"""B8: the fused sLSTM time scan (``csrc/slstm_scan.cu``).

Replaces the Pallas TPU kernel ``repro.kernels.slstm_scan.slstm_scan``. It
also takes an initial ``(c, n, h)`` and returns the final one, which the
prefill writes into the decode cache; from a zero state its ``h`` is the
TPU kernel's. At xlstm-1.3b's prefill the chain of dependent steps, not a
rate, bounds it.

``plan`` picks how the kernel runs, from the shape and R's dtype alone,
before any launch; the C entry checks the plan and refuses one it does not
take, and never picks another route itself:

* ``cluster`` (bf16 R, dh 32..512): one thread-block cluster of dh/32 CTAs
  per (head, group of up to 4 batch rows), R resident in the CTAs'
  registers as tensor-core fragments, h exchanged through distributed
  shared memory, each CTA waiting on its own mbarrier for h_{t-1};
* ``cooperative`` (float32 R, among others): one persistent launch of d/16
  blocks with a grid-wide barrier a step.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build, ref

NAME = "slstm_scan"
R_DTYPES = (torch.float32, torch.bfloat16)
SMEM_BYTES = 232_448  # a block's shared memory on sm_90
SMS = 132  # H100 SXM
UNITS = 32  # hidden units a cluster CTA
MAX_ROWS = 4  # batch rows a cluster
TILE_N = 8  # columns of a tensor-core tile
TERMS = 3  # bf16 terms of h in the tensor-core products
XG_RING = 4  # steps of xg a cluster CTA loads ahead
P_STRIDE = 132  # a row of a cluster CTA's partial sums, padded
K_PARTS = 2  # K parts of a cluster CTA's dot products, 4 warps each
CLUSTER_DH = (32, 64, 128, 256, 512)
COOP_UNITS = 16  # hidden units per cooperative block
COOP_SPLIT = 4  # slices of each cooperative dot product
COOP_MAX_BATCH = 16


class Plan(NamedTuple):
    """How B8 runs: the route, CTAs per cluster, hidden units per CTA (or
    cooperative block), batch rows per cluster (all of them on the
    cooperative route), slices of each dot product (K parts of a cluster
    CTA, 4 warps each), and the dynamic shared memory of a CTA in bytes."""
    route: str
    cluster: int
    units: int
    rows: int
    kslices: int
    smem: int

    @property
    def threads(self) -> int:
        return 128 * self.kslices if self.route == "cluster" else 256

    def clusters(self, batch: int, heads: int) -> int:
        return heads * -(-batch // self.rows)


def _cluster_plan(batch: int, dh: int, groups: int) -> Optional[Plan]:
    """The cluster route (bf16 R) with ``groups`` clusters per head (batch
    rows split evenly): dh/32 CTAs of 32 units, R's slice in registers as
    tensor-core fragments; None where it does not fit (dh not a power of
    two in 32..512, or more than 4 rows)."""
    rows = -(-batch // groups)
    if dh not in CLUSTER_DH or not 1 <= rows <= MAX_ROWS:
        return None
    nb = 4 if rows >= 3 else rows  # rows of h buffers and xg
    n_tiles = 1 if rows <= 2 else 2  # tile columns: (row, term) pairs
    k_tiles = dh // (16 * K_PARTS)
    a_smem = k_tiles - (12 if k_tiles == 16 else k_tiles)  # A past registers
    smem = (16 * 2 * 128 * K_PARTS * a_smem
            + n_tiles * TILE_N * (dh + 8) * 2
            + 4 * (2 * nb * dh + K_PARTS * TERMS * MAX_ROWS * P_STRIDE
                   + XG_RING * nb * 4 * UNITS) + 16)
    if smem > SMEM_BYTES:
        return None
    return Plan("cluster", dh // UNITS, UNITS, rows, K_PARTS, smem)


def _cooperative_plan(batch: int, d: int, dh: int, r_size: int
                      ) -> Optional[Plan]:
    if dh % COOP_UNITS or batch > COOP_MAX_BATCH or d // COOP_UNITS > SMS:
        return None
    bpad = -(-batch // 4) * 4
    cols = 4 * COOP_UNITS
    smem = dh * cols * r_size + (bpad * dh + COOP_SPLIT * bpad * cols) * 4
    if smem > SMEM_BYTES:
        return None
    return Plan("cooperative", 1, COOP_UNITS, batch, COOP_SPLIT, smem)


def plan(batch: int, d: int, heads: int, r_dtype: torch.dtype) -> Plan:
    """The launch plan for B ``batch``, width ``d`` over ``heads`` heads and
    R of ``r_dtype``: the cluster route for bf16 R at dh 32..512 (a power
    of two), with the fewest batch groups a head (at most 4 rows each: one
    cluster a head beat two on the card, PERF.md §6); else the cooperative
    route (float32 R among others). Raises ``ValueError`` for a shape
    neither takes."""
    if r_dtype not in R_DTYPES:
        raise TypeError(f"{NAME}: r must be one of {R_DTYPES}, got {r_dtype}")
    if heads < 1 or d % heads:
        raise ValueError(f"{NAME}: d {d} does not split over {heads} heads")
    dh = d // heads
    if r_dtype == torch.bfloat16:
        p = _cluster_plan(batch, dh, max(1, -(-batch // MAX_ROWS)))
        if p is not None:
            return p
    p = _cooperative_plan(batch, d, dh, r_dtype.itemsize)
    if p is None:
        raise ValueError(f"{NAME}: no route takes B {batch}, d {d}, {heads} "
                         f"heads, R {r_dtype}")
    return p


def _entry_args(p: Plan) -> tuple:
    return (int(p.route == "cluster"), p.cluster, p.units, p.rows,
            p.kslices, p.smem)


def max_clusters(p: Plan, d: int, heads: int, r_dtype: torch.dtype) -> int:
    """``cudaOccupancyMaxActiveClusters`` of a cluster-route plan on the
    current card: how many of its clusters run at once."""
    out = ctypes.c_int(0)
    build.check(build.load(NAME).slstm_scan_max_clusters(
        d, heads, int(r_dtype == torch.bfloat16), *_entry_args(p),
        ctypes.byref(out)), NAME)
    return out.value


def _launch(xg, r, state, p: Plan):
    """One launch of the kernel under plan ``p`` (CUDA tensors, checked)."""
    b, s, four_d = xg.shape
    hs = torch.empty(b, s, four_d // 4, dtype=torch.float32, device=xg.device)
    final = tuple(torch.empty_like(t) for t in state)
    build.check(build.load(NAME).slstm_scan_launch(
        xg.data_ptr(), r.data_ptr(), *(t.data_ptr() for t in state),
        hs.data_ptr(), *(t.data_ptr() for t in final), b, s, four_d // 4,
        r.shape[0], int(r.dtype == torch.bfloat16), *_entry_args(p),
        build.stream_ptr(xg.device)), NAME)
    build.LAUNCHES[NAME] += 1
    return hs, final


def slstm_scan(xg: torch.Tensor, r: torch.Tensor,
               state: Optional[tuple] = None):
    """``(h (B, S, d), (c, n, h))``: the sLSTM recurrence over the input
    gates ``xg`` (B, S, 4d) float32 with recurrent weights ``r`` (H, dh,
    4dh) float32 or bfloat16, from ``state`` (three (B, d) float32 tensors;
    zeros when None).

    On a CUDA tensor this launches the kernel under ``plan``; on a CPU
    tensor it runs the plain version.
    """
    if xg.ndim != 3 or xg.shape[2] % 4 or xg.dtype != torch.float32:
        raise ValueError(f"{NAME}: xg must be (B, S, 4d) float32, got "
                         f"{tuple(xg.shape)} {xg.dtype}")
    b, s, four_d = xg.shape
    d = four_d // 4
    hh = r.shape[0]
    if (r.ndim != 3 or hh == 0 or d % hh
            or tuple(r.shape) != (hh, d // hh, 4 * (d // hh))):
        raise ValueError(f"{NAME}: r {tuple(r.shape)} does not fit d {d}")
    if r.dtype not in R_DTYPES:
        raise TypeError(f"{NAME}: r must be one of {R_DTYPES}, got {r.dtype}")
    if state is not None:
        for t in state:
            if tuple(t.shape) != (b, d) or t.dtype != torch.float32:
                raise ValueError(f"{NAME}: state must be three ({b}, {d}) "
                                 f"float32 tensors")
    tensors = (xg, r) + tuple(state or ())
    for t in tensors:
        if t.device != xg.device:
            raise ValueError(f"{NAME}: tensors on {xg.device} and "
                             f"{t.device}")
    if xg.device.type == "cpu":
        return ref.slstm_scan_ref(xg, r, state)
    if state is None:
        state = tuple(torch.zeros(b, d, dtype=torch.float32,
                                  device=xg.device) for _ in range(3))
    for t in tensors + tuple(state):
        build.require_cuda(t, NAME)
    if s == 0 or b == 0:
        return (torch.empty(b, s, d, dtype=torch.float32, device=xg.device),
                tuple(t.clone() for t in state))
    return _launch(xg, r, state, plan(b, d, hh, r.dtype))
