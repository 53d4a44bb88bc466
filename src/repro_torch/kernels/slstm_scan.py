"""B8: the fused sLSTM time scan (``csrc/slstm_scan.cu``).

Replaces the Pallas TPU kernel ``repro.kernels.slstm_scan.slstm_scan``. It
also takes an initial ``(c, n, h)`` and returns the final one, which the
prefill writes into the decode cache; from a zero state its ``h`` is the
TPU kernel's. One cooperative launch runs all S steps with R resident in
the shared memory of d/16 blocks; at xlstm-1.3b's prefill the chain of
dependent steps, not a rate, bounds it.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref

NAME = "slstm_scan"
R_DTYPES = (torch.float32, torch.bfloat16)
UNITS_PER_BLOCK = 16
MAX_BATCH = 16


def slstm_scan(xg: torch.Tensor, r: torch.Tensor,
               state: Optional[tuple] = None):
    """``(h (B, S, d), (c, n, h))``: the sLSTM recurrence over the input
    gates ``xg`` (B, S, 4d) float32 with recurrent weights ``r`` (H, dh,
    4dh) float32 or bfloat16, from ``state`` (three (B, d) float32 tensors;
    zeros when None).

    On a CUDA tensor this launches the kernel; on a CPU tensor it runs the
    plain version.
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
    dh = d // hh
    if dh % UNITS_PER_BLOCK or b > MAX_BATCH:
        raise ValueError(f"{NAME}: takes dh a multiple of {UNITS_PER_BLOCK} "
                         f"and B <= {MAX_BATCH}, got dh {dh}, B {b}")
    if state is None:
        state = tuple(torch.zeros(b, d, dtype=torch.float32,
                                  device=xg.device) for _ in range(3))
    for t in tensors + tuple(state):
        build.require_cuda(t, NAME)
    hs = torch.empty(b, s, d, dtype=torch.float32, device=xg.device)
    if s == 0 or b == 0:
        return hs, tuple(t.clone() for t in state)
    final = tuple(torch.empty_like(t) for t in state)
    lib = build.load("slstm_scan")
    build.check(lib.slstm_scan_launch(
        xg.data_ptr(), r.data_ptr(), *(t.data_ptr() for t in state),
        hs.data_ptr(), *(t.data_ptr() for t in final), b, s, d, hh,
        int(r.dtype == torch.bfloat16), build.stream_ptr(xg.device)), NAME)
    build.LAUNCHES[NAME] += 1
    return hs, final
