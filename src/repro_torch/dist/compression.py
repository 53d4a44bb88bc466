"""Compressed ISP exchange over the pod axis (``repro.dist.compression``).

The error-feedback form of the MLLess significance filter: parameters are
shared across the data-parallel pod axis, every pod keeps a private
residual, and only the significant part of ``residual + update`` crosses
the wire. A leading tensor dimension of size ``n_pods`` stands in for the
pod collective, so one card runs every pod.

Schemes (``CompressionConfig.scheme``): ``dense`` (the filtered update as
a full tensor), ``topk`` (per pod, per ``block``-sized block, the
``budget`` fraction of largest magnitudes; the rest returns to the
residual) and ``bitmap`` (the same entries as dense, accounted as a
bitmask plus values). Bytes are accounted through ``wire.codec.
leaf_nbytes``, the formula the live runtime's encoder asserts against.

Kernels: on a CUDA tensor the split always runs B1 (``kernels.
significance``) and the hit count always runs B6 (``kernels.wire_pack.
wire_nnz``), whatever ``fused`` says, so the card computes the JAX
package's ``fused=True`` exchange. On a CPU tensor ``fused`` picks between
the JAX package's two forms: B1's plain version, or ``r + u`` in the
leaf's dtype split by ``core.isp.significance_split``. ``interpret`` is
kept for the signature and has no effect.

The pod sums are taken in float32 in pod order, as XLA reduces the pod
axis, and top-k ties go to the lower index, as ``jax.lax.top_k`` breaks
them (a stable descending sort).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch import tree as tree_lib
from repro_torch.core.isp import significance_split
from repro_torch.kernels.significance import significance_filter
from repro_torch.kernels.wire_pack import wire_nnz
from repro_torch.wire import codec as wire_codec

PyTree = Any

_SCHEMES = ("dense", "topk", "bitmap")
# exchange scheme -> default repro wire encoding of what crosses the pod axis
_WIRE_OF = {"dense": "dense", "topk": "sparse", "bitmap": "bitmap"}


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """Static exchange configuration.

    Attributes:
      scheme: 'dense', 'topk' or 'bitmap' (module doc).
      budget: topk only — fraction of entries kept per block (0 < b <= 1).
      block: topk only — block size of the block-local top-k.
      wire: the codec the byte accounting charges for ('dense'|'sparse'|
        'bitmap'); None derives it from ``scheme``.
      fused: on CPU tensors, B1's and B6's plain versions instead of the
        unfused form (on CUDA tensors the kernels always run).
      interpret: no effect (the TPU kernels' interpret mode).
    """

    scheme: str = "dense"
    budget: float = 0.01
    block: int = 128
    wire: Optional[str] = None
    fused: bool = False
    interpret: bool = False

    def __post_init__(self):
        if self.scheme not in _SCHEMES:
            raise ValueError(
                f"scheme must be one of {_SCHEMES}, got {self.scheme!r}")
        if self.wire is not None and self.wire not in wire_codec.SCHEMES:
            raise ValueError(
                f"wire must be one of {wire_codec.SCHEMES}, got {self.wire!r}")
        if not 0.0 < self.budget <= 1.0:
            raise ValueError(f"budget must be in (0, 1], got {self.budget}")
        if self.block < 1:
            raise ValueError(f"block must be >= 1, got {self.block}")

    @property
    def wire_scheme(self) -> str:
        """The codec this exchange is accounted as."""
        return self.wire or _WIRE_OF[self.scheme]

    def k_per_block(self, block: Optional[int] = None) -> int:
        """Entries kept per block under the topk budget (always >= 1)."""
        b = self.block if block is None else block
        return max(1, min(b, int(round(b * self.budget))))


def split_significant(
    u: torch.Tensor, x: torch.Tensor, r: torch.Tensor, v_t: float, *,
    floor: float = 1e-8, fused: bool = False, interpret: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(sig, res)``: ``r + u`` split by ``|acc| > v_t * max(|x|,
    floor)``. ``x`` may have fewer leading dims than ``u``/``r`` (shared
    params against a pod-stacked update): it is broadcast, and B1 reads it
    once per pod."""
    del interpret
    if fused or u.device.type == "cuda":
        return significance_filter(u, x, r, v_t, floor)
    sig, res, _ = significance_split(r + u, x, v_t, floor)
    return sig, res


def _pod_topk_mask(sig_pod: torch.Tensor,
                   cfg: CompressionConfig) -> torch.Tensor:
    """Keep-mask of the per-block top-k |entries| of every pod slice of
    ``sig_pod`` (P, *s): the JAX package's ``vmap`` of
    ``_block_topk_mask``. Each slice is flattened to (nb, block) with zero
    padding; padded entries are dropped from the mask."""
    pods = sig_pod.shape[0]
    flat = sig_pod.reshape(pods, -1)
    n = flat.shape[1]
    block = min(cfg.block, max(n, 1))
    k = cfg.k_per_block(block)
    pad = (-n) % block
    if pad:
        flat = F.pad(flat, (0, pad))
    blocks = flat.reshape(pods, -1, block)
    # stable: among equal magnitudes the lower index comes first
    idx = torch.sort(blocks.abs(), dim=-1, descending=True,
                     stable=True).indices[..., :k]
    keep = torch.zeros(blocks.shape, dtype=torch.bool, device=blocks.device)
    keep.scatter_(-1, idx, True)
    return keep.reshape(pods, -1)[:, :n].reshape(sig_pod.shape)


def _f32(value: float, device) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=device)


def pod_sum(t: torch.Tensor) -> torch.Tensor:
    """Float32 sum over the leading axis as XLA reduces it: one slice is
    returned as it is; more are added in index order from +0 (so ``-0.0``
    sums to ``+0.0``)."""
    if t.shape[0] == 1:
        return t[0].float().clone()
    acc = torch.zeros(t.shape[1:], dtype=torch.float32, device=t.device)
    for i in range(t.shape[0]):
        acc = acc + t[i].float()
    return acc


def isp_compressed_step(
    cfg: CompressionConfig, updates_pod: PyTree, params: PyTree,
    residual_pod: PyTree, v_t: float, *, floor: float = 1e-8,
) -> tuple[PyTree, PyTree, dict[str, torch.Tensor]]:
    """One error-feedback ISP exchange over the leading pod axis.

    ``updates_pod`` and ``residual_pod`` leaves are (P, *s), ``params``
    leaves *s. Returns ``(combined, new_residual_pod, stats)``: ``combined``
    has the shape and dtype of ``params`` (the summed sent mass), per pod
    ``sent_p + new_residual_p == residual_p + update_p`` for every leaf,
    and ``stats`` holds ``sent_fraction`` and ``wire_bytes`` as 0-d float32
    tensors on the params' device (nothing here waits for the card).
    """
    u_leaves = tree_lib.leaves(updates_pod)
    x_leaves = tree_lib.leaves(params)
    r_leaves = tree_lib.leaves(residual_pod)
    dev = x_leaves[0].device
    wire_scheme = cfg.wire_scheme
    combined, new_res = [], []
    n_sent = _f32(0.0, dev)
    n_total = 0
    wire = _f32(0.0, dev)
    for u, x, r in zip(u_leaves, x_leaves, r_leaves):
        sig, res = split_significant(u, x, r, v_t, floor=floor,
                                     fused=cfg.fused,
                                     interpret=cfg.interpret)
        if cfg.scheme == "topk":
            keep = _pod_topk_mask(sig, cfg)
            sent = torch.where(keep, sig, torch.zeros_like(sig))
            res = res + (sig - sent)  # unsent significant mass feeds back
        else:
            sent = sig
        combined.append(pod_sum(sent).to(x.dtype))
        new_res.append(res)
        if (cfg.fused or sent.device.type == "cuda") and sent.numel() > 0:
            hits = wire_nnz(sent.reshape(-1)).float()  # B6, exact in int32
        else:
            hits = torch.sum((sent != 0).float())
        n_sent = n_sent + hits
        n_total += sent.numel()
        # each pod ships one encoded leaf: P * the fixed part (dense bytes
        # or bitmap mask) plus the marginal bytes per entry times the hits
        n_pods, leaf_n = sent.shape[0], sent.numel() // sent.shape[0]
        itemsize = x.element_size()
        fixed = wire_codec.leaf_nbytes(wire_scheme, leaf_n, 0, itemsize)
        marginal = wire_codec.leaf_nbytes(wire_scheme, leaf_n, 1,
                                          itemsize) - fixed
        wire = wire + _f32(float(n_pods * fixed), dev) + hits * float(
            marginal)
    stats = {
        "sent_fraction": n_sent / _f32(max(float(n_total), 1.0), dev),
        "wire_bytes": wire,
    }
    return (tree_lib.unflatten(params, combined),
            tree_lib.unflatten(params, new_res), stats)


def apply_combined(params: PyTree, combined: PyTree) -> PyTree:
    """x' = x + sum_p sent_p in float32, cast back to each leaf's dtype."""
    return tree_lib.tree_map(
        lambda p, c: (p.float() + c.float()).to(p.dtype), params, combined)
