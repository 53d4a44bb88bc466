"""B1: the fused ISP significance filter (``csrc/significance.cu``).

Replaces the Pallas TPU kernel ``repro.kernels.significance.
significance_filter``. One elementwise pass reads ``u``, ``x`` and ``r``
and writes ``sig`` and the new residual — the 3-read / 2-write minimum
for this function; the card's memory rate bounds it. float32, float16 and
bfloat16, with the TPU kernel's float32 arithmetic in between. ``x`` may
lack leading dimensions of ``u`` (the pod path's shared parameters against
pod-stacked updates): the kernel reads it once per pod instead of a
broadcast copy.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.wire_pack import CODES

NAME = "significance_filter"
DTYPES = (torch.float32, torch.float16, torch.bfloat16)


def significance_filter(
    u: torch.Tensor, x: torch.Tensor, r: torch.Tensor, v_t: float,
    floor: float = 1e-8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(sig, new_residual)`` with ``sig + new_residual == r + u`` before
    rounding to the storage type.

    ``u``, ``x`` and ``r`` share one of ``DTYPES``; ``u`` and ``r`` one
    shape, whose trailing dimensions are ``x``'s. On a CUDA tensor this
    launches the kernel; on a CPU tensor it runs the plain version.
    """
    if u.shape != r.shape or tuple(u.shape[u.dim() - x.dim():]) != tuple(
            x.shape) or x.dim() > u.dim():
        raise ValueError(f"shape mismatch: {u.shape} {x.shape} {r.shape}")
    for t in (u, x, r):
        if t.dtype != u.dtype or t.dtype not in DTYPES:
            raise TypeError(f"{NAME}: one of {DTYPES}, got {u.dtype}, "
                            f"{x.dtype}, {r.dtype}")
        if t.device != u.device:
            raise ValueError(f"{NAME}: tensors on {u.device} and {t.device}")
    vt = float(np.float32(v_t))
    fl = float(np.float32(floor))
    if u.device.type == "cpu":
        return ref.significance_ref(u, x, r, vt, fl)
    for t in (u, x, r):
        build.require_cuda(t, NAME)
    pods = math.prod(u.shape[:u.dim() - x.dim()])
    if pods > 65535:
        raise ValueError(f"{NAME}: {pods} copies of x, at most 65535")
    sig = torch.empty_like(u)
    res = torch.empty_like(r)
    if u.numel():
        lib = build.load("significance")
        build.check(lib.significance_filter_launch(
            u.data_ptr(), x.data_ptr(), r.data_ptr(), sig.data_ptr(),
            res.data_ptr(), x.numel(), pods, CODES[u.dtype], vt, fl,
            build.stream_ptr(u.device)), NAME)
        build.LAUNCHES[NAME] += 1
    return sig, res
