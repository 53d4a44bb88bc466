"""B1: the fused ISP significance filter (``csrc/significance.cu``).

Replaces the Pallas TPU kernel ``repro.kernels.significance.
significance_filter``. One elementwise pass reads ``u``, ``x`` and ``r``
and writes ``sig`` and the new residual — the 3-read / 2-write minimum
for this function; the card's memory rate bounds it.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build, ref

NAME = "significance_filter"


def significance_filter(
    u: torch.Tensor, x: torch.Tensor, r: torch.Tensor, v_t: float,
    floor: float = 1e-8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(sig, new_residual)`` with ``sig + new_residual == r + u``.

    float32 tensors of one shape. On a CUDA tensor this launches the
    kernel; on a CPU tensor it runs the plain version.
    """
    if not (u.shape == x.shape == r.shape):
        raise ValueError(f"shape mismatch: {u.shape} {x.shape} {r.shape}")
    for t in (u, x, r):
        if t.dtype != torch.float32:
            raise TypeError(f"{NAME}: float32 only, got {t.dtype}")
        if t.device != u.device:
            raise ValueError(f"{NAME}: tensors on {u.device} and {t.device}")
    vt = float(np.float32(v_t))
    fl = float(np.float32(floor))
    if u.device.type == "cpu":
        return ref.significance_ref(u, x, r, vt, fl)
    for t in (u, x, r):
        build.require_cuda(t, NAME)
    sig = torch.empty_like(u)
    res = torch.empty_like(r)
    n = u.numel()
    if n:
        lib = build.load("significance")
        build.check(lib.significance_filter_launch(
            u.data_ptr(), x.data_ptr(), r.data_ptr(), sig.data_ptr(),
            res.data_ptr(), n, vt, fl, build.stream_ptr(u.device)), NAME)
        build.LAUNCHES[NAME] += 1
    return sig, res
