"""B2 and B3: fused Adam + ISP filter, and fused Adam (``csrc/fused_adam.cu``).

Replace the Pallas TPU kernels ``repro.kernels.fused_adam.adam_sig_update``
(B2) and ``adam_update`` (B3). The scalar block (lr, betas, eps, bias
corrections, ``v_t`` or the weight decay, the update scale) is computed once
on the host in float32 (``ref.adam_scalars``) and handed to the kernel or,
for a CPU tensor, to the plain version, so the two differ only in their own
arithmetic. Each is one elementwise pass; the card's memory rate bounds
both (B2 40 B per element, B3 28 B at float32).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build, ref

SIG_NAME = "adam_sig_update"
NAME = "adam_update"
P_DTYPES = (torch.float32, torch.bfloat16)


def _block(s: ref.AdamScalars):
    return (ctypes.c_float * len(s))(*s)


def _check(name: str, tensors, dtypes) -> None:
    t0 = tensors[0]
    for t, dts in zip(tensors, dtypes):
        if t.shape != t0.shape:
            raise ValueError(f"{name}: shape mismatch {t0.shape} {t.shape}")
        if t.dtype not in dts:
            raise TypeError(f"{name}: got {t.dtype}, takes {dts}")
        if t.device != t0.device:
            raise ValueError(f"{name}: tensors on {t0.device} and "
                             f"{t.device}")
    if t0.device.type != "cpu":
        for t in tensors:
            build.require_cuda(t, name)


def adam_update(
    p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
    lr: float, step: int, *, b1: float = 0.9, b2: float = 0.999,
    eps: float = 1e-8, weight_decay: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused Adam step on one tensor: ``(new_p, new_mu, new_nu)``.

    ``p`` and ``g`` are float32 or bfloat16 (one type), the moments
    float32. On a CUDA tensor this launches the kernel; on a CPU tensor it
    runs the plain version.
    """
    if p.dtype not in P_DTYPES:
        raise TypeError(f"{NAME}: p must be one of {P_DTYPES}, got {p.dtype}")
    f32 = (torch.float32,)
    _check(NAME, (p, g, mu, nu), ((p.dtype,), (p.dtype,), f32, f32))
    s = ref.adam_scalars(lr, b1, b2, eps, int(step), last=weight_decay)
    if p.device.type == "cpu":
        return ref.adam_ref(p, g, mu, nu, s)
    p_out, mu_out, nu_out = (torch.empty_like(t) for t in (p, mu, nu))
    n = p.numel()
    if n:
        lib = build.load("fused_adam")
        build.check(lib.adam_update_launch(
            p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(),
            p_out.data_ptr(), mu_out.data_ptr(), nu_out.data_ptr(), n,
            int(p.dtype == torch.bfloat16), _block(s),
            build.stream_ptr(p.device)), NAME)
        build.LAUNCHES[NAME] += 1
    return p_out, mu_out, nu_out


def adam_sig_update(
    p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
    r: torch.Tensor, lr: float, step: int, v_t: float, *, b1: float = 0.9,
    b2: float = 0.999, eps: float = 1e-8, floor: float = 1e-8,
    scale: float = 1.0,
) -> tuple[torch.Tensor, ...]:
    """Fused Adam + ISP filter on one tensor:
    ``(sig, new_mu, new_nu, new_residual, u)``.

    ``u`` is the Adam update times ``scale`` (the worker's ``1/P_active``);
    ``sig + new_residual == r + u``. float32 tensors of one shape. On a
    CUDA tensor this launches the kernel; on a CPU tensor it runs the
    plain version.
    """
    f32 = (torch.float32,)
    _check(SIG_NAME, (p, g, mu, nu, r), (f32,) * 5)
    s = ref.adam_scalars(lr, b1, b2, eps, int(step), last=v_t, scale=scale)
    fl = float(np.float32(floor))
    if p.device.type == "cpu":
        return ref.adam_sig_ref(p, g, mu, nu, r, s, fl)
    outs = tuple(torch.empty_like(p) for _ in range(5))
    n = p.numel()
    if n:
        lib = build.load("fused_adam")
        build.check(lib.adam_sig_update_launch(
            p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(),
            r.data_ptr(), *(o.data_ptr() for o in outs), n, _block(s), fl,
            build.stream_ptr(p.device)), SIG_NAME)
        build.LAUNCHES[SIG_NAME] += 1
    return outs
