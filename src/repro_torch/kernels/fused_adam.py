"""B2 and B3: fused Adam + ISP filter, and fused Adam (``csrc/fused_adam.cu``).

Replace the Pallas TPU kernels ``repro.kernels.fused_adam.adam_sig_update``
(B2) and ``adam_update`` (B3). The scalar block (lr, betas, eps, bias
corrections, ``v_t`` or the weight decay, the update scale) is computed once
on the host in float32 (``ref.adam_scalars``) and handed to the kernel or,
for a CPU tensor, to the plain version, so the two differ only in their own
arithmetic. Each is one elementwise pass in float32 over float32 or
bfloat16 storage (p and g of one type, the moments of one type, B2's
residual its own), each output rounded once to its type, as the TPU
kernels do; the card's memory rate bounds both (B2 40 B per element, B3
28 B at float32; 20 B and 14 B all in bfloat16).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.wire_pack import CODES

SIG_NAME = "adam_sig_update"
NAME = "adam_update"
DTYPES = (torch.float32, torch.bfloat16)


def _block(s: ref.AdamScalars):
    return (ctypes.c_float * len(s))(*s)


def _check(name: str, groups) -> None:
    """``groups``: tuples of tensors that must share one of ``DTYPES``; all
    tensors share one shape and one device."""
    t0 = groups[0][0]
    for group in groups:
        for t in group:
            if t.shape != t0.shape:
                raise ValueError(f"{name}: shape mismatch {t0.shape} "
                                 f"{t.shape}")
            if t.dtype != group[0].dtype or t.dtype not in DTYPES:
                raise TypeError(f"{name}: got {[x.dtype for x in group]}, "
                                f"takes one of {DTYPES} for them")
            if t.device != t0.device:
                raise ValueError(f"{name}: tensors on {t0.device} and "
                                 f"{t.device}")
    if t0.device.type != "cpu":
        for group in groups:
            for t in group:
                build.require_cuda(t, name)


def adam_update(
    p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
    lr: float, step: int, *, b1: float = 0.9, b2: float = 0.999,
    eps: float = 1e-8, weight_decay: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused Adam step on one tensor: ``(new_p, new_mu, new_nu)``, each in
    its input's type.

    ``p`` and ``g`` share one of ``DTYPES``, ``mu`` and ``nu`` one of
    ``DTYPES``. On a CUDA tensor this launches the kernel; on a CPU tensor
    it runs the plain version.
    """
    _check(NAME, ((p, g), (mu, nu)))
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
            CODES[p.dtype], CODES[mu.dtype], _block(s),
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
    in float32 ``sig + new_residual == r + u``. Tensors of one shape: ``p``
    and ``g`` share one of ``DTYPES``, ``mu`` and ``nu`` one, ``r`` any;
    ``sig`` and ``u`` come back in ``p``'s type, the moments in theirs and
    the residual in ``r``'s. On a CUDA tensor this launches the kernel; on
    a CPU tensor it runs the plain version.
    """
    _check(SIG_NAME, ((p, g), (mu, nu), (r,)))
    s = ref.adam_scalars(lr, b1, b2, eps, int(step), last=v_t, scale=scale)
    fl = float(np.float32(floor))
    if p.device.type == "cpu":
        return ref.adam_sig_ref(p, g, mu, nu, r, s, fl)
    outs = tuple(torch.empty_like(t) for t in (p, mu, nu, r, p))
    n = p.numel()
    if n:
        lib = build.load("fused_adam")
        build.check(lib.adam_sig_update_launch(
            p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(),
            r.data_ptr(), *(o.data_ptr() for o in outs), n, CODES[p.dtype],
            CODES[mu.dtype], CODES[r.dtype], _block(s), fl,
            build.stream_ptr(p.device)), SIG_NAME)
        build.LAUNCHES[SIG_NAME] += 1
    return outs
