"""B7: blocked online-softmax attention (``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel ``repro.kernels.flash_attention.
flash_attention_bhsd``. The port takes the model's own layouts, q and the
output (B, Sq, H, Dh), k and v (B, Skv, K, Dh) with GQA as it is (query
head h reads KV head h // (H / K)), so no transpose, repeat or padding
surrounds the launch. Causal and sliding-window masks and a ``q_offset``
(a query block against a longer KV) as in the TPU kernel; KV tiles wholly
masked are skipped. At phi4-mini's prefill the card's operation rate
bounds it.

Under autograd the kernel is the forward of ``FlashAttention``; its
backward recomputes the plain version (``ref.mha_ref``) and takes its
gradients (the TPU kernel has no backward either: the JAX package trains
through its XLA attention cores). The function is the same on both
devices, so the CPU tests reach its backward.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import build, ref

NAME = "flash_attention"
DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (32, 64, 128, 256)  # the kernel's Dh; the plain version takes any


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Attention of q (B, Sq, H, Dh) over k, v (B, Skv, K, Dh) -> (B, Sq,
    H, Dh) in ``q.dtype``; float32 math.

    float32 or bfloat16 (one type). On a CUDA tensor this launches the
    kernel; on a CPU tensor it runs the plain version.
    """
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"{NAME}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    b, sq, h, dh = q.shape
    skv, kh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != dh or kh == 0 or h % kh:
        raise ValueError(f"{NAME}: q {tuple(q.shape)} does not fit k "
                         f"{tuple(k.shape)}")
    for t in (q, k, v):
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise TypeError(f"{NAME}: takes one of {DTYPES}, got "
                            f"{q.dtype}, {k.dtype}, {v.dtype}")
        if t.device != q.device:
            raise ValueError(f"{NAME}: tensors on {q.device} and {t.device}")
    if q_offset < 0 or (window is not None and window <= 0):
        raise ValueError(f"{NAME}: q_offset {q_offset}, window {window}")
    return FlashAttention.apply(q, k, v, causal, window, q_offset)


def _forward(q, k, v, causal, window, q_offset) -> torch.Tensor:
    b, sq, h, dh = q.shape
    skv, kh = k.shape[1], k.shape[2]
    if q.device.type == "cpu":
        return ref.mha_ref(q, k, v, causal=causal, window=window,
                           q_offset=q_offset)
    if dh not in HEAD_DIMS:
        raise ValueError(f"{NAME}: head dim {dh} not in {HEAD_DIMS}")
    for t in (q, k, v):
        build.require_cuda(t, NAME)
        if t.data_ptr() % 16:
            raise ValueError(f"{NAME}: tensor not 16-byte aligned")
    o = torch.empty_like(q)
    if o.numel():
        lib = build.load("flash_attention")
        build.check(lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, sq,
            skv, h, kh, dh, int(q.dtype == torch.bfloat16), int(causal),
            0 if window is None else int(window), int(q_offset),
            float(np.float32(1.0) / np.sqrt(np.float32(dh))),  # true Dh
            build.stream_ptr(q.device)), NAME)
        build.count(NAME)
    return o


class FlashAttention(torch.autograd.Function):
    """B7 (or, for CPU tensors, its plain version) forward; the backward
    recomputes ``ref.mha_ref`` in float32 and returns its gradients."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.mask = dict(causal=causal, window=window, q_offset=q_offset)
        return _forward(q, k, v, causal, window, q_offset)

    @staticmethod
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        need = [i for i in range(3) if ctx.needs_input_grad[i]]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(i in need)
                      for i, t in enumerate(saved)]
            out = ref.mha_ref(*inputs, **ctx.mask)
            got = torch.autograd.grad(out, [inputs[i] for i in need],
                                      grad_out)
        grads = [None, None, None]
        for i, g in zip(need, got):
            grads[i] = g
        return (*grads, None, None, None)
