"""The port's B7 (flash attention) and B8 (sLSTM scan) held to the JAX package.

On the CPU each wrapper runs its plain PyTorch version (``ref.mha_ref``,
``ref.slstm_scan_ref``); here those are compared with the JAX Pallas
kernels run in interpret mode and with the JAX references, on the same
numpy inputs, at the tolerances of ``tests/test_kernels.py``: 2e-5 at
float32 and 2e-2 at bfloat16 for attention, 2e-5 for the sLSTM scan (both
sum in float32, in another order). GQA is held to JAX
``attention.attn_apply``. The CUDA kernels are compared with these plain
versions on the card by ``chip_smoke.py`` and the ``cuda``-marked tests.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.slstm_scan import slstm_scan as jslstm_scan
from repro.models import attention as jattn
from repro.models import xlstm as jxl
from repro.configs import get_smoke as jget_smoke

from repro_torch import convert
from repro_torch.configs import get_smoke
from repro_torch.kernels import ops, ref
from repro_torch.kernels.slstm_scan import slstm_scan
from repro_torch.models import attention, params as pdefs

F32_TOL, BF16_TOL = 2e-5, 2e-2


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _pair(a: np.ndarray, bf16: bool):
    """The same values as a JAX array and a torch tensor (bf16 rounds the
    float32 values to nearest even in both)."""
    j = jnp.asarray(a)
    t = torch.from_numpy(a)
    if bf16:
        return j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _qkv(shape_q, shape_kv, seed, bf16):
    return (_pair(_np(shape_q, seed), bf16),
            _pair(_np(shape_kv, seed + 1), bf16),
            _pair(_np(shape_kv, seed + 2), bf16))


# ---- B7: the cases of tests/test_kernels.py --------------------------------------


@pytest.mark.parametrize("seq,dh", [(128, 128), (256, 128), (384, 256)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bf16", [False, True])
def test_flash_matches_pallas_interpret_and_ref(seq, dh, causal, bf16):
    (jq, q), (jk, k), (jv, v) = _qkv((2, seq, 2, dh), (2, seq, 2, dh),
                                     seed=seq + dh, bf16=bf16)
    got = ops.flash_attention(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = BF16_TOL if bf16 else F32_TOL
    _close(got, jops.flash_attention(jq, jk, jv, causal=causal,
                                     interpret=True), tol)
    _close(got, jref.mha_ref(jq, jk, jv, causal=causal), tol)


@pytest.mark.parametrize("window", [64, 128])
def test_flash_sliding_window(window):
    (jq, q), (jk, k), (jv, v) = _qkv((1, 256, 2, 128), (1, 256, 2, 128),
                                     seed=window, bf16=False)
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    _close(got, jops.flash_attention(jq, jk, jv, causal=True, window=window,
                                     interpret=True), F32_TOL)
    _close(got, jref.mha_ref(jq, jk, jv, causal=True, window=window), F32_TOL)


def test_flash_head_dim_64():
    (jq, q), (jk, k), (jv, v) = _qkv((1, 128, 2, 64), (1, 128, 2, 64),
                                     seed=5, bf16=False)
    got = ops.flash_attention(q, k, v, causal=True)
    _close(got, jops.flash_attention(jq, jk, jv, causal=True,
                                     interpret=True), F32_TOL)


def test_flash_q_offset():
    """Sq < Skv with q_offset: a query block against a longer KV."""
    (jq, q), (jk, k), (jv, v) = _qkv((1, 128, 2, 128), (1, 384, 2, 128),
                                     seed=6, bf16=False)
    got = ops.flash_attention(q, k, v, causal=True, q_offset=256)
    _close(got, jops.flash_attention(jq, jk, jv, causal=True, q_offset=256,
                                     interpret=True), F32_TOL)
    _close(got, jref.mha_ref(jq, jk, jv, causal=True, q_offset=256), F32_TOL)


@pytest.mark.parametrize("sq,skv,causal", [(200, 200, True), (1000, 1000, True),
                                           (200, 200, False)])
def test_flash_ragged_lengths(sq, skv, causal):
    (jq, q), (jk, k), (jv, v) = _qkv((1, sq, 2, 64), (1, skv, 2, 64),
                                     seed=sq, bf16=False)
    got = ops.flash_attention(q, k, v, causal=causal)
    _close(got, jref.mha_ref(jq, jk, jv, causal=causal), F32_TOL)


@pytest.mark.parametrize("bf16", [False, True])
def test_flash_gqa_reads_kv_head_h_over_group(bf16):
    """24 query heads over 8 KV heads (phi4-mini's grouping) against the
    JAX reference on K/V repeated to 24 heads: head h reads KV head h // 3."""
    (jq, q), (jk, k), (jv, v) = _qkv((2, 64, 24, 64), (2, 64, 8, 64),
                                     seed=24, bf16=bf16)
    got = ops.flash_attention(q, k, v, causal=True)
    want = jref.mha_ref(jq, jnp.repeat(jk, 3, axis=2),
                        jnp.repeat(jv, 3, axis=2), causal=True)
    _close(got, want, BF16_TOL if bf16 else F32_TOL)


def test_attention_block_prefill_and_decode_match_jax():
    """One GQA attention block (phi4-mini-smoke: 4 heads over 2 KV heads,
    RoPE) in float32: prefill output and cache, then one decode step's
    output and cache, against JAX ``attn_apply`` (1e-5)."""
    jcfg = dataclasses.replace(jget_smoke("phi4-mini-3.8b"),
                               param_dtype="float32",
                               activation_dtype="float32")
    cfg = dataclasses.replace(get_smoke("phi4-mini-3.8b"),
                              param_dtype="float32",
                              activation_dtype="float32")
    spec = cfg.groups[0][0][0]
    jspec = jcfg.groups[0][0][0]
    jp = {k: jnp.asarray(_np(d.shape, i)) * 0.1 for i, (k, d) in enumerate(
        sorted(jattn.attn_defs(jcfg).items()))}
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    b, s, L = 2, 12, 16
    x = _np((b, s, cfg.d_model), 40)
    pol = jattn.ShardingPolicy()
    jcache = {k: jnp.zeros((b, L, 2 * 16), jnp.float32) for k in ("k", "v")}
    jy, jcache = jattn.attn_apply(jcfg, jspec, jp, jnp.asarray(x),
                                  policy=pol, cache=jcache)
    cache = pdefs.zeros(attention.cache_defs(cfg, spec, b, L), "cpu")
    y, cache = attention.attn_apply(cfg, spec, p, torch.from_numpy(x),
                                    cache=cache)
    _close(y, jy, 1e-5)
    for key in ("k", "v"):
        _close(cache[key], jcache[key], 1e-5)
    x1 = _np((b, 1, cfg.d_model), 41)
    jy, jcache = jattn.attn_apply(jcfg, jspec, jp, jnp.asarray(x1),
                                  policy=pol, cache=jcache,
                                  decode_pos=jnp.int32(s))
    y, cache = attention.attn_apply(cfg, spec, p, torch.from_numpy(x1),
                                    cache=cache, decode_pos=s)
    _close(y, jy, 1e-5)
    for key in ("k", "v"):
        _close(cache[key], jcache[key], 1e-5)


def _p_bf16_model(q, k, v, causal, window, q_offset):
    """``ref.mha_ref``'s arithmetic with the card kernel's one new rounding:
    the unnormalised probabilities go to bf16 before P V, while their sum
    stays float32 (a model of the tensor-core B7, not a port function).
    Returns the float32 output and the size of its terms, ``(P |v|) / l``."""
    b, sq, h, dh = q.shape
    skv, kh = k.shape[1], k.shape[2]
    scale = float(np.float32(1.0) / np.sqrt(np.float32(dh)))
    qg = q.float().reshape(b, sq, kh, h // kh, dh)
    logits = torch.einsum("bqkgd,bckd->bkgqc", qg, k.float()) * scale
    q_pos = q_offset + torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    allow = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        allow &= k_pos <= q_pos
    if window is not None:
        allow &= q_pos - k_pos < window
    logits = torch.where(allow, logits, ref.NEG_INF)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    pb = p.bfloat16().float()

    def pv(x):
        y = torch.einsum("bkgqc,bckd->bkgqd", pb, x) / l
        return y.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh)

    return pv(v.float()), pv(v.float().abs())


def _mha_p_bf16(q, k, v, causal, window, q_offset):
    return _p_bf16_model(q, k, v, causal, window, q_offset)[0].to(q.dtype)


BF16_U = 2.0 ** -8  # bf16's unit roundoff


def _p_rounding_share(got, q, k, v, kw) -> float:
    """The largest share of ``2u (P |v|) / l + u |o| + 1e-6`` by which
    ``got`` is off the model's ``o``: each term may differ by two roundings
    of P (the kernel rounds P against its running row max) and the output
    by one. At most 1 for the bf16 kernel."""
    want, size = _p_bf16_model(q, k, v, **kw)
    bound = 2 * BF16_U * size + BF16_U * want.abs() + 1e-6
    return float(((got.float() - want).abs() / bound).max())


# (B, Sq, Skv, H, K, causal, window, q_offset) at each Dh
_ROUNDING_CASES = {
    "causal": (2, 255, 255, 2, 2, True, None, 0),
    "window": (1, 300, 300, 2, 2, True, 100, 0),
    "q_offset": (1, 100, 300, 2, 2, True, None, 200),
    "gqa": (1, 129, 129, 12, 4, True, None, 0),
}


@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("case", sorted(_ROUNDING_CASES))
def test_p_rounded_to_bf16_stays_within_the_bf16_tolerance(dh, case):
    """The tensor-core B7 rounds P to bf16 before P V (the TPU kernel keeps
    it float32): that arithmetic, modelled here, stays within BF16_TOL of
    JAX's flash attention in interpret mode and of ``ref.mha_ref``."""
    b, sq, skv, h, kh, causal, window, off = _ROUNDING_CASES[case]
    (jq, q), (jk, k), (jv, v) = _qkv((b, sq, h, dh), (b, skv, kh, dh),
                                     seed=dh + sq + h, bf16=True)
    kw = dict(causal=causal, window=window, q_offset=off)
    got = _mha_p_bf16(q, k, v, **kw)
    assert got.dtype == torch.bfloat16
    rep = h // kh
    want = jops.flash_attention(jq, jnp.repeat(jk, rep, axis=2),
                                jnp.repeat(jv, rep, axis=2), interpret=True,
                                **kw)
    _close(got, want.astype(jnp.float32), BF16_TOL)
    _close(got, ref.mha_ref(q, k, v, **kw).float(), BF16_TOL)


@pytest.mark.parametrize("dh", [32, 64, 128])
def test_p_rounding_bound_holds_the_plain_version_and_not_a_dropped_tile(dh):
    """The card check's bound on the bf16 kernel (``_p_rounding_share``)
    holds ``ref.mha_ref`` in bf16 (within one rounding of P of the model),
    causal or not, but not an output that skipped one 64-key tile of a
    512-key row."""
    (_, q), (_, k), (_, v) = _qkv((2, 512, 4, dh), (2, 512, 2, dh),
                                  seed=dh, bf16=True)
    for causal in (True, False):
        kw = dict(causal=causal, window=None, q_offset=0)
        assert _p_rounding_share(ref.mha_ref(q, k, v, **kw), q, k, v,
                                 kw) <= 1.0
    keep = torch.cat([torch.arange(64), torch.arange(128, 512)])
    skipped = ref.mha_ref(q, k[:, keep], v[:, keep], causal=False)
    assert _p_rounding_share(skipped, q, k, v, kw) > 1.0


# ---- B8 --------------------------------------------------------------------------


def _slstm_inputs(b=2, s=16, d=64, h=2, seed=0):
    dh = d // h
    xg = _np((b, s, 4 * d), seed)
    r = _np((h, dh, 4 * dh), seed + 1) * np.float32(0.5 / np.sqrt(dh))
    return xg, r


def test_slstm_zero_state_matches_pallas_interpret():
    xg, r = _slstm_inputs()
    want = jslstm_scan(jnp.asarray(xg), jnp.asarray(r), n_heads=2, block_t=8,
                       interpret=True)
    hs, _ = slstm_scan(torch.from_numpy(xg), torch.from_numpy(r))
    _close(hs, want, 2e-5)


@pytest.mark.parametrize("r_bf16", [False, True])
def test_slstm_from_a_state_matches_the_module_scan(r_bf16):
    """A non-zero initial (c, n, h), and the final state, against the JAX
    module's ``lax.scan`` of ``_slstm_cell`` (2e-5); R in float32 or
    bfloat16 (the cell upcasts it)."""
    xg, r = _slstm_inputs(seed=3)
    state = [_np((2, 64), 10 + i) for i in range(3)]
    state[1] = np.abs(state[1]) + 1.0  # a normalizer as the scan leaves it
    jr = jnp.asarray(r).astype(jnp.bfloat16) if r_bf16 else jnp.asarray(r)

    def body(carry, xg_t):
        return jxl._slstm_cell({"r": jr}, xg_t, carry)

    jstate, jhs = jax.lax.scan(body, tuple(jnp.asarray(a) for a in state),
                               jnp.asarray(xg).swapaxes(0, 1))
    tr = convert.from_leaves([torch.empty(r.shape, dtype=torch.bfloat16
                                          if r_bf16 else torch.float32)],
                             [np.asarray(jr)])[0]
    hs, final = slstm_scan(torch.from_numpy(xg), tr,
                           tuple(torch.from_numpy(a) for a in state))
    _close(hs, jhs.swapaxes(0, 1), 2e-5)
    for got, want in zip(final, jstate):
        _close(got, want, 2e-5)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    q = torch.zeros(1, 8, 3, 64)
    with pytest.raises(ValueError):  # 3 query heads over 2 KV heads
        ops.flash_attention(q, torch.zeros(1, 8, 2, 64),
                            torch.zeros(1, 8, 2, 64))
    with pytest.raises(TypeError):
        ops.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):
        slstm_scan(torch.zeros(1, 4, 64), torch.zeros(2, 8, 16))


@pytest.mark.cuda
def test_kernels_match_their_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    # (B, Sq, Skv, H, K, Dh, causal, window, q_offset): GQA 24/8, then the
    # tensor-core kernel's tile edges (BQ 64 / 128, BK 128)
    cases = [(2, 200, 200, 24, 8, 128, True, None, 0)]
    cases += [(2, s, s, 2, 2, dh, causal, None, 0) for s in (127, 129, 255)
              for dh in (32, 64, 128) for causal in (True, False)]
    cases += [(1, 100, 300, 2, 2, 128, True, None, 200),
              (1, 300, 300, 2, 2, 64, True, 100, 0),
              (2, 256, 256, 12, 4, 64, True, None, 0),
              (2, 256, 256, 8, 2, 32, True, None, 0),
              (16, 256, 256, 12, 12, 64, True, None, 0)]
    for i, (b, sq, skv, h, kh, dh, causal, window, off) in enumerate(cases):
        for bf16 in (False, True):
            (_, q), (_, k), (_, v) = _qkv((b, sq, h, dh), (b, skv, kh, dh),
                                          seed=i + 1, bf16=bf16)
            q, k, v = q.to(dev), k.to(dev), v.to(dev)
            kw = dict(causal=causal, window=window, q_offset=off)
            got = ops.flash_attention(q, k, v, **kw)
            want = ref.mha_ref(q, k, v, **kw)
            _close(got.cpu(), want.cpu().float().numpy(),
                   BF16_TOL if bf16 else F32_TOL)
            if bf16:
                assert _p_rounding_share(got, q, k, v, kw) <= 1.0
    xg, r = _slstm_inputs()
    hs, _ = slstm_scan(torch.from_numpy(xg).to(dev),
                       torch.from_numpy(r).to(dev))
    want, _ = ref.slstm_scan_ref(torch.from_numpy(xg), torch.from_numpy(r))
    _close(hs.cpu(), want.numpy(), 2e-5)
