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
import re
from pathlib import Path

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
from repro_torch.kernels import slstm_scan as slstm_scan_mod
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


XLSTM_D, XLSTM_H = 2048, 4  # xlstm-1.3b's sLSTM width and heads


def _smoke_width():
    cfg = get_smoke("xlstm-1.3b")
    return cfg.d_model, cfg.n_heads


_PORT_SHAPES = [
    (1, XLSTM_D, XLSTM_H, torch.bfloat16, "cluster"),
    (4, XLSTM_D, XLSTM_H, torch.bfloat16, "cluster"),
    (16, XLSTM_D, XLSTM_H, torch.bfloat16, "cluster"),
    (2, 64, 2, torch.bfloat16, "cluster"),
    (2, None, None, torch.bfloat16, "cluster"),  # xlstm_13b's smoke config
    (4, XLSTM_D, XLSTM_H, torch.float32, "cooperative"),
    (2, 64, 2, torch.float32, "cooperative"),
]


@pytest.mark.parametrize("batch,d,heads,r_dtype,route", _PORT_SHAPES)
def test_slstm_plan_for_every_shape_the_port_runs(batch, d, heads, r_dtype,
                                                  route):
    """B8's plan: the cluster route for bf16 R (dh 512 at B 1, 4, 16, the
    test and smoke widths), the cooperative one for float32 R; every plan
    within one block's shared memory and 16 CTAs a cluster."""
    if d is None:
        d, heads = _smoke_width()
    p = slstm_scan_mod.plan(batch, d, heads, r_dtype)
    dh = d // heads
    assert p.route == route and p.smem <= 232_448
    if route == "cluster":
        assert p.cluster <= 16 and p.cluster * p.units == dh
        assert p.rows <= 4 and p.rows * p.clusters(batch, heads) >= batch
        assert dh % (16 * p.kslices) == 0 and p.threads <= 512
    else:
        assert p.rows == batch and d // p.units <= slstm_scan_mod.SMS
    if d == XLSTM_D and r_dtype == torch.bfloat16:
        assert (p.cluster, p.units, p.kslices, p.threads) == (16, 32, 2, 256)


@pytest.mark.parametrize("batch,d,heads,r_dtype", [
    (4, 4096, 4, torch.bfloat16),  # dh 1024: R's slice fits no 16 CTAs
    (17, XLSTM_D, XLSTM_H, torch.float32),  # past the cooperative batch
    (2, 80, 2, torch.float32),  # dh 40: no multiple of 16 or 32
])
def test_slstm_plan_refuses_a_shape_no_route_takes(batch, d, heads, r_dtype):
    with pytest.raises(ValueError):
        slstm_scan_mod.plan(batch, d, heads, r_dtype)


_CU = Path(slstm_scan_mod.__file__).parent / "csrc" / "slstm_scan.cu"


def _c_expr(text: str, env: dict):
    """A C integer expression of the kernel source, evaluated in Python
    (casts dropped, ``/`` as integer division, one ``?:`` at the top)."""
    text = re.sub(r"static_cast<\w+>", "", text).replace("p.", "")
    text = text.replace("sizeof(float)", "4").replace("sizeof(TR)", "r_size")
    text = text.replace("/", "//")
    m = re.fullmatch(r"\s*(.+?)\s*\?\s*(.+?)\s*:\s*(.+?)\s*", text, re.S)
    if m:
        text = f"({m[2]}) if ({m[1]}) else ({m[3]})"
    return eval(f"({text})", {"__builtins__": {}}, env)


def _c_namespace(name: str) -> dict:
    """The ``constexpr`` constants and one-line ``constexpr`` functions of
    namespace ``name`` in ``slstm_scan.cu``, with its local ``nb``,
    ``bpad`` and ``smem`` formulas as functions."""
    src = _CU.read_text()
    start = src.index(f"namespace {name} {{")
    block = src[start:src.index(f"}}  // namespace {name}", start)]
    env = {"kMaxSmem": int(re.search(r"kMaxSmem = (\d+);", src)[1])}
    for const, expr in re.findall(r"constexpr int (k\w+) = ([^;]+);", block):
        env[const] = _c_expr(expr, env)

    def function(params, body):
        names = [p.split()[-1] for p in params.split(",")]
        return lambda *a: _c_expr(body, {**env, **dict(zip(names, a))})

    for fn, params, body in re.findall(
            r"constexpr \w+ (\w+)\(([^)]*)\)\s*\{\s*return ([^;]+);", block):
        env[fn] = function(params, body)
    for local in ("nb", "bpad", "smem"):
        m = re.search(rf"const (?:int|size_t) {local} =([^;]+);", block)
        if m:
            env["c_" + local] = m[1]
    return env


@pytest.mark.parametrize("py,ns,c", [
    ("UNITS", "clu", "kUnits"), ("MAX_ROWS", "clu", "kMaxRows"),
    ("TILE_N", "clu", "kN"), ("TERMS", "clu", "kTerms"),
    ("XG_RING", "clu", "kRing"), ("P_STRIDE", "clu", "kPStride"),
    ("K_PARTS", "clu", "kParts"), ("SMEM_BYTES", "clu", "kMaxSmem"),
    ("COOP_UNITS", "coop", "kU"), ("COOP_SPLIT", "coop", "kSplit"),
])
def test_slstm_plan_constants_are_the_kernels(py, ns, c):
    """What ``plan`` assumes of the kernel's layout is what
    ``slstm_scan.cu`` declares; a drift would otherwise show only as
    cudaErrorInvalidValue on the card."""
    assert getattr(slstm_scan_mod, py) == _c_namespace(ns)[c]


@pytest.mark.parametrize("batch,d,heads,r_dtype,route", _PORT_SHAPES + [
    (4, XLSTM_D, XLSTM_H, torch.bfloat16, "split"),  # two clusters a head
    (3, XLSTM_D, XLSTM_H, torch.bfloat16, "split"),
    (1, 128, 4, torch.bfloat16, "split"),
])
def test_slstm_plan_is_what_the_c_entry_takes(batch, d, heads, r_dtype,
                                              route):
    """Every plan the port makes (and the batch split ``time_lm_kernels``
    times) passes the C entry's own checks: its shared memory is the
    kernel source's formula, evaluated here from its text."""
    if d is None:
        d, heads = _smoke_width()
    dh = d // heads
    if route == "split":
        p = slstm_scan_mod._cluster_plan(batch, dh, 2)
    else:
        p = slstm_scan_mod.plan(batch, d, heads, r_dtype)
    if p.route == "cluster":
        c = _c_namespace("clu")
        assert (p.units, p.kslices, p.threads) == (
            c["kUnits"], c["kParts"], c["kThreads"])
        assert p.cluster * c["kUnits"] == dh and 1 <= p.rows <= c["kMaxRows"]
        nb = _c_expr(c["c_nb"], {"rows": p.rows})
        want = c["smem_bytes"](dh, nb, p.kslices)
    else:
        c = _c_namespace("coop")
        assert (p.units, p.kslices, p.threads, p.rows) == (
            c["kU"], c["kSplit"], c["kThreads"], batch)
        assert dh % c["kU"] == 0 and batch <= c["kThreads"] // c["kU"]
        bpad = _c_expr(c["c_bpad"], {**c, "batch": batch})
        want = _c_expr(c["c_smem"], {**c, "dh": dh, "bpad": bpad,
                                     "r_size": r_dtype.itemsize})
    assert p.smem == want <= c["kMaxSmem"]


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _cluster_model(xg, r, state, kparts):
    """The cluster kernel's arithmetic in numpy: h_{t-1} as three bf16
    terms (hi = bf16(h), mid = bf16(h - hi), lo = bf16(h - hi - mid)),
    whose products with bf16 R are exact; in each of the ``kparts`` K
    parts of each dot product, each term's products summed exactly and
    rounded to float32 (the tensor cores' float32 sums, modelled without
    their rounding), then (lo + mid) + hi; the parts added in order from
    0, and xg added last."""
    b, s, four_d = xg.shape
    d = four_d // 4
    hh, dh, _ = r.shape
    c, n, h = (a.copy() for a in state)
    kl = dh // kparts
    out = np.zeros((b, s, d), np.float32)
    for t in range(s):
        hi = _bf16(h)
        mid = _bf16(h - hi)
        lo = _bf16(h - hi - mid)
        rh = np.zeros((b, hh, 4 * dh), np.float32)
        for head in range(hh):
            cols = slice(head * dh, (head + 1) * dh)
            total = np.zeros((b, 4 * dh), np.float32)
            for q in range(kparts):
                ks = slice(q * kl, (q + 1) * kl)
                rq = r[head][ks].astype(np.float64)
                hi_s, mid_s, lo_s = ((term[:, cols][:, ks] @ rq).astype(
                    np.float32) for term in (hi, mid, lo))
                total = total + ((lo_s + mid_s) + hi_s)
            rh[:, head] = total
        g = xg[:, t] + rh.reshape(b, hh, 4, dh).transpose(0, 2, 1, 3).reshape(
            b, 4 * d)
        ig = np.exp(np.minimum(g[:, :d], np.float32(8)))
        fg = np.float32(1) / (np.float32(1) + np.exp(-g[:, d:2 * d]))
        zg = np.tanh(g[:, 2 * d:3 * d])
        og = np.float32(1) / (np.float32(1) + np.exp(-g[:, 3 * d:]))
        c = fg * c + ig * zg
        n = fg * n + ig
        h = og * (c / np.maximum(np.abs(n), np.float32(1)))
        out[:, t] = h
    return out, (c, n, h)


@pytest.mark.parametrize("b,s,d,hh", [
    (2, 16, 64, 2),  # dh 32: 2 K parts of one tile
    (3, 8, 256, 2),  # dh 128: 4 K parts of two tiles
])
def test_slstm_cluster_summation_order_matches_ref_and_pallas(b, s, d, hh):
    """A numpy model of the cluster kernel's order of summation (bf16 R),
    from zero and from a non-zero state, against ``ref.slstm_scan_ref``
    and (from zero) the Pallas kernel in interpret mode, at 2e-5."""
    xg, r = _slstm_inputs(b, s, d, hh, seed=5)
    r = _bf16(r)
    p = slstm_scan_mod.plan(b, d, hh, torch.bfloat16)
    assert p.route == "cluster"
    zero = [np.zeros((b, d), np.float32) for _ in range(3)]
    state = [_np((b, d), 20 + i) for i in range(3)]
    state[1] = np.abs(state[1]) + 1.0
    pallas = jslstm_scan(jnp.asarray(xg), jnp.asarray(r), n_heads=hh,
                         block_t=s, interpret=True)
    for st in (zero, state):
        got, final = _cluster_model(xg, r, st, p.kslices)
        want, want_final = ref.slstm_scan_ref(
            torch.from_numpy(xg), torch.from_numpy(r),
            tuple(torch.from_numpy(a) for a in st))
        _close(torch.from_numpy(got), want.numpy(), 2e-5)
        for g, w in zip(final, want_final):
            _close(torch.from_numpy(g), w.numpy(), 2e-5)
        if st is zero:
            _close(torch.from_numpy(got), pallas, 2e-5)


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
    for rdt in (torch.float32, torch.bfloat16):  # both B8 routes
        tr = torch.from_numpy(r).to(rdt)
        hs, _ = slstm_scan(torch.from_numpy(xg).to(dev), tr.to(dev))
        want, _ = ref.slstm_scan_ref(torch.from_numpy(xg), tr)
        _close(hs.cpu(), want.numpy(), 2e-5)
