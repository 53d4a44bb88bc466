"""The port's kernels (B1, B4, B5) held to the JAX package on the CPU.

On the CPU each wrapper runs its plain PyTorch version; here those plain
versions are compared bit for bit with the JAX Pallas kernels run in
interpret mode and with the JAX package's numpy codec, on the same numpy
inputs. The CUDA kernels themselves are compared with their plain versions
on the card by ``chip_smoke.py`` and by the ``cuda``-marked test below.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp
from repro.kernels import ref as jref
from repro.kernels import significance as jsig
from repro.kernels import wire_pack as jwp
from repro.wire import codec as jcodec

from repro_torch.kernels import build, ref, significance, wire_pack
from repro_torch.kernels.ops import significance_tree

SIZES = (1, 7, 129, 1025, 4097)


def _sig_inputs(n, seed):
    rng = np.random.default_rng(seed)
    u = (rng.standard_normal(n) * 0.05).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    r = (rng.standard_normal(n) * 0.05).astype(np.float32)
    u[::5] = -0.0
    x[::7] = 0.0
    r[: min(n, 64)] = -0.0
    return u, x, r


def _sparse(n, density, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(n) * 3
    a[rng.random(n) >= density] = 0.0
    if np.dtype(dtype).kind == "i":
        return (a * 100).astype(dtype)
    out = a.astype(np.float32)
    out[1::11] = np.where(out[1::11] == 0, -0.0, out[1::11])
    return out.astype(dtype)


def _bits(t):
    return t.contiguous().view(torch.uint8).numpy().tobytes() if \
        t.dtype.is_floating_point else t.numpy().tobytes()


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("v_t", (0.0, 0.3, 0.7))
def test_significance_plain_matches_pallas_interpret(n, v_t):
    u, x, r = _sig_inputs(n, seed=n)
    vt32 = float(np.float32(v_t))
    sig, res = significance.significance_filter(
        torch.from_numpy(u), torch.from_numpy(x), torch.from_numpy(r), vt32)
    jsig_, jres = jsig.significance_filter(
        jnp.asarray(u), jnp.asarray(x), jnp.asarray(r),
        jnp.asarray(vt32, jnp.float32), interpret=True)
    assert _bits(sig) == np.asarray(jsig_).tobytes()
    assert _bits(res) == np.asarray(jres).tobytes()


@pytest.mark.parametrize("shape", ((5,), (16, 9), (3, 5, 7)))
def test_significance_tree_matches_jax_ref(shape):
    rng = np.random.default_rng(3)
    u, x, r = (rng.standard_normal(shape).astype(np.float32) * s
               for s in (0.05, 1.0, 0.05))
    tree_t = {"a": torch.from_numpy(u)}
    sig, res = significance_tree(tree_t, {"a": torch.from_numpy(x)},
                                 {"a": torch.from_numpy(r)}, 0.4)
    js, jr = jref.significance_ref(jnp.asarray(u), jnp.asarray(x),
                                   jnp.asarray(r), 0.4)
    assert _bits(sig["a"]) == np.asarray(js).tobytes()
    assert _bits(res["a"]) == np.asarray(jr).tobytes()


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("vdt", ("float32", "float16", "bfloat16"))
def test_wire_pack_plain_matches_pallas_interpret(n, vdt):
    flat = _sparse(n, 0.3, seed=n)
    tdt = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16}[vdt]
    got = wire_pack.wire_pack(torch.from_numpy(flat), tdt)
    want = jwp.wire_pack(jnp.asarray(flat), vdt=np.dtype(jnp.dtype(vdt)),
                         block_rows=jwp.pick_block_rows(n), interpret=True)
    mask, qdense, cvals, cidx, nnz, res = want
    k = int(nnz)
    assert int(got[4]) == k
    assert _bits(got[0]) == np.asarray(mask).tobytes()
    assert _bits(got[1]) == np.asarray(qdense).tobytes()
    assert _bits(got[2][:k]) == np.asarray(cvals)[:k].tobytes()
    assert _bits(got[3][:k]) == np.asarray(cidx)[:k].tobytes()
    assert _bits(got[5]) == np.asarray(res).tobytes()


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", ("float32", "int32"))
def test_wire_unpack_add_plain_matches_pallas_interpret(n, dtype):
    npdt = np.dtype(dtype)
    flat = _sparse(n, 0.2, seed=n + 1, dtype=npdt)
    target = _sparse(n, 1.0, seed=n + 2, dtype=npdt)
    if dtype == "float32":
        target[::4] = -0.0  # the unconditional +0 turns these into +0.0
    mask = np.packbits(flat != 0, bitorder="little")
    cvals = flat[flat != 0]
    got = wire_pack.wire_unpack_add(torch.from_numpy(target),
                                    torch.from_numpy(mask),
                                    torch.from_numpy(cvals))
    cap = 1 << max(cvals.size - 1, 0).bit_length()
    cpad = np.zeros(cap, npdt)
    cpad[: cvals.size] = cvals
    want = jwp.wire_unpack_add(jnp.asarray(target), jnp.asarray(mask),
                               jnp.asarray(cpad),
                               block_rows=jwp.pick_block_rows(n),
                               interpret=True)
    assert _bits(got) == np.asarray(want).tobytes()
    assert _bits(got) == (target + np.where(flat != 0, flat, 0)).tobytes()


@settings(max_examples=30, deadline=None)
@given(
    n=st.integers(1, 3000),
    density=st.sampled_from((0.0, 0.05, 0.5, 1.0)),
    seed=st.integers(0, 2**16),
    vdt=st.sampled_from(("float32", "float16", "bfloat16")),
)
def test_wire_pack_plain_matches_numpy_codec(n, density, seed, vdt):
    """Mask bytes, compacted values and residual equal what the JAX
    package's numpy codec ships for a bitmap leaf."""
    flat = _sparse(n, density, seed)
    quant = {"float32": "none", "float16": "fp16", "bfloat16": "bf16"}[vdt]
    meta, parts, res = jcodec.encode_leaf(flat, scheme="bitmap",
                                          quant=quant, with_residual=True)
    blob = b"".join(bytes(p) for p in parts)
    tdt = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16}[vdt]
    mask, _q, cvals, _i, nnz, resid = wire_pack.wire_pack(
        torch.from_numpy(flat), tdt)
    k = int(nnz)
    assert k == meta["nnz"]
    assert _bits(mask) + _bits(cvals[:k]) == blob
    if quant != "none":
        assert _bits(resid) == res.tobytes()


@settings(max_examples=30, deadline=None)
@given(
    n=st.integers(1, 3000),
    density=st.sampled_from((0.0, 0.1, 1.0)),
    seed=st.integers(0, 2**16),
)
def test_wire_unpack_plain_matches_numpy_decode(n, density, seed):
    flat = _sparse(n, density, seed)
    meta, parts, _ = jcodec.encode_leaf(flat, scheme="bitmap")
    mask = np.packbits(flat != 0, bitorder="little")
    got = wire_pack.wire_unpack(torch.from_numpy(mask),
                                torch.from_numpy(flat[flat != 0]), n,
                                torch.float32)
    want = jcodec.decode_leaf(meta, b"".join(bytes(p) for p in parts))
    assert _bits(got) == want.tobytes()


def test_packbits_matches_numpy():
    rng = np.random.default_rng(0)
    for n in (1, 7, 8, 9, 500, 1025):
        m = rng.random(n) < 0.3
        got = ref.packbits_le(torch.from_numpy(m))
        assert _bits(got) == np.packbits(m, bitorder="little").tobytes()
        back = ref.unpackbits_le(got, n)
        assert np.array_equal(back.numpy(), m)


def test_wrappers_reject_what_the_kernels_do_not_take():
    f = torch.zeros(8)
    with pytest.raises(TypeError):
        significance.significance_filter(f.double(), f.double(),
                                         f.double(), 0.5)
    with pytest.raises(ValueError):
        significance.significance_filter(f, f[:4], f, 0.5)
    with pytest.raises(TypeError):
        wire_pack.wire_pack(f.to(torch.int32), torch.float16)
    with pytest.raises(ValueError):
        wire_pack.wire_pack(torch.zeros(0), torch.float32)
    with pytest.raises(TypeError):
        wire_pack.wire_unpack_add(f.half(), torch.zeros(1, dtype=torch.uint8),
                                  f.half())


def test_plain_versions_launch_nothing():
    """Launch counts move only where a kernel runs on the card."""
    build.reset_launches()
    u, x, r = (torch.from_numpy(a) for a in _sig_inputs(100, 1))
    sig, _ = significance.significance_filter(u, x, r, 0.3)
    wire_pack.wire_pack(sig, torch.float32)
    assert sum(build.LAUNCHES.values()) == 0


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    """B1, B4, B5 bit-exact against their plain versions on a CUDA card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs this check)")
    dev = torch.device("cuda")
    build.reset_launches()
    for n in (1, 7, 127, 1000003):
        u, x, r = (torch.from_numpy(a).to(dev) for a in _sig_inputs(n, n))
        got = significance.significance_filter(u, x, r, 0.3)
        want = ref.significance_ref(u, x, r, 0.3)
        for g, w in zip(got, want):
            assert _bits(g.cpu()) == _bits(w.cpu())
        kp = wire_pack.wire_pack(want[0], torch.float16)
        rp = ref.wire_pack_ref(want[0], torch.float16)
        k = int(rp[4])
        assert _bits(kp[0].cpu()) == _bits(rp[0].cpu())
        assert _bits(kp[2][:k].cpu()) == _bits(rp[2][:k].cpu())
        t = torch.randn(n, device=dev)
        assert _bits(wire_pack.wire_unpack_add(t, rp[0], rp[2][:k]).cpu()) \
            == _bits(ref.wire_unpack_add_ref(t, rp[0], rp[2][:k]).cpu())
    assert build.LAUNCHES["significance_filter"] == 4
