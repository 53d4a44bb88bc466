"""The port's wire codec against the JAX package's, byte for byte.

Each case of ``tests/test_wire_codec.py`` and ``tests/test_wire_pack.py``
goes through the JAX codec (numpy reference) and through the port's codec
under both impls — ``numpy`` and ``cuda`` (on a CPU tensor the kernels'
plain versions run) — and must give the same metas, bytes, residuals and
decoded values. Sharded encode and device-resident decode accumulation are
held to the same bytes.
"""

from __future__ import annotations

import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.runtime import sharding as jsharding
from repro.wire import codec as jcodec

from repro_torch.runtime import sharding
from repro_torch.wire import codec

BF16 = np.dtype(ml_dtypes.bfloat16)
DTYPES = {
    "f32": np.dtype(np.float32),
    "f16": np.dtype(np.float16),
    "bf16": BF16,
    "i32": np.dtype(np.int32),
}
SHAPES = ((), (1,), (5,), (128,), (129,), (16, 4), (3, 5, 7))
SCHEMES = ("dense", "sparse", "bitmap", "auto")


def _leaf(shape, dtype, density, seed=0):
    """tests/test_wire_codec.py's leaf generator."""
    dtype = np.dtype(dtype)
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape or ())
    mask = rng.random(shape or ()) < density
    a = np.where(mask, a, 0.0)
    if dtype.kind == "i":
        return (a * 10).astype(dtype)
    return a.astype(dtype)


def _join(parts) -> bytes:
    return b"".join(bytes(p) for p in parts)


def _np(x) -> np.ndarray:
    return codec.to_numpy(x)


def _check_leaf(a: np.ndarray, scheme: str, quant: str) -> None:
    jm, jp, jr = jcodec.encode_leaf(a, scheme=scheme, quant=quant, key="k",
                                    with_residual=True)
    jblob = _join(jp)
    inputs = (("numpy", a), ("numpy", codec.to_tensor(a)),
              ("cuda", codec.to_tensor(a)), ("auto", codec.to_tensor(a)))
    for impl, x in inputs:
        m, p, r = codec.encode_leaf(x, scheme=scheme, quant=quant, key="k",
                                    with_residual=True, impl=impl)
        assert m == jm, (impl, m, jm)
        assert _join(p) == jblob, impl
        assert _np(r).dtype == jr.dtype and _np(r).tobytes() == jr.tobytes()
        assert _np(r).shape == jr.shape
    want = jcodec.decode_leaf(jm, jblob)
    for impl in ("numpy", "cuda"):
        got = codec.decode_leaf(jm, jblob, impl=impl, device="cpu")
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("density", (0.0, 0.15, 1.0))
def test_codec_cases_match_jax(scheme, dtype, shape, density):
    _check_leaf(_leaf(shape, DTYPES[dtype], density), scheme, "none")


@pytest.mark.parametrize("scheme", ("dense", "sparse", "bitmap"))
@pytest.mark.parametrize("quant", ("fp16", "bf16"))
@pytest.mark.parametrize("dtype", ("f32", "f16", "bf16"))
def test_quantized_cases_match_jax(scheme, quant, dtype):
    a = _leaf((37, 11), DTYPES[dtype], 0.3, seed=4)
    _check_leaf(a, scheme, quant)


def test_negative_zero_and_large_leaf_match_jax():
    a = np.array([-0.0, 0.0, 1.5, -0.0], dtype=np.float32)
    for quant in ("none", "fp16"):
        _check_leaf(a, "dense", quant)
    n = codec.CUDA_AUTO_MIN_N + 17
    big = _leaf((n,), np.float32, 0.05, seed=3)
    _check_leaf(big, "auto", "fp16")


@settings(max_examples=40, deadline=None)
@given(
    n=st.integers(0, 3000),
    density=st.sampled_from((0.0, 0.05, 0.3, 1.0)),
    seed=st.integers(0, 2**16),
    scheme=st.sampled_from(SCHEMES),
    dq=st.sampled_from((("f32", "none"), ("f32", "fp16"), ("f32", "bf16"),
                        ("f16", "none"), ("bf16", "none"), ("i32", "none"))),
)
def test_encode_property_matches_jax(n, density, seed, scheme, dq):
    dtype, quant = dq
    _check_leaf(_leaf((n,), DTYPES[dtype], density, seed), scheme, quant)


@settings(max_examples=25, deadline=None)
@given(
    n=st.integers(1, 2000),
    density=st.sampled_from((0.0, 0.1, 1.0)),
    seed=st.integers(0, 2**16),
    dtype=st.sampled_from(("f32", "i32")),
)
def test_decode_add_matches_jax(n, density, seed, dtype):
    a = _leaf((n,), DTYPES[dtype], density, seed)
    meta, parts, _ = jcodec.encode_leaf(a, scheme="bitmap", key="k")
    blob = _join(parts)
    target = _leaf((n,), DTYPES[dtype], 1.0, seed + 1)
    if dtype == "f32":
        target[::5] = -0.0
    want = jcodec.decode_add_leaf(target.copy(), meta, blob)
    for impl in ("numpy", "cuda"):
        got = codec.decode_add_leaf(codec.to_tensor(target), meta, blob,
                                    impl=impl)
        assert _np(got).tobytes() == np.asarray(want).tobytes()


def test_resolve_impl_gates():
    f32, i64 = np.dtype(np.float32), np.dtype(np.int64)
    assert codec.resolve_impl("numpy", 1000, f32) == "numpy"
    assert codec.resolve_impl("cuda", 0, f32) == "numpy"
    assert codec.resolve_impl("cuda", 1000, i64) == "numpy"
    assert codec.resolve_impl("cuda", 1000, f32) == "cuda"
    assert codec.resolve_impl("auto", 100, f32) == "numpy"
    assert codec.resolve_impl("auto", codec.CUDA_AUTO_MIN_N, f32) == "cuda"
    assert codec.CUDA_AUTO_MIN_N == jcodec.PALLAS_AUTO_MIN_N
    with pytest.raises(ValueError):
        codec.resolve_impl("pallas", 10, f32)


def test_sizing_and_tree_helpers_match_jax():
    for n, nnz, isz in ((1, 0, 4), (129, 7, 2), (10**6, 5000, 4)):
        for s in ("dense", "sparse", "bitmap"):
            assert codec.leaf_nbytes(s, n, nnz, isz) == jcodec.leaf_nbytes(
                s, n, nnz, isz)
        assert codec.best_scheme(n, nnz, isz) == jcodec.best_scheme(
            n, nnz, isz)
    tree = {"b": _leaf((7, 3), np.float32, 0.4, 1),
            "a": [_leaf((33,), np.float32, 0.1, 2), _leaf((), np.int32, 1, 3)]}
    ttree = {"b": codec.to_tensor(tree["b"]),
             "a": [codec.to_tensor(x) for x in tree["a"]]}
    jm, jb = jcodec.encode_tree(tree)
    m, b = codec.encode_tree(ttree)
    assert (m, b) == (jm, jb)
    assert codec.predict_tree_nbytes(ttree) == jcodec.predict_tree_nbytes(
        tree) == codec.tree_nbytes(m)
    back = codec.decode_tree(m, b, ttree)
    assert back["b"].tobytes() == tree["b"].tobytes()


@pytest.mark.filterwarnings("ignore:shard\\(s\\)")
@pytest.mark.parametrize("n_shards", (1, 2, 3))
@pytest.mark.parametrize("split_bytes", (0, 1024))
@pytest.mark.parametrize("impl", ("numpy", "cuda"))
def test_sharded_encode_matches_jax(n_shards, split_bytes, impl):
    from repro.models.pmf import PMFParams as JParams

    from repro_torch.models.pmf import PMFParams

    U = _leaf((40, 6), np.float32, 0.2, 5)
    M = _leaf((6, 70), np.float32, 0.2, 6)
    jt = JParams(U=U, M=M)
    tt = PMFParams(codec.to_tensor(U), codec.to_tensor(M))
    ja = jsharding.tree_assignment(jt, n_shards, split_bytes=split_bytes)
    ta = sharding.tree_assignment(tt, n_shards, split_bytes=split_bytes)
    assert ta == ja
    jps, jres = jsharding.encode_tree_sharded(
        jt, ja, n_shards, quant="fp16", with_residual=True,
        split_bytes=split_bytes)
    tps, tres = sharding.encode_tree_sharded(
        tt, ta, n_shards, quant="fp16", with_residual=True,
        split_bytes=split_bytes, impl=impl)
    for (jm, jp), (tm, tp) in zip(jps, tps):
        assert tm == jm and _join(tp) == _join(jp)
    assert _np(tres.U).tobytes() == np.asarray(jres.U).tobytes()
    assert _np(tres.M).tobytes() == np.asarray(jres.M).tobytes()
    assert sharding.predict_shard_nbytes(
        tt, ta, n_shards, split_bytes=split_bytes) == \
        jsharding.predict_shard_nbytes(jt, ja, n_shards,
                                       split_bytes=split_bytes)


@pytest.mark.parametrize("impl", ("numpy", "cuda"))
def test_leafbuffers_on_device_match_jax(impl):
    """Decode accumulators fold peers' parts to the same float32 bits as
    the JAX package's host buffers, whichever impl decodes."""
    like_np = {"w": ((700,), np.float32), "b": ((33,), np.float32)}
    jbufs = jsharding.LeafBuffers(like_np)
    tbufs = sharding.LeafBuffers(
        {k: (s, torch.float32) for k, (s, _) in like_np.items()}, "cpu")
    for seed in range(4):
        for k, (shape, _) in like_np.items():
            a = _leaf(shape, np.float32, 0.3, 10 + seed)
            meta, parts, _ = jcodec.encode_leaf(a, scheme="bitmap",
                                                quant="fp16", key=k)
            blob = _join(parts)
            jbufs.add_encoded(meta, blob)
            tbufs.add_encoded(meta, blob, impl=impl)
    for k in like_np:
        assert _np(tbufs[k]).tobytes() == jbufs[k].tobytes()
    tbufs.assert_complete(copies=4)
