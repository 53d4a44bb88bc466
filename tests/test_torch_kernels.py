"""The port's kernels (B1, B2, B3, B4, B5) held to the JAX package on the CPU.

On the CPU each wrapper runs its plain PyTorch version; here those plain
versions are compared bit for bit with the JAX Pallas kernels run in
interpret mode and with the JAX package's numpy codec, on the same numpy
inputs. B2 and B3 are Adam arithmetic, where the Pallas kernel rounds
``1 - b2`` in float32 and the JAX ``adam_ref`` (like the port) from double:
they are held to the JAX kernel at the tolerances of
``tests/test_kernels.py`` (1e-5, 2e-2 at bfloat16). The CUDA kernels
themselves are compared with their plain versions on the card by
``chip_smoke.py`` and by the ``cuda``-marked test below.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax
import jax.numpy as jnp
from repro import optim as joptim
from repro.kernels import fused_adam as jfa
from repro.kernels import ref as jref
from repro.kernels import significance as jsig
from repro.kernels import wire_pack as jwp
from repro.wire import codec as jcodec

from repro_torch import optim
from repro_torch.kernels import build, fused_adam, ref, significance, wire_pack
from repro_torch.kernels.ops import (adam_isp_tree, adam_tree,
                                     fused_adam as fused_adam_tree,
                                     fused_adam_sig, significance_tree)
from repro_torch.wire import codec

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


@pytest.mark.parametrize("n", (7, 1000, 4097))
@pytest.mark.parametrize("density", (0.05, 1.0))
@pytest.mark.parametrize("short", (1, 3, "empty"))
def test_wire_unpack_short_values_plain_matches_pallas_interpret(n, density,
                                                                 short):
    """With fewer values than set mask bits, each gather position is
    clamped to the last value, as JAX's ``wire_unpack_add`` clamps it to
    the values' capacity: the plain ``wire_unpack_add`` and
    ``wire_unpack`` against JAX in interpret mode, bit for bit. JAX
    refuses to gather from an empty array; the port reads no values as
    one zero slot, which is what JAX is given then."""
    flat = _sparse(n, density, seed=n + 11)
    target = _sparse(n, 1.0, seed=n + 12)
    target[::4] = -0.0
    mask = np.packbits(flat != 0, bitorder="little")
    support = flat[flat != 0]
    cvals = support[:0] if short == "empty" else \
        support[:max(support.size - short, 0)]
    jvals = cvals if cvals.size else np.zeros(1, np.float32)
    got = wire_pack.wire_unpack_add(torch.from_numpy(target),
                                    torch.from_numpy(mask),
                                    torch.from_numpy(cvals))
    want = jwp.wire_unpack_add(jnp.asarray(target), jnp.asarray(mask),
                               jnp.asarray(jvals),
                               block_rows=jwp.pick_block_rows(n),
                               interpret=True)
    assert _bits(got) == np.asarray(want).tobytes()
    got = wire_pack.wire_unpack(torch.from_numpy(mask),
                                torch.from_numpy(cvals), n, torch.float32)
    want = jwp.wire_unpack(jnp.asarray(mask), jnp.asarray(jvals), n=n,
                           dtype=jnp.float32,
                           block_rows=jwp.pick_block_rows(n), interpret=True)
    assert _bits(got) == np.asarray(want).tobytes()
    bits = flat != 0
    pos = np.clip(np.cumsum(bits) - 1, 0, jvals.size - 1)
    assert _bits(got) == np.where(bits, jvals[pos], 0).astype(
        np.float32).tobytes()


_HALF = {"float16": torch.float16, "bfloat16": torch.bfloat16}


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype,vdt", [("float16", "float16"),
                                       ("float16", "bfloat16"),
                                       ("bfloat16", "bfloat16"),
                                       ("bfloat16", "float16")])
def test_wire_unpack_half_targets_plain_matches_pallas_interpret(n, dtype,
                                                                 vdt):
    """B5's decode-only form into float16 and bfloat16 leaves (the values
    in the leaf's wire type or the other half type): the plain version
    against JAX ``wire_unpack`` in interpret mode and numpy's decode, bit
    for bit."""
    flat = torch.from_numpy(_sparse(n, 0.2, seed=n + 5)).to(_HALF[vdt])
    mask = ref.packbits_le(flat != 0)
    cvals = flat[flat != 0]
    got = wire_pack.wire_unpack(mask, cvals, n, _HALF[dtype])
    assert got.dtype == _HALF[dtype]
    ncv = codec.to_numpy(cvals)
    cap = 1 << max(ncv.size - 1, 0).bit_length()
    cpad = np.zeros(cap, ncv.dtype)
    cpad[: ncv.size] = ncv
    want = jwp.wire_unpack(jnp.asarray(mask.numpy()), jnp.asarray(cpad), n=n,
                           dtype=jnp.dtype(dtype),
                           block_rows=jwp.pick_block_rows(n), interpret=True)
    assert _bits(got) == np.asarray(want).tobytes()
    numpy = np.zeros(n, codec.np_dtype(_HALF[dtype]))
    numpy[codec.to_numpy(flat != 0)] = ncv.astype(numpy.dtype)
    assert _bits(got) == numpy.tobytes()


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
    with pytest.raises(TypeError):  # half targets decode half values only
        wire_pack.wire_unpack(torch.zeros(1, dtype=torch.uint8), f, 8,
                              torch.bfloat16)


def test_plain_versions_launch_nothing():
    """Launch counts move only where a kernel runs on the card."""
    build.reset_launches()
    u, x, r = (torch.from_numpy(a) for a in _sig_inputs(100, 1))
    sig, _ = significance.significance_filter(u, x, r, 0.3)
    wire_pack.wire_pack(sig, torch.float32)
    fused_adam.adam_sig_update(u, x, r, r.abs(), sig, 1e-3, 1, 0.3)
    fused_adam.adam_update(u, x, r, r.abs(), 1e-3, 1)
    assert sum(build.LAUNCHES.values()) == 0


_WIRE_CU = Path(wire_pack.__file__).parent / "csrc" / "wire_pack.cu"


def _wire_constants() -> dict:
    """The ``constexpr`` integers of ``csrc/wire_pack.cu``, evaluated in
    order (``ull`` suffixes dropped, ``/`` as integer division)."""
    env: dict = {}
    for name, expr in re.findall(
            r"constexpr (?:int|int64_t|uint64_t|unsigned) (k\w+) = ([^;]+);",
            _WIRE_CU.read_text()):
        expr = re.sub(r"\b(0x[0-9a-f]+|\d+)(?:ull|u)\b", r"\1", expr)
        expr = expr.replace("/", "//")
        env[name] = eval(expr, {"__builtins__": {}}, dict(env))
    return env


@pytest.mark.parametrize("py,c", [
    ("THREADS", "kThreads"), ("ITEMS", "kItems"), ("TILE", "kTile"),
    ("STATUS_BASE", "kStatusBase"), ("SEQ_SHIFT", "kSeqShift"),
    ("INCLUSIVE", "kInclusive"), ("MAX_ELEMENTS", "kMaxElements"),
])
def test_wire_lookback_constants_are_the_kernels(py, c):
    """What the wrapper assumes of B4's and B5's tile and status words (it
    sizes the look-back buffer from them) is what ``wire_pack.cu``
    declares; a drift would show only as a hang or a wrong offset on the
    card."""
    assert getattr(wire_pack, py) == _wire_constants()[c]


def test_wire_status_word_holds_every_count():
    """A status word is (seq << 32) | flag | count: the largest count and
    the largest sequence number fit beside the flag, in 64 bits."""
    c = _wire_constants()
    assert c["kCountMask"] == wire_pack.INCLUSIVE - 1 >= wire_pack.MAX_ELEMENTS
    assert wire_pack.INCLUSIVE << 1 == 1 << wire_pack.SEQ_SHIFT
    word = (wire_pack.SEQ_LIMIT << wire_pack.SEQ_SHIFT) | wire_pack.INCLUSIVE \
        | wire_pack.MAX_ELEMENTS
    assert word < 2**64 and word >> wire_pack.SEQ_SHIFT == wire_pack.SEQ_LIMIT
    assert wire_pack.tiles(wire_pack.MAX_ELEMENTS) < 2**32


def test_wire_lookback_buffer_is_kept_per_stream_and_never_reset_per_call():
    """The look-back buffer of one (device, stream) is reused across calls
    and sizes and grows (zeroed) when a call needs more tiles; each call
    gets the buffer's next sequence number, and a new buffer (made, grown,
    or after the last number) starts again at 1; another stream has its
    own."""
    lb = wire_pack.Lookback()
    cpu = torch.device("cpu")
    words, seq = lb.take(cpu, 7, wire_pack.tiles(1))
    assert (words.numel(), seq) == (wire_pack.STATUS_BASE + 1, 1)
    assert words.dtype == torch.int64 and not words.any()
    words[:] = 5  # what calls leave behind is never cleared
    again, seq = lb.take(cpu, 7, 1)
    assert again.data_ptr() == words.data_ptr() and seq == 2
    n = 3 * wire_pack.TILE + 1
    grown, seq = lb.take(cpu, 7, wire_pack.tiles(n))
    assert seq == 1 and not grown.any()  # a new buffer starts again at 1
    assert grown.numel() == max(wire_pack.STATUS_BASE + 4, 2 * words.numel())
    small, seq = lb.take(cpu, 7, 1)
    assert small.data_ptr() == grown.data_ptr() and seq == 2
    other, seq = lb.take(cpu, 8, 1)
    assert other.data_ptr() != grown.data_ptr() and seq == 1
    lb._bufs[(str(cpu), 7)] = (grown, wire_pack.SEQ_LIMIT - 1)
    last, seq = lb.take(cpu, 7, 1)
    assert last.data_ptr() == grown.data_ptr() and seq == wire_pack.SEQ_LIMIT
    grown[:] = 9
    fresh, seq = lb.take(cpu, 7, 1)
    assert seq == 1 and not fresh.any()


@pytest.mark.parametrize("n", (1, 7, 129, 4095, 4096, 4097, 3 * 4096 + 5))
@pytest.mark.parametrize("density", (0.0, 0.05, 1.0))
def test_wire_tile_layout_model(n, density):
    """A numpy model of B4's and B5's index arithmetic, with the kernel's
    constants: a tile's (warp, run, lane, element) order is flat order, so
    in-tile prefixes plus tile offsets are the flat cumsum; B5's nibble of
    a mask byte is the lane's flags (none past n), and B4's OR of 8 lanes'
    nibbles is the packed mask word, zero tail bits included."""
    c = _wire_constants()
    assert c["kWarps"] * c["kWarpSpan"] == c["kTile"]
    assert c["kRuns"] * c["kRun"] == c["kWarpSpan"]
    assert c["kRun"] == 32 * c["kGroup"] and c["kGroup"] * 2 == 8
    nt = wire_pack.tiles(n)
    tile, warp, run, lane = np.meshgrid(
        np.arange(nt), np.arange(c["kWarps"]), np.arange(c["kRuns"]),
        np.arange(32), indexing="ij")
    g = tile * c["kTile"] + warp * c["kWarpSpan"] + c["kGroup"] * lane \
        + run * c["kRun"]
    elems = (g[..., None] + np.arange(c["kGroup"])).reshape(-1)
    assert np.array_equal(elems, np.arange(nt * c["kTile"]))
    rng = np.random.default_rng(n)
    bits = rng.random(n) < density
    padded = np.zeros(nt * c["kTile"], bool)
    padded[:n] = bits
    mask = np.packbits(bits, bitorder="little")
    nib = np.where(g < n, (mask[np.minimum(g, n - 1) >> 3] >> (g & 4)) & 15,
                   0)
    left = np.clip(n - g, 0, c["kGroup"])
    nib &= (1 << left) - 1
    flags = (nib[..., None] >> np.arange(c["kGroup"])) & 1
    assert np.array_equal(flags.reshape(-1).astype(bool), padded)
    # lanes 8q..8q+7 OR their nibbles into mask word q of the run
    words = (nib << (c["kGroup"] * (lane & 7))).reshape(*g.shape[:3], 4, 8)
    words = np.bitwise_or.reduce(words, axis=-1).astype("<u4")
    packed = words.reshape(-1).view(np.uint8)[: (n + 7) // 8]
    assert packed.tobytes() == mask.tobytes()
    counts = flags.reshape(nt, -1).sum(1)  # each tile's aggregate
    offset = np.concatenate([[0], np.cumsum(counts)[:-1]])
    in_tile = np.cumsum(flags.reshape(nt, -1), 1) - flags.reshape(nt, -1)
    pos = (offset[:, None] + in_tile).reshape(-1)[:n]
    assert np.array_equal(pos[bits], np.arange(int(bits.sum())))


def _adam_inputs(shape, seed):
    """p, g, mu, nu (>= 0) and r as float32 numpy arrays of ``shape``, with
    -0.0 in g."""
    rng = np.random.default_rng(seed)
    p, g, mu, nu, r = (np.asarray(rng.standard_normal(shape), np.float32)
                       for _ in range(5))
    g.reshape(-1)[::9] = -0.0
    return p, g, mu, np.abs(nu, out=nu), np.asarray(r * 1e-3, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("shape", ((), (1,), (13,), (100,), (256, 128),
                                   (33, 5)))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("step", (1, 100))
def test_adam_update_plain_matches_pallas_interpret(shape, dtype, step):
    p, g, mu, nu, _ = _adam_inputs(shape, seed=len(shape) + step)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    got = fused_adam.adam_update(
        torch.from_numpy(p).to(tdt), torch.from_numpy(g).to(tdt),
        torch.from_numpy(mu), torch.from_numpy(nu), 1e-3, step)
    want = jfa.adam_update(jnp.asarray(p, jdt), jnp.asarray(g, jdt),
                           jnp.asarray(mu), jnp.asarray(nu), 1e-3, step,
                           interpret=True)
    assert got[0].dtype == tdt and got[0].shape == shape
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    for a, b in zip(got, want):
        _close(a, b, tol)


@pytest.mark.parametrize("wd", (0.0, 0.1))
def test_adam_update_weight_decay_matches_pallas_interpret(wd):
    p, g, _, _, _ = _adam_inputs((128,), seed=8)
    z = np.zeros(128, np.float32)
    got = fused_adam.adam_update(*(torch.from_numpy(a) for a in (p, g, z, z)),
                                 1e-2, 1, weight_decay=wd)
    want = jfa.adam_update(*(jnp.asarray(a) for a in (p, g, z, z)), 1e-2, 1,
                           weight_decay=wd, interpret=True)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("shape", ((), (1,), (13,), (500,), (64, 200)))
@pytest.mark.parametrize("v_t", (0.0, 0.7))
@pytest.mark.parametrize("step", (1, 5, 100))
def test_adam_sig_plain_matches_pallas_interpret(shape, v_t, step):
    p, g, mu, nu, r = _adam_inputs(shape, seed=9 + step)
    t = [torch.from_numpy(a) for a in (p, g, mu, nu, r)]
    sig, mu2, nu2, res, u = fused_adam.adam_sig_update(*t, 1e-3, step, v_t)
    want = jfa.adam_sig_update(*(jnp.asarray(a) for a in (p, g, mu, nu, r)),
                               1e-3, step, v_t, interpret=True)
    for a, b in zip((sig, mu2, nu2, res), want):
        assert a.shape == shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    # conservation: sig + res == r + u exactly; the mask is sig != 0
    assert torch.equal(sig + res, t[4] + u)
    assert torch.equal(sig != 0, (sig != 0) & (res == 0))


_DT = {"float32": (torch.float32, jnp.float32),
       "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.mark.parametrize("shape", ((), (1,), (13,), (100,), (256, 128),
                                   (33, 5)))
@pytest.mark.parametrize("pdtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("step", (1, 100))
def test_adam_update_bf16_moments_plain_matches_pallas_interpret(
        shape, pdtype, step):
    """B3 with bfloat16 moments (a bfloat16 model's ``zeros_like(params)``
    state), p and g in float32 or bfloat16: each output in its input's
    type, as the TPU kernel writes it, within the bfloat16 tolerance 2e-2
    (``1 - b2`` is rounded from double here, in float32 there, so the two
    are not bit-equal)."""
    p, g, mu, nu, _ = _adam_inputs(shape, seed=20 + len(shape) + step)
    tdt, jdt = _DT[pdtype]
    got = fused_adam.adam_update(
        torch.from_numpy(p).to(tdt), torch.from_numpy(g).to(tdt),
        torch.from_numpy(mu).bfloat16(), torch.from_numpy(nu).bfloat16(),
        1e-3, step)
    want = jfa.adam_update(jnp.asarray(p, jdt), jnp.asarray(g, jdt),
                           jnp.asarray(mu, jnp.bfloat16),
                           jnp.asarray(nu, jnp.bfloat16), 1e-3, step,
                           interpret=True)
    assert [t.dtype for t in got] == [tdt, torch.bfloat16, torch.bfloat16]
    assert [w.dtype for w in want] == [jdt, jnp.bfloat16, jnp.bfloat16]
    for a, b in zip(got, want):
        assert a.shape == shape
        _close(a, b, 2e-2)


@pytest.mark.parametrize("shape", ((), (1,), (13,), (500,), (64, 200)))
@pytest.mark.parametrize("v_t", (0.0, 0.7))
@pytest.mark.parametrize("step", (1, 5, 100))
def test_adam_sig_bf16_plain_matches_pallas_interpret(shape, v_t, step):
    """B2 on bfloat16 leaves (p, g, the moments and the residual): every
    output bfloat16, within the bfloat16 tolerance 2e-2 of the Pallas
    kernel; an entry is sent or kept, never both."""
    p, g, mu, nu, r = _adam_inputs(shape, seed=30 + step)
    t = [torch.from_numpy(a).bfloat16() for a in (p, g, mu, nu, r)]
    sig, mu2, nu2, res, u = fused_adam.adam_sig_update(*t, 1e-3, step, v_t)
    want = jfa.adam_sig_update(
        *(jnp.asarray(a, jnp.bfloat16) for a in (p, g, mu, nu, r)), 1e-3,
        step, v_t, interpret=True)
    for a, b in zip((sig, mu2, nu2, res), want):
        assert a.shape == shape and a.dtype == torch.bfloat16
        assert b.dtype == jnp.bfloat16
        _close(a, b, 2e-2)
    assert u.dtype == torch.bfloat16
    assert not bool(((sig != 0) & (res != 0)).any())


@pytest.mark.parametrize("pdtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("mdtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("rdtype", ("float32", "bfloat16"))
def test_adam_sig_dtype_combinations_match_pallas_interpret(pdtype, mdtype,
                                                            rdtype):
    """B2 takes p and g in one type, the moments in one, the residual in
    its own: ``sig`` and ``u`` come back in p's type, the moments in
    theirs, the residual in r's (the TPU kernel's out shapes); values
    within 1e-5 when all are float32, else 2e-2."""
    p, g, mu, nu, r = _adam_inputs((500,), seed=40)
    dts = [_DT[pdtype], _DT[pdtype], _DT[mdtype], _DT[mdtype], _DT[rdtype]]
    got = fused_adam.adam_sig_update(
        *(torch.from_numpy(a).to(d[0]) for a, d in zip((p, g, mu, nu, r),
                                                       dts)), 1e-3, 5, 0.7)
    want = jfa.adam_sig_update(
        *(jnp.asarray(a, d[1]) for a, d in zip((p, g, mu, nu, r), dts)),
        1e-3, 5, 0.7, interpret=True)
    assert [t.dtype for t in got] == [dts[0][0], dts[2][0], dts[2][0],
                                      dts[4][0], dts[0][0]]
    assert [w.dtype for w in want] == [dts[0][1], dts[2][1], dts[2][1],
                                       dts[4][1]]
    tol = 1e-5 if pdtype == mdtype == rdtype == "float32" else 2e-2
    for a, b in zip(got, want):
        _close(a, b, tol)


@pytest.mark.parametrize("step", (1, 100))
def test_adam_sig_u_at_one_third_matches_jax_optim(step):
    """B2's ``u`` at scale 1/3 is ``repro.optim.adam``'s update times 1/3
    (the JAX worker's ``a * inv_p`` with three workers)."""
    p, g, mu, nu, r = _adam_inputs((300,), seed=11)
    jopt = joptim.adam(1e-2)
    js = joptim.OptState(jnp.asarray(step, jnp.int32), jnp.asarray(mu),
                         jnp.asarray(nu))
    ju, _ = jopt.update(jnp.asarray(g), js, jnp.asarray(p))
    want = np.asarray(ju * (1.0 / 3.0))
    out = fused_adam.adam_sig_update(
        *(torch.from_numpy(a) for a in (p, g, mu, nu, r)), 1e-2, step, 0.5,
        scale=1.0 / 3.0)
    np.testing.assert_allclose(out[4].numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("inv_p", (1.0, 0.25, 1.0 / 3.0))
@pytest.mark.parametrize("lr_decay", (False, True))
def test_fused_worker_step_equals_adam_then_filter(inv_p, lr_decay):
    """``adam_isp_tree`` against the port's unfused worker step,
    ``optim.adam`` -> ``* inv_p`` -> ``significance_ref``, over three steps
    on a tree with a 0-d leaf: masks identical, values within 1e-6."""
    rng = np.random.default_rng(12)
    params = {"w": torch.from_numpy(rng.standard_normal(257).astype(
        np.float32)), "b": torch.tensor(0.0)}
    opt = optim.adam(1e-2, lr_decay=lr_decay)
    fs = us = opt.init(params)
    fres = ures = {k: torch.zeros_like(v) for k, v in params.items()}
    for t in (1, 2, 3):
        grads = {k: torch.from_numpy(rng.standard_normal(v.shape).astype(
            np.float32)) for k, v in params.items()}
        v_t = 0.7 / np.sqrt(t)
        fu, fsig, fres, fs = adam_isp_tree(grads, fs, params, fres,
                                           opt.hparams, t, v_t, inv_p)
        upd, us = opt.update(grads, us, params)
        uu = {k: a * inv_p for k, a in upd.items()}
        usig, ures = significance_tree(uu, params, ures, v_t)
        for k in params:
            assert torch.equal(fsig[k] != 0, usig[k] != 0)
            for a, b in ((fu, uu), (fsig, usig), (fres, ures),
                         (fs.mu, us.mu), (fs.nu, us.nu)):
                np.testing.assert_allclose(a[k].numpy(), b[k].numpy(),
                                           rtol=1e-6, atol=0)
        assert fs.step.dtype == torch.int32 and int(fs.step) == int(
            us.step) == t + 1
        params = {k: params[k] + fu[k] for k in params}


@pytest.mark.parametrize("lr_decay", (False, True))
@pytest.mark.parametrize("wd", (0.0, 0.1))
def test_adam_tree_equals_adam_then_apply(lr_decay, wd):
    """``adam_tree`` (the in-process BSP step through B3) against
    ``optim.adam`` -> ``apply_updates`` over three steps on a tree with a
    0-d leaf: parameters and moments within 1e-6 relative (the fused form
    adds the float32 update before rounding), the same ``OptState``."""
    rng = np.random.default_rng(14)
    params = {"w": torch.from_numpy(rng.standard_normal(257).astype(
        np.float32)), "b": torch.tensor(0.5)}
    opt = optim.adam(1e-2, lr_decay=lr_decay, weight_decay=wd)
    fp, up = params, params
    fs = us = opt.init(params)
    for t in (1, 2, 3):
        grads = {k: torch.from_numpy(rng.standard_normal(v.shape).astype(
            np.float32)) for k, v in params.items()}
        fp, fs = adam_tree(grads, fs, fp, opt.hparams, t)
        upd, us = opt.update(grads, us, up)
        up = optim.apply_updates(up, upd)
        for k in params:
            for a, b in ((fp, up), (fs.mu, us.mu), (fs.nu, us.nu)):
                np.testing.assert_allclose(a[k].numpy(), b[k].numpy(),
                                           rtol=1e-6, atol=1e-7)
        assert fs.step.dtype == torch.int32 and int(fs.step) == int(
            us.step) == t + 1


def test_tree_entry_points_run_per_leaf():
    p, g, mu, nu, r = _adam_inputs((40,), seed=13)
    leaves = [torch.from_numpy(a) for a in (p, g, mu, nu, r)]
    trees = [{"a": x[:30], "z": x[30:].reshape(2, 5)} for x in leaves]
    got = fused_adam_sig(*trees, 1e-3, 2, 0.3)
    want = fused_adam.adam_sig_update(*leaves, 1e-3, 2, 0.3)
    for gt, w in zip(got, want):
        assert torch.equal(torch.cat([gt["a"], gt["z"].reshape(-1)]), w)
    got = fused_adam_tree(*trees[:4], 1e-3, 2, weight_decay=0.1)
    want = fused_adam.adam_update(*leaves[:4], 1e-3, 2, weight_decay=0.1)
    for gt, w in zip(got, want):
        assert torch.equal(torch.cat([gt["a"], gt["z"].reshape(-1)]), w)


def test_adam_wrappers_reject_what_the_kernels_do_not_take():
    f = torch.zeros(8)
    with pytest.raises(TypeError):
        fused_adam.adam_sig_update(f.double(), f, f, f, f, 1e-3, 1, 0.5)
    with pytest.raises(ValueError):
        fused_adam.adam_sig_update(f, f, f[:4], f, f, 1e-3, 1, 0.5)
    with pytest.raises(TypeError):
        fused_adam.adam_update(f.half(), f.half(), f, f, 1e-3, 1)
    with pytest.raises(TypeError):
        fused_adam.adam_update(f, f.bfloat16(), f, f, 1e-3, 1)
    with pytest.raises(TypeError):
        fused_adam.adam_update(f, f, f.bfloat16(), f, 1e-3, 1)
    b = f.bfloat16()
    with pytest.raises(TypeError):  # moments of two types
        fused_adam.adam_update(b, b, b, f, 1e-3, 1)
    with pytest.raises(TypeError):
        fused_adam.adam_sig_update(b, b, f, b, b, 1e-3, 1, 0.5)
    with pytest.raises(TypeError):  # p and g of two types
        fused_adam.adam_sig_update(f, b, f, f, f, 1e-3, 1, 0.5)
    with pytest.raises(TypeError):
        fused_adam.adam_sig_update(f, f, f, f, f.half(), 1e-3, 1, 0.5)
    with pytest.raises(TypeError):
        fused_adam.adam_update(f, f, f.double(), f.double(), 1e-3, 1)
    with pytest.raises(ValueError):
        adam_isp_tree({"a": f}, optim.adam(1e-3, weight_decay=0.1).init(
            {"a": f}), {"a": f}, {"a": f},
            optim.adam(1e-3, weight_decay=0.1).hparams, 1, 0.5, 1.0)


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    """B1, B2, B3, B4, B5 bit-exact against their plain versions on a CUDA
    card; B2 also on bfloat16 leaves, B3 also with bfloat16 moments."""
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
        for tdt in (torch.float16, torch.bfloat16):  # B5 decode only
            assert _bits(wire_pack.wire_unpack(rp[0], rp[2][:k], n, tdt)
                         .cpu()) == _bits(ref.wire_unpack_ref(
                             rp[0], rp[2][:k], n, tdt).cpu())
        # fewer values than set bits: the gather clamps to the last value
        # (the values' memory goes on past the view, so a gather that is
        # not clamped reads the true values and differs)
        for short in (1, 3, k):
            cv = rp[2][:max(k - short, 0)]
            assert _bits(wire_pack.wire_unpack_add(t, rp[0], cv).cpu()) \
                == _bits(ref.wire_unpack_add_ref(t, rp[0], cv).cpu())
            assert _bits(wire_pack.wire_unpack(rp[0], cv, n, torch.float16)
                         .cpu()) == _bits(ref.wire_unpack_ref(
                             rp[0], cv, n, torch.float16).cpu())
        ins = [torch.from_numpy(a).to(dev) for a in _adam_inputs((n,), n)]
        for step, v_t, scale in ((1, 0.0, 1.0), (100, 0.7, 1.0 / 3.0)):
            got = fused_adam.adam_sig_update(*ins, 1e-3, step, v_t,
                                             scale=scale)
            s = ref.adam_scalars(1e-3, 0.9, 0.999, 1e-8, step, v_t, scale)
            for g, w in zip(got, ref.adam_sig_ref(*ins, s)):
                assert _bits(g.cpu()) == _bits(w.cpu())
            bf = [t.bfloat16() for t in ins]  # B2 on bfloat16 leaves
            got = fused_adam.adam_sig_update(*bf, 1e-3, step, v_t)
            s = ref.adam_scalars(1e-3, 0.9, 0.999, 1e-8, step, v_t)
            for g, w in zip(got, ref.adam_sig_ref(*bf, s)):
                assert g.dtype == torch.bfloat16
                assert _bits(g.cpu()) == _bits(w.cpu())
        for dt in (torch.float32, torch.bfloat16):
            for mdt in (torch.float32, torch.bfloat16):
                for wd in (0.0, 0.1):
                    bi = [ins[0].to(dt), ins[1].to(dt), ins[2].to(mdt),
                          ins[3].to(mdt)]
                    got = fused_adam.adam_update(*bi, 1e-3, 100,
                                                 weight_decay=wd)
                    s = ref.adam_scalars(1e-3, 0.9, 0.999, 1e-8, 100, wd)
                    for g, w in zip(got, ref.adam_ref(*bi, s)):
                        assert _bits(g.cpu()) == _bits(w.cpu())
    assert build.LAUNCHES["significance_filter"] == 4
    assert build.LAUNCHES["adam_sig_update"] == 16
    assert build.LAUNCHES["adam_update"] == 32
