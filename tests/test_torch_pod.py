"""The port's pod exchange held to the JAX package on the CPU.

B6 (``wire_nnz``) and B1 on float16 / bfloat16 run their plain versions
here and are compared bit for bit with the Pallas kernels in interpret
mode. ``dist.compression.isp_compressed_step`` is compared with the JAX
function leaf for leaf and bit for bit: against ``fused=True,
interpret=True`` (what the card computes) and against the default
``fused=False``. ``dist.elastic`` transitions, Adam / SGD / Nesterov on
bfloat16 leaves and ``clip_by_global_norm`` likewise. Every input is made
with numpy from a seed and handed to both packages.
"""

from __future__ import annotations

import argparse
import dataclasses

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro import optim as joptim
from repro.dist import compression as jcomp
from repro.dist import elastic as jelastic
from repro.kernels import significance as jsig
from repro.kernels import wire_pack as jwp
from repro.launch import train as jtrain

from repro_torch import convert, optim
from repro_torch.core.isp import ISPConfig
from repro_torch.dist import compression, elastic
from repro_torch.kernels import build, significance, wire_pack
from repro_torch.launch import train
from repro_torch.wire.codec import to_numpy, to_tensor

BF16 = np.dtype(ml_dtypes.bfloat16)
NP_DTYPES = {"float32": np.dtype(np.float32), "float16": np.dtype(np.float16),
             "bfloat16": BF16, "int32": np.dtype(np.int32)}
TILE = jwp.DEFAULT_BLOCK_ROWS * jwp.LANES  # the Pallas kernels' tile


def _same(t: torch.Tensor, a) -> bool:
    """Bit-identical: same dtype, shape and bytes."""
    a = np.asarray(a)
    got = to_numpy(t)
    return (got.dtype == a.dtype and got.shape == a.shape
            and got.tobytes() == a.tobytes())


def _array(n: int, dtype: str, seed: int, density: float = 0.4) -> np.ndarray:
    """Values with -0.0, a leading all-zero Pallas tile when n allows one,
    and (floats) a NaN."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(n) * 3
    a[rng.random(n) >= density] = 0.0
    if dtype == "int32":
        return (a * 100).astype(np.int32)
    a = a.astype(np.float32)
    a[1::11] = np.where(a[1::11] == 0, -0.0, a[1::11])
    if n > 2 * TILE:
        a[:TILE] = 0.0
        a[TILE + 5] = np.nan
    return a.astype(NP_DTYPES[dtype])


# -- B6: wire_nnz ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", ("float32", "float16", "bfloat16", "int32"))
@pytest.mark.parametrize("n", (1, 129, 4096, 2 * TILE + 77))
def test_wire_nnz_plain_matches_pallas_interpret(n, dtype):
    flat = _array(n, dtype, seed=n)
    got = wire_pack.wire_nnz(to_tensor(flat))
    want = jwp.wire_nnz(jnp.asarray(flat), interpret=True)
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == int(want)


def test_wire_nnz_edges():
    z = torch.tensor([0.0, -0.0, 0.0])
    assert int(wire_pack.wire_nnz(z)) == 0
    assert int(wire_pack.wire_nnz(torch.tensor([float("nan"), -0.0]))) == 1
    assert int(wire_pack.wire_nnz(torch.zeros(0))) == 0
    with pytest.raises(ValueError):
        wire_pack.wire_nnz(torch.zeros(2, 2))
    with pytest.raises(TypeError):
        wire_pack.wire_nnz(torch.zeros(3, dtype=torch.float64))
    build.reset_launches()
    wire_pack.wire_nnz(torch.ones(5))
    assert sum(build.LAUNCHES.values()) == 0  # the plain version launches nothing


# -- B1 on float16 / bfloat16 -------------------------------------------------------


def _sig_inputs(shape, x_shape, dtype: str, seed: int):
    rng = np.random.default_rng(seed)
    u = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    x = rng.standard_normal(x_shape).astype(np.float32)
    r = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    u.reshape(-1)[::5] = -0.0
    x.reshape(-1)[::7] = 0.0
    r.reshape(-1)[:64] = -0.0
    dt = NP_DTYPES[dtype]
    return u.astype(dt), x.astype(dt), r.astype(dt)


@pytest.mark.parametrize("dtype", ("bfloat16", "float16"))
@pytest.mark.parametrize("n", (1, 7, 1025, 4097))
@pytest.mark.parametrize("v_t", (0.0, 0.7))
def test_significance_half_plain_matches_pallas_interpret(n, dtype, v_t):
    u, x, r = _sig_inputs((n,), (n,), dtype, seed=n)
    vt32 = float(np.float32(v_t))
    sig, res = significance.significance_filter(
        to_tensor(u), to_tensor(x), to_tensor(r), vt32)
    jsig_, jres = jsig.significance_filter(
        jnp.asarray(u), jnp.asarray(x), jnp.asarray(r),
        jnp.asarray(vt32, jnp.float32), interpret=True)
    assert _same(sig, jsig_) and _same(res, jres)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16", "float16"))
@pytest.mark.parametrize("fused", (True, False))
def test_split_significant_broadcasts_x_over_pods(dtype, fused):
    u, x, r = _sig_inputs((3, 5, 77), (5, 77), dtype, seed=3)
    for v in (0.0, 0.4):
        got = compression.split_significant(
            to_tensor(u), to_tensor(x), to_tensor(r), v, fused=fused)
        want = jcomp.split_significant(
            jnp.asarray(u), jnp.asarray(x), jnp.asarray(r), jnp.float32(v),
            fused=fused, interpret=True)
        assert _same(got[0], want[0]) and _same(got[1], want[1])


def test_significance_wrapper_refusals():
    f = torch.zeros(2, 8)
    with pytest.raises(TypeError):
        significance.significance_filter(f, f[0].half(), f, 0.5)
    with pytest.raises(ValueError):
        significance.significance_filter(f, torch.zeros(4), f, 0.5)


# -- isp_compressed_step --------------------------------------------------------

SHAPES = {"a": (5, 33), "b": (130,), "c": (7, 3, 4)}


def _exchange_inputs(pods: int, dtype: str, seed: int):
    rng = np.random.default_rng(seed)
    dt = NP_DTYPES[dtype]
    x = {k: rng.standard_normal(s).astype(np.float32).astype(dt)
         for k, s in SHAPES.items()}
    u = {k: (rng.standard_normal((pods,) + s) * 0.3).astype(np.float32)
         .astype(dt) for k, s in SHAPES.items()}
    r = {k: (rng.standard_normal((pods,) + s) * 0.05).astype(np.float32)
         .astype(dt) for k, s in SHAPES.items()}
    for k in SHAPES:
        x[k].reshape(-1)[::9] = 0.0
        u[k].reshape(-1)[::13] = -0.0
    return u, x, r


def _to_port(tree):
    return {k: to_tensor(v) for k, v in tree.items()}


def _to_jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("pods", (1, 2, 3))
@pytest.mark.parametrize("scheme", ("dense", "topk", "bitmap"))
@pytest.mark.parametrize("fused", (True, False))
def test_isp_compressed_step_matches_jax(scheme, pods, dtype, fused):
    """Combined, residuals, sent_fraction and wire_bytes all equal. fused
    =True is the card's exchange (B1 split, B6 count); fused=False the
    JAX default, here in the leaf's dtype on the CPU."""
    u, x, r = _exchange_inputs(pods, dtype, seed=pods)
    kw = dict(scheme=scheme, budget=0.05, block=16)
    v_t = float(np.float32(0.7) / np.sqrt(np.float32(3.0)))
    c, res, stats = compression.isp_compressed_step(
        compression.CompressionConfig(fused=fused, **kw), _to_port(u),
        _to_port(x), _to_port(r), v_t)
    jc, jres, jstats = jcomp.isp_compressed_step(
        jcomp.CompressionConfig(fused=fused, interpret=True, **kw),
        _to_jax(u), _to_jax(x), _to_jax(r), jnp.float32(v_t))
    for k in SHAPES:
        assert _same(c[k], jc[k]), k
        assert _same(res[k], jres[k]), k
    for key in ("sent_fraction", "wire_bytes"):
        assert _same(stats[key], jstats[key]), key


@pytest.mark.parametrize("pods", (1, 2, 3, 4))
def test_pod_sum_is_bit_exact(pods):
    """The pod sum in float32, in pod order, as XLA reduces the pod axis."""
    rng = np.random.default_rng(pods)
    sent = (rng.standard_normal((pods, 4099)) * np.float32(10.0) **
            rng.integers(-6, 6, (pods, 4099))).astype(np.float32)
    sent[:, ::17] = -0.0
    got = compression.pod_sum(torch.from_numpy(sent))
    want = jnp.sum(jnp.asarray(sent), axis=0)
    assert _same(got, want)


@pytest.mark.parametrize("budget,block", ((0.01, 128), (0.1, 16), (0.3, 7),
                                          (1.0, 8)))
def test_topk_mask_breaks_ties_as_lax_top_k(budget, block):
    """bf16 drawn from a few values, so most blocks hold ties: the kept
    entries are the lower-index ones, as jax.lax.top_k keeps them."""
    rng = np.random.default_rng(int(block))
    vals = np.array([0.0, -0.0, 0.5, -0.5, 1.0, -1.0, 2.0], np.float32)
    sig = vals[rng.integers(0, vals.size, (3, 1000))].astype(BF16)
    cfg = compression.CompressionConfig(scheme="topk", budget=budget,
                                        block=block)
    jcfg = jcomp.CompressionConfig(scheme="topk", budget=budget, block=block)
    got = compression._pod_topk_mask(to_tensor(sig), cfg)
    want = jax.vmap(lambda s: jcomp._block_topk_mask(s, jcfg))(
        jnp.asarray(sig))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_compression_config_matches_jax():
    for kw in (dict(), dict(scheme="topk", budget=0.001),
               dict(scheme="bitmap", wire="sparse"), dict(scheme="topk",
                                                          budget=1.0)):
        cfg, jcfg = compression.CompressionConfig(**kw), \
            jcomp.CompressionConfig(**kw)
        assert cfg.wire_scheme == jcfg.wire_scheme
        assert cfg.k_per_block() == jcfg.k_per_block()
    for bad in (dict(scheme="gzip"), dict(budget=0.0), dict(block=0),
                dict(wire="zip")):
        with pytest.raises(ValueError):
            compression.CompressionConfig(**bad)


def test_apply_combined_matches_jax():
    _, x, r = _exchange_inputs(2, "bfloat16", seed=5)
    c = {k: v[0] for k, v in r.items()}
    got = compression.apply_combined(_to_port(x), _to_port(c))
    want = jcomp.apply_combined(_to_jax(x), _to_jax(c))
    for k in SHAPES:
        assert _same(got[k], want[k])


# -- dist.elastic -----------------------------------------------------------------


def test_plans_and_meshes_match_jax():
    plan = elastic.ElasticPlan(initial_pods=5, per_pod_batch=3, min_pods=2)
    jplan = jelastic.ElasticPlan(initial_pods=5, per_pod_batch=3, min_pods=2)
    got = elastic.transition_schedule(plan, [5, 4, 2])
    want = jelastic.transition_schedule(jplan, [5, 4, 2])
    assert [dataclasses.asdict(t) for t in got] == [
        dataclasses.asdict(t) for t in want]
    for pods in (1, 2, 7):
        assert elastic.mesh_shape_for(pods) == jelastic.mesh_shape_for(pods)
        assert elastic.mesh_axes_for(pods) == jelastic.mesh_axes_for(pods)
    for bad in ((5, 5), (4, 5), (5, 1)):
        with pytest.raises(ValueError):
            elastic.plan_transition(plan, *bad)
    with pytest.raises(ValueError):
        elastic.transition_schedule(plan, [4, 3])


def _pod_state(pods: int, dtype: str, seed: int):
    u, x, r = _exchange_inputs(pods, dtype, seed)
    opt = joptim.OptState(np.full((pods,), 7, np.int32), u, r)
    return x, opt, r


def _port_opt(opt):
    return optim.OptState(torch.from_numpy(opt.step), _to_port(opt.mu),
                          _to_port(opt.nu))


def _jax_opt(opt):
    return joptim.OptState(jnp.asarray(opt.step), _to_jax(opt.mu),
                           _to_jax(opt.nu))


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("old,new", ((4, 3), (3, 1), (5, 2)))
def test_apply_transition_matches_jax(old, new, dtype):
    x, opt, r = _pod_state(old, dtype, seed=old)
    tr = elastic.plan_transition(elastic.ElasticPlan(old, 2), old, new)
    jtr = jelastic.plan_transition(jelastic.ElasticPlan(old, 2), old, new)
    got = elastic.apply_transition(tr, _to_port(x), _port_opt(opt),
                                   _to_port(r))
    want = jelastic.apply_transition(jtr, _to_jax(x), _jax_opt(opt),
                                     _to_jax(r))
    _same_leaves(got, want)


def _same_leaves(tree, jtree) -> None:
    leaves = convert.to_leaves(tree)
    jleaves = jax.tree_util.tree_leaves(jtree)
    assert len(leaves) == len(jleaves)
    for g, w in zip(leaves, jleaves):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("ckpt", (False, True))
@pytest.mark.parametrize("old", (4, 2))
def test_scale_in_pod_matches_jax(tmp_path, old, ckpt):
    """One scale-in of the pod path (flush, shrink, checkpoint and, at one
    pod, the restore) gives JAX's state."""
    x, opt, r = _pod_state(old, "bfloat16", seed=11)
    d = str(tmp_path / "port") if ckpt else None
    jd = str(tmp_path / "jax") if ckpt else None
    st = train.TrainState(_to_port(x), _port_opt(opt), _to_port(r), 6, old)
    jst = jtrain.TrainState(_to_jax(x), _jax_opt(opt), _to_jax(r), 6, old)
    st = train._scale_in_pod(argparse.Namespace(checkpoint_dir=d), st,
                             elastic.ElasticPlan(old, 2), None)
    jst = jtrain._scale_in_pod(argparse.Namespace(checkpoint_dir=jd), jst,
                               jelastic.ElasticPlan(old, 2), None)
    assert st.pool == jst.pool == old - 1 and st.step == jst.step
    _same_leaves({"p": st.params, "o": st.opt_state, "r": st.residual},
                 {"p": jst.params, "o": jst.opt_state, "r": jst.residual})


def test_reintegration_matches_jax():
    rng = np.random.default_rng(0)
    reps = rng.standard_normal((5, 33)).astype(np.float32)
    mask = np.array([True, True, False, True, True])
    got = elastic.reintegrate_replicas(torch.from_numpy(reps), 2,
                                       torch.from_numpy(mask))
    want = jelastic.reintegrate_replicas(jnp.asarray(reps), 2,
                                         jnp.asarray(mask))
    assert _same(got, want)
    own, leaving = reps[0], reps[1]
    for p_old in (3, np.float32(3.0)):
        got = elastic.reintegrate_into(torch.from_numpy(own),
                                       torch.from_numpy(leaving), p_old)
        want = jelastic.reintegrate_into(jnp.asarray(own),
                                         jnp.asarray(leaving), p_old)
        assert _same(got, want)
    got = elastic.reintegrate_into(
        torch.from_numpy(own), torch.from_numpy(leaving),
        torch.tensor(3.0, dtype=torch.float32))
    assert _same(got, own + (leaving - own) / np.float32(3.0))


def test_resharded_restore_onto_the_state_device(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": torch.ones(3, dtype=torch.bfloat16)}
    from repro_torch.checkpoint import store

    store.save(str(tmp_path), 3, tree)
    like = {k: torch.zeros_like(v) for k, v in tree.items()}
    out = elastic.resharded_restore(str(tmp_path), 3, like, pods=2)
    for k in tree:
        assert out[k].dtype == tree[k].dtype and torch.equal(out[k], tree[k])
    with pytest.raises(ValueError):
        elastic.resharded_restore(str(tmp_path), 3, like, pods=0)


@pytest.mark.cuda
@pytest.mark.parametrize("p_old", (3, 5, 7))
def test_reintegrate_into_divides_exactly_on_the_card(p_old):
    """On the card the divisor is a 0-d float32 device tensor: float32
    division as numpy computes it, where a Python float divides through
    its reciprocal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs this check)")
    rng = np.random.default_rng(p_old)
    own = rng.standard_normal(1 << 20).astype(np.float32)
    leaving = rng.standard_normal(1 << 20).astype(np.float32)
    want = own + (leaving - own) / np.float32(p_old)
    dev = torch.device("cuda")
    pool = torch.full((), float(p_old), dtype=torch.float32, device=dev)
    for divisor in (pool, p_old):
        got = elastic.reintegrate_into(torch.from_numpy(own).to(dev),
                                       torch.from_numpy(leaving).to(dev),
                                       divisor)
        assert got.cpu().numpy().tobytes() == want.tobytes()


# -- optimizers on bfloat16 leaves -----------------------------------------------


def _bf16_problem(seed: int, n: int = 100_000):
    rng = np.random.default_rng(seed)
    p = (rng.standard_normal(n) * 0.05).astype(BF16)
    grads = [(rng.standard_normal(n) * 10.0 ** rng.uniform(-4, 0, n))
             .astype(BF16) for _ in range(3)]
    return p, grads


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in bf16 places between two bf16 arrays."""
    def ordered(x):
        i = x.view(np.int16).astype(np.int32)
        return np.where(i < 0, -32768 - i, i)
    return np.abs(ordered(a) - ordered(b))


def _eager_model(name: str, kw: dict, p: np.ndarray, grads: list):
    """The eager JAX optimizers' arithmetic in numpy, op by op: a bf16
    operation rounds its float32 result to bf16 (a Python constant takes
    the leaf's dtype), a float32 0-d array (eta, the bias corrections)
    promotes to float32. Yields ``(update, mu, nu)`` per step."""
    f32 = np.float32
    bf = lambda a: np.asarray(a, np.float32).astype(BF16)  # noqa: E731
    up = lambda a: a.astype(np.float32)  # noqa: E731
    eta = f32(3e-4)
    m = np.zeros(p.shape, BF16)
    v = np.zeros(p.shape, BF16)
    for t, g in enumerate(grads, 1):
        if name == "sgd":
            yield bf(-eta * up(g)), m, v
        elif name == "nesterov":
            m = bf(up(bf(up(bf(0.9)) * up(m))) + up(g))
            yield bf(-eta * up(bf(up(g) + up(bf(up(bf(0.9)) * up(m)))))), m, v
        else:
            m = bf(up(bf(up(bf(0.9)) * up(m)))
                   + up(bf(up(bf(1 - 0.9)) * up(g))))
            v = bf(up(bf(up(bf(0.999)) * up(v)))
                   + up(bf(up(bf(1 - 0.999)) * up(bf(up(g) * up(g))))))
            bc1 = f32(1) - f32(0.9) ** f32(t)
            bc2 = f32(1) - f32(0.999) ** f32(t)
            u = -eta * (up(m) / bc1) / (np.sqrt(up(v) / bc2) + f32(1e-8))
            if kw.get("weight_decay"):
                u = u - eta * f32(kw["weight_decay"]) * up(p)
            yield bf(u), m, v


def _diff(got, want) -> str:
    """Where two arrays differ bit for bit: the count and the first few
    places."""
    got, want = np.asarray(got), np.asarray(want)
    bits = np.int16 if got.itemsize == 2 else np.int32
    at = np.flatnonzero(got.view(bits) != want.view(bits))
    return (f"{at.size} of {got.size} differ; first at {at[:5].tolist()}: "
            f"{got[at[:5]].tolist()} against {want[at[:5]].tolist()}; "
            f"torch threads {torch.get_num_threads()}")


@pytest.mark.parametrize("name,kw", (("adam", {}), ("adam",
                                                   {"weight_decay": 0.1}),
                                     ("sgd", {}), ("nesterov", {})))
def test_optimizers_match_jax_eager_on_bf16_leaves(name, kw):
    """Three steps on 100,000 bf16 leaves: updates and moments bit for bit
    against the JAX optimizer run op by op, and each of the two against a
    numpy model of the eager arithmetic (so a failure names the side that
    moved)."""
    p, grads = _bf16_problem(seed=len(name))
    opt, jopt = optim.make(name, 3e-4, **kw), joptim.make(name, 3e-4, **kw)
    params, jparams = {"w": to_tensor(p)}, {"w": jnp.asarray(p)}
    state, jstate = opt.init(params), jopt.init(jparams)
    model = _eager_model(name, kw, p, grads)
    for g in grads:
        u, state = opt.update({"w": to_tensor(g)}, state, params)
        ju, jstate = jopt.update({"w": jnp.asarray(g)}, jstate, jparams)
        mu, mmu, mnu = next(model)
        for got, jgot, want in ((u["w"], ju["w"], mu),
                                (state.mu["w"], jstate.mu["w"], mmu),
                                (state.nu["w"], jstate.nu["w"], mnu)):
            assert _same(jgot, want), "JAX: " + _diff(jgot, want)
            assert _same(got, want), "port: " + _diff(to_numpy(got), want)
            assert _same(got, jgot)
        assert int(state.step) == int(jstate.step)


@pytest.mark.parametrize("name,kw", (("adam", {}), ("adam",
                                                   {"weight_decay": 0.1}),
                                     ("sgd", {}), ("nesterov", {})))
def test_optimizers_match_jax_eager_on_float32_leaves(name, kw):
    """Three steps on 100,000 float32 leaves, updates and moments bit for
    bit against the JAX optimizer run op by op. Adam's square root must be
    correctly rounded, as XLA's is: PyTorch's float32 sqrt on the CPU is
    one place off for about 0.6% of its inputs, and the update showed it
    in about 590 elements a step."""
    rng = np.random.default_rng(len(name))
    p = (rng.standard_normal(100_000) * 0.05).astype(np.float32)
    opt, jopt = optim.make(name, 3e-4, **kw), joptim.make(name, 3e-4, **kw)
    params, jparams = {"w": to_tensor(p)}, {"w": jnp.asarray(p)}
    state, jstate = opt.init(params), jopt.init(jparams)
    for _ in range(3):
        g = (rng.standard_normal(p.size) * 10.0 ** rng.uniform(-4, 0, p.size)
             ).astype(np.float32)
        u, state = opt.update({"w": to_tensor(g)}, state, params)
        ju, jstate = jopt.update({"w": jnp.asarray(g)}, jstate, jparams)
        for got, want in ((u["w"], ju["w"]), (state.mu["w"], jstate.mu["w"]),
                          (state.nu["w"], jstate.nu["w"])):
            assert _same(got, want), _diff(to_numpy(got), want)


def test_adam_matches_jitted_jax_on_bf16_leaves():
    """Against ``jax.jit(update)``, as the JAX trainer runs it: the moments
    bit for bit; the update within two bf16 places, at most 0.1% of them
    two apart. XLA computes the update from the float32 moments before
    they are rounded to bf16 (its excess precision): a numpy model of that
    matches the jitted update bit for bit, while the port follows the
    eager update exactly (the test above)."""
    p, grads = _bf16_problem(seed=9)
    opt, jopt = optim.adam(3e-4), joptim.adam(3e-4)
    params, jparams = {"w": to_tensor(p)}, {"w": jnp.asarray(p)}
    state, jstate = opt.init(params), jopt.init(jparams)
    update = jax.jit(jopt.update)
    m = v = np.zeros(p.shape, np.float32)
    w = {c: np.float32(BF16.type(c)) for c in (0.9, 1 - 0.9, 0.999,
                                                1 - 0.999)}
    for t, g in enumerate(grads, 1):
        u, state = opt.update({"w": to_tensor(g)}, state, params)
        ju, jstate = update({"w": jnp.asarray(g)}, jstate, jparams)
        assert _same(state.mu["w"], jstate.mu["w"])
        assert _same(state.nu["w"], jstate.nu["w"])
        d = _ulps(to_numpy(u["w"]), np.asarray(ju["w"]))
        assert d.max() <= 2 and np.mean(d == 2) <= 1e-3
        # XLA's excess precision: the moments' last sums stay float32
        gf = g.astype(np.float32)
        bf = lambda a: a.astype(BF16).astype(np.float32)  # noqa: E731
        mf = bf(w[0.9] * m) + bf(w[1 - 0.9] * gf)
        vf = bf(w[0.999] * v) + bf(w[1 - 0.999] * bf(gf * gf))
        bc1 = np.float32(1) - np.float32(0.9) ** np.float32(t)
        bc2 = np.float32(1) - np.float32(0.999) ** np.float32(t)
        ux = -np.float32(3e-4) * (mf / bc1) / (np.sqrt(vf / bc2)
                                               + np.float32(1e-8))
        assert ux.astype(BF16).tobytes() == np.asarray(ju["w"]).tobytes()
        m = to_numpy(state.mu["w"]).astype(np.float32)
        v = to_numpy(state.nu["w"]).astype(np.float32)


def test_clip_scale_is_a_tensor_division():
    """300 norms, each the correctly rounded sqrt of an exact sum of
    squares: the scale ``max_norm / norm`` and every scaled leaf bit for
    bit (a Python scalar divided by a tensor goes through a reciprocal and
    differs for about a quarter of them)."""
    rng = np.random.default_rng(5)
    for _ in range(300):
        tree = {"a": rng.integers(-64, 64, 5).astype(np.float32) / 8,
                "b": rng.integers(-64, 64, 3).astype(np.float32) / 8}
        got = optim.clip_by_global_norm(_to_port(tree), 0.7)
        want = joptim.clip_by_global_norm(_to_jax(tree), 0.7)
        for k in tree:
            assert _same(got[k], want[k])


def test_clip_by_global_norm_is_bit_exact():
    """float32 leaves whose squares and sums are exact in any order (so
    the norm is the correctly rounded sqrt in both), then random leaves
    at 1e-6."""
    rng = np.random.default_rng(4)
    exact = {"a": rng.integers(-64, 64, (40, 7)).astype(np.float32) / 8,
             "b": rng.integers(-64, 64, (13,)).astype(np.float32) / 8}
    noisy = {"a": rng.standard_normal((40, 7)).astype(np.float32),
             "b": rng.standard_normal(13).astype(np.float32)}
    for tree, tol in ((exact, 0.0), (noisy, 1e-6)):
        for max_norm in (0.7, 1.0, 1e6):
            got = optim.clip_by_global_norm(_to_port(tree), max_norm)
            want = joptim.clip_by_global_norm(_to_jax(tree), max_norm)
            norm = optim.global_norm(_to_port(tree))
            assert float(norm) == pytest.approx(
                float(joptim.global_norm(_to_jax(tree))), rel=tol or 1e-7)
            for k in tree:
                if tol == 0.0:
                    assert _same(got[k], want[k])
                else:
                    np.testing.assert_allclose(got[k].numpy(),
                                               np.asarray(want[k]), rtol=tol)
    bf = {"w": to_tensor(rng.standard_normal(50).astype(BF16))}
    got = optim.clip_by_global_norm(bf, 0.5)
    want = joptim.clip_by_global_norm({"w": jnp.asarray(to_numpy(bf["w"]))},
                                      0.5)
    assert got["w"].dtype == torch.bfloat16
    assert _ulps(to_numpy(got["w"]), np.asarray(want["w"])).max() <= 1


def test_isp_threshold_matches_jax():
    for step in (1, 2, 3, 17, 1000):
        assert np.float32(ISPConfig(v=0.7).threshold(step)) == np.asarray(
            jtrain.ISPConfig(v=0.7).threshold(step))
