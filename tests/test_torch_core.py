"""The port's tree keys, ISP filter, optimizers, PMF model, checkpoints and
state conversion, held to the JAX package on the same numpy inputs.

Tolerances: the ISP filter and tree keys are exact (pure elementwise
float32 math, identical naming); the PMF loss and gradients and five
optimizer steps are held to rtol=1e-5, atol=1e-6, because XLA and PyTorch
sum the minibatch and fuse the optimizer arithmetic in different orders.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import optim as joptim
from repro.checkpoint import store as jstore
from repro.core import isp as jisp
from repro.models import pmf as jpmf
from repro.wire import codec as jcodec

from repro_torch import convert, device as device_lib, optim
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import store
from repro_torch.core import isp
from repro_torch.models import pmf

RTOL, ATOL = 1e-5, 1e-6


class Pair(NamedTuple):
    first: object
    second: object


def _t(a):
    return torch.from_numpy(np.array(a))


def _nested(rng):
    return {
        "z": rng.standard_normal((3, 2)).astype(np.float32),
        "a": Pair(rng.standard_normal(4).astype(np.float32),
                  [rng.standard_normal(2).astype(np.float32), None,
                   (rng.standard_normal(1).astype(np.float32),)]),
        "m": {"y": np.float32(1.0), "b": rng.standard_normal(5)},
    }


def test_tree_keys_and_leaf_order_match_jax():
    tree = _nested(np.random.default_rng(0))
    jkeys = jcodec.tree_keys(tree)
    assert tree_lib.tree_keys(tree) == jkeys
    jleaves = jax.tree_util.tree_leaves(tree)
    leaves = tree_lib.leaves(tree)
    assert len(leaves) == len(jleaves)
    for a, b in zip(leaves, jleaves):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    back = tree_lib.unflatten(tree, [np.asarray(x) * 2 for x in leaves])
    assert tree_lib.tree_keys(back) == jkeys
    assert list(back) == list(tree)  # the caller's dict order survives


def test_path_keys_of_the_checkpoint_tree_match_jax():
    P = jpmf.PMFParams(U=np.zeros((3, 2), np.float32),
                       M=np.zeros((2, 4), np.float32))
    jtree = {"params": P, "opt": joptim.OptState(np.int32(1), P, P),
             "residual": P}
    tp = pmf.PMFParams(torch.zeros(3, 2), torch.zeros(2, 4))
    ttree = {"params": tp, "opt": optim.OptState(torch.tensor(1), tp, tp),
             "residual": tp}
    assert tree_lib.tree_keys(ttree) == jcodec.tree_keys(jtree)
    assert tree_lib.tree_keys(ttree)[:3] == ["opt/step", "opt/mu/U",
                                             "opt/mu/M"]


@settings(max_examples=30, deadline=None)
@given(
    n=st.integers(1, 400),
    v=st.sampled_from((0.0, 0.1, 0.7, 2.0)),
    step=st.integers(1, 50),
    decay=st.booleans(),
    seed=st.integers(0, 2**16),
)
def test_filter_update_bit_exact(n, v, step, decay, seed):
    rng = np.random.default_rng(seed)
    u, x, r = (rng.standard_normal(n).astype(np.float32) * s
               for s in (0.1, 1.0, 0.1))
    x[::9] = 0.0
    u[::4] = -0.0
    jcfg = jisp.ISPConfig(v=v, decay=decay)
    cfg = isp.ISPConfig(v=v, decay=decay)
    assert np.float32(cfg.threshold(step)) == np.asarray(
        jcfg.threshold(step))
    jsig, jstate, jmask = jisp.filter_update(
        jcfg, jisp.ISPState(residual={"w": jnp.asarray(r)},
                            step=jnp.asarray(step, jnp.int32)),
        {"w": jnp.asarray(u)}, {"w": jnp.asarray(x)})
    sig, state, mask = isp.filter_update(
        cfg, isp.ISPState({"w": _t(r)}, step), {"w": _t(u)}, {"w": _t(x)})
    assert sig["w"].numpy().tobytes() == np.asarray(jsig["w"]).tobytes()
    assert state.residual["w"].numpy().tobytes() == np.asarray(
        jstate.residual["w"]).tobytes()
    assert np.array_equal(mask["w"].numpy(), np.asarray(jmask["w"]))
    assert state.step == step + 1
    # mask == (sig != 0): the fraction is the same from either tree
    assert isp.communicated_fraction(mask) == isp.communicated_fraction(sig)
    assert isp.communicated_fraction(mask) == float(
        jisp.communicated_fraction(jmask))


@pytest.mark.parametrize("floor", (1e-8, 1e-3))
def test_significance_split_bit_exact(floor):
    rng = np.random.default_rng(1)
    acc = rng.standard_normal(257).astype(np.float32) * 1e-3
    x = rng.standard_normal(257).astype(np.float32)
    x[::3] = 0.0
    js, jr, jm = jisp.significance_split(jnp.asarray(acc), jnp.asarray(x),
                                         jnp.float32(0.25), floor)
    s, r, m = isp.significance_split(_t(acc), _t(x), 0.25, floor)
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    assert r.numpy().tobytes() == np.asarray(jr).tobytes()
    assert np.array_equal(m.numpy(), np.asarray(jm))


def test_flush_returns_residual_and_clears():
    st_ = isp.ISPState({"w": torch.ones(3)}, 4)
    out, cleared = isp.flush(st_)
    assert torch.equal(out["w"], torch.ones(3))
    assert torch.count_nonzero(cleared.residual["w"]) == 0
    assert cleared.step == 4


def _pmf_inputs(seed=0, n_users=30, n_movies=40, rank=5, batch=64):
    rng = np.random.default_rng(seed)
    U = (rng.standard_normal((n_users, rank)) / np.sqrt(rank)).astype(
        np.float32)
    M = (rng.standard_normal((rank, n_movies)) / np.sqrt(rank)).astype(
        np.float32)
    user = rng.integers(0, n_users, batch).astype(np.int32)
    movie = rng.integers(0, n_movies, batch).astype(np.int32)
    rating = rng.uniform(0.5, 5.0, batch).astype(np.float32)
    return U, M, user, movie, rating


def _pmf_both(U, M, user, movie, rating):
    jcfg = jpmf.PMFConfig(n_users=U.shape[0], n_movies=M.shape[1],
                          rank=U.shape[1])
    cfg = pmf.PMFConfig(n_users=U.shape[0], n_movies=M.shape[1],
                        rank=U.shape[1])
    jb = jpmf.RatingsBatch(jnp.asarray(user), jnp.asarray(movie),
                           jnp.asarray(rating))
    tb = pmf.RatingsBatch(_t(user).long(), _t(movie).long(), _t(rating))
    return jcfg, cfg, jb, tb


@pytest.mark.parametrize("seed", range(3))
def test_pmf_loss_and_grads_match_value_and_grad(seed):
    U, M, user, movie, rating = _pmf_inputs(seed)
    jcfg, cfg, jb, tb = _pmf_both(U, M, user, movie, rating)
    jloss, jg = jpmf.grad_fn(jcfg, jpmf.PMFParams(jnp.asarray(U),
                                                  jnp.asarray(M)), jb)
    loss, g = pmf.grad_fn(cfg, pmf.PMFParams(_t(U), _t(M)), tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(g.U.numpy(), np.asarray(jg.U), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(g.M.numpy(), np.asarray(jg.M), rtol=RTOL,
                               atol=ATOL)
    # untouched rows and columns stay exactly zero, as in the reference
    assert np.array_equal(g.U.numpy() == 0, np.asarray(jg.U) == 0)
    np.testing.assert_allclose(
        float(pmf.rmse(pmf.PMFParams(_t(U), _t(M)), tb)),
        float(jpmf.rmse(jpmf.PMFParams(jnp.asarray(U), jnp.asarray(M)), jb)),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name,lr", (("nesterov", 0.08), ("adam", 1e-2),
                                     ("sgd", 0.1)))
def test_optimizers_match_over_five_steps(name, lr):
    U, M, user, movie, rating = _pmf_inputs(7)
    jcfg, cfg, jb, tb = _pmf_both(U, M, user, movie, rating)
    jopt, opt = joptim.make(name, lr), optim.make(name, lr)
    jp = jpmf.PMFParams(jnp.asarray(U), jnp.asarray(M))
    tp = pmf.PMFParams(_t(U), _t(M))
    js, ts = jopt.init(jp), opt.init(tp)
    for _ in range(5):
        _, jg = jpmf.grad_fn(jcfg, jp, jb)
        _, tg = pmf.grad_fn(cfg, tp, tb)
        ju, js = jopt.update(jg, js, jp)
        tu, ts = opt.update(tg, ts, tp)
        jp = joptim.apply_updates(jp, ju)
        tp = optim.apply_updates(tp, tu)
    for a, b in zip(tree_lib.leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)
    for a, b in zip(tree_lib.leaves(ts.mu), jax.tree_util.tree_leaves(js.mu)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)
    assert int(ts.step) == int(js.step) == 6


def _ckpt_trees():
    U, M, *_ = _pmf_inputs(2)
    jp = jpmf.PMFParams(jnp.asarray(U), jnp.asarray(M))
    jopt = joptim.make("nesterov", 0.1)
    js = jopt.init(jp)
    js = joptim.OptState(js.step + 3, jax.tree.map(lambda x: x + 0.5, js.mu),
                         js.nu)
    jtree = {"params": jp, "opt": js,
             "residual": jax.tree.map(lambda x: x * 1e-3, jp)}
    ttree = convert.from_leaves(
        {"params": pmf.PMFParams(torch.zeros(U.shape), torch.zeros(M.shape)),
         "opt": optim.make("nesterov", 0.1).init(
             pmf.PMFParams(torch.zeros(U.shape), torch.zeros(M.shape))),
         "residual": pmf.PMFParams(torch.zeros(U.shape),
                                   torch.zeros(M.shape))},
        [np.asarray(x) for x in jax.tree_util.tree_leaves(jtree)])
    return jtree, ttree


def test_convert_carries_params_opt_state_and_residual():
    jtree, ttree = _ckpt_trees()
    assert int(ttree["opt"].step) == 4
    assert ttree["opt"].step.dtype == torch.int32
    for a, b in zip(convert.to_leaves(ttree),
                    jax.tree_util.tree_leaves(jtree)):
        assert a.dtype == np.asarray(b).dtype
        assert a.tobytes() == np.asarray(b).tobytes()


@pytest.mark.parametrize("writer", ("jax", "torch"))
def test_checkpoints_cross_restore(tmp_path, writer):
    jtree, ttree = _ckpt_trees()
    d = str(tmp_path / "ck")
    if writer == "jax":
        jstore.save(d, 5, jtree, extra={"who": "jax"})
    else:
        store.save(d, 5, ttree, extra={"who": "torch"})
    got_t = store.restore(d, 5, ttree)
    got_j = jstore.restore(d, 5, jtree)
    for a, b, c in zip(tree_lib.leaves(got_t),
                       jax.tree_util.tree_leaves(got_j),
                       jax.tree_util.tree_leaves(jtree)):
        assert convert.to_leaves([a])[0].tobytes() == np.asarray(b).tobytes()
        assert np.asarray(b).tobytes() == np.asarray(c).tobytes()
    step, latest = store.restore_latest_valid(d, ttree)
    assert step == 5 and jstore.manifest_extra(d, 5)["who"] == writer


def test_device_rule_raises_without_cuda_and_never_falls_back():
    assert device_lib.resolve("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            device_lib.resolve()
        with pytest.raises(RuntimeError):
            device_lib.resolve("cuda")
