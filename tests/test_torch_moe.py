"""The port's MoE feed-forward (``repro_torch.models.moe``) held to the JAX
package's (``repro.models.moe``) on the CPU.

Inputs are made from a seed with numpy; parameters are the JAX package's,
carried across as numpy leaves (``convert.from_leaves``). Tolerances:

* routing (expert ids, the kept and dropped assignments), ``capacity``,
  ``expert_split`` and the leaves across ``convert``: exact.
* ``out`` and ``aux`` in float32 within 1e-5 relative and absolute: the
  grouped products and the sum over a token's assignments run in other
  orders. In bfloat16 within 0.05, the LM tests' bf16 tolerance, after the
  expert choice is asserted equal.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.models import moe as jmoe
from repro.models import params as jpdefs
from repro.models.config import MoEConfig as JMoEConfig

from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.configs import get_smoke
from repro_torch.models import moe
from repro_torch.models import params as pdefs
from repro_torch.models.config import MoEConfig

TOL = {"float32": 1e-5, "bfloat16": 5e-2}
SMOKES = ("mixtral-8x22b", "phi3.5-moe-42b-a6.6b")  # split 4, split 4


def _cfgs(arch: str, dtype: str = "float32", **moe_kw):
    kw = dict(param_dtype=dtype, activation_dtype=dtype)
    jcfg, cfg = jget_smoke(arch), get_smoke(arch)
    if moe_kw:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                                 **moe_kw))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe_kw))
    return (dataclasses.replace(jcfg, **kw), dataclasses.replace(cfg, **kw))


def _params(jcfg, cfg, seed: int = 0):
    """JAX ``moe_defs`` materialised from a seed, and the port's copy."""
    jp = jpdefs.materialize(jmoe.moe_defs(jcfg), jax.random.PRNGKey(seed))
    p = convert.from_leaves(pdefs.empty(moe.moe_defs(cfg)),
                            [np.asarray(x) for x in
                             jax.tree_util.tree_leaves(jp)])
    return jp, p


def _x(shape, dtype: str, seed: int = 1, shift: float = 0.0) -> np.ndarray:
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return (x + shift).astype(np.float32)


def _both(jcfg, cfg, jp, p, x: np.ndarray, dtype: str):
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jout, jaux = jmoe.moe_apply(jcfg, jp, jx)
    out, aux = moe.moe_apply(cfg, p, tx)
    return (np.asarray(jout, np.float32), float(jaux),
            out.float().numpy(), float(aux), jx, tx)


def _jax_route(jcfg, jp, jx):
    """The JAX package's routing lines (``repro.models.moe.moe_apply``)
    with G = 1: expert ids and each assignment's capacity slot and keep."""
    n = jx.shape[0] * jx.shape[1]
    logits = jx.reshape(n, -1).astype(jnp.float32) @ jp["router"]
    _, ids = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), jcfg.moe.top_k)
    flat_e = ids.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, jcfg.moe.n_experts, dtype=jnp.int32)
    pos_in_e = jnp.cumsum(onehot, axis=0) - onehot
    slot = jnp.sum(pos_in_e * onehot, axis=-1)
    keep = slot < jmoe.capacity(n, jcfg)
    return np.asarray(ids), np.asarray(slot), np.asarray(keep)


def _port_route(cfg, p, tx):
    n = tx.shape[0] * tx.shape[1]
    _, _, ids = moe.route(cfg, p, tx.reshape(n, -1))
    slot = moe.slots(ids, cfg.moe.n_experts)
    return ids.numpy(), slot.numpy(), (slot < moe.capacity(n, cfg)).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", SMOKES)
def test_moe_apply_matches_jax(arch, dtype):
    jcfg, cfg = _cfgs(arch, dtype)
    assert moe.expert_split(cfg) == jmoe.expert_split(jcfg) == 4
    jp, p = _params(jcfg, cfg)
    jout, jaux, out, aux, jx, tx = _both(jcfg, cfg, jp, p,
                                         _x((2, 24, cfg.d_model), dtype),
                                         dtype)
    jids, _, _ = _jax_route(jcfg, jp, jx)
    ids, _, _ = _port_route(cfg, p, tx)
    np.testing.assert_array_equal(ids, jids)
    tol = TOL[dtype]
    np.testing.assert_allclose(out, jout, rtol=tol, atol=tol)
    assert aux == pytest.approx(jaux, rel=tol, abs=tol)
    assert np.isfinite(out).all() and out.shape == (2, 24, cfg.d_model)


@pytest.mark.parametrize("arch", SMOKES)
def test_overflow_drops_the_assignments_jax_drops(arch):
    """A router biased towards expert 0 sends every token there first:
    48 tokens against a capacity of 32 overflow it (and the expert most
    tokens take second), and the assignments that arrive last in
    token-major (token, k) order are dropped, as in the JAX package."""
    jcfg, cfg = _cfgs(arch)
    jp, p = _params(jcfg, cfg)
    router = np.asarray(jp["router"]).copy()
    router[:, 0] += 4.0  # x has a +1 shift: expert 0 wins every token
    jp = dict(jp, router=jnp.asarray(router))
    p = dict(p, router=torch.from_numpy(router))
    x = _x((2, 24, cfg.d_model), "float32", seed=3, shift=1.0)
    jout, jaux, out, aux, jx, tx = _both(jcfg, cfg, jp, p, x, "float32")
    jids, jslot, jkeep = _jax_route(jcfg, jp, jx)
    ids, slot, keep = _port_route(cfg, p, tx)
    assert moe.capacity(48, cfg) == jmoe.capacity(48, jcfg) == 32
    assert (jids[:, 0] == 0).all()
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(slot, jslot)
    np.testing.assert_array_equal(keep, jkeep)
    dropped = np.nonzero(~keep)[0]
    flat = ids.reshape(-1)
    assert (flat[dropped] == 0).sum() == 16  # tokens 32..47's first choice
    assert (slot[dropped] >= 32).all()
    counts = np.bincount(flat, minlength=cfg.moe.n_experts)
    assert len(dropped) == np.maximum(counts - 32, 0).sum()
    np.testing.assert_allclose(out, jout, rtol=TOL["float32"],
                               atol=TOL["float32"])
    assert aux == pytest.approx(jaux, rel=TOL["float32"])


@pytest.mark.parametrize("tie", ["all", "pair"])
def test_exact_ties_pick_the_lower_expert_index(tie):
    """Equal routing probabilities: ``jax.lax.top_k`` takes the lower
    index first, and so must the port (a zero router ties all experts;
    two equal router columns tie those two experts)."""
    jcfg, cfg = _cfgs("mixtral-8x22b")
    jp, p = _params(jcfg, cfg)
    router = np.asarray(jp["router"]).copy()
    if tie == "all":
        router[:] = 0.0
        want = [0, 1]
    else:
        router[:, 3] = router[:, 1] = np.abs(router).max() * 4
        want = [1, 3]
    jp = dict(jp, router=jnp.asarray(router))
    p = dict(p, router=torch.from_numpy(router))
    x = np.abs(_x((1, 16, cfg.d_model), "float32", seed=5))
    jout, jaux, out, aux, jx, tx = _both(jcfg, cfg, jp, p, x, "float32")
    jids, _, _ = _jax_route(jcfg, jp, jx)
    ids, _, _ = _port_route(cfg, p, tx)
    assert (jids == want).all() and (ids == want).all()
    vals, idx = moe.top_k(torch.tensor([[0.25, 0.5, 0.25, 0.5]]), 3)
    assert idx.tolist() == [[1, 3, 0]]
    np.testing.assert_allclose(out, jout, rtol=TOL["float32"],
                               atol=TOL["float32"])
    assert aux == pytest.approx(jaux, rel=TOL["float32"])


@pytest.mark.parametrize("factor", [1.0, 1.25, 2.0])
@pytest.mark.parametrize("n_experts,top_k", [(4, 1), (4, 2), (8, 2),
                                              (16, 2), (16, 4)])
def test_capacity_and_expert_split_match_jax(n_experts, top_k, factor):
    jcfg, cfg = _cfgs("phi3.5-moe-42b-a6.6b", n_experts=n_experts,
                      top_k=top_k, capacity_factor=factor)
    assert moe.expert_split(cfg) == jmoe.expert_split(jcfg)
    for n in (1, 7, 8, 48, 100, 1024, 2048 * 4, 5120 * 2):
        c = moe.capacity(n, cfg)
        assert c == jmoe.capacity(n, jcfg), n
        assert c >= 8 and c % 8 == 0


@pytest.mark.parametrize("n_experts", [1, 2, 4, 8, 16, 32, 64])
def test_expert_split_over_expert_counts(n_experts):
    jcfg, cfg = _cfgs("mixtral-8x22b", n_experts=n_experts)
    assert moe.EP_TARGET == jmoe.EP_TARGET
    split = moe.expert_split(cfg)
    assert split == jmoe.expert_split(jcfg)
    assert (n_experts * split) % moe.EP_TARGET == 0


@pytest.mark.parametrize("arch", SMOKES + ("mixtral-8x22b-full",))
def test_virtual_expert_leaves_cross_both_ways(arch):
    """The router and the (E*split, d, f/split) expert leaves cross from
    the JAX package to the port and back unchanged, by the same keys (the
    full mixtral's defs are compared, declarations only)."""
    if arch.endswith("-full"):
        from repro.configs import get_arch as jget_arch
        from repro_torch.configs import get_arch
        jcfg, cfg = jget_arch("mixtral-8x22b"), get_arch("mixtral-8x22b")
        jdefs, defs = jmoe.moe_defs(jcfg), moe.moe_defs(cfg)
        assert {k: d.shape for k, d in defs.items()} == {
            k: d.shape for k, d in jdefs.items()}
        assert defs["w_gate"].shape == (16, 6144, 8192)
        assert defs["router"].dtype == torch.float32
        return
    jcfg, cfg = _cfgs(arch, "bfloat16")
    jp, p = _params(jcfg, cfg, seed=4)
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    assert tree_lib.tree_keys(p) == [
        "/".join(k.key for k in path) for path, _ in jleaves]
    back = convert.to_leaves(p)
    for got, (_, want) in zip(back, jleaves):
        want = np.asarray(want)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got.view(np.uint8),
                                      want.view(np.uint8))
    assert p["router"].dtype == torch.float32
    assert p["w_gate"].dtype == torch.bfloat16
    split = moe.expert_split(cfg)
    e, d, f = cfg.moe.n_experts, cfg.d_model, cfg.d_ff
    assert tuple(p["w_down"].shape) == (e * split, f // split, d)
    again = convert.from_leaves(pdefs.empty(moe.moe_defs(cfg)), back)
    for k in p:
        assert torch.equal(again[k], p[k])


def test_moe_config_fields_match():
    assert repr(MoEConfig(8, 2)) == repr(JMoEConfig(8, 2))
