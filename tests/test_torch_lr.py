"""The port's LR job, held to the JAX package on the CPU.

The Criteo-like generators are numpy in both packages and must agree bit
for bit. LR loss and gradients (dense and sparse) are held to
``jax.value_and_grad`` at rtol=1e-5, atol=1e-6: autograd and XLA sum the
minibatch in different orders. A live 2-worker, 6-step LR job with Adam
runs through ``repro_torch`` on the CPU (the fused B2 step's plain version)
from the JAX package's initial parameters, and through
``repro.runtime.run_job`` (``optim.adam`` then the jnp filter); the final
held-out BCE is held to 1e-3 relative and the wire bytes must be equal.
Within the port the result is bit-identical across broker shard counts.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.checkpoint import store as jstore
from repro.data import synthetic as jsyn
from repro.models import lr as jlr
from repro.runtime import FaaSJobConfig as JFaaSJobConfig
from repro.runtime import build_workload, run_job as jrun_job
from repro.runtime import sharding as jsharding

from repro_torch import convert
from repro_torch.data import synthetic
from repro_torch.models import lr
from repro_torch.runtime import sharding, supervisor, workload
from repro_torch.runtime.supervisor import FaaSJobConfig, run_job
from repro_torch.wire import codec

RTOL, ATOL = 1e-5, 1e-6
WCFG = {"n_samples": 4000, "batch_size": 128}
JOB = dict(workload="lr", n_workers=2, total_steps=6, invocation_steps=3,
           checkpoint_every=100, optimizer="adam", lr=0.05, isp_v=0.5,
           deadline_s=180.0)


@pytest.mark.parametrize("n,seed", ((1, 0), (500, 0), (3000, 7)))
def test_criteo_generators_are_bit_identical(n, seed):
    jc = jsyn.CriteoLikeConfig(n_samples=n, seed=seed)
    tc = synthetic.CriteoLikeConfig(n_samples=n, seed=seed)
    assert jc == type(jc)(**vars(tc))
    for a, b in zip(synthetic.make_criteo_dense(tc),
                    jsyn.make_criteo_dense(jc)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    for a, b in zip(synthetic.make_criteo_sparse(tc),
                    jsyn.make_criteo_sparse(jc)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def _both(sparse: bool, l2: float, seed: int, batch: int = 96):
    rng = np.random.default_rng(seed)
    if sparse:
        idx, val, y = synthetic.make_criteo_sparse(
            synthetic.CriteoLikeConfig(n_samples=batch, seed=seed,
                                       hash_dim=5000))
        n_features = 5000
        jb = jlr.SparseBatch(jnp.asarray(idx), jnp.asarray(val),
                             jnp.asarray(y))
        tb = lr.SparseBatch(torch.from_numpy(idx.astype(np.int64)),
                            torch.from_numpy(val), torch.from_numpy(y))
    else:
        x, y = synthetic.make_criteo_dense(
            synthetic.CriteoLikeConfig(n_samples=batch, seed=seed))
        n_features = x.shape[1]
        jb = jlr.DenseBatch(jnp.asarray(x), jnp.asarray(y))
        tb = lr.DenseBatch(torch.from_numpy(x), torch.from_numpy(y))
    w = rng.standard_normal(n_features).astype(np.float32)
    b = np.float32(rng.standard_normal())
    jcfg = jlr.LRConfig(n_features=n_features, l2=l2, sparse=sparse)
    cfg = lr.LRConfig(n_features=n_features, l2=l2, sparse=sparse)
    jp = jlr.LRParams(jnp.asarray(w), jnp.asarray(b))
    tp = lr.LRParams(torch.from_numpy(w), torch.tensor(b))
    return jcfg, cfg, jp, tp, jb, tb


@pytest.mark.parametrize("sparse", (False, True))
@pytest.mark.parametrize("l2", (0.0, 0.01))
@pytest.mark.parametrize("seed", (0, 1))
def test_lr_loss_and_grads_match_value_and_grad(sparse, l2, seed):
    jcfg, cfg, jp, tp, jb, tb = _both(sparse, l2, seed)
    jloss, jg = jlr.grad_fn(jcfg, jp, jb)
    loss, g = lr.grad_fn(cfg, tp, tb)
    assert g.w.shape == tp.w.shape and g.b.shape == ()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(g.w.numpy(), np.asarray(jg.w), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(g.b.numpy(), np.asarray(jg.b), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(lr.accuracy(cfg, tp, tb)),
                               float(jlr.accuracy(jcfg, jp, jb)), rtol=0,
                               atol=1e-6)


def test_sparse_grad_touches_only_the_batch_coordinates():
    _, cfg, _, tp, _, tb = _both(True, 0.0, 3, batch=8)
    _, g = lr.grad_fn(cfg, tp, tb)
    touched = torch.zeros(cfg.n_features, dtype=torch.bool)
    touched[tb.idx.reshape(-1)] = True
    assert not bool(g.w[~touched].any())


def _params0(tmp_path) -> str:
    jp = build_workload("lr", WCFG).params0
    return convert.write_params0(str(tmp_path / "params0.npz"), ["w", "b"],
                                 [np.asarray(jp.w), np.asarray(jp.b)])


def test_lr_workload_matches_jax(tmp_path):
    jwl = build_workload("lr", WCFG)
    wl = workload.build("lr", dict(WCFG, params0=_params0(tmp_path)),
                        device="cpu")
    assert wl.n_batches == jwl.n_batches
    assert wl.params0.b.shape == () and wl.params0.w.shape == (13,)
    assert convert.to_leaves(wl.params0)[0].tobytes() == np.asarray(
        jwl.params0.w).tobytes()
    for key in (0, 5, 31):
        jb, tb = jwl.batch(key), wl.batch(key)
        assert tb.x.numpy().tobytes() == np.asarray(jb.x).tobytes()
        assert tb.y.numpy().tobytes() == np.asarray(jb.y).tobytes()
    np.testing.assert_allclose(wl.eval_fn(wl.params0),
                               jwl.eval_fn(jwl.params0), rtol=RTOL)
    seeded = workload.build("lr", WCFG, device="cpu").params0
    assert seeded.w.shape == (13,) and float(seeded.b) == 0.0


@pytest.mark.parametrize("scheme", ("dense", "sparse", "bitmap", "auto"))
@pytest.mark.parametrize("impl", ("numpy", "cuda"))
def test_lr_leaves_through_the_codec_match_jax(scheme, impl):
    """The 13-element ``w`` and the 0-d ``b`` (significant, as it always
    is from its zero start) give the JAX codec's bytes and decode back."""
    w = np.zeros(13, np.float32)
    w[[2, 7]] = (0.25, -1.5)
    b = np.float32(-0.125)
    jt = jlr.LRParams(w, b)
    tt = lr.LRParams(codec.to_tensor(w), codec.to_tensor(np.asarray(b)))
    ja = jsharding.tree_assignment(jt, 1)
    ta = sharding.tree_assignment(tt, 1)
    assert ta == ja
    (jm, jp), = jsharding.encode_tree_sharded(jt, ja, 1, scheme=scheme)[0]
    (tm, tp), = sharding.encode_tree_sharded(tt, ta, 1, scheme=scheme,
                                             impl=impl)[0]
    blob = b"".join(bytes(p) for p in tp)
    assert tm == jm and blob == b"".join(bytes(p) for p in jp)
    like = {k: (tuple(x.shape), x.dtype) for k, x in
            zip(codec.tree_keys(tt), (tt.w, tt.b))}
    bufs = sharding.LeafBuffers(like, "cpu")
    off = 0
    for m in tm:
        bufs.add_encoded(m, blob[off:off + m["nbytes"]], impl=impl)
        off += m["nbytes"]
    assert bufs["w"].numpy().tobytes() == w.tobytes()
    assert bufs["b"].shape == () and float(bufs["b"]) == float(b)


def _port_cfg(run_dir, params0, **kw) -> FaaSJobConfig:
    return FaaSJobConfig(run_dir=str(run_dir), device="cpu",
                         workload_cfg=dict(WCFG, params0=params0),
                         **dict(JOB, **kw))


@pytest.fixture(scope="module")
def lr_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lr")
    p0 = _params0(tmp)
    cfg = _port_cfg(tmp / "job", p0)
    return cfg, run_job(cfg), p0, tmp


def _jax_final_state(run_dir):
    wl = build_workload("lr", WCFG)
    like = {"params": wl.params0,
            "opt": joptim.make("adam", JOB["lr"]).init(wl.params0),
            "residual": jax.tree.map(jnp.zeros_like, wl.params0)}
    d = os.path.join(run_dir, "ckpt", "w000")
    return jstore.restore(d, jstore.latest_step(d), like)


def test_live_lr_job_tracks_the_jax_runtime(lr_run, tmp_path):
    cfg, res, _, _ = lr_run
    jres = jrun_job(JFaaSJobConfig(run_dir=str(tmp_path / "jax"),
                                   workload_cfg=dict(WCFG), **JOB))
    rel_eval = abs(res["final_eval"] - jres["final_eval"]) / jres[
        "final_eval"]
    params, _ = supervisor.final_params(cfg)
    got = convert.to_leaves(params)
    want = jax.tree_util.tree_leaves(
        _jax_final_state(str(tmp_path / "jax"))["params"])
    absd = max(float(np.max(np.abs(a - np.asarray(b))))
               for a, b in zip(got, want))
    print(f"final eval BCE port {res['final_eval']:.6f} jax "
          f"{jres['final_eval']:.6f} (rel {rel_eval:.2e}); params max "
          f"|diff| {absd:.3e}; wire bytes port {res['wire_bytes_total']} "
          f"jax {jres['wire_bytes_total']}")
    assert res["steps"] == jres["steps"] == 6
    assert res["final_pool"] == jres["final_pool"] == 2
    assert res["n_invocations"] == jres["n_invocations"] == 4
    assert res["dup_mismatches"] == 0
    assert res["invariant_max_err"] == 0.0
    assert np.isfinite(res["final_eval"])
    assert rel_eval <= 1e-3
    assert res["wire_bytes_total"] == jres["wire_bytes_total"]
    # the CPU path runs the plain versions: nothing is launched
    assert all(c == {} for c in res["kernel_launches_by_worker"].values())


def test_fused_adam_checkpoint_restores_in_the_jax_package(lr_run):
    """The fused step keeps ``optim.adam``'s ``OptState(step, mu, nu)``:
    the port's final checkpoint restores with the JAX package's template
    and its step counts the steps taken."""
    cfg, res, _, _ = lr_run
    tree = _jax_final_state(cfg.run_dir)
    assert int(tree["opt"].step) == res["steps"] + 1
    assert np.asarray(tree["params"].b).shape == ()
    assert float(jnp.max(jnp.abs(tree["opt"].nu.w))) > 0.0


def test_lr_digest_is_identical_across_broker_shards(lr_run):
    _, _, p0, tmp = lr_run
    kw = dict(wire_scheme="bitmap", invocation_steps=1_000_000)
    cfg2 = _port_cfg(tmp / "job2", p0, n_brokers=2, **kw)
    cfg1 = _port_cfg(tmp / "job1", p0, **kw)
    r2, r1 = run_job(cfg2), run_job(cfg1)
    assert r2["dup_mismatches"] == r1["dup_mismatches"] == 0
    assert r2["wire_bytes_total"] == r1["wire_bytes_total"]
    assert supervisor.final_params_digest(cfg2) == \
        supervisor.final_params_digest(cfg1)
