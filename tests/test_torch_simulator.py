"""The port's serverless training simulator and consistency models, held to
the JAX package on the CPU.

Sizes: PMF at ``chip_smoke.py``'s ``SMALL`` width (120 users x 150 movies,
rank 4, 6,000 ratings), LR sparse with a 2,000-wide hash; P = 4 workers,
6 steps. Every JAX run starts from the JAX package's own ``params0``.

Tolerances, and why:

* The consistency functions (``ssp_step``, ``ssp_drain``, ``bsp_exchange``,
  ``isp_exchange``), ``evict_and_reintegrate``, the vmapped gradient
  against a per-worker loop, and the simulator's state after each step
  against the JAX simulator's ``_multi_worker_step`` run op by op (not
  jitted): bit for bit. The port sums over the worker axis as a left fold,
  which is the order XLA reduces a leading axis in.
* The same for LR sparse: within ``LR_RTOL``/``LR_ATOL`` (1e-5, 1e-6,
  ``tests/test_torch_lr.py``'s): the model's logits sum each row's 39
  features in another order than XLA's, so its gradient is not
  bit-exact to begin with.
* The step's mean loss against that op-by-op JAX step: ``LOSS_RTOL``
  (2.4e-7, two float32 ulps): ``torch.mean`` and ``jnp.mean`` sum the
  minibatch in different orders. Gradients do not see this.
* ``_step_times`` and billing, fed the JAX run's loss and ``comm_frac``
  trace: bit for bit (host numpy, float64, the same code).
* Whole runs against the jitted JAX simulator: losses within
  ``RUN_LOSS_RTOL`` (1e-6) and ``comm_frac`` within ``RUN_COMM_RTOL``
  (2.4e-7, two ulps) relative, and so the bytes shipped; wall and cost
  within ``RUN_WALL_RTOL`` (1e-9): XLA fuses the jitted step, so its gradient rounds differently in
  the last place, and it turns ``comm_frac``'s division by the constant
  parameter count into a product with the reciprocal (one ulp off the
  division); the bytes each step ships, and so wall and cost, follow
  ``comm_frac``. Measured on these runs: losses 1.6e-7 relative at most,
  ``comm_frac`` 8.4e-8, wall 3.8e-12, cost 2.6e-13.
* The port on the card against the port on the CPU (``chip_smoke.py``'s
  ``simulator`` phase, full ML-10M width, P = 8, 3 ISP steps; it keeps a
  copy of these two numbers): losses within ``CARD_LOSS_RTOL`` (1e-5) and
  ``comm_frac`` within ``CARD_COMM_RTOL`` (1e-3) relative. The card sums
  the minibatch and the duplicate rows of the indexing backward in other
  orders, and at that width an element within an ulp of its threshold can
  flip its mask: each flip moves ``comm_frac`` by one hit in thousands.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.core import autotuner as jautotuner
from repro.core import consistency as jcons
from repro.core import isp as jisp
from repro.core import simulator as jsim
from repro.data import synthetic as jsyn
from repro.models import lr as jlr
from repro.models import pmf as jpmf

from repro_torch import convert, optim
from repro_torch import tree as tree_lib
from repro_torch.core import autotuner, consistency as cons, isp
from repro_torch.core import simulator as sim
from repro_torch.data import synthetic
from repro_torch.kernels import build
from repro_torch.models import lr, pmf

LOSS_RTOL = 2.4e-7
LR_RTOL, LR_ATOL = 1e-5, 1e-6  # tests/test_torch_lr.py's
RUN_LOSS_RTOL, RUN_COMM_RTOL, RUN_WALL_RTOL = 1e-6, 2.4e-7, 1e-9
CARD_LOSS_RTOL, CARD_COMM_RTOL = 1e-5, 1e-3
P, B, STEPS = 4, 64, 6
RANK = 4
ML = dict(n_users=120, n_movies=150, n_ratings=6000, rank=RANK, seed=0)
CRITEO = dict(n_samples=4000, hash_dim=2000, seed=0)
# a tuner that finds the knee at once and scales in at every interval, so
# the "MLLess + All" job evicts within the test's 6 steps
TUNER = dict(sched_interval_s=0.0, delta_s=0.05, knee_slope_threshold=10.0,
             knee_window=2, min_points_for_fit=3)
# examples/mlless_pmf.py's five jobs, plus SSP
JOBS = {
    "mlless_bsp": ("MLLESS", "BSP", False),
    "mlless_isp": ("MLLESS", "ISP", False),
    "mlless_all": ("MLLESS", "ISP", True),
    "serverful": ("SERVERFUL", "BSP", False),
    "pywren": ("PYWREN", "BSP", False),
    "mlless_ssp": ("MLLESS", "SSP", False),
}


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a)).to(dtype=dtype)


def _leaves(tree) -> list:
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _same(port_tree, jax_tree, exact: bool = True) -> None:
    """Bit for bit, or within the LR model's own tolerance."""
    got = convert.to_leaves(port_tree)
    want = _leaves(jax_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        if exact:
            assert g.tobytes() == w.tobytes()
        else:
            np.testing.assert_allclose(g, w, rtol=LR_RTOL, atol=LR_ATOL)


# -- the workloads ----------------------------------------------------------


class PMFJob:
    """examples/mlless_pmf.py's job at the SMALL width, in both packages."""

    def __init__(self):
        ml = jsyn.MovieLensLikeConfig(**ML)
        self.users, self.movies, self.ratings = jsyn.make_movielens(ml)
        self.jcfg = jpmf.PMFConfig(ml.n_users, ml.n_movies, RANK)
        self.cfg = pmf.PMFConfig(ml.n_users, ml.n_movies, RANK)
        self.jparams0 = jpmf.init(self.jcfg, jax.random.PRNGKey(0))
        self.params0 = pmf.PMFParams(*(_t(a) for a in self.jparams0))
        eidx = np.random.default_rng(0).choice(len(self.ratings), 512,
                                               replace=False)
        self.jeval = jsyn.ratings_batch(self.users, self.movies,
                                        self.ratings, eidx)
        self.teval = synthetic.ratings_batch(self.users, self.movies,
                                             self.ratings, eidx, "cpu")

    def _idx(self, step, n):
        return np.random.default_rng(step).integers(0, len(self.ratings),
                                                    size=(n, B))

    def jbatch(self, step, n):
        return jsyn.ratings_batch(self.users, self.movies, self.ratings,
                                  self._idx(step, n))

    def tbatch(self, step, n):
        return synthetic.ratings_batch(self.users, self.movies, self.ratings,
                                       self._idx(step, n), "cpu")

    def jeval_fn(self, p):
        return float(jpmf.rmse(p, self.jeval))

    def teval_fn(self, p):
        return float(pmf.rmse(p, self.teval))

    def kw(self):
        nnz = lambda b: 2 * RANK * min(b, ML["n_users"])  # noqa: E731
        return dict(flops_per_sample=6 * RANK * 3, update_nnz_fn=nnz)

    def jsim(self, **cfg):
        return jsim.ServerlessSimulator(
            _jconfig(**cfg), grad_fn=partial(jpmf.grad_fn, self.jcfg),
            optimizer=joptim.make("nesterov", 0.08), params=self.jparams0,
            **self.kw())

    def tsim(self, **cfg):
        return sim.ServerlessSimulator(
            _tconfig(**cfg), loss_fn=partial(pmf.loss_fn, self.cfg),
            optimizer=optim.make("nesterov", 0.08), params=self.params0,
            device="cpu", **self.kw())


class LRSparseJob:
    """benchmarks/table3_weak_scaling.py's job (LR sparse, Adam, BSP) with
    a 2,000-wide hash."""

    def __init__(self):
        c = jsyn.CriteoLikeConfig(**CRITEO)
        self.idx, self.val, self.y = jsyn.make_criteo_sparse(c)
        self.jcfg = jlr.LRConfig(n_features=c.hash_dim, sparse=True)
        self.cfg = lr.LRConfig(n_features=c.hash_dim, sparse=True)
        self.jparams0 = jlr.init(self.jcfg, jax.random.PRNGKey(0))
        self.params0 = lr.LRParams(*(_t(a) for a in self.jparams0))
        self.nnz = lambda b: b * 13 + b * 26  # noqa: E731

    def _sel(self, step, n):
        return np.random.default_rng(1000 + step).integers(
            0, len(self.y), size=(n, B))

    def jbatch(self, step, n):
        return jsyn.sparse_batch(self.idx, self.val, self.y,
                                 self._sel(step, n))

    def tbatch(self, step, n):
        return synthetic.sparse_batch(self.idx, self.val, self.y,
                                      self._sel(step, n), "cpu")

    def jsim(self, **cfg):
        return jsim.ServerlessSimulator(
            _jconfig(sparse_model=True, **cfg),
            grad_fn=partial(jlr.grad_fn, self.jcfg),
            optimizer=joptim.make("adam", 0.3), params=self.jparams0,
            flops_per_sample=6.0 * 39, update_nnz_fn=self.nnz)

    def tsim(self, **cfg):
        return sim.ServerlessSimulator(
            _tconfig(sparse_model=True, **cfg),
            loss_fn=partial(lr.loss_fn, self.cfg),
            optimizer=optim.make("adam", 0.3), params=self.params0,
            flops_per_sample=6.0 * 39, update_nnz_fn=self.nnz,
            device="cpu")


def _jconfig(platform="MLLESS", model="BSP", slack=3, v=0.7, **kw):
    kw.setdefault("sparse_model", True)
    return jsim.SimulatorConfig(
        n_workers=P, platform=jsim.Platform[platform],
        consistency=jcons.ConsistencyConfig(
            model=jcons.Model[model], isp=jisp.ISPConfig(v=v), slack=slack),
        **kw)


def _tconfig(platform="MLLESS", model="BSP", slack=3, v=0.7, **kw):
    kw.setdefault("sparse_model", True)
    return sim.SimulatorConfig(
        n_workers=P, platform=sim.Platform[platform],
        consistency=cons.ConsistencyConfig(
            model=cons.Model[model], isp=isp.ISPConfig(v=v), slack=slack),
        **kw)


@pytest.fixture(scope="module")
def pmf_job():
    return PMFJob()


@pytest.fixture(scope="module")
def lr_job():
    return LRSparseJob()


# -- synthetic batches and the ISP helpers ----------------------------------


def test_batch_helpers_select_what_jax_selects(pmf_job, lr_job):
    sel = pmf_job._idx(3, P)
    got = synthetic.ratings_batch(pmf_job.users, pmf_job.movies,
                                  pmf_job.ratings, sel, "cpu")
    want = jsyn.ratings_batch(pmf_job.users, pmf_job.movies,
                              pmf_job.ratings, sel)
    assert got.user.dtype == got.movie.dtype == torch.int64
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    sl = slice(5, 37)
    for g, w in zip(
            synthetic.sparse_batch(lr_job.idx, lr_job.val, lr_job.y, sl,
                                   "cpu"),
            jsyn.sparse_batch(lr_job.idx, lr_job.val, lr_job.y, sl)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    x, y = jsyn.make_criteo_dense(jsyn.CriteoLikeConfig(n_samples=300))
    for g, w in zip(synthetic.dense_batch(x, y, sl, "cpu"),
                    jsyn.dense_batch(x, y, sl)):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _isp_inputs(seed: int):
    rng = np.random.default_rng(seed)
    params = {"a": rng.standard_normal((6, 5)).astype(np.float32),
              "b": rng.standard_normal(7).astype(np.float32)}
    params["a"][0, :3] = 0.0
    params["b"][2] = -0.0
    res = {k: (rng.standard_normal(v.shape) * 0.3).astype(np.float32)
           for k, v in params.items()}
    masks = {k: rng.random(v.shape) < 0.3 for k, v in params.items()}
    return params, res, masks


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_isp_helpers_match_jax(seed):
    params, res, masks = _isp_inputs(seed)
    tp = {k: _t(v) for k, v in params.items()}
    st = isp.init_state(tp)
    jst = jisp.init_state(params)
    assert st.step == int(jst.step) == 1
    _same(st.residual, jst.residual)
    tm = {k: _t(v) for k, v in masks.items()}
    assert isp.communicated_bytes(tm) == float(jisp.communicated_bytes(masks))
    assert isp.communicated_bytes(tm, 4) == float(
        jisp.communicated_bytes(masks, 4))
    assert isp.dense_bytes(tp) == jisp.dense_bytes(params)
    assert isp.dense_bytes(tp, 2) == jisp.dense_bytes(params, 2)
    tr = isp.ISPState({k: _t(v) for k, v in res.items()}, 3)
    jr = jisp.ISPState(res, jnp.asarray(3, jnp.int32))
    assert isp.residual_relative_norm(tr, tp) == float(
        jisp.residual_relative_norm(jr, params))


# -- the consistency models, bit for bit ------------------------------------


def _stacked(rng, p: int, scale: float = 1.0, lead: tuple = ()):
    shapes = {"U": (9, 3), "M": (3, 11), "b": ()}
    return {k: (rng.standard_normal(lead + (p,) + s)
                * np.exp(rng.uniform(-6, 2, lead + (p,) + s)) * scale
                ).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("p,slack,steps", ((1, 1, 3), (3, 2, 4), (4, 3, 5),
                                           (5, 3, 4), (8, 1, 3), (24, 3, 4)))
def test_ssp_step_and_drain_match_jax(p, slack, steps):
    rng = np.random.default_rng(p * 10 + slack)
    params = _stacked(rng, p)
    st = cons.ssp_init({k: _t(v) for k, v in params.items()}, slack,
                       device="cpu")
    jst = jcons.ssp_init(params, slack)
    _same(st.queue, jst.queue)
    for _ in range(steps):
        u = _stacked(rng, p, 1e-2)
        vis, st = cons.ssp_step(st, {k: _t(v) for k, v in u.items()})
        jvis, jst = jcons.ssp_step(jst, u)
        _same(vis, jvis)
        _same(st.queue, jst.queue)
        assert st.step == int(jst.step)
    _same(cons.ssp_drain(st), jcons.ssp_drain(jst))


@pytest.mark.parametrize("p", (1, 2, 4, 5, 8, 24))
def test_bsp_exchange_matches_jax(p):
    u = _stacked(np.random.default_rng(p), p)
    _same(cons.bsp_exchange({k: _t(v) for k, v in u.items()}),
          jcons.bsp_exchange(u))


@pytest.mark.parametrize("p,v,decay", ((1, 0.7, True), (4, 0.7, True),
                                       (5, 0.3, False), (8, 0.0, True),
                                       (24, 0.7, True)))
def test_isp_exchange_matches_jax(p, v, decay):
    rng = np.random.default_rng(p + 100)
    cfg = isp.ISPConfig(v=v, decay=decay)
    jcfg = jisp.ISPConfig(v=v, decay=decay)
    x = _stacked(rng, p)
    x["U"][0, 0, :] = 0.0  # the absolute floor
    x["M"][:, 1, 2] = -0.0
    tx = {k: _t(a) for k, a in x.items()}
    st = cons.isp_init(tx, device="cpu")
    jst = jcons.isp_init(x)
    build.reset_launches()
    for _ in range(4):
        u = _stacked(rng, p, 0.3)
        vis, st, masks = cons.isp_exchange(cfg, st,
                                           {k: _t(a) for k, a in u.items()},
                                           tx)
        jvis, jst, jmasks = jcons.isp_exchange(jcfg, jst, u, x)
        _same(vis, jvis)
        _same(st.residual, jst.residual)
        _same(masks, jmasks)
        assert st.step == int(jst.step)
    # CPU tensors run B1's plain version: nothing launched
    assert dict(build.LAUNCHES) == {}


@pytest.mark.parametrize("p,evicted", ((2, 1), (4, 3), (4, 1), (8, 5)))
def test_evict_and_reintegrate_matches_jax(p, evicted):
    rng = np.random.default_rng(p * 7 + evicted)
    reps = _stacked(rng, p)
    active = rng.random(p) < 0.7
    active[evicted] = False
    got = autotuner.evict_and_reintegrate(
        {k: _t(v) for k, v in reps.items()}, evicted, _t(active))
    _same(got, jautotuner.evict_and_reintegrate(reps, evicted,
                                                jnp.asarray(active)))


def test_evict_and_reintegrate_is_not_the_pool_division():
    """x <- (x + x_evicted) / 2 whatever the pool size."""
    reps = {"w": _t(np.arange(12, dtype=np.float32).reshape(4, 3))}
    got = autotuner.evict_and_reintegrate(
        reps, 3, _t(np.array([True, True, False, False])))["w"]
    want = np.arange(12, dtype=np.float32).reshape(4, 3)
    want[:2] = 0.5 * (want[:2] + want[3])
    np.testing.assert_array_equal(got.numpy(), want)


# -- the vmapped gradient -----------------------------------------------------


def test_vmapped_gradient_matches_a_per_worker_loop(pmf_job, lr_job):
    rng = np.random.default_rng(5)
    for job, loss_fn, grad_fn, params in (
            (pmf_job, partial(pmf.loss_fn, pmf_job.cfg),
             partial(pmf.grad_fn, pmf_job.cfg), pmf_job.params0),
            (lr_job, partial(lr.loss_fn, lr_job.cfg),
             partial(lr.grad_fn, lr_job.cfg), lr_job.params0)):
        stacked = tree_lib.tree_map(
            lambda x: x[None] + _t(rng.standard_normal((P,) + tuple(x.shape))
                                   * 0.05, torch.float32), params)
        batch = job.tbatch(2, P)
        grads, losses = torch.func.vmap(torch.func.grad_and_value(loss_fn))(
            stacked, batch)
        for p in range(P):
            loss, g = grad_fn(tree_lib.tree_map(lambda x: x[p], stacked),
                              tree_lib.tree_map(lambda x: x[p], batch))
            assert float(loss) == float(losses[p])
            for a, b in zip(tree_lib.leaves(g), tree_lib.leaves(grads)):
                assert torch.equal(a, b[p])


# -- the multi-worker step against JAX's, op by op --------------------------


@pytest.mark.parametrize("model", ("BSP", "SSP", "ISP"))
@pytest.mark.parametrize("job", ("pmf", "lr"))
def test_step_state_matches_jax_op_by_op(model, job, pmf_job, lr_job):
    """The state after each of 5 steps, one worker inert from step 3, bit
    for bit against the JAX step run op by op; its mean loss within
    LOSS_RTOL. Also carries the JAX state over (``convert.
    load_simulator_state``) after step 2 and goes on from there."""
    w = pmf_job if job == "pmf" else lr_job
    exact = job == "pmf"
    js = w.jsim(model=model, slack=2)
    ts = w.tsim(model=model, slack=2)
    _same(ts.opt_state, js.opt_state)
    assert tuple(ts.opt_state.step.shape) == (P,)
    for step in range(1, 6):
        act = np.array([True, True, step < 3, True])
        out = js._multi_worker_step(js.replicas, js.opt_state, js.isp_state,
                                    js.ssp_state, w.jbatch(step, P),
                                    jnp.asarray(act))
        (js.replicas, js.opt_state, js.isp_state, js.ssp_state, jloss,
         jcomm) = out
        loss, comm = ts._multi_worker_step(w.tbatch(step, P), _t(act))
        _same(ts.replicas, js.replicas, exact)
        _same(ts.opt_state, js.opt_state, exact)
        if model == "ISP":
            _same(ts.isp_state.residual, js.isp_state.residual, exact)
            assert ts.isp_state.step == int(js.isp_state.step)
        if model == "SSP":
            _same(ts.ssp_state.queue, js.ssp_state.queue, exact)
        if exact:
            assert float(comm) == float(jcomm)
            np.testing.assert_allclose(float(loss), float(jloss),
                                       rtol=LOSS_RTOL, atol=0)
        else:
            np.testing.assert_allclose(float(comm), float(jcomm),
                                       rtol=LR_RTOL)
            np.testing.assert_allclose(float(loss), float(jloss),
                                       rtol=LR_RTOL)
        if step == 2:  # a fresh port simulator, carried over from JAX
            ts = w.tsim(model=model, slack=2)
            convert.load_simulator_state(
                ts, _leaves(js.replicas), _leaves(js.opt_state),
                _leaves(js.isp_state) if model == "ISP" else None,
                _leaves(js.ssp_state) if model == "SSP" else None)


def test_the_other_models_state_is_not_allocated(pmf_job):
    assert pmf_job.tsim(model="BSP").isp_state is None
    assert pmf_job.tsim(model="BSP").ssp_state is None
    assert pmf_job.tsim(model="ISP").ssp_state is None
    assert pmf_job.tsim(model="SSP").isp_state is None


# -- timing and billing, fed JAX's trace ------------------------------------

BILLING = {
    "mlless_bsp": dict(platform="MLLESS", model="BSP"),
    "mlless_isp_cold": dict(platform="MLLESS", model="ISP", cold_start_s=0.7,
                            invocations_per_worker=3),
    "mlless_isp_tuner": dict(platform="MLLESS", model="ISP", tuner=True),
    "mlless_ssp_straggler": dict(platform="MLLESS", model="SSP", slack=2,
                                 straggler_worker=1, straggler_delay_s=0.4,
                                 straggler_every=2),
    "mlless_ssp_auto": dict(platform="MLLESS", model="SSP", slack=3,
                            wire_scheme="auto", n_redis=2, seed=3),
    "serverful": dict(platform="SERVERFUL", model="BSP",
                      straggler_worker=0, straggler_delay_s=0.2),
    "pywren_cold": dict(platform="PYWREN", model="ISP", cold_start_s=1.5,
                        invocations_per_worker=2, wire_scheme="bitmap"),
}


@pytest.mark.parametrize("case", sorted(BILLING))
def test_step_times_and_billing_match_jax_on_its_trace(case, pmf_job):
    """The port's run fed the JAX run's (loss, comm_frac) trace in place of
    its own step: every record, the lifetimes, the wall, the bill and the
    evictions bit for bit."""
    cfg = dict(BILLING[case])
    tuned = cfg.pop("tuner", False)
    js = pmf_job.jsim(**cfg)
    jres = js.run(pmf_job.jbatch, B, STEPS,
                  tuner=jautotuner.ScaleInAutoTuner(
                      jautotuner.AutoTunerConfig(**TUNER), P)
                  if tuned else None)
    ts = pmf_job.tsim(**cfg)
    trace = iter([(r.loss, r.comm_fraction) for r in jres.records])

    def replay(batch, mask):
        loss, comm = next(trace)
        return (torch.tensor(loss, dtype=torch.float32),
                torch.tensor(comm, dtype=torch.float32))

    ts._multi_worker_step = replay
    res = ts.run(pmf_job.tbatch, B, STEPS,
                 tuner=autotuner.ScaleInAutoTuner(
                     autotuner.AutoTunerConfig(**TUNER), P)
                 if tuned else None)
    assert [vars(r) for r in res.records] == [vars(r)
                                              for r in jres.records]
    assert res.worker_lifetimes_s == [float(t)
                                      for t in jres.worker_lifetimes_s]
    assert res.total_wall_s == jres.total_wall_s
    assert res.iaas_cost == jres.iaas_cost
    assert (res.bill is None) == (jres.bill is None)
    if res.bill is not None:
        assert vars(res.bill) == vars(jres.bill)
    assert res.total_cost == jres.total_cost
    assert res.summary == jres.summary
    if tuned:
        assert res.summary["final_workers"] < P
        np.testing.assert_array_equal(ts.active, js.active)


# -- whole runs against the jitted JAX simulator ----------------------------


def _close_runs(res, jres) -> None:
    assert len(res.records) == len(jres.records)
    for r, j in zip(res.records, jres.records):
        assert r.active_workers == j.active_workers
        np.testing.assert_allclose(r.loss, j.loss, rtol=RUN_LOSS_RTOL)
        np.testing.assert_allclose(r.comm_fraction, j.comm_fraction,
                                   rtol=RUN_COMM_RTOL)
        np.testing.assert_allclose(r.wall_s, j.wall_s, rtol=RUN_WALL_RTOL)
        np.testing.assert_allclose(r.comm_bytes, j.comm_bytes,
                                   rtol=RUN_COMM_RTOL)
    np.testing.assert_allclose(res.total_wall_s, jres.total_wall_s,
                               rtol=RUN_WALL_RTOL)
    np.testing.assert_allclose(res.total_cost, jres.total_cost,
                               rtol=RUN_WALL_RTOL)
    assert res.summary == jres.summary


@pytest.mark.parametrize("name", list(JOBS))
def test_mlless_pmf_jobs_match_jax(name, pmf_job):
    platform, model, tuned = JOBS[name]
    kw = dict(platform=platform, model=model)
    jres = pmf_job.jsim(**kw).run(
        pmf_job.jbatch, B, STEPS, eval_fn=pmf_job.jeval_fn,
        tuner=jautotuner.ScaleInAutoTuner(
            jautotuner.AutoTunerConfig(**TUNER), P) if tuned else None)
    ts = pmf_job.tsim(**kw)
    build.reset_launches()
    res = ts.run(pmf_job.tbatch, B, STEPS, eval_fn=pmf_job.teval_fn,
                 tuner=autotuner.ScaleInAutoTuner(
                     autotuner.AutoTunerConfig(**TUNER), P)
                 if tuned else None)
    assert dict(build.LAUNCHES) == {}  # the plain versions on the CPU
    _close_runs(res, jres)
    if tuned:
        assert res.summary["final_workers"] < P
    if model == "BSP":  # every replica the same
        for x in tree_lib.leaves(ts.replicas):
            assert all(torch.equal(x[0], x[p]) for p in range(1, P))
    if model == "ISP":
        assert all(0.0 < r.comm_fraction < 1.0 for r in res.records)


def test_table3_lr_sparse_adam_bsp_matches_jax(lr_job):
    jres = lr_job.jsim().run(lr_job.jbatch, B, STEPS, loss_threshold=0.55)
    res = lr_job.tsim().run(lr_job.tbatch, B, STEPS, loss_threshold=0.55)
    _close_runs(res, jres)
    assert res.converged_at_step == jres.converged_at_step


# -- the device rule -----------------------------------------------------------


def test_cuda_is_the_default_and_raises_without_a_card(monkeypatch,
                                                       pmf_job):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sim.ServerlessSimulator(
            _tconfig(), loss_fn=partial(pmf.loss_fn, pmf_job.cfg),
            optimizer=optim.make("sgd", 0.1), params=pmf_job.params0,
            flops_per_sample=1.0)
    stacked = {"w": torch.zeros(P, 3)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cons.isp_init(stacked)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cons.ssp_init(stacked, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        synthetic.ratings_batch(pmf_job.users, pmf_job.movies,
                                pmf_job.ratings, slice(0, 4), "cuda")
