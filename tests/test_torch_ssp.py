"""Bounded staleness (SSP, DESIGN.md §13) on the port's live FaaS runtime,
held to the JAX runtime on the CPU.

Protocol level: the port's broker releases an SSP pull at step t only once
every update from steps <= t - slack - 1 is stored, serves exactly that
frontier step, and keeps both after a WAL-replay respawn (the counterparts
of ``tests/test_runtime_ssp.py``).

End to end: the small PMF job (3 workers, slack 2, 8 steps, 3 steps an
invocation) runs through the port and through ``repro.runtime.run_job``
from the same initial parameters. The two frameworks sum the minibatch
gradient in different orders, so elements near the ISP threshold can flip
and the runs are not bit-identical: the final eval is held to 1e-3
relative and the final params to ``PARAMS_ATOL``. Measured on this job
(port against JAX, every surviving worker's drained params): a largest
absolute difference of 5.96e-8, with and without the eviction. The
tolerance is 1e-5; a flush reintegrated against the pool at the pull
(divisor 2 in place of 3) gives 6.9e-2, while its final eval stays
within 1e-3 (5.7e-4). Within the port the drained params are
bit-identical across broker shard counts and through worker SIGKILLs
mid-run and mid-drain.
"""

from __future__ import annotations

import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.runtime import FaaSJobConfig as JFaaSJobConfig
from repro.runtime import build_workload, run_job as jrun_job

from repro_torch import convert
from repro_torch.checkpoint import store as ckpt
from repro_torch.runtime import protocol, supervisor
from repro_torch.runtime.broker import Broker
from repro_torch.runtime.supervisor import FaaSJobConfig, run_job

SLACK = 2
WCFG = {"n_users": 120, "n_movies": 150, "n_ratings": 6000, "rank": 4,
        "batch_size": 64}
JOB = dict(workload="pmf", n_workers=3, total_steps=8, invocation_steps=3,
           checkpoint_every=100, optimizer="nesterov", lr=0.08, isp_v=0.5,
           consistency="ssp", slack=SLACK, deadline_s=120.0)
PARAMS_ATOL = 1e-5
STEPS, P = JOB["total_steps"], JOB["n_workers"]

BROKER_JOB = {"workload": "pmf", "workload_cfg": {}, "n_workers": 2,
              "total_steps": 10, "n_batches": 5, "consistency": "ssp",
              "slack": SLACK}


# -- the broker's SSP release --------------------------------------------------


class _Cluster:
    """One in-thread port broker shard on an ephemeral port."""

    def __init__(self, job: dict, wal_dir=None):
        wal = os.path.join(wal_dir, "shard00.wal") if wal_dir else None
        self.broker = Broker(dict(job), wal_path=wal)
        self.addr = self.broker.start()

    def rpc(self, header, payload=b"", timeout=10.0):
        return protocol.request(self.addr, header, payload, timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        assert self.broker.stop(timeout=5.0) == []


def _x(v: float):
    return protocol.encode_tree({"x": torch.full((4,), float(v))})


def _publish(c, worker, step, meta, payload):
    c.rpc({"t": "publish", "worker": worker, "step": step, "meta": meta,
           "loss": 1.0, "sent_fraction": 1.0, "inv_err": 0.0}, payload)


def _decoded(resp, blob) -> list[tuple[int, np.ndarray]]:
    return [(d["worker"], np.asarray(protocol.decode_tree(
        d["meta"], part, {"x": torch.zeros(4)})["x"]))
        for d, part in protocol.unpack_parts(resp["parts"], blob)]


def test_ssp_pull_ready_immediately_below_bound():
    """While t - slack - 1 < 1 a pull owes nothing: it releases at once with
    no parts, with nothing published."""
    with _Cluster(BROKER_JOB) as c:
        for step in range(1, SLACK + 2):
            resp, blob = c.rpc({"t": "pull", "worker": 0, "step": step,
                                "timeout_s": 0.2})
            assert resp["ready"] is True
            assert resp["visible_step"] == step - SLACK - 1
            assert protocol.unpack_parts(resp["parts"], blob) == []


def test_ssp_release_respects_staleness_bound():
    """A pull at t waits until every worker's contiguous publish frontier
    reaches t - slack - 1; a publish below the frontier does not release
    it."""
    with _Cluster(BROKER_JOB) as c:
        for s in (1, 2, 3):
            _publish(c, 0, s, *_x(s))
        resp, _ = c.rpc({"t": "pull", "worker": 0, "step": SLACK + 3,
                         "timeout_s": 0.2})
        assert resp["ready"] is False
        done = {}

        def late():
            _publish(c, 1, 1, *_x(11))
            _publish(c, 1, 2, *_x(12))
            done["ok"] = True

        th = threading.Thread(target=late)
        th.start()
        resp, blob = c.rpc({"t": "pull", "worker": 0, "step": SLACK + 3,
                            "timeout_s": 5.0})
        th.join()
        assert done.get("ok") and resp["ready"] is True
        assert resp["visible_step"] == 2
        (w, x), = _decoded(resp, blob)
        assert w == 1
        np.testing.assert_array_equal(x, np.full(4, 12.0, np.float32))


def test_ssp_serves_exactly_the_frontier_step():
    with _Cluster(BROKER_JOB) as c:
        for s in (1, 2, 3):
            for w in (0, 1):
                _publish(c, w, s, *_x(10 * w + s))
        resp, blob = c.rpc({"t": "pull", "worker": 0, "step": SLACK + 3,
                            "timeout_s": 5.0})
        assert resp["ready"] is True and resp["visible_step"] == 2
        (w, x), = _decoded(resp, blob)
        assert w == 1
        np.testing.assert_array_equal(x, np.full(4, 12.0, np.float32))


def test_ssp_release_survives_shard_respawn(tmp_path):
    """WAL replay rebuilds the per-worker clocks: the respawned shard blocks
    exactly where the dead one did."""
    meta, payload = _x(1)
    with _Cluster(BROKER_JOB, wal_dir=str(tmp_path)) as c1:
        for s in (1, 2):
            _publish(c1, 0, s, meta, payload)
        _publish(c1, 1, 1, meta, payload)
    with _Cluster(BROKER_JOB, wal_dir=str(tmp_path)) as c2:
        assert c2.broker.core.clocks == {0: 2, 1: 1}
        resp, _ = c2.rpc({"t": "pull", "worker": 0, "step": SLACK + 2,
                          "timeout_s": 2.0})
        assert resp["ready"] is True and resp["visible_step"] == 1
        resp, _ = c2.rpc({"t": "pull", "worker": 0, "step": SLACK + 3,
                          "timeout_s": 0.2})
        assert resp["ready"] is False


# -- the live job ---------------------------------------------------------------


def _port_cfg(run_dir, params0, **kw) -> FaaSJobConfig:
    return FaaSJobConfig(run_dir=str(run_dir), device="cpu",
                         workload_cfg=dict(WCFG, params0=params0),
                         **dict(JOB, **kw))


def _jax_final_params(run_dir, worker: int) -> list[np.ndarray]:
    import jax
    import jax.numpy as jnp

    from repro import optim as joptim

    wl = build_workload("pmf", WCFG)
    like = {"params": wl.params0,
            "opt": joptim.make("nesterov", 0.08).init(wl.params0),
            "residual": jax.tree.map(jnp.zeros_like, wl.params0)}
    d = os.path.join(run_dir, "ckpt", f"w{worker:03d}")
    step = jstore.latest_step(d)
    assert step == STEPS + 1  # the post-drain sentinel checkpoint
    tree = jstore.restore(d, step, like)
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree["params"])]


def _digests(cfg) -> list[str]:
    return [supervisor.final_params_digest(cfg, w) for w in range(P)]


def _compare_with_jax(cfg, res, jdir, jres, survivors):
    rel_eval = abs(res["final_eval"] - jres["final_eval"]) / jres[
        "final_eval"]
    absd = 0.0
    for w in survivors:
        params, step = supervisor.final_params(cfg, w)
        assert step == STEPS + 1
        got = convert.to_leaves(params)
        want = _jax_final_params(jdir, w)
        absd = max(absd, max(float(np.max(np.abs(a - b)))
                             for a, b in zip(got, want)))
    print(f"final params: max |diff| {absd:.3e}; final eval port "
          f"{res['final_eval']:.6f} jax {jres['final_eval']:.6f} "
          f"(rel {rel_eval:.2e})")
    assert rel_eval <= 1e-3
    assert absd <= PARAMS_ATOL


@pytest.fixture(scope="module")
def params0(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ssp_p0")
    jp = build_workload("pmf", WCFG).params0
    return convert.write_params0(str(tmp / "params0.npz"), ["U", "M"],
                                 [np.asarray(jp.U), np.asarray(jp.M)])


def _concurrently(**fns) -> dict:
    """Run independent jobs side by side (each is its own process tree);
    re-raise the first failure."""
    out: dict = {}

    def one(name, fn):
        try:
            out[name] = fn()
        except BaseException as e:  # surfaced below
            out[name] = e

    threads = [threading.Thread(target=one, args=kv) for kv in fns.items()]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for v in out.values():
        if isinstance(v, BaseException):
            raise v
    return out


def _run_killing_mid_drain(cfg, victim: int) -> dict:
    """Run the job and SIGKILL ``victim`` once its step-``total_steps``
    checkpoint exists, while it waits in the drain."""
    sup = supervisor.Supervisor(cfg)
    out: dict = {}
    th = threading.Thread(target=lambda: out.update(res=sup.run()))
    th.start()
    victim_dir = os.path.join(cfg.run_dir, "ckpt", f"w{victim:03d}")
    killed = False
    while th.is_alive():
        proc = sup.slots[victim].proc
        if (not killed and proc is not None and proc.poll() is None
                and ckpt.latest_step(victim_dir) == STEPS):
            proc.send_signal(signal.SIGKILL)
            killed = True
        time.sleep(0.005)
    th.join()
    assert killed
    return out["res"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, params0):
    """Every live job of this file, side by side: the port and JAX on the
    base job and on a scripted eviction, the port under ISP, and the port
    at 2 broker shards with worker 1 SIGKILLed mid-run and worker 2
    SIGKILLed mid-drain (its step-8 checkpoint written, its drain held by
    worker 0's 2 s straggle at step 7)."""
    tmp = tmp_path_factory.mktemp("ssp")
    single = dict(invocation_steps=1_000_000)
    evict = dict(single, scripted_evict_steps=(0,))
    cfgs = {
        "port": _port_cfg(tmp / "port", params0),
        "isp": _port_cfg(tmp / "isp", params0, consistency="isp", **single),
        "evict": _port_cfg(tmp / "evict", params0, **evict),
        "killed": _port_cfg(
            tmp / "killed", params0, n_brokers=2, checkpoint_every=4,
            kill_worker_at_step=(1, 3), poll_interval_s=0.01,
            straggler={"worker": 0, "delay_s": 2.0, "every": 7}, **single),
    }
    jdirs = {"jax": str(tmp / "jax"), "jevict": str(tmp / "jevict")}
    res = _concurrently(
        port=lambda: run_job(cfgs["port"]),
        isp=lambda: run_job(cfgs["isp"]),
        evict=lambda: run_job(cfgs["evict"]),
        killed=lambda: _run_killing_mid_drain(cfgs["killed"], 2),
        jax=lambda: jrun_job(JFaaSJobConfig(
            run_dir=jdirs["jax"], workload_cfg=dict(WCFG), **JOB)),
        jevict=lambda: jrun_job(JFaaSJobConfig(
            run_dir=jdirs["jevict"], workload_cfg=dict(WCFG),
            **dict(JOB, **evict))),
    )
    return cfgs, res, jdirs


def test_live_ssp_tracks_the_jax_runtime(runs):
    cfgs, res, jdirs = runs
    port, jres = res["port"], res["jax"]
    assert port["steps"] == jres["steps"] == STEPS
    assert port["final_pool"] == jres["final_pool"] == P
    assert port["n_invocations"] == jres["n_invocations"] == 9
    assert port["dup_mismatches"] == jres["dup_mismatches"] == 0
    assert port["final_ckpt_step"] == STEPS + 1
    assert port["consistency"] == "ssp" and port["slack"] == SLACK
    _compare_with_jax(cfgs["port"], port, jdirs["jax"], jres, range(P))


def test_ssp_digest_is_identical_across_shards_and_kills(runs):
    """Every worker's drained params at 2 shards, through a SIGKILL
    mid-run and one mid-drain, keep the 1-shard run's digest."""
    cfgs, res, _ = runs
    killed = res["killed"]
    restored = {r["worker"]: r["restored_step"] for r in killed["respawns"]}
    assert sorted(restored) == [1, 2]
    assert restored[1] < STEPS and restored[2] == STEPS  # the drain's
    assert killed["steps"] == STEPS and killed["final_pool"] == P
    assert killed["dup_mismatches"] == 0
    assert _digests(cfgs["killed"]) == _digests(cfgs["port"])


def test_ssp_digest_differs_from_isp(runs):
    cfgs, res, _ = runs
    assert res["isp"]["final_ckpt_step"] == STEPS
    assert res["isp"]["slack"] is None
    assert supervisor.final_params_digest(cfgs["isp"]) != \
        supervisor.final_params_digest(cfgs["port"])


def test_ssp_eviction_reintegrates_at_the_delivered_steps_pool(runs):
    """A scripted eviction granted before any publish takes effect at step
    2; under slack 2 its flush reaches the survivors with the frontier 2,
    in the pull at step 5, and is divided by the pool before step 2 (3),
    not by the pool at step 5 (2). The port's survivors track JAX's
    within the stated tolerance."""
    cfgs, res, jdirs = runs
    for r in (res["evict"], res["jevict"]):
        assert [(e["worker"], e["evict_step"]) for e in r["scale_events"]] \
            == [(2, 2)]
        assert r["final_pool"] == 2 and r["dup_mismatches"] == 0
    _compare_with_jax(cfgs["evict"], res["evict"], jdirs["jevict"],
                      res["jevict"], (0, 1))
