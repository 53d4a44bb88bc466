"""The port's multi-job fleet (``repro_torch.runtime.scheduler``) on the CPU,
held to the JAX package's (``repro.runtime.scheduler``).

Tolerances:

* ``multi_job_rollup``: bit for bit against JAX's (both are float64
  Python arithmetic in the same order).
* admission: every config JAX's ``FleetScheduler`` refuses, the port's
  refuses too (``ValueError``), and both admit the legacy kill knobs.
* a packed job's final params: bit-identical (sha256 digest) to the same
  job run solo by the port, through 1 and 2 tcp shards, mixed ISP and SSP,
  and shm with a worker and a broker SIGKILL. A packed job's final
  held-out eval: within 1e-3 relative of the same fleet run by JAX's
  ``run_fleet`` from the same initial parameters (the frameworks sum the
  minibatch gradient in different orders, so an element near the ISP
  threshold can flip its mask).
* fair share under ``pool_budget``: at least two ``fair-share``
  evictions, the larger job first, every job at its last step.
* launch counts: each thread's count holds its own launches exactly.
"""

from __future__ import annotations

import os
import platform
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from repro.core import billing as jbilling
from repro.runtime import FleetConfig as JFleetConfig
from repro.runtime import FleetScheduler as JFleetScheduler
from repro.runtime import build_workload as jbuild_workload

from repro_torch import convert
from repro_torch.core import billing
from repro_torch.kernels import build
from repro_torch.runtime import (FaaSJobConfig, FleetConfig, FleetScheduler,
                                 build_workload, final_params_digest,
                                 run_fleet, run_job)
from repro_torch.runtime import supervisor
from repro_torch.wire import shm as wire_shm

sys.path.insert(0, os.path.dirname(__file__))
from runtime_harness import (  # noqa: E402
    SMALL_LR_WCFG,
    SMALL_PMF_WCFG,
    final_params as jfinal_params,
    run_small_fleet,
    small_lr_cfg as jsmall_lr_cfg,
    small_pmf_cfg as jsmall_pmf_cfg,
)

EVAL_RTOL = 1e-3
# the small jobs of the JAX package's fleet tests (runtime_harness)
PMF_JOB = dict(workload="pmf", n_workers=3, total_steps=8,
               checkpoint_every=100, optimizer="nesterov", lr=0.08,
               isp_v=0.5, deadline_s=180.0, device="cpu")
LR_JOB = dict(workload="lr", n_workers=2, total_steps=6,
              checkpoint_every=100, optimizer="nesterov", lr=0.05,
              isp_v=0.5, deadline_s=180.0, device="cpu")


@pytest.fixture(scope="module")
def params0(tmp_path_factory) -> dict:
    """The JAX package's initial parameters of both small jobs, as the
    files the port's workloads start from."""
    tmp = tmp_path_factory.mktemp("params0")
    jp = jbuild_workload("pmf", SMALL_PMF_WCFG).params0
    jl = jbuild_workload("lr", SMALL_LR_WCFG).params0
    return {
        "pmf": convert.write_params0(str(tmp / "pmf.npz"), ["U", "M"],
                                     [np.asarray(jp.U), np.asarray(jp.M)]),
        "lr": convert.write_params0(str(tmp / "lr.npz"), ["w", "b"],
                                    [np.asarray(jl.w), np.asarray(jl.b)]),
    }


def _cfg(run_dir, params0: dict, workload: str = "pmf",
         **kw) -> FaaSJobConfig:
    job, wcfg = ((PMF_JOB, SMALL_PMF_WCFG) if workload == "pmf"
                 else (LR_JOB, SMALL_LR_WCFG))
    return FaaSJobConfig(run_dir=str(run_dir),
                         workload_cfg=dict(wcfg, params0=params0[workload]),
                         **dict(job, **kw))


def _fleet(run_dir, params0: dict, jobs: dict, **fleet_kw) -> FleetConfig:
    """``jobs`` maps job id -> overrides (``workload="lr"`` for LR); each
    job's run_dir is pinned by the scheduler."""
    built = {}
    for jid, ov in jobs.items():
        ov = dict(ov)
        built[jid] = _cfg(run_dir, params0, ov.pop("workload", "pmf"), **ov)
    return FleetConfig(run_dir=str(run_dir), jobs=built, **fleet_kw)


@pytest.fixture(scope="module")
def solo_digests(tmp_path_factory, params0) -> dict:
    """The port's solo digests (one run a workload and consistency)."""
    tmp = tmp_path_factory.mktemp("solo")
    out = {}
    for key, wl, kw in (("pmf_isp", "pmf", {}), ("lr_isp", "lr", {}),
                        ("lr_ssp", "lr", {"consistency": "ssp",
                                          "slack": 2})):
        cfg = _cfg(tmp / key, params0, wl, **kw)
        run_job(cfg)
        out[key] = final_params_digest(cfg)
    return out


def _check_fleet(res: dict, params0: dict, solo: dict, expect: dict) -> None:
    assert res["dup_mismatches"] == 0
    for jid, key in expect.items():
        job = res["jobs"][jid]
        cfg = _cfg(job["run_dir"], params0, job["workload"])
        assert final_params_digest(cfg) == solo[key], (
            f"job {jid}: packed params differ from solo {key}")
        assert job["final_eval"] is not None and np.isfinite(
            job["final_eval"])
        # the CPU runs the kernels' plain versions: nothing launched
        assert all(c == {} for c in job["kernel_launches_by_worker"].values())
    # the rollup attributes the whole pooled bill
    per_job = res["rollup"]["per_job"]
    assert set(per_job) == set(res["jobs"])
    assert sum(v["total"] for v in per_job.values()) == pytest.approx(
        res["rollup"]["total"], rel=1e-12)
    assert res["rollup"]["total"] == res["bill"]["total"]


# -- the pooled bill ----------------------------------------------------------


@pytest.mark.parametrize("seed", (0, 1, 2, 3))
def test_multi_job_rollup_matches_jax_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    n_jobs = int(rng.integers(1, 5))
    lifetimes = [float(x) for x in rng.uniform(0.05, 40.0,
                                               int(rng.integers(1, 12)))]
    wall = float(rng.uniform(1.0, 60.0))
    n_redis = int(rng.integers(1, 4))
    busy = {f"j{i}": float(x) for i, x in enumerate(
        rng.uniform(0.0, 30.0, n_jobs))}
    if seed == 3:  # an all-idle fleet splits evenly
        busy = {j: 0.0 for j in busy}
    got = billing.multi_job_rollup(lifetimes, wall, n_redis, busy)
    want = jbilling.multi_job_rollup(lifetimes, wall, n_redis, busy)
    assert got["per_job"] == want["per_job"]  # float equality: bit for bit
    assert got["bill"].total == want["bill"].total
    assert got["bill"].worker_seconds == want["bill"].worker_seconds


# -- admission ----------------------------------------------------------------


_REFUSED = {
    "n_brokers": {"a": {}, "b": {"n_brokers": 2}},
    "transport": {"a": {}, "b": {"transport": "shm"}},
    "job id": {"a/b": {}},
    "prewarm": {"a": {"prewarm": True}},
    "chaos": {"a": {"chaos": {"seed": 0, "events": [
        {"kind": "worker_kill", "step": 2, "worker": 1}]}}},
    "scripted_retunes": {"a": {"scripted_retunes": (
        (3, {"n_brokers": 2}),)}},
    "consistency": {"a": {"consistency": "bsp"}},
    "slack": {"a": {"consistency": "ssp", "slack": -1}},
    "no jobs": {},
}


def _both_fleets(tmp_path, params0, jobs: dict):
    """The same fleet for the port and for JAX's scheduler."""
    jax_jobs = {}
    for jid, ov in jobs.items():
        ov = dict(ov)
        maker = jsmall_lr_cfg if ov.pop("workload", "pmf") == "lr" \
            else jsmall_pmf_cfg
        jax_jobs[jid] = maker(str(tmp_path / "jax" / jid), **ov)
    return (_fleet(tmp_path / "port", params0, jobs),
            JFleetConfig(run_dir=str(tmp_path / "jax"), jobs=jax_jobs))


@pytest.mark.parametrize("case", sorted(_REFUSED))
def test_admission_refuses_what_jax_refuses(tmp_path, params0, case):
    port, jax = _both_fleets(tmp_path, params0, _REFUSED[case])
    with pytest.raises(ValueError):
        JFleetScheduler(jax)
    with pytest.raises(ValueError):
        FleetScheduler(port)
    assert not os.path.exists(tmp_path / "port" / "logs")  # nothing spawned


def test_admission_accepts_the_kill_knobs_and_pins_run_dirs(tmp_path,
                                                            params0):
    jobs = {"a": {"kill_worker_at_step": (1, 2)},
            "b": {"workload": "lr", "kill_broker_at_step": (0, 2),
                  "straggler": {"worker": 0, "delay_s": 0.01}}}
    port, jax = _both_fleets(tmp_path, params0, jobs)
    JFleetScheduler(jax)
    sched = FleetScheduler(port)
    assert sched.jobs["a"].cfg.run_dir == str(tmp_path / "port/jobs/a")
    assert len(sched.slots) == 3 and sched.n_brokers == 1


# -- live two-job fleets ------------------------------------------------------


def test_fleet_two_jobs_tcp_single_shard_tracks_jax(tmp_path, params0,
                                                    solo_digests):
    res = run_fleet(_fleet(tmp_path / "fleet", params0,
                           {"a": {}, "b": {"workload": "lr"}}))
    _check_fleet(res, params0, solo_digests, {"a": "pmf_isp",
                                              "b": "lr_isp"})
    # bin-packing: slots 0 and 1 host both jobs in one process each
    assert res["n_invocations"] == 3
    assert {j: r["steps"] for j, r in res["jobs"].items()} == {"a": 8,
                                                                "b": 6}
    jres = run_small_fleet(tmp_path / "jax", {"a": {}, "b": {"workload":
                                                             "lr"}})
    for jid, maker, wl_name, wcfg in (
            ("a", jsmall_pmf_cfg, "pmf", SMALL_PMF_WCFG),
            ("b", jsmall_lr_cfg, "lr", SMALL_LR_WCFG)):
        jcfg = maker(jres["jobs"][jid]["run_dir"])
        survivor = min(range(jcfg.n_workers))
        _, jparams = jfinal_params(jcfg, survivor)
        jeval = float(jbuild_workload(wl_name, wcfg).eval_fn(jparams))
        got = res["jobs"][jid]["final_eval"]
        rel = abs(got - jeval) / abs(jeval)
        print(f"job {jid}: final eval port {got:.6f} jax {jeval:.6f} "
              f"(rel {rel:.2e}); wire bytes port "
              f"{res['jobs'][jid]['wire_bytes_total']} jax "
              f"{jres['jobs'][jid]['wire_bytes_total']}")
        assert rel <= EVAL_RTOL
        assert res["jobs"][jid]["steps"] == jres["jobs"][jid]["steps"]


def test_fleet_two_shards_mixed_isp_and_ssp(tmp_path, params0, solo_digests):
    res = run_fleet(_fleet(tmp_path / "fleet", params0, {
        "a": {"n_brokers": 2},
        "b": {"workload": "lr", "n_brokers": 2, "consistency": "ssp",
              "slack": 2}}))
    _check_fleet(res, params0, solo_digests, {"a": "pmf_isp",
                                              "b": "lr_ssp"})
    assert res["jobs"]["b"]["final_ckpt_step"] == LR_JOB["total_steps"] + 1


@pytest.mark.skipif(
    not sys.platform.startswith("linux")
    or platform.machine() not in wire_shm.SHM_MACHINES,
    reason="the shm transport targets same-host Linux TSO machines")
def test_fleet_shm_faults_bit_identical(tmp_path, params0, solo_digests):
    """shm, 2 shards, mixed ISP and SSP, invocation-bounded, a worker
    SIGKILL (the whole packed process: both jobs replay) and a shard
    SIGKILL (its WAL replays every job's history): still bit-identical."""
    cell = {"transport": "shm", "n_brokers": 2}
    res = run_fleet(_fleet(tmp_path / "fleet", params0, {
        # step 2 is mid-invocation (the boundary is at 5): the SIGKILL
        # lands on a running process, not on a clean boundary exit
        "a": dict(cell, invocation_steps=5, checkpoint_every=2,
                  kill_worker_at_step=(1, 2)),
        "b": dict(cell, workload="lr", consistency="ssp", slack=2,
                  invocation_steps=4, checkpoint_every=2,
                  kill_broker_at_step=(1, 2))}))
    _check_fleet(res, params0, solo_digests, {"a": "pmf_isp",
                                              "b": "lr_ssp"})
    assert res["n_respawns"] >= 1
    assert len(res["broker_respawns"]) >= 1
    left = [n for n in os.listdir("/dev/shm")
            if n.startswith(res["shm_token"])]
    assert left == []


def test_worker_kill_lands_on_a_running_invocation(tmp_path, params0):
    """The worker kill knob of job ``a`` (worker 1, step 2) fires only on a
    running invocation of ``a``: a slot whose threads already said
    ``bye:invocation-end`` (job ``b``'s boundary stops its sibling too) is
    left to exit cleanly, and the kill lands on the next invocation, which
    the reaper records as a respawn of ``a`` on worker 1."""
    sched = FleetScheduler(_fleet(tmp_path / "fleet", params0, {
        "a": dict(invocation_steps=5, checkpoint_every=2,
                  kill_worker_at_step=(1, 2)),
        "b": dict(workload="lr", invocation_steps=4, checkpoint_every=2)}))
    sched._spawn = lambda slot: None  # the test plays the invocations
    slot, a, b = sched.slots[1], sched.jobs["a"], sched.jobs["b"]

    def invocation(status: str) -> None:
        slot.proc = subprocess.Popen(
            [sys.executable, "-c", "import time; time.sleep(60)"])
        slot.spawned_at = time.monotonic()
        a.statuses = {"1": status}
        b.statuses = {"1": status}

    def end() -> None:
        try:
            slot.proc.wait(timeout=2)  # a SIGKILL ends it at once
        except subprocess.TimeoutExpired:
            # not killed: the invocation ends at its boundary
            a.statuses = b.statuses = {"1": "bye:invocation-end"}
            slot.proc.terminate()
            slot.proc.wait(timeout=30)
        sched._reap(slot)

    a.frontier = 2
    invocation("bye:invocation-end")  # winding down after b's boundary
    sched._fire_kill_knobs()
    end()
    assert sched.respawns == []
    invocation("running")
    sched._fire_kill_knobs()
    end()
    mine = [r for r in sched.respawns if r["job"] == "a"]
    assert len(mine) == 1
    assert mine[0]["worker"] == 1
    assert mine[0]["exit_code"] == -signal.SIGKILL
    assert mine[0]["restored_step"] <= 2
    assert a.killed_once


def test_fleet_fair_share_pool_budget(tmp_path, params0):
    """3 + 2 workers against a budget of 3: two fair-share evictions, the
    larger job's first; both jobs reach their last step."""
    res = run_fleet(_fleet(tmp_path / "fleet", params0,
                           {"a": {}, "b": {"workload": "lr"}},
                           pool_budget=3))
    events = [e for j in res["jobs"].values() for e in j["scale_events"]]
    fair = [e for e in events if e["reason"] == "fair-share"]
    assert len(fair) >= 2
    assert fair[0] in res["jobs"]["a"]["scale_events"]
    for jid, job in res["jobs"].items():
        assert job["final_pool"] >= 1, f"job {jid} lost every worker"
        assert job["steps"] == {"a": 8, "b": 6}[jid]
    assert res["dup_mismatches"] == 0


# -- per-thread launch counts -------------------------------------------------


def test_each_thread_counts_only_its_own_launches():
    """Two job threads of one process launch at once: each thread's count
    holds exactly its own launches, a reset in one thread leaves the
    other's alone, and the process count is their sum."""
    build.reset_launches()
    start, counted = threading.Barrier(2), threading.Barrier(2)
    seen: dict = {}

    def job(name: str, kernels: dict, reset_after: bool) -> None:
        start.wait()
        for _ in range(max(kernels.values())):
            for k, n in kernels.items():
                if n > 0:
                    build.count(k)
            kernels = {k: n - 1 for k, n in kernels.items()}
        counted.wait()
        seen[name] = dict(build.thread_launches())
        counted.wait()
        if reset_after:
            build.reset_launches()
        counted.wait()
        seen[name + " after"] = dict(build.thread_launches())

    pmf = {"significance_filter": 20, "wire_pack": 20,
           "wire_unpack_add": 60}
    lr = {"adam_sig_update": 20, "wire_pack": 20, "wire_unpack_add": 60}
    threads = [threading.Thread(target=job, args=("pmf", pmf, False)),
               threading.Thread(target=job, args=("lr", lr, True))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    assert seen["pmf"] == pmf and seen["lr"] == lr
    assert seen["lr after"] == {} and seen["pmf after"] == pmf
    assert dict(build.LAUNCHES) == {}  # the reset cleared the process count
    assert build.thread_launches() == {}  # this thread launched nothing
    build.reset_launches()


def test_launch_counts_lose_no_update_under_thread_switches():
    """More counting threads than cores, switching every microsecond: the
    process count is the exact sum of the threads' own (a lost
    read-modify-write would make it smaller)."""
    build.reset_launches()
    n_threads, n = 2 * (os.cpu_count() or 2) + 2, 5000
    own: dict = {}

    def job(i: int) -> None:
        for _ in range(n):
            build.count("wire_pack")
        own[i] = build.thread_launches()["wire_pack"]

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=job, args=(i,))
                   for i in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert own == {i: n for i in range(n_threads)}
    assert build.LAUNCHES["wire_pack"] == n_threads * n
    build.reset_launches()


def test_final_params_restore_under_a_fleet_run_dir(tmp_path, params0):
    """A packed job's checkpoints read back through the solo helpers."""
    res = run_fleet(_fleet(tmp_path / "fleet", params0,
                           {"a": {"total_steps": 3, "n_workers": 2}}))
    cfg = _cfg(res["jobs"]["a"]["run_dir"], params0, "pmf")
    params, step = supervisor.final_params(cfg)
    assert step == 3
    wl = build_workload("pmf", cfg.workload_cfg, device="cpu")
    assert wl.eval_fn(params) == pytest.approx(res["jobs"]["a"]["final_eval"],
                                               rel=0, abs=0)
