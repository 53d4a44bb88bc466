"""The port's chaos plane on the CPU, held to the JAX package.

The pure functions equal JAX's on the same arguments: the seeded plan
expansion (``FaultPlan.randomized``), the ``--chaos`` parser, the merge of
an explicit spec with the legacy knobs (``compiled_chaos_plan``), the WAL
byte a ``wal_corrupt`` event flips, and ``launch.hostperf``'s environment
(the port sets no XLA flags: ``xla_flags`` is None). Then the job-level
pieces on real processes: the config's JSON round trip, the worker's
``ckpt_enospc`` seam, the refusal of an in-process ``supervisor_kill``,
one job under JAX's multi-fault plan (``tests/test_chaos.py``'s
``CHAOS_EVENTS``) with ``JOB`` and ``WCFG`` of ``test_torch_runtime.py``
at 3 workers (the plan's victims are workers 0-2), 12 steps in one
invocation (as JAX's test runs it) and a checkpoint every 4, its workers
under ``hostperf``, which must land on the fault-free job's bits, and two
``run_job_resilient`` jobs whose supervisor kills itself and is resumed:
one whose successor adopts the live pool by pid and then rolls it back
after a WAL corruption, and one whose workers finish while no supervisor
runs and are billed up to their goodbye.

One invocation, because a ``ckpt_enospc`` event fires once in every
process of its worker (``WorkerFaults``, as in JAX): with ``JOB``'s 3
steps an invocation, each of worker 0's invocations from step 4 on fails
its only save at or past step 6, restores step 4 again, and the job never
ends.
"""

from __future__ import annotations

import json
import os
import random
import sys
import types

import numpy as np
import pytest

from repro.launch import hostperf as jhostperf
from repro.runtime import FaaSJobConfig as JFaaSJobConfig
from repro.runtime import faults as jfaults
from repro.runtime import supervisor as jsupervisor

from repro_torch.checkpoint import store as ckpt
from repro_torch.core.autotuner import AutoTunerConfig
from repro_torch.launch import hostperf
from repro_torch.runtime import faults, supervisor, worker
from repro_torch.runtime.supervisor import FaaSJobConfig, run_job

from test_torch_runtime import JOB, WCFG

# tests/test_chaos.py's plan: every worker-side seam plus a real SIGKILL
CHAOS_EVENTS = [
    {"kind": "compute_delay", "step": 2, "worker": 1, "delay_s": 0.05,
     "every": 3},
    {"kind": "transport_stall", "step": 3, "worker": 0, "delay_s": 0.3},
    {"kind": "transport_delay", "step": 4, "worker": 2, "delay_s": 0.2},
    {"kind": "worker_kill", "step": 5, "worker": 1},
    {"kind": "transport_reset", "step": 6, "worker": 2},
    {"kind": "ckpt_enospc", "step": 6, "worker": 0},
]
CHAOS_JOB = dict(JOB, n_workers=3, total_steps=12,
                 invocation_steps=1_000_000, checkpoint_every=4,
                 deadline_s=240.0)


def _cfg(run_dir, **kw) -> FaaSJobConfig:
    return FaaSJobConfig(run_dir=str(run_dir), device="cpu",
                         workload_cfg=dict(WCFG), **dict(CHAOS_JOB, **kw))


def _digests(cfg) -> list[str]:
    return [supervisor.final_params_digest(cfg, w)
            for w in range(cfg.n_workers)]


# -- the pure functions against JAX -------------------------------------------


@pytest.mark.parametrize("seed,workers,shards,steps", [
    (1013, 3, 2, 24), (7, 4, 2, 12), (0, 2, 1, 30), (424242, 8, 4, 60)])
def test_randomized_plan_equals_jax(seed, workers, shards, steps):
    got = faults.FaultPlan.randomized(seed, workers, shards, steps)
    want = jfaults.FaultPlan.randomized(seed, workers, shards, steps)
    assert got.to_spec() == want.to_spec()
    assert faults.FaultPlan.from_spec(got.to_spec()) == got


@pytest.mark.parametrize("arg", [
    "7:auto", "31:auto",
    '5:[{"kind": "worker_kill", "step": 4, "worker": 1}, '
    '{"kind": "transport_delay", "step": 2, "worker": 0, "delay_s": 0.25, '
    '"op": "pull"}, {"kind": "supervisor_kill", "step": 6}]'])
def test_parse_chaos_arg_equals_jax(arg):
    kw = dict(n_workers=3, n_shards=2, total_steps=24)
    got = faults.parse_chaos_arg(arg, **kw)
    assert got.to_spec() == jfaults.parse_chaos_arg(arg, **kw).to_spec()
    for bad in ("x:auto", "7:", '7:[{"kind": "nope", "step": 1}]'):
        with pytest.raises(SystemExit, match="--chaos"):
            faults.parse_chaos_arg(bad, **kw)


@pytest.mark.parametrize("seed", [3, 11])
def test_compiled_plan_merges_spec_and_knobs_as_jax(seed, tmp_path):
    """An explicit spec merged with the legacy knobs under the spec's seed
    (the seed picks wal_corrupt's byte)."""
    kw = dict(
        chaos={"seed": seed, "events": [
            {"kind": "wal_corrupt", "step": 4, "shard": 1},
            {"kind": "ckpt_enospc", "step": 2, "worker": 0}]},
        kill_worker_at_step=(1, 3), kill_broker_at_step=(0, 5),
        straggler={"worker": 2, "delay_s": 0.1, "every": 2})
    got = _cfg(tmp_path, **kw)
    want = JFaaSJobConfig(run_dir=str(tmp_path), workload_cfg=dict(WCFG),
                          n_workers=3, **kw)
    assert got.compiled_chaos_plan().seed == seed
    assert got.compiled_chaos_plan().to_spec() == \
        want.compiled_chaos_plan().to_spec()
    assert got.job_dict(5)["chaos"] == want.job_dict(5)["chaos"]


@pytest.mark.parametrize("seed,idx,size", [
    (11, 4, 1), (11, 4, 5000), (0, 0, 3), (987654, 7, 123457)])
def test_wal_flip_byte_equals_jax(seed, idx, size, tmp_path):
    blob = bytes(random.Random(size).randrange(256) for _ in range(size))
    flipped = []
    for name, mod, plan_cls in (("port", supervisor, faults.FaultPlan),
                                ("jax", jsupervisor, jfaults.FaultPlan)):
        run_dir = tmp_path / name
        os.makedirs(run_dir / "broker")
        wal = run_dir / "broker" / "shard01.wal"
        wal.write_bytes(blob)
        sup = object.__new__(mod.Supervisor)
        sup.plan = plan_cls(seed=seed, events=())
        sup.cfg = types.SimpleNamespace(run_dir=str(run_dir))
        pos = sup._flip_wal_byte(1, idx)
        flipped.append((pos, wal.read_bytes()))
    assert flipped[0] == flipped[1]
    pos, after = flipped[0]
    assert size - max(size // 3, 1) <= pos < size
    assert after[pos] == blob[pos] ^ 0xFF


@pytest.mark.parametrize("threads,preload", [(1, True), (1, False),
                                             (2, True), (4, False)])
def test_hostperf_env_equals_jax(threads, preload, tmp_path, monkeypatch):
    lib = tmp_path / "libtcmalloc_minimal.so.4"
    lib.write_bytes(b"")
    monkeypatch.setenv("REPRO_TCMALLOC", str(lib) if preload else "")
    base = {"LD_PRELOAD": "/usr/lib/libother.so", "OMP_NUM_THREADS": "8",
            "CUBLAS_WORKSPACE_CONFIG": ":16:8"}
    got = hostperf.build_env(base, threads=threads)
    want = jhostperf.build_env(base, threads=threads)
    xla_only = {"XLA_FLAGS", "TF_CPP_MIN_LOG_LEVEL"}
    assert {k: v for k, v in want.items() if k not in xla_only} == got
    assert got["LD_PRELOAD"] == (f"/usr/lib/libother.so:{lib}" if preload
                                 else "/usr/lib/libother.so")
    assert got["CUBLAS_WORKSPACE_CONFIG"] == ":16:8"  # the caller's kept
    d, jd = hostperf.describe(got), jhostperf.describe(want)
    assert d["xla_flags"] is None and jd["xla_flags"]
    assert {k: v for k, v in d.items() if k != "xla_flags"} == \
        {k: v for k, v in jd.items() if k != "xla_flags"}
    assert hostperf.build_env({})["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"


# -- the job config, the checkpoint seam, the guard ---------------------------


def test_config_roundtrips_through_json_with_tuples(tmp_path):
    cfg = _cfg(tmp_path, chaos={"seed": 3, "events": CHAOS_EVENTS},
               rpc={"timeout_s": 5.0, "tries": 3}, autotune=True,
               tuner=AutoTunerConfig(sched_interval_s=0.5, delta_s=0.25),
               scripted_evict_steps=(4, 9), kill_worker_at_step=(1, 3),
               kill_broker_at_step=(0, 5), prewarm=True, hostperf=True)
    back = FaaSJobConfig.from_dict(json.loads(json.dumps(cfg.to_dict())))
    assert back == cfg
    assert isinstance(back.tuner, AutoTunerConfig)
    for k in ("scripted_evict_steps", "kill_worker_at_step",
              "kill_broker_at_step"):
        assert isinstance(getattr(back, k), tuple)


def test_ckpt_enospc_leaves_the_previous_generation(tmp_path, capsys):
    import torch

    plan = faults.FaultPlan(seed=0, events=(
        faults.FaultEvent("ckpt_enospc", 4, worker=0),))
    wf = faults.WorkerFaults(plan, 0)
    d = str(tmp_path / "ckpt")

    def state(v):
        return {"params": {"U": torch.full((3, 2), float(v))}}

    for step in (2, 4):
        wf.at_step(step)
        ok = worker.save_checkpoint(d, step, state(step), 0, wf)
        assert ok == (step == 2)
    assert "checkpoint save at step 4 failed" in capsys.readouterr().out
    assert ckpt.all_steps(d) == [2]  # no partial snapshot was installed
    step, tree = ckpt.restore_latest_valid(d, state(0))
    assert step == 2 and float(tree["params"]["U"][0, 0]) == 2.0
    fired = wf.drain()
    assert [(f["index"], f["kind"], f["step"]) for f in fired] == [
        (0, "ckpt_enospc", 4)]
    # one-shot: the next save of this invocation goes through
    wf.at_step(6)
    assert worker.save_checkpoint(d, 6, state(6), 0, wf)
    assert ckpt.all_steps(d) == [2, 6]


def test_broker_imports_no_tensor_library():
    """A shard process (and a killed one's respawn) starts without a torch
    import: its byte accounting is codec.tree_nbytes on the metas."""
    import subprocess

    from repro_torch.runtime import broker
    from repro_torch.wire import codec

    code = ("import sys; import repro_torch.runtime.broker; "
            "print(sorted(m for m in ('torch', 'numpy', 'jax') "
            "if m in sys.modules))")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=os.path.join(
            os.path.dirname(__file__), "..", "src")), timeout=60)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
    meta = [{"k": "U", "nbytes": 1234}, {"k": "M", "o": 8, "nbytes": 77}]
    assert broker._wire_bytes(meta) == codec.tree_nbytes(meta) == 1311


def test_broker_clock_is_the_contiguous_frontier():
    """After a WAL suffix is quarantined, a worker past the lost steps may
    publish a later one before the rollback reads the clocks: the clock
    must stay below the hole, so the rollback replays it."""
    from repro_torch.runtime.broker import BrokerCore

    core = BrokerCore({"n_workers": 2, "total_steps": 10, "n_batches": 5})
    meta = [{"k": "x", "shape": [1], "scheme": "dense", "nbytes": 4}]

    def publish(step):
        core.handle({"t": "publish", "worker": 0, "step": step,
                     "meta": meta, "loss": 1.0, "sent_fraction": 1.0,
                     "inv_err": 0.0}, bytes([step, 0, 0, 0]))

    for step in (1, 2, 4, 5):  # step 3's record lost
        publish(step)
    assert core.clocks[0] == 2
    publish(3)  # the rolled-back worker's replay fills the hole
    assert core.clocks[0] == 5


def test_supervisor_kill_refused_in_process(tmp_path):
    with pytest.raises(ValueError, match="supervisor_kill"):
        supervisor.Supervisor(_cfg(tmp_path, chaos={
            "seed": 1, "events": [{"kind": "supervisor_kill", "step": 3}]}))


def test_cli_takes_chaos_prewarm_and_hostperf(tmp_path, monkeypatch):
    """``--chaos`` compiles into the job's spec (a plan with a
    supervisor_kill goes to ``run_job_resilient``), ``--prewarm`` and
    ``--hostperf`` into their fields."""
    from repro_torch.launch import train as train_cli

    seen = {}

    def fake(name):
        def run(cfg):
            seen[name] = cfg
            return {}
        return run

    monkeypatch.setattr(supervisor, "run_job", fake("run_job"))
    monkeypatch.setattr(faults, "run_job_resilient", fake("resilient"))
    argv = ["train", "--runtime", "faas", "--device", "cpu", "--steps",
            "24", "--workers", "3", "--n-brokers", "2", "--run-dir",
            str(tmp_path / "r")]
    monkeypatch.setattr(sys, "argv", argv + ["--chaos", "7:auto"])
    train_cli.main()
    want = faults.FaultPlan.randomized(7, 3, 2, 24)
    assert seen["resilient"].chaos == want.to_spec()
    assert "run_job" not in seen
    monkeypatch.setattr(sys, "argv", argv + [
        "--prewarm", "--hostperf", "--chaos",
        '2:[{"kind": "worker_kill", "step": 3, "worker": 1}]'])
    train_cli.main()
    cfg = seen["run_job"]
    assert cfg.prewarm and cfg.hostperf
    assert cfg.compiled_chaos_plan().counts() == {"worker_kill": 1}


# -- end to end: JAX's multi-fault plan on real processes ---------------------


@pytest.fixture(scope="module")
def chaos_jobs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("chaos")
    clean = _cfg(tmp / "clean")
    chaos = _cfg(tmp / "chaos", chaos={"seed": 11, "events": CHAOS_EVENTS},
                 hostperf=True)
    return clean, run_job(clean), chaos, run_job(chaos)


def test_chaos_job_completes_every_step(chaos_jobs):
    _, clean_res, _, res = chaos_jobs
    assert res["steps"] == clean_res["steps"] == 12
    assert res["final_pool"] == 3
    assert res["dup_mismatches"] == 0
    assert res["invariant_max_err"] == 0.0
    assert res["chaos"] == {"seed": 11, "events": CHAOS_EVENTS}
    # the workers ran under launch/hostperf.py's env, the clean job not
    assert clean_res["hostperf"] is None
    assert res["hostperf"] == hostperf.describe(hostperf.build_env({}))
    assert res["hostperf"]["threads"]["MKL_NUM_THREADS"] == "1"
    assert [r["wire_bytes"] for r in res["history"]] == [
        r["wire_bytes"] for r in clean_res["history"]]


def test_chaos_job_records_every_event(chaos_jobs):
    """The supervisor's kill and the workers' faults, each at least once,
    none skipped and each with its recovery."""
    _, _, _, res = chaos_jobs
    fired = {e["index"] for e in res["chaos_events"]}
    assert fired == set(range(len(CHAOS_EVENTS)))
    for e in res["chaos_events"]:
        assert "skipped" not in e and e["recovery_s"] is not None, e
        assert e["kind"] == CHAOS_EVENTS[e["index"]]["kind"]
        assert e["worker"] == CHAOS_EVENTS[e["index"]]["worker"]


def test_chaos_worker_kill_respawns_from_a_checkpoint(chaos_jobs):
    _, _, _, res = chaos_jobs
    ev = res["respawns"][0]
    assert ev["worker"] == 1 and ev["exit_code"] == -9
    assert ev["restored_step"] in (4, 8)  # a periodic checkpoint


def test_chaos_job_lands_on_the_fault_free_bits(chaos_jobs):
    clean, _, chaos, _ = chaos_jobs
    assert _digests(chaos) == _digests(clean)


# worker 0 straggles at every step after the supervisor's death, and the
# barrier holds the pool with it: the 9 steps left (about 13 s) outlast
# the successor's start, so it finds every worker alive
RESILIENT_EVENTS = [
    {"kind": "compute_delay", "step": 4, "worker": 0, "delay_s": 1.5,
     "every": 1},
    {"kind": "supervisor_kill", "step": 3},
    # after the resume: the rollback SIGKILLs the adopted workers, waits
    # for them through /proc and respawns them
    {"kind": "wal_corrupt", "step": 6, "shard": 1},
]


def test_supervisor_kill_resumes_readopts_and_keeps_the_bits(chaos_jobs,
                                                             tmp_path):
    clean, _, _, _ = chaos_jobs
    cfg = _cfg(tmp_path / "job", checkpoint_every=2, n_brokers=2,
               chaos={"seed": 5, "events": RESILIENT_EVENTS})
    res = faults.run_job_resilient(cfg)
    assert res["supervisor_restarts"] >= 1
    assert res["supervisor_resumed"] >= 1
    assert res["steps"] == 12 and res["final_pool"] == 3
    assert res["dup_mismatches"] == 0
    kills = [e for e in res["chaos_events"]
             if e["kind"] == "supervisor_kill"]
    assert len(kills) == 1 and kills[0]["recovery_s"] is not None
    assert kills[0]["readopted"] == {"workers": 3, "brokers": 2,
                                     "successors_killed": 0}
    wal, = [e for e in res["chaos_events"] if e["kind"] == "wal_corrupt"]
    assert wal["recovery_s"] is not None
    assert sorted(r["worker"] for r in wal["rollback"]) == [0, 1, 2]
    # the adopted workers were no children of the successor: init reaped
    # them, so their respawns carry no exit code
    assert sorted(r["worker"] for r in res["respawns"]
                  if r["exit_code"] is None) == [0, 1, 2]
    assert not os.path.exists(os.path.join(cfg.run_dir,
                                           "supervisor.journal.json"))
    assert np.isfinite(res["final_eval"])
    assert _digests(cfg) == _digests(clean)


def test_headless_exit_is_billed_to_its_goodbye(tmp_path):
    """Workers that finish while no supervisor runs are billed up to their
    goodbye, not up to the successor's first look at them."""
    cfg = _cfg(tmp_path / "job", chaos={
        "seed": 3, "events": [{"kind": "supervisor_kill", "step": 11}]})
    res = faults.run_job_resilient(cfg)
    assert res["steps"] == 12 and res["final_pool"] == 3
    kill, = [e for e in res["chaos_events"]
             if e["kind"] == "supervisor_kill"]
    assert kill["readopted"]["workers"] == 0
    assert len(res["lifetimes_s"]) == 3
    # each worker said goodbye within a step of the kill, and the
    # successor took recovery_s to come up after it (billed to the
    # successor's first look, each lifetime would be about wall_s)
    assert max(res["lifetimes_s"]) < res["wall_s"] - kill["recovery_s"] + 1.0
    assert min(res["lifetimes_s"]) > 0.0
