"""Pre-warmed respawn in the port's FaaS runtime, on the CPU.

``JOB`` and ``WCFG`` of ``test_torch_runtime.py`` (2 workers, 6 steps, 3
an invocation): each slot's next invocation is spawned gated, warms up,
and holds until the supervisor opens its gate at the boundary. The job
must land on the cold job's bits with the same wire bytes, the overlaps
measured. A held successor also serves as the respawn after a crash, and
a supervisor resumed from its journal kills the successors its
predecessor held (they can never be opened) and bills their lifetimes.
A straggler's compute delay in the last two tests keeps every step
longer than the supervisor's poll, so the faults land mid-invocation.
"""

from __future__ import annotations

import os

import pytest

from repro_torch.runtime import faults, supervisor
from repro_torch.runtime.supervisor import FaaSJobConfig, run_job

from test_torch_runtime import JOB, WCFG

SLOW = {"worker": 0, "delay_s": 0.3, "every": 1}


def _cfg(run_dir, **kw) -> FaaSJobConfig:
    return FaaSJobConfig(run_dir=str(run_dir), device="cpu",
                         workload_cfg=dict(WCFG), **dict(JOB, **kw))


@pytest.fixture(scope="module")
def cold(tmp_path_factory):
    cfg = _cfg(tmp_path_factory.mktemp("cold") / "job")
    return cfg, run_job(cfg), supervisor.final_params_digest(cfg)


def test_prewarm_is_bit_identical_with_measured_overlap(cold, tmp_path):
    cfg0, res0, dig0 = cold
    cfg = _cfg(tmp_path / "warm", prewarm=True)
    res = run_job(cfg)
    assert supervisor.final_params_digest(cfg) == dig0
    assert [r["wire_bytes"] for r in res["history"]] == [
        r["wire_bytes"] for r in res0["history"]]
    assert res["dup_mismatches"] == 0 and res["n_respawns"] == 0
    overlaps = res["cold_start_overlaps"]
    # one promotion a slot: the final invocation ends 'done' and has no
    # successor
    assert sorted(o["worker"] for o in overlaps) == [0, 1]
    assert all(o["overlap_s"] >= 0.0 and o["invocation"] == 1
               for o in overlaps)
    assert res["n_invocations"] == res0["n_invocations"] == 4
    logs = os.listdir(os.path.join(cfg.run_dir, "logs"))
    assert "w000.inv001.pre.log" in logs and "w000.inv001.log" not in logs


def test_held_successor_serves_a_crash_respawn(cold, tmp_path):
    _, _, dig0 = cold
    cfg = _cfg(tmp_path / "crash", prewarm=True, straggler=SLOW,
               kill_worker_at_step=(1, 1), poll_interval_s=0.02)
    res = run_job(cfg)
    assert supervisor.final_params_digest(cfg) == dig0
    assert res["dup_mismatches"] == 0
    assert [(r["worker"], r["exit_code"]) for r in res["respawns"]] == [
        (1, -9)]
    # worker 1's first invocation ended in the crash, and the successor
    # held for its boundary took over: no cold process was spawned
    assert {"worker": 1, "invocation": 1} in [
        {k: o[k] for k in ("worker", "invocation")}
        for o in res["cold_start_overlaps"]]
    logs = os.listdir(os.path.join(cfg.run_dir, "logs"))
    assert "w001.inv001.pre.log" in logs and "w001.inv001.log" not in logs
    kill, = [e for e in res["chaos_events"] if e["kind"] == "worker_kill"]
    assert kill["recovery_s"] is not None


def test_resumed_supervisor_kills_and_bills_held_successors(cold, tmp_path):
    _, res0, dig0 = cold
    cfg = _cfg(tmp_path / "resume", prewarm=True, straggler=SLOW,
               chaos={"seed": 2, "events": [
                   {"kind": "supervisor_kill", "step": 1}]})
    res = faults.run_job_resilient(cfg)
    assert res["supervisor_resumed"] == 1
    assert supervisor.final_params_digest(cfg) == dig0
    assert res["dup_mismatches"] == 0
    kill, = [e for e in res["chaos_events"]
             if e["kind"] == "supervisor_kill"]
    assert kill["readopted"]["brokers"] == 1
    assert kill["readopted"]["successors_killed"] == 2
    # billed: both first invocations, both killed successors, and both
    # second invocations
    assert res["n_invocations"] == res0["n_invocations"] + 2
    assert all(t > 0.0 for t in res["lifetimes_s"])
