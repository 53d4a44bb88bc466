"""Fleet scheduler: N concurrent training jobs on ONE serverless pool (port
of ``repro.runtime.scheduler``).

A single job pays for every barrier stall: an ISP worker blocked on its
slowest peer is a live, billed function doing nothing. The fleet
(DESIGN.md §14) admits N jobs onto one shared broker and worker pool, so
one job's stall is filled by another job's compute inside the same 100 ms
billing quantum. Every layer keeps its single-job semantics per job:

* **brokers**: each shard process hosts one ``BrokerCore`` a job
  (``broker.Broker`` with a ``{"jobs": ...}`` config), routed by the
  ``job`` header; the cores share the port, the WAL (records are stamped
  with their job) and the shm segments. A shard SIGKILL replays every
  job's history at once.
* **keys**: every leaf key is prefixed ``j<id>/`` (``sharding.
  job_namespace``). The prefix is uniform within a job, so its partition,
  byte accounting and summation order are those of the same job run solo,
  and its final params are bit-identical to the solo run's.
* **workers**: one invocation process a slot runs one training thread a
  hosted job (``worker.run_worker_fleet``): bin-packing. A process-wide
  lock serialises the jobs' compute; the first thread at its invocation
  budget ends the invocation for all of them, and the scheduler respawns
  ONE process. On the card each job thread has its own CUDA stream and its
  own launch count.
* **scale-in**: one independent, unmodified ``ScaleInAutoTuner`` a job, fed
  that job's telemetry. ``pool_budget`` caps the fleet's active (worker,
  job) pairs: beyond it the job holding the most active workers gives one
  up (reason ``fair-share``).
* **faults**: the legacy knobs ``kill_worker_at_step`` (SIGKILLs the slot's
  process: every job on it replays) and ``kill_broker_at_step`` are fired
  here; an explicit ``chaos`` plan, ``prewarm`` and ``scripted_retunes``
  are refused (their blast radius crosses jobs).
* **billing**: the pool pays ONE bill (quantum-rounded invocation
  lifetimes and the shared VMs billed once on the fleet's wall clock);
  ``core.billing.multi_job_rollup`` attributes it to the jobs by their
  busy seconds.

``python -m repro_torch.launch.train --runtime faas --jobs jobs.json`` is
the CLI entry point.
"""

from __future__ import annotations

import dataclasses
import json
import os
import secrets
import signal
import subprocess
import sys
import time
from typing import Any, Optional

from repro_torch.core.autotuner import (
    AutoTunerConfig,
    ScaleInAutoTuner,
    TopologyTuner,
    TopologyTunerConfig,
)
from repro_torch.core.billing import CommModel, faas_cost, multi_job_rollup
from repro_torch.runtime import protocol
from repro_torch.runtime import workload as workload_lib
from repro_torch.runtime.sharding import job_namespace
from repro_torch.runtime.supervisor import (FaaSJobConfig, base_env,
                                            final_params, worker_env)


@dataclasses.dataclass
class FleetConfig:
    """N admitted jobs sharing one broker and worker pool.

    The jobs must agree on the pool's topology (``n_brokers``,
    ``transport``): they share its processes. Everything else (workload,
    device, wire scheme, consistency, slack, step budgets, tuners, the kill
    knobs) is per job. Each job's ``run_dir`` is pinned to
    ``<run_dir>/jobs/<job_id>``.
    """

    run_dir: str
    jobs: dict[str, FaaSJobConfig] = dataclasses.field(default_factory=dict)
    # fair-share arbitration: the most active (worker, job) pairs at once
    # across the fleet; None leaves each job its own pool
    pool_budget: Optional[int] = None
    poll_interval_s: float = 0.05
    deadline_s: float = 600.0


@dataclasses.dataclass
class _FleetSlot:
    """One invocation slot (one billable process hosting >= 1 job)."""

    worker: int
    proc: Optional[subprocess.Popen] = None
    spawned_at: float = 0.0
    invocations: int = 0
    # the job whose kill_worker_at_step knob SIGKILLed the live invocation
    kill_for: Optional[str] = None
    # the live invocation's segment names, every (job, shard)
    shm_segs: list = dataclasses.field(default_factory=list)

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None


@dataclasses.dataclass
class _BrokerShard:
    shard: int
    proc: Optional[subprocess.Popen] = None
    addr: Optional[tuple[str, int]] = None
    spawns: int = 0

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None


@dataclasses.dataclass
class _JobState:
    """A job's control-plane state (the solo supervisor's fields, keyed)."""

    cfg: FaaSJobConfig
    wl: Any
    history: list = dataclasses.field(default_factory=list)
    poll_since: int = 1
    frontier: int = 0
    evictions: dict = dataclasses.field(default_factory=dict)
    statuses: dict = dataclasses.field(default_factory=dict)
    bye_launches: dict = dataclasses.field(default_factory=dict)
    scale_events: list = dataclasses.field(default_factory=list)
    scripted_fired: int = 0
    killed_once: bool = False
    broker_killed_once: bool = False
    tuner: Optional[ScaleInAutoTuner] = None
    # observe-only topology tuner: the broker pool is shared, so no job
    # may re-shard it live; the result carries a model-ranked advice
    topo_tuner: Optional[TopologyTuner] = None
    # worker -> 'done' | 'evicted': this job's terminal workers
    terminal: dict = dataclasses.field(default_factory=dict)

    def live_workers(self) -> list[int]:
        return [w for w in range(self.cfg.n_workers)
                if w not in self.terminal]

    def active_workers(self) -> list[int]:
        """Live and not yet scheduled to leave."""
        return [w for w in self.live_workers() if w not in self.evictions]

    @property
    def complete(self) -> bool:
        return not self.live_workers()


class FleetScheduler:
    """Admission, packing and fair-share control plane over one pool."""

    def __init__(self, fleet: FleetConfig):
        if not fleet.jobs:
            raise ValueError("fleet needs at least one job")
        self.fleet = fleet
        self.job_ids = sorted(fleet.jobs)
        for jid in self.job_ids:
            job_namespace(jid)  # validates the id's characters
        cfgs = [fleet.jobs[j] for j in self.job_ids]
        if len({c.n_brokers for c in cfgs}) != 1:
            raise ValueError("fleet jobs must agree on n_brokers")
        if len({c.transport for c in cfgs}) != 1:
            raise ValueError("fleet jobs must agree on transport")
        for jid, c in zip(self.job_ids, cfgs):
            if c.transport not in ("tcp", "shm"):
                raise ValueError(f"job {jid}: bad transport {c.transport!r}")
            if c.consistency not in ("isp", "ssp"):
                raise ValueError(
                    f"job {jid}: bad consistency {c.consistency!r}")
            if c.consistency == "ssp" and c.slack < 0:
                raise ValueError(f"job {jid}: slack must be >= 0")
            if c.prewarm:
                # a fleet slot already overlaps the jobs' starts
                raise ValueError(
                    f"job {jid}: prewarm is not supported under the fleet "
                    "scheduler (use the solo supervisor)")
            if c.scripted_retunes:
                # the shared pool: one job's re-shard would fence every
                # other job's workers mid-step
                raise ValueError(
                    f"job {jid}: scripted_retunes is not supported under "
                    "the fleet scheduler (use the solo supervisor)")
            if c.chaos is not None:
                # a plan SIGKILLs shared slots and shards; the legacy
                # kill_*_at_step knobs stay the fleet's fault hooks
                raise ValueError(
                    f"job {jid}: chaos plans are not supported under the "
                    "fleet scheduler (use the solo supervisor)")
        self.n_brokers = cfgs[0].n_brokers
        self.transport = cfgs[0].transport
        # admission: pin each job's run_dir inside the fleet's
        self.jobs: dict[str, _JobState] = {}
        for jid in self.job_ids:
            cfg = dataclasses.replace(
                fleet.jobs[jid],
                run_dir=os.path.join(fleet.run_dir, "jobs", jid))
            st = _JobState(cfg=cfg, wl=workload_lib.build(
                cfg.workload, cfg.workload_cfg, device=cfg.device))
            if cfg.autotune:
                st.tuner = ScaleInAutoTuner(cfg.tuner or AutoTunerConfig(),
                                            cfg.n_workers)
            if cfg.topology_tune:
                # observe-only: one cell, the fleet's shared topology
                st.topo_tuner = TopologyTuner(
                    [{"n_brokers": self.n_brokers,
                      "transport": self.transport,
                      "wire_scheme": cfg.wire_scheme,
                      "shard_split_bytes": cfg.shard_split_bytes}],
                    TopologyTunerConfig(), comm=CommModel(),
                    n_workers=cfg.n_workers)
            self.jobs[jid] = st
        self.slots = [_FleetSlot(worker=w)
                      for w in range(max(c.n_workers for c in cfgs))]
        self.shards = [_BrokerShard(shard=s) for s in range(self.n_brokers)]
        self._conns: list[Optional[protocol.Connection]] = (
            [None] * self.n_brokers)
        self.lifetimes: list[float] = []
        self.respawns: list[dict] = []
        self.broker_respawns: list[dict] = []
        self._stopping = False
        self._shm_token = f"fl{os.getpid():x}{secrets.token_hex(2)}"
        self._shm_segments: dict[str, Any] = {}  # name -> wire.shm.Segment

    # -- job placement --------------------------------------------------------

    def _hosted_jobs(self, slot: _FleetSlot) -> list[str]:
        """The jobs this slot still runs: admitted there, not terminal."""
        return [jid for jid in self.job_ids
                if slot.worker < self.jobs[jid].cfg.n_workers
                and slot.worker not in self.jobs[jid].terminal]

    # -- brokers (the solo supervisor's recipe, the fleet's config) -----------

    def _broker_dir(self) -> str:
        return os.path.join(self.fleet.run_dir, "broker")

    def _spawn_broker(self, bs: _BrokerShard) -> None:
        bdir = self._broker_dir()
        logdir = os.path.join(self.fleet.run_dir, "logs")
        os.makedirs(bdir, exist_ok=True)
        os.makedirs(logdir, exist_ok=True)
        port_file = os.path.join(bdir, f"shard{bs.shard:02d}.port")
        if os.path.exists(port_file):
            os.unlink(port_file)
        wal_path = os.path.join(bdir, f"shard{bs.shard:02d}.wal")
        if bs.spawns == 0 and os.path.exists(wal_path):
            os.unlink(wal_path)  # a fresh fleet never replays an old one
        log_path = os.path.join(
            logdir, f"broker{bs.shard:02d}.spawn{bs.spawns:02d}.log")
        with open(log_path, "wb") as log:
            bs.proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.runtime.broker",
                 "--config", os.path.join(bdir, "fleet.json"),
                 "--shard-id", str(bs.shard),
                 "--n-shards", str(self.n_brokers),
                 "--port", str(bs.addr[1] if bs.addr else 0),
                 "--wal", wal_path,
                 "--port-file", port_file],
                stdout=log, stderr=subprocess.STDOUT, env=base_env())
        bs.spawns += 1
        deadline = time.monotonic() + max(
            self.jobs[j].cfg.broker_spawn_timeout_s for j in self.job_ids)
        while not os.path.exists(port_file):
            if bs.proc.poll() is not None:
                raise RuntimeError(
                    f"fleet broker shard {bs.shard} exited during spawn "
                    f"(code {bs.proc.returncode}); logs in {logdir}")
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"fleet broker shard {bs.shard} did not listen in time")
            time.sleep(0.01)
        with open(port_file) as f:
            host, port = f.read().strip().rsplit(":", 1)
        bs.addr = (host, int(port))

    def _start_brokers(self) -> None:
        os.makedirs(self._broker_dir(), exist_ok=True)
        doc = {"jobs": {jid: self.jobs[jid].cfg.job_dict(
            self.jobs[jid].wl.n_batches) for jid in self.job_ids}}
        with open(os.path.join(self._broker_dir(), "fleet.json"), "w") as f:
            json.dump(doc, f, indent=1)
        for bs in self.shards:
            self._spawn_broker(bs)

    def _reap_brokers(self) -> None:
        """Respawn any shard that died unasked (its WAL restores every
        job's core)."""
        if self._stopping:
            return
        for bs in self.shards:
            if bs.proc is not None and bs.proc.poll() is not None:
                self.broker_respawns.append({
                    "shard": bs.shard, "exit_code": bs.proc.returncode,
                    "at_frontier": {j: self.jobs[j].frontier
                                    for j in self.job_ids}})
                if self._conns[bs.shard] is not None:
                    self._conns[bs.shard].close()
                    self._conns[bs.shard] = None
                self._spawn_broker(bs)
                if self.transport == "shm":
                    self._reserve_shard_shm(bs)

    # -- shm segments: one family a (slot, job), one segment a shard ----------

    def _teardown_slot_shm(self, slot: _FleetSlot) -> None:
        from repro_torch.wire import shm

        for name in slot.shm_segs:
            seg = self._shm_segments.pop(name, None)
            if seg is not None:
                seg.unlink()
            else:  # pragma: no cover - belt and braces
                shm.Segment.unlink_by_name(name)
        slot.shm_segs = []

    def _setup_slot_shm(self, slot: _FleetSlot, jids: list[str]) -> str:
        """Fresh segments for the slot's next invocation, each served by
        its shard; the thread of job ``jid`` attaches
        ``<base>g<jid>s<shard>`` (``worker.run_worker_fleet``). The ring is
        the largest of the hosted jobs' ``shm_ring_bytes``."""
        from repro_torch.wire import shm

        self._teardown_slot_shm(slot)
        base = f"{self._shm_token}w{slot.worker}i{slot.invocations}"
        ring = max(self.jobs[j].cfg.shm_ring_bytes for j in jids)
        names = [f"{base}g{jid}s{s}"
                 for jid in jids for s in range(self.n_brokers)]
        for name in names:
            self._shm_segments[name] = shm.Segment.create(
                name, ring_bytes=ring)
        slot.shm_segs = names
        for jid in jids:
            for s in range(self.n_brokers):
                resp, _ = self._rpc(
                    {"t": "shm_serve", "seg": f"{base}g{jid}s{s}"}, shard=s)
                if not resp.get("ok"):
                    raise RuntimeError(f"shard {s} refused shm_serve: {resp}")
        return base

    def _reserve_shard_shm(self, bs: _BrokerShard) -> None:
        """After a shard respawn: serve every live slot's segments of that
        shard again. One-shot requests to the just-bound port: this runs
        inside ``_rpc``'s retry path and must not recurse into it."""
        for slot in self.slots:
            for name in slot.shm_segs:
                if not name.endswith(f"s{bs.shard}"):
                    continue
                for attempt in range(3):
                    try:
                        protocol.request(
                            bs.addr, {"t": "shm_serve", "seg": name},
                            timeout=10.0)
                        break
                    except (ConnectionError, OSError, TimeoutError):
                        if attempt == 2:
                            break  # the workers' retries outlast the reap
                        time.sleep(0.2)

    # -- worker lifecycle -----------------------------------------------------

    def _spawn(self, slot: _FleetSlot) -> None:
        jids = self._hosted_jobs(slot)
        assert jids, "spawning a slot with no live jobs"
        logdir = os.path.join(self.fleet.run_dir, "logs")
        os.makedirs(logdir, exist_ok=True)
        brokers = ",".join(f"{h}:{p}" for h, p in
                           (bs.addr for bs in self.shards))
        cmd = [sys.executable, "-m", "repro_torch.runtime.worker",
               "--brokers", brokers, "--worker-id", str(slot.worker),
               "--jobs", ",".join(jids)]
        if self.transport == "shm":
            cmd += ["--transport", "shm",
                    "--shm-seg", self._setup_slot_shm(slot, jids)]
        log_path = os.path.join(
            logdir, f"w{slot.worker:03d}.inv{slot.invocations:03d}.log")
        with open(log_path, "wb") as log:
            slot.proc = subprocess.Popen(cmd, stdout=log,
                                         stderr=subprocess.STDOUT,
                                         env=worker_env())
        slot.spawned_at = time.monotonic()
        slot.invocations += 1

    def _reap(self, slot: _FleetSlot) -> None:
        """Classify an exited invocation per hosted job and respawn while
        any of them lives on. Terminal statuses (done, evicted) were folded
        in from the polls; what is left per job is a clean invocation
        boundary or a crash (replay)."""
        from repro_torch.checkpoint import store as ckpt

        code = slot.proc.returncode
        self.lifetimes.append(time.monotonic() - slot.spawned_at)
        slot.proc = None
        if slot.kill_for is not None:
            st = self.jobs[slot.kill_for]
            if st.statuses.get(str(slot.worker)) == "bye:invocation-end":
                # the thread said its bye between the poll and the signal:
                # the kill missed, so it fires again on the next invocation
                st.killed_once = False
            slot.kill_for = None
        live = []
        for jid in self._hosted_jobs(slot):
            st = self.jobs[jid]
            if st.statuses.get(str(slot.worker), "") != "bye:invocation-end":
                # no goodbye for this job: a crash; it replays from its
                # newest checkpoint (per-job checkpoints and WAL history)
                restored = ckpt.latest_step(os.path.join(
                    st.cfg.run_dir, "ckpt", f"w{slot.worker:03d}"))
                self.respawns.append({
                    "worker": slot.worker, "job": jid, "exit_code": code,
                    "restored_step": restored or 0,
                    "at_frontier": st.frontier})
            live.append(jid)
        if live:
            self._spawn(slot)
        else:
            self._teardown_slot_shm(slot)

    def _fold_statuses(self) -> None:
        """Terminal (worker, job) transitions arrive through the polls: a
        thread's ``bye:done`` or ``bye:evicted`` ends that job on its slot
        while the process may run on for its siblings."""
        for st in self.jobs.values():
            for w_str, status in st.statuses.items():
                w = int(w_str)
                if w in st.terminal:
                    continue
                if status == "bye:done":
                    st.terminal[w] = "done"
                elif status == "bye:evicted":
                    st.terminal[w] = "evicted"

    # -- control-plane RPC ----------------------------------------------------

    def _rpc(self, header: dict, payload: bytes = b"", shard: int = 0,
             tries: int = 8) -> tuple[dict, bytes]:
        last: Optional[Exception] = None
        for i in range(tries):
            if self._conns[shard] is None:
                self._conns[shard] = protocol.Connection(
                    self.shards[shard].addr, timeout=30.0)
            try:
                return self._conns[shard].request(header, payload)
            except (ConnectionError, OSError, TimeoutError) as e:
                last = e
                self._conns[shard].close()
                self._conns[shard] = None
                self._reap_brokers()
                time.sleep(0.1 * (i + 1))
        assert last is not None
        raise last

    def _poll_job(self, jid: str) -> None:
        st = self.jobs[jid]
        resp, _ = self._rpc({"t": "poll", "since": st.poll_since, "job": jid})
        for row in resp["rows"]:
            st.history.append(row)
            st.poll_since = row["step"] + 1
            st.frontier = max(st.frontier, row["step"])
            if st.tuner is not None:
                st.tuner.observe(row["step"], row["loss"], row["dur_s"])
            if st.topo_tuner is not None:
                st.topo_tuner.observe(row["dur_s"], row.get("phase"))
        st.evictions = {int(k): v for k, v in resp["evictions"].items()}
        st.statuses = resp["statuses"]
        st.bye_launches = resp.get("bye_launches", st.bye_launches)

    def _evict_victim(self, jid: str, reason: str, s_delta=None) -> bool:
        """One worker leaves job ``jid`` (its thread flushes and exits; the
        slot keeps running its other jobs)."""
        st = self.jobs[jid]
        victims = st.active_workers()
        if len(victims) <= 1:
            return False
        victim = max(victims)
        resp, _ = self._rpc({"t": "evict", "worker": victim, "job": jid})
        if not resp.get("granted"):
            return False
        for s in range(1, self.n_brokers):
            self._rpc({"t": "evict_apply", "worker": victim,
                       "step": resp["evict_step"], "job": jid}, shard=s)
        st.evictions[victim] = resp["evict_step"]
        st.scale_events.append({
            "worker": victim, "evict_step": resp["evict_step"],
            "at_frontier": st.frontier, "s_delta": s_delta,
            "reason": reason})
        return True

    def _fair_share(self) -> None:
        """While the fleet holds more active (worker, job) pairs than the
        budget, the job with the most active workers gives one up: each
        job still walks its own knee curve, the budget caps the sum."""
        budget = self.fleet.pool_budget
        if budget is None:
            return
        for _ in range(len(self.job_ids) * max(len(self.slots), 1)):
            counts = {jid: len(self.jobs[jid].active_workers())
                      for jid in self.job_ids if not self.jobs[jid].complete}
            if sum(counts.values()) <= budget:
                return
            for jid in sorted(counts, key=lambda j: (-counts[j], j)):
                if self._evict_victim(jid, "fair-share"):
                    break
            else:
                return  # nobody can shrink further

    def _fire_kill_knobs(self) -> None:
        """The legacy per-job fault knobs. A worker SIGKILL hits the slot's
        process, so every job on it replays.

        The worker kill waits for a running invocation of its job on the
        slot (status ``running``: hello said, no bye yet). A slot whose
        threads already said ``bye:invocation-end`` (a sibling job's
        boundary stops them all) exits cleanly anyway, and a respawn that
        is still importing shows the last invocation's bye: killing either
        replays nothing and records no respawn."""
        for jid, st in self.jobs.items():
            if st.cfg.kill_worker_at_step is not None and not st.killed_once:
                w, at = st.cfg.kill_worker_at_step
                slot = self.slots[w]
                if (st.frontier >= at and slot.alive
                        and st.statuses.get(str(w)) == "running"):
                    slot.proc.send_signal(signal.SIGKILL)
                    st.killed_once = True
                    slot.kill_for = jid
            if (st.cfg.kill_broker_at_step is not None
                    and not st.broker_killed_once):
                s, at = st.cfg.kill_broker_at_step
                bs = self.shards[s]
                if st.frontier >= at and bs.alive:
                    bs.proc.send_signal(signal.SIGKILL)
                    st.broker_killed_once = True

    # -- main loop ------------------------------------------------------------

    def run(self) -> dict:
        fleet = self.fleet
        os.makedirs(fleet.run_dir, exist_ok=True)
        for st in self.jobs.values():
            os.makedirs(st.cfg.run_dir, exist_ok=True)
        t0 = time.monotonic()
        shard_stats: dict[str, list] = {jid: [] for jid in self.job_ids}
        try:
            self._start_brokers()
            for slot in self.slots:
                self._spawn(slot)
            deadline = t0 + fleet.deadline_s
            while True:
                time.sleep(fleet.poll_interval_s)
                self._reap_brokers()
                for jid in self.job_ids:
                    self._poll_job(jid)
                self._fold_statuses()
                self._fire_kill_knobs()
                for slot in self.slots:
                    if slot.proc is not None and slot.proc.poll() is not None:
                        # refresh the statuses so a goodbye just sent is
                        # not misread as a crash
                        for jid in self._hosted_jobs(slot):
                            self._poll_job(jid)
                        self._fold_statuses()
                        self._reap(slot)
                if all(slot.alive for slot in self.slots
                       if self._hosted_jobs(slot)):
                    for jid, st in self.jobs.items():
                        if st.scripted_fired < len(
                                st.cfg.scripted_evict_steps):
                            nxt = st.cfg.scripted_evict_steps[
                                st.scripted_fired]
                            if (st.frontier >= nxt
                                    and self._evict_victim(jid, "scripted")):
                                st.scripted_fired += 1
                        if st.tuner is not None and st.history:
                            decision = st.tuner.decide()
                            if decision.remove_worker:
                                self._evict_victim(jid, decision.reason,
                                                   decision.s_delta)
                    self._fair_share()
                if all(st.complete for st in self.jobs.values()):
                    for jid in self.job_ids:
                        self._poll_job(jid)
                    break
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"fleet deadline ({fleet.deadline_s}s) exceeded; "
                        f"frontiers="
                        f"{ {j: st.frontier for j, st in self.jobs.items()} }"
                        f"; statuses="
                        f"{ {j: st.statuses for j, st in self.jobs.items()} }"
                        f"; logs in {os.path.join(fleet.run_dir, 'logs')}")
            # every job is complete, so each slot's process is exiting on
            # its own (terminal statuses fold in from the polls, before the
            # processes end): wait for it and bill its real lifetime
            for slot in self.slots:
                if slot.proc is not None:
                    try:
                        slot.proc.wait(timeout=30.0)
                    except subprocess.TimeoutExpired:
                        slot.proc.kill()
                        slot.proc.wait()
                    self.lifetimes.append(time.monotonic() - slot.spawned_at)
                    slot.proc = None
                    self._teardown_slot_shm(slot)
            self._stopping = True
            # one shutdown a (job core, shard); the shard process exits
            # after its last core is down, so the jobs go inner
            for s in range(self.n_brokers):
                for jid in self.job_ids:
                    resp, _ = self._rpc({"t": "shutdown", "job": jid},
                                        shard=s)
                    shard_stats[jid].append(resp)
        finally:
            for slot in self.slots:
                if slot.alive:
                    slot.proc.kill()
                    slot.proc.wait()
            for conn in self._conns:
                if conn is not None:
                    conn.close()
            self._conns = [None] * self.n_brokers
            for bs in self.shards:
                if bs.proc is not None:
                    bs.proc.terminate()
                    try:
                        bs.proc.wait(timeout=5.0)
                    except subprocess.TimeoutExpired:
                        bs.proc.kill()
                        bs.proc.wait()
            # the scheduler owns every segment: none may outlive the fleet
            for seg in self._shm_segments.values():
                seg.unlink()
            self._shm_segments.clear()
        wall = time.monotonic() - t0
        return self._result(wall, shard_stats)

    # -- results --------------------------------------------------------------

    def _job_result(self, jid: str, stats_rows: list) -> dict:
        st = self.jobs[jid]
        hist = st.history
        durs = [r["dur_s"] for r in hist if r.get("dur_s")]
        stats: dict[str, dict[str, int]] = {}
        for resp in stats_rows:
            for kind, row in (resp.get("stats") or {}).items():
                agg = stats.setdefault(
                    kind, {"count": 0, "bytes_in": 0, "bytes_out": 0})
                for k in agg:
                    agg[k] += row.get(k, 0)
        busy_s = sum(float(r["dur_s"]) * int(r.get("p_active", 1))
                     for r in hist if r.get("dur_s"))
        # this job's kernel launches a worker: its steps' reports and its
        # SSP drain's goodbye, counted by the job's own thread
        launches: dict[str, dict[str, int]] = {}
        for by_worker in [r.get("launches_by_worker") or {} for r in hist] + [
                st.bye_launches]:
            for w, counts in by_worker.items():
                acc = launches.setdefault(w, {})
                for k, v in counts.items():
                    acc[k] = acc.get(k, 0) + int(v)
        survivors = [w for w, v in st.terminal.items() if v == "done"]
        final_eval = final_ckpt_step = None
        if survivors:
            params, final_ckpt_step = final_params(st.cfg, min(survivors),
                                                   st.wl)
            final_eval = st.wl.eval_fn(params)
        return {
            "job_id": jid,
            "workload": st.wl.name,
            "device": str(st.wl.device),
            "consistency": st.cfg.consistency,
            "run_dir": st.cfg.run_dir,
            "n_workers": st.cfg.n_workers,
            "steps": st.frontier,
            "final_loss": hist[-1]["loss"] if hist else None,
            "final_eval": final_eval,
            "final_ckpt_step": final_ckpt_step,
            "final_pool": len(survivors),
            "history": hist,
            "measured_step_s": (sum(durs) / len(durs)) if durs else None,
            "busy_s": busy_s,
            "wire_bytes_total": sum(r["wire_bytes"] for r in hist),
            "invariant_max_err": max((r["inv_err"] for r in hist),
                                     default=0.0),
            "kernel_launches_by_worker": launches,
            "scale_events": st.scale_events,
            "evictions": dict(st.evictions),
            "dup_mismatches": sum(int(r.get("dup_mismatches", 0))
                                  for r in stats_rows),
            "broker_stats": stats,
            "broker_stats_per_shard": [r.get("stats") or {}
                                       for r in stats_rows],
            "broker_update_bytes_per_shard": [
                int(r.get("update_bytes", 0)) for r in stats_rows],
            "topology_recommendation": self._topo_recommendation(jid),
        }

    def _topo_recommendation(self, jid: str) -> Optional[dict]:
        """Observe-only topology advice for one fleet job: the shared pool
        is never re-sharded live, so the running cell is measured and its
        neighbours ranked by the cost model."""
        st = self.jobs[jid]
        if st.topo_tuner is None:
            return None
        hist = st.history
        bytes_per_step = (sum(float(r.get("wire_bytes") or 0.0)
                              for r in hist) / max(len(hist), 1))
        current = dict(st.topo_tuner.cells[0])
        flip_b = dict(current, n_brokers=(
            2 if int(current["n_brokers"]) == 1 else 1))
        flip_t = dict(current, transport=(
            "shm" if current["transport"] == "tcp" else "tcp"))
        comm = CommModel()
        ranked = sorted(
            ({"cell": c, "model_exchange_s": comm.indirect_exchange_time(
                bytes_per_step, st.cfg.n_workers,
                n_redis=int(c["n_brokers"]))}
             for c in (current, flip_b, flip_t)),
            key=lambda r: r["model_exchange_s"])
        return {"mode": "observe-only",
                "note": "fleet pool is shared; no live re-shard per job",
                "measured": st.topo_tuner.cell_stats(0),
                "model_ranked_cells": ranked}

    def _result(self, wall: float, shard_stats: dict[str, list]) -> dict:
        per_job = {jid: self._job_result(jid, shard_stats[jid])
                   for jid in self.job_ids}
        bill = faas_cost(self.lifetimes, wall, n_redis=self.n_brokers)
        rollup = multi_job_rollup(
            self.lifetimes, wall, self.n_brokers,
            {jid: per_job[jid]["busy_s"] for jid in self.job_ids})
        return {
            "jobs": per_job,
            "job_ids": list(self.job_ids),
            "n_brokers": self.n_brokers,
            "transport": self.transport,
            "pool_budget": self.fleet.pool_budget,
            "shm_token": self._shm_token,
            "wall_s": wall,
            "n_invocations": len(self.lifetimes),
            "lifetimes_s": list(self.lifetimes),
            "respawns": self.respawns,
            "n_respawns": len(self.respawns),
            "broker_respawns": self.broker_respawns,
            "dup_mismatches": sum(per_job[j]["dup_mismatches"]
                                  for j in self.job_ids),
            "bill": {
                "worker_seconds": bill.worker_seconds,
                "wall_seconds": bill.wall_seconds,
                "worker_cost": bill.worker_cost,
                "infra_cost": bill.infra_cost,
                "n_redis": bill.n_redis,
                "total": bill.total,
            },
            "rollup": {"per_job": rollup["per_job"],
                       "total": rollup["bill"].total},
        }


def run_fleet(fleet: FleetConfig) -> dict:
    """Run N admitted jobs to completion on one pool; returns the fleet's
    result (``jobs[<id>]`` mirrors the solo supervisor's result)."""
    return FleetScheduler(fleet).run()
