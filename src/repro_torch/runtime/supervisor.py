r"""Host-side supervisor of the FaaS runtime (port of
``repro.runtime.supervisor``, solo path).

Owns one training job end to end:

* spawns ``n_brokers`` update-broker shard processes
  (``repro_torch.runtime.broker``) and ``n_workers`` worker processes
  (``repro_torch.runtime.worker``), each invocation-bounded;
* polls live (loss, step-duration) telemetry off the coordinator and feeds
  the scale-in ``ScaleInAutoTuner``; on a decision it evicts the
  highest-id worker, which flushes its replica and exits;
* respawns workers at invocation boundaries and after crashes (restore
  the newest checkpoint, replay forward), and a crashed broker shard on
  its original port (WAL replay);
* under ``transport='shm'`` owns every shared-memory segment (DESIGN.md
  §12): fresh segments per worker invocation, served by each shard before
  the worker spawns, re-served after a shard respawn, and unlinked when
  the invocation ends and, whatever is left, when the job ends;
* compiles the legacy fault knobs (``kill_worker_at_step``,
  ``kill_broker_at_step``, ``straggler``) into one ``faults.FaultPlan``:
  the supervisor fires the kills, the workers the straggler's delay;
* bills every invocation's measured lifetime through ``faas_cost``.

The job's device travels in the job dict, so every worker follows it, as
do ``consistency`` (``isp``, or bounded-staleness ``ssp`` with ``slack``,
DESIGN.md §13) and the transport. Not yet ported from the JAX supervisor:
an explicit ``chaos`` spec and its journal, the topology tuner and live
re-sharding, pre-warmed respawn, the fleet and ``hostperf``; a config that
asks for one raises.

State machine per worker slot::

    spawned -> running -> { done | evicted }          (terminal)
                      \-> invocation-end -> respawn -> running
                      \-> crashed        -> respawn -> running (replay)
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import secrets
import signal
import subprocess
import sys
import time
from typing import Any, Optional

import numpy as np

from repro_torch.core.autotuner import AutoTunerConfig, ScaleInAutoTuner
from repro_torch.core.billing import FaaSBill, faas_cost
from repro_torch.runtime import protocol
from repro_torch.runtime import workload as workload_lib
from repro_torch.runtime.faults import (
    SUPERVISOR_KINDS,
    FaultEvent,
    FaultPlan,
    RetryPolicy,
)
from repro_torch.wire import codec as wire_codec

PyTree = Any

# per-direction ring capacity of each worker<->shard shm segment
SHM_RING_BYTES = 4 << 20


@dataclasses.dataclass
class FaaSJobConfig:
    """One serverless training job (all fields JSON-serializable)."""

    run_dir: str
    workload: str = "pmf"
    workload_cfg: dict = dataclasses.field(default_factory=dict)
    device: str = "cuda"
    n_workers: int = 4
    total_steps: int = 60
    invocation_steps: int = 1_000_000  # steps per function invocation
    checkpoint_every: int = 10
    optimizer: str = "nesterov"
    lr: float = 0.08
    isp_v: float = 0.7
    isp_decay: bool = True
    # pull-barrier consistency (DESIGN.md §13): 'isp' is the full per-step
    # barrier; 'ssp' is bounded staleness — a pull at step t blocks only
    # until every update from steps <= t - slack - 1 is stored, and is
    # served exactly that step
    consistency: str = "isp"
    slack: int = 3
    # {"worker": k, "delay_s": d, "every": n}: worker k sleeps d seconds
    # inside every n-th step's compute phase
    straggler: Optional[dict] = None
    # update wire encoding: 'auto'|'dense'|'sparse'|'bitmap', optional
    # 'fp16'|'bf16' value quantization with error-feedback residual
    wire_scheme: str = "auto"
    wire_quant: str = "none"
    # codec backend (wire.codec.IMPLS): 'cuda' runs the fused kernels on
    # the main path, 'numpy' is the host reference, 'auto' picks per leaf
    wire_impl: str = "cuda"
    n_brokers: int = 1
    # worker<->shard data path (DESIGN.md §12): 'tcp' is the persistent
    # loopback socket, 'shm' the supervisor-allocated shared-memory ring
    # segments (same framing, codec and accounted bytes); the
    # supervisor's own control plane always rides TCP
    transport: str = "tcp"
    shard_split_bytes: int = 0
    partitioner: str = "greedy"
    autotune: bool = False
    tuner: Optional[AutoTunerConfig] = None
    scripted_evict_steps: tuple[int, ...] = ()
    kill_worker_at_step: Optional[tuple[int, int]] = None  # (worker, step)
    kill_broker_at_step: Optional[tuple[int, int]] = None  # (shard, step)
    # an explicit FaultPlan spec (the JAX chaos plane): not yet ported
    chaos: Optional[dict] = None
    rpc: Optional[dict] = None
    poll_interval_s: float = 0.05
    deadline_s: float = 600.0
    pull_deadline_s: float = 120.0
    broker_spawn_timeout_s: float = 30.0
    seed: int = 0

    def compiled_chaos_plan(self) -> Optional[FaultPlan]:
        """The legacy one-off knobs as one fault plan:
        ``kill_worker_at_step`` / ``kill_broker_at_step`` become supervisor
        kill events and ``straggler`` a repeating ``compute_delay``. None
        when the job injects nothing."""
        events = []
        if self.kill_worker_at_step is not None:
            w, at = self.kill_worker_at_step
            events.append(FaultEvent("worker_kill", int(at), worker=int(w)))
        if self.kill_broker_at_step is not None:
            s, at = self.kill_broker_at_step
            events.append(FaultEvent("broker_kill", int(at), shard=int(s)))
        if self.straggler is not None:
            st = self.straggler
            events.append(FaultEvent(
                "compute_delay", 0, worker=int(st["worker"]),
                delay_s=float(st["delay_s"]), every=int(st.get("every", 1)),
            ))
        if not events:
            return None
        return FaultPlan(seed=0, events=tuple(events)).validate()

    def job_dict(self, n_batches: int) -> dict:
        d = {
            "workload": self.workload,
            "workload_cfg": dict(self.workload_cfg),
            "device": self.device,
            "n_workers": self.n_workers,
            "total_steps": self.total_steps,
            "invocation_steps": self.invocation_steps,
            "checkpoint_every": self.checkpoint_every,
            "optimizer": self.optimizer,
            "lr": self.lr,
            "isp_v": self.isp_v,
            "isp_decay": self.isp_decay,
            "consistency": self.consistency,
            "slack": self.slack,
            "wire_scheme": self.wire_scheme,
            "wire_quant": self.wire_quant,
            "wire_impl": self.wire_impl,
            "n_brokers": self.n_brokers,
            "transport": self.transport,
            "shard_split_bytes": self.shard_split_bytes,
            "partitioner": self.partitioner,
            "topo_gen": 0,
            "n_batches": n_batches,
            "run_dir": self.run_dir,
            "pull_deadline_s": self.pull_deadline_s,
            "seed": self.seed,
        }
        plan = self.compiled_chaos_plan()
        if plan is not None:
            d["chaos"] = plan.to_spec()
        if self.rpc is not None:
            d["rpc"] = dict(self.rpc)
        return d


@dataclasses.dataclass
class _Slot:
    """One logical worker (survives respawns; one proc per invocation)."""

    worker: int
    proc: Optional[subprocess.Popen] = None
    spawned_at: float = 0.0
    invocations: int = 0
    terminal: Optional[str] = None  # 'done' | 'evicted'
    # shm transport: this invocation's per-shard segment names (fresh per
    # invocation, the shm analogue of a new connection per invocation)
    shm_segs: list = dataclasses.field(default_factory=list)

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None


@dataclasses.dataclass
class _BrokerShard:
    """One update-store shard (survives respawns at a pinned port)."""

    shard: int
    proc: Optional[subprocess.Popen] = None
    addr: Optional[tuple[str, int]] = None
    spawns: int = 0


class Supervisor:
    def __init__(self, cfg: FaaSJobConfig):
        if cfg.transport not in ("tcp", "shm"):
            raise ValueError(
                f"transport must be 'tcp' or 'shm', got {cfg.transport!r}")
        if cfg.consistency not in ("isp", "ssp"):
            raise ValueError(f"consistency must be 'isp' or 'ssp', got "
                             f"{cfg.consistency!r}")
        if cfg.consistency == "ssp" and cfg.slack < 0:
            raise ValueError(f"slack must be >= 0, got {cfg.slack}")
        if cfg.chaos is not None:
            raise NotImplementedError("an explicit chaos spec: not yet "
                                      "ported")
        if cfg.wire_impl not in wire_codec.IMPLS:
            raise ValueError(
                f"wire_impl must be one of {wire_codec.IMPLS}, got "
                f"{cfg.wire_impl!r}"
            )
        if cfg.partitioner not in ("greedy", "ring"):
            raise ValueError(f"partitioner must be 'greedy' or 'ring', got "
                             f"{cfg.partitioner!r}")
        self.plan = cfg.compiled_chaos_plan()
        if self.plan is not None:
            for e in self.plan.events:
                if e.worker is not None and not 0 <= e.worker < cfg.n_workers:
                    raise ValueError(f"fault event targets worker "
                                     f"{e.worker} of {cfg.n_workers}: {e}")
                if e.shard is not None and not 0 <= e.shard < cfg.n_brokers:
                    raise ValueError(f"fault event targets shard "
                                     f"{e.shard} of {cfg.n_brokers}: {e}")
        self._kills_fired: set[int] = set()
        self.cfg = cfg
        self.rpc_policy = RetryPolicy.from_dict(cfg.rpc)
        self.wl = workload_lib.build(cfg.workload, cfg.workload_cfg,
                                     device=cfg.device)
        self.shards = [_BrokerShard(shard=s) for s in range(cfg.n_brokers)]
        self._conns: list[Optional[protocol.Connection]] = (
            [None] * cfg.n_brokers)
        self.slots = [_Slot(worker=w) for w in range(cfg.n_workers)]
        self.lifetimes: list[float] = []  # one entry per finished invocation
        self.history: list[dict] = []
        self.scale_events: list[dict] = []
        self.respawns: list[dict] = []
        self.broker_respawns: list[dict] = []
        self.evictions: dict[int, int] = {}
        self.bye_launches: dict[str, dict[str, int]] = {}
        self._frontier = 0
        self._poll_since = 1
        self._scripted_fired = 0
        self._stopping = False
        # shm transport: a job-unique segment namespace and the live
        # segments (the supervisor alone creates and unlinks them)
        self._shm_token = f"ml{os.getpid():x}{secrets.token_hex(2)}"
        self._shm_segments: dict[str, Any] = {}  # name -> wire.shm.Segment
        self.tuner: Optional[ScaleInAutoTuner] = None
        if cfg.autotune:
            self.tuner = ScaleInAutoTuner(cfg.tuner or AutoTunerConfig(),
                                          cfg.n_workers)

    # -- process management ---------------------------------------------------

    def _base_env(self) -> dict:
        import repro_torch

        src = os.path.dirname(os.path.dirname(
            os.path.abspath(repro_torch.__file__)))
        env = dict(os.environ)
        env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
        return env

    def _worker_env(self) -> dict:
        env = self._base_env()
        # each worker is the paper's 1 vCPU function: cap host math threads
        env.setdefault("OMP_NUM_THREADS", "1")
        env.setdefault("OPENBLAS_NUM_THREADS", "1")
        # deterministic cuBLAS workspaces (torch.use_deterministic_algorithms)
        env.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        return env

    def _broker_dir(self) -> str:
        return os.path.join(self.cfg.run_dir, "broker")

    def _spawn_broker(self, bs: _BrokerShard) -> None:
        """Spawn (or respawn) one shard and wait until it listens. Respawns
        pin the original port; the port file is the readiness signal,
        written after WAL replay and bind."""
        bdir = self._broker_dir()
        logdir = os.path.join(self.cfg.run_dir, "logs")
        os.makedirs(bdir, exist_ok=True)
        os.makedirs(logdir, exist_ok=True)
        port_file = os.path.join(bdir, f"shard{bs.shard:02d}.port")
        if os.path.exists(port_file):
            os.unlink(port_file)
        wal_path = os.path.join(bdir, f"shard{bs.shard:02d}.wal")
        if bs.spawns == 0 and os.path.exists(wal_path):
            os.unlink(wal_path)  # a reused run_dir: never replay old logs
        log_path = os.path.join(
            logdir, f"broker{bs.shard:02d}.spawn{bs.spawns:02d}.log")
        with open(log_path, "wb") as log:
            bs.proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.runtime.broker",
                 "--config", os.path.join(bdir, "job.json"),
                 "--shard-id", str(bs.shard),
                 "--n-shards", str(len(self.shards)),
                 "--port", str(bs.addr[1] if bs.addr else 0),
                 "--wal", wal_path,
                 "--port-file", port_file],
                stdout=log, stderr=subprocess.STDOUT, env=self._base_env(),
            )
        bs.spawns += 1
        deadline = time.monotonic() + self.cfg.broker_spawn_timeout_s
        while not os.path.exists(port_file):
            if bs.proc.poll() is not None:
                raise RuntimeError(
                    f"broker shard {bs.shard} exited during spawn "
                    f"(code {bs.proc.returncode}); logs in {logdir}")
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"broker shard {bs.shard} did not listen within "
                    f"{self.cfg.broker_spawn_timeout_s}s")
            time.sleep(0.01)
        with open(port_file) as f:
            host, port = f.read().strip().rsplit(":", 1)
        bs.addr = (host, int(port))

    def _start_brokers(self) -> None:
        os.makedirs(self._broker_dir(), exist_ok=True)
        with open(os.path.join(self._broker_dir(), "job.json"), "w") as f:
            json.dump(self.cfg.job_dict(self.wl.n_batches), f, indent=1)
        for bs in self.shards:
            self._spawn_broker(bs)

    def _reap_brokers(self) -> None:
        """Respawn any shard that died unasked (its WAL restores it)."""
        if self._stopping:
            return
        for bs in self.shards:
            if bs.proc is not None and bs.proc.poll() is not None:
                self.broker_respawns.append({
                    "shard": bs.shard, "exit_code": bs.proc.returncode,
                    "at_frontier": self._frontier})
                if self._conns[bs.shard] is not None:
                    self._conns[bs.shard].close()
                    self._conns[bs.shard] = None
                self._spawn_broker(bs)
                if self.cfg.transport == "shm":
                    # the shard's serving threads died with it: hand it
                    # every live worker's segment again (each re-serve
                    # resets that ring pair and bumps its generation, so
                    # in-flight workers replay through their RPC retries)
                    self._reserve_shard_shm(bs)

    # -- shared-memory segment lifecycle --------------------------------------
    #
    # One segment per (worker, shard), created fresh for every worker
    # invocation: a dying invocation's half-written rings are never reused;
    # its broker-side threads exit on client-death detection and the
    # supervisor unlinks the memory.

    def _teardown_worker_shm(self, slot: _Slot) -> None:
        from repro_torch.wire import shm

        for name in slot.shm_segs:
            seg = self._shm_segments.pop(name, None)
            if seg is not None:
                seg.unlink()
            else:  # pragma: no cover - belt and braces
                shm.Segment.unlink_by_name(name)
        slot.shm_segs = []

    def _setup_worker_shm(self, slot: _Slot) -> str:
        """Fresh segments for this slot's next invocation, each served by
        its shard; returns the base name (shard s attaches '<base>s<s>')."""
        from repro_torch.wire import shm

        self._teardown_worker_shm(slot)
        base = f"{self._shm_token}w{slot.worker}i{slot.invocations}"
        names = [f"{base}s{s}" for s in range(len(self.shards))]
        for name in names:
            self._shm_segments[name] = shm.Segment.create(
                name, ring_bytes=SHM_RING_BYTES)
        slot.shm_segs = names
        for s, name in enumerate(names):
            resp, _ = self._rpc({"t": "shm_serve", "seg": name}, shard=s)
            if not resp.get("ok"):
                raise RuntimeError(f"shard {s} refused shm_serve: {resp}")
        return base

    def _reserve_shard_shm(self, bs: _BrokerShard) -> None:
        """After a shard respawn: serve every live worker's segment for
        this shard again. One-shot RPCs to the just-bound port: this runs
        inside ``_rpc``'s retry path and must not recurse into it."""
        for slot in self.slots:
            if slot.terminal is not None or not slot.shm_segs:
                continue
            name = slot.shm_segs[bs.shard]
            for attempt in range(3):
                try:
                    protocol.request(bs.addr, {"t": "shm_serve", "seg": name},
                                     timeout=10.0)
                    break
                except (ConnectionError, OSError, TimeoutError):
                    if attempt == 2:
                        # workers ride it out: their shm connect wait and
                        # RPC retries outlast the next reap cycle
                        break
                    time.sleep(0.2)

    def _spawn(self, slot: _Slot) -> None:
        logdir = os.path.join(self.cfg.run_dir, "logs")
        os.makedirs(logdir, exist_ok=True)
        brokers = ",".join(f"{h}:{p}" for h, p in
                           (bs.addr for bs in self.shards))
        cmd = [sys.executable, "-m", "repro_torch.runtime.worker",
               "--brokers", brokers, "--worker-id", str(slot.worker)]
        if self.cfg.transport == "shm":
            cmd += ["--transport", "shm",
                    "--shm-seg", self._setup_worker_shm(slot)]
        log_path = os.path.join(
            logdir, f"w{slot.worker:03d}.inv{slot.invocations:03d}.log")
        with open(log_path, "wb") as log:
            slot.proc = subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT,
                env=self._worker_env(),
            )
        slot.spawned_at = time.monotonic()
        slot.invocations += 1

    def _ckpt_dir(self, worker: int) -> str:
        return os.path.join(self.cfg.run_dir, "ckpt", f"w{worker:03d}")

    def _reap(self, slot: _Slot, statuses: dict) -> None:
        """Classify an exited process and respawn when the slot lives on."""
        from repro_torch.checkpoint import store as ckpt

        code = slot.proc.returncode
        self.lifetimes.append(time.monotonic() - slot.spawned_at)
        slot.proc = None
        status = statuses.get(str(slot.worker), "")
        if status == "bye:done":
            slot.terminal = "done"
            self._teardown_worker_shm(slot)
        elif status == "bye:evicted":
            slot.terminal = "evicted"
            self._teardown_worker_shm(slot)
        elif status == "bye:invocation-end":
            self._spawn(slot)
        else:
            # no goodbye: the process died — respawn; it restores its
            # newest checkpoint and replays forward
            self.respawns.append({
                "worker": slot.worker, "exit_code": code,
                "restored_step": ckpt.latest_step(
                    self._ckpt_dir(slot.worker)) or 0,
                "at_frontier": self._frontier})
            self._spawn(slot)

    # -- broker RPC -----------------------------------------------------------

    def _rpc(self, header: dict, payload: bytes = b"",
             shard: int = 0) -> tuple[dict, bytes]:
        """Retrying RPC to one shard; survives a shard respawn window."""
        last: Optional[Exception] = None
        for _ in self.rpc_policy.attempts():
            if self._conns[shard] is None:
                self._conns[shard] = protocol.Connection(
                    self.shards[shard].addr,
                    timeout=self.rpc_policy.timeout_s)
            try:
                return self._conns[shard].request(header, payload)
            except (ConnectionError, OSError, TimeoutError) as e:
                last = e
                self._conns[shard].close()
                self._conns[shard] = None
                self._reap_brokers()
        assert last is not None
        raise last

    def _poll(self) -> dict:
        resp, _ = self._rpc({"t": "poll", "since": self._poll_since})
        for row in resp["rows"]:
            self.history.append(row)
            self._poll_since = row["step"] + 1
            self._frontier = max(self._frontier, row["step"])
            if self.tuner is not None:
                self.tuner.observe(row["step"], row["loss"], row["dur_s"])
        self.evictions = {int(k): v for k, v in resp["evictions"].items()}
        self.bye_launches = resp.get("bye_launches", self.bye_launches)
        return resp

    def _fire_kills(self) -> None:
        """SIGKILL each planned victim once the frontier reaches its step
        and it is running (a victim between processes waits for the next
        one)."""
        if self.plan is None:
            return
        for idx, e in enumerate(self.plan.events):
            if (e.kind not in SUPERVISOR_KINDS or idx in self._kills_fired
                    or self._frontier < e.step):
                continue
            # compiled_chaos_plan makes worker_kill and broker_kill only
            victim = (self.slots[e.worker] if e.kind == "worker_kill"
                      else self.shards[e.shard])
            proc = victim.proc
            if proc is not None and proc.poll() is None:
                proc.send_signal(signal.SIGKILL)
                self._kills_fired.add(idx)

    def _evict_victim(self, reason: str, s_delta=None) -> bool:
        """Highest-id live, non-terminal, non-evicted worker leaves."""
        victims = [s.worker for s in self.slots
                   if s.terminal is None and s.worker not in self.evictions]
        if len(victims) <= 1:
            return False
        victim = max(victims)
        resp, _ = self._rpc({"t": "evict", "worker": victim})
        if not resp.get("granted"):
            return False
        for s in range(1, len(self.shards)):
            self._rpc({"t": "evict_apply", "worker": victim,
                       "step": resp["evict_step"]}, shard=s)
        self.evictions[victim] = resp["evict_step"]
        self.scale_events.append({
            "worker": victim, "evict_step": resp["evict_step"],
            "at_frontier": self._frontier, "s_delta": s_delta,
            "reason": reason})
        return True

    # -- main loop ------------------------------------------------------------

    def run(self) -> dict:
        cfg = self.cfg
        os.makedirs(cfg.run_dir, exist_ok=True)
        t_job0 = time.monotonic()
        try:
            self._start_brokers()
            for slot in self.slots:
                self._spawn(slot)
            deadline = t_job0 + cfg.deadline_s
            while True:
                time.sleep(cfg.poll_interval_s)
                self._reap_brokers()
                statuses = self._poll()["statuses"]
                self._fire_kills()
                for slot in self.slots:
                    if (slot.terminal is None and slot.proc is not None
                            and slot.proc.poll() is not None):
                        # refresh statuses so a just-sent bye is not
                        # misread as a crash
                        statuses = self._poll()["statuses"]
                        self._reap(slot, statuses)
                if all(s.alive for s in self.slots if s.terminal is None):
                    if self._scripted_fired < len(cfg.scripted_evict_steps):
                        nxt = cfg.scripted_evict_steps[self._scripted_fired]
                        if (self._frontier >= nxt
                                and self._evict_victim("scripted")):
                            self._scripted_fired += 1
                    if self.tuner is not None and self.history:
                        decision = self.tuner.decide()
                        if decision.remove_worker:
                            self._evict_victim(decision.reason,
                                               decision.s_delta)
                if all(s.terminal is not None for s in self.slots):
                    self._poll()
                    break
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"FaaS job deadline ({cfg.deadline_s}s) exceeded at "
                        f"frontier {self._frontier}; statuses={statuses}; "
                        f"logs in {os.path.join(cfg.run_dir, 'logs')}")
            self._stopping = True
            shard_stats = [self._rpc({"t": "shutdown"}, shard=s)[0]
                           for s in range(len(self.shards))]
        finally:
            for slot in self.slots:
                if slot.alive:
                    slot.proc.send_signal(signal.SIGKILL)
                    slot.proc.wait()
            for conn in self._conns:
                if conn is not None:
                    conn.close()
            self._conns = [None] * len(self.shards)
            for bs in self.shards:
                if bs.proc is not None:
                    bs.proc.terminate()
                    try:
                        bs.proc.wait(timeout=5.0)
                    except subprocess.TimeoutExpired:
                        bs.proc.kill()
                        bs.proc.wait()
            # the supervisor owns every shm segment: none may outlive the
            # job (they are named host-global resources, not fds)
            for seg in self._shm_segments.values():
                seg.unlink()
            self._shm_segments.clear()
        wall = time.monotonic() - t_job0
        bill = faas_cost(self.lifetimes, wall, n_redis=len(self.shards))
        return self._result(wall, bill, shard_stats)

    # -- results --------------------------------------------------------------

    def _final_eval(self) -> tuple[Optional[float], Optional[int]]:
        survivors = [s.worker for s in self.slots if s.terminal == "done"]
        if not survivors:
            return None, None
        tree, step = final_params(self.cfg, min(survivors), self.wl)
        return self.wl.eval_fn(tree), step

    def _result(self, wall, bill: FaaSBill, shard_stats) -> dict:
        final_eval, final_ckpt_step = self._final_eval()
        hist = self.history
        durs = [r["dur_s"] for r in hist if r.get("dur_s")]
        phases = [r["phase"] for r in hist if r.get("phase")]
        phase_s_mean = {
            k: sum(p[k] for p in phases if p.get(k) is not None)
            / max(sum(1 for p in phases if p.get(k) is not None), 1)
            for k in phases[0]
        } if phases else {}
        launches: dict[str, dict[str, int]] = {}
        per_step = [r.get("launches_by_worker") or {} for r in hist]
        for by_worker in per_step + [self.bye_launches]:
            for w, counts in by_worker.items():
                acc = launches.setdefault(w, {})
                for k, v in counts.items():
                    acc[k] = acc.get(k, 0) + int(v)
        stats: dict[str, dict[str, int]] = {}
        for resp in shard_stats:
            for kind, row in (resp.get("stats") or {}).items():
                agg = stats.setdefault(
                    kind, {"count": 0, "bytes_in": 0, "bytes_out": 0})
                for k in agg:
                    agg[k] += row.get(k, 0)
        return {
            "workload": self.wl.name,
            "device": str(self.wl.device),
            "n_workers": self.cfg.n_workers,
            "n_brokers": len(self.shards),
            "transport": self.cfg.transport,
            "consistency": self.cfg.consistency,
            "slack": (self.cfg.slack if self.cfg.consistency == "ssp"
                      else None),
            "shm_token": self._shm_token,
            "steps": self._frontier,
            "final_pool": sum(1 for s in self.slots if s.terminal == "done"),
            "final_loss": hist[-1]["loss"] if hist else None,
            "final_eval": final_eval,
            "final_ckpt_step": final_ckpt_step,
            "history": hist,
            "measured_step_s": (sum(durs) / len(durs)) if durs else None,
            "phase_s_mean": phase_s_mean,
            "kernel_launches_by_worker": launches,
            "wire_scheme": self.cfg.wire_scheme,
            "wire_quant": self.cfg.wire_quant,
            "wire_impl": self.cfg.wire_impl,
            "invariant_max_err": max((r["inv_err"] for r in hist),
                                     default=0.0),
            "wire_bytes_total": sum(r["wire_bytes"] for r in hist),
            "scale_events": self.scale_events,
            "respawns": self.respawns,
            "n_respawns": len(self.respawns),
            "broker_respawns": self.broker_respawns,
            "n_invocations": len(self.lifetimes),
            "lifetimes_s": list(self.lifetimes),
            "dup_mismatches": sum(int(r.get("dup_mismatches", 0))
                                  for r in shard_stats),
            "wall_s": wall,
            "bill": {
                "worker_seconds": bill.worker_seconds,
                "wall_seconds": bill.wall_seconds,
                "worker_cost": bill.worker_cost,
                "infra_cost": bill.infra_cost,
                "n_redis": bill.n_redis,
                "total": bill.total,
            },
            "broker_stats": stats,
            "broker_update_bytes_per_shard": [
                int(r.get("update_bytes", 0)) for r in shard_stats],
        }


def run_job(cfg: FaaSJobConfig) -> dict:
    """Run one FaaS training job to completion; returns the result dict."""
    return Supervisor(cfg).run()


def final_params(cfg: FaaSJobConfig, worker: int = 0, wl=None):
    """``(params, step)`` of one worker's newest checkpoint, as tensors on
    the job's device."""
    from repro_torch import optim as optim_lib
    from repro_torch import tree as tree_lib
    from repro_torch.checkpoint import store as ckpt

    import torch

    wl = wl or workload_lib.build(cfg.workload, cfg.workload_cfg,
                                  device=cfg.device)
    optimizer = optim_lib.make(cfg.optimizer, cfg.lr)
    like = {
        "params": wl.params0,
        "opt": optimizer.init(wl.params0),
        "residual": tree_lib.tree_map(torch.zeros_like, wl.params0),
    }
    d = os.path.join(cfg.run_dir, "ckpt", f"w{worker:03d}")
    step = ckpt.latest_step(d)
    if step is None:
        raise FileNotFoundError(f"no final checkpoint under {d}")
    return ckpt.restore(d, step, like, device=wl.device)["params"], step


def final_params_digest(cfg: FaaSJobConfig, worker: int = 0) -> str:
    """sha256 over one worker's final checkpointed parameters — the
    bit-identity witness compared across shard counts, replays and codec
    impls (the same digest ``repro.runtime.supervisor`` computes)."""
    from repro_torch import tree as tree_lib

    params, _ = final_params(cfg, worker)
    h = hashlib.sha256()
    for leaf in tree_lib.leaves(params):
        h.update(np.ascontiguousarray(wire_codec.to_numpy(leaf)).tobytes())
    return h.hexdigest()
