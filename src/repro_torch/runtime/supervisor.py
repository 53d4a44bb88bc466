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
* under ``prewarm`` spawns each slot's next invocation ahead of its
  boundary, gated (``--prewarm-gate``): it imports torch, opens the CUDA
  context, loads the kernels and launches them once on a throwaway
  state, then holds; at the boundary (or a crash) the supervisor opens
  the gate instead of paying a cold start inside the barrier stall;
* under ``transport='shm'`` owns every shared-memory segment (DESIGN.md
  §12): fresh segments per worker invocation, served by each shard before
  the worker spawns, re-served after a shard respawn, and unlinked when
  the invocation ends and, whatever is left, when the job ends;
* runs the chaos plane (``runtime/faults.py``, DESIGN.md §17): the
  explicit ``chaos`` spec merged with the legacy knobs
  (``kill_worker_at_step``, ``kill_broker_at_step``, ``straggler``) into
  one seeded ``FaultPlan``; the supervisor fires the kills, the WAL
  corruption and its own death, the workers the wire, checkpoint and
  compute faults;
* under ``allow_self_kill`` / ``resume`` keeps a crash journal, from
  which a re-executed supervisor (``faults.run_job_resilient``) re-adopts
  the live pool by pid;
* bills every invocation's measured lifetime through ``faas_cost``.

The job's device travels in the job dict, so every worker follows it, as
do ``consistency`` (``isp``, or bounded-staleness ``ssp`` with ``slack``,
DESIGN.md §13) and the transport. Not yet ported from the JAX supervisor:
the topology tuner and live re-sharding, and the fleet.

State machine per worker slot::

    spawned -> running -> { done | evicted }          (terminal)
                      \-> invocation-end -> respawn -> running
                      \-> crashed        -> respawn -> running (replay)

(under ``prewarm`` a respawn is the promotion of the held successor).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import random
import secrets
import shutil
import signal
import subprocess
import sys
import time
import warnings
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
    # tuned worker launch env (launch/hostperf.py): thread caps and a
    # tcmalloc LD_PRELOAD when the library is present; what was applied
    # is recorded in the result under 'hostperf'
    hostperf: bool = False
    n_brokers: int = 1
    # worker<->shard data path (DESIGN.md §12): 'tcp' is the persistent
    # loopback socket, 'shm' the supervisor-allocated shared-memory ring
    # segments (same framing, codec and accounted bytes); the
    # supervisor's own control plane always rides TCP
    transport: str = "tcp"
    shard_split_bytes: int = 0
    partitioner: str = "greedy"
    # pre-warmed invocation respawn (DESIGN.md §14.5): each slot's next
    # invocation is spawned gated ahead of its boundary and warms up under
    # the current one; its whole lifetime is billed (a live function)
    prewarm: bool = False
    autotune: bool = False
    tuner: Optional[AutoTunerConfig] = None
    scripted_evict_steps: tuple[int, ...] = ()
    kill_worker_at_step: Optional[tuple[int, int]] = None  # (worker, step)
    kill_broker_at_step: Optional[tuple[int, int]] = None  # (shard, step)
    # the chaos plane (runtime/faults.py, DESIGN.md §17): an expanded
    # FaultPlan spec ({"seed": ..., "events": [...]}); the legacy knobs
    # above compile into the same plan
    chaos: Optional[dict] = None
    rpc: Optional[dict] = None
    poll_interval_s: float = 0.05
    deadline_s: float = 600.0
    pull_deadline_s: float = 120.0
    broker_spawn_timeout_s: float = 30.0
    seed: int = 0

    def compiled_chaos_plan(self) -> Optional[FaultPlan]:
        """The job's fault plan: the explicit ``chaos`` spec merged with
        the legacy one-off knobs, under the spec's seed —
        ``kill_worker_at_step`` / ``kill_broker_at_step`` become supervisor
        kill events and ``straggler`` a repeating ``compute_delay``. None
        when the job injects nothing."""
        plan = FaultPlan.from_spec(self.chaos)
        events = list(plan.events) if plan is not None else []
        seed = plan.seed if plan is not None else 0
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
        return FaultPlan(seed=seed, events=tuple(events)).validate()

    def to_dict(self) -> dict:
        """JSON form for the out-of-process supervisor
        (``faults.run_job_resilient``); inverse of ``from_dict``."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "FaaSJobConfig":
        """Rebuild a config from ``to_dict``'s JSON: the tuner back into
        an ``AutoTunerConfig`` and JSON lists back into tuples (the kill
        knobs are compared as tuples)."""
        d = dict(d)
        if d.get("tuner"):
            d["tuner"] = AutoTunerConfig(**d["tuner"])
        d["scripted_evict_steps"] = tuple(d.get("scripted_evict_steps") or ())
        for k in ("kill_worker_at_step", "kill_broker_at_step"):
            if d.get(k) is not None:
                d[k] = tuple(d[k])
        return cls(**d)

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


def _pid_alive(pid: Optional[int]) -> bool:
    """Liveness from /proc, which also works for an adopted process (not
    our child, so no waitpid). A zombie counts as dead: its exit status
    belongs to init, and it will never publish again."""
    if not pid:
        return False
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[-1].split()[0] != "Z"
    except OSError:
        return False


def _terminate_pid(pid: int, grace_s: float = 5.0) -> None:
    """SIGTERM an adopted (non-child) process, escalating to SIGKILL."""
    try:
        os.kill(pid, signal.SIGTERM)
    except OSError:
        return
    deadline = time.monotonic() + grace_s
    while _pid_alive(pid) and time.monotonic() < deadline:
        time.sleep(0.05)
    if _pid_alive(pid):
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass


class _Process:
    """The current process of a slot or shard: a child spawned here
    (``proc``) or one adopted from a journal (``adopted_pid``: not our
    child, so its liveness comes from /proc, never waitpid)."""

    proc: Optional[subprocess.Popen]
    adopted_pid: Optional[int]

    @property
    def alive(self) -> bool:
        if self.proc is not None:
            return self.proc.poll() is None
        return _pid_alive(self.adopted_pid)

    @property
    def exited(self) -> bool:
        if self.proc is not None:
            return self.proc.poll() is not None
        return self.adopted_pid is not None and not _pid_alive(
            self.adopted_pid)

    @property
    def pid(self) -> Optional[int]:
        return self.proc.pid if self.proc is not None else self.adopted_pid

    def sigkill(self) -> None:
        if self.proc is not None:
            if self.proc.poll() is None:
                self.proc.send_signal(signal.SIGKILL)
        elif self.adopted_pid is not None:
            try:
                os.kill(self.adopted_pid, signal.SIGKILL)
            except OSError:
                pass

    def wait_dead(self, timeout_s: float = 10.0) -> None:
        """Wait until the (killed) process is gone."""
        if self.proc is not None:
            self.proc.wait(timeout=timeout_s)
            return
        deadline = time.monotonic() + timeout_s
        while _pid_alive(self.adopted_pid) and time.monotonic() < deadline:
            time.sleep(0.01)


@dataclasses.dataclass
class _Slot(_Process):
    """One logical worker (survives respawns; one proc per invocation)."""

    worker: int
    proc: Optional[subprocess.Popen] = None
    adopted_pid: Optional[int] = None
    spawned_at: float = 0.0
    # adopted from a journal with its process already gone: it ended
    # while no supervisor ran
    ended_headless: bool = False
    invocations: int = 0
    terminal: Optional[str] = None  # 'done' | 'evicted'
    # first training step of the current invocation (restored + 1): the
    # prewarm trigger predicts the boundary from it
    inv_start: int = 1
    # shm transport: this invocation's per-shard segment names (fresh per
    # invocation, the shm analogue of a new connection per invocation)
    shm_segs: list = dataclasses.field(default_factory=list)
    # the pre-warmed next invocation (cfg.prewarm): a live process holding
    # at its gate, with its own segments. Its times are monotonic; the
    # ready time is the supervisor's first sighting of '<gate>.ready'
    pre_proc: Optional[subprocess.Popen] = None
    pre_gate: Optional[str] = None
    pre_spawned_mono: float = 0.0
    pre_ready_mono: float = 0.0
    pre_shm_segs: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _BrokerShard(_Process):
    """One update-store shard (survives respawns at a pinned port)."""

    shard: int
    proc: Optional[subprocess.Popen] = None
    adopted_pid: Optional[int] = None
    addr: Optional[tuple[str, int]] = None
    spawns: int = 0


class Supervisor:
    def __init__(self, cfg: FaaSJobConfig, *, allow_self_kill: bool = False,
                 resume: bool = False):
        if cfg.transport not in ("tcp", "shm"):
            raise ValueError(
                f"transport must be 'tcp' or 'shm', got {cfg.transport!r}")
        if cfg.consistency not in ("isp", "ssp"):
            raise ValueError(f"consistency must be 'isp' or 'ssp', got "
                             f"{cfg.consistency!r}")
        if cfg.consistency == "ssp" and cfg.slack < 0:
            raise ValueError(f"slack must be >= 0, got {cfg.slack}")
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
            if (any(e.kind == "supervisor_kill" for e in self.plan.events)
                    and not allow_self_kill):
                raise ValueError(
                    "a supervisor_kill fault needs the out-of-process "
                    "runner (faults.run_job_resilient): an in-process "
                    "supervisor cannot survive killing itself")
        self._resume = resume
        # the journal only pays for itself when a successor could read it
        self._journal_enabled = allow_self_kill or resume
        self._resumed = 0
        self._chaos_fired: set[int] = set()
        self._chaos_pending: list[dict] = []
        self.chaos_events: list[dict] = []
        self._wal_quarantined = 0
        self.cfg = cfg
        self.rpc_policy = RetryPolicy.from_dict(cfg.rpc)
        self._t_job0 = time.monotonic()
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
        self.cold_start_overlaps: list[dict] = []
        self.evictions: dict[int, int] = {}
        self.bye_launches: dict[str, dict[str, int]] = {}
        # each worker's last goodbye, wall clock (the coordinator keeps it)
        self.bye_wall: dict[str, float] = {}
        # a resumed supervisor: its predecessor's death, wall clock
        self._killed_wall: Optional[float] = None
        self._frontier = 0
        self._poll_since = 1
        # the longest cold start seen: the pool's first wait for telemetry
        # and every successor's warm-up (None until one is measured)
        self._cold_s: Optional[float] = None
        self._scripted_fired = 0
        self._stopping = False
        # shm transport: a job-unique segment namespace and the live
        # segments (the supervisor alone creates and unlinks them)
        self._shm_token = f"ml{os.getpid():x}{secrets.token_hex(2)}"
        self._shm_segments: dict[str, Any] = {}  # name -> wire.shm.Segment
        self.hostperf_applied: Optional[dict] = None
        if cfg.hostperf:
            from repro_torch.launch import hostperf

            self.hostperf_applied = hostperf.describe(self._worker_env())
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
        if self.cfg.hostperf:
            from repro_torch.launch import hostperf

            return hostperf.build_env(env, threads=1)
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
        bs.adopted_pid = None
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
            if bs.exited:
                self.broker_respawns.append({
                    "shard": bs.shard,
                    # adopted: init reaped the status
                    "exit_code": (bs.proc.returncode if bs.proc is not None
                                  else None),
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

    def _unlink_segments(self, names: list) -> None:
        from repro_torch.wire import shm

        for name in names:
            seg = self._shm_segments.pop(name, None)
            if seg is not None:
                seg.unlink()
            else:  # a dead predecessor's segment (resume)
                shm.Segment.unlink_by_name(name)

    def _teardown_worker_shm(self, slot: _Slot) -> None:
        self._unlink_segments(slot.shm_segs)
        slot.shm_segs = []

    def _serve_segments(self, slot: _Slot) -> tuple[str, list]:
        """Fresh segments named for the slot's next invocation, each served
        by its shard; returns the base name (shard s attaches
        '<base>s<s>') and the names."""
        from repro_torch.wire import shm

        base = f"{self._shm_token}w{slot.worker}i{slot.invocations}"
        names = [f"{base}s{s}" for s in range(len(self.shards))]
        for name in names:
            self._shm_segments[name] = shm.Segment.create(
                name, ring_bytes=SHM_RING_BYTES)
        for s, name in enumerate(names):
            resp, _ = self._rpc({"t": "shm_serve", "seg": name}, shard=s)
            if not resp.get("ok"):
                raise RuntimeError(f"shard {s} refused shm_serve: {resp}")
        return base, names

    def _setup_worker_shm(self, slot: _Slot) -> str:
        self._teardown_worker_shm(slot)
        base, slot.shm_segs = self._serve_segments(slot)
        return base

    def _reserve_shard_shm(self, bs: _BrokerShard) -> None:
        """After a shard respawn: serve every live worker's segment for
        this shard again (a held successor's too). One-shot RPCs to the
        just-bound port: this runs inside ``_rpc``'s retry path and must
        not recurse into it."""
        for slot in self.slots:
            if slot.terminal is not None:
                continue
            for segs in (slot.shm_segs, slot.pre_shm_segs):
                if not segs:
                    continue
                for attempt in range(3):
                    try:
                        protocol.request(
                            bs.addr, {"t": "shm_serve", "seg": segs[bs.shard]},
                            timeout=10.0)
                        break
                    except (ConnectionError, OSError, TimeoutError):
                        if attempt == 2:
                            # workers ride it out: their shm connect wait
                            # and RPC retries outlast the next reap cycle
                            break
                        time.sleep(0.2)

    def _worker_cmd(self, slot: _Slot, shm_base: Optional[str],
                    gate: Optional[str] = None) -> list:
        brokers = ",".join(f"{h}:{p}" for h, p in
                           (bs.addr for bs in self.shards))
        cmd = [sys.executable, "-m", "repro_torch.runtime.worker",
               "--brokers", brokers, "--worker-id", str(slot.worker)]
        if gate is not None:
            cmd += ["--prewarm-gate", gate]
        if shm_base is not None:
            cmd += ["--transport", "shm", "--shm-seg", shm_base]
        return cmd

    def _popen_worker(self, cmd: list, log_name: str) -> subprocess.Popen:
        logdir = os.path.join(self.cfg.run_dir, "logs")
        os.makedirs(logdir, exist_ok=True)
        with open(os.path.join(logdir, log_name), "wb") as log:
            return subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                    env=self._worker_env())

    def _spawn(self, slot: _Slot) -> None:
        base = (self._setup_worker_shm(slot)
                if self.cfg.transport == "shm" else None)
        slot.adopted_pid = None
        slot.proc = self._popen_worker(
            self._worker_cmd(slot, base),
            f"w{slot.worker:03d}.inv{slot.invocations:03d}.log")
        slot.spawned_at = time.monotonic()
        slot.invocations += 1
        slot.inv_start = self._restored_step(slot) + 1

    def _ckpt_dir(self, worker: int) -> str:
        return os.path.join(self.cfg.run_dir, "ckpt", f"w{worker:03d}")

    def _restored_step(self, slot: _Slot) -> int:
        from repro_torch.checkpoint import store as ckpt

        return ckpt.latest_step(self._ckpt_dir(slot.worker)) or 0

    # -- pre-warmed respawn (DESIGN.md §14.5) ----------------------------------

    def _prespawn(self, slot: _Slot) -> None:
        """Spawn the slot's next invocation gated: it imports torch, opens
        the CUDA context, loads and launches the kernels once and then
        holds at ``pre_gate``, so its cold start runs under the current
        invocation instead of inside the respawn stall."""
        gatedir = os.path.join(self.cfg.run_dir, "gate")
        os.makedirs(gatedir, exist_ok=True)
        gate = os.path.join(
            gatedir, f"w{slot.worker:03d}.inv{slot.invocations:03d}.gate")
        for p in (gate, gate + ".ready"):
            if os.path.exists(p):
                os.unlink(p)
        base = None
        if self.cfg.transport == "shm":
            # the next invocation's family, beside the live one
            base, slot.pre_shm_segs = self._serve_segments(slot)
        slot.pre_proc = self._popen_worker(
            self._worker_cmd(slot, base, gate=gate),
            f"w{slot.worker:03d}.inv{slot.invocations:03d}.pre.log")
        slot.pre_gate = gate
        slot.pre_spawned_mono = time.monotonic()
        slot.pre_ready_mono = 0.0

    def _scan_prewarm_ready(self) -> None:
        """Stamp the first monotonic sighting of each held successor's
        '.ready' marker (never a file mtime from the wall-clock domain).
        Its warm-up is a measured cold start for ``_prewarm_due``."""
        for slot in self.slots:
            if (slot.pre_proc is not None and slot.pre_gate is not None
                    and slot.pre_ready_mono == 0.0
                    and os.path.exists(slot.pre_gate + ".ready")):
                slot.pre_ready_mono = time.monotonic()
                warmup = slot.pre_ready_mono - slot.pre_spawned_mono
                self._cold_s = max(self._cold_s or 0.0, warmup)

    def _promote_prewarmed(self, slot: _Slot) -> None:
        """The current invocation ended and a successor holds at its gate:
        open the gate and make it the invocation. Records the overlap: the
        successor's warm-up seconds that ran under the previous invocation
        (up to its ready sighting, or all it had so far when not ready)."""
        self._scan_prewarm_ready()
        warm = slot.pre_ready_mono > 0.0
        end = slot.pre_ready_mono if warm else time.monotonic()
        overlap = end - slot.pre_spawned_mono
        if overlap < 0.0:
            warnings.warn(
                f"negative prewarm overlap ({overlap:.3f}s) for worker "
                f"{slot.worker}; clamping to 0", stacklevel=2)
            overlap = 0.0
        self.cold_start_overlaps.append({
            "worker": slot.worker, "invocation": slot.invocations,
            "overlap_s": overlap, "ready_at_promotion": warm})
        # open the gate (atomic create): the held process restores the
        # newest checkpoint, written by the invocation that just exited
        tmp = slot.pre_gate + ".tmp"
        with open(tmp, "w"):
            pass
        os.replace(tmp, slot.pre_gate)
        self._teardown_worker_shm(slot)
        slot.shm_segs, slot.pre_shm_segs = slot.pre_shm_segs, []
        slot.proc = slot.pre_proc
        slot.adopted_pid = None
        slot.spawned_at = slot.pre_spawned_mono
        slot.pre_proc = None
        slot.pre_gate = None
        slot.invocations += 1
        slot.inv_start = self._restored_step(slot) + 1

    def _abort_prewarmed(self, slot: _Slot) -> None:
        """Kill a held successor that will not be used and bill its (real,
        live-function) lifetime."""
        if slot.pre_proc is None:
            return
        if slot.pre_proc.poll() is None:
            slot.pre_proc.kill()
            slot.pre_proc.wait()
        self.lifetimes.append(time.monotonic() - slot.pre_spawned_mono)
        slot.pre_proc = None
        slot.pre_gate = None
        self._unlink_segments(slot.pre_shm_segs)
        slot.pre_shm_segs = []

    def _prewarm_due(self, boundary: int) -> bool:
        """Is the boundary at most one cold start away? Steps and cold
        starts are measured on the job itself: a step's mean ``dur_s``,
        and the longest of the first wait for telemetry after the pool
        spawned and every successor's warm-up. Until both are measured
        the boundary is taken to be near: on the card a cold start (torch
        import, CUDA context, kernel load) takes seconds and a step tens
        of milliseconds, so a successor spawned one step ahead (JAX's
        lead) would hide almost none of it. A step ahead is always due, as
        in JAX."""
        if self._frontier >= boundary - 1 or self._cold_s is None:
            return True
        durs = [r["dur_s"] for r in self.history[-8:] if r.get("dur_s")]
        if not durs:
            return True
        step_s = sum(durs) / len(durs)
        return (boundary - self._frontier) * step_s <= self._cold_s

    def _maybe_prespawn(self) -> None:
        """Spawn a gated successor for every running slot whose invocation
        boundary is due (``_prewarm_due``) and that has none yet."""
        if not self.cfg.prewarm:
            return
        for slot in self.slots:
            if (slot.terminal is not None or not slot.alive
                    or slot.pre_proc is not None
                    or slot.worker in self.evictions):
                continue
            boundary = slot.inv_start + self.cfg.invocation_steps - 1
            if boundary >= self.cfg.total_steps:
                # final invocation: it ends 'done', nothing follows it
                continue
            if self._prewarm_due(boundary):
                self._prespawn(slot)

    def _reap(self, slot: _Slot, statuses: dict) -> None:
        """Classify an exited process and respawn when the slot lives on."""
        status = statuses.get(str(slot.worker), "")
        self.lifetimes.append(self._ended_at(slot, status) - slot.spawned_at)
        # an adopted process was reaped by init: no exit code to read
        code = slot.proc.returncode if slot.proc is not None else None
        slot.proc = None
        slot.adopted_pid = None
        slot.ended_headless = False
        held = slot.pre_proc is not None and slot.pre_proc.poll() is None
        if status in ("bye:done", "bye:evicted"):
            slot.terminal = status[len("bye:"):]
            self._teardown_worker_shm(slot)
            self._abort_prewarmed(slot)
            return
        if status != "bye:invocation-end":
            # no goodbye: the process died — respawn; it restores its
            # newest checkpoint and replays forward. A held successor is
            # as good a respawn: it restores only after its gate opens
            self.respawns.append({
                "worker": slot.worker, "exit_code": code,
                "restored_step": self._restored_step(slot),
                "at_frontier": self._frontier})
        if held:
            self._promote_prewarmed(slot)
        else:
            self._abort_prewarmed(slot)
            self._spawn(slot)

    def _ended_at(self, slot: _Slot, status: str) -> float:
        """When the slot's exited process ended, on the monotonic clock: now
        for a child (its exit is seen within a poll). An adopted process may
        have ended while no supervisor ran: it is billed to its goodbye's
        wall time, or, when it said none, to its supervisor's death."""
        now_m = time.monotonic()
        if slot.proc is not None:
            return now_m
        t_wall = None
        if status.startswith("bye:"):
            t_wall = self.bye_wall.get(str(slot.worker))
        if t_wall is None and slot.ended_headless:
            t_wall = self._killed_wall
        if t_wall is None:
            return now_m
        ended = now_m - (time.time() - t_wall)
        # a goodbye older than the spawn was the previous invocation's
        return now_m if ended < slot.spawned_at else min(ended, now_m)

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
            if not self.history and self._cold_s is None:
                # the pool's first telemetry: one cold start and a step
                self._cold_s = time.monotonic() - self._t_job0
            self.history.append(row)
            self._poll_since = row["step"] + 1
            self._frontier = max(self._frontier, row["step"])
            if self.tuner is not None:
                self.tuner.observe(row["step"], row["loss"], row["dur_s"])
        self.evictions = {int(k): v for k, v in resp["evictions"].items()}
        self.bye_launches = resp.get("bye_launches", self.bye_launches)
        self.bye_wall = resp.get("bye_wall", self.bye_wall)
        return resp

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

    # -- chaos plane (runtime/faults.py, DESIGN.md §17) ------------------------

    def _chaos_step(self) -> None:
        """Fire due supervisor-side fault events, then settle in-flight
        recoveries (a fault's ``recovery_s`` closes when the supervisor
        sees the victim back: worker respawned, shard rebound). A due
        ``supervisor_kill`` fires in a poll of its own: when another event
        is due in the same poll, it waits for the next one, so the other
        fault's victims are not left with no supervisor at all."""
        if self.plan is not None:
            due = [(idx, e) for idx, e in enumerate(self.plan.events)
                   if e.kind in SUPERVISOR_KINDS
                   and idx not in self._chaos_fired
                   and self._frontier >= e.step]
            others = [(idx, e) for idx, e in due
                      if e.kind != "supervisor_kill"]
            for idx, e in others or due:
                self._chaos_fired.add(idx)
                self._inject(idx, e)
        self._settle_chaos()

    def _inject(self, idx: int, e: FaultEvent) -> None:
        rec = {"index": idx, "kind": e.kind, "step": e.step,
               "at_frontier": self._frontier}
        if e.kind == "worker_kill":
            slot = self.slots[e.worker]
            rec["worker"] = e.worker
            if slot.terminal is not None or not slot.alive:
                rec["skipped"] = "victim not running"
                self.chaos_events.append(rec)
                return
            slot.sigkill()
            self._chaos_pending.append(
                {"rec": rec, "t0": time.monotonic(), "kind": e.kind,
                 "worker": e.worker, "invocations": slot.invocations})
        elif e.kind in ("broker_kill", "wal_corrupt"):
            bs = self.shards[e.shard]
            rec["shard"] = e.shard
            if not bs.alive:
                rec["skipped"] = "shard not running"
                self.chaos_events.append(rec)
                return
            bs.sigkill()
            if e.kind == "wal_corrupt":
                rec["flipped_offset"] = self._flip_wal_byte(e.shard, idx)
            self._chaos_pending.append(
                {"rec": rec, "t0": time.monotonic(), "kind": e.kind,
                 "shard": e.shard, "spawns": bs.spawns})
        elif e.kind == "supervisor_kill":
            # journal first (chaos_fired already holds this index, so the
            # successor will not fire it again), then die for real: no
            # cleanup, no goodbye; the pool runs on headless until the
            # next supervisor re-adopts it from the journal
            rec["killed_at_wall"] = time.time()
            self.chaos_events.append(rec)
            self._save_journal()
            os.kill(os.getpid(), signal.SIGKILL)

    def _flip_wal_byte(self, shard: int, idx: int) -> Optional[int]:
        """Flip one seeded byte in the tail third of a (just-killed)
        shard's WAL; the respawn's CRC check quarantines from there."""
        path = os.path.join(self._broker_dir(), f"shard{shard:02d}.wal")
        try:
            size = os.path.getsize(path)
        except OSError:
            return None
        if size == 0:
            return None
        rng = random.Random((self.plan.seed << 8) ^ (0x5A5A + idx))
        pos = rng.randrange(size - max(size // 3, 1), size)
        with open(path, "r+b") as f:
            f.seek(pos)
            b = f.read(1)
            f.seek(pos)
            f.write(bytes([b[0] ^ 0xFF]))
            f.flush()
            os.fsync(f.fileno())
        return pos

    def _settle_chaos(self) -> None:
        still = []
        for p in self._chaos_pending:
            rec = p["rec"]
            if p["kind"] == "worker_kill":
                slot = self.slots[p["worker"]]
                done = slot.terminal is not None or (
                    slot.invocations > p["invocations"] and slot.alive)
            else:  # broker_kill / wal_corrupt: settled once rebound
                bs = self.shards[p["shard"]]
                done = bs.spawns > p["spawns"] and bs.alive
                if done and p["kind"] == "wal_corrupt":
                    rec["rollback"] = self._quarantine_rollback(
                        p["shard"], rec)
            if done:
                rec["recovery_s"] = time.monotonic() - p["t0"]
                self.chaos_events.append(rec)
            else:
                still.append(p)
        self._chaos_pending = still

    def _prune_checkpoints(self, worker: int, limit: int) -> list[int]:
        from repro_torch.checkpoint import store as ckpt

        d = self._ckpt_dir(worker)
        pruned = []
        for step in ckpt.all_steps(d):
            if step > limit:
                shutil.rmtree(os.path.join(d, f"step_{step:010d}"),
                              ignore_errors=True)
                pruned.append(step)
        return pruned

    def _quarantine_rollback(self, shard: int, rec: dict) -> list[dict]:
        """Reconcile the pool with a shard that lost a WAL suffix.

        The respawned shard's per-worker publish ``clocks`` are its durable
        frontier: anything a worker published past its clock on this shard
        is gone (quarantined, or silently torn off when the flip hit a
        length field of the final record, which is why this runs after
        every wal_corrupt injection). Every non-terminal worker rolls back
        to that frontier: SIGKILLed, its checkpoints past the clock
        pruned, so the crash-respawn path replays forward and publishes
        the lost records again bit for bit (the other shards dup-check
        them). The workers die before the prune, so no checkpoint past
        the clock lands after it (JAX prunes first). The bytes the shard
        quarantined are recorded on ``rec`` and summed into the result's
        ``wal_quarantined_bytes``."""
        bs = self.shards[shard]
        try:
            resp, _ = protocol.request(
                bs.addr, {"t": "poll", "since": self.cfg.total_steps + 1},
                timeout=10.0)
        except (ConnectionError, OSError, TimeoutError):
            return []  # shard died again; the next reap cycle recovers
        rec["quarantined_bytes"] = int(resp.get("wal_quarantined", 0))
        self._wal_quarantined += rec["quarantined_bytes"]
        clocks = {int(k): v for k, v in (resp.get("clocks") or {}).items()}
        victims = [slot for slot in self.slots if slot.terminal is None]
        for slot in victims:
            slot.sigkill()
        for slot in victims:
            slot.wait_dead()
        return [{"worker": slot.worker,
                 "replay_from": clocks.get(slot.worker, 0),
                 "pruned_ckpts": self._prune_checkpoints(
                     slot.worker, clocks.get(slot.worker, 0))}
                for slot in victims]

    # -- crash journal and re-adoption (DESIGN.md §17.4) -----------------------

    def _journal_path(self) -> str:
        return os.path.join(self.cfg.run_dir, "supervisor.journal.json")

    def _save_journal(self) -> None:
        """Atomically persist what a successor supervisor needs to re-adopt
        the live pool: pids, ports, invocation counters and the billing
        and telemetry accumulators. Monotonic times are stored as wall
        clock, for the successor to rebase onto its own monotonic clock.
        JAX's schema without the topology fields."""
        if not self._journal_enabled:
            return
        now_m, now_w = time.monotonic(), time.time()

        def wall(t_mono: float) -> Optional[float]:
            return now_w - (now_m - t_mono) if t_mono else None

        state = {
            "version": 1,
            "t_job0_wall": wall(self._t_job0),
            "shm_token": self._shm_token,
            "shards": [
                {"shard": bs.shard,
                 "addr": list(bs.addr) if bs.addr else None,
                 "pid": bs.pid, "spawns": bs.spawns}
                for bs in self.shards
            ],
            "slots": [
                {"worker": s.worker, "pid": s.pid,
                 "invocations": s.invocations, "terminal": s.terminal,
                 "inv_start": s.inv_start,
                 "spawned_wall": wall(s.spawned_at),
                 "shm_segs": list(s.shm_segs),
                 "pre_pid": (s.pre_proc.pid if s.pre_proc is not None
                             else None),
                 "pre_spawned_wall": (wall(s.pre_spawned_mono)
                                      if s.pre_proc is not None else None),
                 "pre_shm_segs": list(s.pre_shm_segs)}
                for s in self.slots
            ],
            "lifetimes": self.lifetimes,
            "evictions": self.evictions,
            "scale_events": self.scale_events,
            "respawns": self.respawns,
            "broker_respawns": self.broker_respawns,
            "cold_start_overlaps": self.cold_start_overlaps,
            "scripted_fired": self._scripted_fired,
            "chaos_fired": sorted(self._chaos_fired),
            "chaos_events": self.chaos_events,
            # recoveries in flight: a kill fired in the same poll as the
            # supervisor's own settles under the successor
            "chaos_pending": [
                {**{k: v for k, v in p.items() if k != "t0"},
                 "t0_wall": wall(p["t0"])}
                for p in self._chaos_pending
            ],
            "wal_quarantined": self._wal_quarantined,
            "resumed": self._resumed,
        }
        tmp = self._journal_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._journal_path())

    def _resume_from_journal(self) -> bool:
        """Re-adopt a previous supervisor's pool from its journal.

        Live brokers and workers are adopted by pid (they ran on headless
        and never noticed the change of management); a dead shard respawns
        through WAL replay. A worker whose process ended while headless is
        adopted too and reaped by the main loop like any exit, from the
        coordinator's status: an invocation end, a crash or the job's end
        (JAX respawns each as a crash, and bills none of their lifetimes);
        its lifetime ends at its goodbye, or at the predecessor's death.
        A successor held at its gate is killed and its lifetime billed.
        Telemetry is polled again from step 1 (the coordinator keeps it
        all), so the history is the same."""
        path = self._journal_path()
        if not self._resume or not os.path.exists(path):
            return False
        with open(path) as f:
            st = json.load(f)
        now_m, now_w = time.monotonic(), time.time()

        def mono(t_wall: Optional[float]) -> float:
            return now_m - (now_w - t_wall) if t_wall else 0.0

        self._t_job0 = mono(st["t_job0_wall"])
        self._shm_token = st["shm_token"]
        self.lifetimes = st["lifetimes"]
        self.evictions = {int(k): v for k, v in st["evictions"].items()}
        self.scale_events = st["scale_events"]
        self.respawns = st["respawns"]
        self.broker_respawns = st["broker_respawns"]
        self.cold_start_overlaps = st["cold_start_overlaps"]
        self._scripted_fired = st["scripted_fired"]
        self._chaos_fired = set(st["chaos_fired"])
        self.chaos_events = st["chaos_events"]
        self._chaos_pending = [
            {**{k: v for k, v in p.items() if k != "t0_wall"},
             "t0": mono(p["t0_wall"])}
            for p in st["chaos_pending"]
        ]
        self._wal_quarantined = st["wal_quarantined"]
        self._resumed = st["resumed"] + 1
        self._killed_wall = max(
            (rec["killed_at_wall"] for rec in self.chaos_events
             if rec.get("kind") == "supervisor_kill"), default=None)
        adopted_b = adopted_w = killed = 0
        self.shards = []
        self._conns = []
        for js in st["shards"]:
            bs = _BrokerShard(shard=js["shard"], spawns=js["spawns"])
            bs.addr = tuple(js["addr"]) if js["addr"] else None
            if _pid_alive(js["pid"]):
                bs.adopted_pid = js["pid"]
                adopted_b += 1
            self.shards.append(bs)
            self._conns.append(None)
        for bs in self.shards:
            if not bs.alive:  # spawns > 0: the WAL replays before binding
                self.broker_respawns.append({
                    "shard": bs.shard, "exit_code": None,
                    "at_frontier": self._frontier, "resume_orphan": True})
                self._spawn_broker(bs)
        self.slots = []
        for js in st["slots"]:
            s = _Slot(worker=js["worker"], invocations=js["invocations"],
                      terminal=js["terminal"], inv_start=js["inv_start"],
                      spawned_at=mono(js["spawned_wall"]),
                      shm_segs=list(js["shm_segs"]))
            if js["terminal"] is None:
                s.adopted_pid = js["pid"]
                s.ended_headless = not _pid_alive(js["pid"])
                adopted_w += not s.ended_headless
            if js["pre_pid"] is not None:
                # billed to now when killed here, else to the death of
                # the supervisor that held it
                ended = now_m
                if _pid_alive(js["pre_pid"]):
                    try:
                        os.kill(js["pre_pid"], signal.SIGKILL)
                        killed += 1
                    except OSError:
                        pass
                elif self._killed_wall is not None:
                    ended = mono(self._killed_wall)
                self.lifetimes.append(ended - mono(js["pre_spawned_wall"]))
                self._unlink_segments(js["pre_shm_segs"])
            self.slots.append(s)
        # stamp the recovery on the kill that took the predecessor down
        for rec in self.chaos_events:
            if rec.get("kind") == "supervisor_kill" \
                    and "recovery_s" not in rec:
                rec["recovery_s"] = now_w - rec["killed_at_wall"]
                rec["readopted"] = {"workers": adopted_w,
                                    "brokers": adopted_b,
                                    "successors_killed": killed}
        self._poll_since = 1
        self._frontier = 0
        return True

    # -- main loop ------------------------------------------------------------

    def run(self) -> dict:
        cfg = self.cfg
        os.makedirs(cfg.run_dir, exist_ok=True)
        self._t_job0 = time.monotonic()
        try:
            if not self._resume_from_journal():
                self._start_brokers()
                for slot in self.slots:
                    self._spawn(slot)
            self._save_journal()
            deadline = self._t_job0 + cfg.deadline_s
            while True:
                time.sleep(cfg.poll_interval_s)
                self._reap_brokers()
                statuses = self._poll()["statuses"]
                # seeded fault injection: SIGKILLs, WAL corruption, the
                # supervisor's own death
                self._chaos_step()
                for slot in self.slots:
                    if slot.terminal is None and slot.exited:
                        # refresh statuses so a just-sent bye is not
                        # misread as a crash
                        statuses = self._poll()["statuses"]
                        self._reap(slot, statuses)
                self._maybe_prespawn()
                self._scan_prewarm_ready()
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
                self._save_journal()
                if all(s.terminal is not None for s in self.slots):
                    self._poll()
                    break
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"FaaS job deadline ({cfg.deadline_s}s) exceeded at "
                        f"frontier {self._frontier}; statuses={statuses}; "
                        f"logs in {os.path.join(cfg.run_dir, 'logs')}")
            # a fault whose recovery the job's end beat to the punch
            for p in self._chaos_pending:
                p["rec"]["recovery_s"] = None
                self.chaos_events.append(p["rec"])
            self._chaos_pending = []
            self._stopping = True
            shard_stats = [self._rpc({"t": "shutdown"}, shard=s)[0]
                           for s in range(len(self.shards))]
            # clean completion: the journal has nothing left to recover
            if self._journal_enabled and os.path.exists(self._journal_path()):
                os.unlink(self._journal_path())
        finally:
            for slot in self.slots:
                if slot.alive:
                    slot.sigkill()
                    if slot.proc is not None:
                        slot.proc.wait()
                if slot.pre_proc is not None and slot.pre_proc.poll() is None:
                    slot.pre_proc.kill()
                    slot.pre_proc.wait()
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
                elif bs.adopted_pid is not None and _pid_alive(bs.adopted_pid):
                    _terminate_pid(bs.adopted_pid)
            # the supervisor owns every shm segment: none may outlive the
            # job (they are named host-global resources, not fds)
            for seg in self._shm_segments.values():
                seg.unlink()
            self._shm_segments.clear()
        wall = time.monotonic() - self._t_job0
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
            # what launch/hostperf.py applied (None when off; tcmalloc None
            # inside when the library is absent)
            "hostperf": self.hostperf_applied,
            "invariant_max_err": max((r["inv_err"] for r in hist),
                                     default=0.0),
            "wire_bytes_total": sum(r["wire_bytes"] for r in hist),
            "scale_events": self.scale_events,
            "respawns": self.respawns,
            "n_respawns": len(self.respawns),
            "broker_respawns": self.broker_respawns,
            # prewarm: the successors' warm-up seconds that ran under the
            # previous invocation
            "cold_start_overlaps": self.cold_start_overlaps,
            "n_invocations": len(self.lifetimes),
            "lifetimes_s": list(self.lifetimes),
            "dup_mismatches": sum(int(r.get("dup_mismatches", 0))
                                  for r in shard_stats),
            # the chaos plane: what fired, how long each recovery took, and
            # what the WAL CRC checks dropped
            "chaos": None if self.plan is None else self.plan.to_spec(),
            # the supervisor's faults, then the workers' as their step
            # reports carried them (recovery: until the next report)
            "chaos_events": self.chaos_events + [
                dict(f, worker=int(w)) for r in hist
                for w, fired in (r.get("faults_by_worker") or {}).items()
                for f in fired],
            "wal_quarantined_bytes": self._wal_quarantined,
            "supervisor_resumed": self._resumed,
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


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", default="pmf",
                    choices=workload_lib.WORKLOAD_NAMES)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--invocation-steps", type=int, default=1_000_000)
    ap.add_argument("--n-brokers", type=int, default=1)
    ap.add_argument("--transport", default="tcp", choices=("tcp", "shm"))
    ap.add_argument("--consistency", default="isp", choices=("isp", "ssp"))
    ap.add_argument("--slack", type=int, default=3)
    ap.add_argument("--autotune", action="store_true")
    ap.add_argument("--prewarm", action="store_true")
    ap.add_argument("--run-dir", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--config", default=None,
                    help="JSON FaaSJobConfig (from_dict); overrides the "
                    "per-field job flags")
    ap.add_argument("--resume", action="store_true",
                    help="re-adopt a previous supervisor's pool from its "
                    "journal when one exists in the run directory")
    ap.add_argument("--allow-self-kill", action="store_true",
                    help="permit a supervisor_kill fault event (only safe "
                    "under a runner that executes the supervisor again)")
    args = ap.parse_args()
    if args.config:
        with open(args.config) as f:
            cfg = FaaSJobConfig.from_dict(json.load(f))
    else:
        if args.run_dir is None:
            ap.error("--run-dir (or --config) is required")
        cfg = FaaSJobConfig(
            run_dir=args.run_dir, workload=args.workload, device=args.device,
            n_workers=args.workers, total_steps=args.steps,
            invocation_steps=args.invocation_steps,
            n_brokers=args.n_brokers, transport=args.transport,
            consistency=args.consistency, slack=args.slack,
            autotune=args.autotune, prewarm=args.prewarm,
        )
    res = Supervisor(cfg, allow_self_kill=args.allow_self_kill,
                     resume=args.resume).run()
    print(json.dumps({k: v for k, v in res.items() if k != "history"},
                     indent=1, default=str))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1, default=str)


if __name__ == "__main__":
    main()
