"""Deterministic seeded fault-injection plane (DESIGN.md §17).

MLLess's cost argument rests on stateless functions recovering cheaply
from the failures serverless makes routine.  PRs 2/4/5/9 proved
bit-identical replay under *hand-placed* SIGKILLs; this module replaces
those one-off knobs (``kill_worker_at_step`` / ``kill_broker_at_step`` /
``straggler``) with one composable mechanism: a ``FaultPlan`` — a seeded
schedule of ``FaultEvent``s — threaded as injection hooks through every
runtime seam:

=================  ==========================================================
kind               seam
=================  ==========================================================
worker_kill        supervisor run loop → SIGKILL the worker process at step N
broker_kill        supervisor run loop → SIGKILL a broker shard at step N
supervisor_kill    supervisor run loop → SIGKILL *itself* (journal replays)
wal_corrupt        supervisor: SIGKILL the shard, flip one seeded byte in
                   its WAL tail, let CRC quarantine + rollback recover
transport_delay    wire client hook: sleep before a send (slow frame)
transport_stall    wire client hook: sleep before a recv (wedged peer)
transport_reset    wire client hook: raise ConnectionError once (the
                   transports' reconnect-and-replay path recovers)
ckpt_enospc        checkpoint store write hook: fail the npz write once
                   (simulated ENOSPC; atomic staging keeps it invisible)
compute_delay      worker step loop: sleep after compute (straggler)
=================  ==========================================================

Everything is deterministic at a fixed seed: ``FaultPlan.randomized``
expands a seed into explicit events once, supervisor-side, and ships
them to workers through ``job_dict`` — a respawned worker or a resumed
supervisor derives the identical plan.  With no plan installed every
hook is a single ``None`` check: the default path stays byte-identical
(``wire_guard``'s chaos-dormancy leg asserts this).

``RetryPolicy`` is the other half of the hardening: one jittered
exponential-backoff-plus-deadline policy replacing the scattered
``timeout=30.0`` / ``tries=8`` literals in the worker/supervisor RPC
paths, configurable via ``FaaSJobConfig.rpc``.
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import time
from dataclasses import dataclass, field, replace
from typing import Iterator, Optional

from repro_torch.wire import framing

# fault kinds executed by the supervisor's run loop
SUPERVISOR_KINDS = ("worker_kill", "broker_kill", "supervisor_kill",
                    "wal_corrupt")
# fault kinds executed inside a worker process (wire / checkpoint / step
# hooks)
WORKER_KINDS = ("transport_delay", "transport_stall", "transport_reset",
                "ckpt_enospc", "compute_delay")
KINDS = SUPERVISOR_KINDS + WORKER_KINDS


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.

    ``step`` is the global training step the event arms at (supervisor
    kinds fire when the pool's max published step reaches it; worker
    kinds fire at the start of local step ``step``).  ``worker`` /
    ``shard`` select the victim where the kind needs one.  ``delay_s``
    parameterises the sleep kinds; ``every`` repeats a compute_delay
    every N steps from ``step`` on (1 = every step); ``op`` optionally
    restricts a transport fault to one RPC op name.
    """

    kind: str
    step: int
    worker: Optional[int] = None
    shard: Optional[int] = None
    delay_s: float = 0.0
    every: int = 0  # 0 = fire once; N>0 = repeat every N steps (compute_delay)
    op: Optional[str] = None

    def validate(self) -> "FaultEvent":
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"known: {KINDS}")
        if self.step < 0:
            raise ValueError(f"fault step must be >= 0: {self}")
        if self.kind in ("worker_kill", "transport_delay",
                         "transport_stall", "transport_reset",
                         "ckpt_enospc", "compute_delay") \
                and self.worker is None:
            raise ValueError(f"{self.kind} needs worker=: {self}")
        if self.kind in ("broker_kill", "wal_corrupt") and self.shard is None:
            raise ValueError(f"{self.kind} needs shard=: {self}")
        if self.kind in ("transport_delay", "transport_stall",
                         "compute_delay") and self.delay_s <= 0:
            raise ValueError(f"{self.kind} needs delay_s > 0: {self}")
        return self

    def to_dict(self) -> dict:
        d = {"kind": self.kind, "step": self.step}
        if self.worker is not None:
            d["worker"] = self.worker
        if self.shard is not None:
            d["shard"] = self.shard
        if self.delay_s:
            d["delay_s"] = self.delay_s
        if self.every:
            d["every"] = self.every
        if self.op is not None:
            d["op"] = self.op
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "FaultEvent":
        return cls(
            kind=str(d["kind"]), step=int(d["step"]),
            worker=None if d.get("worker") is None else int(d["worker"]),
            shard=None if d.get("shard") is None else int(d["shard"]),
            delay_s=float(d.get("delay_s", 0.0)),
            every=int(d.get("every", 0)),
            op=d.get("op"),
        ).validate()


@dataclass(frozen=True)
class FaultPlan:
    """A seeded, fully-explicit schedule of fault events.

    The plan that reaches workers and a resumed supervisor is always the
    *expanded* form — randomization happens exactly once, in
    ``randomized``, so every process derives identical behaviour.
    """

    seed: int = 0
    events: tuple = ()

    def validate(self) -> "FaultPlan":
        for e in self.events:
            e.validate()
        return self

    def to_spec(self) -> dict:
        return {"seed": self.seed,
                "events": [e.to_dict() for e in self.events]}

    @classmethod
    def from_spec(cls, spec: Optional[dict]) -> Optional["FaultPlan"]:
        if spec is None:
            return None
        events = tuple(FaultEvent.from_dict(d)
                       for d in spec.get("events", ()))
        return cls(seed=int(spec.get("seed", 0)), events=events).validate()

    # -- selectors ------------------------------------------------------------

    def supervisor_events(self) -> list:
        return [e for e in self.events if e.kind in SUPERVISOR_KINDS]

    def worker_events(self, worker_id: int) -> list:
        return [e for e in self.events
                if e.kind in WORKER_KINDS and e.worker == worker_id]

    def counts(self) -> dict:
        out: dict = {}
        for e in self.events:
            out[e.kind] = out.get(e.kind, 0) + 1
        return out

    # -- seeded expansion -----------------------------------------------------

    @classmethod
    def randomized(
        cls,
        seed: int,
        n_workers: int,
        n_shards: int,
        total_steps: int,
        kinds: tuple = ("worker_kill", "broker_kill", "wal_corrupt",
                        "transport_stall", "supervisor_kill"),
    ) -> "FaultPlan":
        """Expand a seed into an explicit multi-fault schedule with at
        least one event of every requested kind.

        Event steps land in ``[3, total_steps - 6]`` so every fault has
        steps left in which to recover (a WAL corruption injected while
        a worker is already terminal could never be replayed), and the
        victims/steps/offsets all come from one ``random.Random(seed)``
        stream — the schedule is a pure function of its arguments.
        """
        if total_steps < 12:
            raise ValueError(
                f"randomized fault plans need total_steps >= 12 "
                f"(got {total_steps}) so every fault can recover")
        rng = random.Random(seed)
        lo, hi = 3, total_steps - 6
        events = []
        for kind in kinds:
            step = rng.randrange(lo, hi + 1)
            if kind in ("worker_kill", "ckpt_enospc"):
                events.append(FaultEvent(kind, step,
                                         worker=rng.randrange(n_workers)))
            elif kind in ("broker_kill", "wal_corrupt"):
                events.append(FaultEvent(kind, step,
                                         shard=rng.randrange(n_shards)))
            elif kind in ("transport_delay", "transport_stall"):
                events.append(FaultEvent(
                    kind, step, worker=rng.randrange(n_workers),
                    delay_s=round(0.2 + 0.8 * rng.random(), 3)))
            elif kind == "transport_reset":
                events.append(FaultEvent(kind, step,
                                         worker=rng.randrange(n_workers)))
            elif kind == "compute_delay":
                events.append(FaultEvent(
                    kind, step, worker=rng.randrange(n_workers),
                    delay_s=round(0.1 + 0.4 * rng.random(), 3), every=2))
            elif kind == "supervisor_kill":
                events.append(FaultEvent(kind, step))
            else:
                raise ValueError(f"unknown fault kind {kind!r}")
        events.sort(key=lambda e: (e.step, e.kind))
        return cls(seed=seed, events=tuple(events)).validate()


def parse_chaos_arg(arg: str, n_workers: int, n_shards: int,
                    total_steps: int) -> FaultPlan:
    """Parse the train driver's ``--chaos SEED:JSON`` flag.

    ``SEED:auto`` expands the seed into the default randomized multi-
    fault schedule; ``SEED:[{...}, ...]`` is an explicit event list.
    Malformed input raises SystemExit (mirrors ``--retune`` parsing).
    """
    try:
        seed_s, _, rest = arg.partition(":")
        seed = int(seed_s)
        if not rest:
            raise ValueError("missing event spec after ':'")
        if rest == "auto":
            return FaultPlan.randomized(seed, n_workers, n_shards,
                                        total_steps)
        events = tuple(FaultEvent.from_dict(d) for d in json.loads(rest))
        return FaultPlan(seed=seed, events=events).validate()
    except (ValueError, KeyError, TypeError, json.JSONDecodeError) as e:
        raise SystemExit(
            f"--chaos: malformed spec {arg!r} "
            f"(want SEED:auto or SEED:[{{\"kind\":...,\"step\":...}}]): {e}")


# -- unified RPC retry policy -------------------------------------------------


@dataclass(frozen=True)
class RetryPolicy:
    """Jittered exponential backoff + deadline for idempotent RPCs.

    Replaces the scattered ``timeout=30.0`` / ``tries=8`` /
    ``sleep(0.25 * 2**i)`` literals: ``timeout_s`` bounds one attempt,
    ``tries`` bounds the attempt count, ``deadline_s`` bounds the whole
    loop, and ``backoff(i)`` is deterministic at a fixed seed (full
    jitter in ``[0.5, 1.0] * min(cap, base * 2**i)``) so runs replay
    bit-identically while a thundering herd still decorrelates.
    """

    timeout_s: float = 30.0
    tries: int = 8
    backoff_s: float = 0.25
    backoff_cap_s: float = 2.0
    deadline_s: float = 120.0
    seed: int = 0

    def to_dict(self) -> dict:
        return {"timeout_s": self.timeout_s, "tries": self.tries,
                "backoff_s": self.backoff_s,
                "backoff_cap_s": self.backoff_cap_s,
                "deadline_s": self.deadline_s, "seed": self.seed}

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "RetryPolicy":
        if not d:
            return cls()
        return cls(
            timeout_s=float(d.get("timeout_s", 30.0)),
            tries=int(d.get("tries", 8)),
            backoff_s=float(d.get("backoff_s", 0.25)),
            backoff_cap_s=float(d.get("backoff_cap_s", 2.0)),
            deadline_s=float(d.get("deadline_s", 120.0)),
            seed=int(d.get("seed", 0)),
        )

    def reseed(self, salt: int) -> "RetryPolicy":
        """Derive a policy with a per-caller jitter stream (worker id,
        shard id) so concurrent retry loops decorrelate."""
        return replace(self, seed=(self.seed * 1000003 + salt) & 0x7FFFFFFF)

    def backoff(self, attempt: int) -> float:
        base = min(self.backoff_cap_s, self.backoff_s * (2.0 ** attempt))
        u = random.Random((self.seed << 8) ^ attempt).random()
        return base * (0.5 + 0.5 * u)

    def attempts(self) -> Iterator[int]:
        """Yield attempt indices, sleeping the jittered backoff between
        them; stops after ``tries`` attempts or when the next attempt
        would start past ``deadline_s``.  The caller breaks out on
        success and re-raises its last error when the generator is
        exhausted."""
        start = time.monotonic()
        for i in range(self.tries):
            yield i
            if i + 1 >= self.tries:
                break
            pause = self.backoff(i)
            if time.monotonic() + pause - start > self.deadline_s:
                break
            time.sleep(pause)


# -- worker-side runtime ------------------------------------------------------


class WorkerFaults:
    """Executes a plan's worker-side events inside one worker process.

    Installs the wire-layer chaos hook, answers the step loop's
    straggler/compute-delay query, and arms the checkpoint-write fault.
    Each one-shot event fires at most once per invocation *generation*:
    events are keyed by identity, and the ``fired`` set survives only
    in-process — a respawned worker re-derives arming from its restored
    step, which is exactly the semantics a real transient fault has.
    """

    def __init__(self, plan: FaultPlan, worker_id: int):
        self.worker_id = worker_id
        self.events = plan.worker_events(worker_id)
        self._fired: set = set()
        self._step = -1
        self._installed = False
        # each event's index in the plan, and the firings not yet reported
        # as (index, kind, local step, monotonic time)
        self._index = {id(e): i for i, e in enumerate(plan.events)}
        self._unreported: list = []

    def _record(self, e: FaultEvent) -> None:
        self._unreported.append(
            (self._index[id(e)], e.kind, self._step, time.monotonic()))

    def drain(self) -> list:
        """The firings since the last call, as the worker's step report
        carries them: ``recovery_s`` is the seconds from the firing until
        now, when the worker has completed a step again."""
        now = time.monotonic()
        out = [{"index": i, "kind": k, "step": s, "recovery_s": now - t}
               for i, k, s, t in self._unreported]
        self._unreported = []
        return out

    def install(self) -> None:
        if self.events:
            framing.install_chaos_hook(self._on_wire)
            self._installed = True

    def uninstall(self) -> None:
        if self._installed:
            framing.clear_chaos_hook()
            self._installed = False

    def at_step(self, t: int) -> None:
        self._step = t

    # one-shot events fire when the worker has REACHED the event step —
    # ">=" not "==" — so a worker that restores past the step (crash
    # replay) still fires exactly once rather than never
    def _due(self, e: FaultEvent) -> bool:
        return id(e) not in self._fired and 0 <= e.step <= self._step

    def _on_wire(self, side: str, header: dict) -> None:
        op = header.get("op")
        for e in self.events:
            if not self._due(e):
                continue
            if e.op is not None and op is not None and e.op != op:
                continue
            if e.kind == "transport_delay" and side == "send":
                self._fired.add(id(e))
                self._record(e)
                time.sleep(e.delay_s)
            elif e.kind == "transport_stall" and side == "recv":
                self._fired.add(id(e))
                self._record(e)
                time.sleep(e.delay_s)
            elif e.kind == "transport_reset" and side == "send":
                self._fired.add(id(e))
                self._record(e)
                raise ConnectionError(
                    f"chaos: injected connection reset "
                    f"(worker {self.worker_id}, step {self._step})")

    def compute_delay_s(self, t: int) -> float:
        """Total injected straggler sleep for local step ``t``."""
        total = 0.0
        for e in self.events:
            if e.kind != "compute_delay" or t < e.step:
                continue
            if e.every > 0:
                if (t - e.step) % e.every == 0:
                    self._record(e)
                    total += e.delay_s
            elif id(e) not in self._fired:
                self._fired.add(id(e))
                self._record(e)
                total += e.delay_s
        return total

    def ckpt_should_fail(self, step: int) -> bool:
        """True once when a ckpt_enospc event is armed at ``step``."""
        for e in self.events:
            if e.kind == "ckpt_enospc" and id(e) not in self._fired \
                    and step >= e.step:
                self._fired.add(id(e))
                self._record(e)
                return True
        return False


# -- resilient out-of-process job runner --------------------------------------


def run_job_resilient(cfg, max_restarts: int = 3) -> dict:
    """Run a job under a supervisor that may be killed by its own plan.

    The supervisor runs as a subprocess (``python -m
    repro_torch.runtime.supervisor --config ... --allow-self-kill
    --resume``); when a ``supervisor_kill`` event takes it down mid-job,
    it is executed again and re-adopts the live pool from its journal.
    Returns the job result dict with ``supervisor_restarts`` added. Each
    supervisor's output goes to ``logs/supervisor.runNN.log`` under the
    run directory.
    """
    import repro_torch

    logdir = os.path.join(cfg.run_dir, "logs")
    os.makedirs(logdir, exist_ok=True)
    cfg_path = os.path.join(cfg.run_dir, "job_config.json")
    out_path = os.path.join(cfg.run_dir, "job_result.json")
    if os.path.exists(out_path):
        os.unlink(out_path)
    with open(cfg_path, "w") as f:
        json.dump(cfg.to_dict(), f)
    env = dict(os.environ)
    src = os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "repro_torch.runtime.supervisor",
           "--config", cfg_path, "--out", out_path, "--allow-self-kill",
           "--resume"]
    restarts = 0
    for run in range(max_restarts + 1):
        with open(os.path.join(logdir, f"supervisor.run{run:02d}.log"),
                  "wb") as log:
            proc = subprocess.run(cmd, env=env, stdout=log,
                                  stderr=subprocess.STDOUT)
        if os.path.exists(out_path):
            with open(out_path) as f:
                result = json.load(f)
            result["supervisor_restarts"] = restarts
            return result
        if proc.returncode == 0:
            raise RuntimeError(
                "supervisor exited 0 without writing a result")
        restarts += 1
    raise RuntimeError(
        f"supervisor did not complete within {max_restarts} restarts")
