"""Update broker shard — the sharded Redis stand-in of the FaaS runtime.

The paper scales its external store by sharding keys across Redis
instances (§5); here the live update store is partitioned by *leaf key*
(``runtime.sharding``) over N broker shards, each its own process running
this module's handler loop.  Workers talk to every shard over *persistent*
local TCP connections (``repro_torch.wire.framing``) — one connection per shard
per worker invocation, one handler thread per connection, any number of
framed request/response round trips (DESIGN.md §10.3, §11).

Responsibilities of every shard:

* **update store / pub-sub** for the leaves it owns: workers publish their
  significance-filtered slice for step t and pull the peers' slices for t;
  the pull blocks until the shard's ISP barrier for t is met (every worker
  active at t has published its slice here, and every worker *evicted at*
  t has flushed its slice here).  Updates are retained so a respawned
  worker can replay any step — the store IS the fault-tolerance log, like
  the iteration keys MLLess leaves in Redis.
* **byte accounting**: per-message-type request/response byte counters
  plus ``update_bytes`` (codec-accounted published update bytes) — the
  measured analogue of ``core.billing.CommModel``, per shard.
* **write-ahead log**: every state-mutating request is appended (framed,
  synchronously, BEFORE the response) to an on-disk WAL; a respawned
  shard replays it and resumes bit-identically — acked means logged, so
  a SIGKILL loses at most unacknowledged requests, which the workers'
  idempotent RPC layer retries.

The request/response loop itself is *transport-generic* (DESIGN.md §12):
the same handler loop serves a persistent TCP connection (one thread per
socket) or a shared-memory ring-buffer channel (one thread per
``wire.shm`` segment, attached on a ``shm_serve`` control request from
the supervisor).  ``BrokerCore`` never sees the difference — headers,
payload bytes, WAL records and byte accounting are identical on both
transports by construction.  The supervisor's control plane (poll /
evict / shutdown / shm_serve itself) always rides TCP.

The *coordinator* (shard 0) additionally owns everything that must be
globally consistent — the paper's messaging-VM role:

* **minibatch keys**: deterministic round-robin assignment
  ``((step - 1) * P + worker) % n_batches`` served per request and
  piggybacked on ready pulls (``key_next``);
* **membership**: the supervisor requests evictions; the coordinator picks
  the effective step ``e = max_published + 2`` so no worker can have
  computed a step with a stale pool size (a worker only begins step t
  after pulling t-1 from the coordinator, and every coordinator response
  carries the eviction table).  The supervisor then installs the granted
  ``(worker, step)`` on the other shards via ``evict_apply`` — a shard
  with a not-yet-synced table merely blocks its step-e barrier
  conservatively (it still expects the leaver's publish), never serves it
  short;
* **telemetry**: per-(step, worker) loss / duration / sent-fraction /
  conservation-error rows, aggregated per completed step for the
  supervisor's auto-tuner poll.

No shard ever decodes tensor payloads (workers own the math); it stores
raw bytes plus a digest so duplicate publishes from a replayed worker can
be verified bit-identical (``dup_mismatches`` must stay 0 — the
determinism check, which a broker-shard respawn is also held to).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import socketserver
import struct
import threading
import zlib
from typing import Optional

from repro_torch.runtime import protocol

# ops that mutate shard state — exactly what the WAL must persist.
# publish/flush log from inside their handlers (only non-dup records, with
# the store lock held, BEFORE the update becomes pullable); the rest log
# generically from handle().  The live-reshard ops (DESIGN.md §16) are
# parameter-complete in their headers, so generic log-then-apply replays
# them exactly; topo_begin mints its fence and logs the RESULT instead
# (mint-at-replay could diverge, like evict), and migrate_read is
# read-only.
_MUTATING = ("hello", "report", "bye", "evict_apply",
             "migrate_in", "migrate_drop", "topo_commit")

# header_len, payload_len, crc32(header bytes + payload bytes)
_WAL_HDR = struct.Struct("<III")
# a header JSON larger than this cannot have been written by append() —
# a full-size length word this absurd is a corrupted record, not a torn
# tail (tearing only truncates; it never rewrites committed bytes)
_WAL_MAX_HLEN = 1 << 24
_WAL_MAX_PLEN = 1 << 31


class WALCorruption(Exception):
    """A fully-present WAL record failed its CRC (or carries impossible
    lengths): the log was *altered*, not torn.  ``valid_end`` is the byte
    offset of the last record that verified."""

    def __init__(self, path: str, valid_end: int):
        super().__init__(
            f"WAL {path}: corrupt record after byte {valid_end}")
        self.path = path
        self.valid_end = valid_end


class WriteAheadLog:
    """Append-only framed (header JSON, payload) log with per-record CRC.

    A record is ``uint32 hlen | uint32 plen | uint32 crc32 | header |
    payload``, flushed per append.  Two distinct failure modes on
    replay (DESIGN.md §17.3):

    * **torn tail** — a short read mid-final-record.  A SIGKILL mid-
      append can truncate at most that record, which was never acked and
      will be retried by its sender: silently truncated.
    * **corruption** — a fully-present record whose CRC mismatches (a
      flipped byte anywhere in lengths/header/payload).  Replaying past
      it could rebuild *wrong* state behind acked responses, so the
      replay raises ``WALCorruption`` and the attach path quarantines
      the unreadable suffix instead of serving from it.
    """

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "ab")
        self._lock = threading.Lock()

    def append(self, header: dict, payload: bytes) -> None:
        raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
        crc = zlib.crc32(payload, zlib.crc32(raw))
        with self._lock:
            self._f.write(_WAL_HDR.pack(len(raw), len(payload), crc))
            self._f.write(raw)
            if payload:
                self._f.write(payload)
            self._f.flush()  # survive process death (not host death)

    def close(self) -> None:
        with self._lock:
            self._f.close()

    @staticmethod
    def iter_records_with_end(path: str):
        """Yield (header, payload, end_offset) records, stopping at a torn
        tail; ``end_offset`` is the byte offset just past the record.
        Raises ``WALCorruption`` on a CRC-failed (altered) record."""
        with open(path, "rb") as f:
            off = 0
            while True:
                head = f.read(_WAL_HDR.size)
                if len(head) < _WAL_HDR.size:
                    return
                hlen, plen, crc = _WAL_HDR.unpack(head)
                if hlen > _WAL_MAX_HLEN or plen > _WAL_MAX_PLEN:
                    raise WALCorruption(path, off)
                raw = f.read(hlen)
                payload = f.read(plen)
                if len(raw) < hlen or len(payload) < plen:
                    return  # torn tail: the op was never acked
                if zlib.crc32(payload, zlib.crc32(raw)) != crc:
                    raise WALCorruption(path, off)
                off += _WAL_HDR.size + hlen + plen
                yield json.loads(raw.decode("utf-8")), payload, off

    @staticmethod
    def iter_records(path: str):
        """Yield (header, payload) records, stopping at a torn tail."""
        for header, payload, _ in WriteAheadLog.iter_records_with_end(path):
            yield header, payload


def replay_wal(path: str, dispatch) -> tuple[int, int]:
    """Replay a WAL's valid prefix through ``dispatch(header, payload)``.

    Returns ``(records_replayed, quarantined_bytes)``.  A torn tail (an
    unacked final record) is silently truncated, exactly as before; a
    CRC-corrupt record quarantines everything from the corruption point
    on into ``path + ".quarantine"`` and truncates the live log to its
    valid prefix — the shard then serves the *prefix* state, never
    garbage, and the supervisor rolls the affected workers back to the
    surviving frontier (DESIGN.md §17.3).
    """
    replayed = 0
    quarantined = 0
    if not os.path.exists(path):
        return 0, 0
    valid_end = 0
    corrupt = False
    try:
        for header, payload, end in WriteAheadLog.iter_records_with_end(path):
            dispatch(header, payload)
            replayed += 1
            valid_end = end
    except WALCorruption:
        corrupt = True
    size = os.path.getsize(path)
    if valid_end < size:
        if corrupt:
            with open(path, "rb") as f:
                f.seek(valid_end)
                bad = f.read()
            with open(path + ".quarantine", "ab") as q:
                q.write(bad)
                q.flush()
            quarantined = len(bad)
            print(f"WAL {path}: quarantined {quarantined} corrupt bytes "
                  f"after record {replayed} (offset {valid_end})",
                  flush=True)
        # drop the bad/torn suffix BEFORE appending: a later record
        # after garbage bytes would be unreachable to the next replay,
        # silently voiding its 'acked => logged' guarantee
        with open(path, "r+b") as f:
            f.truncate(valid_end)
    return replayed, quarantined


class BrokerCore:
    """All shard state + request handling, guarded by one lock/condition.

    One core holds ONE job's store/barrier/telemetry state.  Under the
    multi-job control plane (DESIGN.md §14) the shard process hosts one
    core per admitted job and routes requests by their ``job`` header;
    ``job_tag`` is that routing id — it is stamped onto every WAL record
    this core writes (so a shared per-shard log replays back into the
    right core) and is ``None`` for a solo job, whose records stay
    byte-identical to the single-job build's.
    """

    def __init__(self, job: dict, shard_id: int = 0, n_shards: int = 1,
                 job_tag: Optional[str] = None):
        self.job = dict(job)
        self.job_tag = job_tag
        self.shard_id = int(shard_id)
        self.n_shards = int(n_shards)
        self.P = int(job["n_workers"])
        self.n_batches = int(job.get("n_batches", 1))
        self.total_steps = int(job["total_steps"])
        # consistency model for the pull barrier: 'isp' (default) is the
        # full per-step barrier; 'ssp' is bounded staleness — a pull at
        # step t blocks only until every update from steps <= t - slack - 1
        # is stored (DESIGN.md §13)
        self.consistency = str(job.get("consistency", "isp"))
        self.slack = int(job.get("slack", 3))
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        # step -> worker -> (meta, payload, digest)
        self.updates: dict[int, dict[int, tuple[list, bytes, str]]] = {}
        # step -> worker -> (meta, payload, digest)   (eviction flushes)
        self.flushes: dict[int, dict[int, tuple[list, bytes, str]]] = {}
        # (step, worker) -> telemetry dict   (coordinator only)
        self.telemetry: dict[tuple[int, int], dict] = {}
        self.evictions: dict[int, int] = {}  # worker -> effective step
        # per-worker publish clocks: highest step each worker has stored
        # here.  Publishes from one worker are sequential over its
        # persistent connection (and WAL replay preserves that order), so
        # the max is also the contiguous durable frontier — the quantity
        # the SSP release rule is stated in.
        self.clocks: dict[int, int] = {}
        self.statuses: dict[int, str] = {w: "spawned" for w in range(self.P)}
        # kernel launches of work done after a worker's last step (the SSP
        # drain), carried by its final bye
        self.bye_launches: dict[int, dict[str, int]] = {}
        self.max_published = 0
        self.dup_mismatches = 0
        self.update_bytes = 0  # codec-accounted published update bytes
        # live-reshard state (DESIGN.md §16): a pending epoch fence (every
        # worker exits at loop-top t >= fence), the committed topology
        # generation, and the set of (gen, src) migrations already merged
        # (idempotency under supervisor retries / WAL replay)
        self.topo_fence: Optional[int] = None
        self.topo_gen = int(job.get("topo_gen", 0))
        self.migrations_applied: set[tuple[int, int]] = set()
        self._poll_cursor = 1  # next telemetry step the supervisor hasn't seen
        self.wal_quarantined_bytes = 0  # corrupt WAL suffix dropped at attach
        self.stats: dict[str, dict[str, int]] = {}
        self.shutting_down = False
        self.shutdown_event = threading.Event()
        self._wal: Optional[WriteAheadLog] = None
        self._replaying = False

    @property
    def is_coordinator(self) -> bool:
        return self.shard_id == 0

    # -- write-ahead log ------------------------------------------------------

    def attach_wal(self, path: str, replay: bool = True) -> int:
        """Replay an existing WAL (respawn path), then append to it.
        Returns the number of records replayed.

        Per-message socket ``stats`` are NOT reconstructed (the WAL holds
        requests, not responses) — they restart per process; the codec
        meter ``update_bytes`` IS rebuilt exactly, and is the number the
        per-shard accounting invariant is stated in.
        """
        replayed = 0
        if replay and os.path.exists(path):
            self._replaying = True
            try:
                replayed, self.wal_quarantined_bytes = replay_wal(
                    path, self.handle)
            finally:
                self._replaying = False
        self._wal = WriteAheadLog(path)
        return replayed

    def _log(self, header: dict, payload: bytes = b"") -> None:
        if self._wal is not None and not self._replaying:
            if self.job_tag is not None and "job" not in header:
                # coordinator-minted records (evict_apply grants,
                # dup_mismatch markers) have no worker-supplied job
                # header; stamp the core's tag so a shared fleet WAL
                # replays them back into this core
                header = {**header, "job": self.job_tag}
            self._wal.append(header, payload)

    # -- membership -----------------------------------------------------------

    def active_at(self, step: int) -> list[int]:
        return [
            w
            for w in range(self.P)
            if w not in self.evictions or step < self.evictions[w]
        ]

    def _barrier_ready(self, step: int) -> bool:
        pubs = self.updates.get(step, {})
        if any(w not in pubs for w in self.active_at(step)):
            return False
        fl = self.flushes.get(step, {})
        return all(
            q in fl for q, e in self.evictions.items() if e == step
        )

    def _ssp_ready(self, d: int) -> bool:
        """Staleness-bounded release: every update from steps <= d is
        stored here.  Evicted workers stop publishing at e - 1 and hand
        off via a flush at e, so their obligation is capped there."""
        if d < 1:
            return True
        for w in range(self.P):
            e = self.evictions.get(w)
            lim = d if e is None else min(d, e - 1)
            if self.clocks.get(w, 0) < lim:
                return False
            if e is not None and e <= d and w not in self.flushes.get(e, {}):
                return False
        return True

    def _parts_at(self, step: int, worker: int) -> list:
        """The deliverable parts of one step: peers' update slices (in
        ascending worker order — the fixed float-summation order every
        replica relies on) plus any eviction flush effective at it."""
        parts = []
        for w in sorted(self.active_at(step)):
            if w == worker:
                continue
            meta, blob, _ = self.updates[step][w]
            parts.append(({"worker": w, "meta": meta}, blob))
        for q in sorted(self.flushes.get(step, {})):
            if self.evictions.get(q) == step:
                meta, blob, _ = self.flushes[step][q]
                parts.append(
                    ({"worker": q, "meta": meta, "flush": True}, blob)
                )
        return parts

    def _telemetry_complete(self, step: int) -> bool:
        return all(
            (step, w) in self.telemetry
            and "dur_s" in self.telemetry[(step, w)]
            for w in self.active_at(step)
        )

    # -- request dispatch -----------------------------------------------------

    def handle(self, header: dict, payload: bytes) -> tuple[dict, bytes]:
        kind = header.get("t", "?")
        fn = getattr(self, f"_op_{kind}", None)
        if fn is None:
            return {"ok": False, "error": f"unknown message type {kind!r}"}, b""
        if kind in _MUTATING:
            # log-then-apply: an acked mutation is always in the WAL, so a
            # respawned shard replays exactly what the workers believe
            # happened; an unacked one is retried by the idempotent RPC
            self._log(header, payload)
        return fn(header, payload)

    def _membership(self) -> dict:
        out = {"evictions": {str(k): v for k, v in self.evictions.items()}}
        if self.topo_fence is not None:
            # piggybacked like evictions: every pull/publish response
            # carries the fence once minted, and the pull that releases a
            # worker into step fence-1's successor is necessarily sent
            # after the mint (the mint guarantees barrier(fence-1) was
            # incomplete), so no worker can publish past the fence.  The
            # key is absent when unset — default-path response bytes are
            # untouched.
            out["topo_fence"] = self.topo_fence
        return out

    def _op_hello(self, h: dict, _p: bytes) -> tuple[dict, bytes]:
        with self._lock:
            w = int(h["worker"])
            if not h.get("warm"):
                # a warm hello (pre-warmed respawn) only fetches the job
                # config — the PREVIOUS invocation still owns the slot's
                # status until it says bye, or the reaper would
                # misclassify its clean exit as a crash
                self.statuses[w] = "running"
            resp = {
                "ok": True,
                "job": self.job,
                "shard_id": self.shard_id,
                "n_shards": self.n_shards,
                **self._membership(),
            }
        return resp, b""

    def batch_key(self, step: int, worker: int) -> int:
        """Deterministic round-robin minibatch key for (step, worker)."""
        return ((step - 1) * self.P + worker) % self.n_batches

    def _op_batch(self, h: dict, _p: bytes) -> tuple[dict, bytes]:
        step, worker = int(h["step"]), int(h["worker"])
        key = self.batch_key(step, worker)
        with self._lock:
            return {"ok": True, "key": key, **self._membership()}, b""

    def _op_publish(self, h: dict, payload: bytes) -> tuple[dict, bytes]:
        step, worker = int(h["step"]), int(h["worker"])
        meta = h["meta"]
        digest = hashlib.sha1(
            json.dumps(meta, sort_keys=True).encode() + payload
        ).hexdigest()
        with self._cond:
            slot = self.updates.setdefault(step, {})
            dup = worker in slot
            if dup:
                # bit-identical dups (worker replay) are NOT re-logged:
                # the original record already persists, and re-appending
                # full payloads would bloat every future WAL replay
                if slot[worker][2] != digest:
                    self.dup_mismatches += 1
                    # the determinism tripwire must survive a shard
                    # respawn — persist a payload-free marker
                    self._log({"t": "dup_mismatch", "worker": worker,
                               "step": step, "kind": "publish"})
            else:
                # log while holding the lock, before the update becomes
                # pullable: no peer can apply an unlogged update
                self._log(h, payload)
                slot[worker] = (meta, payload, digest)
                self.max_published = max(self.max_published, step)
                self.clocks[worker] = max(self.clocks.get(worker, 0), step)
                self.update_bytes += protocol.wire_bytes(meta)
            if self.is_coordinator:
                # telemetry is a coordinator concern; the worker reports
                # its cross-shard wire_bytes total on this one publish
                self.telemetry.setdefault((step, worker), {}).update(
                    {
                        "loss": h.get("loss"),
                        "sent_fraction": h.get("sent_fraction"),
                        "inv_err": h.get("inv_err"),
                        "wire_bytes": (
                            h["wire_bytes"] if "wire_bytes" in h
                            else protocol.wire_bytes(meta)
                        ),
                    }
                )
            self._cond.notify_all()
            return {"ok": True, "dup": dup, **self._membership()}, b""

    def _op_flush(self, h: dict, payload: bytes) -> tuple[dict, bytes]:
        step, worker = int(h["step"]), int(h["worker"])
        digest = hashlib.sha1(
            json.dumps(h["meta"], sort_keys=True).encode() + payload
        ).hexdigest()
        with self._cond:
            slot = self.flushes.setdefault(step, {})
            dup = worker in slot
            if dup:
                # a replayed flush must be bit-identical too — survivors may
                # already have applied the first copy
                if slot[worker][2] != digest:
                    self.dup_mismatches += 1
                    self._log({"t": "dup_mismatch", "worker": worker,
                               "step": step, "kind": "flush"})
            else:
                self._log(h, payload)  # as for publish: log-before-visible
                slot[worker] = (h["meta"], payload, digest)
            self._cond.notify_all()
        return {"ok": True, "dup": dup}, b""

    def _op_pull(self, h: dict, _p: bytes) -> tuple[dict, bytes]:
        step, worker = int(h["step"]), int(h["worker"])
        timeout = float(h.get("timeout_s", 2.0))
        if self.consistency == "ssp":
            return self._pull_ssp(step, worker, timeout)
        with self._cond:
            ready = self._cond.wait_for(
                lambda: self._barrier_ready(step) or self.shutting_down,
                timeout=timeout,
            )
            if self.shutting_down:
                return {"ok": False, "abort": True}, b""
            if not ready or not self._barrier_ready(step):
                return {"ok": True, "ready": False, **self._membership()}, b""
            descs, payload = protocol.pack_parts(
                self._parts_at(step, worker)
            )
            resp = {
                "ok": True,
                "ready": True,
                "parts": descs,
                **self._membership(),
            }
            if self.is_coordinator:
                # coalesced pull: piggyback the NEXT step's minibatch key so
                # the steady-state worker loop is exactly 1 + n_shards round
                # trips per ISP barrier (one publish + one pull per shard)
                resp["key_next"] = self.batch_key(step + 1, worker)
        return resp, payload

    def _pull_ssp(self, step: int, worker: int,
                  timeout: float) -> tuple[dict, bytes]:
        """Bounded-staleness pull: a pull at step t is served exactly the
        updates of the frontier step d = t - slack - 1 (empty, and ready
        immediately, while d < 1), blocking only until every update from
        steps <= d is stored.  The delivery schedule is a pure function
        of t, so a respawned worker's replayed pulls return the identical
        retained parts — replay stays deterministic (DESIGN.md §13)."""
        d = step - self.slack - 1
        with self._cond:
            ready = self._cond.wait_for(
                lambda: self._ssp_ready(d) or self.shutting_down,
                timeout=timeout,
            )
            if self.shutting_down:
                return {"ok": False, "abort": True}, b""
            if not ready or not self._ssp_ready(d):
                return {"ok": True, "ready": False, **self._membership()}, b""
            parts = self._parts_at(d, worker) if d >= 1 else []
            descs, payload = protocol.pack_parts(parts)
            resp = {
                "ok": True,
                "ready": True,
                "parts": descs,
                "visible_step": d,
                **self._membership(),
            }
            if self.is_coordinator:
                resp["key_next"] = self.batch_key(step + 1, worker)
        return resp, payload

    def _op_report(self, h: dict, _p: bytes) -> tuple[dict, bytes]:
        step, worker = int(h["step"]), int(h["worker"])
        with self._lock:
            cell = self.telemetry.setdefault((step, worker), {})
            cell["dur_s"] = float(h["dur_s"])
            if "phase" in h:  # per-phase data-path breakdown (DESIGN.md §10)
                cell["phase"] = {
                    k: float(v) for k, v in h["phase"].items()
                }
            if "launches" in h:  # kernel launches the worker's step made
                cell["launches"] = {
                    k: int(v) for k, v in h["launches"].items()
                }
        return {"ok": True}, b""

    def _op_bye(self, h: dict, _p: bytes) -> tuple[dict, bytes]:
        with self._lock:
            self.statuses[int(h["worker"])] = f"bye:{h.get('reason', '?')}"
            if "launches" in h:
                self.bye_launches[int(h["worker"])] = {
                    k: int(v) for k, v in h["launches"].items()
                }
        return {"ok": True}, b""

    def _op_evict(self, h: dict, _p: bytes) -> tuple[dict, bytes]:
        if not self.is_coordinator:
            # membership decisions are minted in exactly one place; other
            # shards receive the result via evict_apply
            return {"ok": False, "error": "evict: not the coordinator"}, b""
        worker = int(h["worker"])
        with self._cond:
            if worker in self.evictions:
                return {
                    "ok": True, "granted": True,
                    "evict_step": self.evictions[worker],
                }, b""
            # effective at a step no worker can have begun with the old
            # pool; distinct from every prior eviction's step — with ONE
            # leaver per step the survivors' sequential mean-preserving
            # pulls x += (flush - x)/P_old stay exact (two flushes at the
            # same step with the same divisor would drift the pool mean)
            step = max(
                self.max_published + 2,
                max(self.evictions.values(), default=0) + 1,
            )
            if step > self.total_steps:
                # the pool finishes before the eviction could take effect —
                # granting it would strand a flush no survivor ever pulls
                return {"ok": True, "granted": False,
                        "reason": "past-end"}, b""
            self.evictions[worker] = step
            # the WAL must replay the *result*, not re-derive it from a
            # different max_published — log the grant as an evict_apply
            self._log({"t": "evict_apply", "worker": worker, "step": step})
            self._cond.notify_all()
        return {"ok": True, "granted": True, "evict_step": step}, b""

    def _op_dup_mismatch(self, h: dict, _p: bytes) -> tuple[dict, bytes]:
        """WAL-replay path only: restore a previously-detected replay
        divergence (the marker is logged at detection time; this op is
        not in _MUTATING so replay does not re-log it)."""
        with self._lock:
            self.dup_mismatches += 1
        return {"ok": True}, b""

    def _op_evict_apply(self, h: dict, _p: bytes) -> tuple[dict, bytes]:
        """Install a coordinator-granted eviction (worker, effective step)
        on this shard — the supervisor's cross-shard membership sync."""
        worker, step = int(h["worker"]), int(h["step"])
        with self._cond:
            prev = self.evictions.get(worker)
            if prev is not None and prev != step:
                return {
                    "ok": False,
                    "error": f"evict_apply conflict: worker {worker} already "
                    f"evicted at {prev}, got {step}",
                }, b""
            self.evictions[worker] = step
            self._cond.notify_all()
        return {"ok": True, "evict_step": step}, b""

    # -- live re-sharding (DESIGN.md §16) -------------------------------------

    @staticmethod
    def _entry_slices(meta: list, blob: bytes):
        """Yield ``(m, byte_segment)`` per leaf meta of one stored entry —
        the per-entry offset walk migrate read/in/drop all share."""
        off = 0
        for m in meta:
            nb = int(m["nbytes"])
            yield m, blob[off:off + nb]
            off += nb

    def _op_topo_begin(self, h: dict, _p: bytes) -> tuple[dict, bytes]:
        """Mint the epoch fence for a topology handover (coordinator only;
        idempotent).  The fence f satisfies: (a) no worker has published
        step >= f-1, so barrier(f-1) is incomplete at mint time and every
        pull response releasing a worker into step f carries the fence via
        _membership(); (b) f exceeds every granted eviction step, so an
        eviction flush always lands in a barrier <= f-1.  Logged as its
        RESULT (like evict): re-minting at replay could diverge."""
        with self._cond:
            if "fence" in h:  # WAL replay: install the minted fence
                self.topo_fence = int(h["fence"])
                self._cond.notify_all()
                return {"ok": True, "granted": True,
                        "fence": self.topo_fence}, b""
            if not self.is_coordinator:
                return {"ok": False,
                        "error": "topo_begin: not the coordinator"}, b""
            if self.topo_fence is not None:
                return {"ok": True, "granted": True,
                        "fence": self.topo_fence}, b""
            fence = max(
                self.max_published + 2,
                max(self.evictions.values(), default=0) + 1,
            )
            if fence > self.total_steps:
                # the job finishes before the fence could take effect —
                # same refusal as a past-end eviction
                return {"ok": True, "granted": False,
                        "reason": "past-end"}, b""
            self.topo_fence = fence
            self._log({"t": "topo_begin", "fence": fence})
            self._cond.notify_all()
        return {"ok": True, "granted": True, "fence": fence}, b""

    def _op_topo_commit(self, h: dict, _p: bytes) -> tuple[dict, bytes]:
        """Install the new topology after migration: update the job dict
        (respawned workers hello into the new assignment), bump the
        generation, clear the fence.  Parameter-complete header, so the
        generic WAL log-then-apply replays it exactly."""
        with self._cond:
            for k in ("n_brokers", "transport", "wire_scheme",
                      "shard_split_bytes", "partitioner"):
                if k in h:
                    self.job[k] = h[k]
            self.topo_gen = int(h["gen"])
            self.job["topo_gen"] = self.topo_gen
            self.n_shards = int(h["n_shards"])
            self.topo_fence = None
            self._cond.notify_all()
        return {"ok": True, "gen": self.topo_gen}, b""

    def _op_migrate_read(self, h: dict, _p: bytes) -> tuple[dict, bytes]:
        """Read every stored slice of the moved identities ``[(k, o), ...]``
        out of this shard (updates AND eviction flushes), packed as
        (kind, step, worker, meta) parts.  Read-only — not logged; the
        durable hand-off is the destination's migrate_in record."""
        moved = {(str(k), int(o)) for k, o in h["moved"]}
        with self._lock:
            parts = []
            for kind, store in (("update", self.updates),
                                ("flush", self.flushes)):
                for step in sorted(store):
                    for w in sorted(store[step]):
                        meta, blob, _ = store[step][w]
                        sel, segs = [], []
                        for m, seg in self._entry_slices(meta, blob):
                            if (m["k"], int(m.get("o", 0))) in moved:
                                sel.append(m)
                                segs.append(seg)
                        if sel:
                            parts.append((
                                {"kind": kind, "step": step, "worker": w,
                                 "meta": sel},
                                b"".join(segs),
                            ))
            descs, payload = protocol.pack_parts(parts)
            resp = {
                "ok": True,
                "parts": descs,
                "clocks": {str(k): v for k, v in self.clocks.items()},
                "max_published": self.max_published,
            }
        return resp, payload

    def _op_migrate_in(self, h: dict, payload: bytes) -> tuple[dict, bytes]:
        """Merge migrated slices into this shard's store.  Idempotent per
        (gen, src) — a supervisor retry after a SIGKILL mid-apply replays
        over the WAL-rebuilt ``migrations_applied`` marker.  Merged metas
        are kept sorted by (k, o); safe because migrated identities were
        owned by the source under the OLD assignment and are disjoint
        from anything this shard already stored, and post-fence pulls
        never read pre-fence steps (only dump reassembly does, and it is
        order-insensitive per (worker, step))."""
        from repro_torch.wire.framing import unpack_parts

        key = (int(h["gen"]), int(h["src"]))
        with self._cond:
            if key in self.migrations_applied:
                return {"ok": True, "already": True}, b""
            for desc, part in unpack_parts(h["parts"], payload):
                kind = desc["kind"]
                store = self.updates if kind == "update" else self.flushes
                step, w = int(desc["step"]), int(desc["worker"])
                slot = store.setdefault(step, {})
                pairs = list(self._entry_slices(desc["meta"], bytes(part)))
                if w in slot:
                    old_meta, old_blob, _ = slot[w]
                    pairs.extend(self._entry_slices(old_meta, old_blob))
                pairs.sort(
                    key=lambda p: (p[0]["k"], int(p[0].get("o", 0)))
                )
                metas = [m for m, _ in pairs]
                blob = b"".join(seg for _, seg in pairs)
                digest = hashlib.sha1(
                    json.dumps(metas, sort_keys=True).encode() + blob
                ).hexdigest()
                slot[w] = (metas, blob, digest)
                if kind == "update":
                    self.max_published = max(self.max_published, step)
                    self.clocks[w] = max(self.clocks.get(w, 0), step)
                    self.update_bytes += protocol.wire_bytes(desc["meta"])
            self.migrations_applied.add(key)
            self._cond.notify_all()
        return {"ok": True, "already": False}, b""

    def _op_migrate_drop(self, h: dict, _p: bytes) -> tuple[dict, bytes]:
        """Drop the moved identities from this shard after every
        destination acked its migrate_in.  Naturally idempotent (dropping
        absent identities is a no-op); header-only, generically logged."""
        moved = {(str(k), int(o)) for k, o in h["moved"]}
        with self._cond:
            for kind, store in (("update", self.updates),
                                ("flush", self.flushes)):
                for step in list(store):
                    for w in list(store[step]):
                        meta, blob, _ = store[step][w]
                        keep, segs, dropped = [], [], []
                        for m, seg in self._entry_slices(meta, blob):
                            if (m["k"], int(m.get("o", 0))) in moved:
                                dropped.append(m)
                            else:
                                keep.append(m)
                                segs.append(seg)
                        if not dropped:
                            continue
                        if kind == "update":
                            self.update_bytes -= protocol.wire_bytes(dropped)
                        if keep:
                            kept_blob = b"".join(segs)
                            digest = hashlib.sha1(
                                json.dumps(keep, sort_keys=True).encode()
                                + kept_blob
                            ).hexdigest()
                            store[step][w] = (keep, kept_blob, digest)
                        else:
                            del store[step][w]
                            if not store[step]:
                                del store[step]
            self._cond.notify_all()
        return {"ok": True}, b""

    def _op_poll(self, h: dict, _p: bytes) -> tuple[dict, bytes]:
        # with a client-supplied cursor ('since') the poll is IDEMPOTENT —
        # a lost response replayed over a reconnecting wire.Connection
        # returns the same rows instead of dropping them; the server-side
        # cursor only backs cursor-less (legacy/debug) callers
        stateless = "since" in h
        with self._lock:
            rows = []
            step = int(h["since"]) if stateless else self._poll_cursor
            while step <= self.total_steps and self._telemetry_complete(step):
                active = self.active_at(step)
                cells = [self.telemetry[(step, w)] for w in active]
                row = {
                    "step": step,
                    "loss": _mean([c["loss"] for c in cells]),
                    "dur_s": _mean([c["dur_s"] for c in cells]),
                    "sent_fraction": _mean(
                        [c["sent_fraction"] for c in cells]
                    ),
                    "inv_err": max(
                        float(c["inv_err"] or 0.0) for c in cells
                    ),
                    "wire_bytes": float(
                        sum(c["wire_bytes"] for c in cells)
                    ),
                    "p_active": len(active),
                    # per-worker durations so a straggler's stalls are
                    # attributable (fig9 --live scores the NON-straggler
                    # p95 under each consistency model)
                    "dur_s_by_worker": {
                        str(w): float(self.telemetry[(step, w)]["dur_s"])
                        for w in active
                    },
                }
                if any("launches" in c for c in cells):
                    row["launches_by_worker"] = {
                        str(w): self.telemetry[(step, w)].get("launches", {})
                        for w in active
                    }
                phases = [c["phase"] for c in cells if "phase" in c]
                if phases:
                    row["phase"] = {
                        k: _mean([p.get(k) for p in phases])
                        for k in phases[0]
                    }
                rows.append(row)
                step += 1
            if not stateless:
                self._poll_cursor = step
            resp = {
                "ok": True,
                "rows": rows,
                "statuses": {str(k): v for k, v in self.statuses.items()},
                "max_published": self.max_published,
                "clocks": {str(k): v for k, v in self.clocks.items()},
                "dup_mismatches": self.dup_mismatches,
                **self._membership(),
            }
            if self.bye_launches:  # absent unless a drain reported
                resp["bye_launches"] = {
                    str(w): dict(c) for w, c in self.bye_launches.items()
                }
            if self.wal_quarantined_bytes:
                # key absent on the default path — response bytes stay
                # baseline-identical with no corruption ever seen
                resp["wal_quarantined"] = self.wal_quarantined_bytes
        return resp, b""

    def _op_dump(self, h: dict, _p: bytes) -> tuple[dict, bytes]:
        """Test/debug hook: every stored update slice as one multi-part
        payload (this shard's leaves only; the supervisor merges shards)."""
        with self._lock:
            parts = []
            for step in sorted(self.updates):
                for w in sorted(self.updates[step]):
                    meta, blob, _ = self.updates[step][w]
                    parts.append(
                        ({"worker": w, "step": step, "meta": meta}, blob)
                    )
            descs, payload = protocol.pack_parts(parts)
        return {"ok": True, "parts": descs}, payload

    def _op_stats(self, h: dict, _p: bytes) -> tuple[dict, bytes]:
        with self._lock:
            resp = {
                "ok": True,
                "shard_id": self.shard_id,
                "stats": self.stats,
                "update_bytes": self.update_bytes,
                "dup_mismatches": self.dup_mismatches,
            }
            if self.wal_quarantined_bytes:
                resp["wal_quarantined"] = self.wal_quarantined_bytes
            return resp, b""

    def _op_shutdown(self, h: dict, _p: bytes) -> tuple[dict, bytes]:
        with self._cond:
            self.shutting_down = True
            self._cond.notify_all()
            resp = {
                "ok": True,
                "shard_id": self.shard_id,
                "stats": self.stats,
                "update_bytes": self.update_bytes,
                "dup_mismatches": self.dup_mismatches,
            }
        # shutdown_event is set by the HANDLER after this response is on
        # the wire — setting it here would let the standalone process exit
        # before the requester ever reads its stats
        return resp, b""

    # -- accounting -----------------------------------------------------------

    def account(self, kind: str, bytes_in: int, bytes_out: int) -> None:
        with self._lock:
            row = self.stats.setdefault(
                kind, {"count": 0, "bytes_in": 0, "bytes_out": 0}
            )
            row["count"] += 1
            row["bytes_in"] += bytes_in
            row["bytes_out"] += bytes_out


def _mean(xs) -> Optional[float]:
    vals = [float(x) for x in xs if x is not None]
    return sum(vals) / len(vals) if vals else None


# -- transport-generic serve loop ---------------------------------------------


def _account_request(core: BrokerCore, header: dict, payload: bytes,
                     bytes_out: int) -> None:
    """Identical byte accounting on every transport: the framed request
    size a TCP socket would have carried (8-byte length prefix + header
    JSON + payload) — transport-private overhead (shm rids/trailers, IP
    headers) is never counted."""
    hdr_len = len(json.dumps(header, separators=(",", ":")))
    core.account(header.get("t", "?"), 8 + hdr_len + len(payload), bytes_out)


class _Handler(socketserver.BaseRequestHandler):
    def handle(self) -> None:  # one persistent connection, many requests
        broker: "Broker" = self.server.broker  # type: ignore[attr-defined]
        try:
            self.request.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            while True:
                header, payload = protocol.recv_msg(self.request)
                if header.get("t") == "shm_serve":
                    # transport control plane, not shard state: the shell
                    # attaches a shared-memory segment and serves it from
                    # a dedicated thread (idempotent per segment)
                    resp = broker.shm_serve(header)
                    protocol.send_msg(self.request, resp)
                    continue
                core, resp, blob = broker.dispatch(header, payload)
                out = protocol.send_msg(self.request, resp, blob)
                _account_request(core, header, payload, out)
                if core.shutting_down and broker.all_shutting_down():
                    # signal process exit only AFTER the last job's
                    # (shutdown) response reached the wire — the
                    # requester must get its final stats back; with
                    # other jobs still live the connection stays up
                    for c in broker.cores.values():
                        c.shutdown_event.set()
                    break
        except (ConnectionError, ValueError, OSError):
            pass  # client vanished mid-stream; nothing to clean up


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class Broker:
    """Server shell around ``BrokerCore``; in-thread or standalone.

    Always binds a TCP port (the supervisor's control plane and the
    default worker data path); additionally serves any number of
    shared-memory segments handed to it via ``shm_serve`` requests —
    one daemon thread per segment running the same handler loop the TCP
    connections run (DESIGN.md §12.3).

    With ``wal_path`` the cores replay any existing log BEFORE the port is
    bound (a respawned shard never serves from partial state) and append
    every subsequent mutation to it.

    Multi-job (DESIGN.md §14): a config with a ``"jobs"`` key —
    ``{"jobs": {job_id: job_dict, ...}}`` — hosts one independent
    ``BrokerCore`` per job in this process, all sharing one TCP port,
    one WAL file, and the shm segments.  Requests route by their
    ``job`` header; a request without one goes to the sole core (so
    single-job traffic is byte-identical to the single-core build).
    ``self.core`` remains the sole/first core for solo-path callers.
    """

    def __init__(
        self,
        job: dict,
        host: str = "127.0.0.1",
        port: int = 0,
        shard_id: int = 0,
        n_shards: int = 1,
        wal_path: Optional[str] = None,
    ):
        jobs = job.get("jobs") if isinstance(job, dict) else None
        if jobs:
            self.cores: dict[Optional[str], BrokerCore] = {
                str(jid): BrokerCore(
                    jdict, shard_id=shard_id, n_shards=n_shards,
                    job_tag=str(jid),
                )
                for jid, jdict in jobs.items()
            }
        else:
            self.cores = {
                None: BrokerCore(job, shard_id=shard_id, n_shards=n_shards)
            }
        self.core = next(iter(self.cores.values()))
        self.replayed = 0
        if wal_path:
            self.replayed = self._attach_shared_wal(wal_path)
        self._server = _Server((host, port), _Handler)
        self._server.core = self.core  # type: ignore[attr-defined]
        self._server.broker = self  # type: ignore[attr-defined]
        self._thread: Optional[threading.Thread] = None
        self._shm_threads: dict[str, threading.Thread] = {}
        self._shm_lock = threading.Lock()

    # -- multi-core routing ----------------------------------------------------

    def dispatch(
        self, header: dict, payload: bytes
    ) -> tuple[BrokerCore, dict, bytes]:
        """Route a request to its job's core by the ``job`` header and
        handle it there; returns the core too so the caller accounts the
        bytes on the right job's meter."""
        jid = header.get("job")
        core = self.cores.get(jid)
        if core is None and jid is None and len(self.cores) == 1:
            core = self.core
        if core is None:
            return self.core, {"ok": False, "error": f"unknown job {jid!r}"}, b""
        resp, blob = core.handle(header, payload)
        return core, resp, blob

    def all_shutting_down(self) -> bool:
        return all(c.shutting_down for c in self.cores.values())

    def _attach_shared_wal(self, path: str) -> int:
        """Replay one shared per-shard WAL into every core (records route
        by their ``job`` header), truncate any torn tail, then append all
        cores' subsequent mutations to the same (thread-safe) log.
        Identical to ``BrokerCore.attach_wal`` when there is one core."""
        replayed = 0
        if os.path.exists(path):
            for c in self.cores.values():
                c._replaying = True
            try:
                replayed, quarantined = replay_wal(
                    path, lambda h, p: self.dispatch(h, p))
            finally:
                for c in self.cores.values():
                    c._replaying = False
            for c in self.cores.values():
                c.wal_quarantined_bytes = quarantined
        wal = WriteAheadLog(path)
        for c in self.cores.values():
            c._wal = wal
        return replayed

    # -- shared-memory data path ----------------------------------------------

    def shm_serve(self, header: dict) -> dict:
        """Attach one ``wire.shm`` segment and serve it from a dedicated
        thread.  Idempotent: a retried request for a segment this process
        already serves is acked without a second (ring-resetting) attach —
        two servers on one ring would corrupt the stream."""
        name = str(header["seg"])
        with self._shm_lock:
            # dead threads (prior invocations' segments) would otherwise
            # accumulate one entry per invocation x shard for the job's
            # lifetime
            self._shm_threads = {
                n: th for n, th in self._shm_threads.items() if th.is_alive()
            }
            t = self._shm_threads.get(name)
            if t is not None:
                return {"ok": True, "seg": name, "already": True}
            t = threading.Thread(
                target=self._serve_shm_segment, args=(name,), daemon=True,
                name=f"shm-{name}",
            )
            self._shm_threads[name] = t
            t.start()
        return {"ok": True, "seg": name, "already": False}

    def _serve_shm_segment(self, name: str) -> None:
        from repro_torch.wire import shm

        def stopping() -> bool:
            return self.all_shutting_down()

        while not self.all_shutting_down():
            try:
                chan = shm.ShmServerChannel(name, stop=stopping)
            except (ConnectionError, OSError, FileNotFoundError):
                return  # segment gone (worker slot torn down)
            try:
                while not self.all_shutting_down():
                    try:
                        rid, header, payload = chan.recv()
                    except shm.TornFrameError:
                        # desynced stream (e.g. a client abandoned a
                        # half-sent frame): heal by re-serving — the
                        # ring reset + generation bump make the client
                        # replay its request from a clean stream
                        break
                    core, resp, blob = self.dispatch(header, payload)
                    out = chan.send(rid, resp, blob)
                    _account_request(core, header, payload, out)
            except (ConnectionError, OSError, TimeoutError, ValueError):
                chan.close(mark_closed=self.all_shutting_down())
                return  # peer death or shutdown: this channel is done
            chan.close()  # torn-frame break: loop around and re-serve

    @property
    def addr(self) -> tuple[str, int]:
        return self._server.server_address[:2]

    def start(self) -> tuple[str, int]:
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            kwargs={"poll_interval": 0.05},
            daemon=True,
            name=f"broker-tcp-{self.core.shard_id}",
        )
        self._thread.start()
        return self.addr

    def stop(self, timeout: float = 5.0) -> list[str]:
        """Stop serving; returns the names of handler threads that failed
        to join within ``timeout`` (empty list = clean stop).  A wedged
        handler is also logged here — the one place the thread identity
        is still known."""
        for core in self.cores.values():
            with core._cond:
                core.shutting_down = True
                core._cond.notify_all()
            core.shutdown_event.set()
        self._server.shutdown()
        self._server.server_close()
        wedged: list[str] = []
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                wedged.append(self._thread.name)
        with self._shm_lock:
            shm_threads = list(self._shm_threads.values())
        for t in shm_threads:  # they exit within one wait slice (~50 ms)
            t.join(timeout=timeout)
            if t.is_alive():
                wedged.append(t.name)
        # cores share one WAL in fleet mode — close each distinct log once
        closed: set[int] = set()
        for core in self.cores.values():
            if core._wal is not None and id(core._wal) not in closed:
                closed.add(id(core._wal))
                core._wal.close()
        if wedged:
            print(
                f"broker shard {self.core.shard_id}: handler threads "
                f"failed to join within {timeout}s: {wedged}", flush=True,
            )
        return wedged


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", required=True, help="job config JSON file")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--shard-id", type=int, default=0)
    ap.add_argument("--n-shards", type=int, default=1)
    ap.add_argument("--wal", default=None,
                    help="write-ahead log path (replayed on respawn)")
    ap.add_argument("--port-file", default=None,
                    help="write HOST:PORT here once listening (atomic) — "
                    "the supervisor's readiness signal")
    args = ap.parse_args()
    with open(args.config) as f:
        job = json.load(f)
    broker = Broker(
        job,
        port=args.port,
        shard_id=args.shard_id,
        n_shards=args.n_shards,
        wal_path=args.wal,
    )
    host, port = broker.start()
    if args.port_file:
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(f"{host}:{port}")
        os.replace(tmp, args.port_file)
    print(
        f"broker shard {args.shard_id}/{args.n_shards} listening on "
        f"{host}:{port} (replayed {broker.replayed} WAL records)",
        flush=True,
    )
    try:
        # fleet configs host several cores; the process exits only once
        # every job's core has been shut down
        for core in broker.cores.values():
            core.shutdown_event.wait()
    except KeyboardInterrupt:
        pass
    broker.stop()


if __name__ == "__main__":
    main()
