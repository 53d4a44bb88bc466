"""Shared-memory transport for the same-host update path (DESIGN.md §12).

Workers and broker shards are processes on ONE host, yet until this
module every update byte crossed the kernel twice through a loopback TCP
socket.  Here the persistent ``Connection`` seam of ``wire.framing`` is
re-implemented over a ``multiprocessing.shared_memory`` segment per
(worker, shard) pair: publishes and pulls are a single userspace memcpy
into an mmap'd ring — no socket, no syscall per byte — while the message
framing, the codec, and every byte-accounting number stay bit-identical
to the TCP transport.

Segment layout (one per worker↔shard channel, created by the supervisor)::

    SegHdr   | RingHdr req | RingHdr rsp | req data [N] | rsp data [N]

Each ring is a single-producer single-consumer byte stream:

* ``head``/``tail`` are monotonically-increasing uint64 byte cursors
  published through a **seqlock** (odd/even sequence word around each
  store) so the peer never acts on a torn 8-byte read;
* the producer copies payload bytes FIRST and publishes ``head`` after —
  the head store is the commit point, so a reader can never observe a
  partially-written frame (SIGKILL mid-publish leaves the bytes beyond
  ``head`` invisible; every decoded frame additionally carries a trailer
  word as a torn-write tripwire);
* frames larger than the ring stream through it in chunks — the producer
  commits as space frees, the consumer drains as bytes commit, so the
  ring size bounds memory, not message size;
* a full ring is **backpressure**: the producer waits on the consumer's
  space futex; an empty ring parks the consumer on the producer's data
  futex (Linux ``futex(2)`` on words inside the segment — the same
  zero-syscall-until-contended wakeup the ISP barrier long-poll needs;
  the transport refuses any host but Linux on x86).

Liveness and respawn are generation-based: the serving broker resets the
rings and bumps the segment ``generation`` word when it (re)attaches, so
a worker whose in-flight request was wiped by a broker respawn sees the
generation move, raises ``ConnectionError``, and replays through the same
idempotent-RPC retry path the TCP transport uses.  A SIGKILLed *worker*
is detected by pid liveness; its segments are torn down and recreated by
the supervisor before the respawned invocation attaches (DESIGN.md §12.3
failure matrix).
"""

from __future__ import annotations

import ctypes
import json
import os
import platform
import struct
import sys
import time
from multiprocessing import shared_memory
from typing import Callable, Optional

from repro_torch.wire import framing
from repro_torch.wire.framing import Payload, _as_views

# -- futex(2) wakeup (Linux) --------------------------------------------------

_FUTEX_WAIT = 0
_FUTEX_WAKE = 1
_INT_MAX = 2**31 - 1
_SYS_FUTEX = {
    "x86_64": 202,
    "i686": 240,
    "i386": 240,
}.get(platform.machine())

# the ring commit protocol (payload stores before the head publish, and
# the seqlock around the 64-bit cursors) relies on total-store-order —
# ctypes emits no memory barriers, so weakly-ordered machines (aarch64,
# power, ...) could surface uncommitted bytes.  The transport refuses to
# start anywhere the assumption does not hold rather than corrupting
# quietly (DESIGN.md §12.2).
SHM_MACHINES = ("x86_64", "i686", "i386", "AMD64")


def _require_supported() -> None:
    m = platform.machine()
    if m not in SHM_MACHINES or not sys.platform.startswith("linux"):
        raise ConnectionError(
            f"shm transport requires Linux on a TSO machine "
            f"({SHM_MACHINES}); this host is {sys.platform}/{m} — use the "
            "tcp transport"
        )

# every channel passes _require_supported() first, so the futex calls
# run only on Linux x86, where this handle always loads
_libc = ctypes.CDLL(None, use_errno=True) if os.name == "posix" else None

# the slice of a futex wait between peer-death/generation checks: short
# enough that they stay responsive
_WAIT_SLICE_S = 0.05
# a reader's back-off while a seqlock word stays odd (its writer died
# between the two increments)
_POLL_SLEEP_S = 0.0002
# adaptive spin-then-futex: before parking in the kernel, spin up to a
# budget tuned from the MEASURED wait times of this word (2x the EWMA,
# capped) — barrier wakeups that historically arrive within microseconds
# are caught without paying the ~5-10 us futex syscall + thread switch,
# while words that historically park for milliseconds skip straight to
# the futex.  The cap bounds the cpu burned per wait and is overridable
# for oversubscribed hosts (REPRO_SHM_SPIN_US=0 disables spinning).
_SPIN_MAX_S = max(float(os.environ.get("REPRO_SHM_SPIN_US", "200")), 0.0) * 1e-6


class _AdaptiveWaiter:
    """Per-futex-word spin budget learned from measured wait durations."""

    __slots__ = ("ewma_s",)
    _ALPHA = 0.2  # EWMA smoothing of observed wait times

    def __init__(self) -> None:
        self.ewma_s = 0.0

    def budget_s(self) -> float:
        return min(2.0 * self.ewma_s, _SPIN_MAX_S)

    def record(self, waited_s: float) -> None:
        self.ewma_s += self._ALPHA * (waited_s - self.ewma_s)
# producer commit granularity: one head-publish + wake per frame for
# small messages, every _COMMIT_CHUNK bytes for large ones — small
# frames pay ONE wakeup, large frames stream (the consumer's copy-out
# overlaps the producer's copy-in, like kernel socket buffering does)
_COMMIT_CHUNK = 256 << 10
# copies at or above this size go through numpy, which drops the GIL for
# large contiguous copies — a broker thread pushing a MB-scale pull
# response must not serialize every OTHER worker's ack behind it (TCP
# gets this for free: sendmsg releases the GIL during the kernel copy)
_NP_COPY_MIN = 16 << 10


class _timespec(ctypes.Structure):
    _fields_ = [("tv_sec", ctypes.c_long), ("tv_nsec", ctypes.c_long)]


def _futex_wait(addr: int, expected: int, timeout_s: float) -> None:
    """Sleep until *addr != expected (best effort) or timeout."""
    sec = int(timeout_s)
    ts = _timespec(sec, int((timeout_s - sec) * 1e9))
    _libc.syscall(
        _SYS_FUTEX,
        ctypes.c_void_p(addr),
        ctypes.c_int(_FUTEX_WAIT),  # NOT private: waiters cross processes
        ctypes.c_uint32(expected),
        ctypes.byref(ts),
        ctypes.c_void_p(0),
        ctypes.c_uint32(0),
    )  # EAGAIN/ETIMEDOUT/EINTR are all "go re-check"


def _futex_wake(addr: int) -> None:
    _libc.syscall(
        _SYS_FUTEX,
        ctypes.c_void_p(addr),
        ctypes.c_int(_FUTEX_WAKE),
        ctypes.c_uint32(_INT_MAX),
        ctypes.c_void_p(0),
        ctypes.c_void_p(0),
        ctypes.c_uint32(0),
    )


# -- segment layout -----------------------------------------------------------

MAGIC = 0x4D4C5348  # "MLSH"
VERSION = 1

# segment header field offsets (all uint32 unless noted)
_OFF_MAGIC = 0
_OFF_VERSION = 4
_OFF_RING_BYTES = 8
_OFF_GENERATION = 12  # futex word; even = serving, odd = resetting
_OFF_SERVER_PID = 16
_OFF_CLIENT_PID = 20
_OFF_CLOSED = 24  # server's clean-shutdown flag
_OFF_CLIENT_BUSY = 28  # client-inside-ring-mutation flag (reset handshake)
_SEG_HDR = 64

# ring header field offsets (relative to the ring header base)
_R_HEAD_SEQ = 0
_R_HEAD = 8  # uint64
_R_TAIL_SEQ = 16
_R_TAIL = 24  # uint64
_R_DATA_FUTEX = 32  # producer bumps after head advances
_R_SPACE_FUTEX = 36  # consumer bumps after tail advances
_RING_HDR = 64

_REQ_HDR = _SEG_HDR
_RSP_HDR = _SEG_HDR + _RING_HDR
_DATA0 = _SEG_HDR + 2 * _RING_HDR

DEFAULT_RING_BYTES = 4 << 20

# shm frame: uint32 rid | uint32 hlen | uint32 plen | header | payload |
# uint32 trailer.  rid matches responses to requests across timeouts (the
# TCP transport gets this for free by closing the socket); the trailer is
# the torn-write tripwire — a frame whose trailer does not check out is
# NEVER surfaced to the codec.
_FRAME = struct.Struct("<III")
_TRAILER = struct.Struct("<I")
_TRAILER_SALT = 0xA5C35A3C


def _trailer_word(rid: int, hlen: int, plen: int) -> int:
    return (rid ^ hlen ^ (plen << 1) ^ _TRAILER_SALT) & 0xFFFFFFFF


def segment_nbytes(ring_bytes: int) -> int:
    return _DATA0 + 2 * ring_bytes


class TornFrameError(ConnectionError):
    """A committed frame failed its trailer check — protocol corruption.

    Raised instead of ever handing the bytes to the codec."""


def _attach_raw(name: str) -> shared_memory.SharedMemory:
    """Attach WITHOUT leaving a resource-tracker registration behind.

    CPython (up to 3.12) registers a POSIX segment with the resource
    tracker on ATTACH as well as create, and the tracker UNLINKS every
    registered segment when its owning process dies.  Attaching
    processes here die mid-job by design — a SIGKILLed broker shard, an
    invocation-bounded worker — and their trackers would yank the live
    segment out from under every peer (the respawned shard then finds
    no segment and the pool wedges).  Only the creating supervisor owns
    unlink; ``Segment.unlink`` re-registers first so the bookkeeping
    stays balanced."""
    seg = shared_memory.SharedMemory(name=name)
    try:  # pragma: no branch
        from multiprocessing import resource_tracker

        resource_tracker.unregister(seg._name, "shared_memory")  # type: ignore[attr-defined]
    except Exception:  # pragma: no cover - tracker API moved
        pass
    return seg


class Segment:
    """One worker↔shard shm channel: header words + two rings.

    All cross-process words are accessed through ``ctypes`` objects bound
    directly into the mapping (single aligned stores).  Publication
    ordering relies on x86-TSO/total-store-order semantics plus the
    seqlock around the 64-bit cursors; DESIGN.md §12.2 records the
    assumption.
    """

    def __init__(self, seg: shared_memory.SharedMemory, owner: bool):
        self._seg = seg
        self.owner = owner
        self.name = seg.name
        buf = seg.buf
        self._u32 = {
            off: ctypes.c_uint32.from_buffer(buf, off)
            for off in (
                _OFF_MAGIC, _OFF_VERSION, _OFF_RING_BYTES, _OFF_GENERATION,
                _OFF_SERVER_PID, _OFF_CLIENT_PID, _OFF_CLOSED,
                _OFF_CLIENT_BUSY,
            )
        }
        self._ring_u32: dict[int, ctypes.c_uint32] = {}
        self._ring_u64: dict[int, ctypes.c_uint64] = {}
        for base in (_REQ_HDR, _RSP_HDR):
            for off in (_R_HEAD_SEQ, _R_TAIL_SEQ, _R_DATA_FUTEX,
                        _R_SPACE_FUTEX):
                self._ring_u32[base + off] = ctypes.c_uint32.from_buffer(
                    buf, base + off
                )
            for off in (_R_HEAD, _R_TAIL):
                self._ring_u64[base + off] = ctypes.c_uint64.from_buffer(
                    buf, base + off
                )
        # per-word adaptive spin budgets — process-local state (each side
        # measures the waits IT experiences), not part of the shared layout
        self._waiters: dict[int, _AdaptiveWaiter] = {}

    # -- lifecycle ------------------------------------------------------------

    @classmethod
    def create(cls, name: str, ring_bytes: int = DEFAULT_RING_BYTES
               ) -> "Segment":
        _require_supported()  # every channel flows from a created segment
        seg = shared_memory.SharedMemory(
            name=name, create=True, size=segment_nbytes(ring_bytes)
        )
        seg.buf[: segment_nbytes(ring_bytes)] = bytes(
            segment_nbytes(ring_bytes)
        )
        self = cls(seg, owner=True)
        self._u32[_OFF_RING_BYTES].value = ring_bytes
        self._u32[_OFF_VERSION].value = VERSION
        self._u32[_OFF_MAGIC].value = MAGIC  # magic last: readers gate on it
        return self

    @classmethod
    def attach(cls, name: str) -> "Segment":
        self = cls(_attach_raw(name), owner=False)
        if self._u32[_OFF_MAGIC].value != MAGIC:
            self.close()
            raise ConnectionError(f"shm segment {name!r}: bad magic")
        if self._u32[_OFF_VERSION].value != VERSION:
            v = self._u32[_OFF_VERSION].value
            self.close()
            raise ConnectionError(
                f"shm segment {name!r}: version {v} != {VERSION}"
            )
        return self

    def close(self) -> None:
        # ctypes objects exported from the buffer pin it: drop them first
        self._u32.clear()
        self._ring_u32.clear()
        self._ring_u64.clear()
        try:
            self._seg.close()
        except (OSError, BufferError):  # pragma: no cover
            pass

    def unlink(self) -> None:
        self.close()
        Segment.unlink_by_name(self.name)

    @staticmethod
    def unlink_by_name(name: str) -> None:
        # a plain attach RE-registers the name (see _attach_raw), so the
        # unregister inside SharedMemory.unlink always finds its entry —
        # balanced bookkeeping whatever mix of create/attach/unregister
        # this process did before
        try:
            seg = shared_memory.SharedMemory(name=name)
        except FileNotFoundError:
            return
        try:
            seg.unlink()
        finally:
            seg.close()

    # -- header words ---------------------------------------------------------

    @property
    def ring_bytes(self) -> int:
        return self._u32[_OFF_RING_BYTES].value

    @property
    def generation(self) -> int:
        return self._u32[_OFF_GENERATION].value

    def _word_addr(self, off: int) -> int:
        return ctypes.addressof(self._u32[off])

    def wait_generation(
        self,
        not_equal_to: int,
        timeout_s: float,
        check: Optional[Callable[[], None]] = None,
    ) -> int:
        """Block until ``generation`` is even and differs from
        ``not_equal_to``; returns the new generation."""
        deadline = time.monotonic() + timeout_s
        while True:
            g = self.generation
            if g != not_equal_to and g % 2 == 0 and g > 0:
                return g
            if check is not None:
                check()
            if time.monotonic() > deadline:
                raise ConnectionError(
                    f"shm segment {self.name!r}: no serving peer "
                    f"(generation stuck at {g})"
                )
            _futex_wait(self._word_addr(_OFF_GENERATION), g, _WAIT_SLICE_S)

    def set_server(self, pid: int) -> None:
        self._u32[_OFF_SERVER_PID].value = pid

    def set_client(self, pid: int) -> None:
        self._u32[_OFF_CLIENT_PID].value = pid

    @property
    def server_pid(self) -> int:
        return self._u32[_OFF_SERVER_PID].value

    @property
    def client_pid(self) -> int:
        return self._u32[_OFF_CLIENT_PID].value

    @property
    def closed_flag(self) -> bool:
        return bool(self._u32[_OFF_CLOSED].value)

    def set_closed(self) -> None:
        self._u32[_OFF_CLOSED].value = 1
        self._wake_all()

    def _set_busy(self, val: int) -> None:
        self._u32[_OFF_CLIENT_BUSY].value = val

    def _wake_all(self) -> None:
        for base in (_REQ_HDR, _RSP_HDR):
            _futex_wake(ctypes.addressof(
                self._ring_u32[base + _R_DATA_FUTEX]))
            _futex_wake(ctypes.addressof(
                self._ring_u32[base + _R_SPACE_FUTEX]))
        _futex_wake(self._word_addr(_OFF_GENERATION))

    def reset_rings(self, quiesce_s: float = 2.0) -> int:
        """Server-side (re)attach: invalidate, quiesce the client, zero
        both rings, publish a new even generation.  Returns it.

        The odd intermediate generation tells a mid-operation client to
        abort (its in-flight request is gone); the ``client_busy`` word
        is the handshake that keeps the reset from racing a client chunk
        copy that was already past its generation check.
        """
        g = self.generation
        self._u32[_OFF_GENERATION].value = g + 1 if g % 2 == 0 else g
        _futex_wake(self._word_addr(_OFF_GENERATION))
        deadline = time.monotonic() + quiesce_s
        while self._u32[_OFF_CLIENT_BUSY].value:
            pid = self.client_pid
            if pid and not _pid_alive(pid):
                break  # dead client cannot be mid-copy
            if time.monotonic() > deadline:
                break  # crashed-but-undetectable client; proceed
            time.sleep(0.001)
        for base in (_REQ_HDR, _RSP_HDR):
            for off in (_R_HEAD_SEQ, _R_TAIL_SEQ, _R_DATA_FUTEX,
                        _R_SPACE_FUTEX):
                self._ring_u32[base + off].value = 0
            for off in (_R_HEAD, _R_TAIL):
                self._ring_u64[base + off].value = 0
        self._u32[_OFF_CLOSED].value = 0
        self.set_server(os.getpid())
        newg = (self.generation // 2) * 2 + 2
        self._u32[_OFF_GENERATION].value = newg
        self._wake_all()
        return newg

    # -- seqlock cursors ------------------------------------------------------

    def _try_load_cursor(
        self, base: int, seq_off: int, val_off: int, tries: int = 3
    ) -> Optional[int]:
        """Bounded, non-blocking cursor read: None when the seqlock stays
        torn — the liveness checks use this so they never recurse into
        the spinning loads they guard."""
        seq = self._ring_u32[base + seq_off]
        val = self._ring_u64[base + val_off]
        for _ in range(tries):
            s1 = seq.value
            v = val.value
            s2 = seq.value
            if s1 == s2 and s1 % 2 == 0:
                return v
        return None

    def _load_cursor(
        self, base: int, seq_off: int, val_off: int,
        check: Optional[Callable[[], None]] = None,
    ) -> int:
        seq = self._ring_u32[base + seq_off]
        val = self._ring_u64[base + val_off]
        spins = 0
        while True:
            s1 = seq.value
            v = val.value
            s2 = seq.value
            if s1 == s2 and s1 % 2 == 0:
                return v
            spins += 1
            if spins % 1000 == 0:
                # a writer SIGKILLed between the two seqlock increments
                # leaves the word odd FOREVER — without this, the reader
                # spins at 100% cpu with its peer-death detection
                # unreachable
                if check is not None:
                    check()
                time.sleep(_POLL_SLEEP_S)

    def _store_cursor(self, base: int, seq_off: int, val_off: int,
                      value: int) -> None:
        seq = self._ring_u32[base + seq_off]
        seq.value += 1
        self._ring_u64[base + val_off].value = value
        seq.value += 1

    def _bump(self, base: int, futex_off: int) -> None:
        w = self._ring_u32[base + futex_off]
        w.value = (w.value + 1) & 0xFFFFFFFF
        _futex_wake(ctypes.addressof(w))

    def _word_value(self, base: int, futex_off: int) -> int:
        return self._ring_u32[base + futex_off].value

    def _wait_word(self, base: int, futex_off: int, captured: int) -> None:
        """Park until the word moves past ``captured`` — the caller MUST
        have captured the value BEFORE re-checking its wait condition, or
        a bump landing between check and wait is a lost wakeup (a
        50 ms-slice stall per message, not a correctness bug)."""
        w = self._ring_u32[base + futex_off]
        if w.value != captured:
            return  # already moved: don't sleep at all
        waiter = self._waiters.get(base + futex_off)
        if waiter is None:
            waiter = self._waiters[base + futex_off] = _AdaptiveWaiter()
        t0 = time.monotonic()
        budget = waiter.budget_s()
        spins = 0
        while budget > 0.0:
            if w.value != captured:
                waiter.record(time.monotonic() - t0)
                return
            spins += 1
            # monotonic() costs ~50 ns — amortize it across a batch of
            # word loads so the spin actually spins
            if spins % 64 == 0 and time.monotonic() - t0 >= budget:
                break
        _futex_wait(ctypes.addressof(w), captured, _WAIT_SLICE_S)
        # futex-path waits feed the EWMA too: a word that keeps parking
        # for milliseconds drags its budget toward the cap ONLY (bounded
        # spin), one that wakes in microseconds shrinks it back
        waiter.record(time.monotonic() - t0)


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:  # pragma: no cover - pid reused by another user
        return True
    return True


class _PidProbe:
    """Rate-limited liveness probe: generation/closed words are read on
    every wait iteration (ctypes loads, ~ns), but the ``os.kill`` syscall
    only every ``interval_s`` — peer death is a slow path, the probe must
    not tax the fast one."""

    def __init__(self, interval_s: float = 0.01):
        self.interval_s = interval_s
        self._last = 0.0

    def dead(self, pid: int) -> bool:
        if not pid:
            return False
        now = time.monotonic()
        if now - self._last < self.interval_s:
            return False
        self._last = now
        return not _pid_alive(pid)


class Ring:
    """One direction of a segment as a SPSC byte stream.

    ``role`` is 'producer' or 'consumer' — a ``Ring`` object only ever
    mutates the cursor its role owns, which is what makes the
    single-writer seqlocks sound.
    """

    def __init__(self, seg: Segment, base: int, role: str,
                 check: Optional[Callable[[], None]] = None):
        self.seg = seg
        self.base = base
        self.role = role
        self.check = check
        self.cap = seg.ring_bytes
        data0 = _DATA0 if base == _REQ_HDR else _DATA0 + self.cap
        self.data = seg._seg.buf[data0: data0 + self.cap]

    @staticmethod
    def _copy(dst, src) -> None:
        """memcpy that drops the GIL for big chunks (numpy) and skips the
        numpy overhead for small ones (plain buffer assignment)."""
        if len(src) >= _NP_COPY_MIN:
            import numpy as np

            np.copyto(
                np.frombuffer(dst, dtype=np.uint8),
                np.frombuffer(src, dtype=np.uint8),
            )
        else:
            dst[:] = src

    def release(self) -> None:
        if self.data is not None:
            self.data.release()
            self.data = None  # type: ignore[assignment]

    def _head(self) -> int:
        # the producer's cursor: only the peer can leave its seqlock torn,
        # so the consumer's liveness check guards the retry loop (and
        # symmetrically below) — never the cursor's own writer
        check = self.check if self.role == "consumer" else None
        return self.seg._load_cursor(self.base, _R_HEAD_SEQ, _R_HEAD, check)

    def _tail(self) -> int:
        check = self.check if self.role == "producer" else None
        return self.seg._load_cursor(self.base, _R_TAIL_SEQ, _R_TAIL, check)

    def _run_checks(self) -> None:
        if self.check is not None:
            self.check()

    # -- producer -------------------------------------------------------------

    def write_bytes(self, views: list, deadline: float) -> int:
        """Stream the buffer views into the ring; returns bytes written.

        The head cursor is published (and the peer woken) ONCE at the
        end for small frames — one wakeup per frame, not one per buffer
        view, which is the difference between a ~100 us and a multi-ms
        round trip when each wake is a thread switch.  Large frames
        commit every ``_COMMIT_CHUNK`` bytes (and whenever the ring
        fills), so the consumer's copy-out overlaps the producer's
        copy-in the way kernel socket buffering overlaps a ``sendmsg``
        with the peer's ``recv`` — and a frame larger than the ring
        still streams through.
        """
        assert self.role == "producer"
        head = self._head()
        committed = head
        total = 0

        def publish() -> None:
            nonlocal committed
            if head != committed:
                self.seg._store_cursor(self.base, _R_HEAD_SEQ, _R_HEAD, head)
                self.seg._bump(self.base, _R_DATA_FUTEX)
                committed = head

        for v in views:
            mv = memoryview(v).cast("B")
            off = 0
            n = len(mv)
            while off < n:
                self._run_checks()  # prompt generation/peer-death detection
                seq = self.seg._word_value(self.base, _R_SPACE_FUTEX)
                free = self.cap - (head - self._tail())
                if free == 0:
                    publish()  # let the consumer drain what we copied
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"shm ring {self.seg.name!r}: full for too long "
                            "(consumer stalled)"
                        )
                    self.seg._wait_word(self.base, _R_SPACE_FUTEX, seq)
                    continue
                pos = head % self.cap
                take = min(n - off, free, self.cap - pos)
                self._copy(self.data[pos: pos + take], mv[off: off + take])
                head += take
                off += take
                total += take
                if head - committed >= _COMMIT_CHUNK:
                    publish()
        publish()
        return total

    # -- consumer -------------------------------------------------------------

    def read_exact(self, n: int, deadline: float) -> bytes:
        assert self.role == "consumer"
        out = bytearray(n)
        got = 0
        tail = self._tail()
        while got < n:
            self._run_checks()
            seq = self.seg._word_value(self.base, _R_DATA_FUTEX)
            avail = self._head() - tail
            if avail == 0:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"shm ring {self.seg.name!r}: timed out waiting "
                        f"for {n - got} bytes"
                    )
                self.seg._wait_word(self.base, _R_DATA_FUTEX, seq)
                continue
            was_full = avail == self.cap
            pos = tail % self.cap
            take = min(n - got, avail, self.cap - pos)
            self._copy(
                memoryview(out)[got: got + take],
                self.data[pos: pos + take],
            )
            tail += take
            got += take
            self.seg._store_cursor(self.base, _R_TAIL_SEQ, _R_TAIL, tail)
            if was_full:
                # the producer only ever parks on the space futex after
                # publishing a FULL ring — waking on any other drain is a
                # wasted syscall on the per-message fast path
                self.seg._bump(self.base, _R_SPACE_FUTEX)
        return bytes(out)

    def poll_available(self) -> Optional[int]:
        """Committed-but-unread bytes; None when a cursor seqlock is torn
        (a peer died mid-store).  Non-blocking — safe to call from the
        liveness checks that guard the blocking loads."""
        head = self.seg._try_load_cursor(self.base, _R_HEAD_SEQ, _R_HEAD)
        tail = self.seg._try_load_cursor(self.base, _R_TAIL_SEQ, _R_TAIL)
        if head is None or tail is None:
            return None
        return head - tail


# -- framed messages over a ring pair ----------------------------------------


def send_frame(ring: Ring, rid: int, header: dict, payload: Payload,
               deadline: float) -> int:
    """Write one framed message; returns the bytes a TCP ``send_msg`` of
    the same message would report (rid + trailer are transport overhead,
    uncounted — byte accounting must be transport-invariant)."""
    views = _as_views(payload)
    plen = sum(len(v) for v in views)
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    ring.write_bytes(
        [
            memoryview(_FRAME.pack(rid, len(raw), plen)),
            memoryview(raw),
            *views,
            memoryview(_TRAILER.pack(_trailer_word(rid, len(raw), plen))),
        ],
        deadline,
    )
    return 8 + len(raw) + plen


def recv_frame(
    ring: Ring, deadline: float, frame_timeout_s: Optional[float] = None
) -> tuple[int, dict, bytes]:
    """Read one framed message → (rid, header, payload).

    The trailer word is verified before anything is surfaced: a frame
    that fails it (torn write, desynced stream) raises
    ``TornFrameError`` and is never decoded.

    ``frame_timeout_s`` (server side) bounds the body reads separately
    from the idle wait for the header: a frame whose header landed but
    whose body never completes is an ABANDONED half-frame (the client
    gave up mid-send and is waiting for a ring reset), surfaced as
    ``TornFrameError`` so the serving loop re-serves instead of blocking
    both sides against each other.
    """
    rid, hlen, plen = _FRAME.unpack(ring.read_exact(_FRAME.size, deadline))
    if hlen > (1 << 31) or plen > (1 << 31):
        raise TornFrameError(
            f"shm ring {ring.seg.name!r}: implausible frame ({hlen}, {plen})"
        )
    if frame_timeout_s is not None:
        deadline = min(deadline, time.monotonic() + frame_timeout_s)
    try:
        raw = ring.read_exact(hlen, deadline)
        payload = ring.read_exact(plen, deadline) if plen else b""
        (tw,) = _TRAILER.unpack(ring.read_exact(_TRAILER.size, deadline))
    except TimeoutError as e:
        if frame_timeout_s is None:
            raise
        raise TornFrameError(
            f"shm ring {ring.seg.name!r}: frame body stalled "
            f"(rid={rid}, hlen={hlen}, plen={plen}) — abandoned half-frame"
        ) from e
    if tw != _trailer_word(rid, hlen, plen):
        raise TornFrameError(
            f"shm ring {ring.seg.name!r}: frame trailer mismatch "
            f"(rid={rid}, hlen={hlen}, plen={plen})"
        )
    return rid, json.loads(raw.decode("utf-8")), payload


# -- client side: the Transport implementation --------------------------------


class ShmConnection:
    """Persistent framed request/response channel over one shm segment —
    the shared-memory twin of ``framing.Connection`` (same ``request`` /
    ``send_only`` / ``recv_response`` / ``close`` surface, so
    ``framing.pipelined`` and every retry loop work unchanged).

    'Reconnecting' means waiting for the serving broker to publish a NEW
    even generation (it resets the rings when it attaches), then
    replaying the request — the same idempotent-replay contract the TCP
    transport relies on.
    """

    def __init__(self, name: str, timeout: float = 30.0,
                 connect_wait_s: float = 5.0):
        self.name = name
        self.timeout = timeout
        self.connect_wait_s = connect_wait_s
        self._seg: Optional[Segment] = None
        self._req: Optional[Ring] = None
        self._rsp: Optional[Ring] = None
        self._gen = 0  # generation this client is attached under
        self._dead_gen = 0  # generation seen when the last failure hit
        self._rid = 0
        self._inflight = False
        self._probe = _PidProbe()

    # -- liveness checks ------------------------------------------------------

    def _check(self) -> None:
        seg = self._seg
        assert seg is not None
        if seg.closed_flag:
            raise ConnectionError(
                f"shm segment {self.name!r}: server closed"
            )
        g = seg.generation
        if g != self._gen:
            raise ConnectionError(
                f"shm segment {self.name!r}: server reset "
                f"(generation {self._gen} -> {g})"
            )
        if self._probe.dead(seg.server_pid):
            raise ConnectionError(
                f"shm segment {self.name!r}: server pid "
                f"{seg.server_pid} died"
            )

    # -- attach ---------------------------------------------------------------

    def _connect(self) -> None:
        deadline = time.monotonic() + self.connect_wait_s
        seg: Optional[Segment] = None
        while seg is None:
            try:
                seg = Segment.attach(self.name)
            except FileNotFoundError:
                if time.monotonic() > deadline:
                    raise ConnectionError(
                        f"shm segment {self.name!r} does not exist"
                    ) from None
                time.sleep(0.01)
        try:
            gen = seg.wait_generation(
                self._dead_gen, max(deadline - time.monotonic(), 0.05)
            )
        except ConnectionError:
            seg.close()
            raise
        seg.set_client(os.getpid())
        self._seg = seg
        self._gen = gen
        self._req = Ring(seg, _REQ_HDR, "producer", check=self._check)
        self._rsp = Ring(seg, _RSP_HDR, "consumer", check=self._check)
        self._inflight = False

    def _ensure(self) -> None:
        if self._seg is None:
            self._connect()

    # -- request/response -----------------------------------------------------

    def send_only(self, header: dict, payload: Payload = b"",
                  timeout: Optional[float] = None) -> None:
        t = timeout if timeout is not None else self.timeout
        for attempt in range(2):
            try:
                framing.chaos("send", header)
                self._ensure()
                seg = self._seg
                assert seg is not None
                rid = self._rid + 1
                deadline = time.monotonic() + t
                # busy-word handshake: a server-side ring reset must not
                # race a chunk copy in flight (reads need no guard — a
                # reset mid-read is caught by the generation check or the
                # frame trailer)
                seg._set_busy(1)
                try:
                    self._check()
                    send_frame(self._req, rid, header, payload, deadline)  # type: ignore[arg-type]
                finally:
                    seg._set_busy(0)
                self._rid = rid
                self._inflight = True
                return
            except (ConnectionError, OSError, TimeoutError):
                # a failed send may have committed a PARTIAL frame — the
                # stream is only trustworthy again after the server resets
                # the rings, so always demand a new generation here
                self.close(failed=True, force_stale=True)
                if attempt:
                    raise

    def recv_response(self, timeout: Optional[float] = None
                      ) -> tuple[dict, bytes]:
        if self._seg is None or not self._inflight:
            raise ConnectionError("no in-flight request on this channel")
        t = timeout if timeout is not None else self.timeout
        deadline = time.monotonic() + t
        try:
            framing.chaos("recv", {})
            while True:
                rid, hdr, payload = recv_frame(self._rsp, deadline)  # type: ignore[arg-type]
                if rid == self._rid:
                    self._inflight = False
                    return hdr, payload
                if rid > self._rid:
                    raise TornFrameError(
                        f"shm segment {self.name!r}: response rid {rid} "
                        f"from the future (expected {self._rid})"
                    )
                # rid < expected: the answer to a request we already gave
                # up on (timeout + replay) — drain and keep waiting
        except (ConnectionError, OSError, TimeoutError):
            self.close(failed=True)
            raise

    def request(self, header: dict, payload: Payload = b"",
                timeout: Optional[float] = None) -> tuple[dict, bytes]:
        last: Optional[Exception] = None
        for attempt in range(2):
            try:
                self.send_only(header, payload, timeout=timeout)
                return self.recv_response(timeout=timeout)
            except (ConnectionError, OSError, TimeoutError) as e:
                last = e
        assert last is not None
        raise last

    def close(self, failed: bool = False, force_stale: bool = False) -> None:
        if self._seg is not None:
            if failed:
                # only demand a NEW generation when the server side
                # actually went away or reset — a plain recv timeout with
                # a live, same-generation server may simply reattach (the
                # rid filter discards whatever late response still lands)
                stale = force_stale
                if not stale:
                    try:
                        stale = (
                            self._seg.generation != self._gen
                            or self._seg.closed_flag
                            or (self._seg.server_pid
                                and not _pid_alive(self._seg.server_pid))
                        )
                    except Exception:  # pragma: no cover - segment unmapped
                        stale = True
                if stale:
                    self._dead_gen = self._gen
            for ring in (self._req, self._rsp):
                if ring is not None:
                    ring.release()
            self._req = self._rsp = None
            self._seg.close()
            self._seg = None
        self._inflight = False

    def __enter__(self) -> "ShmConnection":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# -- server side --------------------------------------------------------------


class ShmServerChannel:
    """The broker-side end of one segment: recv requests, send responses.

    ``serve`` resets the rings and publishes a fresh generation — the
    listen()+accept() of this transport.  The handler loop shape matches
    a TCP socket handler: ``recv()`` blocks until a request or raises
    ``ConnectionError`` when the peer dies / the server is asked down.
    """

    def __init__(self, name: str,
                 stop: Optional[Callable[[], bool]] = None):
        self.name = name
        self.seg = Segment.attach(name)
        self.stop = stop
        self.gen = self.seg.reset_rings()
        self._probe = _PidProbe()
        self._req = Ring(self.seg, _REQ_HDR, "consumer", check=self._check)
        self._rsp = Ring(self.seg, _RSP_HDR, "producer", check=self._check)

    def _check(self) -> None:
        if self.stop is not None and self.stop():
            raise ConnectionError(
                f"shm segment {self.name!r}: server shutting down"
            )
        if self._probe.dead(self.seg.client_pid):
            # only fail if there is nothing left to consume: the client
            # may have published a full frame and exited cleanly.  A
            # torn cursor (None) from a mid-store death is equally dead.
            avail = self._req.poll_available()
            if avail is None or avail == 0:
                raise ConnectionError(
                    f"shm segment {self.name!r}: client pid "
                    f"{self.seg.client_pid} died"
                )

    def recv(self, timeout_s: float = 3600.0,
             frame_timeout_s: float = 60.0) -> tuple[int, dict, bytes]:
        return recv_frame(
            self._req, time.monotonic() + timeout_s,
            frame_timeout_s=frame_timeout_s,
        )

    def send(self, rid: int, header: dict, payload: Payload = b"",
             timeout_s: float = 60.0) -> int:
        return send_frame(
            self._rsp, rid, header, payload, time.monotonic() + timeout_s
        )

    def close(self, mark_closed: bool = False) -> None:
        if mark_closed:
            try:
                self.seg.set_closed()
            except Exception:  # pragma: no cover - segment already gone
                pass
        self._req.release()
        self._rsp.release()
        self.seg.close()
