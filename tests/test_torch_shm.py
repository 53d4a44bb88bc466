"""The port's shared-memory transport (DESIGN.md §12), on the CPU.

Rings: round trips through a small ring (empty, oversized and vectored
payloads, wraparound at fixed sizes), backpressure, the full-ring timeout,
a reader respawn, connecting with no serving generation, a trailer
mismatch, garbage attach, and a real SIGKILL mid-publish that never
decodes a torn frame (the counterparts of ``tests/test_wire_shm.py``).

Interop: the port keeps the JAX package's segment layout and frame format
byte for byte, so a JAX server answers a port client and the reverse, and
the same frame written by either leaves the same bytes in the segment.

Live: the port's FaaS job over shm at 2 broker shards gives the wire bytes
and final-params digest of tcp, through a worker SIGKILL and through a
broker-shard SIGKILL (WAL replay and a segment re-serve), and leaves
nothing of the job in /dev/shm.
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

from repro.wire import shm as jshm

from repro_torch import convert
from repro_torch.runtime import supervisor
from repro_torch.runtime.supervisor import FaaSJobConfig, run_job
from repro_torch.wire import shm

pytestmark = pytest.mark.skipif(
    not sys.platform.startswith("linux")
    or platform.machine() not in shm.SHM_MACHINES,
    reason="shm transport targets same-host Linux on TSO machines",
)

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


def _seg_name(tag: str) -> str:
    return f"mlpt{os.getpid():x}{tag}"


class _Harness:
    """One segment and a server thread echoing every request; ``server``
    picks whose ``ShmServerChannel`` answers."""

    def __init__(self, tag: str, ring_bytes: int = 1 << 12, server=shm):
        self.name = _seg_name(tag)
        self.seg = shm.Segment.create(self.name, ring_bytes=ring_bytes)
        self.errors: list = []
        self._stop = False
        self._server = server
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self) -> None:
        try:
            chan = self._server.ShmServerChannel(
                self.name, stop=lambda: self._stop)
            while not self._stop:
                try:
                    rid, hdr, payload = chan.recv(timeout_s=10.0)
                except (ConnectionError, TimeoutError):
                    break
                chan.send(rid, {"ok": True, "echo": hdr, "n": len(payload)},
                          payload)
            chan.close()
        except Exception as e:  # pragma: no cover - surfaced by close()
            self.errors.append(e)

    def close(self) -> None:
        self._stop = True
        self.thread.join(timeout=10.0)
        assert not self.thread.is_alive(), "server thread wedged"
        self.seg.unlink()
        assert not self.errors, self.errors


@pytest.fixture
def harness(request):
    h = _Harness(tag=str(abs(hash(request.node.name)) % 10**6))
    yield h
    h.close()


def test_roundtrip_small(harness):
    with shm.ShmConnection(harness.name, timeout=10.0) as conn:
        hdr, payload = conn.request({"t": "ping", "x": 1}, b"hello")
        assert hdr["ok"] and hdr["echo"]["x"] == 1
        assert payload == b"hello"


def test_roundtrip_oversized_frame_streams_through(harness):
    big = bytes(range(256)) * 64  # 4x the ring: streams through in chunks
    with shm.ShmConnection(harness.name, timeout=10.0) as conn:
        hdr, payload = conn.request({"t": "big"}, big)
        assert hdr["n"] == len(big) and payload == big


def test_vectored_payload_roundtrip(harness):
    with shm.ShmConnection(harness.name, timeout=10.0) as conn:
        hdr, payload = conn.request(
            {"t": "vec"}, [b"abc", b"", memoryview(b"defg")])
        assert payload == b"abcdefg"


@pytest.mark.parametrize("sizes", (
    (0,), (1024,), (1023, 1025), (0, 2048, 1, 4096), (12_000, 7, 3072),
    (5000, 0, 9999, 1024, 1),
))
def test_stream_roundtrip_wraparound(sizes):
    """Frames of fixed sizes through a 1 KiB ring: empty payloads, exact
    ring multiples and many-times-capacity frames wrap and reassemble
    bit-exactly, in order."""
    h = _Harness(tag=f"w{abs(hash(sizes)) % 10**6}", ring_bytes=1 << 10)
    try:
        with shm.ShmConnection(h.name, timeout=20.0) as conn:
            for i, n in enumerate(sizes):
                blob = bytes([(i + j) % 251 for j in range(n)])
                hdr, payload = conn.request({"i": i}, blob)
                assert hdr["echo"]["i"] == i and payload == blob
    finally:
        h.close()


def _client_ring(name):
    client = shm.Segment.attach(name)
    return client, shm.Ring(client, shm._REQ_HDR, "producer")


def test_backpressure_blocks_writer_until_reader_drains():
    name = _seg_name("bp")
    seg = shm.Segment.create(name, ring_bytes=1 << 10)
    try:
        chan = shm.ShmServerChannel(name)
        client, req = _client_ring(name)
        payload = b"z" * 4096  # 4x capacity: cannot fit without draining
        state = {"sent": None}

        def writer():
            state["sent"] = shm.send_frame(
                req, 1, {"t": "bp"}, payload, time.monotonic() + 20.0)

        t = threading.Thread(target=writer, daemon=True)
        t.start()
        time.sleep(0.3)
        assert t.is_alive() and state["sent"] is None  # parked on space
        rid, hdr, got = chan.recv(timeout_s=10.0)
        assert rid == 1 and got == payload
        t.join(timeout=10.0)
        assert not t.is_alive() and state["sent"] is not None
        req.release()
        client.close()
        chan.close()
    finally:
        seg.unlink()


def test_full_ring_times_out_without_reader():
    name = _seg_name("to")
    seg = shm.Segment.create(name, ring_bytes=1 << 10)
    try:
        chan = shm.ShmServerChannel(name)
        client, req = _client_ring(name)
        with pytest.raises(TimeoutError):
            shm.send_frame(req, 1, {"t": "stuck"}, b"z" * 4096,
                           time.monotonic() + 0.3)
        req.release()
        client.close()
        chan.close()
    finally:
        seg.unlink()


def test_reader_respawn_reattaches_and_replays():
    """A new server resets the rings and bumps the generation: the client's
    in-flight request fails with ConnectionError (never a wrong answer) and
    its replay lands on the new server."""
    name = _seg_name("rs")
    seg = shm.Segment.create(name, ring_bytes=1 << 12)
    try:
        ch1 = shm.ShmServerChannel(name)
        conn = shm.ShmConnection(name, timeout=5.0, connect_wait_s=5.0)
        conn.send_only({"t": "lost"}, b"x")
        ch2 = shm.ShmServerChannel(name)  # the respawn
        assert ch2.gen > ch1.gen
        with pytest.raises(ConnectionError):
            conn.recv_response(timeout=5.0)

        def serve_one():
            rid, hdr, payload = ch2.recv(timeout_s=10.0)
            ch2.send(rid, {"ok": True, "srv": 2}, payload)

        t = threading.Thread(target=serve_one, daemon=True)
        t.start()
        hdr, payload = conn.request({"t": "retry"}, b"abc")
        assert hdr["srv"] == 2 and payload == b"abc"
        t.join(timeout=10.0)
        conn.close()
        ch1.close()
        ch2.close()
    finally:
        seg.unlink()


def test_connect_requires_a_serving_generation():
    name = _seg_name("ng")
    seg = shm.Segment.create(name, ring_bytes=1 << 10)
    try:
        conn = shm.ShmConnection(name, timeout=1.0, connect_wait_s=0.3)
        with pytest.raises(ConnectionError):
            conn.request({"t": "nobody-home"})
    finally:
        seg.unlink()


def test_trailer_mismatch_raises_torn_frame():
    name = _seg_name("tf")
    seg = shm.Segment.create(name, ring_bytes=1 << 10)
    try:
        chan = shm.ShmServerChannel(name)
        client, req = _client_ring(name)
        raw = b"{}"
        frame = (shm._FRAME.pack(7, len(raw), 0) + raw
                 + shm._TRAILER.pack(0xDEADBEEF))  # wrong trailer
        req.write_bytes([memoryview(frame)], time.monotonic() + 5.0)
        with pytest.raises(shm.TornFrameError):
            chan.recv(timeout_s=5.0)
        req.release()
        client.close()
        chan.close()
    finally:
        seg.unlink()


def test_segment_attach_rejects_garbage():
    from multiprocessing import shared_memory

    name = _seg_name("bad")
    raw = shared_memory.SharedMemory(name=name, create=True, size=4096)
    try:
        with pytest.raises(ConnectionError):
            shm.Segment.attach(name)
    finally:
        raw.close()
        raw.unlink()


_KILL_CHILD = r"""
import os, sys, time
from repro_torch.wire import shm

seg = shm.Segment.attach(sys.argv[1])
seg.set_client(os.getpid())
req = shm.Ring(seg, shm._REQ_HDR, "producer")
rid = 0
while True:  # frames >> ring size: a SIGKILL lands mid-frame w.h.p.
    rid += 1
    shm.send_frame(req, rid, {"rid": rid}, bytes([rid % 256]) * 10_000,
                   time.monotonic() + 30.0)
"""


def test_sigkill_mid_publish_never_decodes_a_torn_frame():
    """A writer process SIGKILLed mid-publish: every frame the reader
    decodes is complete and exact; the partial frame raises."""
    name = _seg_name("kp")
    seg = shm.Segment.create(name, ring_bytes=1 << 12)
    try:
        chan = shm.ShmServerChannel(name)
        env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        proc = subprocess.Popen([sys.executable, "-c", _KILL_CHILD, name],
                                env=env)
        try:
            got = 0
            while got < 3:
                rid, hdr, payload = chan.recv(timeout_s=30.0)
                assert payload == bytes([rid % 256]) * 10_000
                got += 1
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=10.0)
            while True:  # drain what was committed; the torn tail raises
                try:
                    rid, hdr, payload = chan.recv(timeout_s=2.0)
                except (ConnectionError, TimeoutError):
                    break
                assert payload == bytes([rid % 256]) * 10_000, (
                    f"torn frame decoded at rid {rid} after SIGKILL")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10.0)
        chan.close()
    finally:
        seg.unlink()


# -- interop with the JAX package's transport -------------------------------------


def test_layout_constants_are_the_jax_packages():
    for k in ("MAGIC", "VERSION", "SHM_MACHINES", "_REQ_HDR", "_RSP_HDR",
              "_OFF_GENERATION", "_R_HEAD", "_R_TAIL"):
        assert getattr(shm, k) == getattr(jshm, k), k
    assert shm._FRAME.format == jshm._FRAME.format
    assert shm._TRAILER.format == jshm._TRAILER.format
    for n in (1 << 10, 1 << 12, 4 << 20):
        assert shm.segment_nbytes(n) == jshm.segment_nbytes(n)
    for args in ((1, 0, 0), (7, 123, 456), (2**31, 2**20, 5)):
        assert shm._trailer_word(*args) == jshm._trailer_word(*args)


@pytest.mark.parametrize("server,client", ((jshm, shm), (shm, jshm)),
                         ids=("jax-server-port-client",
                              "port-server-jax-client"))
def test_interop_both_ways(server, client):
    big = bytes(range(256)) * 40  # wraps a 4 KiB ring
    h = _Harness(tag=f"io{server is shm:d}", server=server)
    try:
        with client.ShmConnection(h.name, timeout=10.0) as conn:
            for i, blob in enumerate((b"", b"x", big)):
                hdr, payload = conn.request({"t": "io", "i": i}, blob)
                assert hdr["echo"] == {"t": "io", "i": i}
                assert payload == blob
    finally:
        h.close()


def test_the_same_frame_leaves_the_same_segment_bytes():
    """One frame written through each package into a fresh segment of each
    package: the two segments hold the same bytes."""
    images = []
    for mod, tag in ((shm, "bp"), (jshm, "bj")):
        name = _seg_name(tag)
        seg = mod.Segment.create(name, ring_bytes=1 << 10)
        try:
            req = mod.Ring(seg, mod._REQ_HDR, "producer")
            mod.send_frame(req, 42, {"t": "publish", "step": 3},
                           [b"abc", bytes(range(200))],
                           time.monotonic() + 5.0)
            req.release()
            images.append(bytes(seg._seg.buf[:mod.segment_nbytes(1 << 10)]))
        finally:
            seg.unlink()
    assert images[0] == images[1]


# -- the live job --------------------------------------------------------------------


WCFG = {"n_users": 120, "n_movies": 150, "n_ratings": 6000, "rank": 4,
        "batch_size": 64}
JOB = dict(workload="pmf", n_workers=3, total_steps=8, checkpoint_every=2,
           optimizer="nesterov", lr=0.08, isp_v=0.5, n_brokers=2,
           wire_scheme="bitmap", poll_interval_s=0.01, deadline_s=120.0)


def _left_in_dev_shm(token: str) -> list[str]:
    return [n for n in os.listdir("/dev/shm") if n.startswith(token)]


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    """tcp, shm, shm with worker 1 SIGKILLed at step 3, and shm with shard 1
    SIGKILLed at step 4, side by side."""
    from repro.runtime import build_workload

    tmp = tmp_path_factory.mktemp("shm_live")
    jp = build_workload("pmf", WCFG).params0
    p0 = convert.write_params0(str(tmp / "params0.npz"), ["U", "M"],
                               [np.asarray(jp.U), np.asarray(jp.M)])
    kws = {"tcp": {}, "shm": {"transport": "shm"},
           "worker_kill": {"transport": "shm", "kill_worker_at_step": (1, 3)},
           "broker_kill": {"transport": "shm", "kill_broker_at_step": (1, 4)}}
    cfgs = {k: FaaSJobConfig(run_dir=str(tmp / k), device="cpu",
                             workload_cfg=dict(WCFG, params0=p0),
                             **dict(JOB, **kw)) for k, kw in kws.items()}
    out: dict = {}

    def one(k):
        try:
            out[k] = run_job(cfgs[k])
        except BaseException as e:  # surfaced below
            out[k] = e

    threads = [threading.Thread(target=one, args=(k,)) for k in cfgs]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for v in out.values():
        if isinstance(v, BaseException):
            raise v
    digests = {k: [supervisor.final_params_digest(c, w) for w in range(3)]
               for k, c in cfgs.items()}
    return out, digests


@pytest.mark.parametrize("run", ("shm", "worker_kill", "broker_kill"))
def test_shm_is_bit_identical_to_tcp(live, run):
    res, digests = live
    tcp, got = res["tcp"], res[run]
    assert got["transport"] == "shm" and got["steps"] == 8
    assert got["dup_mismatches"] == 0 and got["invariant_max_err"] == 0.0
    assert [r["wire_bytes"] for r in got["history"]] == [
        r["wire_bytes"] for r in tcp["history"]]
    assert got["broker_update_bytes_per_shard"] == \
        tcp["broker_update_bytes_per_shard"]
    assert digests[run] == digests["tcp"]
    assert _left_in_dev_shm(got["shm_token"]) == []


def test_shm_faults_were_injected(live):
    res, _ = live
    assert [r["worker"] for r in res["worker_kill"]["respawns"]] == [1]
    assert res["worker_kill"]["n_invocations"] == 4
    assert [r["shard"] for r in res["broker_kill"]["broker_respawns"]] == [1]
    assert res["shm"]["n_invocations"] == 3
    assert res["tcp"]["broker_respawns"] == []
