"""Message framing + persistent connections (DESIGN.md §10).

Every message on the FaaS data path is::

    uint32 header_len | uint32 payload_len | header JSON (utf-8) | payload

The payload may be handed to ``send_msg`` as bytes OR as a list of buffer
views (what ``wire.codec.encode_tree_parts`` produces): the vectored form
goes out through one ``socket.sendmsg`` scatter-gather call — the encoded
leaf arrays are never copied into a joined blob.

``Connection`` is the persistent client channel that replaced the
one-shot connect-per-RPC pattern: a worker opens ONE socket to the broker
for the life of its invocation and runs every request/response round trip
over it (the broker's handler loops on the same socket).  A broken
connection reconnects transparently and retries once — every broker
operation is idempotent (publishes are dup-checked by digest, pulls are
reads), so an ambiguous failure mid-round-trip is safe to replay.
"""

from __future__ import annotations

import json
import os
import socket
import struct
from typing import Optional, Protocol, Union, runtime_checkable

_HDR = struct.Struct("<II")
MAX_MSG_BYTES = 1 << 31  # sanity bound on a single message

Payload = Union[bytes, bytearray, memoryview, list]

# -- fault-injection seam (runtime/faults.py, DESIGN.md §17) ------------------
#
# A process-global hook called at the client-side transport boundary:
# ``hook(side, header)`` with side in {"send", "recv"} immediately before
# the corresponding half of a round trip.  The hook may sleep (frame
# delay / stall) or raise ConnectionError (connection reset) — raising
# lands inside the transports' existing reconnect-and-replay path, so an
# injected reset exercises the REAL recovery machinery.  ``None`` (the
# default) costs one attribute load per call and nothing else: the
# default path stays byte-identical with the hook dormant.

_chaos_hook = None


def install_chaos_hook(fn) -> None:
    global _chaos_hook
    _chaos_hook = fn


def clear_chaos_hook() -> None:
    global _chaos_hook
    _chaos_hook = None


def chaos(side: str, header: dict) -> None:
    hook = _chaos_hook
    if hook is not None:
        hook(side, header)


def _as_views(payload: Payload) -> list[memoryview]:
    parts = payload if isinstance(payload, list) else [payload]
    return [memoryview(p).cast("B") for p in parts if len(p)]


try:
    _iov = int(os.sysconf("SC_IOV_MAX"))  # -1 = indeterminate (POSIX)
    _IOV_MAX = min(_iov, 1024) if _iov > 0 else 1024
except (AttributeError, ValueError, OSError):  # pragma: no cover
    _IOV_MAX = 1024


def _sendall_vectored(sock: socket.socket, bufs: list[memoryview]) -> None:
    """sendall over a list of buffers without joining them.

    Chunked to the kernel's IOV_MAX — one sendmsg over a deep pytree's
    thousands of leaf views would fail with EMSGSIZE.
    """
    bufs = list(bufs)
    while bufs:
        try:
            n = sock.sendmsg(bufs[:_IOV_MAX])
        except AttributeError:  # pragma: no cover - platforms without sendmsg
            sock.sendall(b"".join(bufs))
            return
        while n:
            if n >= len(bufs[0]):
                n -= len(bufs[0])
                bufs.pop(0)
            else:
                bufs[0] = bufs[0][n:]
                n = 0


def send_msg(sock: socket.socket, header: dict, payload: Payload = b"") -> int:
    """Write one framed message; returns total bytes on the wire."""
    views = _as_views(payload)
    plen = sum(len(v) for v in views)
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    _sendall_vectored(
        sock, [memoryview(_HDR.pack(len(raw), plen)), memoryview(raw), *views]
    )
    return _HDR.size + len(raw) + plen


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            raise ConnectionError("peer closed mid-message")
        buf.extend(chunk)
    return bytes(buf)


def recv_msg(sock: socket.socket) -> tuple[dict, bytes]:
    """Read one framed message → (header, payload)."""
    hlen, plen = _HDR.unpack(_recv_exact(sock, _HDR.size))
    if hlen > MAX_MSG_BYTES or plen > MAX_MSG_BYTES:
        raise ValueError(f"oversized message header ({hlen}, {plen})")
    header = json.loads(_recv_exact(sock, hlen).decode("utf-8"))
    payload = _recv_exact(sock, plen) if plen else b""
    return header, payload


def request(
    addr: tuple[str, int],
    header: dict,
    payload: Payload = b"",
    timeout: float = 30.0,
) -> tuple[dict, bytes]:
    """One-shot RPC round trip: connect, send, receive, close.

    Kept for rare, cold callers (CLI debugging); the hot path uses
    ``Connection``.
    """
    with socket.create_connection(addr, timeout=timeout) as sock:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        send_msg(sock, header, payload)
        return recv_msg(sock)


@runtime_checkable
class Transport(Protocol):
    """The pluggable client channel of the update path (DESIGN.md §12.1).

    One persistent request/response stream to one broker shard; strictly
    one outstanding request.  ``Connection`` (TCP) and ``shm.
    ShmConnection`` (shared memory) both implement it, and everything
    above the seam — ``pipelined``, the workers' retry loops, the
    supervisor's RPC — is written against this surface only.  The
    contract every implementation honours:

    * ``request`` retries once through a transparent reconnect; all
      broker ops are idempotent, so an ambiguous mid-round-trip failure
      is safe to replay;
    * ``send_only``/``recv_response`` split one round trip for the
      multi-shard fan-out;
    * failures surface as ``ConnectionError``/``OSError``/
      ``TimeoutError`` — never transport-specific types — so callers'
      retry windows are transport-agnostic.
    """

    def request(self, header: dict, payload: Payload = b"",
                timeout: Optional[float] = None) -> tuple[dict, bytes]: ...

    def send_only(self, header: dict, payload: Payload = b"",
                  timeout: Optional[float] = None) -> None: ...

    def recv_response(self, timeout: Optional[float] = None
                      ) -> tuple[dict, bytes]: ...

    def close(self) -> None: ...


TRANSPORTS = ("tcp", "shm")


def make_transport(
    kind: str,
    addr: Optional[tuple[str, int]] = None,
    shm_name: Optional[str] = None,
    timeout: float = 30.0,
) -> "Transport":
    """Transport factory: the ONE place a transport name becomes a
    channel.  ``tcp`` needs ``addr``; ``shm`` needs ``shm_name`` (the
    per-(worker, shard) segment the supervisor allocated)."""
    if kind == "tcp":
        if addr is None:
            raise ValueError("tcp transport requires addr=(host, port)")
        return Connection(addr, timeout=timeout)
    if kind == "shm":
        if shm_name is None:
            raise ValueError("shm transport requires shm_name")
        from repro_torch.wire.shm import ShmConnection  # lazy: Linux-only

        return ShmConnection(shm_name, timeout=timeout)
    raise ValueError(f"unknown transport {kind!r}; known: {TRANSPORTS}")


class Connection:
    """Persistent framed request/response channel (client side, TCP).

    One TCP connection, any number of sequential round trips.  On a
    connection failure the request is retried once over a fresh socket
    (idempotent server ops make the replay safe); a second failure
    propagates to the caller.
    """

    def __init__(self, addr: tuple[str, int], timeout: float = 30.0):
        self.addr = (addr[0], int(addr[1]))
        self.timeout = timeout
        self._sock: Optional[socket.socket] = None

    def _connect(self) -> socket.socket:
        sock = socket.create_connection(self.addr, timeout=self.timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock
        return sock

    def request(
        self,
        header: dict,
        payload: Payload = b"",
        timeout: Optional[float] = None,
    ) -> tuple[dict, bytes]:
        last: Optional[Exception] = None
        for attempt in range(2):
            sock = self._sock
            try:
                if sock is None:
                    sock = self._connect()
                sock.settimeout(timeout if timeout is not None
                                else self.timeout)
                chaos("send", header)
                send_msg(sock, header, payload)
                chaos("recv", header)
                return recv_msg(sock)
            except (ConnectionError, OSError, TimeoutError) as e:
                last = e
                self.close()
        assert last is not None
        raise last

    # -- pipelined half-operations (multi-shard fan-out) ----------------------
    #
    # ``send_only`` + ``recv_response`` split one round trip so a client
    # talking to N servers can send N requests before waiting for any
    # response — per-server latency (scheduling wakeups, WAL flushes, long
    # polls) then overlaps instead of summing.  Strictly one outstanding
    # request per connection; ``pipelined`` is the safe composition.

    def send_only(
        self, header: dict, payload: Payload = b"",
        timeout: Optional[float] = None,
    ) -> None:
        """Write one request without reading the response (reconnects and
        resends once on failure — server ops are idempotent)."""
        for attempt in range(2):
            sock = self._sock
            try:
                if sock is None:
                    sock = self._connect()
                sock.settimeout(timeout if timeout is not None
                                else self.timeout)
                chaos("send", header)
                send_msg(sock, header, payload)
                return
            except (ConnectionError, OSError, TimeoutError):
                self.close()
                if attempt:
                    raise

    def recv_response(
        self, timeout: Optional[float] = None
    ) -> tuple[dict, bytes]:
        """Read the response of the request ``send_only`` put in flight."""
        if self._sock is None:
            raise ConnectionError("no in-flight request on this connection")
        self._sock.settimeout(timeout if timeout is not None
                              else self.timeout)
        try:
            chaos("recv", {})
            return recv_msg(self._sock)
        except (ConnectionError, OSError, TimeoutError):
            self.close()  # never leave a half-read stream behind
            raise

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def __enter__(self) -> "Connection":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def pipelined(
    conns: list["Transport"],
    messages: list[tuple[dict, Payload]],
    timeout: Optional[float] = None,
) -> list[tuple[dict, bytes]]:
    """One round trip to N servers, overlapped: send every request, then
    collect every response.  Works over ANY ``Transport`` mix.  A channel
    that fails either half falls back to a fresh sequential ``request``
    (idempotent servers make the replay safe), so the result is
    positionally complete or raises.
    """
    results: list[Optional[tuple[dict, bytes]]] = [None] * len(conns)
    failed: list[int] = []
    for i, (conn, (header, payload)) in enumerate(zip(conns, messages)):
        try:
            conn.send_only(header, payload, timeout=timeout)
        except (ConnectionError, OSError, TimeoutError):
            failed.append(i)
    for i, conn in enumerate(conns):
        if i in failed:
            continue
        try:
            results[i] = conn.recv_response(timeout=timeout)
        except (ConnectionError, OSError, TimeoutError):
            failed.append(i)
    for i in failed:
        conns[i].close()  # force a clean socket for the replay
        header, payload = messages[i]
        results[i] = conns[i].request(header, payload, timeout=timeout)
    return results  # type: ignore[return-value]


# -- multi-part payloads (coalesced pull responses) ---------------------------


def pack_parts(parts: list[tuple[dict, Payload]]) -> tuple[list[dict], list]:
    """Coalesce several (descriptor, payload) pairs into one message.

    Returns (descriptors, flat buffer list) — the buffer list feeds
    ``send_msg`` directly (no join).  Each descriptor gains an ``nbytes``
    so the peer can slice the concatenated payload back apart.
    """
    descs = []
    bufs: list = []
    for desc, blob in parts:
        views = _as_views(blob)
        d = dict(desc)
        d["nbytes"] = sum(len(v) for v in views)
        descs.append(d)
        bufs.extend(views)
    return descs, bufs


def unpack_parts(
    descs: list[dict], payload: Payload
) -> list[tuple[dict, memoryview]]:
    view = memoryview(payload if not isinstance(payload, list)
                      else b"".join(payload)).cast("B")
    out = []
    off = 0
    for d in descs:
        n = int(d["nbytes"])
        out.append((d, view[off : off + n]))
        off += n
    if off != len(view):
        raise ValueError(
            f"trailing bytes in multi-part payload: {len(view) - off}"
        )
    return out
