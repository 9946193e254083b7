"""Wire layer for the process fabric: length-prefixed pickle frames.

Port of :mod:`repro.serving.ipc` (pure Python, copied: the same frames,
byte for byte). Every payload that crosses a wire holds numpy arrays and
plain Python values, never a torch tensor, so unpickling a reply does not
bring up a CUDA context in the gateway.

One frame is ``<I little-endian byte count><pickle bytes>``. That is the
entire protocol — no negotiation, no compression, no partial frames: a
:class:`Wire` wraps one connected ``AF_UNIX`` stream socket and gives
both ends ``send(obj)`` / ``recv() -> obj`` with an internal lock per
direction, so the gateway's receiver thread can block in ``recv`` while
scheduler callback threads ``send`` replies concurrently.

Message vocabulary (all plain picklable dataclasses):

* :class:`Hello` — a freshly spawned worker introduces itself (id, pid).
* :class:`Request` — gateway -> worker: a correlation ``id``, a ``kind``
  from :data:`KINDS`, and a kind-specific payload (numpy arrays pickle
  fine; reads are small relative to the index, which never crosses the
  wire — workers mmap it from disk).
* :class:`Reply` — worker -> gateway: the request's ``id`` plus either a
  ``payload`` or a pickled exception in ``error`` (the gateway re-raises
  it into the caller's future, so a worker-side rejection reads exactly
  like an in-process one).

Why pickle and not a public serialization format: both ends of every
wire are processes the fabric itself spawned, talking over a private
``AF_UNIX`` socket in a mode-0700 runtime directory — the trust boundary
is the process boundary, not the wire. Nothing here accepts frames from
the network.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import socket
import struct
import threading
from typing import Optional

__all__ = [
    "Hello",
    "Request",
    "Reply",
    "Wire",
    "WireClosed",
    "KINDS",
    "listen",
    "connect",
]

_LEN = struct.Struct("<I")
# a frame is a query batch, an ack, or a journal tail — never the index;
# anything past this is a protocol bug, not a big message
MAX_FRAME = 1 << 30

KINDS = ("replay", "query", "insert", "compact", "stats", "shutdown")


class WireClosed(ConnectionError):
    """The peer hung up (EOF mid-frame or a dead socket) — for the
    gateway this IS the worker-death signal."""


@dataclasses.dataclass(frozen=True)
class Hello:
    """First frame a worker sends after connecting."""

    worker_id: int
    pid: int


@dataclasses.dataclass(frozen=True)
class Request:
    """Gateway -> worker. ``id`` correlates the eventual :class:`Reply`.

    ``trace`` carries the observability trace context —
    ``(trace_id, parent_span_id)`` minted at the gateway — so spans the
    worker opens stitch as children of the gateway's dispatch span
    (:mod:`repro_torch.obs.trace`). Defaulted for wire compatibility with
    frames from code that predates the field.
    """

    id: int
    kind: str
    payload: object = None
    trace: Optional[tuple] = None


@dataclasses.dataclass(frozen=True)
class Reply:
    """Worker -> gateway. Exactly one of payload / error is meaningful."""

    id: int
    payload: object = None
    error: Optional[BaseException] = None


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly ``n`` bytes or raise :class:`WireClosed` on EOF.

    Short reads are the NORM on a stream socket — the kernel hands back
    whatever is buffered, so a frame (or even its 4-byte length prefix)
    can arrive in arbitrarily small pieces; this loop reassembles them.
    EINTR gets an explicit retry: ``InterruptedError`` is an ``OSError``
    subclass, so without its own clause a signal landing mid-frame would
    be misreported as peer death (regression-tested in
    ``tests/test_torch_fabric.py``).
    """
    chunks = []
    while n:
        try:
            chunk = sock.recv(min(n, 1 << 20))
        except InterruptedError:
            continue              # EINTR: the peer is fine, just retry
        except OSError as e:
            raise WireClosed(f"socket died mid-frame: {e}") from e
        if not chunk:
            raise WireClosed("peer closed the wire")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


class Wire:
    """One framed, thread-safe duplex channel over a connected socket."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._send_lock = threading.Lock()
        self._recv_lock = threading.Lock()

    def send(self, obj) -> None:
        data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        if len(data) > MAX_FRAME:
            raise ValueError(
                f"refusing to send a {len(data)}-byte frame (> {MAX_FRAME}); "
                f"the index never crosses the wire — this is a protocol bug")
        with self._send_lock:
            try:
                # sendall retries EINTR internally (PEP 475); an exception
                # escaping it leaves the stream position unknown, so a
                # frame-level retry could desynchronize — fail the wire
                self._sock.sendall(_LEN.pack(len(data)) + data)
            except OSError as e:
                raise WireClosed(f"send on a dead wire: {e}") from e

    def recv(self):
        with self._recv_lock:
            n, = _LEN.unpack(_recv_exact(self._sock, _LEN.size))
            if n > MAX_FRAME:
                raise WireClosed(
                    f"peer announced a {n}-byte frame (> {MAX_FRAME}) — "
                    f"stream is desynchronized")
            return pickle.loads(_recv_exact(self._sock, n))

    def close(self) -> None:
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()

    def __enter__(self) -> "Wire":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def listen(path: str, backlog: int = 16) -> socket.socket:
    """Bind + listen on an ``AF_UNIX`` socket at ``path`` (replacing a
    stale one from a previous run)."""
    if os.path.exists(path):
        os.unlink(path)
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.bind(path)
    sock.listen(backlog)
    return sock


def connect(path: str, timeout_s: float = 30.0) -> Wire:
    """Connect to the gateway's listener (worker boot path)."""
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.settimeout(timeout_s)
    sock.connect(path)
    sock.settimeout(None)
    return Wire(sock)
