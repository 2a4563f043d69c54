"""Wire backends: where a :class:`~repro_torch.wire.codec.WireMessage` becomes
bytes and crosses a party boundary.

Both backends speak the same frames — ``codec.frame(codec.encode(msg))``
— and report the same measured byte count for the same message, so the
privacy ledger's serialized-byte metering is backend-independent:

* :class:`LoopbackBackend` — an in-process queue pair. The default wire.
  Messages are genuinely encoded to bytes and decoded on the far side
  (no object sharing), so loopback runs measure exactly what a socket
  run would, and the training trace stays bitwise-identical to the
  legacy direct-call engine.
* :class:`SocketBackend` — length-prefixed frames over a TCP stream, so
  a client party can run in another process.

``send``/``recv`` are host-boundary operations by construction — they
serialize device tensors and block on I/O — and every data-plane frame
they move is metered by ``Transport.account_wire``.

Ported from the JAX package's ``wire/backend.py``; the frames are the
same bytes, so a backend of either package talks to the other's.
"""
from __future__ import annotations

import collections
import socket as _socket
import time
from typing import Optional, Protocol, Tuple, runtime_checkable

from repro_torch.analysis import tags
from repro_torch.wire import codec
from repro_torch.wire.codec import WireMessage

DEFAULT_TIMEOUT_S = 120.0


class WireClosed(ConnectionError):
    """The peer closed the wire (clean EOF or reset)."""


class WireTimeout(TimeoutError):
    """No frame arrived within the recv timeout."""


@runtime_checkable
class WireBackend(Protocol):
    """What the engine and workers need from a wire.

    ``send`` returns the measured frame size in bytes (length prefix
    included); ``recv`` returns the decoded message plus the same
    measurement on the receiving side — equal by construction, so either
    end can feed ``Transport.account_wire``."""

    def send(self, msg: WireMessage) -> int: ...

    def recv(self, timeout: Optional[float] = None
             ) -> Tuple[WireMessage, int]: ...

    def close(self) -> None: ...


# ============================================================= loopback ====

class LoopbackBackend:
    """In-process queue pair that still round-trips every frame through
    the byte codec — the far end sees decoded bytes, never shared
    objects, so loopback and socket runs are the same protocol at
    different transport latencies."""

    def __init__(self, inbox: collections.deque,
                 outbox: collections.deque) -> None:
        self._inbox = inbox
        self._outbox = outbox
        self._open = True

    @classmethod
    def pair(cls) -> Tuple["LoopbackBackend", "LoopbackBackend"]:
        """Two cross-wired endpoints (engine end, worker end)."""
        a: collections.deque = collections.deque()
        b: collections.deque = collections.deque()
        return cls(inbox=a, outbox=b), cls(inbox=b, outbox=a)

    @tags.wire("up", accounted_by="Transport.account_wire", kind="frame",
               reason="loopback uplink frames: encoded bytes queued for "
                      "the peer endpoint, metered at their serialized size")
    @tags.wire("down", accounted_by="Transport.account_wire", kind="frame",
               reason="the same queue carries downlink frames; direction "
                      "is a property of the sender's role, not the wire")
    @tags.host_boundary("serializes device tensors into a host-side frame "
                        "queue — the party boundary of the in-proc wire")
    def send(self, msg: WireMessage) -> int:
        if not self._open:
            raise WireClosed("send on a closed loopback endpoint")
        buf = codec.frame(codec.encode(msg))
        self._outbox.append(buf)
        return len(buf)

    def send_bytes(self, buf: bytes) -> int:
        """Raw-frame transmit (the :class:`~repro_torch.wire.faults.ChaosBackend`
        hook): queue already-framed — possibly deliberately damaged —
        bytes for the peer."""
        if not self._open:
            raise WireClosed("send on a closed loopback endpoint")
        self._outbox.append(buf)
        return len(buf)

    @tags.host_boundary("decodes host-side frame bytes back into arrays; "
                        "blocks the host loop, never a trace")
    def recv(self, timeout: Optional[float] = None
             ) -> Tuple[WireMessage, int]:
        # loopback peers run in the same thread (the engine pumps the
        # worker), so an empty inbox cannot fill by waiting
        if not self._inbox:
            if not self._open:
                raise WireClosed("recv on a closed loopback endpoint")
            raise WireTimeout("loopback inbox empty (peer not pumped?)")
        buf = self._inbox.popleft()
        return codec.decode(buf[codec.FRAME_OVERHEAD:]), len(buf)

    def pending(self) -> int:
        return len(self._inbox)

    def close(self) -> None:
        self._open = False


# =============================================================== socket ====

class SocketBackend:
    """Length-prefixed frames over a connected TCP stream.

    Constructed via :meth:`connect` with ``self_heal=True`` the backend
    remembers its dial target and, when the stream dies mid-``send`` /
    mid-``recv``, re-dials it with exponential backoff before giving up —
    a worker survives the engine dropping and re-accepting its
    connection (or an engine restart on the same port) instead of dying
    with the first broken pipe. Accepted (listener-side) backends have no
    dial target and always fail fast."""

    def __init__(self, sock: _socket.socket) -> None:
        sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
        self._sock = sock
        self._peer: Optional[Tuple[str, int]] = None
        self._heal_attempts = 0
        self._heal_delay_s = 0.0
        self.reconnects = 0         # successful self-heals (observability)

    @classmethod
    def connect(cls, host: str, port: int, *, retries: int = 100,
                delay_s: float = 0.1, self_heal: bool = False,
                heal_attempts: int = 5,
                heal_delay_s: float = 0.05) -> "SocketBackend":
        """Dial the engine's listener, retrying while it comes up (the
        subprocess child usually races the parent's ``accept``).

        ``self_heal=True`` arms mid-stream reconnect: a ``WireClosed``
        during ``send``/``recv`` triggers up to ``heal_attempts`` re-dials
        with exponential backoff starting at ``heal_delay_s``."""
        last: Optional[Exception] = None
        for _ in range(retries):
            try:
                be = cls(_socket.create_connection((host, port)))
                if self_heal:
                    be._peer = (host, port)
                    be._heal_attempts = heal_attempts
                    be._heal_delay_s = heal_delay_s
                return be
            except OSError as e:  # pragma: no cover - timing dependent
                last = e
                time.sleep(delay_s)
        raise WireClosed(f"could not connect to {host}:{port}: {last}")

    def _reconnect(self, cause: Exception) -> None:
        """Re-dial the remembered peer with exponential backoff; raises
        ``WireClosed`` (chained to ``cause``) once the budget is spent."""
        if self._peer is None:
            raise cause
        host, port = self._peer
        try:
            self._sock.close()
        except OSError:  # pragma: no cover - already torn down
            pass
        delay = self._heal_delay_s
        last: Exception = cause
        for _ in range(self._heal_attempts):
            try:
                sock = _socket.create_connection((host, port))
                sock.setsockopt(_socket.IPPROTO_TCP,
                                _socket.TCP_NODELAY, 1)
                self._sock = sock
                self.reconnects += 1
                return
            except OSError as e:
                last = e
                time.sleep(delay)
                delay *= 2
        raise WireClosed(
            f"could not re-dial {host}:{port} after "
            f"{self._heal_attempts} attempts: {last}") from cause

    @tags.wire("up", accounted_by="Transport.account_wire", kind="frame",
               reason="TCP uplink frames: the length-prefixed bytes are "
                      "the measured wire cost of the message")
    @tags.wire("down", accounted_by="Transport.account_wire", kind="frame",
               reason="the same stream carries downlink frames; direction "
                      "is a property of the sender's role, not the wire")
    @tags.host_boundary("serializes device tensors and writes them to a "
                        "kernel socket buffer — a genuine process boundary")
    def send(self, msg: WireMessage) -> int:
        buf = codec.frame(codec.encode(msg))
        try:
            self._sock.sendall(buf)
        except OSError as e:
            self._reconnect(WireClosed(f"peer gone during send: {e}"))
            # healed: the frame may have been torn mid-stream — resend it
            # whole on the fresh connection (the far side reads a clean
            # frame; the torn prefix died with the old socket)
            try:
                self._sock.sendall(buf)
            except OSError as e2:  # pragma: no cover - peer flapping
                raise WireClosed(f"peer gone during resend: {e2}") from e2
        return len(buf)

    def send_bytes(self, buf: bytes) -> int:
        """Raw-frame transmit (the :class:`~repro_torch.wire.faults.ChaosBackend`
        hook): push already-framed — possibly deliberately damaged —
        bytes down the stream."""
        try:
            self._sock.sendall(buf)
        except OSError as e:
            raise WireClosed(f"peer gone during send: {e}") from e
        return len(buf)

    @tags.host_boundary("blocking read from a kernel socket buffer back "
                        "into host tensors; never inside a trace")
    def recv(self, timeout: Optional[float] = None
             ) -> Tuple[WireMessage, int]:
        self._sock.settimeout(DEFAULT_TIMEOUT_S if timeout is None
                              else timeout)
        try:
            prefix = self._recv_exact(codec.FRAME_OVERHEAD)
        except WireClosed as e:
            # between frames: safe to heal and wait for the next one (a
            # frame torn mid-read is NOT resumable — that stays fatal)
            self._reconnect(e)
            self._sock.settimeout(DEFAULT_TIMEOUT_S if timeout is None
                                  else timeout)
            prefix = self._recv_exact(codec.FRAME_OVERHEAD)
        body = self._recv_exact(codec.unframe_length(prefix))
        return codec.decode(body), len(prefix) + len(body)

    def _recv_exact(self, n: int) -> bytes:
        chunks = []
        got = 0
        while got < n:
            try:
                chunk = self._sock.recv(n - got)
            except _socket.timeout as e:
                raise WireTimeout(
                    f"no frame within timeout ({got}/{n} bytes)") from e
            except OSError as e:
                raise WireClosed(f"peer gone during recv: {e}") from e
            if not chunk:
                raise WireClosed(f"peer closed mid-frame ({got}/{n} bytes)")
            chunks.append(chunk)
            got += len(chunk)
        return b"".join(chunks)

    def close(self) -> None:
        try:
            self._sock.shutdown(_socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()


def listen(host: str = "127.0.0.1", port: int = 0
           ) -> Tuple[_socket.socket, int]:
    """Open a listener for worker processes to dial; returns the bound
    (socket, port) — port 0 lets the OS pick a free one."""
    srv = _socket.socket(_socket.AF_INET, _socket.SOCK_STREAM)
    srv.setsockopt(_socket.SOL_SOCKET, _socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen()
    return srv, srv.getsockname()[1]


def accept(listener: _socket.socket,
           timeout: Optional[float] = None) -> SocketBackend:
    listener.settimeout(DEFAULT_TIMEOUT_S if timeout is None else timeout)
    try:
        sock, _ = listener.accept()
    except _socket.timeout as e:
        raise WireTimeout("no worker dialed the listener in time") from e
    return SocketBackend(sock)
