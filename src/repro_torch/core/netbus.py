"""NetBus: the networked AgentBus client (paper §3: components "can be
collocated, or isolated on different physical processes or machines").

``NetBus`` implements the full ``AgentBus`` surface over a TCP connection
to a ``repro.launch.bus_server`` process, so every consumer of the bus —
``LogActAgent``, voters, the lifecycle/checkpoint machinery, ``BusObserver``
introspection, ``BusClient`` ACLs — works unchanged against a bus living in
another OS process (or another machine). The wire contract is the batched
cursor protocol of the local backends, frozen in ``docs/bus-protocol.md``:

* ``append_many`` — one request per batch; contiguous positions assigned by
  the server. Each batch carries a client-generated ``batch`` token the
  server deduplicates, so a retry after a connection error can never
  double-append (exactly-once per server incarnation).
* ``read``/``poll`` — cursor ranges with push-down ``types=`` filtering
  (the filter travels to the server, which pushes it into the backing
  backend's native filter — SQL ``WHERE type IN``, per-type index,
  in-segment scan).
* ``tail`` — served from the client's **push-fed local view** (see below),
  zero round-trips in steady state; ``tail(refresh=True)`` forces one RPC.
* ``trim``/``compact``/``trim_base`` — lifecycle ops; a read below the
  server's base raises the same typed ``TrimmedError`` as the local
  backends (the error carries ``requested``/``base`` over the wire).
* ``wait`` — **server-pushed append notifications**: the connection
  subscribes at hello time and the server pushes an ``append`` event frame
  on every append from any client. ``wait()`` therefore blocks on a local
  condition variable at zero idle cost and wakes at push latency —
  MemoryBus-grade wake semantics for a cross-process bus, replacing the
  durable backends' adaptive backoff polling.

Framing: every frame is a 4-byte big-endian length prefix + a payload,
both directions. A payload starting with ``{`` is a UTF-8 JSON object (the
v1 format, unchanged); a payload starting with the ``0x00`` marker byte is
a **binary message**: marker + u32 meta-length + JSON meta object +
concatenated binary entry frames (``core.codec``). Requests carry ``id``;
responses echo it; frames with an ``event`` field and no ``id`` are server
pushes (always JSON — they are tiny).

Codec negotiation (additive — no proto bump): a client that can speak the
binary entry codec offers ``"codecs": ["binary"]`` at hello; a server that
accepts replies ``"codec": "binary"`` and both sides then move the bulk
data — ``append`` payloads and ``read`` entries — as binary entry frames,
lazily decoded on receipt. Either side omitting the field (an older peer,
or ``LOGACT_CODEC=json``) leaves the connection on pure JSON; mixed
clients coexist on one server because the codec is per-connection.

Failure model: requests are retried with exponential backoff against
connection errors until ``request_timeout`` (appends are retry-safe via the
batch token); a lost connection is re-established lazily and the hello
response's ``epoch`` (a per-server-incarnation id) fences the reconnect —
if the epoch changed, the server was restarted, so the push-fed tail view
and trim base are re-seeded from the hello snapshot instead of trusting
stale local caches. A component SIGKILL'd and restarted simply constructs
a fresh ``NetBus`` and runs its normal snapshot-anchored ``bootstrap``.

Because every append flows through the single server, the push-fed tail
view is complete: it can lag the server by one propagation delay but never
runs ahead, and the client folds its own append acknowledgements into the
view so read-your-writes always holds.
"""
from __future__ import annotations

import itertools
import json
import random
import socket
import struct
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import codec as entry_codec
from .acl import AclError
from .bus import AgentBus, TrimmedError, TypeFilter
from .entries import Entry, Payload, PayloadType, _json_default
from .faults import fault_point

#: Wire protocol version. Versioning rules (docs/bus-protocol.md): additive
#: fields are minor and MUST be ignored by peers that don't know them;
#: breaking changes bump this integer and the server rejects mismatches
#: with error="proto".
PROTO_VERSION = 1

#: Hard cap on a single frame; a longer length prefix means a corrupt or
#: hostile stream and kills the connection.
MAX_FRAME_BYTES = 64 << 20

_HDR = struct.Struct(">I")


# ---------------------------------------------------------------------------
# Framing (shared with repro.launch.bus_server)
# ---------------------------------------------------------------------------

def send_frame(sock: socket.socket, obj: Dict[str, Any]) -> None:
    """Serialize ``obj`` as one length-prefixed JSON frame and send it."""
    data = json.dumps(obj, separators=(",", ":"),
                      default=_json_default).encode()
    sock.sendall(_HDR.pack(len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("bus connection closed by peer")
        buf.extend(chunk)
    return bytes(buf)


def recv_frame(sock: socket.socket) -> Dict[str, Any]:
    """Receive one length-prefixed JSON frame (blocking)."""
    (length,) = _HDR.unpack(_recv_exact(sock, _HDR.size))
    if length > MAX_FRAME_BYTES:
        raise ConnectionError(f"oversized frame ({length} bytes)")
    return json.loads(_recv_exact(sock, length).decode())


#: First payload byte of a binary message (JSON objects start with '{').
BINARY_MARKER = b"\x00"


def send_binary_frame(sock: socket.socket, meta: Dict[str, Any],
                      blob: bytes) -> None:
    """Send one binary message: ``0x00`` marker + u32 meta length + JSON
    meta + concatenated binary entry frames, in a single send. Only sent on
    connections that negotiated ``codec=binary`` at hello."""
    data = json.dumps(meta, separators=(",", ":"),
                      default=_json_default).encode()
    body_len = 1 + _HDR.size + len(data) + len(blob)
    sock.sendall(b"".join((_HDR.pack(body_len), BINARY_MARKER,
                           _HDR.pack(len(data)), data, blob)))


def recv_any(sock: socket.socket) -> Tuple[Dict[str, Any], Optional[bytes]]:
    """Receive one frame of either format: returns ``(obj, None)`` for a
    JSON frame, ``(meta, entry_frames_blob)`` for a binary message."""
    (length,) = _HDR.unpack(_recv_exact(sock, _HDR.size))
    if length > MAX_FRAME_BYTES:
        raise ConnectionError(f"oversized frame ({length} bytes)")
    data = _recv_exact(sock, length)
    if data[:1] == BINARY_MARKER:
        (mlen,) = _HDR.unpack_from(data, 1)
        if 5 + mlen > len(data):
            raise ConnectionError("corrupt binary message (meta overruns)")
        meta = json.loads(data[5:5 + mlen].decode())
        return meta, data[5 + mlen:]
    return json.loads(data.decode()), None


def parse_address(address: "str | Tuple[str, int]") -> Tuple[str, int]:
    """Accept ``"host:port"``, ``"port"``, or a ``(host, port)`` tuple."""
    if isinstance(address, str):
        host, _, port = address.rpartition(":")
        return (host or "127.0.0.1", int(port))
    host, port = address
    return (host, int(port))


class _Reply:
    __slots__ = ("event", "frame", "blob", "error", "sock")

    def __init__(self, sock: socket.socket) -> None:
        self.event = threading.Event()
        self.frame: Optional[Dict[str, Any]] = None
        self.blob: Optional[bytes] = None  # binary read responses
        self.error: Optional[Exception] = None
        self.sock = sock


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------

class NetBus(AgentBus):
    """AgentBus over a TCP connection to a ``bus_server`` process.

    One instance is safe for concurrent use from many threads (one socket,
    request/response multiplexed by id; a background reader thread routes
    responses and folds pushed ``append`` events into the local tail view).
    Components in *different processes* each construct their own NetBus.

    Parameters:
      address          ``"host:port"`` (or ``(host, port)``) of the server.
      client_id        identity sent at hello (dedupe scope + server logs).
      role             optional server-side ACL role (defense in depth; the
                       primary ACL layer is the client-side ``BusClient``).
      connect_timeout  total budget for establishing the first connection.
      request_timeout  per-request budget, *including* reconnect retries.
      codec            ``"auto"`` (default) offers the binary entry codec
                       at hello and uses it if the server accepts;
                       ``"json"`` never offers it (the pre-codec wire,
                       byte-identical to proto v1 JSON clients). Forced to
                       ``"json"`` by ``LOGACT_CODEC=json``. The negotiated
                       result is per-connection: ``wire_codec``.
    """

    def __init__(self, address: "str | Tuple[str, int]",
                 client_id: Optional[str] = None,
                 role: Optional[str] = None,
                 connect_timeout: float = 10.0,
                 request_timeout: float = 30.0,
                 codec: str = "auto") -> None:
        self._addr = parse_address(address)
        # Offer binary only when this process can decode whatever body
        # codec the server's log may hold (msgpack by default).
        self._offer_binary = (codec == "auto"
                              and entry_codec.HAVE_MSGPACK
                              and not entry_codec.legacy_json_mode())
        #: negotiated wire codec of the *current* connection ("json" until
        #: a hello says otherwise; re-negotiated on every reconnect).
        self.wire_codec = "json"
        self.client_id = client_id or f"netbus-{uuid.uuid4().hex[:8]}"
        self.role = role
        self._connect_timeout = connect_timeout
        self._request_timeout = request_timeout
        # Connect + send serialization. Reentrant: _roundtrip's send-failure
        # path calls _drop_connection while already holding the lock (the
        # reader thread calls it bare) — with a plain Lock that self-
        # deadlocks the client whenever a send fails synchronously, e.g.
        # on a socket that died between requests (net.client.*.pre_send).
        self._io_lock = threading.RLock()
        self._sock: Optional[socket.socket] = None
        self._pending: Dict[int, _Reply] = {}
        self._pending_lock = threading.Lock()
        self._req_ids = itertools.count(1)
        # Batch-token source: random prefix per *instance* + counter. Unique
        # across client incarnations sharing a client_id (a restarted
        # component must never collide with its predecessor's tokens in the
        # server's dedupe LRU), without a urandom syscall per append.
        self._batch_prefix = uuid.uuid4().hex[:12]
        self._batch_ids = itertools.count(1)
        #: push-fed local view: monotonic within a server epoch, re-seeded
        #: on epoch change. Guarded by _push_cond.
        self._push_cond = threading.Condition()
        self._known_tail = 0
        self._trim_base = 0
        self.server_epoch: Optional[str] = None
        self._closed = False
        self.n_requests = 0      # round-trips issued (bench accounting)
        self.n_reconnects = 0    # successful re-handshakes after the first
        #: per-instance RNG for decorrelated retry jitter (never seeded:
        #: the whole point is that a fleet of clients desynchronizes)
        self._jitter = random.Random()
        #: force a tail refresh after this many seconds of waiting with no
        #: push progress — self-healing against a lost append notification
        #: (one dropped push would otherwise park a waiter forever). High
        #: by default so an idle client stays at zero request cost.
        self.stale_refresh_s = 30.0
        with self._io_lock:
            self._connect_locked(time.monotonic() + connect_timeout)

    def _next_backoff(self, prev: float, cap: float = 0.5,
                      base: float = 0.02) -> float:
        """Decorrelated jitter (AWS-style): ``uniform(base, prev * 3)``
        capped. Plain doubling from a constant base marches every client of
        a restarted server through identical sleep ladders — a lockstep
        reconnect storm; sampling the whole interval spreads them out."""
        return min(cap, self._jitter.uniform(base, max(base, prev * 3)))

    # -- connection management ----------------------------------------------
    def _connect_locked(self, deadline: float) -> socket.socket:
        """(io_lock held) Dial + hello + subscribe, retrying with backoff
        until ``deadline``. Starts the reader thread on success."""
        backoff = 0.02
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0 or self._closed:
                raise ConnectionError(
                    f"cannot reach bus server at {self._addr[0]}:"
                    f"{self._addr[1]}")
            try:
                sock = socket.create_connection(
                    self._addr, timeout=min(2.0, remaining))
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                hello: Dict[str, Any] = {
                    "op": "hello", "proto": PROTO_VERSION,
                    "client_id": self.client_id,
                    "role": self.role, "subscribe": True}
                if self._offer_binary:
                    hello["codecs"] = ["binary"]
                send_frame(sock, hello)
                resp = recv_frame(sock)
            except (OSError, ConnectionError, ValueError):
                time.sleep(min(backoff, max(0.0, deadline - time.monotonic())))
                backoff = self._next_backoff(backoff)
                continue
            if not resp.get("ok"):
                sock.close()
                raise ConnectionError(
                    f"bus server rejected hello: {resp.get('error')} "
                    f"{resp.get('message', '')}")
            sock.settimeout(None)
            # Codec negotiation result is per-connection: an older server
            # (or LOGACT_CODEC=json on either side) simply never confirms.
            self.wire_codec = ("binary" if self._offer_binary
                               and resp.get("codec") == "binary" else "json")
            epoch = resp["epoch"]
            with self._push_cond:
                if self.server_epoch is not None and epoch != self.server_epoch:
                    # Epoch-fenced reconnect: a different server incarnation
                    # may front a different log state (e.g. restored from an
                    # older durable store) — local caches are not trustworthy.
                    self._known_tail = int(resp["tail"])
                    self._trim_base = int(resp["trim_base"])
                else:
                    self._known_tail = max(self._known_tail, int(resp["tail"]))
                    self._trim_base = max(self._trim_base,
                                          int(resp["trim_base"]))
                if self.server_epoch is not None:
                    self.n_reconnects += 1
                self.server_epoch = epoch
                self._push_cond.notify_all()
            self._sock = sock
            threading.Thread(target=self._reader_loop, args=(sock,),
                             daemon=True,
                             name=f"netbus-reader-{self.client_id}").start()
            return sock

    def _drop_connection(self, sock: socket.socket) -> None:
        with self._io_lock:
            if self._sock is sock:
                self._sock = None
        try:
            sock.close()
        except OSError:  # pragma: no cover - already closed
            pass
        # Wake wait()ers so they notice the dead connection and trigger a
        # reconnect instead of sleeping through appends they can't see.
        with self._push_cond:
            self._push_cond.notify_all()

    def _reader_loop(self, sock: socket.socket) -> None:
        exc: Exception = ConnectionError("bus connection lost")
        try:
            while True:
                frame, blob = recv_any(sock)
                event = frame.get("event")
                if event == "append":
                    with self._push_cond:
                        t = int(frame["tail"])
                        if t > self._known_tail:
                            self._known_tail = t
                            self._push_cond.notify_all()
                elif event is not None:
                    continue  # unknown push: forward-compatible, ignore
                else:
                    with self._pending_lock:
                        reply = self._pending.pop(frame.get("id"), None)
                    if reply is not None:
                        reply.frame = frame
                        reply.blob = blob
                        reply.event.set()
        except (OSError, ConnectionError, ValueError) as e:
            exc = ConnectionError(f"bus connection lost: {e}")
        self._drop_connection(sock)
        with self._pending_lock:
            stale = [r for r in self._pending.values() if r.sock is sock]
            for r in stale:
                for rid in [k for k, v in self._pending.items() if v is r]:
                    self._pending.pop(rid, None)
        for r in stale:
            r.error = exc
            r.event.set()

    # -- request plumbing ---------------------------------------------------
    def _request(self, op: str, params: Dict[str, Any],
                 timeout: Optional[float] = None) -> Dict[str, Any]:
        """One logical request: retries transport errors with backoff until
        the request timeout. Safe for appends too — the batch token makes
        them idempotent on the server."""
        return self._request_full(op, params, timeout)[0]

    def _request_full(
            self, op: str, params: Dict[str, Any],
            timeout: Optional[float] = None,
            payloads: Optional[Sequence[Payload]] = None,
    ) -> Tuple[Dict[str, Any], Optional[bytes]]:
        """Like ``_request`` but returns ``(frame, blob)`` — ``blob`` is the
        binary entry-frames half of a binary response (None on JSON). When
        ``payloads`` is given and the connection negotiated the binary
        codec, the request itself is sent as a binary message (the payload
        bodies travel as entry frames, not JSON); on a JSON connection they
        are folded into ``params`` in the legacy shape. The choice is made
        per attempt, against the codec of the connection actually used —
        a reconnect mid-retry may land on a differently-negotiated peer."""
        deadline = time.monotonic() + (timeout if timeout is not None
                                       else self._request_timeout)
        backoff = 0.02
        while True:
            if self._closed:
                raise ConnectionError("bus client closed")
            try:
                return self._roundtrip(op, params, deadline, payloads)
            except AclError:
                raise  # a PermissionError IS an OSError; don't retry it
            except (ConnectionError, OSError) as e:
                if time.monotonic() + backoff >= deadline:
                    raise ConnectionError(
                        f"bus request {op!r} failed: {e}") from e
                time.sleep(backoff)
                backoff = self._next_backoff(backoff)

    def _roundtrip(self, op: str, params: Dict[str, Any], deadline: float,
                   payloads: Optional[Sequence[Payload]] = None,
                   ) -> Tuple[Dict[str, Any], Optional[bytes]]:
        with self._io_lock:
            sock = self._sock
            if sock is None:
                sock = self._connect_locked(deadline)
            act = fault_point(f"net.client.{op}.pre_send")
            if act is not None:
                # connection reset before the request left the client: the
                # server never saw it, the retry is trivially safe
                try:
                    sock.close()
                except OSError:
                    pass
                raise ConnectionError(
                    f"injected reset before {op!r} send")
            rid = next(self._req_ids)
            reply = _Reply(sock)
            with self._pending_lock:
                self._pending[rid] = reply
            try:
                if payloads is not None and self.wire_codec == "binary":
                    send_binary_frame(
                        sock, {"id": rid, "op": op, **params},
                        entry_codec.encode_payloads(payloads))
                elif payloads is not None:
                    wire = [{"type": p.type.value, "body": p.body}
                            for p in payloads]
                    send_frame(sock, {"id": rid, "op": op,
                                      "payloads": wire, **params})
                else:
                    send_frame(sock, {"id": rid, "op": op, **params})
                self.n_requests += 1
            except OSError as e:
                with self._pending_lock:
                    self._pending.pop(rid, None)
                self._drop_connection(sock)
                raise ConnectionError(str(e)) from e
            act = fault_point(f"net.client.{op}.post_send")
            if act is not None:
                # connection reset after the request left: the server may
                # have processed it — only the batch token (append) or
                # idempotence (read/tail) makes the retry safe
                try:
                    sock.close()
                except OSError:
                    pass
        if not reply.event.wait(max(0.0, deadline - time.monotonic())):
            with self._pending_lock:
                self._pending.pop(rid, None)
            raise TimeoutError(f"bus request {op!r} timed out")
        if reply.error is not None:
            raise reply.error
        return self._check(reply.frame), reply.blob  # type: ignore[arg-type]

    @staticmethod
    def _check(frame: Dict[str, Any]) -> Dict[str, Any]:
        if frame.get("ok"):
            return frame
        err = frame.get("error")
        if err == "trimmed":
            raise TrimmedError(int(frame["requested"]), int(frame["base"]))
        if err == "acl":
            raise AclError(frame.get("message", "denied by bus server"))
        raise RuntimeError(f"bus server error {err!r}: "
                           f"{frame.get('message', '')}")

    # -- AgentBus surface ---------------------------------------------------
    def append_many(self, payloads: Sequence[Payload]) -> List[int]:
        """Batched append over one round-trip. The ``batch`` token makes a
        retried request idempotent: the server replays the recorded
        positions instead of appending twice."""
        if not payloads:
            return []
        fault_point("net.client.crash.pre_append")  # whole-process death
        batch = f"{self._batch_prefix}-{next(self._batch_ids)}"
        frame, _ = self._request_full("append", {"batch": batch},
                                      payloads=payloads)
        positions = [int(p) for p in frame["positions"]]
        with self._push_cond:  # read-your-writes for the local tail view
            if positions[-1] + 1 > self._known_tail:
                self._known_tail = positions[-1] + 1
                self._push_cond.notify_all()
        return positions

    def read(self, start: int, end: Optional[int] = None,
             types: TypeFilter = None) -> List[Entry]:
        """Range read; ``types`` is pushed down to the server (and from
        there into the backing backend's native filter)."""
        params: Dict[str, Any] = {"start": int(start)}
        if end is not None:
            params["end"] = int(end)
        if types is not None:
            params["types"] = sorted(PayloadType.parse(t).value
                                     for t in types)
        frame, blob = self._request_full("read", params)
        if blob is not None:  # binary response: lazy entries over the blob
            return entry_codec.decode_entries(blob)
        return [Entry.from_dict(d) for d in frame["entries"]]

    def tail(self, refresh: bool = False) -> int:
        """Position one past the last entry, from the push-fed local view
        (never ahead of the server; lags by at most one push propagation).
        ``refresh=True`` forces a round-trip — needed only when something
        appends to the backing store *around* the server (out-of-band)."""
        if refresh:
            frame = self._request("tail", {})
            with self._push_cond:
                t = int(frame["tail"])
                if t > self._known_tail:
                    self._known_tail = t
                    self._push_cond.notify_all()
        with self._push_cond:
            return self._known_tail

    def trim_base(self) -> int:
        """First readable position (one RPC; the server's base can be
        advanced by any client's trim at any time)."""
        frame = self._request("trim_base", {})
        with self._push_cond:
            self._trim_base = int(frame["base"])
            return self._trim_base

    def trim(self, min_position: int) -> int:
        frame = self._request("trim", {"min_position": int(min_position)})
        with self._push_cond:
            self._trim_base = int(frame["base"])
            return self._trim_base

    def compact(self) -> int:
        return int(self._request("compact", {})["compacted"])

    def fork(self, at_position: int,
             path: Optional[str] = None) -> AgentBus:
        """Forward a ``fork`` op to the bus server: the server forks its
        backing log on its own storage (clamping/``TrimmedError`` semantics
        are the backend's) and replies with the child's backend + path,
        which is opened directly — the child is an ordinary local bus, so
        what-if replay against it generates zero traffic on the parent's
        server. ``path`` names the child's server-side storage (the server
        and client share a filesystem in the deployments this targets —
        same-host process isolation); omitted, the server derives a
        sibling path next to its backing store."""
        params: Dict[str, Any] = {"at": int(at_position)}
        if path is not None:
            params["path"] = path
        frame = self._request("fork", params)
        from .bus import make_bus  # local import: same idiom as make_bus's
        return make_bus(str(frame["backend"]), str(frame["path"]))

    def _wait_for_append(self, known_tail: int,
                         timeout: Optional[float]) -> bool:
        """Block on the push-fed tail view (no polling, no request traffic
        while the log is idle). If the connection died, periodically force
        a reconnect via ``tail(refresh=True)`` so appends made while we
        were disconnected are never slept through. A *live* connection that
        has made no progress for ``stale_refresh_s`` also forces one
        refresh: a single dropped append-notify push (lossy network, server
        under pressure) must degrade to one late poll, not a permanently
        parked waiter."""
        deadline = None if timeout is None else time.monotonic() + timeout
        stalled = 0.0
        while True:
            with self._push_cond:
                if self._known_tail > known_tail:
                    return True
                dead = self._sock is None
            if dead and not self._closed:
                try:
                    self.tail(refresh=True)  # reconnect + reseed the view
                except (ConnectionError, TimeoutError):
                    pass
                with self._push_cond:
                    if self._known_tail > known_tail:
                        return True
            elif stalled >= self.stale_refresh_s and not self._closed:
                stalled = 0.0
                try:
                    self.tail(refresh=True)  # lost-push self-heal
                except (ConnectionError, TimeoutError):
                    pass
                with self._push_cond:
                    if self._known_tail > known_tail:
                        return True
            remaining = (None if deadline is None
                         else deadline - time.monotonic())
            if remaining is not None and remaining <= 0:
                with self._push_cond:  # final recheck (same as _backoff_wait)
                    return self._known_tail > known_tail
            # Bounded slices so a connection death mid-wait is noticed.
            chunk = 0.5 if remaining is None else min(0.5, remaining)
            t0 = time.monotonic()
            with self._push_cond:
                self._push_cond.wait_for(
                    lambda: self._known_tail > known_tail, chunk)
            stalled += time.monotonic() - t0

    def server_wait(self, known_tail: int, timeout: float) -> bool:
        """The wire protocol's blocking ``wait`` op (server-side condition
        wait). ``NetBus.wait`` itself uses push events instead — this
        exists for thin clients without a notification reader, and to keep
        the op exercised/conformant."""
        frame = self._request("wait", {"known_tail": int(known_tail),
                                       "timeout": float(timeout)},
                              timeout=timeout + self._request_timeout)
        with self._push_cond:
            t = int(frame["tail"])
            if t > self._known_tail:
                self._known_tail = t
                self._push_cond.notify_all()
        return bool(frame["advanced"])

    def close(self) -> None:
        """Close the connection; in-flight requests fail with
        ``ConnectionError``. Idempotent."""
        self._closed = True
        with self._io_lock:
            sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:  # pragma: no cover
                pass
        with self._push_cond:
            self._push_cond.notify_all()
