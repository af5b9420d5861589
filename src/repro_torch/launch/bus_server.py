"""The bus server: exposes any local bus backend to NetBus clients.

``BusServer`` fronts an ``AgentBus`` (``SqliteBus``/``KvBus`` for
durability, ``MemoryBus`` for tests) with the length-prefixed wire
protocol of ``repro_torch.core.netbus`` (frozen in ``docs/bus-protocol.md``):
JSON frames for control, and — per connection, if the client offers
``codecs: ["binary"]`` at hello and the server accepts — binary entry
frames (``repro_torch.core.codec``) for the bulk data of ``append``/``read``.
JSON-only clients coexist with binary ones on the same server; the codec
is negotiated per connection and the backend stores one canonical form.
This is the piece that makes the log the *externally reachable* source of
truth: Driver/Voter/Executor processes on any machine converge on one
server, and the server's single view of the tail gives networked clients
MemoryBus-grade wake semantics:

* every append (from any client) advances the server's tail under a
  condition variable, and
* an ``{"event": "append", "tail": t}`` frame is **pushed** to every
  subscribed connection — no client ever polls the backing store to learn
  the log moved.

Threading model: one accept loop; per connection, one *reader* thread
(parses requests, executes ops against the bus, sends the reply). All
sends on a connection are synchronous under a per-connection lock, so
pushes never interleave mid-frame with a reply and the append→wake path
has no intermediate thread hop. The appender's own connection is excluded
from the push fan-out (its reply already carries the new tail); a wedged
subscriber can stall an appender's reader for at most the socket send
timeout, after which the subscriber's connection is killed. Backends are
thread-safe, so op execution needs no global lock; only append-dedupe
bookkeeping is serialized.

Append idempotency: each ``append`` request carries a client-generated
``batch`` token. The server remembers ``(client_id, batch) -> positions``
in a bounded LRU and replays the recorded positions when a client retries
after a lost connection — exactly-once append semantics within one server
incarnation (the ``epoch`` returned at hello; clients fence on it).

Server-side ACL (defense in depth): a client that declares a ``role`` at
hello gets the corresponding ``repro_torch.core.acl.ROLES`` permission set
enforced server-side — appends outside the role's type set are rejected
with ``error="acl"``, and reads are intersected with the role's readable
types before the push-down filter reaches the backend. Clients without a
role are unrestricted (the client-side ``BusClient`` remains the primary
ACL layer, as with local backends).

CLI (used by the process harness and tests)::

    python -m repro_torch.launch.bus_server --backend sqlite --path bus.db \
        --host 127.0.0.1 --port 0 --port-file /tmp/bus.port

``--port 0`` binds an ephemeral port; ``--port-file`` publishes the bound
port for children that need to find the server.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import struct
import threading
import uuid
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Set, Tuple

from repro_torch.core import codec as entry_codec
from repro_torch.core.acl import AclError, ROLES
from repro_torch.core.bus import AgentBus, TrimmedError, make_bus
from repro_torch.core.entries import Payload, PayloadType
from repro_torch.core.faults import fault_point
from repro_torch.core.netbus import (MAX_FRAME_BYTES, PROTO_VERSION, recv_any,
                               recv_frame, send_binary_frame, send_frame)

#: Retained (client_id, batch) -> positions records for append dedupe.
_DEDUPE_MAX = 4096


class _Conn:
    """One client connection: socket + synchronous sender.

    All frames (replies and push events) are sent synchronously from the
    calling thread under one lock, so frames never interleave and there is
    no writer-thread wakeup on the append→wake path. Replies block only
    the connection's own reader (ops on one connection are sequential
    anyway); push events are sent from the *appender's* reader thread into
    other connections' sockets, so a wedged subscriber could stall it —
    bounded by the socket send timeout, after which the subscriber's
    connection is killed (the client reconnects and re-seeds its view).
    """

    SEND_TIMEOUT_S = 10.0

    def __init__(self, sock: socket.socket, addr: Tuple[str, int]) -> None:
        self.sock = sock
        self.addr = addr
        self.client_id: str = f"anon-{addr[0]}:{addr[1]}"
        self.role: Optional[str] = None
        self.subscribed = False
        self.codec = "json"  # per-connection; negotiated at hello
        self.alive = True
        # SO_SNDTIMEO bounds blocking sends without touching recv behavior.
        self.sock.setsockopt(
            socket.SOL_SOCKET, socket.SO_SNDTIMEO,
            struct.pack("ll", int(self.SEND_TIMEOUT_S), 0))
        self._send_lock = threading.Lock()

    def send(self, obj: Dict[str, Any]) -> None:
        if not self.alive:
            return
        try:
            with self._send_lock:
                send_frame(self.sock, obj)
        except (OSError, ValueError):
            self.close()

    def send_binary(self, meta: Dict[str, Any], blob: bytes) -> None:
        if not self.alive:
            return
        try:
            with self._send_lock:
                send_binary_frame(self.sock, meta, blob)
        except (OSError, ValueError):
            self.close()

    def close(self) -> None:
        self.alive = False
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:  # pragma: no cover
            pass


class BusServer:
    """Socket front-end for an ``AgentBus``; see module docstring."""

    def __init__(self, bus: AgentBus, host: str = "127.0.0.1",
                 port: int = 0) -> None:
        self.bus = bus
        #: unique per server incarnation; clients fence reconnects on it.
        self.epoch = uuid.uuid4().hex
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(64)
        self.address: Tuple[str, int] = self._listener.getsockname()[:2]
        self._tail_cond = threading.Condition()
        self._tail = bus.tail()
        # Dedupe bookkeeping lock only — the appends themselves run
        # CONCURRENTLY (the backend is thread-safe and SqliteBus
        # group-commits overlapping batches into one transaction). A
        # retried batch that is still in flight parks on its _inflight
        # event instead of re-appending.
        self._dedupe_lock = threading.Lock()
        self._inflight: Dict[Tuple[str, str], threading.Event] = {}
        self._dedupe: "OrderedDict[Tuple[str, str], List[int]]" = OrderedDict()
        self._conns: Set[_Conn] = set()
        self._conns_lock = threading.Lock()
        self._closed = False
        self._accept_thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "BusServer":
        """Serve in a background thread (in-process use: tests, benches)."""
        self._accept_thread = threading.Thread(
            target=self.serve_forever, daemon=True, name="bus-accept")
        self._accept_thread.start()
        return self

    def serve_forever(self) -> None:
        while not self._closed:
            try:
                sock, addr = self._listener.accept()
            except OSError:
                return  # listener closed
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = _Conn(sock, addr)
            with self._conns_lock:
                self._conns.add(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True, name=f"bus-r-{addr[1]}").start()

    def close(self) -> None:
        """Stop accepting, drop every connection. Does NOT close the bus
        (the owner may keep using it, e.g. to inspect state in tests)."""
        self._closed = True
        try:
            # shutdown() first: close() alone does not wake a thread blocked
            # in accept() (the kernel socket survives until the syscall
            # returns), which would leave the port in LISTEN forever.
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:  # pragma: no cover
            pass
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            c.close()

    # -- per-connection reader ----------------------------------------------
    def _serve_conn(self, conn: _Conn) -> None:
        try:
            while not self._closed:
                frame, blob = recv_any(conn.sock)
                rid = frame.get("id")
                op = frame.get("op")
                if op == "hello":
                    conn.send(self._hello(conn, frame))
                    continue
                out_blob: Optional[bytes] = None
                try:
                    resp = self._dispatch(conn, op, frame, blob)
                    if isinstance(resp, tuple):  # binary response
                        resp, out_blob = resp
                except TrimmedError as e:
                    resp = {"ok": False, "error": "trimmed",
                            "requested": e.requested, "base": e.base}
                except AclError as e:
                    resp = {"ok": False, "error": "acl", "message": str(e)}
                except Exception as e:  # defensive: never kill the conn
                    resp = {"ok": False, "error": "internal",
                            "message": f"{type(e).__name__}: {e}"}
                if rid is not None:
                    act = fault_point("net.server.frame.reset_mid")
                    if act is not None:
                        # connection reset mid-frame: a length prefix and a
                        # few bytes of JSON escape, then the peer vanishes —
                        # the client must treat the stream as dead, never
                        # parse the fragment
                        try:
                            with conn._send_lock:
                                conn.sock.sendall(
                                    struct.pack(">I", 1 << 20) + b'{"part')
                        except OSError:
                            pass
                        conn.close()
                        continue
                    resp["id"] = rid
                    if out_blob is not None:
                        conn.send_binary(resp, out_blob)
                    else:
                        conn.send(resp)
        except (OSError, ConnectionError, ValueError, json.JSONDecodeError):
            pass
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            conn.close()

    def _hello(self, conn: _Conn, frame: Dict[str, Any]) -> Dict[str, Any]:
        if frame.get("proto") != PROTO_VERSION:
            return {"ok": False, "error": "proto",
                    "message": f"server speaks proto {PROTO_VERSION}, "
                               f"client sent {frame.get('proto')!r}"}
        role = frame.get("role")
        if role is not None and role not in ROLES:
            return {"ok": False, "error": "acl",
                    "message": f"unknown role {role!r}"}
        conn.client_id = str(frame.get("client_id") or conn.client_id)
        conn.role = role
        # Codec negotiation (additive): accept the binary entry codec only
        # if the client offered it AND this server isn't forced to the
        # legacy JSON wire. Unconfirmed = pure JSON, per connection.
        conn.codec = ("binary"
                      if "binary" in (frame.get("codecs") or [])
                      and entry_codec.HAVE_MSGPACK
                      and not entry_codec.legacy_json_mode() else "json")
        # Subscribe BEFORE reading the tail for the reply: an append landing
        # between the two is then pushed, so the client's view (seeded with
        # the reply tail, advanced by pushes) never has a notification gap.
        conn.subscribed = bool(frame.get("subscribe", True))
        tail = self.bus.tail()
        with self._tail_cond:
            if tail > self._tail:  # out-of-band appends to the backing store
                self._tail = tail
                self._tail_cond.notify_all()
            tail = self._tail
        resp = {"ok": True, "epoch": self.epoch, "tail": tail,
                "trim_base": self.bus.trim_base(),
                "max_frame": MAX_FRAME_BYTES}
        if conn.codec == "binary":
            resp["codec"] = "binary"
        act = fault_point("net.server.hello.flap")
        if act is not None:
            # epoch flap: one hello reports a bogus incarnation id, as if
            # the client raced a restart — it must fence (reseed its view)
            # and still converge once the next hello tells the truth
            resp["epoch"] = f"flap-{self.epoch[:8]}"
        return resp

    # -- op dispatch ---------------------------------------------------------
    def _dispatch(self, conn: _Conn, op: Optional[str],
                  frame: Dict[str, Any],
                  blob: Optional[bytes] = None):
        if op == "append":
            return self._op_append(conn, frame, blob)
        if op == "read":
            return self._op_read(conn, frame)
        if op == "tail":
            return {"ok": True, "tail": self._refresh_tail()}
        if op == "trim_base":
            return {"ok": True, "base": self.bus.trim_base()}
        if op == "trim":
            base = self.bus.trim(int(frame["min_position"]))
            return {"ok": True, "base": base}
        if op == "compact":
            return {"ok": True, "compacted": int(self.bus.compact())}
        if op == "fork":
            return self._op_fork(frame)
        if op == "wait":
            return self._op_wait(frame)
        if op == "ping":
            return {"ok": True, "epoch": self.epoch}
        return {"ok": False, "error": "bad_op",
                "message": f"unknown op {op!r}"}

    def _op_append(self, conn: _Conn, frame: Dict[str, Any],
                   blob: Optional[bytes] = None) -> Dict[str, Any]:
        if blob is not None:  # binary request: payloads as entry frames
            payloads = entry_codec.decode_payloads(blob)
        else:
            payloads = [Payload(PayloadType(p["type"]), p["body"])
                        for p in frame["payloads"]]
        if conn.role is not None:
            # On the binary path this touches only the frame headers —
            # denied bodies are never decoded.
            denied = {p.type for p in payloads} - ROLES[conn.role].append
            if denied:
                raise AclError(
                    f"{conn.client_id} (role={conn.role}) may not append "
                    f"{sorted(t.value for t in denied)}")
        batch = frame.get("batch")
        key = (conn.client_id, str(batch)) if batch else None
        # Dedupe without serializing the appends themselves: a fresh batch
        # registers an in-flight event and appends concurrently with other
        # clients (SqliteBus group-commits the overlap into one
        # transaction); a retry of a *completed* batch replays the recorded
        # positions; a retry of a batch still in flight parks on its event
        # and then replays — never a double append.
        if key is not None:
            while True:
                with self._dedupe_lock:
                    hit = self._dedupe.get(key)
                    if hit is not None:
                        self._dedupe.move_to_end(key)
                        return {"ok": True, "positions": hit,
                                "deduped": True}
                    ev = self._inflight.get(key)
                    if ev is None:
                        self._inflight[key] = threading.Event()
                        break
                ev.wait()  # first attempt still appending: await its result
        try:
            act = fault_point("net.server.append.crash_pre")
            if act is not None:
                # whole-server death before the backend saw the batch
                self.close()
                raise ConnectionError("injected server crash (pre-append)")
            positions = self.bus.append_many(payloads)
            act = fault_point("net.server.append.crash_post")
            if act is not None:
                # whole-server death after the append is durable but before
                # the dedupe record and the reply: the entries exist, the
                # client never learns — a successor incarnation serves them
                self.close()
                raise ConnectionError("injected server crash (post-append)")
            if key is not None:
                with self._dedupe_lock:
                    self._dedupe[key] = positions
                    while len(self._dedupe) > _DEDUPE_MAX:
                        self._dedupe.popitem(last=False)
        finally:
            if key is not None:
                with self._dedupe_lock:
                    ev = self._inflight.pop(key, None)
                if ev is not None:
                    ev.set()
        # The appender learns the new tail from this reply (its client folds
        # it into the local view), so its own connection is excluded from
        # the push fan-out — one less send and one less thread wakeup
        # contending with the waiters being woken.
        self._notify_append(positions[-1] + 1, exclude=conn)
        act = fault_point("net.server.reply.drop_append")
        if act is not None:
            # the append committed, dedupe recorded, pushes fanned out —
            # then the reply connection resets. The client's retry must be
            # answered from the dedupe table, not appended again.
            conn.close()
            raise ConnectionError("injected reset before append reply")
        return {"ok": True, "positions": positions}

    def _op_fork(self, frame: Dict[str, Any]) -> Dict[str, Any]:
        """Fork the backing log server-side and hand back (backend, path)
        so the client can open the child directly — the child is a plain
        local bus, deliberately outside this server's epoch/push machinery
        (what-if replay against it must not generate parent traffic).
        Only path-addressable backends are forkable over the wire: a
        MemoryBus-backed server has nowhere the client could reach."""
        child = self.bus.fork(int(frame["at"]), frame.get("path"))
        root = getattr(child, "_root", None)  # KvBus stores a directory
        if root is not None:
            backend, path = "kv", root
        else:
            path = getattr(child, "_path", None)  # SqliteBus stores a file
            backend = "sqlite"
        try:
            if path is None:
                return {"ok": False, "error": "unsupported",
                        "message": "backing bus has no forkable storage "
                                   "path (memory backend?)"}
            return {"ok": True, "backend": backend, "path": str(path)}
        finally:
            child.close()  # the client reopens it; keep no server handle

    def _op_read(self, conn: _Conn, frame: Dict[str, Any]):
        types = frame.get("types")
        fs = (None if types is None
              else [PayloadType(t) for t in types])
        if conn.role is not None:
            allowed = ROLES[conn.role].read
            fs = sorted(((set(fs) if fs is not None else set(PayloadType))
                         & allowed), key=lambda t: t.value)
        entries = self.bus.read(int(frame["start"]), frame.get("end"),
                                types=fs)
        if conn.codec == "binary":
            # Entries from a binary-codec backend are LazyEntry: encoding
            # reuses their raw body bytes — pass-through, no decode/re-encode.
            return {"ok": True}, entry_codec.encode_entries(entries)
        return {"ok": True, "entries": [e.to_dict() for e in entries]}

    def _op_wait(self, frame: Dict[str, Any]) -> Dict[str, Any]:
        """The protocol's blocking wait (for thin clients without a push
        reader). NB: ops on one connection are sequential, so this blocks
        that connection only; NetBus proper never calls it from its hot
        path."""
        known = int(frame["known_tail"])
        timeout = min(float(frame.get("timeout", 30.0)), 300.0)
        with self._tail_cond:
            advanced = self._tail_cond.wait_for(
                lambda: self._tail > known, timeout)
            return {"ok": True, "advanced": advanced, "tail": self._tail}

    # -- tail + push notifications ------------------------------------------
    def _refresh_tail(self) -> int:
        """Reconcile with the backing store (an out-of-band writer — e.g. a
        co-located process sharing the SQLite file — may have appended
        around the server) and notify if it moved."""
        t = self.bus.tail()
        self._notify_append(t)
        with self._tail_cond:
            return self._tail

    def _notify_append(self, tail: int,
                       exclude: Optional[_Conn] = None) -> None:
        with self._tail_cond:
            if tail <= self._tail:
                return
            self._tail = tail
            self._tail_cond.notify_all()
        if fault_point("net.server.push.drop") is not None:
            # the notification is lost in the network — server state already
            # advanced; subscribers must self-heal (stale refresh), not hang
            return
        fault_point("net.server.push.delay")  # "delay" op sleeps in fire()
        event = {"event": "append", "tail": tail}
        with self._conns_lock:
            subs = [c for c in self._conns
                    if c.subscribed and c.alive and c is not exclude]
        for c in subs:
            c.send(event)  # synchronous push from the appender's thread


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="LogAct bus server")
    ap.add_argument("--backend", default="sqlite",
                    choices=["memory", "sqlite", "kv"])
    ap.add_argument("--path", default=None,
                    help="backend storage path (sqlite file / kv root)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 = bind an ephemeral port")
    ap.add_argument("--port-file", default=None,
                    help="write the bound port here once listening")
    args = ap.parse_args(argv)
    bus = make_bus(args.backend, path=args.path)
    server = BusServer(bus, host=args.host, port=args.port)
    if args.port_file:
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(server.address[1]))
        os.replace(tmp, args.port_file)  # atomic: readers never see partial
    server.serve_forever()


if __name__ == "__main__":
    main()
