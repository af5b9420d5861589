"""The port's network shared log against the reference's, on the CPU.

``repro_torch/core/netbus.py`` is the reference's file byte for byte, and
``repro_torch/launch/bus_server.py`` the reference's with ``repro.`` read
as ``repro_torch.`` (``test_torch_core_copies.py``). Here each scenario
runs once per package through ``tests/_torch_core_parity.py``: a
``NetBus`` of the package against the package's in-process ``BusServer``
on port 0 (one scenario restarts its server on its own port), under
``_clock``'s counters, which the server's threads also read through the
backing bus. The port's record must equal the reference's.

* The conformance contract on ``net`` (``tests/test_bus.py:386-398``,
  ``:402-477``, ``:706-762``): ``test_torch_bus.py``'s scenarios through
  its ``_bus_at``, whose ``net`` log is a ``NetBus`` to a server over a
  ``SqliteBus``; a scenario that reopens a log opens a second client of
  the same server.
* The in-process scenarios of ``tests/test_netbus.py:33-263``.
* Across packages: a port ``NetBus`` against a reference ``BusServer``,
  and the other way round, must give the same-package record.
* The eight in-process network fault points
  (``src/repro/core/faults.py:191-229``), each under the package's own
  ``faults.injected``: positions, what is read back, the reconnect counts,
  every batch on the log once.
* The governed serving agent on ``net`` against the JAX side, through
  ``test_torch_bus._serve``.
* Broken controls: a port server with its append dedupe disabled, and a
  port ``NetBus`` whose ``read`` drops the last entry.

Every client, server and backing bus is closed in a ``finally``, every
thread a scenario starts is joined on a deadline, and after each test no
thread it started may be alive and no socket it opened may be listening.

No hypothesis: every input is fixed.
"""
import contextlib
import os
import socket
import threading
import time
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import test_torch_bus as tb  # noqa: E402
from _torch_core_parity import PORT, REF, _both, _run  # noqa: E402
from test_torch_bus import serving  # noqa: E402,F401

DEADLINE_S = 10.0


def _listening():
    """The inodes of the listening TCP sockets that this process holds."""
    mine = set()
    for fd in os.listdir("/proc/self/fd"):
        with contextlib.suppress(OSError):
            link = os.readlink(f"/proc/self/fd/{fd}")
            if link.startswith("socket:["):
                mine.add(link[8:-1])
    listening = set()
    for table in ("/proc/self/net/tcp", "/proc/self/net/tcp6"):
        with contextlib.suppress(OSError), open(table) as f:
            for line in f.read().splitlines()[1:]:
                cols = line.split()
                if cols[3] == "0A":  # TCP_LISTEN
                    listening.add(cols[9])
    return mine & listening


@pytest.fixture(autouse=True)
def _nothing_left_behind():
    before, listening = set(threading.enumerate()), _listening()
    yield

    def started():
        return [t.name for t in threading.enumerate()
                if t not in before and t.is_alive()]

    deadline = time.monotonic() + DEADLINE_S
    while started() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not started()
    assert _listening() <= listening


def _addr(srv):
    host, port = srv.address
    return f"{host}:{port}"


def _close(*closeables):
    for c in closeables:
        if c is not None:
            c.close()


@contextlib.contextmanager
def _server(pkg, backing=None):
    """``pkg``'s ``BusServer`` on port 0 over ``backing`` (a fresh
    ``MemoryBus`` by default); the server and then the bus are closed on
    the way out."""
    backing = backing if backing is not None else pkg.bus.MemoryBus()
    srv = None
    try:
        srv = pkg.bus_server.BusServer(backing).start()
        yield srv
    finally:
        _close(srv, backing)


def _join(rec, label, thread):
    thread.join(timeout=DEADLINE_S)
    rec.see(f"{label} joined", not thread.is_alive())


# ---------------------------------------------------------------------------
# the conformance contract on net
# ---------------------------------------------------------------------------

NET_CONTRACTS = [tb.sc_append, tb.sc_read, tb.sc_poll_wait,
                 tb.sc_lazy_eager, tb.sc_trim, tb.sc_fork,
                 tb.sc_fork_trimmed, tb.sc_durable, tb.sc_trim_durable,
                 tb.sc_concurrent]


def _on_net(scenario):
    """``scenario`` on the net backend; its servers and their buses are
    closed when it ends."""
    def run(pkg, rec, root):
        try:
            scenario(pkg, rec, root, "net")
        finally:
            tb._close_servers()
    return run


@pytest.mark.parametrize("scenario", NET_CONTRACTS,
                         ids=[sc.__name__[3:] for sc in NET_CONTRACTS])
def test_net_contract_records_are_equal(tmp_path, scenario):
    want, got = _both(_on_net(scenario), tmp_path)
    assert got == want


# ---------------------------------------------------------------------------
# the in-process scenarios of tests/test_netbus.py
# ---------------------------------------------------------------------------

def sc_roundtrip(pkg, rec, root):
    """tests/test_netbus.py:33: positions, read-your-writes, another
    client's view, the pushed-down type filter."""
    E, T = pkg.entries, pkg.entries.PayloadType
    with _server(pkg) as srv:
        a = b = None
        try:
            a = pkg.netbus.NetBus(_addr(srv), client_id="a")
            b = pkg.netbus.NetBus(_addr(srv), client_id="b")
            rec.see("append", a.append_many([E.mail("m0"), E.mail("m1")]))
            rec.see("a tail", a.tail())
            rec.do("b reads", b.read, 0)
            rec.see("b votes", b.append(E.vote("i1", "rule", "v", True)))
            rec.do("a reads votes", a.read, 0, types=[T.VOTE])
            rec.do("a reads commits", a.read, 0, types=[T.COMMIT])
            rec.see("b tail refreshed", b.tail(refresh=True))
        finally:
            _close(a, b)


def sc_mixed_codec(pkg, rec, root):
    """tests/test_netbus.py:52: a JSON client and a binary client on one
    server, and a binary batch retried under one token."""
    E, T = pkg.entries, pkg.entries.PayloadType
    with _server(pkg) as srv:
        jc = bc = None
        try:
            jc = pkg.netbus.NetBus(_addr(srv), client_id="legacy-json",
                                   codec="json")
            bc = pkg.netbus.NetBus(_addr(srv), client_id="binary")
            rec.see("codecs", (jc.wire_codec, bc.wire_codec))
            rec.see("json appends", jc.append_many([E.mail("from-json",
                                                           tag="ü")]))
            rec.see("binary appends", bc.append_many(
                [E.mail("from-binary", nested={"k": [1, 2]}),
                 E.vote("i1", "rule", "v", True)]))
            via_json = rec.do("via json", jc.read, 0)
            via_bin = rec.do("via binary", bc.read, 0)
            rec.see("equal both ways", (via_json == via_bin,
                                        via_bin == via_json))
            rec.do("json votes", jc.read, 0, types=[T.VOTE])
            rec.do("binary votes", bc.read, 0, types=[T.VOTE])
            for n in (1, 2):
                frame, _ = bc._request_full("append", {"batch": "fixed"},
                                            payloads=[E.mail("once")])
                rec.see(f"token try {n}", (frame["positions"],
                                           frame.get("deduped")))
            rec.do("log", bc.read, 0)
        finally:
            _close(jc, bc)


def sc_lazy_wire(pkg, rec, root):
    """tests/test_netbus.py:88: a read over the binary wire from a
    SqliteBus decodes no body, in the client or the server, until one is
    touched."""
    E, codec = pkg.entries, pkg.codec
    with _server(pkg, pkg.bus.SqliteBus(os.path.join(root, "lazy.db"))) \
            as srv:
        nb = None
        try:
            nb = pkg.netbus.NetBus(_addr(srv), client_id="lazy")
            nb.append_many([E.mail(f"m{i}") for i in range(16)])
            codec.DECODES.reset()
            es = nb.read(0)
            rec.see("read", (len(es), codec.DECODES.bodies))
            rec.see("touched", (es[3].body["text"], codec.DECODES.bodies))
        finally:
            _close(nb)


def sc_push_wake(pkg, rec, root):
    """tests/test_netbus.py:112: another client's append wakes a waiter
    by a push, at no request of the waiter's."""
    E = pkg.entries
    with _server(pkg) as srv:
        waiter = appender = None
        try:
            waiter = pkg.netbus.NetBus(_addr(srv), client_id="waiter")
            appender = pkg.netbus.NetBus(_addr(srv), client_id="appender")
            out = {}
            known = waiter.tail()  # read before the append can land
            t = threading.Thread(target=lambda: out.setdefault(
                "woke", waiter.wait(known, timeout=DEADLINE_S)))
            t.start()
            time.sleep(0.1)
            before = waiter.n_requests
            appender.append(E.mail("wake up"))
            _join(rec, "waiter", t)
            rec.see("woke", out.get("woke"))
            rec.see("waiter tail", waiter.tail())
            rec.see("requests of the waiter's", waiter.n_requests - before)
        finally:
            _close(waiter, appender)


def sc_trimmed_wire(pkg, rec, root):
    """tests/test_netbus.py:137: a TrimmedError crosses the wire with its
    requested position and base."""
    E = pkg.entries
    with _server(pkg) as srv:
        c = None
        try:
            c = pkg.netbus.NetBus(_addr(srv), client_id="c")
            c.append_many([E.mail(f"m{i}") for i in range(4)])
            rec.see("trim", c.trim(2))
            rec.see("base", c.trim_base())
            rec.do("from 0", c.read, 0)
            rec.do("from 2", c.read, 2)
        finally:
            _close(c)


def sc_role_acl(pkg, rec, root):
    """tests/test_netbus.py:151: the server enforces a declared role, and
    refuses an unknown one at hello."""
    E = pkg.entries
    with _server(pkg) as srv:
        v = None
        try:
            v = pkg.netbus.NetBus(_addr(srv), client_id="v", role="voter")
            rec.do("voter mails", v.append, E.mail("voters cannot mail"))
            rec.do("voter votes", v.append, E.vote("i1", "rule", "v", True))
            rec.do("unknown role", pkg.netbus.NetBus, _addr(srv),
                   client_id="x", role="no-such-role", connect_timeout=2.0)
            rec.do("log", v.read, 0)
        finally:
            _close(v)


def sc_busclient(pkg, rec, root):
    """tests/test_netbus.py:164: the client-side ACL over a NetBus."""
    E = pkg.entries
    with _server(pkg) as srv:
        bus = None
        try:
            bus = pkg.netbus.NetBus(_addr(srv), client_id="layered")
            ex = pkg.acl.BusClient(bus, "executor-1", "executor")
            rec.do("executor votes", ex.append,
                   E.vote("i", "rule", "x", True))
            rec.do("executor results", ex.append,
                   E.result("i", True, {}, "executor-1"))
            rec.do("executor reads", ex.read, 0)
        finally:
            _close(bus)


def sc_dedupe(pkg, rec, root):
    """tests/test_netbus.py:177: a retried append under one batch token
    gives the recorded positions, not a second append."""
    with _server(pkg) as srv:
        c = None
        try:
            c = pkg.netbus.NetBus(_addr(srv), client_id="dup")
            wire = [{"type": "Mail", "body": {"text": "once",
                                              "sender": "u"}}]
            for n in (1, 2):
                r = c._request("append", {"payloads": wire,
                                          "batch": "tok-1"})
                rec.see(f"try {n}", (r["positions"], r.get("deduped")))
            rec.see("tail", c.tail(refresh=True))
            rec.do("log", c.read, 0)
        finally:
            _close(c)


def _rebind(pkg, backing, port):
    """A successor ``BusServer`` on ``port``, retrying the bind until the
    deadline (tests/test_netbus.py:208-214)."""
    deadline = time.monotonic() + DEADLINE_S
    while True:
        try:
            return pkg.bus_server.BusServer(backing, port=port).start()
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)


def sc_reconnect(pkg, rec, root):
    """tests/test_netbus.py:193: a client survives a server restart over
    a durable log: a new epoch, a reconnect, and a resubscribed push."""
    E = pkg.entries
    backing = pkg.bus.SqliteBus(os.path.join(root, "bus.db"))
    srv = c = w = None
    try:
        srv = pkg.bus_server.BusServer(backing).start()
        c = pkg.netbus.NetBus(_addr(srv), client_id="c")
        w = pkg.netbus.NetBus(_addr(srv), client_id="w")
        rec.see("before", c.append_many([E.mail("before-0"),
                                         E.mail("before-1")]))
        first_epoch = c.server_epoch
        srv.close()
        srv = _rebind(pkg, backing, srv.address[1])
        rec.see("after", c.append(E.mail("after-restart")))
        rec.see("new epoch", (c.server_epoch == srv.epoch,
                              c.server_epoch != first_epoch))
        rec.see("reconnected", c.n_reconnects >= 1)
        out = {}
        # the waiter's reconnect and tail read come before the append: read
        # in the thread, a slow reconnect could see the append's tail and
        # then wait for one past it
        known = w.tail(refresh=True)
        t = threading.Thread(target=lambda: out.setdefault(
            "woke", w.wait(known, timeout=DEADLINE_S)))
        t.start()
        time.sleep(0.1)
        c.append(E.mail("wake the resubscribed waiter"))
        _join(rec, "waiter", t)
        rec.see("woke", out.get("woke"))
        rec.see("waiter reconnected", w.n_reconnects >= 1)
        rec.do("log", c.read, 0)
    finally:
        _close(c, w, srv, backing)


def sc_proto_mismatch(pkg, rec, root):
    """tests/test_netbus.py:230: a hello of another protocol version is
    refused, on a raw socket with the package's own framing."""
    with _server(pkg) as srv:
        s = socket.create_connection(srv.address, timeout=DEADLINE_S)
        try:
            pkg.netbus.send_frame(s, {"op": "hello",
                                      "proto": pkg.netbus.PROTO_VERSION + 1,
                                      "client_id": "relic"})
            resp = pkg.netbus.recv_frame(s)
            rec.see("reply", (resp["ok"], resp["error"], resp["message"]))
        finally:
            s.close()


def sc_server_wait(pkg, rec, root):
    """tests/test_netbus.py:245: the protocol's blocking wait op."""
    E = pkg.entries
    with _server(pkg) as srv:
        a = b = None
        try:
            a = pkg.netbus.NetBus(_addr(srv), client_id="a")
            b = pkg.netbus.NetBus(_addr(srv), client_id="b")
            rec.see("quiet", a.server_wait(a.tail(), timeout=0.1))
            out = {}
            t = threading.Thread(target=lambda: out.setdefault(
                "advanced", a.server_wait(0, timeout=DEADLINE_S)))
            t.start()
            time.sleep(0.05)
            b.append(E.mail("x"))
            _join(rec, "waiter", t)
            rec.see("advanced", out.get("advanced"))
        finally:
            _close(a, b)


IN_PROCESS = [sc_roundtrip, sc_mixed_codec, sc_lazy_wire, sc_push_wake,
              sc_trimmed_wire, sc_role_acl, sc_busclient, sc_dedupe,
              sc_reconnect, sc_proto_mismatch, sc_server_wait]


@pytest.mark.parametrize("scenario", IN_PROCESS,
                         ids=[sc.__name__[3:] for sc in IN_PROCESS])
def test_in_process_records_are_equal(tmp_path, scenario):
    want, got = _both(scenario, tmp_path)
    assert got == want
    joined = [v for k, v in got if k.endswith(" joined")]
    assert all(joined)


def _push_wake_says(rec):
    assert rec.get("waiter joined") and rec.get("woke") is True
    assert rec.get("requests of the waiter's") == 0


def _dedupe_says(rec):
    assert rec.get("try 1") == [[0], None]
    assert rec.get("try 2") == [[0], True] and rec.get("tail") == 1


def _reconnect_says(rec):
    assert rec.get("new epoch") == [True, True]
    assert rec.get("reconnected")
    assert rec.get("waiter joined") and rec.get("woke") is True


def _role_acl_says(rec):
    assert rec.get("voter mails")[:2] == ("raised", "AclError")
    assert rec.get("unknown role")[:2] == ("raised", "ConnectionError")


def _lazy_wire_says(rec):
    assert rec.get("read") == [16, 0]


def _mixed_codec_says(rec):
    assert rec.get("codecs") == ["json", "binary"]


REFERENCE_SAYS = [(sc_push_wake, _push_wake_says),
                  (sc_dedupe, _dedupe_says),
                  (sc_reconnect, _reconnect_says),
                  (sc_role_acl, _role_acl_says),
                  (sc_lazy_wire, _lazy_wire_says),
                  (sc_mixed_codec, _mixed_codec_says)]


@pytest.mark.parametrize("scenario,says", REFERENCE_SAYS,
                         ids=[sc.__name__[3:] for sc, _ in REFERENCE_SAYS])
def test_in_process_records_say_what_the_reference_tests_assert(
        tmp_path, scenario, says):
    says(_run(scenario, PORT, tmp_path))


# ---------------------------------------------------------------------------
# across packages: the wire of docs/bus-protocol.md
# ---------------------------------------------------------------------------

def _over(client, server):
    """A namespace whose client side (``netbus``, and ``entries`` for the
    payloads) is ``client``'s and whose server side (``bus``,
    ``bus_server``) is ``server``'s."""
    return SimpleNamespace(
        name=f"{client.name} to {server.name}", netbus=client.netbus,
        entries=client.entries, bus=server.bus, bus_server=server.bus_server)


ACROSS = [sc_roundtrip, sc_dedupe, sc_mixed_codec]


@pytest.mark.parametrize("client,server", [(PORT, REF), (REF, PORT)],
                         ids=["port-client-ref-server",
                              "ref-client-port-server"])
@pytest.mark.parametrize("scenario", ACROSS,
                         ids=[sc.__name__[3:] for sc in ACROSS])
def test_a_client_of_one_package_talks_to_a_server_of_the_other(
        tmp_path, scenario, client, server):
    want = _run(scenario, REF, tmp_path / "ref")
    assert _run(scenario, _over(client, server), tmp_path / "over") == want


# ---------------------------------------------------------------------------
# the eight in-process network fault points
# ---------------------------------------------------------------------------

NET_POINTS = [(point, op) for point, spec in
              sorted(REF.faults.INJECTION_POINTS.items())
              if point.startswith("net.") and "crash" not in point
              for op in spec.ops]


def sc_fault(pkg, rec, root, point, op):
    """Two clients of a server over a SqliteBus, under a plan that fires
    ``point`` at its second traversal: client a appends four batches of
    two, client b reads the log after each and waits for the last push;
    then b's connection is cut and b reads once more (the next hello fences
    an epoch flap). Then a fresh SqliteBus reads the file."""
    E, faults = pkg.entries, pkg.faults
    path = os.path.join(root, "fault.db")
    plan = faults.FaultPlan.single(point, op, at_hit=2,
                                   arg=0.05 if op == "delay" else 0.0)
    with _server(pkg, pkg.bus.SqliteBus(path)) as srv:
        a = b = None
        try:
            with faults.injected(plan) as inj:
                a = pkg.netbus.NetBus(_addr(srv), client_id="a",
                                      request_timeout=DEADLINE_S)
                b = pkg.netbus.NetBus(_addr(srv), client_id="b",
                                      request_timeout=DEADLINE_S)
                a.stale_refresh_s = b.stale_refresh_s = 0.2
                for i in range(4):
                    rec.see(f"append {i}", a.append_many(
                        [E.mail(f"m{i}"), E.mail(f"n{i}")]))
                    rec.do(f"b reads {i}", b.read, 0)
                rec.see("b woke", b.wait(7, timeout=DEADLINE_S))
                rec.see("b tail", b.tail())
            rec.see("fired", [(f.point, f.op) for f in inj.fired])
            rec.see("reconnects", (a.n_reconnects, b.n_reconnects))
            rec.see("b on the server's epoch", b.server_epoch == srv.epoch)
            b._sock.shutdown(socket.SHUT_RDWR)
            rec.do("b reads after a cut", b.read, 6)
            rec.see("b reconnects", b.n_reconnects)
            rec.see("b on the server's epoch again",
                    b.server_epoch == srv.epoch)
        finally:
            _close(a, b)
    fresh = pkg.bus.SqliteBus(path)
    try:
        rec.do("the log", fresh.read, 0)
    finally:
        fresh.close()


def test_the_net_points_are_the_same():
    mine = [(p, op) for p, spec in sorted(PORT.faults.INJECTION_POINTS.items())
            if p.startswith("net.") and "crash" not in p for op in spec.ops]
    assert mine == NET_POINTS and len(NET_POINTS) == 8


def _once_each(rec):
    texts = [body["text"] for _, _, body, _ in rec.get("the log")]
    return texts == [f"{c}{i}" for i in range(4) for c in "mn"]


@pytest.mark.parametrize("point,op", NET_POINTS,
                         ids=[p for p, _ in NET_POINTS])
def test_net_fault_point_leaves_the_same_log(tmp_path, point, op):
    want, got = _both(sc_fault, tmp_path, point, op)
    assert got == want
    assert got.get("fired") == [[point, op]]
    assert _once_each(got)
    assert got.get("b woke") is True and got.get("b tail") == 8
    assert got.get("b on the server's epoch again") is True
    if point.endswith(("pre_send", "post_send", "drop_append",
                       "reset_mid")):
        assert sum(got.get("reconnects")) == 1


# ---------------------------------------------------------------------------
# the governed serving agent on net, against the JAX side
# ---------------------------------------------------------------------------

def test_governed_serving_on_net_matches_jax(tmp_path, serving):  # noqa: F811
    try:
        want = tb._serve(serving, REF, "net", str(tmp_path / "j"))
        got = tb._serve(serving, PORT, "net", str(tmp_path / "t"))
    finally:
        tb._close_servers()
    assert set(got["outputs"]) == {"r0", "r2"} and got["rejected"] == ["r1"]
    assert ("Abort", None) in got["decisions"]
    assert got == want
    # a NetBus serves decoded copies: the agent's view holds no _sched flag
    assert got["flagged in memory"] == 0


# ---------------------------------------------------------------------------
# broken controls
# ---------------------------------------------------------------------------

def test_a_server_without_append_dedupe_fails_the_comparison(tmp_path,
                                                             monkeypatch):
    """A port server that forgets each append's batch token: the retry
    after ``net.client.append.post_send`` appends the batch again."""
    point = ("net.client.append.post_send", "disconnect")
    want = _run(sc_fault, REF, tmp_path / "ref", *point)
    assert _run(sc_fault, PORT, tmp_path / "port", *point) == want
    cls = PORT.bus_server.BusServer
    append = cls._op_append
    monkeypatch.setattr(cls, "_op_append", lambda self, conn, frame,
                        blob=None: append(self, conn, {
                            k: v for k, v in frame.items() if k != "batch"},
                            blob))
    got = _run(sc_fault, PORT, tmp_path / "broken", *point)
    assert got != want
    assert _once_each(want) and not _once_each(got)
    assert len(got.get("the log")) == 10


def test_a_netbus_that_drops_an_entry_fails_the_comparison(tmp_path,
                                                           monkeypatch):
    scenario = _on_net(tb.sc_read)
    want = _run(scenario, REF, tmp_path / "ref")
    assert _run(scenario, PORT, tmp_path / "port") == want
    cls = PORT.netbus.NetBus
    read = cls.read
    monkeypatch.setattr(cls, "read",
                        lambda self, *a, **kw: read(self, *a, **kw)[:-1])
    assert _run(scenario, PORT, tmp_path / "broken") != want
    assert _run(sc_roundtrip, PORT, tmp_path / "rt") != _run(
        sc_roundtrip, REF, tmp_path / "rt-ref")
