"""The port's durable shared log against the reference's, on the CPU.

``repro_torch/core/bus.py`` and ``core/codec.py`` are the reference's files
byte for byte (``test_torch_core_copies.py``); here the two packages' buses
and codecs run side by side. Each scenario is written once, as a function
of one package (its ``core`` modules, with payloads built by its own
``entries``), and fills a record of what a user of the log can observe:
positions and tails, ``(position, type, body, ts)`` of every entry read,
trim bases, counters, and the type of any error raised. The port's record
must equal the reference's. During a scenario the bus's entry timestamps
come from a counter (``_clock``), so that two runs of one scenario can be
equal; a scenario whose threads interleave differently from run to run
records its invariants (dense positions, contiguous batches, nothing lost)
and not the order.

Covered: the codec's bytes; each package reading the other's SQLite files
(group commit on and off, a fork) and KV directories (after a trim, a
compaction and a fork), and the legacy JSON rows and segments; the
conformance, fork, durability, KV segment, group-commit and lifecycle
scenarios on sqlite and kv; every SQLite and KV crash point; ``make_bus``
(``net`` against an in-process server); the governed serving agent and
the executor-crash drill on durable logs against the JAX side; and a
broken control (a port bus whose ``read`` drops the last entry) that the
comparison must catch.

The harness (``REF``/``PORT``, ``Record``, ``_clock``, ``_run``,
``_both``) is shared with ``test_torch_agent_kernel.py`` and lives in
``tests/_torch_core_parity.py``. ``_bus_at``'s ``net`` backend (a
``NetBus`` to a server over a ``SqliteBus``, ``_server_at``,
``_close_servers``) and ``_serve`` serve ``test_torch_netbus.py``.

No hypothesis: every input is fixed.
"""
import json
import os
import sqlite3
import threading
import time

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _torch_trainer_parity as parity  # noqa: E402
from _torch_core_parity import (PORT, REF, Record, _both,  # noqa: E402
                                _clock, _obs, _run)
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.base import smoke as jax_smoke  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.models.params import split_params  # noqa: E402
from repro.serving import server as jax_server  # noqa: E402
from repro.serving.engine import PagedEngine as JaxEngine  # noqa: E402
from repro_torch.configs.base import get_config, smoke  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402
from repro_torch.serving import server  # noqa: E402
from repro_torch.serving.engine import PagedEngine  # noqa: E402

torch.set_num_threads(1)


def _path(root, backend, name="log"):
    return os.path.join(root, name + (".db" if backend in ("sqlite", "net")
                                      else ""))


#: the net backend's logs: path -> (its in-process BusServer, the
#: SqliteBus behind it), until ``_close_servers``
_SERVERS = {}


def _server_at(pkg, path):
    """The address of ``pkg``'s ``BusServer`` over a ``SqliteBus`` at
    ``path``, started on port 0 at the first call for the path."""
    if path not in _SERVERS:
        backing = pkg.bus.SqliteBus(path)
        _SERVERS[path] = (pkg.bus_server.BusServer(backing).start(), backing)
    host, port = _SERVERS[path][0].address
    return f"{host}:{port}"


def _close_servers():
    """Close every net log's server, then the bus behind it."""
    while _SERVERS:
        srv, backing = _SERVERS.popitem()[1]
        srv.close()
        backing.close()


def _bus_at(pkg, backend, path, **kw):
    """A bus of ``pkg`` on ``backend`` at ``path``. For ``net``, a
    ``NetBus`` to the server of the log at ``path``: a second call for the
    path opens a second client of the same server."""
    if backend == "memory":
        return pkg.bus.MemoryBus()
    if backend == "sqlite":
        return pkg.bus.SqliteBus(path, **kw)
    if backend == "net":
        return pkg.netbus.NetBus(_server_at(pkg, path), client_id="parity",
                                 **kw)
    return pkg.bus.KvBus(path, **kw)


def _new(pkg, backend, root, name="log", **kw):
    return _bus_at(pkg, backend, _path(root, backend, name), **kw)


def _mix(E, i):
    """The i-th payload of a fixed mix of every payload type."""
    return [lambda: E.mail(f"m{i} ü", sender=f"s{i % 3}"),
            lambda: E.inf_in({"ctx": f"c{i}"}, "d1"),
            lambda: E.inf_out({"plan": [i, "β"]}, "d1"),
            lambda: E.intent("train_chunk", {"steps": i % 5}, "d1",
                             intent_id=f"i{i}"),
            lambda: E.vote(f"i{i}", "rule", "v1", i % 2 == 0, reason="ok"),
            lambda: E.commit(f"i{i}", "dec"),
            lambda: E.abort(f"i{i}", "dec", reason="nein"),
            lambda: E.result(f"i{i}", True, {"out": i}, "x1"),
            lambda: E.policy("decider", {"mode": "first_voter", "n": i}),
            lambda: E.checkpoint("driver-1", i, f"snap-{i}",
                                 driver_epoch=i % 4)][i % 10]()


def _one_of_each(E):
    """One payload of every PayloadType, with non-ASCII text and a
    checkpoint marker, as ``tests/test_codec.py`` builds them."""
    return [E.inf_in({"ctx": "übung"}, "d1"),
            E.inf_out({"plan": ["α", "β"]}, "d1"),
            E.intent("write_file", {"path": "/tmp/naïve.txt"}, "d1",
                     intent_id="i1"),
            E.vote("i1", "rule", "v1", True, reason="日本語 reason"),
            E.commit("i1", "dec"),
            E.abort("i2", "dec", reason="预算"),
            E.result("i1", True, {"out": "héllo"}, "x1"),
            E.mail("Привет, мир", sender="usér"),
            E.policy("decider", {"mode": "on_by_default"}),
            E.checkpoint("driver-1", 42, "snap-00042", driver_epoch=3)]


# ---------------------------------------------------------------------------
# the codec's bytes
# ---------------------------------------------------------------------------

def _body_codecs():
    codecs = [REF.codec.BODY_JSON]
    if REF.codec.HAVE_MSGPACK:
        codecs.append(REF.codec.BODY_MSGPACK)
    return codecs


def _encoded(pkg, body_codec):
    E, codec = pkg.entries, pkg.codec
    payloads = _one_of_each(E)
    entries = [E.Entry(i, 1000.5 + i, p) for i, p in enumerate(payloads)]
    return {"entries": codec.encode_entries(entries, body_codec),
            "payloads": codec.encode_payloads(payloads, body_codec),
            "blobs": [codec.payload_blob(p, body_codec) for p in payloads]}


def test_codec_bytes_are_equal_and_read_both_ways():
    assert PORT.codec.HAVE_MSGPACK == REF.codec.HAVE_MSGPACK
    assert {p.type for p in _one_of_each(PORT.entries)} == \
        set(PORT.entries.ALL_TYPES)
    for bc in _body_codecs():
        want, got = _encoded(REF, bc), _encoded(PORT, bc)
        assert got == want
        for writer, reader in ((REF, PORT), (PORT, REF)):
            buf = _encoded(writer, bc)["entries"]
            for lazy in (True, False):
                mine = reader.codec.decode_entries(
                    _encoded(reader, bc)["entries"], lazy=lazy)
                theirs = reader.codec.decode_entries(buf, lazy=lazy)
                assert _obs(theirs) == _obs(mine) and len(mine) == 10
            blobs = _encoded(writer, bc)["blobs"]
            back = [reader.codec.payload_from_blob(p.type, b).body
                    for p, b in zip(_one_of_each(reader.entries), blobs)]
            assert back == [p.body for p in _one_of_each(reader.entries)]


def _corrupt(pkg, buf):
    rec = Record()
    for label, bad in (("truncated", buf[:-7]),
                       ("bad version", b"\x09" + buf[1:]),
                       ("bad type tag", buf[:2] + b"\xff" + buf[3:]),
                       ("header cut", buf[:10])):
        rec.do(label, lambda b: _obs(pkg.codec.decode_entries(b, lazy=False)),
               bad)
    return rec


def test_a_corrupt_frame_raises_codec_error_in_both():
    buf = _encoded(REF, REF.codec.BODY_JSON)["entries"]
    want, got = _corrupt(REF, buf), _corrupt(PORT, buf)
    assert got == want
    assert all(obs[:2] == ("raised", "CodecError") for _, obs in got)


# ---------------------------------------------------------------------------
# each package reads the other's log
# ---------------------------------------------------------------------------

WRITES = ["sqlite", "sqlite-no-group-commit", "sqlite-fork", "kv",
          "kv-compact", "kv-fork"]


def _write_log(pkg, root, kind):
    """~280 entries of every type, single appends and batches of up to 6,
    then a trim; for the variants a compaction, or a fork at 150 that gets
    three entries of its own. Returns the backend and the path to read."""
    E = pkg.entries
    backend = kind.split("-")[0]
    kw = {"group_commit": False} if kind == "sqlite-no-group-commit" else {}
    os.makedirs(root, exist_ok=True)
    bus = _new(pkg, backend, root, **kw)
    i = 0
    for r in range(90):
        n = r % 7
        if n == 0:
            bus.append(_mix(E, i))
            i += 1
        else:
            bus.append_many([_mix(E, i + j) for j in range(n)])
            i += n
    bus.trim(37)
    path = _path(root, backend)
    if kind == "kv-compact":
        bus.compact(max_segment_entries=16)
    if kind.endswith("fork"):
        path = _path(root, backend, "child")
        child = bus.fork(150, path)
        child.append_many([E.mail(f"child {j}") for j in range(3)])
        child.close()
    bus.close()
    return backend, path


def _read_log(pkg, backend, path):
    """A fresh instance's view of the log at ``path``."""
    rec = Record()
    bus = _bus_at(pkg, backend, path)
    base = rec.see("trim base", bus.trim_base())
    rec.see("tail", bus.tail())
    rec.do("every entry", bus.read, base)
    for t in pkg.entries.PayloadType:
        rec.do(f"typed {t.value}", bus.read, base, types=[t])
    rec.do("a range", bus.read, base + 5, base + 40)
    rec.do("below the base", bus.read, base - 1)
    if backend == "kv":
        rec.see("quarantined", bus.quarantined)
    bus.close()
    return rec


@pytest.mark.parametrize("kind", WRITES)
def test_each_package_reads_the_others_log(tmp_path, kind):
    recs = {}
    for w in (REF, PORT):
        with _clock(w):
            backend, path = _write_log(w, str(tmp_path / w.name), kind)
        for r in (REF, PORT):
            recs[w.name, r.name] = _read_log(r, backend, path)
    want = recs["repro", "repro"]
    assert want.get("trim base") > 0
    assert len(want.get("every entry")) > 100
    assert want.get("below the base")[:2] == ("raised", "TrimmedError")
    for key, rec in recs.items():
        assert rec == want, key


def _legacy_log(pkg, root, backend):
    """Three entries in the legacy JSON format (text rows; a whole-object
    ``seg-*.json``), then a binary batch through the bus, and for kv a
    compaction of the mixed run."""
    E = pkg.entries
    os.makedirs(root, exist_ok=True)
    path = _path(root, backend, "legacy")
    old = [E.Entry(i, 1.0 + i, E.mail(f"old{i}", marker="läcy"))
           for i in range(3)]
    if backend == "sqlite":
        pkg.bus.SqliteBus(path).close()  # the schema
        conn = sqlite3.connect(path)
        with conn:
            conn.executemany(
                "INSERT INTO log(position, realtime_ts, type, payload) "
                "VALUES (?, ?, ?, ?)",
                [(e.position, e.realtime_ts, e.type.value,
                  e.payload.to_json()) for e in old])
        conn.close()
    else:
        os.makedirs(path)
        with open(os.path.join(path, "seg-000000000000.json"), "w") as f:
            json.dump([e.to_dict() for e in old], f, sort_keys=True,
                      default=E._json_default)
    bus = _bus_at(pkg, backend, path)
    bus.append_many([E.mail("new"), E.vote("i0", "rule", "v", True)])
    if backend == "kv":
        bus.compact(max_segment_entries=16)
    bus.close()
    return path


@pytest.mark.parametrize("backend", ["sqlite", "kv"])
def test_legacy_json_logs_read_alike(tmp_path, backend):
    recs = {}
    for w in (REF, PORT):
        with _clock(w):
            path = _legacy_log(w, str(tmp_path / w.name), backend)
        for r in (REF, PORT):
            recs[w.name, r.name] = _read_log(r, backend, path)
    want = recs["repro", "repro"]
    assert [b.get("text") for _, _, b, _ in want.get("every entry")][:4] == \
        ["old0", "old1", "old2", "new"]
    for key, rec in recs.items():
        assert rec == want, key


# ---------------------------------------------------------------------------
# the contracts: conformance, fork, durability, segments, group commit,
# lifecycle (each scenario: pkg, record, root, backend)
# ---------------------------------------------------------------------------

def sc_append(pkg, rec, root, backend):
    E, bus = pkg.entries, _new(pkg, backend, root)
    rec.see("tail 0", bus.tail())
    rec.see("append", bus.append(E.mail("a")))
    rec.see("batch", bus.append_many([E.mail("b"),
                                      E.vote("i1", "rule", "v", True)]))
    rec.see("empty batch", bus.append_many([]))
    rec.see("batch of 5", bus.append_many([E.mail(f"m{i}")
                                           for i in range(5)]))
    rec.see("tail", bus.tail())
    rec.do("all", bus.read, 0)
    rec.do("a range", bus.read, 3, 7)
    bus.close()


def sc_read(pkg, rec, root, backend):
    E, bus = pkg.entries, _new(pkg, backend, root)
    for i in range(8):
        bus.append(E.mail(f"m{i}"))
        bus.append(E.intent("k", {"i": i}, "d", intent_id=f"i{i}"))
        bus.append(E.vote(f"i{i}", "rule", "v", i % 2 == 0))
        if i % 3 == 0:
            bus.append(E.commit(f"i{i}", "dec"))
    rec.do("all", bus.read, 0)
    rec.do("3..7", bus.read, 3, 7)
    rec.do("at the tail", bus.read, bus.tail())
    rec.do("past the tail", bus.read, 99)
    rec.do("intents", bus.read, 0, types=[E.PayloadType.INTENT])
    rec.do("mails 2..9", bus.read, 2, 9, types=[E.PayloadType.MAIL])
    rec.do("mails and commits", bus.read, 0,
           types=[E.PayloadType.MAIL, E.PayloadType.COMMIT])
    rec.do("intents 3..17", bus.read, 3, 17, types=[E.PayloadType.INTENT])
    rec.do("read_type votes", bus.read_type, E.PayloadType.VOTE)
    bus.close()


def sc_poll_wait(pkg, rec, root, backend):
    E, bus = pkg.entries, _new(pkg, backend, root)
    rec.see("quiet wait", bus.wait(bus.tail(), timeout=0.05))
    bus.append(E.mail("x"))
    bus.append(E.commit("i1", "dec"))
    rec.do("poll commits", bus.poll, 0, [E.PayloadType.COMMIT], timeout=2.0)
    rec.do("poll at the tail", bus.poll, bus.tail(), [E.PayloadType.COMMIT],
           timeout=0.05)
    out = {}

    def waiter():
        out["woke"] = bus.wait(bus.tail(), timeout=5.0)
        out["got"] = bus.poll(0, [E.PayloadType.VOTE], timeout=5.0)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    bus.append(E.vote("i1", "rule", "v", True))
    t.join(timeout=10.0)
    rec.see("waiter done", not t.is_alive())
    rec.see("woke", out.get("woke"))
    rec.see("polled", out.get("got"))
    rec.see("stale tail", bus.wait(bus.tail() - 1, timeout=0))
    rec.see("from 0", bus.wait(0, timeout=0))
    bus.close()


def sc_lazy_eager(pkg, rec, root, backend):
    E, bus = pkg.entries, _new(pkg, backend, root)
    payloads = [E.mail("héllo ünïcode", nested=[1, {"x": [2, 3]}]),
                E.intent("k", {"arg": "välue"}, "d", intent_id="i1"),
                E.vote("i1", "rule", "v", True),
                E.checkpoint("c1", 2, "snap-2")]
    positions = rec.see("positions", bus.append_many(payloads))
    got = rec.do("read", bus.read, 0)
    eager = [E.Entry(pos, e.realtime_ts, E.Payload(p.type, p.body))
             for pos, p, e in zip(positions, payloads, got)]
    rec.see("equal to eager both ways",
            [(g == w, w == g) for g, w in zip(got, eager)])
    rec.see("wire dicts", [g.to_dict() for g in got])
    rec.see("from_dict", [E.Entry.from_dict(g.to_dict()) == g for g in got])
    rec.do("votes", bus.read, 0, types=[E.PayloadType.VOTE])
    bus.close()


def sc_trim(pkg, rec, root, backend):
    E, bus = pkg.entries, _new(pkg, backend, root)
    for i in range(4):
        bus.append(E.mail(f"m{i}"))
    rec.see("base 0", bus.trim_base())
    rec.see("trim 2", bus.trim(2))
    rec.see("base", bus.trim_base())
    rec.see("tail", bus.tail())
    rec.do("from 2", bus.read, 2)
    rec.do("from 0", bus.read, 0)
    rec.see("trim 1", bus.trim(1))
    rec.see("compact", bus.compact())
    rec.do("from 2 again", bus.read, 2)
    bus.close()


def sc_trim_lifecycle(pkg, rec, root, backend):
    """tests/test_lifecycle.py:35."""
    E, bus = pkg.entries, _new(pkg, backend, root)
    for i in range(10):
        bus.append(E.mail(f"m{i}"))
    base = rec.see("trim 5", bus.trim(5))
    rec.see("again", bus.trim(5))
    rec.see("lower", bus.trim(3))
    rec.see("base", bus.trim_base())
    rec.see("tail", bus.tail())
    rec.do("from the base", bus.read, base)
    rec.do("from 5", bus.read, 5)
    rec.do("from 0", bus.read, 0)
    rec.do("typed below", bus.read, base - 1, types=[E.PayloadType.MAIL])
    rec.do("poll below", bus.poll, 0, [E.PayloadType.MAIL], timeout=0.01)
    rec.see("append after", bus.append(E.mail("after")))
    bus.close()


def sc_trim_durable(pkg, rec, root, backend):
    """tests/test_lifecycle.py:62 and :79: a trim, and a trim to the tail,
    survive a reopen; appends resume at the old tail."""
    E = pkg.entries
    bus = _new(pkg, backend, root)
    for i in range(8):
        bus.append(E.mail(f"m{i}"))
    bus.trim(4)
    bus.close()
    bus = _new(pkg, backend, root)
    rec.see("base", bus.trim_base())
    rec.see("tail", bus.tail())
    rec.do("from 0", bus.read, 0)
    rec.do("from 4", bus.read, 4)
    bus.close()
    bus = _new(pkg, backend, root, "full")
    bus.append_many([E.mail(f"m{i}") for i in range(6)])
    rec.see("trim to the tail", bus.trim(6))
    rec.see("tail after", bus.tail())
    rec.do("at the tail", bus.read, 6)
    rec.see("append", bus.append(E.mail("next")))
    bus.close()
    bus = _new(pkg, backend, root, "full")
    rec.see("reopened base", bus.trim_base())
    rec.see("reopened tail", bus.tail())
    rec.see("append after reopen", bus.append(E.mail("x")))
    rec.do("all", bus.read, bus.trim_base())
    bus.close()


def sc_durable(pkg, rec, root, backend):
    """tests/test_bus.py:85 and :95."""
    E = pkg.entries
    bus = _new(pkg, backend, root)
    bus.append(E.mail("survive"))
    bus.append_many([E.mail("and"), E.mail("these")])
    bus.close()
    bus = _new(pkg, backend, root)
    rec.see("tail", bus.tail())
    rec.do("all", bus.read, 0)
    bus.close()


def _fill(E, bus, n):
    for i in range(n):  # one entry a batch (a segment): trim lands exactly
        bus.append(E.mail(f"m{i}", tag=i))


def sc_fork(pkg, rec, root, backend):
    """tests/test_bus.py:700-780: prefix, divergence both ways, fork of a
    fork, the clamp to the tail."""
    E, codec = pkg.entries, pkg.codec
    bus = _new(pkg, backend, root)
    _fill(E, bus, 8)
    child = bus.fork(5)
    rec.see("child tail", child.tail())
    rec.see("bases", (child.trim_base(), bus.trim_base()))
    rec.do("child", child.read, 0)
    rec.see("prefix bytes", codec.encode_entries(child.read(0)) ==
            codec.encode_entries(bus.read(0)[:5]))
    bus.append(E.mail("parent-only"))
    child.append(E.mail("child-only"))
    child.append(E.mail("child-only-2"))
    rec.see("tails", (bus.tail(), child.tail()))
    rec.do("parent from 5", bus.read, 5)
    rec.do("child from 5", child.read, 5)
    grand = child.fork(3)
    grand.append(E.mail("g"))
    rec.do("grandchild", grand.read, 0)
    rec.see("tails after", (bus.tail(), child.tail(), grand.tail()))
    clamped = bus.fork(999)
    rec.see("clamped tail", clamped.tail())
    for b in (grand, child, clamped, bus):
        b.close()


def sc_fork_trimmed(pkg, rec, root, backend):
    E = pkg.entries
    bus = _new(pkg, backend, root)
    _fill(E, bus, 6)
    base = rec.see("trim 3", bus.trim(3))
    rec.do("fork below the base", bus.fork, base - 1)
    child = bus.fork(5)
    rec.see("child base", child.trim_base())
    rec.do("child from the base", child.read, base)
    rec.do("child from 0", child.read, 0)
    child.close()
    bus.close()


def sc_concurrent(pkg, rec, root, backend):
    """tests/test_bus.py:65 and :160: concurrent appends and batches. The
    interleaving differs from run to run: only its invariants are
    recorded."""
    E, bus = pkg.entries, _new(pkg, backend, root)
    n_threads, batches, per = 6, 4, 5

    def worker(k):
        for b in range(batches):
            bus.append(E.mail(f"{k}-{b}-s", sender=f"t{k}"))
            bus.append_many([E.mail(f"{k}-{b}-{i}", sender=f"t{k}")
                             for i in range(per)])

    ts = [threading.Thread(target=worker, args=(k,))
          for k in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    es = bus.read(0)
    total = n_threads * batches * (per + 1)
    rec.see("dense", [e.position for e in es] == list(range(total)))
    rec.see("nothing lost", len({e.body["text"] for e in es}) == total)
    by_batch = {}
    for e in es:
        k, b, i = e.body["text"].split("-")
        if i != "s":
            by_batch.setdefault((k, b), []).append((int(i), e.position))
    rec.see("batches contiguous", all(
        [p for _, p in sorted(v)] == list(range(min(v)[1], min(v)[1] + per))
        for v in by_batch.values()))
    bus.close()


def sc_group_commit(pkg, rec, root, backend):
    """tests/test_bus.py:574-625 (sqlite): concurrent batches coalesce
    under a window (invariants only), a lone writer pays one transaction a
    batch, and group commit off."""
    E = pkg.entries
    bus = _new(pkg, backend, root, group_window_s=0.05)
    n_threads, per = 8, 4
    results, barrier = {}, threading.Barrier(n_threads)

    def writer(k):
        barrier.wait()
        results[k] = bus.append_many([E.mail(f"w{k}-{i}")
                                      for i in range(per)])

    ts = [threading.Thread(target=writer, args=(k,))
          for k in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    rec.see("batches", bus.gc_batches)
    rec.see("coalesced", bus.gc_commits < n_threads)
    rec.see("dense", sorted(p for ps in results.values() for p in ps)
            == list(range(n_threads * per)))
    rec.see("contiguous", all(ps == list(range(ps[0], ps[0] + per))
                              for ps in results.values()))
    rec.see("own positions", all(
        [e.body["text"] for e in bus.read(ps[0], ps[-1] + 1)]
        == [f"w{k}-{i}" for i in range(per)] for k, ps in results.items()))
    bus.close()
    with _clock(pkg):  # the transactions above took a varying count of ts
        solo = _new(pkg, backend, root, "solo")
        for i in range(10):
            solo.append_many([E.mail(f"s{i}"), E.mail(f"t{i}")])
        rec.see("solo commits, batches, tail",
                (solo.gc_commits, solo.gc_batches, solo.tail()))
        rec.do("solo", solo.read, 0)
        solo.close()
        off = _new(pkg, backend, root, "off", group_commit=False)
        rec.see("off", off.append_many([E.mail("a"), E.mail("b")]))
        rec.do("off read", off.read, 0)
        off.close()


def sc_kv_segments(pkg, rec, root, backend):
    """tests/test_bus.py:250 and :274: reads across segment boundaries,
    and one RTT charged per object."""
    E = pkg.entries
    bus = _new(pkg, backend, root)
    rec.see("rtt", bus.rtt_ops)
    bus.append_many([E.mail(f"a{i}") for i in range(4)])
    rec.see("rtt after a batch", bus.rtt_ops)
    bus.append(E.vote("i0", "rule", "v", True))
    bus.append(E.mail("solo"))
    bus.append_many([E.mail(f"b{i}") for i in range(5)])
    rec.see("tail", bus.tail())
    rec.see("rtt after four", bus.rtt_ops)
    for a, b in ((2, 9), (3, 4), (7, 8), (11, None)):
        rec.do(f"read {a}..{b}", bus.read, a, b)
    rec.do("votes", bus.read, 0, types=[E.PayloadType.VOTE])
    reader = _new(pkg, backend, root)
    rec.do("fresh 2..9", reader.read, 2, 9)
    rec.see("reader rtt", reader.rtt_ops)
    reader.read(0, 4)
    reader.tail()
    rec.see("cached", reader.rtt_ops)
    bus.append(E.mail("late"))
    rec.do("fresh all", reader.read, 0)
    rec.see("one more GET", reader.rtt_ops)


def sc_kv_trim_compact(pkg, rec, root, backend):
    """tests/test_lifecycle.py:98 and :114, tests/test_bus.py's binary
    segments through trim and compact."""
    E = pkg.entries
    root_dir = _path(root, backend)
    bus = _new(pkg, backend, root)
    bus.append_many([E.mail(f"a{i}") for i in range(4)])
    bus.append_many([E.mail(f"b{i}") for i in range(4)])
    rec.see("aligned trim", bus.trim(6))
    rec.see("files", sorted(os.listdir(root_dir)))
    for i in range(20):
        bus.append(E.mail(f"m{i}") if i % 3 else
                   E.intent("k", {"i": i}, "d", intent_id=f"i{i}"))
    rec.see("merged", bus.compact(max_segment_entries=8))
    rec.see("files after", sorted(os.listdir(root_dir)))
    rec.do("all", bus.read, bus.trim_base())
    rec.do("intents", bus.read, bus.trim_base(),
           types=[E.PayloadType.INTENT])
    fresh = _new(pkg, backend, root)
    rec.see("fresh tail", fresh.tail())
    rec.do("fresh 9..23", fresh.read, 9, 23)


def sc_kv_cache(pkg, rec, root, backend):
    """tests/test_lifecycle.py:174 and :256: a bounded cache re-charges
    GETs; a reader with a stale base still raises after another instance
    trimmed."""
    E = pkg.entries
    bus = _new(pkg, backend, root, cache_segments=2)
    for i in range(6):
        bus.append(E.mail(f"m{i}"))
    rec.see("cache bound", len(bus._seg_cache) <= 2)
    ops = bus.rtt_ops
    rec.do("all", bus.read, 0)
    rec.see("re-charged", bus.rtt_ops - ops)
    reader = _new(pkg, backend, root)
    rec.see("reader tail", reader.tail())
    _new(pkg, backend, root).trim(4)
    rec.do("stale reader from 0", reader.read, 0)
    rec.do("stale reader from 4", reader.read, 4)


def sc_kv_under_load(pkg, rec, root, backend):
    """tests/test_lifecycle.py:142: compaction under concurrent appends
    with a small cache (invariants only)."""
    E = pkg.entries
    bus = _new(pkg, backend, root, cache_segments=4)

    def appender():
        for k in range(40):
            bus.append_many([E.mail(f"w{k}-{j}") for j in range(3)])

    t = threading.Thread(target=appender)
    t.start()
    while t.is_alive():
        bus.compact(max_segment_entries=16)
    t.join(timeout=10.0)
    bus.compact(max_segment_entries=16)
    rec.see("tail", bus.tail())
    rec.see("dense", [e.position for e in bus.read(0)] == list(range(120)))
    rec.see("cache bound", len(bus._seg_cache) <= 4)
    base = bus.trim(60)
    bus.compact(max_segment_entries=64)
    reader = _new(pkg, backend, root, cache_segments=2)
    rec.see("reader dense", [e.position for e in reader.read(base)]
            == list(range(base, 120)))
    rec.see("reader cache bound", len(reader._seg_cache) <= 2)
    rec.do("below the base", reader.read, base - 1)


def sc_kv_fork_cow(pkg, rec, root, backend):
    """tests/test_bus.py:783: the fork shares whole segments by hard link
    and rewrites only the boundary; each side's writes stay its own."""
    E = pkg.entries
    root_dir = _path(root, backend)
    bus = _new(pkg, backend, root)
    for i in range(10):
        bus.append_many([E.mail(f"s{i}e{j}") for j in range(4)])
    child_root = _path(root, backend, "child")
    child = bus.fork(26, child_root)
    rec.see("fork stats", child.fork_stats)
    shared = sorted(n for n in os.listdir(child_root)
                    if n.startswith("seg-"))[:6]
    rec.see("same inodes", [
        os.stat(os.path.join(child_root, n)).st_ino
        == os.stat(os.path.join(root_dir, n)).st_ino for n in shared])
    rec.do("child", child.read, 0)
    child.append(E.mail("child"))
    bus.trim(8)
    rec.do("child after the parent's trim", child.read, 0)
    fresh = _new(pkg, backend, root, "child")
    rec.do("fresh child", fresh.read, 0)
    rec.see("quarantined", fresh.quarantined)


CONTRACTS = [(sc, b) for sc in (sc_append, sc_read, sc_poll_wait,
                                sc_lazy_eager, sc_trim, sc_trim_lifecycle,
                                sc_trim_durable, sc_durable, sc_fork,
                                sc_fork_trimmed, sc_concurrent)
             for b in ("sqlite", "kv")] + [
    (sc_group_commit, "sqlite"), (sc_kv_segments, "kv"),
    (sc_kv_trim_compact, "kv"), (sc_kv_cache, "kv"),
    (sc_kv_under_load, "kv"), (sc_kv_fork_cow, "kv")]


@pytest.mark.parametrize("scenario,backend", CONTRACTS,
                         ids=[f"{sc.__name__[3:]}-{b}" for sc, b in CONTRACTS])
def test_contract_records_are_equal(tmp_path, scenario, backend):
    want, got = _both(scenario, tmp_path, backend)
    assert got == want


def sc_make_bus(pkg, rec, root, backends=("memory", "sqlite", "kv")):
    """``make_bus`` on each of ``backends``; ``net`` to an in-process
    server over a SqliteBus, closed before the scenario ends."""
    E = pkg.entries
    try:
        for backend in backends:
            path = None if backend == "memory" else _path(root, backend)
            if backend == "net":
                path = _server_at(pkg, path)
            bus = pkg.bus.make_bus(backend, path)
            rec.see(f"{backend} class", type(bus).__name__)
            rec.see(f"{backend} of its own package",
                    type(bus).__module__.split(".")[0] == pkg.name)
            rec.see(f"{backend} append", bus.append(E.mail(backend)))
            rec.do(f"{backend} read", bus.read, 0)
            bus.close()
    finally:
        _close_servers()
    rec.do("sqlite without a path", pkg.bus.make_bus, "sqlite")
    rec.do("unknown", pkg.bus.make_bus, "tape")


def test_make_bus_memory_sqlite_kv(tmp_path):
    want, got = _both(sc_make_bus, tmp_path)
    assert got == want
    assert [v for k, v in got if k.endswith("class")] == \
        ["MemoryBus", "SqliteBus", "KvBus"]


def test_make_bus_net(tmp_path):
    """``make_bus("net", "host:port")`` gives each package's own
    ``NetBus``, which appends and reads back through a server."""
    want, got = _both(sc_make_bus, tmp_path, ("net",))
    assert got == want
    assert got.get("net class") == "NetBus"
    assert got.get("net of its own package") is True
    assert got.get("net read")[0][2] == {"text": "net", "sender": "user"}


# ---------------------------------------------------------------------------
# crash atomicity: every SQLite and KV crash point
# ---------------------------------------------------------------------------

CRASH_POINTS = [(point, op) for point, spec in
                sorted(REF.faults.INJECTION_POINTS.items())
                if point.split(".")[0] in ("sqlite", "kv")
                for op in spec.ops]


def sc_crash(pkg, rec, root, point, op):
    """Eight entries in three batches (KV segments [0,4) [4,5) [5,8)), then
    one operation under a plan that fires at ``point``; then the log as a
    fresh instance sees it, and one more append."""
    E = pkg.entries
    backend, family = point.split(".")[:2]
    bus = _new(pkg, backend, root)
    bus.append_many([E.mail(f"a{i}") for i in range(4)])
    bus.append(E.vote("i0", "rule", "v", True))
    bus.append_many([E.mail(f"b{i}") for i in range(3)])
    child = _path(root, backend, "child")
    operation = {
        "append": lambda: bus.append_many([E.mail(f"c{i}")
                                           for i in range(3)]),
        "trim": lambda: bus.trim(5),
        "compact": lambda: bus.compact(max_segment_entries=16),
        "fork": lambda: bus.fork(6, child).tail()}[family]
    with pkg.faults.injected(pkg.faults.FaultPlan.single(point, op=op)) \
            as inj:
        rec.do("operation", operation)
    rec.see("fired", [(a.point, a.op) for a in inj.fired])
    bus.close()
    fresh = _new(pkg, backend, root)
    rec.see("tail", fresh.tail())
    base = rec.see("trim base", fresh.trim_base())
    rec.do("entries", fresh.read, base)
    if backend == "kv":
        rec.see("quarantined", fresh.quarantined)
        rec.see("segments", sorted(n for n in os.listdir(_path(root, "kv"))
                                   if n.startswith("seg-")))
    rec.see("fork child published", os.path.exists(child))
    rec.see("append after", fresh.append(E.mail("after")))
    rec.do("entries after", fresh.read, fresh.trim_base())
    fresh.close()


def test_the_crash_points_are_the_same():
    mine = [(p, op) for p, spec in sorted(PORT.faults.INJECTION_POINTS.items())
            if p.split(".")[0] in ("sqlite", "kv") for op in spec.ops]
    assert mine == CRASH_POINTS and len(CRASH_POINTS) >= 16


@pytest.mark.parametrize("point,op", CRASH_POINTS,
                         ids=[f"{p}-{op}" for p, op in CRASH_POINTS])
def test_crash_point_leaves_the_same_log(tmp_path, point, op):
    want, got = _both(sc_crash, tmp_path, point, op)
    assert got == want
    assert got.get("fired") == [[point, op]]
    assert got.get("operation")[:2] == ("raised", "CrashPoint")
    family = point.split(".")[1]
    if family == "append":  # the batch is all there or not at all
        assert got.get("tail") in (8, 11)
        assert len(got.get("entries")) == got.get("tail")
    if op == "torn" and family == "append" and "publish" in point:
        assert got.get("quarantined") == 1 and got.get("tail") == 8
    if family == "fork":  # a crashed fork publishes no child
        assert got.get("fork child published") is False


# ---------------------------------------------------------------------------
# governed agents on a durable log, against the JAX side
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def serving():
    jcfg = jax_smoke(jax_get_config("qwen3_4b"))
    tcfg = smoke(get_config("qwen3_4b"))
    jparams, _ = split_params(JaxModel(jcfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(0)))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def _sched(entry):
    """The ``_sched`` flags in an InfIn entry's mail: the continuous
    planner sets them on the driver's mail dicts after the driver logged
    them in an InfIn context (the reference's ``serving/server.py:243``)."""
    _, t, body, _ = entry
    return [m.get("_sched") for m in body.get("context", {}).get("mail", [])
            if t == "InfIn" and "_sched" in m]


def _unsched(entry):
    pos, t, body, ts = entry
    if t == "InfIn":
        body = json.loads(json.dumps(body))
        for m in body["context"]["mail"]:
            m.pop("_sched", None)
    return pos, t, body, ts


def _serve(serving, pkg, backend, root):
    """The governed continuous serving agent (smoke qwen3_4b, a tenant
    denylist) on a durable log of ``pkg``; the log is then reopened by a
    fresh instance (on ``net``, a ``SqliteBus`` on the server's file once
    the client, the server and its bus are closed), which must read what
    the agent's client read. One
    difference is the reference's own: a bus that serves back the objects
    it was given (KV's segment cache, like the memory bus) shows the
    agent the planner's later ``_sched`` flags in its InfIn entries, which
    the durable copy, written when they were appended, does not hold."""
    jcfg, tcfg, jparams, tparams = serving
    os.makedirs(root, exist_ok=True)
    path = _path(root, backend, "serve")
    bus = _bus_at(pkg, backend, path)
    kw = dict(max_batch=4, num_pages=64, page_size=8, max_new_tokens=4)
    eng = dict(max_batch=4, num_pages=64, page_size=8)
    if pkg is REF:
        srv = jax_server
        agent = srv.build_continuous_serving_agent(jcfg, bus=bus, **kw)
        agent.executor.env.engine = JaxEngine(jcfg, params=jparams, **eng)
    else:
        srv = server
        agent = srv.build_continuous_serving_agent(tcfg, bus=bus,
                                                   device="cpu", **kw)
        agent.executor.env.engine = PagedEngine(tcfg, params=tparams,
                                                device="cpu", **eng)
    agent.add_voter(pkg.voter.RuleVoter(
        pkg.acl.BusClient(bus, "v-rule", "voter"),
        rules=srv.SERVE_ADMISSION_RULES), from_tail=False)
    agent.set_policy("decider", {"mode": "first_voter"})
    agent.set_policy("voter:rule", {"tenant_denylist": ["evil"]})
    for i, (prompt, tenant) in enumerate([([7, 8, 9], "default"),
                                          ([11, 12], "evil"),
                                          ([13, 14, 15, 16], "default")]):
        agent.send_mail(f"req {i}", prompt_tokens=prompt, req_id=f"r{i}",
                        tenant=tenant)
    agent.run_until_idle()
    log = _obs(agent.external_client("t", "admin").read(0))
    bus.close()
    _close_servers()  # on net, the file behind the server is read back
    fresh = _bus_at(pkg, "sqlite" if backend == "net" else backend, path)
    back = _obs(fresh.read(0))
    assert pkg.recovery.committed_unexecuted(fresh) == []
    fresh.close()
    assert len(log) > 10 and not any(_sched(e) for e in back)
    assert [_unsched(e) for e in back] == [_unsched(e) for e in log]
    T = pkg.entries.PayloadType
    decisions = [(t, b["kind"] if t == T.INTENT.value else b.get("approve"))
                 for _, t, b, _ in log
                 if t in (T.INTENT.value, T.VOTE.value, T.COMMIT.value,
                          T.ABORT.value)]
    pl = agent.driver.planner
    return {"outputs": pl.outputs, "rejected": pl.rejected,
            "decisions": decisions, "types": [e[1] for e in log],
            "flagged in memory": sum(a != b for a, b in zip(log, back))}


@pytest.mark.parametrize("backend", ["sqlite", "kv"])
def test_governed_serving_on_a_durable_log_matches_jax(tmp_path, serving,
                                                       backend):
    want = _serve(serving, REF, backend, str(tmp_path / "j"))
    got = _serve(serving, PORT, backend, str(tmp_path / "t"))
    assert set(got["outputs"]) == {"r0", "r2"} and got["rejected"] == ["r1"]
    assert ("Abort", None) in got["decisions"]
    assert got == want
    assert (got["flagged in memory"] > 0) == (backend == "kv")


def _drill_on_sqlite(side, tmpdir):
    """tests/test_recovery.py:31-60 with the agent's log in SQLite: the
    crash inside the second chunk, then what a second SqliteBus on the
    same file (a standby process) sees, then the roll forward."""
    env = side.env(tmpdir, dict(lr=1e-3, warmup_steps=2, total_steps=24))
    os.makedirs(tmpdir, exist_ok=True)
    db = os.path.join(tmpdir, "drill.db")
    bus = side.SqliteBus(db)
    agent = side.build_training_agent(env, total_steps=8,
                                      steps_per_intention=4, ckpt_every=100,
                                      bus=bus)
    env.crash_after_steps = 6
    agent.send_mail("train")
    with pytest.raises(side.InjectedCrash):
        agent.run_until_idle(max_rounds=10000)
    pending = side.committed_unexecuted(bus)
    standby = side.SqliteBus(db)
    seen = side.committed_unexecuted(standby)
    standby.close()
    env.crash_after_steps = None
    agent.executor = side.Executor(
        side.BusClient(bus, "executor-2", "executor"), env=env,
        handlers=side.handlers, announce_reboot=True)
    agent.run_until_idle(max_rounds=10000)
    bus.close()
    return pending, seen, parity.record(side, side.SqliteBus(db), env)


def test_crash_drill_on_sqlite_matches_jax(tmp_path):
    jpend, jseen, want = _drill_on_sqlite(parity.Side("jax"),
                                          str(tmp_path / "j"))
    tpend, tseen, got = _drill_on_sqlite(parity.Side("torch"),
                                         str(tmp_path / "t"))
    assert tseen == tpend and jseen == jpend
    def without_id(pend):
        return [{k: v for k, v in p.items() if k != "intent_id"}
                for p in pend]
    assert without_id(tpend) == without_id(jpend)
    assert [p["kind"] for p in tpend] == ["train_chunk"]
    parity.same(got, want)
    assert [t["kind"] for t in got["trace"]] == [
        "train_chunk", "train_chunk", "probe_state", "train_chunk", "eval"]
    assert got["step"] == 8


# ---------------------------------------------------------------------------
# the broken control
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["sqlite", "kv"])
def test_a_bus_that_drops_an_entry_fails_the_comparison(tmp_path,
                                                        monkeypatch,
                                                        backend):
    """A port bus whose ``read`` drops the last entry: the read contract's
    record and a cross-read of the reference's log must then differ from
    the reference's, where the unbroken port's are equal."""
    want = _run(sc_read, REF, tmp_path / "ref", backend)
    assert _run(sc_read, PORT, tmp_path / "port", backend) == want
    with _clock(REF):
        _, path = _write_log(REF, str(tmp_path / "w"), backend)
    ref_view = _read_log(REF, backend, path)
    assert _read_log(PORT, backend, path) == ref_view
    cls = PORT.bus.SqliteBus if backend == "sqlite" else PORT.bus.KvBus
    read = cls.read
    monkeypatch.setattr(cls, "read",
                        lambda self, *a, **kw: read(self, *a, **kw)[:-1])
    assert _run(sc_read, PORT, tmp_path / "broken", backend) != want
    assert _read_log(PORT, backend, path) != ref_view
