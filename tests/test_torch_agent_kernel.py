"""The port's agent kernel (``core/kernel.py``: ``AgentKernel``,
``TrimPolicy``, spawn images), its ``serving-continuous`` image and the
swarm ``Supervisor`` (``core/supervisor.py``) against the reference's, on
the CPU.

``core/kernel.py`` and ``core/supervisor.py`` are the reference's files
byte for byte (``test_torch_core_copies.py``); here each scenario runs
once per package through ``tests/_torch_core_parity.py``, under counters
for the entry timestamps and the drawn ids (``_clock``), and the port's
record must equal the reference's.

* Control plane (``tests/test_kernel_controlplane.py``): raw buses on
  the memory, sqlite and kv backends; auto-decider and auto-voter; spawn;
  spawn threaded; the threaded poll-driven pipeline.
* Lifecycle through the kernel (``tests/test_lifecycle.py:300-366``):
  ``maintain`` pausing and resuming a threaded agent; a ``TrimPolicy``
  on a synchronous one.
* The ``serving-continuous`` image, spawned by each package's kernel on
  SQLite under a ``TrimPolicy`` and run through
  ``test_torch_serving._governed`` (both engines on one carried-over
  parameter tree, the admission voter, a denylisted tenant).
* The ``Supervisor`` (``tests/test_substrates.py:130-197``): dedupe and
  fix broadcast; checkpoint and bootstrap.
* Broken controls that the comparison must catch: a port bus whose
  ``read`` drops one entry (one scenario of each core group), the port's
  engine on parameters of another seed, and a port image of a name of its
  own that builds the agent with another ``max_new_tokens``.

Threads: where components run on threads of their own (spawn threaded,
the poll pipeline, ``maintain`` of a threaded agent), the interleaving of
entries that two threads append is not fixed from run to run, and with
it the timestamps. There the record holds what the scenario fixes: each
intent's result, the bodies of each entry type in the order their one
writer appended them, the tail and the final cursors, and not the order
of the whole log. Every such scenario waits on a deadline it sets itself
and shuts its threads down in a ``finally``.

``health_check``'s latency verdicts are held because the timestamps come
from ``_clock``'s counter: under the wall clock they would not repeat.

No hypothesis: every input is fixed.
"""
import os
import threading
import time

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_core_parity import (PORT, REF, _both, _clock,  # noqa: E402
                                _run)
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.models.params import split_params  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402
from repro_torch.serving import server  # noqa: E402
from test_torch_serving import _governed, setup  # noqa: E402,F401

torch.set_num_threads(1)

DEADLINE_S = 30.0


# ---------------------------------------------------------------------------
# images, one per package, under names of this file's own
# ---------------------------------------------------------------------------

def _bump(args, env):
    env["n"] += 1
    return {"n": env["n"]}


def _plans(n):
    return [{"intent": {"kind": "bump", "args": {}}}
            for _ in range(n)] + [{"done": True}]


def _counter_image(pkg):
    def image(bus, snapshot_store=None, plans=None, **kw):
        env = {"n": 0}
        agent = pkg.agent.LogActAgent(
            bus=bus, planner=pkg.driver.ScriptPlanner(plans or _plans(1)),
            env=env, handlers={"bump": _bump},
            snapshot_store=snapshot_store)
        agent.env = env
        return agent
    return image


for _pkg in (REF, PORT):
    _pkg.kernel.register_image("parity-counter")(_counter_image(_pkg))


def _settle(kern, h, rec, label, rounds=60):
    """Tick the kernel until nothing plays and the driver is idle;
    record each round's count."""
    counts = []
    for _ in range(rounds):
        counts.append(kern.tick_all())
        if counts[-1] == 0 and h.agent.driver.idle:
            break
    rec.see(label, counts)


def _by_type(entries):
    """Bodies of each entry type, in log order within the type."""
    out = {}
    for e in entries:
        out.setdefault(e.type.value, []).append(e.body)
    return out


# ---------------------------------------------------------------------------
# control plane
# ---------------------------------------------------------------------------

def sc_raw(pkg, rec, root):
    kern = pkg.kernel.AgentKernel(workdir=root)
    try:
        for backend in ("memory", "sqlite", "kv"):
            h = kern.create_bus(f"b-{backend}", mode="raw", backend=backend)
            rec.see(f"{backend} class", type(h.bus).__name__)
            rec.see(f"{backend} append", h.bus.append(
                pkg.entries.mail(f"x-{backend}")))
            rec.see(f"{backend} tail", h.bus.tail())
            rec.do(f"{backend} read", h.bus.read, 0)
            rec.see(f"{backend} components", h.components())
        rec.see("buses", kern.list_buses())
        rec.do("unknown mode", kern.create_bus, "bad", mode="swarm")
        rec.see("maintain without a policy", kern.maintain("b-kv"))
    finally:
        kern.shutdown()


def sc_auto(pkg, rec, root):
    E, T = pkg.entries, pkg.entries.PayloadType
    kern = pkg.kernel.AgentKernel()
    try:
        d = kern.create_bus("d", mode="auto_decider")
        a = kern.create_bus("a", mode="auto_voter", voters=["rule"])
        rec.see("decider only", (d.decider is not None, len(d.voters)))
        rec.see("voters", [v.component_id for v in a.voters])
        for h, mode in ((d, "first_voter"), (a, "first_voter")):
            h.bus.append(E.policy("decider", {"mode": mode},
                                  issuer="admin"))
            ext = pkg.acl.BusClient(h.bus, "d0", "driver")
            ext.append(E.intent("bump", {}, "d0", intent_id="i9"))
            ext.append(E.intent("delete_checkpoint", {"step": 4}, "d0",
                                intent_id="i10"))
        rec.see("ticks", [kern.tick_all() for _ in range(3)])
        for name, h in (("d", d), ("a", a)):
            rec.see(f"{name} votes", h.bus.read_type(T.VOTE))
            rec.see(f"{name} decisions", h.bus.read_type(T.COMMIT, T.ABORT))
            rec.see(f"{name} log", h.bus.read(0))
    finally:
        kern.shutdown()


def sc_spawn(pkg, rec, root):
    kern = pkg.kernel.AgentKernel()
    try:
        h = kern.create_bus("worker", mode="spawn", image="parity-counter",
                            voters=["rule"])
        rec.see("components", [c.component_id for c in h.components()])
        h.bus.append(pkg.entries.mail("go"))
        _settle(kern, h, rec, "ticks")
        rec.see("n", h.agent.env["n"])
        traces = pkg.introspect.trace_intents(h.bus.read(0))
        rec.see("traces", [(t.kind, t.decision, len(t.votes), t.result)
                           for t in traces])
        rec.see("log", h.bus.read(0))
    finally:
        kern.shutdown()


def sc_spawn_threaded(pkg, rec, root):
    kern = pkg.kernel.AgentKernel()
    try:
        h = kern.create_bus("tw", mode="spawn", image="parity-counter",
                            threaded=True, image_kw={"plans": _plans(2)})
        h.bus.append(pkg.entries.mail("go"))
        rec.see("idle", h.agent.wait_idle(timeout=DEADLINE_S))
    finally:
        kern.shutdown()
    rec.see("n", h.agent.env["n"])
    log = h.bus.read(0)
    traces = pkg.introspect.trace_intents(log)
    rec.see("traces", [(t.intent_id, t.kind, t.decision, t.result)
                       for t in traces])
    rec.see("bodies by type", _by_type(log))
    tail = rec.see("tail", h.bus.tail())
    rec.see("cursors", {c.component_id: c.cursor == tail
                        for c in h.components()})


def sc_poll_pipeline(pkg, rec, root):
    """Voter, decider and executor threads wired directly on ``poll``."""
    E, T = pkg.entries, pkg.entries.PayloadType
    bus = pkg.bus.MemoryBus()
    stop = threading.Event()
    results = []

    def consume(client_id, role, types, act):
        client = pkg.acl.BusClient(bus, client_id, role)
        cursor = 0
        while not stop.is_set():
            for e in client.poll(cursor, types, timeout=0.2):
                act(client, e)
                cursor = e.position + 1

    seen = set()

    def decide(c, e):
        iid = e.body["intent_id"]
        if iid not in seen:
            seen.add(iid)
            c.append(E.commit(iid, "d"))

    def execute(c, e):
        results.append(e.body["intent_id"])
        c.append(E.result(e.body["intent_id"], True,
                          {"i": len(results)}, "x"))

    loops = [("v", "voter", [T.INTENT], lambda c, e: c.append(
                 E.vote(e.body["intent_id"], "rule", "v", True))),
             ("d", "decider", [T.VOTE], decide),
             ("x", "executor", [T.COMMIT], execute)]
    threads = [threading.Thread(target=consume, args=loop, daemon=True)
               for loop in loops]
    try:
        for t in threads:
            t.start()
        drv = pkg.acl.BusClient(bus, "drv", "driver")
        for i in range(5):
            drv.append(E.intent("work", {"i": i}, "drv", intent_id=f"w{i}"))
        deadline = time.monotonic() + DEADLINE_S
        while len(results) < 5 and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=5)
    rec.see("threads joined", [t.is_alive() for t in threads])
    rec.see("results", results)
    rec.see("bodies by type", _by_type(bus.read(0)))
    rec.see("tail", bus.tail())


CONTROL_PLANE = [sc_raw, sc_auto, sc_spawn, sc_spawn_threaded,
                 sc_poll_pipeline]


@pytest.mark.parametrize("scenario", CONTROL_PLANE,
                         ids=[sc.__name__[3:] for sc in CONTROL_PLANE])
def test_control_plane_records_are_equal(tmp_path, scenario):
    want, got = _both(scenario, tmp_path)
    assert got == want
    if scenario is sc_raw:
        assert [got.get(f"{b} class") for b in ("memory", "sqlite", "kv")] \
            == ["MemoryBus", "SqliteBus", "KvBus"]
        assert got.get("buses") == ["b-kv", "b-memory", "b-sqlite"]
        assert got.get("unknown mode")[:2] == ("raised", "ValueError")
    elif scenario is sc_auto:
        assert len(got.get("a votes")) == 2 and got.get("d votes") == []
        assert [(t, b["intent_id"]) for _, t, b, _ in
                got.get("a decisions")] == [("Commit", "i9"),
                                            ("Abort", "i10")]
    elif scenario is sc_spawn:
        assert got.get("n") == 1 and got.get("ticks")[-1] == 0
        assert got.get("traces")[0][1:3] == ["commit", 1]
    elif scenario is sc_spawn_threaded:
        assert got.get("idle") and got.get("n") == 2
        assert [t[2] for t in got.get("traces")] == ["commit", "commit"]
        assert all(got.get("cursors").values())
    else:
        assert got.get("results") == [f"w{i}" for i in range(5)]
        assert not any(got.get("threads joined"))


# ---------------------------------------------------------------------------
# log lifecycle through the kernel
# ---------------------------------------------------------------------------

def _snapshot_counts(pkg, root, checkpoints):
    snaps = pkg.snapshot.DirSnapshotStore(os.path.join(root, "snapshots"))
    return {cid: len(snaps._positions(cid)) for cid in checkpoints}


def sc_maintain_threaded(pkg, rec, root):
    kern = pkg.kernel.AgentKernel(workdir=root)
    try:
        h = kern.create_bus("tw", mode="spawn", image="parity-counter",
                            threaded=True, image_kw={"plans": _plans(4)},
                            trim_policy=pkg.kernel.TrimPolicy(
                                checkpoint_every=4))
        h.bus.append(pkg.entries.mail("go"))
        rec.see("idle", h.agent.wait_idle(timeout=DEADLINE_S))
        out = rec.see("maintain", kern.maintain("tw"))
        rec.see("threads running", bool(h.agent._threads) and all(
            t.is_alive() for t in h.agent._threads))
        rec.do("read below the base", h.bus.read, 0)
        h.agent.driver.planner.plans.extend(_plans(1))
        h.bus.append(pkg.entries.mail("more"))
        rec.see("idle again", h.agent.wait_idle(timeout=DEADLINE_S))
        rec.see("maintain again", kern.maintain("tw", force=True))
    finally:
        kern.shutdown()
    rec.see("n", h.agent.env["n"])
    rec.see("snapshots", _snapshot_counts(pkg, root, out["checkpoints"]))
    rec.see("bodies by type", _by_type(h.bus.read(h.bus.trim_base())))


def sc_trim_policy(pkg, rec, root):
    kern = pkg.kernel.AgentKernel(workdir=root)
    try:
        h = kern.create_bus("w", mode="spawn", image="parity-counter",
                            image_kw={"plans": _plans(6)},
                            trim_policy=pkg.kernel.TrimPolicy(
                                checkpoint_every=4, keep_snapshots=2))
        h.bus.append(pkg.entries.mail("go"))
        rec.see("early", kern.maintain("w"))
        _settle(kern, h, rec, "ticks")
        rec.see("log before the trim", h.bus.read(0))
        out = rec.see("maintain", kern.maintain("w"))
        rec.see("not due", kern.maintain("w"))
        rec.see("trim base", h.bus.trim_base())
        rec.do("read below the base", h.bus.read, 0)
        h.agent.driver.planner.plans.extend(_plans(1))
        h.bus.append(pkg.entries.mail("more"))
        _settle(kern, h, rec, "ticks after")
        rec.see("n", h.agent.env["n"])
        rec.see("maintain all", kern.maintain_all(force=True))
        rec.see("snapshots", _snapshot_counts(pkg, root,
                                              out["checkpoints"]))
        rec.see("log", h.bus.read(h.bus.trim_base()))
    finally:
        kern.shutdown()


LIFECYCLE = [sc_maintain_threaded, sc_trim_policy]


@pytest.mark.parametrize("scenario", LIFECYCLE,
                         ids=[sc.__name__[3:] for sc in LIFECYCLE])
def test_lifecycle_records_are_equal(tmp_path, scenario):
    want, got = _both(scenario, tmp_path)
    assert got == want
    out = got.get("maintain")
    assert out["maintained"] and out["trim_base"] > 0
    assert got.get("read below the base")[:2] == ("raised", "TrimmedError")
    assert all(n <= 2 for n in got.get("snapshots").values())
    if scenario is sc_maintain_threaded:
        assert got.get("threads running") and got.get("n") == 5
    else:
        assert got.get("n") == 7
        assert got.get("not due")["maintained"] is False


# ---------------------------------------------------------------------------
# the serving-continuous image, spawned on SQLite under a TrimPolicy
# ---------------------------------------------------------------------------

MAILS = [(f"req {i}", dict(prompt_tokens=p, req_id=f"r{i}", tenant=t))
         for i, (p, t) in enumerate([([7, 8, 9], "default"),
                                     ([11, 12], "evil"),
                                     ([13, 14, 15, 16], "default")])]


SIDES = {"jax": REF, "torch": PORT}


def _serve_spawned(tmp_path, setup, port_image="serving-continuous"):
    """Each package's kernel spawns its image on SQLite under a
    ``TrimPolicy``; ``_governed`` sets the engines, the voter and the
    denylist and runs both; then ``maintain(force=True)`` on each."""
    kernels, handles = {}, {}

    def spawn(side, kw):
        pkg = SIDES[side]
        image, image_kw = (("serving-continuous", kw) if pkg is REF
                           else (port_image, dict(kw, device="cpu")))
        kernels[side] = pkg.kernel.AgentKernel(
            workdir=str(tmp_path / side))
        handles[side] = kernels[side].create_bus(
            "serve", mode="spawn", backend="sqlite", image=image,
            image_kw=image_kw, trim_policy=pkg.kernel.TrimPolicy(
                checkpoint_every=8, keep_snapshots=2))
        return handles[side].agent

    try:
        with _clock(REF), _clock(PORT):
            runs = _governed(setup, {"tenant_denylist": ["evil"]}, MAILS,
                             spawn)
            out = []
            for side, (planner, types) in zip(SIDES, runs):
                bus = handles[side].bus
                out.append({
                    "bus": type(bus).__name__, "tokens": planner.outputs,
                    "rejected": sorted(planner.rejected), "types": types,
                    "pending": SIDES[side].recovery.committed_unexecuted(
                        bus),
                    "maintain": kernels[side].maintain("serve", force=True),
                    "trim base": bus.trim_base()})
    finally:
        for kern in kernels.values():
            kern.shutdown()
    return out


def test_serving_continuous_image_on_sqlite_under_a_trim_policy(tmp_path,
                                                                 setup):
    want, got = _serve_spawned(tmp_path, setup)
    assert got["bus"] == "SqliteBus"
    assert set(got["tokens"]) == {"r0", "r2"} and got["rejected"] == ["r1"]
    assert all(len(t) == 4 for t in got["tokens"].values())
    assert "ABORT" in got["types"] and got["pending"] == []
    assert got["maintain"]["maintained"] and got["trim base"] > 0
    assert got == want


def test_the_image_needs_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kern = PORT.kernel.AgentKernel()
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            kern.create_bus("s", mode="spawn", image="serving-continuous")
        h = kern.create_bus("c", mode="spawn", image="serving-continuous",
                            image_kw={"device": "cpu"})
        assert h.agent.executor.env.device.type == "cpu"
        assert h.agent.executor.env.cfg.n_layers == 2  # the smoke default
    finally:
        kern.shutdown()


# ---------------------------------------------------------------------------
# the swarm supervisor
# ---------------------------------------------------------------------------

def _worker(pkg, bus, ranges, fix_on_first=False):
    def work(args, env):
        lo, hi = args["work_range"]
        v = {"done": hi - lo}
        if fix_on_first and lo == ranges[0][0]:
            v["fix"] = {"issue": "missing CLI", "remedy": "pip install x"}
        return v
    plans = [{"intent": {"kind": "work", "args": {"work_range": list(r)}}}
             for r in ranges] + [{"done": True}]
    return pkg.agent.LogActAgent(bus=bus,
                                 planner=pkg.driver.ScriptPlanner(plans),
                                 env=None, handlers={"work": work})


def _view(rec, label, sup, view):
    rec.see(f"{label} known fixes", view["known_fixes"])
    rec.see(f"{label} claimed", view["claimed"])
    rec.see(f"{label} sent fixes", {n: sorted(s)
                                    for n, s in sup.sent_fixes.items()})
    rec.see(f"{label} mail sent", view["mail_sent"])
    rec.see(f"{label} saga failures", view["saga_failures"])
    rec.see(f"{label} summaries", view["summaries"])
    rec.see(f"{label} health", {n: (h["verdict"], h["reasons"])
                                for n, h in view["health"].items()})


def sc_supervisor_fixes(pkg, rec, root):
    E = pkg.entries
    buses = {f"w{i}": pkg.bus.MemoryBus() for i in range(3)}
    agents = {"w0": _worker(pkg, buses["w0"], [(0, 10), (10, 20)],
                            fix_on_first=True),
              "w1": _worker(pkg, buses["w1"], [(10, 20), (20, 30)]),
              "w2": _worker(pkg, buses["w2"], [(30, 40)])}
    sup = pkg.supervisor.Supervisor(buses)
    for a in agents.values():
        a.send_mail("go")
    for _ in range(60):
        for a in agents.values():
            a.tick()
    _view(rec, "first", sup, sup.sweep())
    _view(rec, "second", sup, sup.sweep())
    rec.see("mail", {n: [e.body for e in b.read(0)
                         if e.type.value == "Mail"]
                     for n, b in buses.items()})
    rec.do("commit", sup.clients["w0"].append, E.commit("i", "sup"))


def sc_supervisor_checkpoint(pkg, rec, root):
    E, T = pkg.entries, pkg.entries.PayloadType
    buses = {f"w{i}": pkg.bus.MemoryBus() for i in range(2)}
    agents = {"w0": _worker(pkg, buses["w0"], [(0, 10)], fix_on_first=True),
              "w1": _worker(pkg, buses["w1"], [(10, 20)])}
    sup = pkg.supervisor.Supervisor(buses)
    for a in agents.values():
        a.send_mail("go")
    for _ in range(40):
        for a in agents.values():
            a.tick()
    _view(rec, "sweep", sup, sup.sweep())
    store = pkg.snapshot.MemorySnapshotStore()
    rec.see("positions", sup.checkpoint(store))
    rec.see("checkpoints", {n: b.read(0, types=[T.CHECKPOINT])
                            for n, b in buses.items()})
    sup2 = pkg.supervisor.Supervisor(buses)
    rec.see("resumed", sup2.bootstrap(store))
    pkg.acl.BusClient(buses["w1"], "x1", "executor").append(E.result(
        "i-new", True, {"fix": {"issue": "flaky DNS",
                                "remedy": "retry with backoff"}}, "x1"))
    _view(rec, "successor", sup2, sup2.sweep())
    rec.see("fresh boot", pkg.supervisor.Supervisor(buses).bootstrap(
        pkg.snapshot.MemorySnapshotStore()))


SUPERVISOR = [sc_supervisor_fixes, sc_supervisor_checkpoint]


@pytest.mark.parametrize("scenario", SUPERVISOR,
                         ids=[sc.__name__[3:] for sc in SUPERVISOR])
def test_supervisor_records_are_equal(tmp_path, scenario):
    want, got = _both(scenario, tmp_path)
    assert got == want
    if scenario is sc_supervisor_fixes:
        assert "missing CLI" in got.get("first known fixes")
        assert all("missing CLI" in s
                   for s in got.get("first sent fixes").values())
        assert got.get("first claimed")["(10, 20)"] == "w0"
        assert got.get("commit")[:2] == ("raised", "AclError")
        assert any(m.get("dedup") for m in got.get("mail")["w1"])
    else:
        assert got.get("resumed") == got.get("positions")
        assert "flaky DNS" in got.get("successor known fixes")
        for name, cps in got.get("checkpoints").items():
            assert cps[-1][2]["component_id"] == f"supervisor@{name}"
            assert cps[-1][2]["position"] == got.get("positions")[name]


# ---------------------------------------------------------------------------
# broken controls
# ---------------------------------------------------------------------------

DROPPED = 3


@pytest.mark.parametrize("scenario", [sc_spawn, sc_trim_policy,
                                      sc_supervisor_fixes],
                         ids=["control_plane", "lifecycle", "supervisor"])
def test_a_bus_that_drops_an_entry_fails_the_comparison(tmp_path,
                                                        monkeypatch,
                                                        scenario):
    """A port ``MemoryBus`` whose ``read`` leaves out the entry at one
    position: the record must then differ from the reference's, where
    the unbroken port's is equal."""
    want = _run(scenario, REF, tmp_path / "ref")
    assert _run(scenario, PORT, tmp_path / "port") == want
    read = PORT.bus.MemoryBus.read
    monkeypatch.setattr(
        PORT.bus.MemoryBus, "read", lambda self, *a, **kw: [
            e for e in read(self, *a, **kw) if e.position != DROPPED])
    assert _run(scenario, PORT, tmp_path / "broken") != want


def _other_seed(setup):
    jcfg, tcfg, jparams, _ = setup
    other, _ = split_params(JaxModel(jcfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(1)))
    return (jcfg, tcfg, jparams,
            params_from_numpy(jax.tree.map(np.asarray, other), "cpu"))


@PORT.kernel.register_image("parity-serving-short")
def _short_image(**kw):
    """The ``serving-continuous`` image with one token fewer a request."""
    return server._image_serving_continuous(
        **dict(kw, max_new_tokens=kw["max_new_tokens"] - 1))


@pytest.mark.parametrize("broken", ["other_seed", "other_image"])
def test_a_broken_serving_side_fails_the_comparison(tmp_path, setup,
                                                    broken):
    if broken == "other_seed":
        want, got = _serve_spawned(tmp_path, _other_seed(setup))
    else:
        want, got = _serve_spawned(tmp_path, setup,
                                   port_image="parity-serving-short")
        assert all(len(t) == 3 for t in got["tokens"].values())
    assert got["rejected"] == want["rejected"] == ["r1"]
    assert got["tokens"] != want["tokens"]
    assert got != want
    assert "parity-serving-short" not in REF.kernel.AGENT_IMAGES
    assert PORT.kernel.AGENT_IMAGES["serving-continuous"] is \
        server._image_serving_continuous
