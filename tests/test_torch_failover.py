"""The port's automatic failover (``core/failover.py``: ``StandbyExecutor``,
``ElasticWorkerPool``) against the reference's, on the CPU.

``core/failover.py`` is the reference's file byte for byte
(``test_torch_core_copies.py``); here the four scenarios of
``tests/test_failover.py`` and a fifth on the serving path run once per
package, and the port's record must equal the reference's.

* The two training scenarios (standby takeover after an executor crash,
  ``:22``; a standby that stays passive on a healthy log, ``:52``) run on
  ``tests/_torch_trainer_parity.py``: both sides start from the
  reference's initial parameters (smoke ``qwen3_4b``, and smoke
  ``chatglm3_6b`` for the passive one, as the reference's test). The
  record keeps each intent's kind, args, decision and result, ``env.step``,
  the data cursor, ``takeover_reason``, whether the standby is active and
  what a second standby's ``check`` says of the recovered log (it still
  names the crashed chunk, which never gets a Result); losses are
  compared to ``LOSS_RTOL`` (rtol = 1e-4), everything else exactly.
  Entry timestamps and drawn ids come from ``_torch_core_parity._clock``'s
  counters, so the takeover reason (an intent id and an age) repeats, and
  the standby's clock is a fixed time past them.
* The elastic pool (``:80``) and the cross-agent mailbox (``:97``) run on
  ``tests/_torch_core_parity.py`` as ``scenario(pkg, rec, root)``. The
  flaky worker is an image of this file's own name in each package's
  registry.
* The pool over the ``serving-continuous`` image: two workers spawned by
  each package's ``ElasticWorkerPool`` (the port's on ``device="cpu"``),
  each run through ``test_torch_serving._governed`` (both engines on one
  carried-over parameter tree, the admission voter, a denylisted
  tenant). Worker 1's executor gets, in a copy of its handler dict, a
  ``serve_step`` that raises; the sweep must replace it, and the
  replacement serves worker 1's requests with the tokens a healthy
  worker 1 gives.
* Broken controls: a standby whose clock has not passed
  ``takeover_timeout`` (no takeover, ``env.step`` stays 6); the port's
  takeover executor built with ``announce_reboot=False`` (its record must
  differ from the reference's); a sweep with no failing worker (nothing
  replaced).

No thread is started here: the kernels tick their agents synchronously,
and every kernel is shut down in a ``finally``. No hypothesis.
"""
import pytest

torch = pytest.importorskip("torch")

import _torch_trainer_parity as parity  # noqa: E402
from _torch_core_parity import PORT, REF, _both, _clock  # noqa: E402
from test_torch_serving import _governed, setup  # noqa: E402,F401

torch.set_num_threads(1)

# the entry timestamps under _clock start here; a standby whose clock reads
# FUTURE sees every entry of these short runs as older than its timeout
T0 = 1.7e9
FUTURE = T0 + 1000.0
TAKEOVER_TIMEOUT = 5.0


def _pkg(side):
    return REF if side.name == "jax" else PORT


# ---------------------------------------------------------------------------
# training: a standby takes over after a crash; stays passive when healthy
# ---------------------------------------------------------------------------

def _takeover(side, tmpdir, clock=None):
    """tests/test_failover.py::test_standby_takes_over_after_crash.
    ``clock(bus)`` gives the standby's clock (FUTURE by default)."""
    with _clock(_pkg(side)):
        env = side.env(tmpdir, dict(lr=1e-3, warmup_steps=1,
                                    total_steps=8))
        bus = side.MemoryBus()
        agent = side.build_training_agent(env, total_steps=8,
                                          steps_per_intention=4,
                                          ckpt_every=100, bus=bus)
        env.crash_after_steps = 6
        agent.send_mail("train")
        with pytest.raises(side.InjectedCrash):
            agent.run_until_idle(max_rounds=10000)
        crashed_at = env.step
        standby = side.StandbyExecutor(
            bus, env, side.handlers, takeover_timeout=TAKEOVER_TIMEOUT,
            clock=clock(bus) if clock else (lambda: FUTURE))
        first_check = standby.check()
        agent.executor = standby
        try:
            agent.run_until_idle(max_rounds=10000)
            ran = "idle"
        except RuntimeError as exc:  # the record holds it
            ran = f"raised {exc}"
        # a second standby on the recovered log: the crashed chunk's
        # intent never gets a Result (the probe and a new chunk supersede
        # it), so its check still names it
        fresh = side.StandbyExecutor(
            bus, env, side.handlers, takeover_timeout=TAKEOVER_TIMEOUT,
            clock=lambda: FUTURE).check()
    out = parity.record(side, bus, env)
    out.update(crashed_at=crashed_at, first_check=first_check, ran=ran,
               takeover_reason=standby.takeover_reason,
               active=standby.active is not None, fresh_check=fresh)
    return out


def test_standby_takeover_matches_reference(tmp_path):
    want = _takeover(parity.Side("jax"), str(tmp_path / "j"))
    got = _takeover(parity.Side("torch"), str(tmp_path / "t"))
    parity.same(got, want)
    assert got["crashed_at"] == 6 and got["step"] == 8 and got["active"]
    assert "no result" in got["takeover_reason"]
    assert got["first_check"] == got["takeover_reason"]
    assert got["fresh_check"] == got["takeover_reason"]
    kinds = [t["kind"] for t in got["trace"]]
    assert kinds == ["train_chunk", "train_chunk", "probe_state",
                     "train_chunk", "eval"]
    # the reason names the pending chunk: the second, with no result
    assert got["trace"][1]["ok"] is None
    assert got["trace"][1]["args"]["data_start"] == 4


def _passive(side, tmpdir):
    """tests/test_failover.py::test_standby_stays_passive_when_healthy
    (the standby on the real clock, as there)."""
    with _clock(_pkg(side)):
        env = side.env(tmpdir, dict(lr=1e-3, warmup_steps=1,
                                    total_steps=4), arch="chatglm3_6b")
        bus = side.MemoryBus()
        agent = side.build_training_agent(env, total_steps=4,
                                          steps_per_intention=4,
                                          ckpt_every=100, bus=bus)
        standby = side.StandbyExecutor(bus, env, side.handlers,
                                       takeover_timeout=60)
        agent.send_mail("train")
        agent.run_until_idle(max_rounds=10000)
        took = standby.maybe_take_over()
    out = parity.record(side, bus, env)
    out.update(took=took, takeover_reason=standby.takeover_reason,
               active=standby.active is not None)
    return out


def test_standby_passive_matches_reference(tmp_path):
    want = _passive(parity.Side("jax"), str(tmp_path / "j"))
    got = _passive(parity.Side("torch"), str(tmp_path / "t"))
    parity.same(got, want)
    assert got["step"] == 4 and not got["took"] and not got["active"]
    assert got["takeover_reason"] is None
    assert [t["kind"] for t in got["trace"]] == ["train_chunk", "eval"]


@pytest.mark.parametrize("name", ["jax", "torch"])
def test_a_standby_inside_its_timeout_does_not_take_over(tmp_path, name):
    """Broken control: the standby's clock one second past the last entry,
    so the pending chunk is younger than ``takeover_timeout``."""
    def just_after(bus):
        last = bus.read(0)[-1].realtime_ts
        return lambda: last + 1.0
    side = parity.Side(name)
    out = _takeover(side, str(tmp_path), clock=just_after)
    assert out["first_check"] is None
    assert not out["active"] and out["takeover_reason"] is None
    assert out["crashed_at"] == 6 and out["step"] == 6


def test_a_takeover_without_the_reboot_announcement_differs(tmp_path,
                                                            monkeypatch):
    """Broken control: the port's standby boots its executor with
    ``announce_reboot=False``, so no recovered Result fences the old
    executor and no probe follows; the record must differ."""
    want = _takeover(parity.Side("jax"), str(tmp_path / "j"))
    real = PORT.failover.Executor

    def unannounced(*args, **kw):
        return real(*args, **dict(kw, announce_reboot=False))
    monkeypatch.setattr(PORT.failover, "Executor", unannounced)
    got = _takeover(parity.Side("torch"), str(tmp_path / "t"))
    assert got["active"]
    assert "probe_state" not in [t["kind"] for t in got["trace"]]
    with pytest.raises(AssertionError):
        parity.same(got, want)


# ---------------------------------------------------------------------------
# the elastic pool and the cross-agent mailbox
# ---------------------------------------------------------------------------

def _flaky_image(pkg):
    def image(bus, snapshot_store=None, fail=False, **kw):
        def work(args, e):
            if fail:
                raise RuntimeError("bad node")
            return {"done": 1}
        plans = [{"intent": {"kind": "work", "args": {}}}] * 3 \
            + [{"done": True}]
        return pkg.agent.LogActAgent(
            bus=bus, planner=pkg.driver.ScriptPlanner(plans), env={},
            handlers={"work": work})
    return image


for _p in (REF, PORT):
    _p.kernel.register_image("parity-flaky-worker")(_flaky_image(_p))


def _traces(pkg, bus):
    """Each intent's kind, args, decision and result; a failed result
    without its traceback, whose paths name the package."""
    out = []
    for t in pkg.introspect.trace_intents(bus.read(0)):
        res = t.result
        if res is not None:
            res = dict(res, value={k: v for k, v in
                                   (res.get("value") or {}).items()
                                   if k != "traceback"})
        out.append((t.intent_id, t.kind, t.args, t.decision, res))
    return out


def sc_elastic_pool(pkg, rec, root, failing=1):
    """tests/test_failover.py::test_elastic_pool_replaces_failing_worker;
    worker ``failing`` raises in every handler (None: no worker does)."""
    kern = pkg.kernel.AgentKernel()
    try:
        pool = pkg.failover.ElasticWorkerPool(
            kern, image="parity-flaky-worker",
            image_kw_fn=lambda i: {"fail": i == failing})
        pool.scale_to(3)
        for name in kern.list_buses():
            kern.get(name).bus.append(pkg.entries.mail("go"))
        rec.see("ticks", [kern.tick_all() for _ in range(60)])
        rec.see("sweep", pool.sweep())
        rec.see("replaced", dict(pool.replaced))
        rec.see("generation", pool.generation)
        rec.see("buses", kern.list_buses())
        for name in kern.list_buses():
            h = kern.get(name)
            rec.see(f"{name} env", h.agent.executor.env)
            rec.see(f"{name} traces", _traces(pkg, h.bus))
        pool.scale_to(3)
        rec.see("buses after scale_to(3)", kern.list_buses())
        rec.see("second sweep", pool.sweep())
    finally:
        kern.shutdown()


def sc_mailbox(pkg, rec, root):
    """tests/test_failover.py::test_cross_agent_mailbox_coordination: the
    orchestrator's executor mails a task to the worker's bus."""
    E = pkg.entries
    worker_bus = pkg.bus.MemoryBus()

    class Delegated(pkg.driver.ScriptPlanner):
        """Turns incoming task mail into a work intent."""

        def __init__(self):
            super().__init__([])

        def propose(self, context):
            for m in context.get("mail", []):
                if "task" in m:
                    return {"intent": {"kind": "work", "args": {
                        "payload": m["task"]["payload"]}}}
            return {"done": True}

    def w_work(args, e):
        e["did"] = args["payload"]
        return {"done": True}

    def delegate(args, env):
        pkg.acl.BusClient(worker_bus, "orch-executor", "executor").append(
            E.mail("do the thing", sender="orchestrator",
                   task={"payload": args["payload"]}))
        return {"delegated": True}

    worker = pkg.agent.LogActAgent(bus=worker_bus, planner=Delegated(),
                                   env={}, handlers={"work": w_work},
                                   agent_id="worker")
    orch = pkg.agent.LogActAgent(
        bus=pkg.bus.MemoryBus(),
        planner=pkg.driver.ScriptPlanner([
            {"intent": {"kind": "delegate", "args": {"payload": 42}}},
            {"done": True}]),
        env={}, handlers={"delegate": delegate}, agent_id="orch")
    orch.send_mail("delegate the work")
    orch.run_until_idle(max_rounds=1000)
    rec.see("worker log before", worker_bus.read(0))
    worker.run_until_idle(max_rounds=1000)
    rec.see("worker env", worker.executor.env)
    rec.see("orch traces", _traces(pkg, orch.bus))
    rec.see("worker traces", _traces(pkg, worker_bus))
    rec.see("worker log", worker_bus.read(0))


def test_elastic_pool_records_are_equal(tmp_path):
    want, got = _both(sc_elastic_pool, tmp_path)
    assert got == want
    sweep = got.get("sweep")
    replaced = [k for k, v in sweep.items() if v.startswith("replaced_by")]
    assert replaced == ["worker-0-1"]
    assert sweep["worker-0-1"] == "replaced_by:worker-1-r0 (failing)"
    assert got.get("replaced") == {"worker-0-1": "worker-1-r0"}
    assert got.get("generation") == 1
    assert "worker-1-r0" in got.get("buses")
    assert all(not r[4]["ok"] for r in got.get("worker-0-1 traces"))
    assert got.get("buses after scale_to(3)") == got.get("buses")
    assert "worker-0-1" not in got.get("second sweep")


def test_a_pool_with_no_failing_worker_replaces_nothing(tmp_path):
    """Broken control: the failing worker made healthy."""
    want, got = _both(sc_elastic_pool, tmp_path, None)
    assert got == want
    assert not any(v.startswith("replaced_by")
                   for v in got.get("sweep").values())
    assert got.get("replaced") == {} and got.get("generation") == 0
    assert got.get("buses") == ["worker-0-0", "worker-0-1", "worker-0-2"]


def test_mailbox_records_are_equal(tmp_path):
    want, got = _both(sc_mailbox, tmp_path)
    assert got == want
    assert got.get("worker env") == {"did": 42}
    (_, kind, args, decision, res), = got.get("worker traces")
    assert (kind, args, decision, res["ok"]) == ("work", {"payload": 42},
                                                 "commit", True)


# ---------------------------------------------------------------------------
# the pool over the serving-continuous image
# ---------------------------------------------------------------------------

SIDES = {"jax": REF, "torch": PORT}
POLICY = {"tenant_denylist": ["evil"]}
# each worker's requests: worker 0 serves r0 and rejects r1's tenant
POOL_MAILS = [
    [("req 0", dict(prompt_tokens=[7, 8, 9], req_id="r0")),
     ("req 1", dict(prompt_tokens=[11, 12], req_id="r1", tenant="evil"))],
    [("req 2", dict(prompt_tokens=[13, 14, 15, 16], req_id="r2")),
     ("req 3", dict(prompt_tokens=[5, 17, 99, 3, 42], req_id="r3"))]]


def _bad_node(args, env):
    raise RuntimeError("bad node")


def _serve_pool(setup, fail):
    """Each package's pool spawns two serving workers; each is run through
    ``_governed`` on its requests (worker 1, if ``fail``, with a
    ``serve_step`` that raises); a sweep; then, if a worker was replaced,
    the replacement serves worker 1's requests. Returns the reference's
    record and the port's."""
    kernels, pools = {}, {}
    out = {side: {} for side in SIDES}

    def spawn_as(pick):
        def spawn(side, kw):
            pkg = SIDES[side]
            if side not in pools:
                image_kw = kw if pkg is REF else dict(kw, device="cpu")
                kernels[side] = pkg.kernel.AgentKernel()
                pools[side] = pkg.failover.ElasticWorkerPool(
                    kernels[side], "serving-continuous",
                    image_kw_fn=lambda i: dict(image_kw))
                pools[side].scale_to(2)
            name = pick(pools[side])
            agent = kernels[side].get(name).agent
            if fail and name == "worker-0-1":
                agent.executor.handlers = dict(agent.executor.handlers,
                                               serve_step=_bad_node)
            return agent
        return spawn

    def served(label, runs):
        for side, (planner, types) in zip(SIDES, runs):
            out[side][label] = {"tokens": planner.outputs,
                                "rejected": sorted(planner.rejected),
                                "types": types}

    try:
        with _clock(REF), _clock(PORT):
            for i, mails in enumerate(POOL_MAILS):
                served(f"worker {i}", _governed(
                    setup, POLICY, mails,
                    spawn_as(lambda pool, i=i: f"worker-0-{i}")))
            for side in SIDES:
                pool = pools[side]
                out[side]["sweep"] = pool.sweep()
                out[side]["replaced"] = dict(pool.replaced)
                out[side]["generation"] = pool.generation
                out[side]["buses"] = kernels[side].list_buses()
                out[side]["worker 1 traces"] = _traces(
                    SIDES[side], kernels[side].get("worker-0-1").bus)
            if fail:
                served("replacement", _governed(
                    setup, POLICY, POOL_MAILS[1],
                    spawn_as(lambda pool: pool.replaced["worker-0-1"])))
    finally:
        for kern in kernels.values():
            kern.shutdown()
    return out["jax"], out["torch"]


@pytest.fixture(scope="module")
def pool_runs(setup):
    return {fail: _serve_pool(setup, fail) for fail in (True, False)}


def test_serving_pool_replaces_the_failing_worker(pool_runs):
    want, got = pool_runs[True]
    assert got == want
    assert set(got["worker 0"]["tokens"]) == {"r0"}
    assert got["worker 0"]["rejected"] == ["r1"]
    assert got["worker 1"]["tokens"] == {}
    assert got["worker 1"]["rejected"] == ["r2", "r3"]
    assert all(not t[4]["ok"] and "bad node" in t[4]["value"]["error"]
               for t in got["worker 1 traces"] if t[3] == "commit")
    assert got["sweep"]["worker-0-1"] == "replaced_by:worker-1-r0 (failing)"
    assert not got["sweep"]["worker-0-0"].startswith("replaced_by")
    assert got["replaced"] == {"worker-0-1": "worker-1-r0"}
    assert got["buses"] == ["worker-0-0", "worker-0-1", "worker-1-r0"]
    # the replacement serves worker 1's requests as a healthy worker 1
    repl = got["replacement"]
    assert set(repl["tokens"]) == {"r2", "r3"} and repl["rejected"] == []
    assert all(len(t) == 4 for t in repl["tokens"].values())
    assert repl["tokens"] == pool_runs[False][1]["worker 1"]["tokens"]


def test_a_serving_pool_with_no_failing_worker_replaces_nothing(pool_runs):
    """Broken control: worker 1 keeps its own ``serve_step``."""
    want, got = pool_runs[False]
    assert got == want
    assert not any(v.startswith("replaced_by")
                   for v in got["sweep"].values())
    assert got["replaced"] == {} and got["generation"] == 0
    assert set(got["worker 1"]["tokens"]) == {"r2", "r3"}
