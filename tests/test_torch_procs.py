"""The port's components as OS processes against the reference's, on the
CPU.

``repro_torch/launch/procs.py`` is the reference's ``launch/procs.py`` with
every whole-word ``repro`` read as ``repro_torch`` and one comment
corrected (``test_torch_core_copies.py``). Here the reference's process
failover scenario (``tests/test_netbus.py:277-342``) runs through
``chip_smoke.py``'s ``process_failover``, the drill that slice 12c runs on
the card: a bus-server process over SQLite, executor, voters, standby and
driver processes, the ``first_voter`` policy and the ``go`` mail, the
driver SIGKILLed after two results. Its record (InfOut count, intent ids,
results, elections) must be what the reference's test asserts
(``process_failover_want``), and the port's must equal the reference's.

* Each package's own ``procs`` for every role.
* Across packages: the port's four components against the reference's
  server process; and one lineage across packages, the reference's driver
  killed mid-plan and the port's standby taking it over from the same
  ``DirSnapshotStore`` (JSON).
* A broken control: a standby of another driver id takes a fresh lineage,
  so the intent ids and the InfOut count differ from the reference's.
* Units: ``incr_plans``, ``main``'s parsing of ``--role`` and ``--spec``,
  ``_child_env``, the argv of ``spawn_component`` and
  ``BusServerProcess``, and a server that dies before it binds.

Every child is killed and waited for in a ``finally``, every wait is on
the log up to a deadline, and after each test no thread it started may be
alive, no socket it opened may be listening and no child it started may be
left (the autouse fixtures).
"""
import contextlib
import importlib.util
import os
from pathlib import Path
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

from repro.launch import procs as ref_procs  # noqa: E402
from repro_torch.launch import procs as port_procs  # noqa: E402

from _torch_core_parity import PORT, REF  # noqa: E402
from test_torch_netbus import _nothing_left_behind  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
ROLES = ("server", "executor", "voters", "standby", "driver")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()


def _children():
    """The pids of this process's children, from every thread's
    ``/proc/self/task/<tid>/children``."""
    pids = set()
    for task in os.listdir("/proc/self/task"):
        with contextlib.suppress(OSError), \
                open(f"/proc/self/task/{task}/children") as f:
            pids.update(f.read().split())
    return pids


@pytest.fixture(autouse=True)
def _no_child_left():
    before = _children()
    yield
    assert _children() <= before


def _core(pkg):
    return SimpleNamespace(acl=pkg.acl, entries=pkg.entries,
                           netbus=pkg.netbus)


def _drill(tmp_path, client, standby_id=cs.PROC_DRIVER_ID, **by_role):
    """``process_failover`` with ``by_role[role]`` (a ``procs`` module)
    for each role, and ``client``'s ``core`` for the test's client."""
    rec, times = cs.process_failover(str(tmp_path), by_role, _core(client),
                                     standby_id=standby_id)
    assert times["kill_to_election_s"] > 0
    assert times["election_to_done_s"] > 0
    return rec


def _all(mod):
    return {r: mod for r in ROLES}


@pytest.fixture(scope="module")
def ref_record(tmp_path_factory):
    return _drill(tmp_path_factory.mktemp("ref"), REF, **_all(ref_procs))


def test_reference_drill_says_what_its_test_asserts(ref_record):
    assert ref_record == cs.process_failover_want()


def test_port_drill_equals_the_reference(tmp_path, ref_record):
    got = _drill(tmp_path, PORT, **_all(port_procs))
    assert got == cs.process_failover_want()
    assert got == ref_record


def test_port_components_on_a_reference_server(tmp_path, ref_record):
    got = _drill(tmp_path, PORT, **dict(_all(port_procs), server=ref_procs))
    assert got == ref_record


def test_port_standby_takes_over_a_reference_driver(tmp_path, ref_record):
    """One lineage across packages: the reference's driver checkpoints to
    the ``DirSnapshotStore`` and is killed; the port's standby restores
    from it and finishes the plan."""
    got = _drill(tmp_path, PORT, **dict(_all(port_procs), driver=ref_procs))
    assert got == ref_record
    snaps = tmp_path / "snaps"
    assert any(snaps.rglob("*")), "the lineage left no snapshot"


def test_a_standby_of_another_lineage_fails_the_comparison(tmp_path,
                                                           ref_record):
    """A standby with another driver id takes a fresh lineage: it elects
    itself and runs the plan from its first step, so the intent ids and
    the InfOut count are not the reference's."""
    got = _drill(tmp_path, PORT, standby_id="driver-other",
                 **_all(port_procs))
    want = cs.process_failover_want()
    assert got != ref_record
    assert got["intent ids"] != want["intent ids"]
    assert got["infouts"] != want["infouts"]
    assert got["intent ids"][-cs.PROC_STEPS:] == [
        f"driver-other-i{i}" for i in range(cs.PROC_STEPS)]
    assert got["elected"] == [cs.PROC_DRIVER_ID, "driver-other"]


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,work_s", [(6, 0.2), (0, 0.0), (3, 1.5)])
def test_incr_plans_are_equal(n, work_s):
    assert port_procs.incr_plans(n, work_s) == ref_procs.incr_plans(n,
                                                                    work_s)


@pytest.mark.parametrize("argv", [
    ["--role", "driver", "--address", "127.0.0.1:1",
     "--spec", '{"driver_id": "d", "plans": []}'],
    ["--role", "voters", "--address", "h:2"],
    ["--role", "standby", "--address", "h:3", "--spec",
     '{"takeover_after_s": 0.5, "nested": {"k": [1, 2]}}']],
    ids=["driver", "voters-default-spec", "standby"])
def test_main_parses_role_and_spec_as_the_reference(monkeypatch, argv):
    seen = {}
    for name, mod in (("ref", ref_procs), ("port", port_procs)):
        calls = seen.setdefault(name, [])
        for role in mod.ROLE_LOOPS:
            monkeypatch.setitem(
                mod.ROLE_LOOPS, role,
                lambda address, spec, role=role, calls=calls:
                    calls.append((role, address, spec)))
        mod.main(list(argv))
    assert seen["port"] == seen["ref"] and len(seen["port"]) == 1


@pytest.mark.parametrize("argv", [["--role", "nobody", "--address", "h:1"],
                                  ["--address", "h:1"]],
                         ids=["unknown-role", "no-role"])
def test_main_refuses_as_the_reference(argv, capsys):
    codes = []
    for mod in (ref_procs, port_procs):
        with pytest.raises(SystemExit) as exc:
            mod.main(list(argv))
        codes.append(exc.value.code)
    assert codes == [2, 2]


def test_child_env_puts_the_port_src_first(monkeypatch):
    monkeypatch.setenv("PYTHONPATH", "/elsewhere")
    env = port_procs._child_env()
    parts = env["PYTHONPATH"].split(os.pathsep)
    assert parts[0] == str(ROOT / "src") and "/elsewhere" in parts
    assert (Path(parts[0]) / "repro_torch" / "launch" / "procs.py").exists()
    assert env == ref_procs._child_env()


class _FakePopen:
    def __init__(self, argv, env=None):
        self.argv, self.env = argv, env

    def poll(self):
        return 0


@pytest.mark.parametrize("mod,pkg", [(ref_procs, "repro"),
                                     (port_procs, "repro_torch")],
                         ids=["reference", "port"])
def test_spawned_argv_names_the_package(monkeypatch, tmp_path, mod, pkg):
    monkeypatch.setattr(mod.subprocess, "Popen", _FakePopen)
    child = mod.spawn_component("executor", "h:1", {"a": 1})
    assert child.argv[1:] == ["-m", f"{pkg}.launch.procs", "--role",
                              "executor", "--address", "h:1", "--spec",
                              '{"a": 1}']
    server = mod.BusServerProcess("sqlite", str(tmp_path / "b.db"),
                                  str(tmp_path))
    assert server.proc.argv[1:] == [
        "-m", f"{pkg}.launch.bus_server", "--backend", "sqlite", "--path",
        str(tmp_path / "b.db"), "--port", "0", "--port-file",
        str(tmp_path / "bus.port")]
    assert server.proc.env["PYTHONPATH"].startswith(str(ROOT / "src"))


@pytest.mark.parametrize("mod", [ref_procs, port_procs],
                         ids=["reference", "port"])
def test_a_server_that_dies_before_binding_raises(tmp_path, mod):
    srv = mod.BusServerProcess("no-such-backend", str(tmp_path / "b.db"),
                               str(tmp_path))
    try:
        with pytest.raises(RuntimeError, match="died before binding"):
            srv.address
    finally:
        srv.kill()
        srv.proc.wait(timeout=20.0)
