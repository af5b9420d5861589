"""Process harness: run LogAct components as separate OS processes.

This is where the paper's deployment claim stops being simulated
(§3: "these deconstructed components can be collocated, or isolated on
different physical processes or machines"): each role below is a real OS
process holding only a ``NetBus`` connection to one ``bus_server``. No
shared memory, no shared Python state — the log is the only channel, so
SIGKILL of any component is survivable by construction.

Roles (CLI ``--role``):

* ``driver``   — a ``Driver`` with a scripted plan; checkpoints to a shared
                 ``DirSnapshotStore`` after every new intent so a standby
                 can resume mid-plan.
* ``standby``  — a passive watcher sharing the primary's ``driver_id``
                 (same lineage: replay harvest and snapshots transfer).
                 It takes over when the log quiesces mid-plan (tail
                 unchanged for ``takeover_after_s`` while no ``done``
                 InfOut exists): it bootstraps from the snapshot store,
                 clears the restored ``elected`` flag so its first action
                 is a fresh election at ``epoch + 1`` (§3.2: a booting
                 Driver always re-fences), replays the logged
                 InfOut/Intent suffix silently, and continues the plan.
* ``voters``   — a ``RuleVoter`` + ``Decider`` pair (separate bus
                 credentials, one connection).
* ``executor`` — an ``Executor`` with the demo ``PROC_HANDLERS``.

Each run loop is: play what's available, then block on ``bus.wait`` —
which on NetBus parks on server-pushed append notifications, so an idle
trio burns no CPU and no request traffic.

The test/bench helpers at the bottom (``BusServerProcess``,
``spawn_component``) launch the CLI entrypoints as ``subprocess.Popen``
children with ``PYTHONPATH`` wired up, and are used by
``tests/test_netbus.py`` and ``benchmarks/bench_netbus.py``.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

import repro_torch
from repro_torch.core import entries as E
from repro_torch.core.acl import BusClient
from repro_torch.core.decider import Decider
from repro_torch.core.driver import Driver, Planner
from repro_torch.core.entries import PayloadType
from repro_torch.core.executor import Executor
from repro_torch.core.netbus import NetBus
from repro_torch.core.snapshot import DirSnapshotStore
from repro_torch.core.voter import RuleVoter


class _LineagePlanner(Planner):
    """Scripted planner indexed by the *driver's* inference count, not an
    internal counter. During recovery the Driver replays logged InfOuts
    WITHOUT calling ``propose`` (deterministic replay, §3.2), so a planner
    with its own index — like ``ScriptPlanner`` — would be left at 0 and
    re-propose the first step after a takeover. Reading
    ``driver.n_inferences`` at propose time keeps the script aligned with
    the lineage no matter how many steps were replayed rather than
    proposed (``n_inferences`` is incremented *after* the propose that
    produces output #n, so it is exactly the index of the plan to emit)."""

    def __init__(self, plans: List[Dict[str, Any]]):
        self.plans = list(plans)
        self.driver: Optional[Driver] = None  # set after Driver construction

    def propose(self, context: Dict[str, Any]) -> Dict[str, Any]:
        i = self.driver.n_inferences if self.driver is not None else 0
        if i >= len(self.plans):
            return {"done": True, "note": "script exhausted"}
        return self.plans[i]


#: Demo executor handlers for the process harness. ``incr`` models a slow
#: side-effecting step: it sleeps ``work_s`` then bumps a counter in the
#: executor's env.
def _incr(args: Dict[str, Any], env: Dict[str, Any]) -> Dict[str, Any]:
    time.sleep(float(args.get("work_s", 0.0)))
    env["n"] = env.get("n", 0) + 1
    return {"value": env["n"], "step": args.get("step")}


PROC_HANDLERS = {"incr": _incr}


def incr_plans(n: int, work_s: float = 0.2) -> List[Dict[str, Any]]:
    """A scripted plan of ``n`` sequential incr intents, then done."""
    plans: List[Dict[str, Any]] = [
        {"intent": {"kind": "incr",
                    "args": {"step": i, "work_s": work_s}}}
        for i in range(n)]
    plans.append({"done": True, "note": "plan complete"})
    return plans


# ---------------------------------------------------------------------------
# Role run loops
# ---------------------------------------------------------------------------

def _drive(drv: Driver, bus: NetBus, snaps: DirSnapshotStore) -> None:
    """Primary/post-takeover driver loop: play, checkpoint after every new
    intent (so a standby can always resume mid-plan), park on push wakes."""
    last_ckpt_intents = -1
    while True:
        played = drv.play_available()
        if drv.n_intents != last_ckpt_intents:
            drv.checkpoint(snaps)
            last_ckpt_intents = drv.n_intents
        if played == 0:
            bus.wait(bus.tail(), timeout=0.5)


def run_driver(address: str, spec: Dict[str, Any]) -> None:
    driver_id = spec["driver_id"]
    bus = NetBus(address, client_id=f"proc-{driver_id}", role="driver")
    planner = _LineagePlanner(spec["plans"])
    drv = Driver(BusClient(bus, driver_id, "driver"), planner,
                 driver_id=driver_id)
    planner.driver = drv
    snaps = DirSnapshotStore(spec["snapshot_dir"])
    drv.bootstrap(snaps)
    _drive(drv, bus, snaps)


def _plan_done(bus: NetBus, driver_id: str) -> bool:
    """True once this lineage has logged a ``done`` InfOut (the plan's
    terminal inference) — a quiet log after that is finished, not stuck."""
    for e in bus.read(bus.trim_base(), types=(PayloadType.INF_OUT,)):
        if (e.body.get("driver_id") == driver_id
                and e.body.get("plan", {}).get("done")):
            return True
    return False


def run_standby(address: str, spec: Dict[str, Any]) -> None:
    driver_id = spec["driver_id"]
    takeover_after = float(spec.get("takeover_after_s", 2.0))
    bus = NetBus(address, client_id=f"proc-standby-{driver_id}",
                 role="driver")
    last_tail = bus.tail()
    last_change = time.monotonic()
    while True:
        bus.wait(last_tail, timeout=0.25)
        t = bus.tail()
        now = time.monotonic()
        if t != last_tail:
            last_tail, last_change = t, now
            continue
        if now - last_change < takeover_after:
            continue
        if _plan_done(bus, driver_id):
            last_change = now  # finished, not stuck: stay passive
            continue
        break  # mid-plan quiescence: the primary is gone — take over
    planner = _LineagePlanner(spec["plans"])
    drv = Driver(BusClient(bus, driver_id, "driver"), planner,
                 driver_id=driver_id)
    planner.driver = drv
    snaps = DirSnapshotStore(spec["snapshot_dir"])
    drv.bootstrap(snaps)
    # The restored snapshot says elected=True — that was the DEAD primary's
    # election. A booting Driver's first action is re-election at epoch+1
    # (§3.2); same driver_id, so the lineage is not self-fenced and the
    # logged InfOut/Intent harvest replays instead of re-proposing.
    drv._elected = False
    _drive(drv, bus, snaps)


def run_voters(address: str, spec: Dict[str, Any]) -> None:
    bus = NetBus(address, client_id="proc-voters")
    voter = RuleVoter(BusClient(bus, "voter-rule", "voter"),
                      voter_id="voter-rule")
    decider = Decider(BusClient(bus, "decider-main", "decider"),
                      decider_id="decider-main")
    while True:
        played = voter.play_available() + decider.play_available()
        if played == 0:
            bus.wait(bus.tail(), timeout=0.5)


def run_executor(address: str, spec: Dict[str, Any]) -> None:
    bus = NetBus(address, client_id="proc-executor", role="executor")
    ex = Executor(BusClient(bus, "executor-main", "executor"),
                  env={}, handlers=PROC_HANDLERS,
                  executor_id="executor-main")
    while True:
        if ex.play_available() == 0:
            bus.wait(bus.tail(), timeout=0.5)


ROLE_LOOPS = {"driver": run_driver, "standby": run_standby,
              "voters": run_voters, "executor": run_executor}


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="LogAct component process")
    ap.add_argument("--role", required=True, choices=sorted(ROLE_LOOPS))
    ap.add_argument("--address", required=True, help="bus server host:port")
    ap.add_argument("--spec", default="{}", help="JSON role parameters")
    args = ap.parse_args(argv)
    ROLE_LOOPS[args.role](args.address, json.loads(args.spec))


# ---------------------------------------------------------------------------
# Subprocess helpers (tests / benchmarks)
# ---------------------------------------------------------------------------

def _child_env() -> Dict[str, str]:
    """Environment for child processes: prepend the repo's src dir so
    ``python -m repro_torch...`` resolves regardless of the parent's cwd."""
    # __path__ names the package directory whether or not the package
    # has an __init__.py (repro_torch has one).
    pkg_dir = os.path.abspath(list(repro_torch.__path__)[0])
    src = os.path.dirname(pkg_dir)
    env = dict(os.environ)
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    return env


class BusServerProcess:
    """Run ``repro_torch.launch.bus_server`` as a child process; context-managed.

    The server binds an ephemeral port and publishes it via ``--port-file``;
    ``address`` blocks until the file appears.
    """

    def __init__(self, backend: str, path: str, workdir: str) -> None:
        self._port_file = os.path.join(workdir, "bus.port")
        if os.path.exists(self._port_file):  # stale from an earlier server
            os.unlink(self._port_file)
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.bus_server",
             "--backend", backend, "--path", path,
             "--port", "0", "--port-file", self._port_file],
            env=_child_env())
        self._address: Optional[str] = None

    @property
    def address(self) -> str:
        if self._address is None:
            deadline = time.monotonic() + 20.0
            while not os.path.exists(self._port_file):
                if self.proc.poll() is not None:
                    raise RuntimeError("bus server died before binding")
                if time.monotonic() > deadline:
                    raise TimeoutError("bus server never published its port")
                time.sleep(0.02)
            with open(self._port_file) as f:
                self._address = f"127.0.0.1:{int(f.read().strip())}"
        return self._address

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=10)

    def __enter__(self) -> "BusServerProcess":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.kill()


def spawn_component(role: str, address: str,
                    spec: Dict[str, Any]) -> subprocess.Popen:
    """Launch one component role as a child process."""
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.procs", "--role", role,
         "--address", address, "--spec", json.dumps(spec)],
        env=_child_env())


def sigkill(proc: subprocess.Popen) -> None:
    """Hard-kill (SIGKILL, no cleanup — the crash the paper recovers from)."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=10)


if __name__ == "__main__":
    main()
