"""The parity harness of the port's ``core`` modules against the
reference's, on the CPU: each package's ``core`` modules and its
``launch.bus_server`` as one namespace (``REF``, ``PORT``), a record of
what a scenario observes (``Record``, ``_obs``), entry timestamps and ids
from counters (``_clock``), and one scenario run per package (``_run``,
``_both``).

A scenario is written once, as a function ``scenario(pkg, rec, root,
*args)`` of one package; the port's record must equal the reference's.
"""
import contextlib
import importlib
import itertools
import os
import time
from types import SimpleNamespace


def _package(name):
    mods = {m: importlib.import_module(f"{name}.core.{m}")
            for m in ("acl", "agent", "bus", "codec", "driver", "entries",
                      "failover", "faults", "introspect", "kernel",
                      "netbus", "recovery", "snapshot", "supervisor",
                      "voter")}
    return SimpleNamespace(
        name=name, bus_server=importlib.import_module(
            f"{name}.launch.bus_server"), **mods)


REF, PORT = _package("repro"), _package("repro_torch")


def _obs(x):
    """What a record keeps of a value: entries as (position, type, body,
    ts); containers element by element."""
    if hasattr(x, "realtime_ts") and hasattr(x, "payload"):
        return (x.position, x.type.value, x.body, x.realtime_ts)
    if isinstance(x, (list, tuple)):
        return [_obs(v) for v in x]
    if isinstance(x, dict):
        return {k: _obs(v) for k, v in x.items()}
    return x


class Record(list):
    """(label, observation) pairs, in the order a scenario made them."""

    def see(self, label, value):
        self.append((label, _obs(value)))
        return value

    def do(self, label, fn, *args, **kw):
        """Call ``fn``: record its result, or the error it raised (type,
        and a TrimmedError's requested position and base)."""
        try:
            out = fn(*args, **kw)
        except Exception as exc:  # the record holds what was raised
            self.append((label, ("raised", type(exc).__name__,
                                 getattr(exc, "requested", None),
                                 getattr(exc, "base", None))))
            return None
        return self.see(label, out)

    def get(self, label):
        return dict(self)[label]


@contextlib.contextmanager
def _clock(pkg):
    """Entry timestamps, and the ids that components and intents draw
    (``entries.new_id``), from counters for the duration of a scenario
    (or of a part of one: the counters restart, and the outer ones are
    put back afterwards)."""
    real, tick = pkg.bus.time, itertools.count()
    real_id, ids = pkg.entries.new_id, itertools.count()
    pkg.bus.time = SimpleNamespace(
        time=lambda: 1.7e9 + 0.25 * next(tick), monotonic=time.monotonic,
        sleep=time.sleep)
    pkg.entries.new_id = lambda: f"{next(ids):016x}"
    try:
        yield
    finally:
        pkg.bus.time = real
        pkg.entries.new_id = real_id


def _run(scenario, pkg, root, *args):
    os.makedirs(root, exist_ok=True)
    rec = Record()
    with _clock(pkg):
        scenario(pkg, rec, str(root), *args)
    return rec


def _both(scenario, tmp_path, *args):
    """The reference's record and the port's, each in a directory of its
    own."""
    want = _run(scenario, REF, tmp_path / "ref", *args)
    got = _run(scenario, PORT, tmp_path / "port", *args)
    assert len(want) > 0
    return want, got
