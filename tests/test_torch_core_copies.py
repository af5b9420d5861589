"""The modules that ``repro_torch`` keeps as copies of the reference's
(``core/``, the numpy-only ``data/pipeline.py``, the configs-only
``distributed/analytic.py``, ``launch/bus_server.py`` and
``launch/procs.py``) hold the reference's text: equal line for line, apart
from lines named here.

* ``core/faults.py`` differs in the first line of its docstring.
* ``launch/bus_server.py`` is the reference's text with every
  ``repro.`` read as ``repro_torch.``, and no other difference.
* ``launch/procs.py`` is the reference's text with every whole-word
  ``repro`` (16 of them) read as ``repro_torch``, and the two comment lines
  at ``:219-220``, which call the package a namespace package with no
  ``__init__.py``, replaced by ``PROCS_OWN_LINES`` (``repro_torch`` has
  one); no other difference.
* Every other copy, ``core/bus.py``, ``core/codec.py``, ``core/kernel.py``,
  ``core/supervisor.py``, ``core/failover.py`` and ``core/netbus.py``
  among them, is the reference's file, byte for byte.
"""
import difflib
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT, REF = ROOT / "src" / "repro_torch", ROOT / "src" / "repro"
COPIES = sorted(p.relative_to(PORT).as_posix()
                for p in (PORT / "core").glob("*.py")
                if p.name != "__init__.py") + ["data/pipeline.py",
                                               "distributed/analytic.py",
                                               "launch/bus_server.py",
                                               "launch/procs.py"]

FAULTS_OWN_LINES = [
    '"""Deterministic fault injection for the chaos plane.',
]
PROCS_OWN_LINES = [
    "    # __path__ names the package directory whether or not the package",
    "    # has an __init__.py (repro_torch has one).",
]
PROCS_OWN_AT = 218  # 0-based: the reference's lines 219-220


def _diff(rel):
    ref = (REF / rel).read_text().splitlines()
    port = (PORT / rel).read_text().splitlines()
    ops = difflib.SequenceMatcher(None, ref, port,
                                  autojunk=False).get_opcodes()
    own = [line for tag, _, _, j1, j2 in ops if tag in ("replace", "insert")
           for line in port[j1:j2]]
    dropped = [line for tag, i1, i2, _, _ in ops
               if tag in ("replace", "delete") for line in ref[i1:i2]]
    return own, dropped


def test_the_copies_are_all_checked():
    assert {"core/introspect.py", "core/recovery.py", "core/bus.py",
            "core/codec.py", "core/faults.py", "core/voter.py",
            "core/kernel.py", "core/supervisor.py", "core/failover.py",
            "core/netbus.py", "data/pipeline.py", "distributed/analytic.py",
            "launch/bus_server.py", "launch/procs.py"} <= set(COPIES)


@pytest.mark.parametrize("rel", COPIES)
def test_copy_holds_the_reference_text(rel):
    if rel == "core/faults.py":
        own, dropped = _diff(rel)
        assert own == FAULTS_OWN_LINES
        assert len(dropped) == 1 and dropped[0].startswith(
            '"""Deterministic fault injection for the chaos plane')
        return
    if rel == "launch/bus_server.py":
        ref = (REF / rel).read_text()
        assert (PORT / rel).read_text() == ref.replace("repro.",
                                                       "repro_torch.")
        assert ref.count("repro.") == 10
        return
    if rel == "launch/procs.py":
        ref = (REF / rel).read_text()
        assert len(re.findall(r"\brepro\b", ref)) == 16
        want = re.sub(r"\brepro\b", "repro_torch", ref).split("\n")
        end = PROCS_OWN_AT + len(PROCS_OWN_LINES)
        assert want[PROCS_OWN_AT].lstrip().startswith(
            "# repro_torch is a namespace package (no __init__.py)")
        want[PROCS_OWN_AT:end] = PROCS_OWN_LINES
        assert (PORT / rel).read_text().split("\n") == want
        return
    assert (PORT / rel).read_bytes() == (REF / rel).read_bytes()
