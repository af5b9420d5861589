"""The modules that ``repro_torch`` keeps as copies of the reference's
(``core/`` and the numpy-only ``data/pipeline.py``) hold the reference's
text: equal line for line, apart from lines named here.

* ``core/bus.py`` is cut down to the in-process backend (``AgentBus``,
  ``MemoryBus``, ``TrimmedError``, ``make_bus("memory")``): it may drop
  the reference's lines, and the lines it has that the reference does not
  are the ones in ``BUS_OWN_LINES`` (docstring and comment lines that
  describe the cut, its imports without the durable backends' modules,
  and ``make_bus``'s refusal of the other backends).
* ``core/faults.py`` differs in the first line of its docstring.
* Every other copy is the reference's file, byte for byte.
"""
import difflib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT, REF = ROOT / "src" / "repro_torch", ROOT / "src" / "repro"
COPIES = sorted(p.relative_to(PORT).as_posix()
                for p in (PORT / "core").glob("*.py")
                if p.name != "__init__.py") + ["data/pipeline.py"]

BUS_OWN_LINES = [
    '"""The AgentBus: a linearizable typed shared log (paper §3, §4.1).',
    '',
    "This is the port's copy of the bus abstraction cut down to what the",
    'governed serving agent needs: the ``AgentBus`` interface, the in-process',
    '``MemoryBus`` backend, ``TrimmedError`` and ``make_bus("memory")``. The',
    'durable backends (SQLite, the segmented KV store, the network client) are',
    'not carried yet.',
    '* ``append_many(payloads) -> positions`` — batched append under one lock',
    '  acquisition. Positions are dense and contiguous: a batch occupies',
    '  ``[positions[0], positions[0] + len(payloads))``.',
    '  optional *push-down type filtering* (a per-type position index probe in',
    '  ``MemoryBus``).',
    '  lifecycle API: ``trim`` drops entries below a low-water mark computed',
    '  from component checkpoints (``core.lifecycle``); positions and ``tail()``',
    '  are unchanged by a trim, and a ``read``/``poll`` that starts below the',
    '  base raises the typed ``TrimmedError`` (recover through the snapshot',
    '  store).',
    "records**: consumers must never mutate an entry's payload body — copy",
    'first (the ``Executor`` deep-copies args before handing them to user',
    'handlers for exactly this reason).',
    'from typing import Dict, List, Optional, Sequence, Tuple',
    'from .entries import ALL_TYPES, Entry, Payload, PayloadType',
    'from .faults import fault_point',
    '#: Adaptive wait bounds for poll loops on backends without a condvar.',
    '        identical entries at the same positions with the same timestamps,',
    '        under the same trim base. Appends to either log after the fork are',
    '        invisible to the other. ``at_position`` is clamped to ``tail()``;',
    '        forking below the trim base raises ``TrimmedError``."""',
    '        MemoryBus). Returns True if the tail advanced, False on timeout."""',
    '                    # deadline expiring here.',
    '        logically immutable, so sharing is safe and the copy is',
    '        O(entries below the fork point) reference copies."""',
    '    """Factory. The port carries only the ``\'memory\'`` backend."""',
    '    raise ValueError(f"unknown bus backend: {backend} (the port carries "',
    '                     f"only \'memory\')")',
]
FAULTS_OWN_LINES = [
    '"""Deterministic fault injection for the chaos plane.',
]


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
            "core/faults.py", "core/voter.py", "data/pipeline.py"} \
        <= set(COPIES)


@pytest.mark.parametrize("rel", COPIES)
def test_copy_holds_the_reference_text(rel):
    own, dropped = _diff(rel)
    if rel == "core/bus.py":
        assert own == BUS_OWN_LINES
        return
    if rel == "core/faults.py":
        assert own == FAULTS_OWN_LINES
        assert len(dropped) == 1 and dropped[0].startswith(
            '"""Deterministic fault injection for the chaos plane')
        return
    assert (PORT / rel).read_bytes() == (REF / rel).read_bytes()
