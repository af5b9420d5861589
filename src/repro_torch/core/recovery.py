"""Semantic recovery (paper §3.2 Executor + §5.3).

A crashed/slow agent's bus is handed to a recovery flow that:

1. **Introspects** the original bus's intentions (only the intentions — the
   paper's recovery prompt: "inspect only the intentions on the original
   bus") to determine what was planned and what completed;
2. issues **exploratory intentions** that probe the environment to find
   where the interrupted work actually stopped (at-most-once: never blindly
   re-run);
3. **rolls forward** the remaining work, optionally *repairing* the
   implementation (the paper's rglob→os.scandir 290× fix) via pluggable
   ``Optimizer`` hooks that pattern-match known pathologies in the logged
   intention payloads.

All recovery actions flow through the normal Intent→Vote→Commit→Execute
machinery — recovery is itself voted on (paper: "Executors cannot be relied
[upon] to drive semantic recovery on their own ... without going through
Voters").
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

from .bus import AgentBus
from .driver import Planner
from .entries import PayloadType, comp_intent_id
from .introspect import TRACE_TYPES, failed_sagas, trace_intents
from .snapshot import SnapshotStore

OptimizerHook = Callable[[Dict[str, Any]], Optional[Dict[str, Any]]]
# hook(original_intent_body) -> replacement args (or None if no fix applies)


def known_pathology_fixes(intent_body: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Built-in fix library: detect slow implementations recorded in the log
    and substitute efficient ones (the Fig-8 move)."""
    args = intent_body.get("args", {})
    impl = args.get("impl")
    if impl == "rglob_sorted":  # recursive-enumerate-then-sort pathology
        return {**args, "impl": "scandir"}
    if impl == "unchunked":  # whole-array eval that thrashes
        return {**args, "impl": "chunked"}
    return None


class RecoveryPlanner(Planner):
    """A Planner for a recovery agent (or a restarted original agent).

    Drives the three-phase flow above over a *work-range* task shape: the
    original task is a list of work units processed in range-chunks, with
    per-chunk ``Result`` entries recording completion (this mirrors the
    paper's 2000-folder checksum task). Phases:

      probe   -> issue an exploratory intent that asks the environment how
                 much output already exists (never trusts the log alone);
      resume  -> re-issue the interrupted processing intent for the
                 remaining range only, with pathology fixes applied;
      verify  -> issue a verification intent over the full output.

    Before any of those, a **compensate** phase (saga recovery, arXiv
    2605.03409): if the original bus holds a failed multi-intent saga —
    a ``saga_id``-flagged plan with an aborted member, a failed Result,
    or a committed member whose Result never arrived — the planner first
    emits one Compensation-flagged intent per committed-prefix member, in
    reverse order (``plan_compensations``). Each compensation is an
    ordinary Intent: it is voted on before it executes (stoppable), and
    its deterministic id (``comp-<iid>``, retries ``comp-<iid>.rN``)
    makes re-planning after a recovery crash dedupe instead of
    double-compensating.
    """

    def __init__(self, original_bus: AgentBus,
                 optimizer_hooks: Sequence[OptimizerHook] = (
                     known_pathology_fixes,),
                 snapshots: Optional[SnapshotStore] = None,
                 original_agent_id: str = "agent"):
        self.original = original_bus
        self.hooks = list(optimizer_hooks)
        self.phase = "probe"
        self.probe_result: Optional[Dict[str, Any]] = None
        self.plan_notes: List[str] = []
        # Introspect only the intentions of the original bus (paper §5.3);
        # the type filter is pushed down so InfIn/InfOut blobs never load.
        # The scan is snapshot-anchored: on a *trimmed* original bus the
        # oldest intentions live only in the original Driver's snapshot
        # (its conversation history records every issued intent), so we
        # harvest those first and then read the surviving log suffix.
        intents: List[Dict[str, Any]] = []
        seen = set()
        if snapshots is not None:
            latest = snapshots.latest(f"{original_agent_id}-driver")
            if latest is not None:
                for h in latest[1].get("history", ()):
                    if h.get("role") == "intent":
                        body = dict(h["body"])
                        if body.get("intent_id") not in seen:
                            seen.add(body.get("intent_id"))
                            intents.append(body)
        for e in self.original.read(self.original.trim_base(),
                                    types=(PayloadType.INTENT,)):
            if e.body.get("intent_id") not in seen:
                seen.add(e.body.get("intent_id"))
                intents.append(e.body)
        self.original_intents = intents
        self.work_intent = next(
            (b for b in reversed(intents) if "work_range" in b.get("args", {})),
            None)
        #: reverse-order compensation plans for failed sagas, emitted
        #: one per propose() before the probe/resume/verify flow starts.
        self.pending_compensations = plan_compensations(original_bus)

    # -- the "inference" over introspected history ---------------------------
    def propose(self, context: Dict[str, Any]) -> Dict[str, Any]:
        if self.pending_compensations:
            comp = self.pending_compensations.pop(0)
            self.plan_notes.append(
                f"compensate {comp['compensates']} "
                f"(saga {comp.get('saga_id')})")
            return {"intent": comp,
                    "note": "Undo the committed prefix of the failed saga, "
                            "most recent effect first"}
        if self.work_intent is None:
            return {"done": True, "note": "nothing to recover"}
        if self.phase == "probe":
            self.phase = "resume"
            self.plan_notes.append("check what was already completed")
            return {"intent": {"kind": "probe_progress",
                               "args": {"task": self.work_intent["args"]}},
                    "note": "Let me check what was already completed"}
        if self.phase == "resume":
            last = context["history"][-1] if context["history"] else {}
            value = last.get("body", {}).get("value", {})
            done_until = int(value.get("done_until", 0))
            lo, hi = self.work_intent["args"]["work_range"]
            if done_until >= hi:
                self.phase = "verify"
                return self.propose(context)
            args = dict(self.work_intent["args"])
            args["work_range"] = [max(lo, done_until), hi]
            fixed = self._apply_fixes({"kind": self.work_intent["kind"],
                                       "args": args})
            self.phase = "verify"
            self.plan_notes.append(
                f"continue from {done_until}; impl={fixed.get('impl')}")
            return {"intent": {"kind": self.work_intent["kind"],
                               "args": fixed},
                    "note": "Continue from where it left off"}
        if self.phase == "verify":
            self.phase = "done"
            return {"intent": {"kind": "verify_output",
                               "args": {"task": self.work_intent["args"]}},
                    "note": "Verify the output"}
        return {"done": True, "note": "Task completed successfully!"}

    def _apply_fixes(self, intent_body: Dict[str, Any]) -> Dict[str, Any]:
        args = dict(intent_body.get("args", {}))
        for hook in self.hooks:
            fixed = hook({"kind": intent_body["kind"], "args": args})
            if fixed is not None:
                args = fixed
        return args


def plan_compensations(bus: AgentBus) -> List[Dict[str, Any]]:
    """Plan-shaped compensation intents for every failed saga on ``bus``,
    committed prefix in reverse log order (newest effect undone first —
    the standard saga unwind). Each plan dict is what a ``Planner`` puts
    under ``"intent"``: the Driver forwards the ``compensates``/``saga_id``
    extras into the Intent body, the Executor dispatches on the flag to the
    registered compensator. Members already covered by an ``ok``
    compensation Result are excluded (``introspect.failed_sagas``), so a
    recovery that crashes mid-unwind and re-plans never double-compensates;
    members whose earlier compensation *committed but never resulted* get a
    fresh attempt id (``comp-<iid>.rN``) the Decider will accept."""
    traces = trace_intents(bus.read(bus.trim_base(), types=TRACE_TYPES))
    plans: List[Dict[str, Any]] = []
    fs = failed_sagas(traces)
    for sid in sorted(fs):
        info = fs[sid]
        for t in info["compensate"]:
            attempt = info["attempts"][t.intent_id] + 1
            plans.append({
                "kind": t.kind,
                "args": {"of": t.intent_id, "args": dict(t.args),
                         "result": (t.result or {}).get("value")},
                "intent_id": comp_intent_id(t.intent_id, attempt),
                "compensates": t.intent_id,
                "saga_id": sid,
            })
    return plans


def in_flight_at(entries, position: int) -> List[str]:
    """Intent ids proposed but not yet decided as of ``position``: an
    INTENT entry lands below ``position`` with no COMMIT/ABORT for it
    below ``position``. These are the intents a log forked at ``position``
    re-adjudicates — the replayed Voter/Decider see them fresh, so a
    substituted policy can flip their outcome (what-if replay reports
    them as ``reopened``). Log order preserved."""
    pending: List[str] = []
    decided = set()
    for e in entries:
        if e.position >= position:
            break
        if e.type == PayloadType.INTENT:
            pending.append(e.body.get("intent_id"))
        elif e.type in (PayloadType.COMMIT, PayloadType.ABORT):
            decided.add(e.body.get("intent_id"))
    return [iid for iid in pending if iid not in decided]


def committed_unexecuted(bus: AgentBus) -> List[Dict[str, Any]]:
    """WAL-style scan: committed intentions without a Result — the at-most-
    once candidates a recovering executor must treat as 'state unknown'.
    Anchored at the trim base: the CheckpointCoordinator never trims a
    committed-but-unexecuted intention, so the suffix is sufficient."""
    return [t.args | {"intent_id": t.intent_id, "kind": t.kind}
            for t in trace_intents(bus.read(bus.trim_base(),
                                            types=TRACE_TYPES))
            if t.decision == "commit" and t.result is None]
