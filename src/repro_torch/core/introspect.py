"""Agentic introspection (paper §1, §5.3, §5.4): inference over the bus.

The paper runs LLM inference over the agent's own execution history. Here
the "inference" is implemented as structured analysis over the typed log —
the same information flow (entire execution history, not token-only
trajectories), feeding semantic recovery, semantic health checks, and the
swarm Supervisor.

``BusObserver`` is the incremental form: it maintains a cursor over the
log and folds newly appended entries into running aggregates and
``IntentTrace`` lifecycles, so long-lived observers (Supervisors, standby
executors, health checkers) pay O(new entries) per sweep rather than
re-reading and re-decoding the full log every time. The stateless
``summarize_bus`` / ``health_check`` entry points are thin wrappers over a
one-shot observer.
"""
from __future__ import annotations

import statistics
from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

from .bus import AgentBus
from .entries import Entry, PayloadType
from .snapshot import SnapshotStore

#: the entry types that participate in intent lifecycles — the natural
#: push-down filter for trace-only scans (recovery, failover detection).
TRACE_TYPES = (PayloadType.INTENT, PayloadType.VOTE, PayloadType.COMMIT,
               PayloadType.ABORT, PayloadType.RESULT)


@dataclass
class IntentTrace:
    """One intention's full lifecycle reconstructed from the log."""

    intent_id: str
    kind: str
    args: Dict[str, Any]
    intent_pos: int
    votes: List[Dict[str, Any]] = field(default_factory=list)
    decision: Optional[str] = None  # 'commit' | 'abort' | None
    result: Optional[Dict[str, Any]] = None
    intent_ts: float = 0.0
    result_ts: float = 0.0
    saga_id: Optional[str] = None      # multi-intent plan membership
    compensates: Optional[str] = None  # Compensation flag: undone intent id

    @property
    def latency_s(self) -> float:
        if self.result is None:
            return float("nan")
        return self.result_ts - self.intent_ts

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "IntentTrace":
        return cls(**d)


def _fold_trace(traces: Dict[str, IntentTrace], order: List[str],
                e: Entry) -> None:
    b = e.body
    if e.type == PayloadType.INTENT:
        iid = b["intent_id"]
        if iid not in traces:
            traces[iid] = IntentTrace(iid, b["kind"], b.get("args", {}),
                                      e.position, intent_ts=e.realtime_ts,
                                      saga_id=b.get("saga_id"),
                                      compensates=b.get("compensates"))
            order.append(iid)
    elif e.type == PayloadType.VOTE:
        t = traces.get(b["intent_id"])
        if t:
            t.votes.append(b)
    elif e.type == PayloadType.COMMIT:
        t = traces.get(b["intent_id"])
        if t and t.decision is None:
            t.decision = "commit"
    elif e.type == PayloadType.ABORT:
        t = traces.get(b["intent_id"])
        if t and t.decision is None:
            t.decision = "abort"
    elif e.type == PayloadType.RESULT and not b.get("recovered"):
        t = traces.get(b["intent_id"])
        if t:
            t.result = b
            t.result_ts = e.realtime_ts


def trace_intents(entries: Sequence[Entry]) -> List[IntentTrace]:
    traces: Dict[str, IntentTrace] = {}
    order: List[str] = []
    for e in entries:
        _fold_trace(traces, order, e)
    return [traces[i] for i in order]


def failed_sagas(traces: Sequence[IntentTrace]) -> Dict[str, Dict[str, Any]]:
    """Group saga-flagged traces and report every *failed* saga.

    A saga has failed when any member intent was aborted, produced a
    failed (``ok=False``) Result, or was committed but never produced a
    Result at all (its executor died mid-saga — effect state unknown).
    For each failed saga, ``compensate`` lists the member traces whose
    effects must be undone — the committed prefix whose handler succeeded
    (or whose outcome is unknown) — in **reverse log order** and minus any
    member an ``ok`` compensation Result already covers (so a compensating
    executor crash never leads to double compensation). ``attempts`` maps
    each of those ids to the number of compensation intents already issued
    for it (the next attempt number is ``attempts[iid] + 1``).
    """
    sagas: Dict[str, List[IntentTrace]] = {}
    comps: Dict[str, List[IntentTrace]] = {}  # compensated iid -> attempts
    for t in traces:
        if t.compensates:
            comps.setdefault(t.compensates, []).append(t)
        elif t.saga_id:
            sagas.setdefault(t.saga_id, []).append(t)
    out: Dict[str, Dict[str, Any]] = {}
    for sid, members in sagas.items():
        failed = [t for t in members
                  if t.decision == "abort"
                  or (t.result is not None and not t.result.get("ok"))
                  or (t.decision == "commit" and t.result is None)]
        if not failed:
            continue
        to_comp: List[IntentTrace] = []
        for t in reversed(members):
            if t.decision != "commit":
                continue  # never committed -> no effect to undo
            if t.result is not None and not t.result.get("ok"):
                continue  # handler failed -> effect never applied
            if any(c.result is not None and c.result.get("ok")
                   for c in comps.get(t.intent_id, ())):
                continue  # already compensated (at-most-once)
            to_comp.append(t)
        out[sid] = {
            "failed": [t.intent_id for t in failed],
            "compensate": to_comp,
            "attempts": {t.intent_id: len(comps.get(t.intent_id, ()))
                         for t in to_comp},
        }
    return out


class BusObserver:
    """Incremental introspection over one bus: cursor + running aggregates.

    ``refresh()`` reads only ``[cursor, tail)`` and folds the new entries
    into per-type counters, byte tallies, and intent traces. All derived
    views (``traces()``, ``summary()``) are computed from the folded state.
    An optional ``on_entry`` callback lets a caller piggyback its own
    per-entry analysis on the same single read of the suffix (e.g. the
    Supervisor's fix harvesting) instead of maintaining a second cursor.
    """

    def __init__(self, bus: AgentBus, start: int = 0,
                 on_entry: Optional[Callable[[Entry], None]] = None) -> None:
        self.bus = bus
        self.cursor = start
        self.on_entry = on_entry
        self._traces: Dict[str, IntentTrace] = {}
        self._order: List[str] = []
        self._by_type: Dict[str, int] = {}
        self._bytes_by_type: Dict[str, int] = {}

    # -- snapshot / bootstrap (the observer is itself replayable state) -----
    def to_snapshot(self) -> Dict[str, Any]:
        return {"cursor": self.cursor,
                "by_type": dict(self._by_type),
                "bytes_by_type": dict(self._bytes_by_type),
                "traces": [self._traces[i].to_dict() for i in self._order]}

    def restore_snapshot(self, snap: Dict[str, Any]) -> None:
        self.cursor = snap["cursor"]
        self._by_type = dict(snap["by_type"])
        self._bytes_by_type = dict(snap["bytes_by_type"])
        self._traces = {}
        self._order = []
        for d in snap["traces"]:
            t = IntentTrace.from_dict(d)
            self._traces[t.intent_id] = t
            self._order.append(t.intent_id)

    def bootstrap(self, snapshots: Optional[SnapshotStore],
                  component_id: str) -> int:
        """Snapshot-anchored boot: restore the latest observer snapshot and
        resume folding at its position instead of 0 (mandatory on a
        trimmed bus — a cursor below the trim base cannot be replayed).
        Mirrors ``Recoverable.bootstrap``: with no snapshot the cursor
        anchors at the trim base, but a snapshot *older* than the base
        raises ``TrimmedError`` — silently skipping the unfolded gap
        would corrupt every derived trace/health statistic."""
        from .bus import TrimmedError
        latest = snapshots.latest(component_id) if snapshots else None
        base = self.bus.trim_base()
        if latest is None:
            self.cursor = max(self.cursor, base)
        else:
            pos, state = latest
            if pos > self.cursor:
                self.restore_snapshot(state)
                self.cursor = max(self.cursor, pos)
            if self.cursor < base:
                raise TrimmedError(self.cursor, base)
        return self.cursor

    def checkpoint(self, snapshots: SnapshotStore, component_id: str,
                   client: Optional[Any] = None) -> int:
        """Persist the folded state; optionally announce it on the bus
        (``client`` must hold Checkpoint append rights, e.g. the
        supervisor role) so the coordinator can account for this
        observer when computing the low-water mark."""
        pos = self.cursor
        snapshots.put(component_id, pos, self.to_snapshot())
        if client is not None:
            from . import entries as E
            client.append(E.checkpoint(component_id, pos,
                                       f"{component_id}/{pos:012d}"))
        return pos

    def refresh(self) -> int:
        """Fold all newly appended entries; returns how many were new."""
        if self.cursor == 0:  # fresh boot: anchor at the trim base
            self.cursor = self.bus.trim_base()
        tail = self.bus.tail()
        new = self.bus.read(self.cursor, tail)
        for e in new:
            tv = e.type.value
            self._by_type[tv] = self._by_type.get(tv, 0) + 1
            self._bytes_by_type[tv] = (self._bytes_by_type.get(tv, 0)
                                       + len(e.payload.to_json()))
            _fold_trace(self._traces, self._order, e)
            if self.on_entry is not None:
                self.on_entry(e)
        self.cursor = max(self.cursor, tail)
        return len(new)

    def traces(self) -> List[IntentTrace]:
        return [self._traces[i] for i in self._order]

    def summary(self) -> Dict[str, Any]:
        traces = self.traces()
        completed = [t for t in traces if t.result is not None]
        failed = [t for t in completed if not t.result.get("ok", False)]
        lat = [t.latency_s for t in completed if t.latency_s == t.latency_s]
        return {
            "tail": self.cursor,
            "entries_by_type": dict(self._by_type),
            "bytes_by_type": dict(self._bytes_by_type),
            "total_bytes": sum(self._bytes_by_type.values()),
            "n_intents": len(traces),
            "n_committed": sum(1 for t in traces if t.decision == "commit"),
            "n_aborted": sum(1 for t in traces if t.decision == "abort"),
            "n_completed": len(completed),
            "n_failed": len(failed),
            "mean_latency_s": statistics.fmean(lat) if lat else 0.0,
            "p90_latency_s": (sorted(lat)[int(0.9 * (len(lat) - 1))]
                              if lat else 0.0),
            "inflight": [t.intent_id for t in traces
                         if t.decision == "commit" and t.result is None],
            "last_kinds": [t.kind for t in traces[-8:]],
            "work_claims": sorted({tuple(t.args["work_range"])
                                   for t in traces
                                   if "work_range" in t.args
                                   and t.decision == "commit"}),
            "completed_work": sorted({tuple(t.args["work_range"])
                                      for t in completed
                                      if "work_range" in t.args
                                      and t.result.get("ok")}),
        }


def summarize_bus(bus: AgentBus, start: int = 0) -> Dict[str, Any]:
    """A semantic summary of an agent's activity — what a Supervisor reads.
    One-shot form; long-lived callers should hold a ``BusObserver``."""
    obs = BusObserver(bus, start)
    obs.refresh()
    return obs.summary()


def health_check(bus: AgentBus, peer_summaries: Sequence[Dict[str, Any]] = (),
                 slow_factor: float = 3.0,
                 observer: Optional[BusObserver] = None) -> Dict[str, Any]:
    """Semantic health check (paper §5.3): inspects per-intent latency in
    the log; compares against the agent's own history and peers; flags a
    straggler before a takeover. Pass a long-lived ``observer`` to make the
    scan incremental (one read of the new suffix instead of two full-log
    reads)."""
    obs = observer if observer is not None else BusObserver(bus)
    obs.refresh()
    s = obs.summary()
    traces = [t for t in obs.traces() if t.result is not None]
    verdict = "healthy"
    reasons: List[str] = []
    if s["inflight"]:
        verdict = "in-flight"
    if s["n_failed"] > 0 and s["n_completed"] > 0:
        frac = s["n_failed"] / s["n_completed"]
        if frac > 0.5:
            verdict, _ = "failing", reasons.append(
                f"{s['n_failed']}/{s['n_completed']} intents failed")
    # Straggler detection: most recent latencies vs own earlier history.
    lat = [t.latency_s for t in traces if t.latency_s == t.latency_s]
    if len(lat) >= 6:
        head = lat[: len(lat) // 2]
        recent = lat[-3:]
        if statistics.fmean(recent) > slow_factor * max(
                statistics.fmean(head), 1e-9):
            verdict = "straggler"
            reasons.append(
                f"recent latency {statistics.fmean(recent):.3f}s > "
                f"{slow_factor}x historical {statistics.fmean(head):.3f}s")
    # ... vs peers.
    peer_lat = [p.get("mean_latency_s", 0.0) for p in peer_summaries]
    if peer_lat and s["mean_latency_s"] > slow_factor * max(
            statistics.fmean(peer_lat), 1e-9):
        verdict = "straggler"
        reasons.append("slow relative to peers")
    return {"verdict": verdict, "reasons": reasons, "summary": s}
