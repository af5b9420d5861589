"""Swarm Supervisor (paper §5.4): a centralized "gossip hub" that
periodically introspects every worker's AgentBus and sends workers mail
with (a) fixes other workers discovered for shared infrastructural issues
and (b) deduplication hints so workers avoid redundant work.

The Supervisor only holds the ``supervisor`` role: it can read everything
but append only Mail — it cannot vote, commit, or change policy.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from .acl import BusClient
from .bus import AgentBus
from .entries import PayloadType, mail
from .introspect import BusObserver, failed_sagas, health_check
from .snapshot import SnapshotStore


class Supervisor:
    def __init__(self, worker_buses: Dict[str, AgentBus],
                 supervisor_id: str = "supervisor"):
        self.supervisor_id = supervisor_id
        self.workers = dict(worker_buses)
        self.clients = {name: BusClient(bus, supervisor_id, "supervisor")
                        for name, bus in self.workers.items()}
        # Incremental per-worker introspection: each sweep folds only the
        # log suffix appended since the last sweep (no full-log re-reads).
        # Fix harvesting piggybacks on the same read via on_entry.
        self._observers = {name: BusObserver(bus, on_entry=self._harvest_fix)
                           for name, bus in self.workers.items()}
        self.known_fixes: Dict[str, str] = {}   # issue -> fix text
        self.sent_fixes: Dict[str, Set[str]] = {n: set() for n in self.workers}
        self.claimed: Dict[Tuple[int, int], str] = {}  # work_range -> worker
        self._claims_sent: Dict[str, Set[Tuple[int, int]]] = {}
        self._sagas_flagged: Dict[str, Set[str]] = {n: set()
                                                    for n in self.workers}
        self.mail_sent = 0

    def _observer_id(self, worker: str) -> str:
        return f"{self.supervisor_id}@{worker}"

    def bootstrap(self, snapshots: Optional[SnapshotStore]) -> Dict[str, int]:
        """Snapshot-anchored boot: every per-worker observer restores its
        latest snapshot and resumes folding at that position instead of
        re-reading each worker's full (possibly trimmed) log."""
        return {name: obs.bootstrap(snapshots, self._observer_id(name))
                for name, obs in self._observers.items()}

    def checkpoint(self, snapshots: SnapshotStore) -> Dict[str, int]:
        """Persist every observer's folded state and announce it on the
        corresponding worker bus (supervisor credentials may append
        Checkpoint), so worker-bus coordinators can account for the
        supervisor's cursor when trimming."""
        return {name: obs.checkpoint(snapshots, self._observer_id(name),
                                     client=self.clients[name])
                for name, obs in self._observers.items()}

    def _harvest_fix(self, e) -> None:
        """Observer hook: workers publish explicit fix notes in result
        values ({"fix": {...}}); harvest them while the observer folds the
        new suffix — one read, one cursor per worker."""
        if e.type != PayloadType.RESULT:
            return
        fix = e.body.get("value", {}).get("fix")
        if fix:
            self.known_fixes[str(fix.get("issue"))] = str(fix.get("remedy"))

    def sweep(self) -> Dict[str, Any]:
        """One introspection round over the fleet. Returns the fleet view."""
        # 1) Refresh every worker's observer (fix harvesting rides along).
        for obs in self._observers.values():
            obs.refresh()
        summaries = {n: obs.summary() for n, obs in self._observers.items()}
        # 2) Broadcast fixes each worker hasn't seen yet.
        for name in self.workers:
            for issue, remedy in self.known_fixes.items():
                if issue in self.sent_fixes[name]:
                    continue
                self.clients[name].append(mail(
                    f"[supervisor] known fix: {issue} -> {remedy}",
                    sender="supervisor", fix={"issue": issue,
                                              "remedy": remedy}))
                self.sent_fixes[name].add(issue)
                self.mail_sent += 1
        # 3) Dedup work claims: first claimant wins; later claimants get a
        #    release note so they pick different ranges.
        for name, s in summaries.items():
            for rng in s["work_claims"]:
                rng_t = tuple(rng)
                owner = self.claimed.setdefault(rng_t, name)
                if owner != name:
                    self.clients[name].append(mail(
                        f"[supervisor] range {rng} already owned by {owner};"
                        " skip it", sender="supervisor",
                        dedup={"range": list(rng), "owner": owner}))
                    self.mail_sent += 1
        # 3b) Gossip-hub: broadcast every claim each worker hasn't seen,
        #     so workers stop proposing ranges peers already own.
        for name in self.workers:
            seen = self._claims_sent.setdefault(name, set())
            fresh = [list(r) for r, owner in self.claimed.items()
                     if owner != name and r not in seen]
            if fresh:
                self.clients[name].append(mail(
                    f"[supervisor] {len(fresh)} ranges claimed by peers",
                    sender="supervisor", claims_snapshot=fresh))
                seen.update(tuple(r) for r in fresh)
                self.mail_sent += 1
        # 3c) Saga failures: a definitively failed multi-intent plan (an
        #     aborted member or a failed Result — commit-without-Result
        #     alone may just be in flight) gets one advisory mail to the
        #     owning worker naming the committed prefix to compensate
        #     (ROADMAP 3(a); the worker's RecoveryPlanner does the unwind).
        saga_failures: Dict[str, Dict[str, Any]] = {}
        for name, obs in self._observers.items():
            traces = {t.intent_id: t for t in obs.traces()}
            fs = failed_sagas(obs.traces())
            definite = {
                sid: info for sid, info in fs.items()
                if any(traces[i].decision == "abort"
                       or traces[i].result is not None
                       for i in info["failed"])}
            if definite:
                saga_failures[name] = {
                    sid: {"failed": info["failed"],
                          "compensate": [t.intent_id
                                         for t in info["compensate"]]}
                    for sid, info in definite.items()}
            flagged = self._sagas_flagged.setdefault(name, set())
            for sid, info in definite.items():
                if sid in flagged:
                    continue
                comp_ids = [t.intent_id for t in info["compensate"]]
                self.clients[name].append(mail(
                    f"[supervisor] saga {sid} failed at "
                    f"{info['failed']}; compensate committed prefix "
                    f"in reverse order: {comp_ids}",
                    sender="supervisor",
                    saga={"saga_id": sid, "failed": info["failed"],
                          "compensate": comp_ids}))
                flagged.add(sid)
                self.mail_sent += 1
        # 4) Health: flag stragglers relative to the fleet (reusing each
        #    worker's observer — no extra log reads).
        health = {}
        for name, bus in self.workers.items():
            peer = [s for n, s in summaries.items() if n != name]
            health[name] = health_check(bus, peer_summaries=peer,
                                        observer=self._observers[name])
        return {"summaries": summaries, "health": health,
                "known_fixes": dict(self.known_fixes),
                "claimed": {str(k): v for k, v in self.claimed.items()},
                "saga_failures": saga_failures,
                "mail_sent": self.mail_sent}
