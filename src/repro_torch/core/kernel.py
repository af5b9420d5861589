"""AgentKernel: the AgentBus control plane (paper §4.1).

Clients create AgentBus instances in one of four modes:

* **Raw**          — just the bus.
* **Auto-Decider** — bus + a remotely-run Decider.
* **Auto-Voter**   — bus + Decider + voters from a pluggable library.
* **Spawn**        — bus + a full sub-agent (Driver/Executor too), from a
                     pre-built "image" (a registered factory). Backends:
                     in-process threads (the K8s/local-process analogue).

The kernel tracks every bus it creates, which is what the swarm Supervisor
enumerates to introspect a fleet.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

from .acl import BusClient
from .agent import LogActAgent
from .bus import AgentBus, make_bus
from .decider import Decider
from .driver import Planner
from .executor import Handler
from .lifecycle import CheckpointCoordinator
from .snapshot import DirSnapshotStore, MemorySnapshotStore, SnapshotStore
from .voter import RuleVoter, StatVoter, Voter, STANDARD_RULES

VoterFactory = Callable[[BusClient], Voter]

#: Pluggable voter library (paper §4.1 "run optional Voters ... from a
#: pluggable library of available Voters").
VOTER_LIBRARY: Dict[str, VoterFactory] = {
    "rule": lambda c: RuleVoter(c, rules=STANDARD_RULES),
    "rule_strict": lambda c: RuleVoter(c, rules=STANDARD_RULES,
                                       default_approve=False),
    "stat": lambda c: StatVoter(c),
    "stat_override": lambda c: StatVoter(c, override_for="rule"),
}

#: Pre-built sub-agent images for Spawn mode: name -> factory(bus, kw)->agent
AGENT_IMAGES: Dict[str, Callable[..., LogActAgent]] = {}


def register_image(name: str) -> Callable[[Callable[..., LogActAgent]],
                                          Callable[..., LogActAgent]]:
    def deco(f: Callable[..., LogActAgent]) -> Callable[..., LogActAgent]:
        AGENT_IMAGES[name] = f
        return f
    return deco


@dataclass
class TrimPolicy:
    """Per-bus log-lifecycle policy (checkpoint cadence + trim/compact).

    Every ``checkpoint_every`` appended entries, ``maintain`` checkpoints
    all of the bus's components, trims at the coordinator's low-water mark
    (keeping at least ``retain_entries`` newest entries), compacts the
    backend, and prunes the snapshot store to ``keep_snapshots`` files per
    component.
    """

    checkpoint_every: int = 512
    retain_entries: int = 0
    compact: bool = True
    keep_snapshots: int = 3


@dataclass
class BusHandle:
    name: str
    bus: AgentBus
    agent: Optional[LogActAgent] = None
    voters: List[Voter] = field(default_factory=list)
    decider: Optional[Decider] = None
    trim_policy: Optional[TrimPolicy] = None
    coordinator: Optional[CheckpointCoordinator] = None
    snapshots: Optional[SnapshotStore] = None
    last_checkpoint_tail: int = 0

    def components(self) -> List[Any]:
        """Every Recoverable component the kernel runs on this bus."""
        if self.agent is not None:
            return self.agent._components()
        comps: List[Any] = list(self.voters)
        if self.decider is not None:
            comps.append(self.decider)
        return comps


class AgentKernel:
    def __init__(self, workdir: Optional[str] = None,
                 default_backend: str = "memory"):
        self.workdir = workdir
        self.default_backend = default_backend
        self.buses: Dict[str, BusHandle] = {}
        self._lock = threading.Lock()

    def snapshot_store(self) -> SnapshotStore:
        if self.workdir:
            return DirSnapshotStore(os.path.join(self.workdir, "snapshots"))
        return MemorySnapshotStore()

    def create_bus(self, name: str, mode: str = "raw",
                   backend: Optional[str] = None,
                   voters: Sequence[str] = (),
                   image: Optional[str] = None,
                   image_kw: Optional[Dict[str, Any]] = None,
                   threaded: bool = False,
                   trim_policy: Optional[TrimPolicy] = None,
                   **bus_kw) -> BusHandle:
        backend = backend or self.default_backend
        path = None
        if backend in ("sqlite", "kv"):
            assert self.workdir, f"{backend} backend needs a kernel workdir"
            root = os.path.join(self.workdir, "buses")
            os.makedirs(root, exist_ok=True)
            path = os.path.join(root, f"{name}.db" if backend == "sqlite"
                                else name)
        bus = make_bus(backend, path=path, **bus_kw)
        handle = BusHandle(name=name, bus=bus)
        if mode == "spawn":
            assert image in AGENT_IMAGES, f"unknown image {image!r}"
            agent = AGENT_IMAGES[image](bus=bus,
                                        snapshot_store=self.snapshot_store(),
                                        **(image_kw or {}))
            for vname in voters:
                agent.add_voter(VOTER_LIBRARY[vname](
                    BusClient(bus, f"{name}-{vname}", "voter")),
                    from_tail=False)
            handle.agent = agent
            handle.voters = agent.voters
            handle.decider = agent.decider
            if threaded:
                agent.start()
        elif mode in ("auto_decider", "auto_voter"):
            handle.decider = Decider(BusClient(bus, f"{name}-decider",
                                               "decider"))
            if mode == "auto_voter":
                for vname in voters:
                    handle.voters.append(VOTER_LIBRARY[vname](
                        BusClient(bus, f"{name}-{vname}", "voter")))
        elif mode != "raw":
            raise ValueError(f"unknown mode {mode!r}")
        if trim_policy is not None:
            handle.trim_policy = trim_policy
            handle.snapshots = (handle.agent.snapshots if handle.agent
                                else self.snapshot_store())
            handle.coordinator = CheckpointCoordinator(
                bus, component_ids=[c.component_id
                                    for c in handle.components()])
        with self._lock:
            self.buses[name] = handle
        return handle

    # -- log lifecycle (checkpoint + trim + compact), per bus ----------------
    def maintain(self, name: str, force: bool = False) -> Dict[str, Any]:
        """One lifecycle round for one bus: if ``checkpoint_every`` entries
        accumulated since the last round (or ``force``), checkpoint every
        component, trim at the safe low-water mark, compact, and prune old
        snapshots. Returns what happened."""
        h = self.get(name)
        if h.trim_policy is None or h.coordinator is None:
            return {"maintained": False}
        pol = h.trim_policy
        tail = h.bus.tail()
        if not force and tail - h.last_checkpoint_tail < pol.checkpoint_every:
            return {"maintained": False, "tail": tail}
        # Hot-plugged components (add_voter) join the gate set here.
        for c in h.components():
            h.coordinator.register(c.component_id)
        # Stop-the-world checkpoint for threaded agents: to_snapshot()
        # must see a quiescent (cursor, state) pair — snapshotting a
        # component mid-play would tear it (state ahead of the recorded
        # cursor, or dict-mutation races). The pause is bounded by the
        # components' 50 ms idle-wait granularity.
        threaded = h.agent is not None and bool(h.agent._threads)
        if threaded:
            h.agent.stop()
        try:
            positions = {c.component_id: c.checkpoint(h.snapshots)
                         for c in h.components()}
            h.last_checkpoint_tail = h.bus.tail()
            base = h.coordinator.trim(retain=pol.retain_entries)
            compacted = h.bus.compact() if pol.compact else 0
            h.snapshots.prune(keep_last=pol.keep_snapshots)
        finally:
            if threaded:
                h.agent.start()
        return {"maintained": True, "checkpoints": positions,
                "trim_base": base, "compacted": compacted, "tail": tail}

    def maintain_all(self, force: bool = False) -> Dict[str, Dict[str, Any]]:
        return {name: self.maintain(name, force=force)
                for name in self.list_buses()}

    def list_buses(self) -> List[str]:
        with self._lock:
            return sorted(self.buses)

    def get(self, name: str) -> BusHandle:
        return self.buses[name]

    def tick_all(self) -> int:
        """Synchronous scheduler across every managed bus (tests/benchmarks)."""
        n = 0
        for h in list(self.buses.values()):
            if h.agent is not None:
                n += h.agent.tick()
            else:
                for v in h.voters:
                    n += v.play_available()
                if h.decider is not None:
                    n += h.decider.play_available()
        return n

    def shutdown(self) -> None:
        for h in self.buses.values():
            if h.agent is not None:
                h.agent.stop()
            h.bus.close()
