"""Automatic failover & straggler mitigation (paper §3.2 + §5.3 applied).

``StandbyExecutor`` implements the paper's "warm standby node [that] can
perform a semantic health check on a primary node before taking over":

  1. watch the primary's bus via introspection (no direct channel);
  2. detect (a) a committed intention with no Result for longer than
     ``takeover_timeout`` (crash / hang), or (b) a straggler verdict from
     the semantic health check (latency degradation);
  3. take over: boot a fresh Executor with ``announce_reboot=True`` — the
     special recovered-Result fences the old executor (it would dedupe on
     the new executor's results anyway) and triggers the Driver's semantic
     recovery flow.

``ElasticWorkerPool`` scales a swarm: it spawns replacement workers (via
the AgentKernel) for agents whose health check fails, and retires idle
ones — membership changes are just bus creations, because voters/deciders
"simply show up" (§3.2) and work claims are supervisor-deduped.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

from .acl import BusClient
from .bus import AgentBus
from .executor import Executor, Handler
from .introspect import BusObserver, health_check
from .snapshot import SnapshotStore


class StandbyExecutor:
    def __init__(self, bus: AgentBus, env: Any,
                 handlers: Dict[str, Handler],
                 takeover_timeout: float = 5.0,
                 slow_factor: float = 3.0,
                 standby_id: str = "executor-standby",
                 clock: Callable[[], float] = time.time):
        self.bus = bus
        self.env = env
        self.handlers = handlers
        self.timeout = takeover_timeout
        self.slow_factor = slow_factor
        self.standby_id = standby_id
        self.clock = clock
        self.active: Optional[Executor] = None
        self.takeover_reason: Optional[str] = None
        # Incremental watch: each check() folds only the new log suffix.
        self._observer = BusObserver(bus)

    # -- lifecycle -----------------------------------------------------------
    def bootstrap(self, snapshots: Optional[SnapshotStore]) -> int:
        """Snapshot-anchored boot of the watch observer (required when the
        primary's bus has been trimmed — the observer cannot start at 0)."""
        return self._observer.bootstrap(snapshots,
                                        f"{self.standby_id}-watch")

    def checkpoint(self, snapshots: SnapshotStore) -> int:
        """Persist the watch state and announce it (supervisor-role
        credential) so the bus coordinator accounts for this standby."""
        client = BusClient(self.bus, f"{self.standby_id}-watch",
                           "supervisor")
        return self._observer.checkpoint(
            snapshots, f"{self.standby_id}-watch", client=client)

    # -- detection -----------------------------------------------------------
    def check(self) -> Optional[str]:
        """Returns a takeover reason, or None if the primary looks healthy."""
        if self.active is not None:
            return None
        now = self.clock()
        self._observer.refresh()
        for t in self._observer.traces():
            if t.decision == "commit" and t.result is None:
                # committed intention with no Result: how stale is it?
                committed_ts = max(t.intent_ts, 0.0)
                if now - committed_ts > self.timeout:
                    return (f"intent {t.intent_id} committed "
                            f"{now - committed_ts:.1f}s ago with no result")
        hc = health_check(self.bus, slow_factor=self.slow_factor,
                          observer=self._observer)
        if hc["verdict"] in ("failing",):
            return f"health check: {hc['verdict']} ({hc['reasons']})"
        return None

    # -- takeover --------------------------------------------------------------
    def maybe_take_over(self) -> bool:
        reason = self.check()
        if reason is None:
            return False
        self.takeover_reason = reason
        self.active = Executor(
            BusClient(self.bus, self.standby_id, "executor"),
            env=self.env, handlers=self.handlers,
            executor_id=self.standby_id, announce_reboot=True)
        return True

    def play_available(self) -> int:
        took = self.maybe_take_over()
        if self.active is None:
            return 0
        return self.active.play_available() + (1 if took else 0)

    @property
    def cursor(self) -> int:  # scheduler compatibility
        return self.active.cursor if self.active else self.bus.tail()


class ElasticWorkerPool:
    """Swarm-level elasticity on top of an AgentKernel: replace workers
    whose health degrades; spawn extras on demand."""

    def __init__(self, kernel, image: str, image_kw_fn=None,
                 slow_factor: float = 3.0):
        self.kernel = kernel
        self.image = image
        self.image_kw_fn = image_kw_fn or (lambda i: {})
        self.slow_factor = slow_factor
        self.generation = 0
        self.replaced: Dict[str, str] = {}

    def scale_to(self, n: int) -> None:
        existing = [b for b in self.kernel.list_buses()
                    if b.startswith("worker-")]
        for i in range(len(existing), n):
            self.kernel.create_bus(
                f"worker-{self.generation}-{i}", mode="spawn",
                image=self.image, image_kw=self.image_kw_fn(i))

    def sweep(self) -> Dict[str, str]:
        """Health-check every worker; spawn replacements for failing ones.
        Returns {worker: action}."""
        actions: Dict[str, str] = {}
        for name in list(self.kernel.list_buses()):
            if not name.startswith("worker-") or name in self.replaced:
                continue
            h = self.kernel.get(name)
            hc = health_check(h.bus, slow_factor=self.slow_factor)
            if hc["verdict"] in ("failing", "straggler"):
                self.generation += 1
                repl = f"worker-{self.generation}-r{len(self.replaced)}"
                self.kernel.create_bus(repl, mode="spawn", image=self.image,
                                       image_kw=self.image_kw_fn(repl))
                self.replaced[name] = repl
                actions[name] = f"replaced_by:{repl} ({hc['verdict']})"
            else:
                actions[name] = hc["verdict"]
        return actions
