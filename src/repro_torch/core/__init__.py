"""LogAct core, the port's copy: typed shared log (AgentBus) +
deconstructed agent state machine (Driver / Voter / Decider / Executor),
the AgentBus control plane (``AgentKernel``), the swarm ``Supervisor`` and
automatic failover (``StandbyExecutor``, ``ElasticWorkerPool``).
Pure Python; kept as a local copy so that ``repro_torch`` imports nothing
of the JAX package."""
from . import entries
from .acl import AclError, BusClient, Permissions, ROLES
from .agent import LogActAgent
from .bus import (AgentBus, KvBus, MemoryBus, SqliteBus, TrimmedError,
                  make_bus)
from .decider import Decider
from .driver import Driver, Planner, ScriptPlanner
from .entries import Entry, Payload, PayloadType
from .executor import Executor
from .failover import ElasticWorkerPool, StandbyExecutor
from .introspect import (BusObserver, TRACE_TYPES, health_check,
                         summarize_bus, trace_intents)
from .kernel import (AgentKernel, AGENT_IMAGES, TrimPolicy, VOTER_LIBRARY,
                     register_image)
from .lifecycle import CheckpointCoordinator, Recoverable
from .netbus import NetBus, PROTO_VERSION
from .policy import DeciderPolicy, PolicyState
from .recovery import RecoveryPlanner, committed_unexecuted
from .snapshot import DirSnapshotStore, MemorySnapshotStore, SnapshotStore
from .supervisor import Supervisor
from .voter import (RuleVoter, StatVoter, Voter, VoteDecision,
                    STANDARD_RULES)

__all__ = [
    "entries", "AclError", "BusClient", "Permissions", "ROLES",
    "LogActAgent", "AgentBus", "KvBus", "MemoryBus", "SqliteBus",
    "TrimmedError", "make_bus", "NetBus", "PROTO_VERSION",
    "Decider", "Driver", "Planner", "ScriptPlanner", "Entry", "Payload",
    "PayloadType", "Executor", "health_check", "summarize_bus",
    "trace_intents", "BusObserver", "TRACE_TYPES",
    "ElasticWorkerPool", "StandbyExecutor", "AgentKernel", "AGENT_IMAGES",
    "TrimPolicy", "VOTER_LIBRARY",
    "register_image", "CheckpointCoordinator", "Recoverable",
    "DeciderPolicy", "PolicyState", "RecoveryPlanner",
    "committed_unexecuted", "DirSnapshotStore", "MemorySnapshotStore",
    "SnapshotStore", "Supervisor", "RuleVoter", "StatVoter", "Voter",
    "VoteDecision", "STANDARD_RULES",
]
