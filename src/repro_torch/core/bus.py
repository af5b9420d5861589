"""The AgentBus: a linearizable, durable, typed shared log (paper §3, §4.1).

API (paper Fig. 4, extended for the batched data plane):

* ``append(payload) -> position`` — single linearizable append.
* ``append_many(payloads) -> positions`` — batched append: one transaction
  (SQLite) / one segment object (KV) / one lock acquisition (memory) per
  batch, so the per-append fixed cost (commit, round-trip, lock) is
  amortized across the batch. Positions are dense and contiguous: a batch
  occupies ``[positions[0], positions[0] + len(payloads))``.
* ``read(start, end=None, types=None) -> entries`` — range read with
  optional *push-down type filtering*: ``types`` becomes a SQL
  ``WHERE type IN (...)`` in ``SqliteBus``, a per-type position index probe
  in ``MemoryBus``, and an in-segment filter in ``KvBus``, so consumers
  that only care about a few entry types never materialize the rest.
* ``tail()`` — position one past the last entry.
* ``poll(start, filter, timeout)`` — blocking filtered read. The scan
  resumes from the previously observed tail on spurious wakeups (it never
  re-reads or re-filters the already-scanned ``[start, tail)`` suffix).
* ``trim(min_position)`` / ``compact()`` / ``trim_base()`` — the log
  lifecycle API (see below).

Log lifecycle (paper §3.2 recovery contract: "load latest snapshot + play
the log suffix"). The log is not append-only forever; it moves through a
four-state lifecycle per position range::

    append ──▶ checkpoint ──▶ trim ──▶ compact

1. **append** — entries land at dense positions; positions are immutable.
2. **checkpoint** — each component periodically persists its replayable
   state to the snapshot store and appends a ``Checkpoint`` entry
   ``{component_id, position, snapshot_key}``, making checkpoint progress
   itself replayable and auditable.
3. **trim** — a ``CheckpointCoordinator`` (``core.lifecycle``) computes the
   **low-water mark**: the minimum over every registered component's
   latest checkpointed position, further capped so that no
   committed-but-unexecuted intention (``recovery.committed_unexecuted``,
   the at-most-once WAL set) is ever dropped. ``trim(lwm)`` deletes
   entries below it: a SQL ``DELETE`` (SqliteBus), list + per-type-index
   pruning (MemoryBus), whole-segment deletion (KvBus — trim is
   segment-aligned, so the effective base may be below the requested
   minimum, never above). Positions are preserved: ``tail()`` and all
   surviving positions are unchanged by a trim.
4. **compact** — backend-specific space reclamation that preserves every
   surviving entry byte-for-byte: ``VACUUM`` for SQLite, adjacent-segment
   **merge** for KvBus (many one-batch objects become few large objects,
   bounding the object count of a week-long log; a bounded LRU segment
   cache keeps reader memory O(cache), not O(log)).

``trim_base()`` reports the first readable position. A ``read``/``poll``
that starts *below* the base raises the typed ``TrimmedError`` — the
caller is directed to the snapshot store: restore the latest snapshot and
resume from its position (``Recoverable.bootstrap`` in
``core.lifecycle`` is the uniform implementation of that path).
``trim``/``compact`` are control-plane operations invoked by a single
coordinator per bus; readers in other processes pick up an externally
advanced base on their next ``trim_base()`` refresh or reconnect.

Three backends (paper §4.1):

* ``MemoryBus``     — in-process, no durability; fastest. Maintains a
                      per-type entry index for O(matches) filtered reads.
* ``SqliteBus``     — one row per entry; durable across reboots of the
                      node. Appends use a cached tail + explicit-position
                      ``INSERT`` (no ``MAX(position)`` subquery per append);
                      cross-process races are resolved by retrying on the
                      primary-key conflict. Concurrent ``append_many``
                      calls **group-commit**: they coalesce into a single
                      transaction/fsync (leader/follower queue; positions
                      still assigned in arrival order). Payload bodies are
                      stored as compact binary blobs (``core.codec``) and
                      decoded lazily; decoded entries are cached per bus
                      instance (position -> Entry), so a body is parsed at
                      most once per process, not once per component per
                      step.
* ``KvBus``         — *segmented* log over a file-per-key store, emulating
                      a remote disaggregated KV store (the paper's
                      DynamoDB / "AnonDB" variant). Entries are grouped
                      into immutable multi-entry segment objects
                      (``seg-<start>.bin`` of binary entry frames, one per
                      ``append_many`` batch) served from ``mmap`` with
                      lazy body decode — an entry a reader never touches
                      is zero-copy;
                      a cached segment index (refreshed by one LIST) makes
                      ``tail()`` O(1) amortized instead of a file-existence
                      probe per position, and ``read`` one GET per segment
                      instead of one per entry. The optional injected
                      round-trip latency (``latency_s``, Fig-5 backend
                      sweep) is charged **per object fetched/stored**
                      (GET/PUT); LIST and cache hits are free, modeling a
                      client with a local manifest/segment cache.

All backends are linearizable for ``append``/``append_many`` (single atomic
assignment of a contiguous position range) and support concurrent
appenders/readers from multiple threads. ``SqliteBus``/``KvBus``
additionally support multiple *processes* (positions are assigned
transactionally / via atomic hard-link creation of segment objects).

Blocking waits (``poll``) use condition variables on ``MemoryBus`` and an
adaptive exponential backoff (start ~0.5 ms, cap ~20 ms) on the durable
backends, replacing fixed-interval sleep polling.

Entries returned by ``read``/``poll`` are **shared, logically immutable
records** on every backend (``MemoryBus`` stores them directly; the durable
backends cache decoded entries). Consumers must never mutate an entry's
payload body — copy first (the ``Executor`` deep-copies args before handing
them to user handlers for exactly this reason).
"""
from __future__ import annotations

import bisect
import json
import mmap
import os
import sqlite3
import threading
import time
import uuid
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from . import codec
from .entries import ALL_TYPES, Entry, Payload, PayloadType, _json_default
from .faults import CrashPoint, fault_point

#: Adaptive wait bounds for the durable backends' poll loops.
_BACKOFF_MIN = 0.0005
_BACKOFF_MAX = 0.02

TypeFilter = Optional[Sequence[PayloadType]]


def _parse_types(types: TypeFilter) -> Optional[frozenset]:
    if types is None:
        return None
    return frozenset(PayloadType.parse(t) for t in types)


class TrimmedError(RuntimeError):
    """A read started below the trim base: those entries were checkpointed
    and compacted away. Recover via the snapshot store — load the latest
    snapshot and resume reading from its position (``trim_base()`` is the
    first readable position)."""

    def __init__(self, requested: int, base: int) -> None:
        super().__init__(
            f"position {requested} is below the trim base {base}: the "
            f"prefix was checkpointed and trimmed — restore the latest "
            f"snapshot from the snapshot store and resume from its "
            f"position instead of replaying from 0")
        self.requested = requested
        self.base = base


class AgentBus:
    """Abstract AgentBus. Subclasses implement the storage methods."""

    def append(self, payload: Payload) -> int:
        """Append one payload; returns its assigned position. Sugar for a
        one-element ``append_many`` (same linearizability guarantee)."""
        return self.append_many([payload])[0]

    def append_many(self, payloads: Sequence[Payload]) -> List[int]:
        """Append a batch atomically; returns the (contiguous) positions."""
        raise NotImplementedError

    def read(self, start: int, end: Optional[int] = None,
             types: TypeFilter = None) -> List[Entry]:
        """Range read of ``[start, end)`` (``end=None`` = current tail),
        in position order. ``types`` is pushed down to the backend's native
        filter. Raises ``TrimmedError`` if ``start`` is below the trim
        base. Returned entries are shared immutable records — never mutate
        a payload body; copy first."""
        raise NotImplementedError

    def tail(self) -> int:
        """Position one past the last entry (0 for an empty log)."""
        raise NotImplementedError

    # -- lifecycle ----------------------------------------------------------
    def trim_base(self) -> int:
        """First readable position. Reads/polls below it raise
        ``TrimmedError``; recover through the snapshot store."""
        return getattr(self, "_trim_base", 0)

    def trim(self, min_position: int) -> int:
        """Drop entries below ``min_position`` (monotonic, idempotent;
        clamped to ``[trim_base, tail]``; may round *down* on backends
        whose storage granularity is coarser than one entry). Returns the
        new trim base. Positions and ``tail()`` are unaffected."""
        raise NotImplementedError

    def compact(self) -> int:
        """Reclaim space below/around surviving entries without changing
        their positions or contents. Returns a backend-specific count of
        compaction operations performed (0 = nothing to do)."""
        return 0

    def fork(self, at_position: int,
             path: Optional[str] = None) -> "AgentBus":
        """Fork the log at ``at_position``: returns a NEW independent bus
        holding this log's prefix ``[trim_base, at_position)`` —
        byte-identical entries at the same positions with the same
        timestamps, under the same trim base. Appends to either log after
        the fork are invisible to the other (divergence isolation both
        directions). ``at_position`` is clamped to ``tail()``; forking
        below the trim base raises ``TrimmedError`` — that prefix was
        checkpointed and trimmed away and cannot be forked.

        ``path`` names the child's storage (a fresh file / directory for
        the durable backends, on the same filesystem as the parent;
        derived from the parent's path when omitted; ignored by
        ``MemoryBus``). On ``KvBus`` the fork is **copy-on-write**:
        segment objects wholly below the fork point are shared with the
        parent by hard reference, only the boundary segment is rewritten
        (see ``docs/whatif.md``). ``NetBus`` forwards a ``fork`` op to
        the ``BusServer``, which forks its backing log server-side."""
        raise NotImplementedError

    def wait(self, known_tail: int, timeout: Optional[float] = None) -> bool:
        """Block until ``tail() > known_tail`` (condition-variable wake on
        MemoryBus, adaptive backoff on the durable backends). Returns True
        if the tail advanced, False on timeout."""
        return self._wait_for_append(known_tail, timeout)

    def poll(self, start: int, filter: Sequence[PayloadType] = ALL_TYPES,
             timeout: Optional[float] = None) -> List[Entry]:
        """Block until >=1 entry with type in ``filter`` exists at
        position >= ``start``; return all such entries in [start, tail).

        Returns [] on timeout. The scan cursor advances past suffixes that
        contained no matching entries, so a wakeup caused by non-matching
        appends never re-reads the suffix it already inspected.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        fs = tuple(PayloadType.parse(t) for t in filter)
        scan = start
        while True:
            tail = self.tail()
            if tail > scan:
                entries = self.read(scan, tail, types=fs)
                if entries:
                    return entries
                scan = tail  # nothing matched in [scan, tail): never rescan
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                return []
            self._wait_for_append(tail, remaining)

    # -- helpers -----------------------------------------------------------
    def _wait_for_append(self, known_tail: int,
                         timeout: Optional[float]) -> bool:
        """Wait until tail() > known_tail. Returns True if it advanced."""
        raise NotImplementedError

    def _backoff_wait(self, known_tail: int,
                      timeout: Optional[float]) -> bool:
        """Adaptive poll: exponential backoff between tail probes."""
        deadline = None if timeout is None else time.monotonic() + timeout
        wait = _BACKOFF_MIN
        while True:
            if self.tail() > known_tail:
                return True
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    # Final recheck before reporting a timeout: an append
                    # can land between the last tail probe above and the
                    # deadline expiring here. MemoryBus's Condition.wait_for
                    # rechecks its predicate after a timed-out wait; without
                    # this, the durable backends would report False for an
                    # append that IS already visible — a lost wakeup the
                    # caller has no way to distinguish from a quiet log.
                    return self.tail() > known_tail
                time.sleep(min(wait, remaining))
            else:
                time.sleep(wait)
            wait = min(wait * 2, _BACKOFF_MAX)

    def read_type(self, *types: PayloadType, start: int = 0) -> List[Entry]:
        """Convenience: filtered read of ``[start, tail)`` for the given
        payload types (push-down filter, like ``read(types=...)``)."""
        return self.read(start, types=types)

    def close(self) -> None:  # pragma: no cover - backend-specific
        """Release backend resources (connections, sockets). Idempotent;
        a no-op for backends that hold none."""
        pass


# ---------------------------------------------------------------------------
# In-memory backend
# ---------------------------------------------------------------------------

class MemoryBus(AgentBus):
    """In-process log with a per-type index for push-down filtered reads.

    ``trim`` drops the list prefix and prunes the per-type indexes; the
    remaining entries keep their original positions (``_trim_base`` is the
    position of ``_entries[0]``)."""

    def __init__(self) -> None:
        self._entries: List[Entry] = []
        self._trim_base = 0  # position of _entries[0]
        #: type -> (positions, entries) parallel sorted lists
        self._by_type: Dict[PayloadType, Tuple[List[int], List[Entry]]] = {}
        self._cond = threading.Condition()

    def append_many(self, payloads: Sequence[Payload]) -> List[int]:
        if not payloads:
            return []
        fault_point("memory.append.crash")
        with self._cond:
            base = self._trim_base + len(self._entries)
            now = time.time()
            positions = []
            for i, p in enumerate(payloads):
                e = Entry(base + i, now, p)
                self._entries.append(e)
                idx = self._by_type.setdefault(p.type, ([], []))
                idx[0].append(e.position)
                idx[1].append(e)
                positions.append(e.position)
            self._cond.notify_all()
            return positions

    def read(self, start: int, end: Optional[int] = None,
             types: TypeFilter = None) -> List[Entry]:
        fs = _parse_types(types)
        with self._cond:
            if start < self._trim_base:
                raise TrimmedError(start, self._trim_base)
            n = self._trim_base + len(self._entries)
            lo, hi = start, n if end is None else min(end, n)
            if lo >= hi:
                return []
            if fs is None:
                return list(self._entries[lo - self._trim_base:
                                          hi - self._trim_base])
            out: List[Entry] = []
            for t in fs:
                idx = self._by_type.get(t)
                if idx is None:
                    continue
                positions, ents = idx
                i = bisect.bisect_left(positions, lo)
                j = bisect.bisect_left(positions, hi)
                out.extend(ents[i:j])
            out.sort(key=lambda e: e.position)
            return out

    def tail(self) -> int:
        with self._cond:
            return self._trim_base + len(self._entries)

    def trim(self, min_position: int) -> int:
        with self._cond:
            tail = self._trim_base + len(self._entries)
            target = min(max(min_position, self._trim_base), tail)
            drop = target - self._trim_base
            if drop > 0:
                del self._entries[:drop]
                for positions, ents in self._by_type.values():
                    i = bisect.bisect_left(positions, target)
                    del positions[:i]
                    del ents[:i]
                self._trim_base = target
            return self._trim_base

    def fork(self, at_position: int,
             path: Optional[str] = None) -> "MemoryBus":
        """Prefix-copy fork (``path`` ignored — the child is in-process).
        Entry records are shared between parent and child: they are
        logically immutable on every backend, so sharing is safe and the
        copy is O(entries below the fork point) reference copies."""
        with self._cond:
            tail = self._trim_base + len(self._entries)
            at = min(at_position, tail)
            if at < self._trim_base:
                raise TrimmedError(at_position, self._trim_base)
            child = MemoryBus()
            child._trim_base = self._trim_base
            for e in self._entries[:at - self._trim_base]:
                child._entries.append(e)
                idx = child._by_type.setdefault(e.type, ([], []))
                idx[0].append(e.position)
                idx[1].append(e)
            return child

    def _wait_for_append(self, known_tail: int, timeout: Optional[float]) -> bool:
        with self._cond:
            return self._cond.wait_for(
                lambda: self._trim_base + len(self._entries) > known_tail,
                timeout=timeout)


# ---------------------------------------------------------------------------
# SQLite backend
# ---------------------------------------------------------------------------

class _PendingBatch:
    """One ``append_many`` call parked in the group-commit queue."""

    __slots__ = ("payloads", "event", "positions", "error")

    def __init__(self, payloads: Sequence[Payload]) -> None:
        self.payloads = payloads
        self.event = threading.Event()
        self.positions: Optional[List[int]] = None
        self.error: Optional[BaseException] = None


class SqliteBus(AgentBus):
    """Durable bus: one row per entry. Safe for multi-thread/multi-process use
    (WAL journal mode; position assignment is transactional).

    Appends keep a cached tail so position assignment is a plain ``INSERT``
    of explicit positions (no ``MAX(position)`` subquery); a concurrent
    appender in another process surfaces as a primary-key conflict, which
    refreshes the cached tail and retries.

    **Group commit** (``group_commit=True``): concurrent ``append_many``
    calls coalesce into one transaction. The first arriver becomes the
    *leader*: it drains the queue (its own batch plus everything that
    arrived meanwhile), commits the whole group in a single transaction,
    assigns each batch its contiguous position slice in queue-arrival
    order (linearizability is unchanged — the queue is FIFO and drains
    under one lock), signals the waiters, and loops until the queue is
    empty. A lone writer is its own leader with an empty queue, so the
    single-writer path costs exactly one transaction per batch — no added
    latency. ``group_window_s > 0`` additionally has the leader linger
    that long collecting stragglers before committing (trades append
    latency for fewer fsyncs under bursty concurrency; default 0 because
    the piggyback coalescing already wins whenever commits overlap).
    ``gc_commits``/``gc_batches`` count transactions vs batches so tests
    and the contention bench can audit the coalescing ratio.

    **Storage format**: payload bodies are stored as compact binary blobs
    (``codec.payload_blob``: one codec byte + msgpack-or-JSON body; the
    type lives in its own indexed column) and decoded **lazily** — ``read``
    returns ``LazyEntry`` whose body stays raw bytes until first access.
    Legacy rows holding JSON text decode through ``Payload.from_json``
    unchanged (SQLite type affinity keeps TEXT and BLOB values apart in
    the same column), and ``LOGACT_CODEC=json`` forces new rows back to
    the legacy text format. Decoded entries are cached per instance so a
    body is parsed at most once per process, not once per component per
    step.
    """

    _CACHE_MAX = 65536

    def __init__(self, path: str, group_commit: bool = True,
                 group_window_s: float = 0.0,
                 synchronous: str = "NORMAL") -> None:
        if synchronous.upper() not in ("OFF", "NORMAL", "FULL", "EXTRA"):
            raise ValueError(f"bad synchronous mode: {synchronous!r}")
        self._synchronous = synchronous.upper()
        self._path = path
        self._local = threading.local()
        self._append_lock = threading.Lock()
        self._cached_tail: Optional[int] = None  # next position to assign
        self._decode_cache: Dict[int, Entry] = {}
        self._cache_lock = threading.Lock()
        self._group_commit = group_commit
        self._gc_window = group_window_s
        self._gc_lock = threading.Lock()
        self._gc_queue: List[_PendingBatch] = []
        self._gc_leader = False
        self.gc_commits = 0  # transactions committed
        self.gc_batches = 0  # append_many batches those transactions carried
        conn = self._conn()
        conn.execute("PRAGMA journal_mode=WAL")  # persistent, set once
        conn.execute(
            "CREATE TABLE IF NOT EXISTS log ("
            " position INTEGER PRIMARY KEY,"
            " realtime_ts REAL NOT NULL,"
            " type TEXT NOT NULL,"
            " payload TEXT NOT NULL)")
        conn.execute("CREATE INDEX IF NOT EXISTS idx_type ON log(type)")
        # Lifecycle metadata (trim base) must survive reboots — an empty
        # table after a full trim is NOT position 0.
        conn.execute("CREATE TABLE IF NOT EXISTS meta ("
                     " key TEXT PRIMARY KEY, value TEXT NOT NULL)")
        conn.commit()
        self._trim_base = 0
        self.trim_base()  # load the durable base

    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self._path, timeout=30.0)
            # WAL + NORMAL is the standard throughput pairing: commits no
            # longer fsync the WAL on every transaction (the WAL is synced
            # at checkpoint), yet the database cannot be corrupted by a
            # crash. FULL fsyncs every commit — there group commit earns
            # its keep, one fsync covering every coalesced batch.
            # synchronous is per-connection, so set it here — every
            # thread gets its own connection.
            conn.execute(f"PRAGMA synchronous={self._synchronous}")
            self._local.conn = conn
        return conn

    @staticmethod
    def _encode_payload(p: Payload) -> "str | bytes":
        if codec.legacy_json_mode():
            return p.to_json()
        return codec.payload_blob(p)

    def append_many(self, payloads: Sequence[Payload]) -> List[int]:
        if not payloads:
            return []
        if not self._group_commit:
            pb = _PendingBatch(list(payloads))
            self._commit_group([pb])
            if pb.error is not None:
                raise pb.error
            return pb.positions
        pb = _PendingBatch(list(payloads))
        with self._gc_lock:
            self._gc_queue.append(pb)
            lead = not self._gc_leader
            if lead:
                self._gc_leader = True
        if lead:
            self._lead_group_commits()
        pb.event.wait()
        if pb.error is not None:
            raise pb.error
        return pb.positions

    def _lead_group_commits(self) -> None:
        """Group-commit leader loop: drain the queue, commit the group as
        one transaction, repeat until the queue is empty. Batches that
        arrive while a commit is in flight are picked up by the next lap —
        that overlap IS the coalescing."""
        while True:
            with self._gc_lock:
                group = self._gc_queue
                self._gc_queue = []
                if not group:
                    self._gc_leader = False
                    return
            if self._gc_window > 0:
                time.sleep(self._gc_window)  # linger for stragglers
                with self._gc_lock:
                    group.extend(self._gc_queue)
                    self._gc_queue = []
            try:
                self._commit_group(group)
            except BaseException as exc:  # pragma: no cover - defensive
                for pb in group:
                    if not pb.event.is_set():
                        pb.error = exc
                        pb.event.set()

    def _commit_group(self, group: List[_PendingBatch]) -> None:
        conn = self._conn()
        ts = time.time()
        # Encode up front so a bad payload fails only its own batch, not
        # the strangers coalesced with it.
        encoded: List[Tuple[_PendingBatch, List[Tuple[str, object]]]] = []
        for pb in group:
            try:
                encoded.append((pb, [(p.type.value, self._encode_payload(p))
                                     for p in pb.payloads]))
            except BaseException as exc:
                pb.error = exc
                pb.event.set()
        if not encoded:
            return
        with self._append_lock:
            while True:
                if self._cached_tail is None:
                    row = conn.execute(
                        "SELECT COALESCE(MAX(position)+1, 0) FROM log"
                    ).fetchone()
                    # a fully trimmed (empty) log resumes at the base
                    self._cached_tail = max(int(row[0]), self.trim_base())
                pos = self._cached_tail
                rows: List[Tuple[int, float, str, object]] = []
                slices: List[Tuple[_PendingBatch, int]] = []
                for pb, items in encoded:
                    slices.append((pb, pos))
                    for tval, blob in items:
                        rows.append((pos, ts, tval, blob))
                        pos += 1
                fault_point("sqlite.append.pre_txn")
                try:
                    with conn:  # ONE transaction for the whole group
                        conn.executemany(
                            "INSERT INTO log(position, realtime_ts, type, "
                            "payload) VALUES (?, ?, ?, ?)", rows)
                        fault_point("sqlite.append.mid_txn")
                except sqlite3.IntegrityError:
                    # Another process appended since we cached the tail.
                    self._cached_tail = None
                    continue
                fault_point("sqlite.append.post_txn")
                self._cached_tail = pos
                self.gc_commits += 1
                self.gc_batches += len(encoded)
                for pb, first in slices:
                    pb.positions = list(range(first,
                                              first + len(pb.payloads)))
                    pb.event.set()
                return

    def _decode(self, pos: int, ts: float, type_val: str,
                payload: "str | bytes") -> Entry:
        with self._cache_lock:
            e = self._decode_cache.get(pos)
            if e is not None:
                return e
        if isinstance(payload, bytes):
            e = codec.LazyEntry(pos, ts, codec.payload_from_blob(
                PayloadType.parse(type_val), payload))
        else:  # legacy JSON text row
            e = Entry(pos, ts, Payload.from_json(payload))
        with self._cache_lock:
            if len(self._decode_cache) >= self._CACHE_MAX:
                self._decode_cache.clear()  # simple epoch eviction
            self._decode_cache[pos] = e
        return e

    def read(self, start: int, end: Optional[int] = None,
             types: TypeFilter = None) -> List[Entry]:
        if start < self._trim_base:
            raise TrimmedError(start, self._trim_base)
        conn = self._conn()
        fs = _parse_types(types)
        sql = ("SELECT position, realtime_ts, type, payload FROM log "
               "WHERE position >= ?")
        params: List[object] = [start]
        if end is not None:
            sql += " AND position < ?"
            params.append(end)
        if fs is not None:
            sql += f" AND type IN ({','.join('?' * len(fs))})"
            params.extend(sorted(t.value for t in fs))
        sql += " ORDER BY position"
        rows = conn.execute(sql, params).fetchall()
        return [self._decode(p, ts, tv, pl) for p, ts, tv, pl in rows]

    def tail(self) -> int:
        """Position one past the last row (a fully trimmed empty table
        reports the durable trim base, not 0)."""
        row = self._conn().execute(
            "SELECT COALESCE(MAX(position)+1, 0) FROM log").fetchone()
        return max(int(row[0]), self._trim_base)

    def trim_base(self) -> int:
        """Durable trim base (refreshed from the meta table, so an
        externally advanced base is picked up by bootstrap-time callers;
        the hot read path checks the cached value)."""
        row = self._conn().execute(
            "SELECT value FROM meta WHERE key='trim_base'").fetchone()
        if row is not None:
            self._trim_base = max(self._trim_base, int(row[0]))
        return self._trim_base

    def trim(self, min_position: int) -> int:
        conn = self._conn()
        with self._append_lock:
            target = min(max(min_position, self.trim_base()), self.tail())
            if target > self._trim_base:
                fault_point("sqlite.trim.pre_txn")
                with conn:  # DELETE + base update in one transaction
                    conn.execute("DELETE FROM log WHERE position < ?",
                                 (target,))
                    fault_point("sqlite.trim.mid_txn")
                    conn.execute(
                        "INSERT OR REPLACE INTO meta(key, value) "
                        "VALUES ('trim_base', ?)", (str(target),))
                fault_point("sqlite.trim.post_txn")
                self._trim_base = target
                with self._cache_lock:
                    for p in [p for p in self._decode_cache if p < target]:
                        del self._decode_cache[p]
            return self._trim_base

    def compact(self) -> int:
        """Reclaim the file space of trimmed rows (VACUUM rewrites the
        database; safe in WAL mode, outside any transaction)."""
        conn = self._conn()
        conn.commit()
        try:
            conn.execute("VACUUM")
        except sqlite3.OperationalError:  # pragma: no cover - busy db
            return 0
        return 1

    def fork(self, at_position: int,
             path: Optional[str] = None) -> "SqliteBus":
        """Prefix-copy fork into a fresh database file at ``path`` (a
        derived sibling path when omitted; must not already hold a log).
        Rows are copied column-for-column — the payload blobs/text land in
        the child byte-identical — along with the durable trim base."""
        conn = self._conn()
        with self._append_lock:
            base = self.trim_base()
            at = min(at_position, self.tail())
            if at < base:
                raise TrimmedError(at_position, base)
            rows = conn.execute(
                "SELECT position, realtime_ts, type, payload FROM log "
                "WHERE position < ? ORDER BY position", (at,)).fetchall()
        if path is None:
            path = f"{self._path}.fork-{at}-{uuid.uuid4().hex[:8]}"
        child = SqliteBus(path, group_commit=self._group_commit,
                          group_window_s=self._gc_window,
                          synchronous=self._synchronous)
        cc = child._conn()
        with cc:  # rows + base land atomically: no half-forked child
            cc.executemany(
                "INSERT INTO log(position, realtime_ts, type, payload) "
                "VALUES (?, ?, ?, ?)", rows)
            if base > 0:
                cc.execute("INSERT OR REPLACE INTO meta(key, value) "
                           "VALUES ('trim_base', ?)", (str(base),))
        child._trim_base = base
        child._cached_tail = None
        return child

    def _wait_for_append(self, known_tail: int, timeout: Optional[float]) -> bool:
        return self._backoff_wait(known_tail, timeout)

    def close(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None


# ---------------------------------------------------------------------------
# Disaggregated KV backend ("AnonDB" emulation) — segmented log
# ---------------------------------------------------------------------------

def _torn_blob(blob: bytes, act) -> bytes:
    """Truncate a segment blob mid-frame, the way a crashed writer (or a
    lossy store) leaves it. The default cut drops the last 7 bytes, which
    always lands inside the final entry's header or body, so the codec
    must reject the remainder; ``act.arg`` overrides with a fraction."""
    if act.arg:
        keep = int(len(blob) * float(act.arg))
    else:
        keep = len(blob) - 7
    return blob[:max(1, min(keep, len(blob) - 1))]


class KvBus(AgentBus):
    """Segmented log over a directory, emulating a remote KV/object store.

    Each ``append_many`` batch becomes one immutable segment object
    ``seg-<start>.bin`` holding the whole batch as concatenated binary
    entry frames (``core.codec``). Position assignment is a compare-and-set
    on the segment's start position: the segment is staged to a temp file
    and published with an atomic ``os.link`` — if the link target exists,
    another appender won the slot and we refresh the index and retry at
    the new tail. Because segments only become visible fully written,
    readers never observe partial data.

    Binary segments are served from ``mmap``: ``_fetch_segment`` maps the
    object and decodes only the 23-byte frame headers — bodies stay raw
    buffer slices over the mapping (``LazyEntry``), so an entry a reader
    never touches (filtered out by ``types=``, skipped by a fold, or
    merely counted by ``_refresh``) is **zero-copy**: no body bytes are
    read, no decode happens. The memoryview slices pin the mapping, and a
    POSIX mapping outlives unlinking, so a segment trimmed by another
    instance stays readable until its entries are released. Legacy
    ``seg-<start>.json`` objects (whole-batch JSON arrays) remain fully
    readable; when both names exist for one start (a crash mid format
    migration) the binary object wins. ``LOGACT_CODEC=json`` forces new
    segments back to the legacy JSON format.

    A per-instance segment index (start -> entry count) is refreshed with a
    single directory LIST; ``tail()`` is served from the index, and reads
    fetch (and cache) one object per segment rather than one per entry.

    ``latency_s`` injects a synthetic round-trip per *object* GET/PUT, for
    the geo-distributed-backend sweep (paper Fig. 5 bottom): one PUT per
    batch appended, one GET per segment fetched. LIST and segment-cache
    hits are free (a local manifest hint). ``rtt_ops`` counts charged
    round-trips so benchmarks can audit the model.

    Lifecycle: ``trim`` deletes whole segment objects strictly below the
    requested position (segment-aligned — the effective base is the end of
    the last fully dropped segment) and persists the base in a tiny
    ``trim-base.json`` marker object (a manifest metadata write, charged
    like LIST: free). ``compact`` merges runs of adjacent segments into
    single objects of up to ``max_segment_entries`` entries (one PUT per
    merged object, published with an atomic replace), so a week-long log
    of one-batch objects collapses to a bounded object count. The decoded
    segment cache is a **bounded LRU** (``cache_segments`` segments);
    evicted segments are simply re-fetched (one charged GET) on the next
    read, keeping reader memory O(cache) on million-entry logs.
    """

    _MARKER = "trim-base.json"

    def __init__(self, root: str, latency_s: float = 0.0,
                 fsync: bool = False, cache_segments: int = 256) -> None:
        self._root = root
        self._latency = latency_s
        self._fsync = fsync
        os.makedirs(root, exist_ok=True)
        self._lock = threading.RLock()
        self._segments: Dict[int, int] = {}      # start -> n entries
        self._seg_ext: Dict[int, str] = {}       # start -> "bin" | "json"
        self._starts: List[int] = []             # sorted segment starts
        #: bounded LRU of decoded segments (start -> entries)
        self._seg_cache: "OrderedDict[int, List[Entry]]" = OrderedDict()
        self._cache_max = max(1, cache_segments)
        self._trim_base = 0
        self._load_marker()
        self._tail = self._trim_base
        self.rtt_ops = 0  # charged GET/PUT round-trips
        self.quarantined = 0  # torn segments renamed aside, never served

    def _seg_path(self, start: int, ext: str) -> str:
        return os.path.join(self._root, f"seg-{start:012d}.{ext}")

    def _seg_key(self, start: int) -> str:
        """Path of an existing segment (its recorded format; new-format
        default for segments this instance hasn't indexed)."""
        return self._seg_path(start, self._seg_ext.get(start, "bin"))

    @staticmethod
    def _encode_segment(entries: List[Entry]) -> bytes:
        if codec.legacy_json_mode():
            return json.dumps([e.to_dict() for e in entries],
                              sort_keys=True, default=_json_default).encode()
        return codec.encode_entries(entries)

    @staticmethod
    def _segment_ext() -> str:
        return "json" if codec.legacy_json_mode() else "bin"

    # -- trim-base marker (manifest metadata; free, like LIST) --------------
    def _load_marker(self) -> None:
        try:
            with open(os.path.join(self._root, self._MARKER)) as f:
                self._trim_base = max(self._trim_base,
                                      int(json.load(f)["base"]))
        except (FileNotFoundError, ValueError, KeyError):
            pass

    def _write_marker(self) -> None:
        path = os.path.join(self._root, self._MARKER)
        tmp = os.path.join(self._root, f".tmp-{uuid.uuid4().hex}")
        with open(tmp, "w") as f:
            json.dump({"base": self._trim_base}, f)
        os.replace(tmp, path)

    # -- bounded LRU segment cache ------------------------------------------
    def _cache_get(self, start: int) -> Optional[List[Entry]]:
        entries = self._seg_cache.get(start)
        if entries is not None:
            self._seg_cache.move_to_end(start)
        return entries

    def _cache_put(self, start: int, entries: List[Entry]) -> None:
        self._seg_cache[start] = entries
        self._seg_cache.move_to_end(start)
        while len(self._seg_cache) > self._cache_max:
            self._seg_cache.popitem(last=False)

    def _pay(self, ops: int) -> None:
        """Sleep the injected latency for ``ops`` charged round-trips.
        Called OUTSIDE the instance lock so concurrent clients' round-trips
        overlap, as they would against a real remote store."""
        if ops > 0 and self._latency > 0:
            time.sleep(self._latency * ops)

    def _fetch_segment(self, start: int) -> Optional[List[Entry]]:
        """GET one segment object (counts one RTT; the latency is paid by
        the caller outside the lock). Binary segments are mmap'd and
        header-decoded only — bodies stay lazy slices over the mapping."""
        self.rtt_ops += 1
        ext = self._seg_ext.get(start)
        for e in ((ext,) if ext else ("bin", "json")):
            path = self._seg_path(start, e)
            if e == "bin":
                try:
                    with open(path, "rb") as f:
                        mm = mmap.mmap(f.fileno(), 0,
                                       access=mmap.ACCESS_READ)
                except FileNotFoundError:
                    continue
                try:
                    # The LazyPayload slices pin the mapping; the mapping
                    # outlives a concurrent unlink (POSIX), so
                    # trimmed-under-us segments stay readable until their
                    # entries are released.
                    entries = codec.decode_entries(memoryview(mm))
                except codec.CodecError:
                    self._quarantine(start, path)
                    continue
                self._seg_ext[start] = "bin"
                return entries
            try:
                with open(path, "rb") as f:
                    data = f.read()
            except FileNotFoundError:
                continue
            try:
                rows = json.loads(data.decode())
            except ValueError:
                self._quarantine(start, path)
                continue
            self._seg_ext[start] = "json"
            return [Entry.from_dict(r) for r in rows]
        return None

    def _quarantine(self, start: int, path: str) -> None:
        """Rename a torn segment object aside (``quar-`` prefix, invisible
        to ``_refresh``) so it is never served as entries and the start
        slot reopens for a clean republish. A torn object can only be an
        unacknowledged publish — its writer died before ``append_many``
        returned — so dropping it loses nothing a client was promised."""
        quar = os.path.join(self._root, "quar-" + os.path.basename(path))
        try:
            os.replace(path, quar)
        except OSError:  # pragma: no cover - raced deletion
            pass
        self._seg_ext.pop(start, None)
        self.quarantined += 1

    def _refresh(self) -> int:
        """LIST the store and reconcile the segment index: pull segments we
        haven't seen (free LIST; one charged GET per new segment, which
        primes the read cache) and drop segments another instance trimmed
        or compacted away. Returns the number of GETs charged."""
        ops = 0
        try:
            names = os.listdir(self._root)
        except FileNotFoundError:  # pragma: no cover - root removed
            return ops
        present: Dict[int, str] = {}
        for n in names:
            if not n.startswith("seg-"):
                continue
            if n.endswith(".bin"):
                present[int(n[4:16])] = "bin"  # binary wins when both exist
            elif n.endswith(".json"):
                present.setdefault(int(n[4:16]), "json")
        gone = [s for s in self._segments if s not in present]
        if gone:
            # Another instance trimmed or compacted. Merge compaction
            # rewrites surviving starts in place, so every cached count
            # is suspect: rebuild the index from scratch (rare — only the
            # non-coordinating instance ever takes this path).
            self._segments.clear()
            self._seg_ext.clear()
            self._seg_cache.clear()
            self._load_marker()
        changed = bool(gone)
        self._seg_ext.update(present)
        for s in sorted(present.keys() - self._segments.keys()):
            entries = self._fetch_segment(s)
            ops += 1
            if entries is None:  # pragma: no cover - raced deletion
                continue
            self._segments[s] = len(entries)
            self._cache_put(s, entries)
            changed = True
        if changed:
            # Drop compaction leftovers: a crash between the merged-object
            # publish and the tail unlinks (kv.compact.post_replace) leaves
            # segments whose whole range a predecessor already covers;
            # serving them would duplicate positions. Finish the dead
            # compactor's work here.
            max_end = -1
            for s in sorted(self._segments):
                end = s + self._segments[s]
                if end <= max_end:
                    try:
                        os.unlink(self._seg_key(s))
                    except FileNotFoundError:  # pragma: no cover - raced
                        pass
                    del self._segments[s]
                    self._seg_ext.pop(s, None)
                    self._seg_cache.pop(s, None)
                    continue
                max_end = max(max_end, end)
            self._starts = sorted(self._segments)
            if self._starts:
                last = self._starts[-1]
                self._tail = max(self._trim_base,
                                 last + self._segments[last])
            else:
                self._tail = self._trim_base
        return ops

    def append_many(self, payloads: Sequence[Payload]) -> List[int]:
        if not payloads:
            return []
        ops = 0
        with self._lock:
            ops += self._refresh()
            ext = self._segment_ext()
            while True:
                start = self._tail
                now = time.time()
                entries = [Entry(start + i, now, p)
                           for i, p in enumerate(payloads)]
                blob = self._encode_segment(entries)
                fault_point("kv.append.pre_stage")
                tmp = os.path.join(self._root, f".tmp-{uuid.uuid4().hex}")
                act = fault_point("kv.append.torn_stage")
                if act is not None:
                    # die mid-stage: a truncated temp object, never linked
                    with open(tmp, "wb") as f:
                        f.write(_torn_blob(blob, act))
                    raise CrashPoint(act.point, act.at_hit)
                fd = os.open(tmp, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                try:
                    os.write(fd, blob)
                    if self._fsync:
                        os.fsync(fd)
                finally:
                    os.close(fd)
                self.rtt_ops += 1  # one PUT per publish attempt
                ops += 1
                fault_point("kv.append.pre_link")
                act = fault_point("kv.append.torn_publish")
                if act is not None:
                    # the store acked a partial object under the final
                    # name (torn publish): readers must quarantine it
                    with open(self._seg_path(start, ext), "wb") as f:
                        f.write(_torn_blob(blob, act))
                    os.unlink(tmp)
                    raise CrashPoint(act.point, act.at_hit)
                try:
                    # atomic CAS publish; a legacy-format object at the
                    # same start also loses us the race (same position)
                    if os.path.exists(self._seg_path(
                            start, "json" if ext == "bin" else "bin")):
                        raise FileExistsError
                    os.link(tmp, self._seg_path(start, ext))
                except FileExistsError:
                    os.unlink(tmp)
                    ops += self._refresh()  # lost the race; retry at tail
                    continue
                os.unlink(tmp)
                fault_point("kv.append.post_link")
                self._segments[start] = len(entries)
                self._seg_ext[start] = ext
                self._cache_put(start, entries)
                self._starts.append(start)
                self._tail = start + len(entries)
                positions = [e.position for e in entries]
                break
        self._pay(ops)
        return positions

    def read(self, start: int, end: Optional[int] = None,
             types: TypeFilter = None) -> List[Entry]:
        fs = _parse_types(types)
        ops = 0
        with self._lock:
            if start < self._trim_base:
                raise TrimmedError(start, self._trim_base)
            if end is None or end > self._tail:
                ops += self._refresh()
                # _refresh may have learned of an externally advanced base
                # (segments trimmed by another instance): re-check, or the
                # caller would silently get partial data instead of being
                # directed to the snapshot store.
                if start < self._trim_base:
                    raise TrimmedError(start, self._trim_base)
            out: List[Entry] = []
            i = bisect.bisect_right(self._starts, start) - 1
            if i < 0:
                i = 0
            for s in self._starts[i:]:
                if end is not None and s >= end:
                    break
                entries = self._cache_get(s)
                if entries is None:  # evicted from the bounded LRU
                    entries = self._fetch_segment(s) or []
                    ops += 1
                    self._cache_put(s, entries)
                for e in entries:
                    if e.position < start:
                        continue
                    if end is not None and e.position >= end:
                        break
                    if fs is None or e.type in fs:
                        out.append(e)
        self._pay(ops)
        return out

    def tail(self) -> int:
        """Position one past the last entry, from the cached segment index
        (refreshed by one free LIST; new segments cost one charged GET
        each, which primes the read cache)."""
        with self._lock:
            ops = self._refresh()
            t = self._tail
        self._pay(ops)
        return t

    def trim_base(self) -> int:
        """First readable position, re-read from the durable marker object
        so an externally advanced base is picked up."""
        with self._lock:
            self._load_marker()
            return self._trim_base

    def trim(self, min_position: int) -> int:
        """Segment-aligned trim: deletes every segment that lies entirely
        below ``min_position``; the new base is the end of the last dropped
        segment (never above ``min_position``).

        The base marker is advanced **before** any segment is unlinked: a
        crash mid-unlink then leaves only invisible garbage below the new
        base (reclaimed by a later trim), never a gap of acknowledged
        entries above it. The old order (unlink, then marker) could lose
        the positions of already-deleted segments if the trimmer died
        before the marker write."""
        ops = 0
        with self._lock:
            ops += self._refresh()
            target = min(min_position, self._tail)
            base = self._trim_base
            drop: List[int] = []
            for s in self._starts:
                n = self._segments[s]
                if s + n > target:
                    break  # starts are sorted; later segments survive too
                drop.append(s)
                base = max(base, s + n)
            fault_point("kv.trim.pre_marker")
            if base != self._trim_base:
                self._trim_base = base
                self._write_marker()
            fault_point("kv.trim.post_marker")
            for s in drop:
                try:
                    os.unlink(self._seg_key(s))
                except FileNotFoundError:  # pragma: no cover - raced
                    pass
                del self._segments[s]
                self._seg_ext.pop(s, None)
                self._seg_cache.pop(s, None)
            if drop:
                self._starts = sorted(self._segments)
            new_base = self._trim_base
        self._pay(ops)
        return new_base

    def compact(self, max_segment_entries: int = 256) -> int:
        """Merge runs of adjacent segments into single objects of up to
        ``max_segment_entries`` entries. Entries keep their positions,
        timestamps, and order byte-for-byte; each merged object costs one
        PUT (plus GETs for segments not in cache). Returns the number of
        merged objects written."""
        merged = 0
        ops = 0
        with self._lock:
            ops += self._refresh()
            i = 0
            while i < len(self._starts):
                group = [self._starts[i]]
                total = self._segments[group[0]]
                j = i + 1
                while (j < len(self._starts)
                       and total + self._segments[self._starts[j]]
                       <= max_segment_entries):
                    group.append(self._starts[j])
                    total += self._segments[self._starts[j]]
                    j += 1
                if len(group) > 1:
                    entries: List[Entry] = []
                    for s in group:
                        es = self._cache_get(s)
                        if es is None:
                            es = self._fetch_segment(s) or []
                            ops += 1
                        entries.extend(es)
                    blob = self._encode_segment(entries)
                    ext = self._segment_ext()
                    tmp = os.path.join(self._root,
                                       f".tmp-{uuid.uuid4().hex}")
                    with open(tmp, "wb") as f:
                        f.write(blob)
                        if self._fsync:
                            os.fsync(f.fileno())
                    fault_point("kv.compact.pre_replace")
                    # atomic replace: readers see either the old first
                    # segment or the full merged one, never a partial
                    old_ext = self._seg_ext.get(group[0], ext)
                    os.replace(tmp, self._seg_path(group[0], ext))
                    fault_point("kv.compact.post_replace")
                    if old_ext != ext:  # format migration: drop the old
                        try:  # name (readers prefer .bin when both exist)
                            os.unlink(self._seg_path(group[0], old_ext))
                        except FileNotFoundError:  # pragma: no cover
                            pass
                    self.rtt_ops += 1  # one PUT per merged object
                    ops += 1
                    for s in group[1:]:
                        try:
                            os.unlink(self._seg_key(s))
                        except FileNotFoundError:  # pragma: no cover
                            pass
                        del self._segments[s]
                        self._seg_ext.pop(s, None)
                        self._seg_cache.pop(s, None)
                    self._segments[group[0]] = len(entries)
                    self._seg_ext[group[0]] = ext
                    self._cache_put(group[0], entries)
                    self._starts = sorted(self._segments)
                    merged += 1
                    i = self._starts.index(group[0]) + 1
                else:
                    i += 1
        self._pay(ops)
        return merged

    def fork(self, at_position: int, path: Optional[str] = None) -> "KvBus":
        """Copy-on-write fork, O(segments above ``at_position``).

        Segments wholly below the fork point are shared with the parent by
        **hard link** (free: no data copied; safe because segment objects
        are immutable — the parent's trim unlinks only its own name and
        compaction publishes replacements via ``os.replace``, so a shared
        inode is never mutated in place). Only the *boundary* segment —
        the one ``at_position`` splits — is re-encoded with the entries
        below the fork point (one PUT). The child is staged in a sibling
        temp directory and published with one atomic ``os.rename``: a
        crash anywhere mid-fork (``kv.fork.boundary_rewrite`` /
        ``kv.fork.pre_publish``) leaves the parent untouched and no child
        at the target path, only an invisible staging dir.

        ``fork_stats`` on the child (and ``last_fork_stats`` on the
        parent) report ``{"shared", "rewritten", "at"}`` segment counts so
        benchmarks and property tests can audit the sharing ratio."""
        ops = 0
        with self._lock:
            ops += self._refresh()
            at = min(at_position, self._tail)
            if at < self._trim_base:
                raise TrimmedError(at_position, self._trim_base)
            root = path or f"{self._root}-fork-{at}-{uuid.uuid4().hex[:8]}"
            parent_dir = os.path.dirname(os.path.abspath(root))
            os.makedirs(parent_dir, exist_ok=True)
            stage = f"{root}.tmp-{uuid.uuid4().hex}"
            os.makedirs(stage)
            shared = rewritten = 0
            for s in self._starts:
                if s >= at:
                    break  # starts are sorted; nothing later is below at
                n = self._segments[s]
                ext = self._seg_ext.get(s, "bin")
                if s + n <= at:
                    os.link(self._seg_path(s, ext),
                            os.path.join(stage, f"seg-{s:012d}.{ext}"))
                    shared += 1
                    continue
                # boundary segment: only entries below the fork survive
                entries = self._cache_get(s)
                if entries is None:
                    entries = self._fetch_segment(s) or []
                    ops += 1
                keep = [e for e in entries if e.position < at]
                blob = self._encode_segment(keep)
                bpath = os.path.join(
                    stage, f"seg-{s:012d}.{self._segment_ext()}")
                act = fault_point("kv.fork.boundary_rewrite")
                if act is not None and act.op == "torn":
                    # power cut mid-rewrite: a truncated boundary object
                    # in the staging dir, which is never published
                    with open(bpath, "wb") as f:
                        f.write(_torn_blob(blob, act))
                    raise CrashPoint(act.point, act.at_hit)
                with open(bpath, "wb") as f:
                    f.write(blob)
                    if self._fsync:
                        os.fsync(f.fileno())
                self.rtt_ops += 1  # one PUT for the rewritten boundary
                ops += 1
                rewritten += 1
            with open(os.path.join(stage, self._MARKER), "w") as f:
                json.dump({"base": self._trim_base}, f)
            fault_point("kv.fork.pre_publish")
            os.rename(stage, root)  # atomic publish of the whole child
            self.last_fork_stats = {"shared": shared,
                                    "rewritten": rewritten, "at": at}
        self._pay(ops)
        child = KvBus(root, latency_s=self._latency, fsync=self._fsync,
                      cache_segments=self._cache_max)
        child.fork_stats = dict(self.last_fork_stats)
        return child

    def _wait_for_append(self, known_tail: int, timeout: Optional[float]) -> bool:
        return self._backoff_wait(known_tail, timeout)


def make_bus(backend: str = "memory", path: Optional[str] = None,
             **kw) -> AgentBus:
    """Factory. backend in {'memory', 'sqlite', 'kv', 'net'}.

    For ``'net'``, ``path`` is the bus server address (``"host:port"``)
    and ``kw`` is forwarded to ``NetBus`` (client_id, role, timeouts)."""
    if backend == "memory":
        return MemoryBus()
    if backend == "sqlite":
        assert path, "sqlite backend needs a path"
        return SqliteBus(path, **kw)
    if backend == "kv":
        assert path, "kv backend needs a root directory"
        return KvBus(path, **kw)
    if backend == "net":
        assert path, "net backend needs a host:port address"
        from .netbus import NetBus  # function-level: netbus imports this module
        return NetBus(path, **kw)
    raise ValueError(f"unknown bus backend: {backend}")
