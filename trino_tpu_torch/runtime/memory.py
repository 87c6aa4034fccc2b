"""Memory accounting: hierarchical byte budgets for device residency.

Reference: lib/trino-memory-context (LocalMemoryContext.java:18,31 —
setBytes returns a future that blocks the driver when the pool is full;
AggregatedMemoryContext.java:16 rolls children up),
memory/ClusterMemoryManager.java:92 (pool enforcement + OOM kill) and
memory/LowMemoryKiller.java (total-reservation victim policy).

Device shape: device-memory reservations are made by the executor BEFORE uploading
table columns or allocating operator capacities, from *static* estimates
(capacities are static by design — the capacity protocol makes operator
footprints knowable up front, something the reference's growable hash
tables cannot do).  Exceeding the budget raises MemoryExceeded, which the
engine catches to re-plan with the out-of-core partitioned executor
(exec/spill.py) — the moral analogue of the reference's revocable memory +
spill path (SpillableHashAggregationBuilder.java:55).

Governance plane (this module's runtime half):

- NodeMemoryPool — one per worker, capacity from the
  `memory.heap-headroom-per-node` config key.  Task executors reserve
  through it via leases; a reserve() against a full pool PARKS the caller
  (blocked-on-memory, the reference's non-immediate setBytes future)
  until a peer lease releases, with a timeout escalation.  Leases marked
  revocable can be force-shrunk (revoke_query) — the holder spills via
  the partitioned executor instead of holding its full footprint.
- ClusterMemoryManager — coordinator-side arbitration over the node-pool
  snapshots workers attach to their heartbeat /v1/info responses.  A node
  under sustained pressure first triggers revocation of the largest
  revocable holder; only when no revocable bytes remain does it kill the
  query with the largest cluster-wide total reservation (Trino's
  TotalReservationLowMemoryKiller policy).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

__all__ = [
    "MemoryExceeded",
    "MemoryContext",
    "QueryMemoryPool",
    "NodeMemoryPool",
    "MemoryLease",
    "ClusterMemoryManager",
]

from ..utils import flightrecorder as _fr
from ..utils.metrics import GLOBAL as _METRICS

# over-free detection (a double-free that silently clamps to zero hides a
# real accounting bug and un-bounds the pool): counted, never masked
_UNDERFLOWS = _METRICS.counter(
    "trino_tpu_memory_accounting_underflow_total",
    "free() calls that would have driven a pool balance negative",
)
# blocked-on-memory wait times (reference: the blocked-driver time the
# MemoryPool futures accumulate)
_BLOCKED_SECONDS = _METRICS.histogram(
    "trino_tpu_memory_blocked_seconds",
    "Time reservations spent parked waiting for pool bytes",
    buckets=(0.001, 0.01, 0.05, 0.25, 1.0, 5.0, 30.0, 120.0),
)
# per-pool gauges (reference: MemoryPoolMXBean's free/reserved bytes the
# cluster manager polls), refreshed on every snapshot()
_POOL_CAPACITY = _METRICS.gauge(
    "trino_tpu_memory_pool_capacity",
    "Pool byte budget",
    labelnames=("pool",),
)
_POOL_RESERVED = _METRICS.gauge(
    "trino_tpu_memory_pool_reserved",
    "Bytes currently reserved in the pool",
    labelnames=("pool",),
)
_POOL_BLOCKED = _METRICS.gauge(
    "trino_tpu_memory_pool_blocked_reservations",
    "Reservations parked waiting for pool bytes",
    labelnames=("pool",),
)


class MemoryExceeded(RuntimeError):
    def __init__(self, requested: int, used: int, budget: int, what: str = ""):
        self.requested = requested
        self.used = used
        self.budget = budget
        super().__init__(
            f"memory budget exceeded: need {requested} bytes ({what}), "
            f"used {used} of {budget}"
        )


def _count_underflow(pool_name: str, overshoot: int) -> None:
    _UNDERFLOWS.inc()
    import sys

    print(
        f"memory accounting underflow in pool {pool_name!r}: "
        f"freed {overshoot} bytes more than reserved (double-free?)",
        file=sys.stderr,
        flush=True,
    )


class QueryMemoryPool:
    """One query's byte pool (reference: per-query MemoryPool slice).

    With a `parent` NodeMemoryPool the query pool is LAYERED under the
    node's budget: reserve() first checks the query budget, then takes the
    bytes from the node pool (blocking there when the node is full —
    blocked-on-memory rides up through the hierarchy)."""

    def __init__(
        self,
        budget: Optional[int],
        parent: Optional["NodeMemoryPool"] = None,
        query_id: str = "",
        name: str = "query",
    ):
        self.budget = budget  # None = unlimited
        self.parent = parent
        self.query_id = query_id
        self.name = name
        self.used = 0
        self.peak = 0
        self._lock = threading.Lock()

    def reserve(self, nbytes: int, what: str = "") -> None:
        with self._lock:
            if self.budget is not None and self.used + nbytes > self.budget:
                raise MemoryExceeded(nbytes, self.used, self.budget, what)
            self.used += nbytes
            self.peak = max(self.peak, self.used)
        if self.parent is not None:
            try:
                self.parent.reserve(
                    self.query_id or self.name, nbytes, what=what
                ).detach()
            except MemoryExceeded:
                with self._lock:
                    self.used -= nbytes
                raise

    def free(self, nbytes: int) -> None:
        with self._lock:
            remaining = self.used - nbytes
            if remaining < 0:
                # a silent max(0, ...) clamp here masked double-frees; the
                # balance still floors at zero, but loudly and counted
                _count_underflow(self.name, -remaining)
                nbytes = self.used
                remaining = 0
            self.used = remaining
        if self.parent is not None and nbytes:
            self.parent.free(self.query_id or self.name, nbytes)


class MemoryContext:
    """Named child of a pool (reference: LocalMemoryContext under an
    AggregatedMemoryContext); tracks its own reservation so set() is
    idempotent-adjusting like the reference's setBytes."""

    def __init__(self, pool: QueryMemoryPool, name: str):
        self.pool = pool
        self.name = name
        self.reserved = 0

    def set(self, nbytes: int) -> None:
        delta = nbytes - self.reserved
        if delta > 0:
            self.pool.reserve(delta, self.name)
        else:
            self.pool.free(-delta)
        self.reserved = nbytes

    def close(self) -> None:
        self.set(0)


class MemoryLease:
    """One reservation held against a NodeMemoryPool.  release() is
    idempotent (task-finish and task-delete may both call it); revoke()
    shrinks a revocable lease to its spilled footprint and fires the
    holder's on_revoke hook so it degrades to partitioned execution."""

    def __init__(
        self,
        pool: "NodeMemoryPool",
        query_id: str,
        nbytes: int,
        revocable: bool,
        on_revoke: Optional[Callable[[], None]] = None,
    ):
        self.pool = pool
        self.query_id = query_id
        self.nbytes = nbytes
        self.revocable = revocable
        self.revoked = False
        self.released = False
        self.on_revoke = on_revoke

    def release(self) -> None:
        self.pool._release(self)

    def detach(self) -> "MemoryLease":
        """Mark this lease as managed by raw free() calls instead of
        release() — used by QueryMemoryPool layering, where frees flow back
        through the query pool's own accounting."""
        self.released = True  # release() becomes a no-op
        return self


class NodeMemoryPool:
    """A worker node's byte budget (reference: the per-node general
    MemoryPool ClusterMemoryManager polls).  reserve() on a full pool
    BLOCKS the calling task thread — parked, visible as blocked>0 in
    snapshot() — until another query frees bytes or `timeout_s` elapses
    (escalating to MemoryExceeded).  set_capacity() supports mid-query
    shrink (MEMORY_PRESSURE chaos) and wakes waiters on grow."""

    def __init__(self, capacity_bytes: int, name: str = "node"):
        self.capacity = int(capacity_bytes)
        self.name = name
        self.reserved = 0
        self.peak = 0
        self.blocked = 0  # reservations currently parked
        self.blocked_ms_total = 0.0
        self.revocations = 0  # revoke_query sweeps that freed bytes
        self._cond = threading.Condition()
        self._leases: list[MemoryLease] = []

    # ------------------------------------------------------------- reserve
    def reserve(
        self,
        query_id: str,
        nbytes: int,
        revocable: bool = False,
        timeout_s: Optional[float] = None,
        what: str = "",
        on_block: Optional[Callable[[], None]] = None,
        on_unblock: Optional[Callable[[], None]] = None,
        on_revoke: Optional[Callable[[], None]] = None,
        abort: Optional[Callable[[], bool]] = None,
    ) -> MemoryLease:
        nbytes = int(nbytes)
        lease = MemoryLease(self, query_id, nbytes, revocable, on_revoke)
        blocked_at: Optional[float] = None

        def _unpark() -> None:
            self.blocked -= 1
            waited = time.monotonic() - blocked_at
            self.blocked_ms_total += waited * 1e3
            _BLOCKED_SECONDS.observe(waited)
            if on_unblock is not None:
                on_unblock()

        with self._cond:
            if nbytes > self.capacity:
                # larger than the whole pool: waiting can never succeed
                raise MemoryExceeded(nbytes, self.reserved, self.capacity, what)
            deadline = (
                None if timeout_s is None else time.monotonic() + timeout_s
            )
            while self.reserved + nbytes > self.capacity:
                if blocked_at is None:
                    blocked_at = time.monotonic()
                    self.blocked += 1
                    _fr.record(
                        "memory_block", node=self.name, query_id=query_id,
                        bytes=nbytes, what=what,
                    )
                    if on_block is not None:
                        on_block()
                if abort is not None and abort():
                    _unpark()
                    raise RuntimeError("task canceled")
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        _unpark()
                        waited = time.monotonic() - blocked_at
                        raise MemoryExceeded(
                            nbytes, self.reserved, self.capacity,
                            f"{what} (blocked {waited:.1f}s on node memory, "
                            f"memory_blocked_timeout_s exceeded)",
                        )
                self._cond.wait(timeout=min(remaining or 1.0, 1.0))
            if blocked_at is not None:
                self.blocked -= 1
                waited = time.monotonic() - blocked_at
                self.blocked_ms_total += waited * 1e3
                _BLOCKED_SECONDS.observe(waited)
                if on_unblock is not None:
                    on_unblock()
            self.reserved += nbytes
            self.peak = max(self.peak, self.reserved)
            self._leases.append(lease)
        return lease

    def _release(self, lease: MemoryLease) -> None:
        with self._cond:
            if lease.released:
                return  # idempotent: finish and delete may both release
            lease.released = True
            try:
                self._leases.remove(lease)
            except ValueError:
                pass
            self._free_locked(lease.nbytes)

    def free(self, query_id: str, nbytes: int) -> None:
        """Raw byte return for detached (query-pool-layered) reservations."""
        with self._cond:
            self._free_locked(int(nbytes))

    def _free_locked(self, nbytes: int) -> None:
        remaining = self.reserved - nbytes
        if remaining < 0:
            _count_underflow(self.name, -remaining)
            remaining = 0
        self.reserved = remaining
        self._cond.notify_all()

    # ----------------------------------------------------------- pressure
    def set_capacity(self, capacity_bytes: int) -> None:
        """Resize the pool mid-flight (MEMORY_PRESSURE chaos shrinks it; a
        shrink below current reservations shows as reserved > capacity on
        the next heartbeat, which is exactly the over-budget signal the
        cluster memory manager escalates on).  Growing wakes waiters."""
        with self._cond:
            self.capacity = int(capacity_bytes)
            self._cond.notify_all()

    def revoke_query(self, query_id: str, spill_parts: int = 4) -> int:
        """Force-spill every revocable lease of `query_id`: each shrinks to
        its out-of-core footprint (nbytes / spill_parts — the partitioned
        executor holds one slice's working set at a time) and the holder's
        on_revoke hook flips it into sliced execution.  Returns bytes
        freed; wakes blocked reservations."""
        hooks: list[Callable[[], None]] = []
        freed = 0
        with self._cond:
            for lease in self._leases:
                if not lease.revocable or lease.revoked or lease.released:
                    continue
                if lease.query_id != query_id:
                    continue
                retained = max(1, lease.nbytes // max(2, spill_parts))
                delta = lease.nbytes - retained
                lease.nbytes = retained
                lease.revoked = True
                freed += delta
                if lease.on_revoke is not None:
                    hooks.append(lease.on_revoke)
            if freed:
                self.revocations += 1
                self.reserved = max(0, self.reserved - freed)
                self._cond.notify_all()
        if freed:
            _fr.record(
                "memory_revoke", node=self.name, query_id=query_id,
                freed_bytes=freed, leases=len(hooks),
            )
        for hook in hooks:  # outside the lock: hooks touch task state
            try:
                hook()
            except Exception:
                pass
        return freed

    # -------------------------------------------------------- observability
    def snapshot(self) -> dict:
        """The heartbeat payload (reference: MemoryInfo in /v1/status):
        per-query reserved/revocable bytes plus pool-level pressure state."""
        with self._cond:
            by_query: dict[str, dict[str, int]] = {}
            for lease in self._leases:
                q = by_query.setdefault(
                    lease.query_id, {"reserved": 0, "revocable": 0}
                )
                q["reserved"] += lease.nbytes
                if lease.revocable and not lease.revoked:
                    q["revocable"] += lease.nbytes
            _POOL_CAPACITY.labels(self.name).set(self.capacity)
            _POOL_RESERVED.labels(self.name).set(self.reserved)
            _POOL_BLOCKED.labels(self.name).set(self.blocked)
            return {
                "capacity": self.capacity,
                "reserved": self.reserved,
                "peak": self.peak,
                "blocked": self.blocked,
                "blocked_ms_total": round(self.blocked_ms_total, 3),
                "revocations": self.revocations,
                "by_query": by_query,
            }


class ClusterMemoryManager:
    """Coordinator-side memory arbitration (ClusterMemoryManager.java:92 +
    TotalReservationLowMemoryKiller).  Fed one snapshot dict per worker per
    heartbeat sweep; a node is PRESSURED when reservations exceed its
    capacity (post-shrink) or tasks sit blocked on its pool.  Pressure must
    persist past `killer_delay_s` before any action fires, and actions
    escalate: revoke the largest revocable holder first (resetting the
    clock so the spill can land), kill the query with the largest
    cluster-wide total reservation only when nothing revocable remains."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._pressure_since: dict[str, float] = {}

    def sweep(
        self,
        snapshots: dict[str, dict],
        killer_delay_s: float = 5.0,
        revocation_enabled: bool = True,
    ) -> list[dict]:
        now = self._clock()
        ripe: list[str] = []
        for node, pool in snapshots.items():
            if not pool:
                self._pressure_since.pop(node, None)
                continue
            over = pool.get("reserved", 0) > pool.get("capacity", 0)
            if not (over or pool.get("blocked", 0) > 0):
                self._pressure_since.pop(node, None)
                continue
            since = self._pressure_since.setdefault(node, now)
            if now - since >= killer_delay_s:
                ripe.append(node)
        for gone in set(self._pressure_since) - set(snapshots):
            self._pressure_since.pop(gone, None)
        if not ripe:
            return []

        if revocation_enabled:
            best = None  # (revocable_bytes, node, query_id)
            for node in ripe:
                for qid, q in (snapshots[node].get("by_query") or {}).items():
                    r = int(q.get("revocable") or 0)
                    if r > 0 and (best is None or r > best[0]):
                        best = (r, node, qid)
            if best is not None:
                # reset the clock: the forced spill needs killer_delay_s to
                # clear the deficit before the killer may escalate
                for node in ripe:
                    self._pressure_since[node] = now
                return [
                    {
                        "action": "revoke",
                        "node": best[1],
                        "query_id": best[2],
                        "bytes": best[0],
                    }
                ]

        # kill: largest TOTAL reservation across the cluster among queries
        # holding bytes on a ripe node (Trino's total-reservation policy)
        totals: dict[str, int] = {}
        for pool in snapshots.values():
            for qid, q in (pool.get("by_query") or {}).items():
                totals[qid] = totals.get(qid, 0) + int(q.get("reserved") or 0)
        candidates = {
            qid
            for node in ripe
            for qid in (snapshots[node].get("by_query") or {})
            if totals.get(qid, 0) > 0
        }
        if not candidates:
            return []
        victim = max(candidates, key=lambda q: totals[q])
        for node in ripe:  # give the kill's cleanup time to release
            self._pressure_since[node] = now
        return [
            {"action": "kill", "query_id": victim, "bytes": totals[victim]}
        ]
