"""Disk accounting: a governed byte budget for spool + spill storage.

Symmetric to the memory plane (runtime/memory.py NodeMemoryPool): every
durable byte a worker writes — spooled exchange commits, output-buffer
spill files, out-of-core spill chunks — takes a lease against a per-node
disk budget (`spool.disk-budget-bytes`).  The reference's analogue is the
fault-tolerant exchange storage + spill space the engine assumes is
bounded but never infinite: at sf10 the spool grows ~100x and an ENOSPC
anywhere in the write path is a worker-killing OSError today.

Pressure escalation, in order, before any query is failed:

1. refresh — leases whose backing path was deleted by another actor
   (coordinator remove_query, spool GC, consumer acknowledge) are
   harvested lazily; deleted bytes return to the pool at the next
   pressure event without cross-actor plumbing.
2. reclaim — registered reclaimers run (the spooled exchange evicts
   fragment-memo namespaces first, then non-live query dirs — see
   SpooledExchange.reclaim), freeing cold durable state.
3. block — the writer parks (bounded by `timeout_s`), waiting for a peer
   release, exactly like blocked-on-memory.
4. shed — the reservation fails with the typed EXCEEDED_SPILL_LIMIT
   (DiskExceeded), which task retry converts into a placement decision:
   the attempt moves to a node with disk left.

All writes route through ``guarded_write`` so a raw filesystem ENOSPC
surfaces as the same typed error instead of an unhandled OSError.
"""

from __future__ import annotations

import errno
import os
import threading
import time
from typing import Callable, Optional

from ..utils import flightrecorder as _fr
from ..utils.metrics import GLOBAL as _METRICS

__all__ = ["DiskExceeded", "DiskLease", "NodeDiskPool", "guarded_write"]

_POOL_CAPACITY = _METRICS.gauge(
    "trino_tpu_disk_pool_capacity_bytes",
    "Node disk pool byte budget (spool.disk-budget-bytes)",
    labelnames=("pool",),
)
_POOL_RESERVED = _METRICS.gauge(
    "trino_tpu_disk_pool_reserved_bytes",
    "Bytes currently leased from the node disk pool",
    labelnames=("pool",),
)
_POOL_BLOCKED = _METRICS.gauge(
    "trino_tpu_disk_pool_blocked_reservations",
    "Disk reservations parked waiting for pool bytes",
    labelnames=("pool",),
)
_POOL_EXCEEDED = _METRICS.counter(
    "trino_tpu_disk_pool_exceeded_total",
    "Disk reservations shed with typed EXCEEDED_SPILL_LIMIT",
)
_RECLAIMED = _METRICS.counter(
    "trino_tpu_disk_reclaimed_bytes_total",
    "Bytes returned to disk pools by pressure reclaim (refresh + evict)",
)

# typed error code carried in the message so coordinator retry paths and
# log scrapers match on it (reference: StandardErrorCode.EXCEEDED_SPILL_LIMIT)
EXCEEDED_SPILL_LIMIT = "EXCEEDED_SPILL_LIMIT"


class DiskExceeded(RuntimeError):
    """Disk budget exhausted (or the device itself is full) — the typed
    EXCEEDED_SPILL_LIMIT path.  Never lets a raw ENOSPC OSError escape."""

    def __init__(self, requested: int, used: int, budget: int, what: str = ""):
        self.requested = requested
        self.used = used
        self.budget = budget
        super().__init__(
            f"{EXCEEDED_SPILL_LIMIT}: disk budget exceeded: need {requested} "
            f"bytes ({what}), used {used} of {budget}"
        )

    @classmethod
    def from_enospc(cls, path: str, nbytes: int) -> "DiskExceeded":
        e = cls(nbytes, 0, 0, f"write {path}")
        e.args = (
            f"{EXCEEDED_SPILL_LIMIT}: device full (ENOSPC) writing "
            f"{nbytes} bytes to {path}",
        )
        return e


class DiskLease:
    """One reservation held against a NodeDiskPool.  release() is
    idempotent; a lease carrying a `path` is auto-harvested by the pool's
    refresh pass once that path no longer exists on disk (another actor —
    spool GC, remove_query, consumer ack — deleted the bytes)."""

    def __init__(
        self,
        pool: "NodeDiskPool",
        owner: str,
        nbytes: int,
        path: Optional[str] = None,
    ):
        self.pool = pool
        self.owner = owner
        self.nbytes = nbytes
        self.path = path
        self.released = False

    def release(self) -> None:
        self.pool._release(self)

    def reparent(self, path: str) -> None:
        """Re-point the lease at the published location (a spool commit
        stages under a tmp dir then renames into place)."""
        self.path = path


class NodeDiskPool:
    """A worker node's disk byte budget.  reserve() on a full pool first
    harvests deleted-path leases, then runs pressure reclaimers, then
    BLOCKS the writer until bytes free or `timeout_s` elapses — escalating
    to the typed DiskExceeded (EXCEEDED_SPILL_LIMIT) only after all of
    that.  set_capacity() supports mid-query shrink (DISK_FULL chaos)."""

    def __init__(self, capacity_bytes: int, name: str = "node"):
        self.capacity = int(capacity_bytes)
        self.name = name
        self.reserved = 0
        self.peak = 0
        self.blocked = 0
        self.blocked_ms_total = 0.0
        self.sheds = 0  # reservations failed with EXCEEDED_SPILL_LIMIT
        self.reclaims = 0  # pressure sweeps that freed bytes
        self.reclaimed_bytes = 0
        self._cond = threading.Condition()
        self._leases: list[DiskLease] = []
        # reclaimers: need_bytes -> freed_bytes estimate; registered by the
        # storage owners (SpooledExchange memo/non-live eviction).  Run
        # OUTSIDE the pool lock — they delete files and may re-enter.
        self._reclaimers: list[Callable[[int], int]] = []

    def add_reclaimer(self, fn: Callable[[int], int]) -> None:
        with self._cond:
            self._reclaimers.append(fn)

    # ------------------------------------------------------------- reserve
    def reserve(
        self,
        owner: str,
        nbytes: int,
        timeout_s: Optional[float] = None,
        what: str = "",
        path: Optional[str] = None,
        reclaim: Optional[Callable[[int], int]] = None,
        abort: Optional[Callable[[], bool]] = None,
    ) -> DiskLease:
        nbytes = int(nbytes)
        lease = DiskLease(self, owner, nbytes, path)
        with self._cond:
            self._refresh_locked()
            if self.reserved + nbytes <= self.capacity:
                self._take_locked(lease)
                return lease
            need = self.reserved + nbytes - self.capacity

        # pressure reclaim, outside the lock: memo namespaces first, then
        # non-live dirs (the reclaimers encode the order) — before any
        # blocking, and long before any query fails
        freed = self._run_reclaimers(need, extra=reclaim)
        if freed:
            with self._cond:
                self.reclaims += 1
                self.reclaimed_bytes += freed
            _RECLAIMED.inc(freed)
            _fr.record(
                "disk_reclaim", node=self.name, task_id=owner,
                freed_bytes=freed, needed_bytes=need,
            )

        blocked_at: Optional[float] = None
        try:
            with self._cond:
                self._refresh_locked()
                deadline = (
                    None if timeout_s is None else time.monotonic() + timeout_s
                )
                while self.reserved + nbytes > self.capacity:
                    if nbytes > self.capacity:
                        # larger than the whole pool: waiting cannot succeed
                        self._shed_locked()
                        _fr.record(
                            "disk_shed", node=self.name, task_id=owner,
                            bytes=nbytes, what=what,
                        )
                        raise DiskExceeded(
                            nbytes, self.reserved, self.capacity, what
                        )
                    if blocked_at is None:
                        blocked_at = time.monotonic()
                        self.blocked += 1
                        _fr.record(
                            "disk_block", node=self.name, task_id=owner,
                            bytes=nbytes, what=what,
                        )
                    if abort is not None and abort():
                        raise RuntimeError("task canceled")
                    remaining = None
                    if deadline is not None:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            self._shed_locked()
                            waited = time.monotonic() - blocked_at
                            _fr.record(
                                "disk_shed", node=self.name, task_id=owner,
                                bytes=nbytes, what=what,
                                blocked_s=round(waited, 3),
                            )
                            raise DiskExceeded(
                                nbytes, self.reserved, self.capacity,
                                f"{what} (blocked {waited:.1f}s on node "
                                f"disk, disk_blocked_timeout_s exceeded)",
                            )
                    self._cond.wait(timeout=min(remaining or 0.5, 0.5))
                    self._refresh_locked()
                self._take_locked(lease)
                return lease
        finally:
            if blocked_at is not None:
                with self._cond:
                    self.blocked -= 1
                    self.blocked_ms_total += (
                        time.monotonic() - blocked_at
                    ) * 1e3

    def _take_locked(self, lease: DiskLease) -> None:
        self.reserved += lease.nbytes
        self.peak = max(self.peak, self.reserved)
        self._leases.append(lease)

    def _shed_locked(self) -> None:
        self.sheds += 1
        _POOL_EXCEEDED.inc()

    def _run_reclaimers(
        self, need: int, extra: Optional[Callable[[int], int]] = None
    ) -> int:
        with self._cond:
            fns = list(self._reclaimers)
        if extra is not None:
            fns.append(extra)
        freed = 0
        for fn in fns:
            if freed >= need:
                break
            try:
                freed += int(fn(need - freed) or 0)
            except Exception:
                pass  # a reclaimer must never break the write path
        return freed

    def _refresh_locked(self) -> None:
        """Harvest leases whose backing path was deleted by another actor
        — lazily, at pressure time, so spool GC / remove_query / ack need
        no reference to this pool."""
        gone = [
            l
            for l in self._leases
            if l.path is not None and not os.path.exists(l.path)
        ]
        for lease in gone:
            lease.released = True
            self._leases.remove(lease)
            self.reserved = max(0, self.reserved - lease.nbytes)
        if gone:
            self._cond.notify_all()

    # ------------------------------------------------------------- release
    def _release(self, lease: DiskLease) -> None:
        with self._cond:
            if lease.released:
                return  # idempotent: finish and delete may both release
            lease.released = True
            try:
                self._leases.remove(lease)
            except ValueError:
                pass
            self.reserved = max(0, self.reserved - lease.nbytes)
            self._cond.notify_all()

    def release_prefix(self, prefix: str) -> int:
        """Release every lease whose owner starts with `prefix` (a query's
        spool dirs at remove_query).  Returns bytes freed."""
        freed = 0
        with self._cond:
            for lease in list(self._leases):
                if lease.owner.startswith(prefix):
                    lease.released = True
                    self._leases.remove(lease)
                    freed += lease.nbytes
            if freed:
                self.reserved = max(0, self.reserved - freed)
                self._cond.notify_all()
        return freed

    # ------------------------------------------------------------ pressure
    def set_capacity(self, capacity_bytes: int) -> None:
        """Resize mid-flight (DISK_FULL chaos shrinks it; a shrink below
        current reservations makes every new write block→reclaim→shed).
        Growing wakes blocked writers."""
        with self._cond:
            self.capacity = int(capacity_bytes)
            self._cond.notify_all()

    # ------------------------------------------------------ observability
    def snapshot(self) -> dict:
        """Heartbeat payload (rides /v1/info beside the memory pool)."""
        with self._cond:
            by_owner: dict[str, int] = {}
            for lease in self._leases:
                # group by query prefix (owner is a task id / file path key)
                key = lease.owner.split("_a", 1)[0]
                by_owner[key] = by_owner.get(key, 0) + lease.nbytes
            _POOL_CAPACITY.labels(self.name).set(self.capacity)
            _POOL_RESERVED.labels(self.name).set(self.reserved)
            _POOL_BLOCKED.labels(self.name).set(self.blocked)
            return {
                "capacity": self.capacity,
                "reserved": self.reserved,
                "peak": self.peak,
                "blocked": self.blocked,
                "blocked_ms_total": round(self.blocked_ms_total, 3),
                "sheds": self.sheds,
                "reclaims": self.reclaims,
                "reclaimed_bytes": self.reclaimed_bytes,
                "by_owner": by_owner,
            }


def guarded_write(path: str, blob: bytes) -> int:
    """THE single write gate for durable bytes (spool chunks, spill files,
    out-of-core pages): converts a raw filesystem ENOSPC/EDQUOT into the
    typed DiskExceeded and removes the partial file so a half-written
    chunk can never be read back as truncated data.  Returns bytes
    written.  Callers lease the bytes from a NodeDiskPool FIRST when one
    governs the node — this gate is the last line, not the accounting."""
    try:
        with open(path, "wb") as f:
            f.write(blob)
        return len(blob)
    except OSError as e:
        if e.errno in (errno.ENOSPC, errno.EDQUOT):
            try:
                os.remove(path)
            except OSError:
                pass
            raise DiskExceeded.from_enospc(path, len(blob)) from None
        raise
