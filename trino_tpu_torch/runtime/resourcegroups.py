"""Resource groups: hierarchical admission control for the coordinator.

Reference: execution/resourcegroups/InternalResourceGroup.java — a tree of
groups, each with hard concurrency and queue limits; arriving queries map
to a group via selectors, run when the group (and every ancestor) has a
free slot, queue FIFO otherwise, and are rejected once the queue is full.
The reference adds weighted/fair scheduling policies between sibling
groups; here the policy is FIFO per group, which is its default for leaf
queries.

Memory admission: a group can carry `memory_limit_bytes`; a query's
declared budget (session `query_max_memory_bytes`, the same number the
out-of-core executor plans against) counts against it while the query
runs.  Declared-budget admission is how the reference's
ClusterMemoryManager enforces pool limits before OOM-killing stragglers.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Optional

__all__ = ["ResourceGroupConfig", "ResourceGroupManager", "QueryRejected"]


class QueryRejected(RuntimeError):
    pass


class ResourceGroupConfig:
    def __init__(
        self,
        name: str = "global",
        max_concurrency: int = 100,
        max_queued: int = 1000,
        memory_limit_bytes: int = 0,  # 0 = unlimited
        subgroups: tuple["ResourceGroupConfig", ...] = (),
        scheduling_weight: int = 1,
    ):
        self.name = name
        self.max_concurrency = max_concurrency
        self.max_queued = max_queued
        self.memory_limit_bytes = memory_limit_bytes
        self.subgroups = subgroups
        # weighted-fair share between sibling groups competing for a
        # parent's slots (reference: resourcegroups/WeightedFairQueue.java)
        self.scheduling_weight = max(1, scheduling_weight)


class _Group:
    def __init__(self, cfg: ResourceGroupConfig, parent: Optional["_Group"]):
        self.cfg = cfg
        self.parent = parent
        self.running: set[str] = set()
        self.reserved_bytes = 0
        self.queue: deque[tuple[str, int, Callable[[], None]]] = deque()

    def can_ever_admit(self, mem_bytes: int) -> bool:
        """False when the declared budget alone exceeds a limit in the chain
        — such a query could queue forever and wedge the group."""
        g: Optional[_Group] = self
        while g is not None:
            if g.cfg.memory_limit_bytes and mem_bytes > g.cfg.memory_limit_bytes:
                return False
            g = g.parent
        return True

    def can_admit(self, mem_bytes: int) -> bool:
        g: Optional[_Group] = self
        while g is not None:
            if len(g.running) >= g.cfg.max_concurrency:
                return False
            if (
                g.cfg.memory_limit_bytes
                and g.reserved_bytes + mem_bytes > g.cfg.memory_limit_bytes
            ):
                return False
            g = g.parent
        return True

    def admit(self, qid: str, mem_bytes: int) -> None:
        g: Optional[_Group] = self
        while g is not None:
            g.running.add(qid)
            g.reserved_bytes += mem_bytes
            g = g.parent

    def release(self, qid: str, mem_bytes: int) -> None:
        g: Optional[_Group] = self
        while g is not None:
            g.running.discard(qid)
            g.reserved_bytes = max(0, g.reserved_bytes - mem_bytes)
            g = g.parent


class ResourceGroupManager:
    def __init__(self, root: Optional[ResourceGroupConfig] = None):
        self._lock = threading.Lock()
        self._groups: dict[str, _Group] = {}
        self._mem_of: dict[str, int] = {}
        self._group_of: dict[str, _Group] = {}

        def build(cfg: ResourceGroupConfig, parent: Optional[_Group]) -> None:
            g = _Group(cfg, parent)
            self._groups[cfg.name] = g
            for sub in cfg.subgroups:
                build(sub, g)

        build(root or ResourceGroupConfig(), None)

    def submit(
        self, group_name: str, qid: str, mem_bytes: int, start: Callable[[], None]
    ) -> str:
        """Admit (calls start() and returns "running"), queue ("queued"), or
        raise QueryRejected when the queue is full."""
        with self._lock:
            g = self._groups.get(group_name)
            if g is None:
                raise QueryRejected(f"unknown resource group: {group_name}")
            if not g.can_ever_admit(mem_bytes):
                raise QueryRejected(
                    f"declared memory budget {mem_bytes} exceeds the "
                    f"memory limit of group {group_name!r} or an ancestor"
                )
            if g.can_admit(mem_bytes):
                g.admit(qid, mem_bytes)
                self._mem_of[qid] = mem_bytes
                self._group_of[qid] = g
                admitted = True
            else:
                if len(g.queue) >= g.cfg.max_queued:
                    raise QueryRejected(
                        f"Too many queued queries for {group_name!r} "
                        f"(max_queued={g.cfg.max_queued})"
                    )
                g.queue.append((qid, mem_bytes, start))
                self._group_of[qid] = g
                admitted = False
        if admitted:
            start()
            return "running"
        return "queued"

    def cancel_queued(self, qid: str) -> bool:
        """Atomically remove a still-QUEUED query; False if it is already
        running (or unknown) — the caller must then cancel it cooperatively
        instead of releasing a slot the query still occupies."""
        with self._lock:
            g = self._group_of.get(qid)
            if g is None:
                return False
            for i, (q, _, _) in enumerate(g.queue):
                if q == qid:
                    del g.queue[i]
                    self._group_of.pop(qid, None)
                    self._mem_of.pop(qid, None)
                    return True
            return False

    def finish(self, qid: str) -> None:
        """Release the query's slot and start whatever its group can now
        admit (called from the query's own completion path)."""
        to_start: list[Callable[[], None]] = []
        with self._lock:
            g = self._group_of.pop(qid, None)
            if g is None:
                return
            mem = self._mem_of.pop(qid, 0)
            in_queue = [i for i, (q, _, _) in enumerate(g.queue) if q == qid]
            if in_queue:  # canceled while queued
                del g.queue[in_queue[0]]
            else:
                g.release(qid, mem)
            # a freed slot may unblock any group under the same ancestors.
            # Among admissible candidates, WEIGHTED-FAIR selection: admit
            # from the group with the smallest running/weight share first
            # (reference: WeightedFairQueue.java — FIFO within a group,
            # weighted shares between siblings)
            while True:
                candidates = [
                    grp
                    for grp in self._groups.values()
                    if grp.queue and grp.can_admit(grp.queue[0][1])
                ]
                if not candidates:
                    break
                grp = min(
                    candidates,
                    key=lambda g: (
                        len(g.running) / g.cfg.scheduling_weight,
                        g.cfg.name,
                    ),
                )
                nqid, nmem, nstart = grp.queue.popleft()
                grp.admit(nqid, nmem)
                self._mem_of[nqid] = nmem
                self._group_of[nqid] = grp
                to_start.append(nstart)
        for s in to_start:
            s()

    def stats(self) -> dict:
        with self._lock:
            return {
                name: {
                    "running": len(g.running),
                    "queued": len(g.queue),
                    "reserved_bytes": g.reserved_bytes,
                }
                for name, g in self._groups.items()
            }
