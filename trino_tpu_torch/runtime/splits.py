"""Split-driven scan execution: morsel enumeration + lazy split scheduler.

Reference: the engine enumerates scans as connector **splits** at runtime
(TableScanNode + ConnectorSplitManager.getSplits), lazily schedules them
onto drivers (execution/scheduler/SourcePartitionedScheduler.java), and —
under fault-tolerant execution — retries them individually.  Here the same
decoupling, one layer up: the planner stops baking data size into scan
shapes, and the **split** becomes the unit of scheduling, retry,
speculation (straggler work-stealing), and backpressure.

Two pieces:

- ``scan_split_plan`` — a SplitSource per fragment: row-range scans are cut
  into pow2-bucketed fixed-capacity morsels of ``split_target_rows`` rows.
  Every morsel's scan page pads to the SAME pow2 capacity
  (``LocalExecutor.split_pad_rows``), so the same query at sf0.01 and sf10
  runs at the same capacities — only the split COUNT scales with data.
- ``SplitScheduler`` — coordinator-side lazy assignment for one scan stage.
  The coordinator holds the un-posted splits; at most ``split_queue_depth``
  are in flight per worker (a full cluster backpressures into admission via
  ``current_backlog``), a drained pool steals a straggler's split onto an
  idle worker (same task id — the spooled exchange's first-commit-wins
  rename arbitrates exactly-once), and a failed split is re-assigned alone
  (``split_retry_limit``) instead of re-running the whole scan.  A worker
  whose memory lease was revoked is *parked*: its queued splits wait or
  drain to peers instead of the old whole-task re-slice.
"""

from __future__ import annotations

import math
import threading
from collections import deque
from typing import Callable, Optional, Sequence

from ..plan.nodes import TableScan, walk
from ..plan.stats import estimate, scan_rows
from ..utils import flightrecorder as _fr
from ..utils import metrics as _metrics

__all__ = ["SplitScheduler", "scan_split_plan", "current_backlog"]

# registered in the GLOBAL registry at import so both the coordinator's and
# the workers' /metrics expositions carry the HELP strings
# (scripts/metrics_lint.py contract)
SPLITS_TOTAL = _metrics.GLOBAL.counter(
    "trino_tpu_splits_total",
    "Scan splits by lifecycle state (enumerated/precommitted/assigned/"
    "completed/retried/stolen/parked)",
    ("state",),
)
SPLIT_RETRIES = _metrics.GLOBAL.counter(
    "trino_tpu_split_retries_total",
    "Individual splits re-assigned after a failed or lost attempt",
)
SPLIT_STEALS = _metrics.GLOBAL.counter(
    "trino_tpu_split_steals_total",
    "Straggler splits re-posted onto an idle worker (first-commit-wins "
    "arbitrates the duplicate)",
)
SPLIT_BACKLOG = _metrics.GLOBAL.gauge(
    "trino_tpu_split_backlog",
    "Coordinator-held scan splits not yet assigned to any worker "
    "(admission backpressure input)",
)

# process-wide un-assigned split count across all live schedulers: the
# admission path sheds new statements when this runs far ahead of what the
# fleet can queue (reference: the FTE scheduler's bounded split queues
# feeding dispatcher backpressure)
_backlog_lock = threading.Lock()
_backlog = 0


def _backlog_add(n: int) -> None:
    global _backlog
    with _backlog_lock:
        _backlog = max(0, _backlog + n)
        SPLIT_BACKLOG.set(_backlog)


def current_backlog() -> int:
    with _backlog_lock:
        return _backlog


def _pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def scan_split_plan(root, catalogs, target_rows: int):
    """SplitSource for one fragment: ``(nsplits, pad_rows)`` when its
    row-range scans should be morselized, else None.

    - no TableScan -> None (exchange-only fragments keep their fan-out)
    - any bucketed scan -> None (the distribute pass aligned the fragment's
      partitioning with the connector bucket count; morselizing would break
      collocated-join alignment)
    - any scanned connector exposing ``scan_unit_plan`` (file-backed
      storage: connectors/parquet.py) -> FILE-BACKED splits: one task per
      (file, row-group) unit of the unit-richest table, so an sf10 scan
      over a partitioned parquet dir streams file-by-file under the same
      retry/steal/park machinery; the pad covers the fattest unit (and the
      fattest bucket of every co-scanned table)
    - otherwise the fragment's scans are cut into ``ceil(rows / pad_rows)``
      row-range morsels where ``pad_rows = pow2(target_rows)`` is also the
      fixed capacity every morsel's scan page pads to.  Sizing uses the
      LARGEST scanned table: every scan in the fragment is sliced by the
      same (part, num_parts) — exactly the mechanism the task path already
      uses, only the count changes.
    """
    scans = [n for n in walk(root) if isinstance(n, TableScan)]
    if not scans:
        return None
    rows = 0.0
    unit_plans: list[tuple[int, int]] = []  # (n_units, max_unit_rows)
    for s in scans:
        conn = None
        try:
            conn = catalogs.get(s.catalog)
            if conn.table_partitioning(s.table):
                return None
        except Exception:
            pass
        n = scan_rows(s, catalogs)
        rows = max(rows, n if n is not None else estimate(s, catalogs).rows)
        up = getattr(conn, "scan_unit_plan", None)
        if up is not None:
            try:
                plan = up(s.table)
            except Exception:
                plan = None
            if plan and plan[0] > 0:
                unit_plans.append(plan)
    if unit_plans:
        # file-backed: the stage fans out to one task per storage unit of
        # the unit-richest scan; get_splits(table, nsplits) then deals one
        # unit per bucket.  Every scan in the fragment is sliced by the
        # same (part, nsplits), so the fixed morsel capacity must cover
        # the fattest bucket across ALL scans: row-range co-scans get
        # ceil(rows / nsplits) rows, file-backed co-scans get up to
        # ceil(n_units / nsplits) whole units.
        nsplits = max(n_u for n_u, _ in unit_plans)
        need = max(1, math.ceil(rows / nsplits))
        for n_u, max_r in unit_plans:
            need = max(need, math.ceil(n_u / nsplits) * max_r)
        return nsplits, _pow2(need)
    pad = _pow2(max(1, int(target_rows)))
    nsplits = max(1, math.ceil(rows / pad))
    return nsplits, pad


class SplitScheduler:
    """Lazy split assignment for ONE scan stage.

    The stage runner (coordinator._run_stage_phased) drives it:
    ``add``/``precommitted`` enumerate, ``assign`` drains the pool onto
    workers with free queue slots (least-loaded first, parked workers
    skipped), ``on_done`` frees a slot, ``retry`` picks the re-assignment
    target for a failed split, ``steal`` duplicates a straggler onto an
    idle worker once the pool is dry.  All methods are thread-safe; the
    runner owns posting and polling.
    """

    def __init__(
        self,
        nsplits: int,
        queue_depth: int = 2,
        is_parked: Optional[Callable[[str], bool]] = None,
        query_id: str = "",
        node: str = "",
        link_penalty: Optional[Callable[[str], int]] = None,
    ):
        self.nsplits = int(nsplits)
        self.queue_depth = max(1, int(queue_depth))
        self._is_parked = is_parked or (lambda url: False)
        # impaired-link count touching a worker (coordinator link matrix,
        # runtime/health.py): a soft placement penalty ranked ahead of
        # load — never a hard filter, so a cluster whose every link is
        # impaired still schedules
        self._link_penalty = link_penalty or (lambda url: 0)
        # flight-recorder attribution: the owning query and the
        # coordinator node this scheduler runs on (utils/flightrecorder.py)
        self.query_id = query_id
        self.node = node
        self._lock = threading.Lock()
        self._pool: deque[int] = deque()
        self._inflight: dict[int, str] = {}  # part -> worker url
        self._load: dict[str, int] = {}  # worker url -> in-flight splits
        self._stolen: set[int] = set()  # one steal per split, ever
        self._steal_of: dict[int, str] = {}  # part -> thief url
        self.stats: dict[str, int] = {
            "splits": self.nsplits,
            "enumerated": 0,
            "precommitted": 0,
            "assigned": 0,
            "completed": 0,
            "retries": 0,
            "steals": 0,
            "parked": 0,
        }

    # ------------------------------------------------------- enumeration

    def add(self, part: int) -> None:
        with self._lock:
            self._pool.append(part)
            self.stats["enumerated"] += 1
        SPLITS_TOTAL.labels("enumerated").inc()
        _backlog_add(1)

    def precommitted(self, part: int) -> None:
        """A pre-crash attempt of this split already committed to the spool
        (resume / fragment-memo seed): it is never enumerated, consumers
        re-read it."""
        with self._lock:
            self.stats["precommitted"] += 1
        SPLITS_TOTAL.labels("precommitted").inc()

    def backlog(self) -> int:
        with self._lock:
            return len(self._pool)

    # -------------------------------------------------------- assignment

    def _free_slots(self, url: str) -> int:
        return self.queue_depth - self._load.get(url, 0)

    def assign(self, workers: Sequence[str]) -> list[tuple[int, str]]:
        """Drain queued splits onto workers with free queue slots,
        least-loaded first.  Stops when every candidate is full or parked
        (bounded per-worker queues = the backpressure edge)."""
        out: list[tuple[int, str]] = []
        parked_seen = False
        with self._lock:
            while self._pool:
                cands = []
                for w in workers:
                    if self._free_slots(w) <= 0:
                        continue
                    if self._is_parked(w):
                        parked_seen = True
                        continue
                    cands.append(w)
                if not cands:
                    break
                w = min(
                    cands,
                    key=lambda u: (
                        self._link_penalty(u), self._load.get(u, 0), u
                    ),
                )
                p = self._pool.popleft()
                self._inflight[p] = w
                self._load[w] = self._load.get(w, 0) + 1
                self.stats["assigned"] += 1
                out.append((p, w))
            if parked_seen and self._pool:
                # splits held back because a revoked worker is parked —
                # they wait here (or drain to peers) instead of the old
                # whole-task re-slice
                self.stats["parked"] += 1
                SPLITS_TOTAL.labels("parked").inc()
                _fr.record(
                    "split_park",
                    node=self.node,
                    query_id=self.query_id or None,
                    queued=len(self._pool),
                )
        for p, w in out:
            SPLITS_TOTAL.labels("assigned").inc()
            _fr.record(
                "split_assign",
                node=self.node,
                query_id=self.query_id or None,
                split=p,
                worker=w,
            )
        _backlog_add(-len(out))
        return out

    def _release(self, part: int) -> None:
        w = self._inflight.pop(part, None)
        if w is not None:
            self._load[w] = max(0, self._load.get(w, 0) - 1)
        thief = self._steal_of.pop(part, None)
        if thief is not None:
            self._load[thief] = max(0, self._load.get(thief, 0) - 1)

    def on_done(self, part: int) -> None:
        with self._lock:
            self._release(part)
            self.stats["completed"] += 1
        SPLITS_TOTAL.labels("completed").inc()

    def retry(
        self, part: int, workers: Sequence[str], exclude: Optional[str] = None
    ) -> Optional[str]:
        """A split's attempts all failed: free its slot and pick the
        re-assignment target — least-loaded, not parked, not the failing
        worker (falling back to whatever is alive)."""
        with self._lock:
            self._release(part)
            cands = [
                w
                for w in workers
                if w != exclude and not self._is_parked(w)
            ]
            if not cands:
                cands = [w for w in workers if w != exclude] or list(workers)
            if not cands:
                return None
            w = min(
                cands,
                key=lambda u: (
                    self._link_penalty(u), self._load.get(u, 0), u
                ),
            )
            self._inflight[part] = w
            self._load[w] = self._load.get(w, 0) + 1
            self.stats["retries"] += 1
        SPLIT_RETRIES.inc()
        SPLITS_TOTAL.labels("retried").inc()
        _fr.record(
            "split_retry",
            node=self.node,
            query_id=self.query_id or None,
            split=part,
            worker=w,
            excluded=exclude,
        )
        return w

    def steal(
        self, workers: Sequence[str], parts: Optional[set] = None
    ) -> Optional[tuple[int, str]]:
        """Straggler work-stealing: once the pool is dry, an idle worker
        duplicates a straggling in-flight split (same task id; the spooled
        exchange's first-commit-wins rename — or the runner's winner-pick
        without a spool — arbitrates exactly-once).  `parts` restricts the
        candidates (the runner passes the lagging single-attempt splits).
        At most one steal per split; returns (part, thief_url) or None."""
        with self._lock:
            if self._pool:
                return None
            idle = [
                w
                for w in workers
                if self._free_slots(w) > 0 and not self._is_parked(w)
            ]
            if not idle:
                return None
            cands = sorted(
                (
                    (self._load.get(u, 0), p)
                    for p, u in self._inflight.items()
                    if p not in self._stolen
                    and u not in idle
                    and (parts is None or p in parts)
                ),
                reverse=True,  # most-loaded victim's newest split first
            )
            for _, p in cands:
                thief = min(
                    idle,
                    key=lambda w: (
                        self._link_penalty(w), self._load.get(w, 0), w
                    ),
                )
                if thief == self._inflight.get(p):
                    continue
                self._stolen.add(p)
                self._steal_of[p] = thief
                self._load[thief] = self._load.get(thief, 0) + 1
                self.stats["steals"] += 1
                SPLIT_STEALS.inc()
                SPLITS_TOTAL.labels("stolen").inc()
                _fr.record(
                    "split_steal",
                    node=self.node,
                    query_id=self.query_id or None,
                    split=p,
                    thief=thief,
                    victim=self._inflight.get(p),
                )
                return p, thief
            return None

    def steal_abort(self, part: int, thief: str) -> None:
        """The duplicate post failed (thief died between pick and POST):
        undo the bookkeeping so the split may be stolen again later."""
        with self._lock:
            if self._steal_of.get(part) == thief:
                del self._steal_of[part]
                self._stolen.discard(part)
                self._load[thief] = max(0, self._load.get(thief, 0) - 1)

    def close(self) -> None:
        """Stage over (success or failure): release any still-queued splits
        from the process-wide backlog so admission unblocks."""
        with self._lock:
            n = len(self._pool)
            self._pool.clear()
        if n:
            _backlog_add(-n)
