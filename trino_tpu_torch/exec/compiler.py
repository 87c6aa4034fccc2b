"""Plan compiler + local executor.

The reference's LocalExecutionPlanner (sql/planner/LocalExecutionPlanner.java
:408) visits the plan and wires OperatorFactory chains that pull pages
through virtual calls, one page at a time.  Here the visitor walks the
plan once and runs every operator eagerly as whole-column torch ops over
(columns, live-mask) pairs; Q1/Q6-shaped aggregates collapse into one fused
kernel pass (ops/cuda/fused.py).

Capacity protocol (the static-shape answer to dynamic selectivity/fan-out):
stateful nodes (group-by, compaction) get a static capacity; the walk
returns the true required size for every such node; the host retries at the
next power-of-two tier on overflow.  The capacities fix the shape of every
operator output, so pages can be compared column by column with the
reference's.  All required sizes of a run come back to the host in ONE
packed transfer.

The port handles TableScan, Values, Filter, Project, Compact, Aggregate,
Distinct, Join (every kind, cross joins against a single row included),
Concat (UNION ALL, and the union under INTERSECT / EXCEPT / UNION), Sort,
TopN, Limit, EnforceSingleRow, Window, Unnest, MatchRecognize and
RemoteSource (a plan fragment's input, handed in as a page by the
executor of a distributed plan).  An Exchange runs between the tasks of a
distributed plan's fragments, never inside one: exec/spmd.py (exchanges in
device memory) and exec/spill.py (out of core, exchanges on disk) cut the
plan at its exchanges, and LocalExecutor refuses one it is handed.

Scans can be sliced and narrowed: `split = (part, num_parts)` scans one
slice of every table (padded with `pad_splits` to the rows of the largest
slice, `_slice_pad`, so all slices share one set of learned capacities), and
`scan_filters` (exec/dynfilter.py) drop rows outside a join's build-side key
domain on the host, before they are uploaded.  Prepared-statement parameters
(`execute(..., params=...)`) are bound for the run through
ops/expr.param_context: every binding of a plan shares its learned
capacities.

Worker tasks (runtime/worker.py) and a coordinator's root fragment set a
few more knobs: `split_pad_rows` pads every scan slice to one fixed
capacity (split-driven scans, runtime/splits.py), `memory_budget_bytes`
refuses a run whose planned footprint exceeds it (MemoryBudgetExceeded;
the task-retry scheduler grows the budget 4x per attempt), and
`collect_operator_stats` leaves each node's live output rows of the run
that returned in `last_operator_stats`.  The executors of one node may share
a ScanCache: uploaded scan columns and learned capacities then outlive a
task.

Three more facts ride the packed `required` transfer: EnforceSingleRow's live
count (key -(nid+1); the host raises past one row) and each hash join's
runtime guard (key _JOIN_GUARD + nid; a set guard — the build overflowed or
a probe walk ran past its budget — re-runs the plan with that join on the
sort path), and under `collect_operator_stats` each node's live output
rows (key _STATS_ROWS_BASE + nid; a fused aggregate chain reports its
Aggregate and its TableScan, as the reference's counters do).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..connectors.spi import CatalogManager
from ..data.page import Column, Dictionary, Page
from ..ops.expr import (
    ColumnVal, bind_params, clear_run_memos, column_val, eval_expr, eval_predicate,
    param_context, translate_codes,
)
from ..ops.relops import (
    AggSpec, SortSpec, broadcast_single_row, compact_rows, equi_join,
    group_aggregate, limit_mask, sort_rows, top_n, unnest_expand,
)
from ..plan.nodes import (
    Aggregate, Compact, Concat, Distinct, EnforceSingleRow, Filter, Join, Limit,
    MatchRecognize, PlanNode, Project, RemoteSource, Sort, TableScan, TopN, Unnest, Values,
    Window,
)
from . import capcache

__all__ = [
    "LocalExecutor", "MemoryBudgetExceeded", "ScanCache", "fused_fragment",
    "scan_column_vals",
]

# plan node -> the ROADMAP item that ports it (none is left unported)
_ROADMAP_ITEM: dict[str, str] = {}


@dataclass
class _Stage:
    cols: list[ColumnVal]
    live: torch.Tensor

    @property
    def capacity(self) -> int:
        return int(self.live.shape[0])


def _node_ids(plan: PlanNode) -> dict[int, PlanNode]:
    """Stable preorder numbering (plan trees are immutable)."""
    out: dict[int, PlanNode] = {}

    def visit(n: PlanNode):
        out[len(out)] = n
        for c in n.children:
            visit(c)

    visit(plan)
    return out


def _generation(conn, table: str):
    """Write generation of `table` (scan caches key on it): per table where
    the connector keeps one, else the connector-wide counter writable
    connectors bump, else 0."""
    per_table = getattr(conn, "table_generation", None)
    return per_table(table) if per_table is not None else getattr(conn, "generation", 0)


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


# `required` key of a hash join's runtime guard: _JOIN_GUARD + node id
_JOIN_GUARD = 1 << 40
# `required` key of a node's live output rows under collect_operator_stats:
# _STATS_ROWS_BASE + node id (capacity keys are small preorder ids,
# EnforceSingleRow's are negative, join guards start at _JOIN_GUARD)
_STATS_ROWS_BASE = 1_000_000


class MemoryBudgetExceeded(RuntimeError):
    """The planned capacities exceed the task's device-memory budget; the
    task-retry scheduler retries the task with a 4x larger budget."""


class ScanCache:
    """Uploaded scan columns and learned capacities that several executors
    share: the tasks of one worker node (runtime/worker.py), which would
    otherwise re-read, re-encode and re-upload their table slices on every
    task.  Entries are keyed by table, columns, split, pad, dynamic filters
    and write generation, so tasks over different slices never collide.
    `lock` guards the dicts only: a task reads and uploads a missing column
    outside it, after marking the column's key in flight (`inflight`: key
    -> Event), so a blocked connector read stalls only the tasks that need
    that very column, and two tasks needing it read it once."""

    def __init__(self):
        self.cols: dict = {}
        self.pages: dict = {}
        self.live: dict = {}
        self.learned_caps: dict = {}
        self.inflight: dict = {}
        self.lock = threading.RLock()

    def drop_device(self) -> int:
        """Let go of every cached column and page (the learned capacities,
        host values, stay): what a node gives back under memory pressure.
        Returns the device bytes the dropped columns held."""
        with self.lock:
            nbytes = sum(
                t.numel() * t.element_size()
                for col in self.cols.values()
                for t in (col.data, col.valid, col.data2)
                if isinstance(t, torch.Tensor)
            )
            self.cols.clear()
            self.pages.clear()
            self.live.clear()
        return nbytes


class LocalExecutor:
    """Single-process execution over device-resident table pages (the
    reference's PlanTester.executeStatement analogue, testing/PlanTester.java
    :706 — full engine, no HTTP)."""

    def __init__(
        self, catalogs: CatalogManager, default_catalog: str = "tpch", device="cuda",
        scan_cache: Optional[ScanCache] = None,
    ):
        self.catalogs = catalogs
        self.default_catalog = default_catalog
        self.device = resolve_device(device)
        # (part, num_parts): the slice of every table this executor scans;
        # (0, 1) = the whole table
        self.split = (0, 1)
        # pad every slice to ceil(total / num_parts) rows (a dead tail), so
        # all slices of a fragment share one set of learned capacities
        self.pad_splits = False
        # split-driven scans (runtime/splits.py): every scan page pads to
        # this fixed capacity, whatever its row range holds.  None = off
        self.split_pad_rows: Optional[int] = None
        # per-task device-memory budget in bytes (None / 0 = none): the
        # task-retry scheduler grows it across attempts; checked against an
        # estimate over the planned capacities before the run
        self.memory_budget_bytes: Optional[int] = None
        self.last_estimated_bytes = 0
        # each node's live output rows of the run that returned, counted on
        # the device and read in the run's one packed transfer:
        # {nid: {operator, rows, rows_in, output_bytes, invocations}}
        self.collect_operator_stats = False
        self.last_operator_stats: dict[int, dict] = {}
        self.last_execute_wall_ms: Optional[float] = None
        # attribution of the last execute(): NVRTC builds of kernel 2
        # recipes (utils/profiler.py; the port's only run-time compiles) and
        # fallback executions, the wall spent waiting on builds and on the
        # rest of the call, and the run per plan signature
        self.compile_events: list[dict] = []
        self.last_compile_ms = 0.0
        self.last_execute_ms = 0.0
        self.execute_events: dict[str, dict] = {}
        # the compile plane (exec/compilesvc.py): kernel 2's builds run on
        # the service's pool.  Budget 0 == wait for the build (bounded only
        # by the deadline); deadline 0 == none.  Past the budget the query
        # runs the unfused operator path (its aggregates on kernel 1) and
        # the built kernel swaps in on the recipe's next execution
        self.compile_wait_budget_ms = 0
        self.compile_deadline_s = 0.0
        self.compile_service = None  # None == the process-global SERVICE
        # worker tasks set their FaultInjector and task id, so COMPILE_SLOW /
        # COMPILE_FAIL fire inside this executor's build jobs
        self.fault_injector = None
        self.fault_task_id = "local"
        # every fallback execution appends {signature, mode, reason,
        # wait_ms} here, mirrored into compile_events (QueryInfo carries it)
        self.fallback_events: list[dict] = []
        self.last_fallback_reason: Optional[str] = None
        self._kernels_ready: set = set()  # service keys whose kernel this executor ran
        self._fell_back: set = set()  # keys that fell back and have not swapped in
        # dynamic filters: scan node id -> (ScanFilter, ...), applied on the
        # host before upload (exec/dynfilter.py); rows outside a join's
        # build-side key domain never reach the card
        self.scan_filters: dict = {}
        self.rows_pruned = 0  # rows those filters dropped
        # keys end in the table's write generation; the split, the pad and
        # the filters are part of every key.  A shared ScanCache holds them
        # for every executor of a node
        cache = scan_cache if scan_cache is not None else ScanCache()
        self.scan_cache = cache
        self._scan_lock = cache.lock
        self._table_cols: dict = cache.cols
        self._table_pages: dict = cache.pages
        # live rows of scan pages padded with dead rows: an empty table or
        # slice scans as one dead row (kernels need a capacity of at least
        # 1), a padded or filtered slice keeps a dead tail
        self._table_live: dict = cache.live
        # host ms spent reading and uploading table columns in the last
        # execute() call (0 when every column was already on the device)
        self.last_upload_ms = 0.0
        # (scan generations, caps, joins sent to the sort path) that
        # completed a query, keyed by plan: repeat executions over the same
        # table generations skip the growth retries.  A write starts the
        # plan over from stats-fed caps (a table that grew 1000-fold would
        # otherwise need more doublings than the retry loop allows)
        self._learned_caps: dict[PlanNode, tuple[tuple, dict[int, int], frozenset]] = (
            cache.learned_caps
        )
        self.last_retries: list[dict] = []
        # the packed `required` values of the last run: {node id: the size
        # that capacity-sized node truly needed} (an Unnest's output rows)
        self.last_required: dict[int, int] = {}

    # ------------------------------------------------------------- table IO
    def table_page(
        self,
        catalog: str,
        table: str,
        columns: Sequence[str],
        types=None,
        scan_id: Optional[int] = None,
    ) -> Page:
        """Device page for the pruned column set; columns are materialized and
        uploaded lazily, once each (the scan-level projection pushdown the
        reference does via ConnectorPageSource lazy blocks).  `scan_id`
        scopes dynamic filters (exec/dynfilter.py) to this scan site: its
        filters drop rows on the host before upload and count them in
        `rows_pruned`; they are part of the cache key, so a filtered and an
        unfiltered site never share columns.  `split` picks the slice of the
        table, `pad_splits` pads it to the slices' common size.

        Columns are cached per write generation of the table (writable
        connectors bump it on every write).  When a table uploads at a new
        generation, its columns of older generations leave the card.  An
        empty table scans as one dead row.

        The scan cache's lock is held only to look up and publish entries:
        a missing column is read and uploaded outside it by the one task
        that marked it in flight, and any other task needing that column
        waits for it."""
        conn = self.catalogs.get(catalog)
        schema = conn.table_schema(table)
        gen = _generation(conn, table)
        filters = self.scan_filters.get(scan_id, ()) if scan_id is not None else ()
        split = self.split
        pad = int(self.split_pad_rows or 0)
        key_of = lambda c: (catalog, table, c, split, pad, filters, gen)
        live_key = (catalog, table, split, pad, filters, gen)
        inflight = self.scan_cache.inflight
        while True:
            with self._scan_lock:
                missing = [c for c in columns if key_of(c) not in self._table_cols]
                if not missing:
                    return self._cached_page(catalog, table, columns, key_of, live_key)
                mine = [c for c in missing if key_of(c) not in inflight]
                theirs = [inflight[key_of(c)] for c in missing if key_of(c) in inflight]
                for c in mine:
                    inflight[key_of(c)] = threading.Event()
                if mine:
                    self._drop_stale(catalog, table, gen)
            if not mine:
                # another task reads these columns: wait for its publish
                # (or its failure, which clears the marker) and look again
                theirs[0].wait()
                continue
            try:
                self._upload_columns(
                    conn, schema, table, mine, filters, pad, key_of, live_key
                )
            finally:
                with self._scan_lock:
                    for c in mine:
                        inflight.pop(key_of(c)).set()

    def _upload_columns(
        self, conn, schema, table, missing, filters, pad, key_of, live_key
    ) -> None:
        """Read `missing` columns of this executor's slice, pad and upload
        them, then publish them in the scan cache (its lock not held while
        the connector reads and the columns upload)."""
        t0 = time.perf_counter()
        split = self.split
        data = self._read_slice(conn, table, missing, filters)
        pad_to = 1  # kernels need a capacity of at least 1
        num_parts = split[1]
        if filters:
            # a pruned slice's size varies run to run: a pow2 capacity
            # keeps the shapes (and learned capacities) few
            pad_to = _pow2(len(next(iter(data.values()))) if data else 0)
        elif self.pad_splits and num_parts > 1:
            pad_to = _slice_pad(conn, table, num_parts)
        if pad:
            # a split-driven morsel: one fixed capacity wins over both
            # pads above (a filtered morsel only shrinks below it)
            pad_to = max(pad_to, pad)
        uploaded = {}
        n_short = None
        for c in missing:
            arr = data[c]
            n_live = len(arr)
            if n_live < pad_to:
                arr = _pad_column(arr, schema.type_of(c), pad_to)
                n_short = n_live
            uploaded[key_of(c)] = Column.from_numpy(
                schema.type_of(c), arr, device=self.device
            )
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        with self._scan_lock:
            if n_short is not None:
                self._table_live[live_key] = n_short
            self._table_cols.update(uploaded)
        self.last_upload_ms += (time.perf_counter() - t0) * 1e3

    def _cached_page(self, catalog, table, columns, key_of, live_key) -> Page:
        """The page of `columns`, every one cached (the caller holds the
        scan lock)."""
        page_key = (catalog, table, tuple(columns)) + live_key[2:]
        cached = self._table_pages.get(page_key)
        if cached is not None:
            return cached
        cols = tuple(self._table_cols[key_of(c)] for c in columns)
        live = None
        n_live = self._table_live.get(live_key)
        if n_live is not None:
            cap = cols[0].capacity if cols else 1
            live = torch.arange(cap, device=self.device) < n_live
        page = Page(cols, live)
        self._table_pages[page_key] = page
        return page

    def _read_slice(self, conn, table: str, missing: list, filters: tuple) -> dict:
        """Host columns `missing` of this executor's slice of `table`, rows
        outside `filters` dropped (and counted in rows_pruned)."""
        part, num_parts = self.split
        want = list(missing) + [f.column for f in filters if f.column not in missing]
        splits = [
            s for i, s in enumerate(conn.get_splits(table, num_parts))
            if num_parts == 1 or i % num_parts == part
        ]
        if not splits:
            # a connector that makes fewer splits than parts (a DB-API table
            # of one split) leaves the other slices empty
            schema = conn.table_schema(table)
            return {c: _empty_column(schema.type_of(c)) for c in missing}
        data = conn.read_split(splits[0], want)
        for sp in splits[1:]:
            more = conn.read_split(sp, want)
            data = {
                c: (np.ma.concatenate([data[c], more[c]])
                    if isinstance(data[c], np.ma.MaskedArray)
                    or isinstance(more[c], np.ma.MaskedArray)
                    else np.concatenate([data[c], more[c]]))
                for c in want
            }
        if not filters:
            return data
        from .dynfilter import keep_mask

        nrows = len(next(iter(data.values()))) if data else 0
        keep = keep_mask(data, filters, nrows)
        self.rows_pruned += int(nrows - keep.sum())
        return {c: data[c][keep] for c in missing}

    def _drop_stale(self, catalog: str, table: str, gen) -> None:
        """Forget the device columns and pages of `catalog.table` at every
        generation but `gen` (a loop of writes would otherwise pin one copy
        of the table per write)."""
        stale = lambda k: k[0] == catalog and k[1] == table and k[-1] != gen
        with self._scan_lock:
            for cache in (self._table_cols, self._table_pages, self._table_live):
                for k in [k for k in cache if stale(k)]:
                    del cache[k]

    def drop_scans(self) -> None:
        """Let go of every cached scan column and page (the out-of-core
        executor calls this between slices, so one slice's working set is
        all that stays on the card)."""
        self.scan_cache.drop_device()

    def drop_table_cache(self, catalog: str, table: str) -> None:
        """Forget every cached generation of `catalog.table` (after a write
        to it commits, or it is dropped)."""
        self._drop_stale(catalog, table, object())

    # ------------------------------------------------------------ execution
    def execute(
        self,
        plan: PlanNode,
        remote_pages: Optional[dict[int, Page]] = None,
        params: tuple = (),
    ) -> Page:
        """Run `plan`.  `remote_pages`: fragment id -> the input page of each
        RemoteSource leaf (on this executor's device).  `params`: the bound
        values of a prepared statement, one per ir.Param index; every
        binding of one plan shares its learned capacities
        (runtime/fastpath.py)."""
        from ..utils.profiler import PROFILER, signature_of

        t0 = time.perf_counter()
        self.last_upload_ms = 0.0
        self.last_compile_ms = 0.0
        self.last_execute_ms = 0.0
        self.execute_events = {}
        n_fallbacks = len(self.fallback_events)
        inputs = self._inputs(plan, remote_pages)
        stats = {} if self.collect_operator_stats else None
        page = self.run_tasks(plan, [(inputs, self.device)], params, stats_rows=stats)[0]
        wall_ms = (time.perf_counter() - t0) * 1e3
        self.last_execute_ms = max(0.0, wall_ms - self.last_compile_ms)
        # a run that fell back is a degraded execution of each kernel it
        # fell back on: attributed apart from the kernel's own runs
        fell_back = {ev["signature"] for ev in self.fallback_events[n_fallbacks:]}
        for ksig in fell_back:
            PROFILER.record_execute(ksig, self.last_execute_ms / 1e3, fallback=True)
        if stats is not None:
            self._record_operator_stats(_node_ids(plan), stats, wall_ms)
            sig = signature_of(plan)
            self.execute_events[sig] = {
                "executes": 1, "execute_s": self.last_execute_ms / 1e3,
                "fallback_executes": 1 if fell_back else 0,
            }
            PROFILER.record_execute(sig, self.last_execute_ms / 1e3)
        return page

    def _kernel_ready(self, recipe, device) -> bool:
        """May this run launch kernel 2 for `recipe` on `device`?  The build
        goes through the compile service (exec/compilesvc.py), deduplicated
        per recipe, card and kernel policy, within this executor's wait
        budget and deadline.  False == run the unfused operator path: counted
        in FALLBACKS by reason and recorded in fallback_events and
        compile_events, never silently.  A build that fails without an armed
        COMPILE_FAIL fault raises its error (nvrtc.NvrtcError with the
        compiler's log) to the query."""
        from ..ops import kernels as _kernels
        from ..ops.cuda import fused_codegen
        from ..runtime.failure import InjectedCompileFailure
        from ..utils.profiler import PROFILER
        from . import compilesvc

        dev = torch.device(device)
        on_card = dev.type == "cuda"
        idx = -1
        if on_card:
            idx = dev.index if dev.index is not None else torch.cuda.current_device()
        rkey = fused_codegen.recipe_key(recipe)
        key = (rkey, dev.type, idx, _kernels.policy_key())
        if key in self._kernels_ready and (
            not on_card or fused_codegen.loaded(recipe, idx) is not None
        ):
            return True
        sig = f"fused_{rkey[:16]}@" + (f"cuda:{idx}" if on_card else "cpu")

        def job():
            if on_card:
                return fused_codegen.build(recipe, idx)
            # on the CPU nothing is compiled: the job prepares the source
            fused_codegen.generate(recipe)
            return None

        svc = self.compile_service or compilesvc.SERVICE
        budget_ms = int(self.compile_wait_budget_ms or 0)

        def obtain():
            return svc.obtain(
                key, sig, job,
                wait_budget_s=budget_ms / 1e3 if budget_ms > 0 else None,
                deadline_s=float(self.compile_deadline_s or 0.0),
                injector=self.fault_injector, fault_task_id=self.fault_task_id,
            )

        out = obtain()
        if out.status == "ready" and on_card and fused_codegen.loaded(recipe, idx) is None:
            # unloaded since it was built (fused_codegen.clear_cache): again
            svc.forget(key)
            out = obtain()
        wait_ms = round(out.waited_s * 1e3, 3)
        self.last_compile_ms += wait_ms
        if out.status == "ready":
            self._kernels_ready.add(key)
            info = out.result
            if key in self._fell_back:
                # swapped in after this executor fell back on it
                self._fell_back.discard(key)
                self.compile_events.append({"signature": sig, "mode": "async", "wait_ms": wait_ms})
            elif info is not None and out.fresh:
                self.compile_events.append({
                    "signature": sig, "compile_s": info["compile_s"], "cache": info["cache"],
                    "mode": "async" if budget_ms > 0 else "sync",
                })
            elif info is not None and out.waited_s > 0:
                # joined another query's build in flight: its wall is the
                # owner's (a build found finished adds nothing)
                self.compile_events.append({"signature": sig, "mode": "async", "wait_ms": wait_ms})
            return True
        if out.status == "error" and not isinstance(out.error, InjectedCompileFailure):
            raise out.error
        reason = out.reason or "compile_wait"
        compilesvc.FALLBACKS.labels(reason).inc()
        PROFILER.record_fallback(sig, reason)
        self.last_fallback_reason = reason
        event = {"signature": sig, "mode": "fallback", "reason": reason, "wait_ms": wait_ms}
        if out.status == "timeout":
            event["error"] = "COMPILE_TIMEOUT"
        self.compile_events.append(event)
        self.fallback_events.append(dict(event))
        self._fell_back.add(key)
        return False

    def _inputs(self, plan: PlanNode, remote_pages: Optional[dict[int, Page]]) -> dict:
        """Input page of every TableScan (uploaded or cached) and
        RemoteSource leaf of `plan`, keyed by preorder id."""
        inputs: dict[str, Page] = {}
        for i, n in _node_ids(plan).items():
            if isinstance(n, TableScan):
                inputs[str(i)] = self.table_page(
                    n.catalog, n.table, n.column_names, n.output_types, scan_id=i
                )
            elif isinstance(n, RemoteSource):
                if remote_pages is None or n.fragment_id not in remote_pages:
                    raise ValueError(f"no input page for fragment {n.fragment_id}")
                inputs[str(i)] = remote_pages[n.fragment_id]
        return inputs

    def _record_operator_stats(self, nodes, rows: dict[int, int], wall_ms=None) -> None:
        """A run's per-node live rows -> the per-operator summary a worker
        ships to the coordinator: {nid: {operator, rows, rows_in,
        output_bytes, invocations}}."""
        stats: dict[int, dict] = {}
        for nid, node in nodes.items():
            if nid not in rows:
                continue  # inside a fused chain: no counter
            child_rows = [rows[c] for c in _child_ids(nodes, nid) if c in rows]
            stats[nid] = {
                "operator": type(node).__name__,
                "rows": rows[nid],
                "rows_in": sum(child_rows) if child_rows else rows[nid],
                "output_bytes": rows[nid] * _est_row_bytes(node),
                "invocations": 1,
            }
        self.last_operator_stats = stats
        self.last_execute_wall_ms = wall_ms

    def _estimate_bytes(self, inputs: dict, caps: dict) -> int:
        """Planned device-memory footprint: the resident input pages plus
        every capacity-sized node's capacity times a nominal row width."""
        total = 0
        for page in inputs.values():
            for col in page.columns:
                total += int(col.capacity) * col.data.element_size()
        ncols = max((len(p.columns) for p in inputs.values()), default=4)
        for cap in caps.values():
            total += int(cap) * 8 * ncols
        return total

    def run_tasks(
        self, plan: PlanNode, tasks: list, params: tuple = (), node_rows: Optional[dict] = None,
        stats_rows: Optional[dict] = None,
    ) -> list[Page]:
        """Run `plan` once per task, `tasks` a list of (inputs, device): one
        task on the CPU or one card, or the D tasks of a distributed
        fragment (exec/spmd.py), the first task's inputs sizing the first
        capacities.  The tasks share one set of capacities: each run's
        `required` sizes are max-reduced over the tasks before the retry
        loop reads them, so every task re-runs at the tier the fullest one
        needs.  Returns the tasks' output pages.  `node_rows`, when given, is filled with each node's
        live rows summed over the tasks (the run that returned; unfused, so
        every node is counted).  `stats_rows`, when given, is filled the
        same way from counters that ride the runs' packed `required`
        transfers, fused chains kept (collect_operator_stats).  Raises
        MemoryBudgetExceeded when `memory_budget_bytes` is set and the
        planned footprint of the first task exceeds it."""
        nodes = _node_ids(plan)
        gens = tuple(
            _generation(self.catalogs.get(n.catalog), n.table)
            for n in nodes.values() if isinstance(n, TableScan)
        )
        learned = self._learned_caps.get(plan)
        if learned is not None and learned[0] == gens:
            _, caps, sort_joins = learned
            start = (caps, sort_joins)
        else:
            caps, sort_joins = self._initial_caps(nodes, tasks[0][0]), frozenset()
            # a fresh process starts at the tiers an earlier one converged
            # to (exec/capcache.py), when they cover every sized node
            stored = capcache.load_caps(plan, tasks[0][0], self.device, caps)
            if stored is not None:
                caps, sort_joins = stored
            start = None
        # capacity bucketing: every cap lands on a pow2 tier.  Also snapshots
        # the dict: the retry loop below mutates caps in place, and learned
        # dicts must not alias it.
        caps = {nid: _pow2(max(int(c), 1)) for nid, c in caps.items()}
        budget = self.memory_budget_bytes
        if budget:
            est = self._estimate_bytes(tasks[0][0], caps)
            self.last_estimated_bytes = est
            if est > budget:
                raise MemoryBudgetExceeded(
                    f"task needs ~{est} bytes of device memory, budget is {budget}"
                )
        # why each re-run of this call happened: {nid: required} of the
        # nodes that overflowed, or {"sort_joins": ids} for failed hash joins
        self.last_retries = []
        for _ in range(12):  # capacity-retry loop
            outs, required, counted, rows = [], {}, [], {}
            for inputs, device in tasks:
                hook = None
                if node_rows is not None:
                    live_of: dict[int, torch.Tensor] = {}
                    counted.append(live_of)

                    def hook(nid, node, stage, _into=live_of):
                        _into[nid] = stage.live.sum(dtype=torch.int64)

                with param_context(params):
                    out_page, req = _trace_plan(
                        plan, inputs, caps, sort_joins, device,
                        node_hook=hook, fuse=node_rows is None,
                        count_rows=stats_rows is not None, kernel_gate=self._kernel_ready,
                    )
                outs.append(out_page)
                # ONE device->host transfer per task
                for key, val in _fetch_required(req).items():
                    if _STATS_ROWS_BASE <= key < _JOIN_GUARD:
                        nid = key - _STATS_ROWS_BASE
                        rows[nid] = rows.get(nid, 0) + val
                        continue
                    required[key] = max(val, required.get(key, val))
                del req, hook
            self.last_required = required
            for key, val in required.items():
                if key < 0 and val > 1:
                    raise RuntimeError("Scalar sub-query has returned multiple rows")
            failed = {
                key - _JOIN_GUARD for key, val in required.items()
                if key >= _JOIN_GUARD and val
            }
            if failed:
                # a hash join's table overflowed or a probe walk ran past
                # its budget: its rows are unusable; run it sorted
                sort_joins = sort_joins | failed
                self.last_retries.append({"sort_joins": sorted(failed)})
                continue
            overflow = {
                nid: req
                for nid, req in required.items()
                if nid in caps and req > caps[nid]
            }
            if not overflow:
                # adaptive compaction: Compact points whose observed surviving
                # count collapses far below their tier get a TIGHT tier for
                # every later run.  A plan that serves every binding of a
                # prepared statement keeps the largest tier any binding
                # needed, so a binding that keeps more rows than the last
                # one does not re-run
                kept = learned[1] if params and learned is not None and learned[0] == gens else {}
                for nid, n in nodes.items():
                    if not isinstance(n, Compact) or nid not in caps:
                        continue
                    req = required.get(nid)
                    if req is None:
                        continue
                    tight = max(_pow2(req * 2 + 1024), kept.get(nid, 0))
                    if tight < caps[nid]:
                        caps[nid] = tight
                self._learned_caps[plan] = (gens, caps, sort_joins)
                if start != (caps, sort_joins):
                    capcache.store_caps(plan, tasks[0][0], self.device, caps, sort_joins)
                if stats_rows is not None:
                    stats_rows.clear()
                    stats_rows.update(rows)
                if node_rows is not None:
                    node_rows.clear()
                    for live_of in counted:
                        for nid, n in _fetch_required(live_of).items():
                            node_rows[nid] = node_rows.get(nid, 0) + n
                return outs
            del outs
            self.last_retries.append(overflow)
            for nid, req in overflow.items():
                caps[nid] = _pow2(max(req, caps[nid] * 2))
        raise RuntimeError(f"capacity retry loop did not converge: {caps}")

    def explain_analyze(
        self, plan: PlanNode, remote_pages: Optional[dict[int, Page]] = None,
        params: tuple = (),
    ) -> tuple[Page, dict]:
        """Execute with per-operator observability (the reference's
        OperatorStats rolled up by ExplainAnalyzeOperator).

        Returns (page, stats) where stats[nid] = {"rows": int, "ms": float}:
        the plan runs once through execute() (capacities learned, result
        checked), then once more at those capacities with the device
        synchronized after every node and every fused chain run operator
        by operator, so each node's time is its own and its row count is
        its live rows.  `remote_pages` feeds a plan
        fragment's RemoteSource leaves (a worker task's distributed EXPLAIN
        ANALYZE, runtime/worker.py)."""
        page = self.execute(plan, remote_pages, params)
        _, caps, sort_joins = self._learned_caps[plan]
        inputs = self._inputs(plan, remote_pages)
        stats: dict[int, dict] = {}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        last = [time.perf_counter()]

        def hook(nid, node, stage):
            rows = int(stage.live.sum())  # synchronizes with the device
            now = time.perf_counter()
            stats[nid] = {"rows": rows, "ms": (now - last[0]) * 1e3}
            last[0] = time.perf_counter()

        with param_context(params):
            _trace_plan(plan, inputs, dict(caps), sort_joins, self.device, node_hook=hook,
                        fuse=False)
        if self.collect_operator_stats:
            # the timing pass is unfused: the inside of a fused chain gets
            # its counts from it
            nodes = _node_ids(plan)
            for nid, st in stats.items():
                if nid not in self.last_operator_stats:
                    self.last_operator_stats[nid] = {
                        "operator": type(nodes[nid]).__name__, "rows": st["rows"],
                        "rows_in": st["rows"],
                        "output_bytes": st["rows"] * _est_row_bytes(nodes[nid]),
                        "invocations": 1,
                    }
        return page, stats

    def _initial_caps(self, nodes, inputs) -> dict[int, int]:
        # stats-fed first guesses (plan/stats.py: group-key NDV products);
        # the retry loop corrects upward when stats are off
        from ..plan.stats import estimate as _est

        caps: dict[int, int] = {}

        def est_groups(n: PlanNode) -> Optional[int]:
            try:
                return int(_est(n, self.catalogs).rows * 1.3) + 16
            except Exception:
                return None

        def size_of(nid: int, n: PlanNode) -> int:
            if isinstance(n, (TableScan, RemoteSource)):
                return inputs[str(nid)].capacity
            if isinstance(n, Values):
                return max(len(n.rows), 1)
            child_sizes = [size_of(c, nodes[c]) for c in _child_ids(nodes, nid)]
            if not child_sizes:
                return 1
            if isinstance(n, (Aggregate, Distinct)):
                hint = est_groups(n)
                cap = hint if hint is not None else 65536
                caps[nid] = min(_pow2(max(cap, 1024)), _pow2(max(child_sizes[0], 1)))
                return caps[nid]
            if isinstance(n, Join):
                if n.kind in ("semi", "anti", "null_anti", "mark", "mark_in"):
                    caps[nid] = _pow2(max(max(child_sizes), 1))
                    return child_sizes[0]
                if n.kind == "cross":
                    return child_sizes[0]
                hard = _pow2(max(max(child_sizes), 1))
                # stats-sized expansion frame: 2x the estimate, floored,
                # capped by the worst case; the retry loop corrects
                # underestimates
                hint = est_groups(n)
                caps[nid] = hard if hint is None else min(hard, _pow2(max(2 * hint, 4096)))
                if n.kind == "left":
                    return caps[nid] + child_sizes[0]
                if n.kind == "full":
                    return caps[nid] + child_sizes[0] + child_sizes[1]
                return caps[nid]
            if isinstance(n, Concat):
                return sum(child_sizes)
            if isinstance(n, Compact):
                # start as a pass-through (cap = input frame): whether this
                # point actually compacts is learned from the first run's
                # TRUE surviving count (the shrink in execute())
                caps[nid] = _pow2(max(child_sizes[0], 1))
                return caps[nid]
            if isinstance(n, TopN):
                # radix-select candidate buffer: room for K plus boundary
                # ties (a 32-bit threshold over a float key can tie
                # thousands of rows); the sort path never overflows it
                caps[nid] = min(
                    _pow2(max(2 * n.count + 512, 16384)),
                    _pow2(max(child_sizes[0], 1)),
                )
                return min(n.count, child_sizes[0])
            if isinstance(n, Unnest):
                # the fan-out is unknown before the run: guess 4x, and the
                # retry loop corrects it
                caps[nid] = _pow2(max(child_sizes[0] * 4, 1024))
                return caps[nid]
            return child_sizes[0]

        size_of(0, nodes[0])
        size_of = None  # the recursive closure holds `inputs`: cut the cycle
        return caps


def _slice_pad(conn, table: str, num_parts: int) -> int:
    """Rows of the largest of `num_parts` slices of `table`: an even share of
    its rows, or where the connector has a unit plan (file-backed: whole
    row groups dealt round-robin, connectors/parquet.py scan_unit_plan) as
    many of its fattest unit as the fullest slice gets, the bound the
    reference's split planner takes (runtime/splits.py scan_split_plan).
    Slices of other uneven connectors (ORC stripes, Iceberg files) that come
    out larger keep their own size and re-learn capacities."""
    total = int(conn.estimated_row_count(table) or 0)
    pad = -(-total // num_parts)
    unit_plan = getattr(conn, "scan_unit_plan", None)
    plan = unit_plan(table) if unit_plan is not None else None
    if plan:
        n_units, max_unit_rows = plan
        pad = max(pad, -(-n_units // num_parts) * max_unit_rows)
    return max(1, pad)


def _empty_column(t) -> np.ndarray:
    return np.empty((0,), dtype=object if (t.is_string or t.is_dict_object) else t.np_dtype)


def _pad_column(arr, t, pad_to: int):
    """`arr` followed by dead rows up to `pad_to` (masked where `arr` is)."""
    fill = np.zeros((pad_to - len(arr),), dtype=object if t.is_string else t.np_dtype)
    if t.is_string:
        fill[:] = ""
    if isinstance(arr, np.ma.MaskedArray):
        return np.ma.concatenate([arr, np.ma.MaskedArray(fill, mask=True)])
    return np.concatenate([arr, fill]) if len(arr) else fill


def _est_row_bytes(node: PlanNode) -> int:
    """Nominal output-row width for the stats pipeline's output_bytes
    estimate (strings count as 16 B of dictionary-coded payload + pointer)."""
    total = 0
    try:
        types = node.output_types
    except Exception:
        return 8
    for t in types:
        if getattr(t, "is_string", False):
            total += 16
        else:
            try:
                total += int(np.dtype(t.np_dtype).itemsize)
            except Exception:
                total += 8
        total += 1  # validity mask byte
    return max(total, 1)


def _fetch_required(required: dict) -> dict[int, int]:
    """Device scalars -> python ints through one packed transfer (a sync per
    counter would serialize the host against every operator)."""
    if not required:
        return {}
    keys = sorted(required)
    packed = torch.stack([required[k].to(torch.int64).reshape(()) for k in keys])
    return dict(zip(keys, packed.tolist()))


def _child_ids(nodes: dict[int, PlanNode], nid: int) -> list[int]:
    n = nodes[nid]
    ids = []
    next_id = nid + 1
    for c in n.children:
        ids.append(next_id)
        next_id += len(_node_ids(c))
    return ids


def fused_fragment(node: Aggregate):
    """The scan-level form of an Aggregate over a straight Filter/Project
    chain over a TableScan: (scan, filters, keys, args, chain depth) with
    every predicate, group key and aggregate argument substituted down to
    the scan's columns (plan/ir.substitute) — or None when the fragment has
    another shape (DISTINCT / two-argument / ordered aggregates included).

    Compact points in the chain are looked through: they change where rows
    sit, not which rows exist, and a fused pass never materializes the
    frame they would shrink.  (The optimizer wraps every filter over a
    frame of 65,536 rows or more in one, so without this no table of
    realistic size would fuse.)"""
    from ..plan.ir import FieldRef, substitute

    for a in node.aggs:
        if a.distinct or a.arg2 is not None or a.order_keys:
            return None
    chain: list[PlanNode] = []
    cur = node.child
    while isinstance(cur, (Filter, Project, Compact)):
        chain.append(cur)
        cur = cur.child
    if not isinstance(cur, TableScan):
        return None
    colmap: list = [FieldRef(i, t) for i, t in enumerate(cur.output_types)]
    filters = []
    for link in reversed(chain):
        if isinstance(link, Filter):
            filters.append(substitute(link.predicate, colmap))
        elif isinstance(link, Project):
            colmap = [substitute(e, colmap) for e in link.expressions]
    keys = [substitute(k, colmap) for k in node.group_keys]
    args = [
        None if a.arg is None else substitute(a.arg, colmap)
        for a in node.aggs
    ]
    return cur, filters, keys, args, len(chain)


def scan_column_vals(page: Page, scan: TableScan) -> list[ColumnVal]:
    """A scan page's columns as expression values typed by the plan."""
    cols = [column_val(c) for c in page.columns]
    for cv, t in zip(cols, scan.output_types):
        cv.type = t
    return cols


def _trace_plan(
    plan: PlanNode, pages: dict[str, Page], caps: dict[int, int],
    sort_joins: frozenset = frozenset(), device="cuda", node_hook=None, fuse: bool = True,
    count_rows: bool = False, kernel_gate=None,
):
    """Walk a plan, running each operator eagerly.  Returns (output page,
    required): `required` maps the preorder id of every capacity-sized node
    to a device scalar holding the size that node truly needed (plus the
    EnforceSingleRow counts and join guards, see the module docstring).
    Joins whose ids are in `sort_joins` take the sort path; `device` holds
    the rows of a Values node; `node_hook(nid, node, stage)`, when given,
    runs after each node (EXPLAIN ANALYZE's per-operator statistics);
    `fuse=False` keeps every node of a fusible aggregate chain its own
    (so each gets its hook); `count_rows` reports each node's live output
    rows under _STATS_ROWS_BASE + nid (a fused chain: its Aggregate and its
    TableScan); `kernel_gate(recipe, device)`, when given, decides whether a
    fused chain may launch kernel 2 now (LocalExecutor._kernel_ready, the
    compile service) — False runs the chain unfused."""
    from ..ops import kernels as _kernels

    required: dict[int, torch.Tensor] = {}
    counter = [0]

    def report(nid: int, value) -> None:
        required[nid] = value

    def check_limbed(stage: _Stage, what: str) -> _Stage:
        # the reference refuses the high limb of a decimal128 column through
        # a union or a window (its exec/compiler.py check_limbed); so does
        # the port
        if any(cv.data2 is not None for cv in stage.cols):
            raise NotImplementedError(f"decimal128 columns through {what}")
        return stage

    def _try_fused_aggregate(node: Aggregate, nid: int) -> Optional[_Stage]:
        """An Aggregate whose input is a straight Filter/Project chain over a
        TableScan collapses into one fused pass (ops/cuda/fused.py) that
        reads the scan columns from device memory exactly once.  Predicates
        and aggregate arguments are substituted down to scan level
        (plan/ir.substitute); anything the pipeline can't express — wide key
        domains, non-dictionary keys, aggregates beyond sum/count/avg —
        declines here and takes the operator-at-a-time path, so this is a
        pure fast path.  On the card it runs the CUDA kernel, on CPU tensors
        the kernel's plain version."""
        from ..ops.cuda import fused as _fused

        if not (fuse and _kernels.get_policy().enabled):
            return None
        frag = fused_fragment(node)
        if frag is None:
            return None
        scan, filters, keys, args, depth = frag
        # a prepared statement's parameters enter the recipe as this run's
        # values: constants are kernel arguments, so the compile is shared
        filters = [bind_params(f) for f in filters]
        args = [None if a is None else bind_params(a) for a in args]
        scan_nid = nid + 1 + depth
        page = pages.get(str(scan_nid))
        if page is None or len(page.columns) != len(scan.output_types):
            return None
        scan_cols = scan_column_vals(page, scan)
        recipe, _why = _fused.plan_pipeline(
            scan_cols, filters, keys,
            [a.fn for a in node.aggs], args, [a.type for a in node.aggs],
        )
        if recipe is None:
            return None
        if kernel_gate is not None and not kernel_gate(recipe, page.device):
            return None  # kernel not built yet: the unfused path runs it
        counter[0] = scan_nid + 1  # consume the whole chain's id range
        _kernels.record_dispatch(
            "fused_pipeline", _kernels.impl_for(page.device),
            f"{len(filters)} filters {len(recipe.streams)} streams "
            f"domain {recipe.domain}",
        )
        # an all-live page passes no mask; a recipe that reads no column
        # still needs one for the row count
        live = page.live if recipe.table else page.live_mask()
        totals = _fused.run(recipe, scan_cols, live)
        key_codes, agg_cols, out_live, n_groups = _fused.assemble(recipe, totals)
        report(nid, n_groups)
        if count_rows:
            required[_STATS_ROWS_BASE + scan_nid] = page.live_mask().sum(dtype=torch.int64)
        cols: list[ColumnVal] = []
        for code, ke, (ci, _, _) in zip(key_codes, node.group_keys, recipe.keys):
            cols.append(ColumnVal(code, None, scan_cols[ci].dict, ke.type))
        for out, a in zip(agg_cols, node.aggs):
            hi = None
            if len(out) == 4:  # decimal128 sum: (lo, valid, None, hi)
                data, valid, _d, hi = out
            else:
                data, valid = out
            cols.append(ColumnVal(data, valid, None, a.type, data2=hi))
        return _Stage(cols, out_live)

    def emit(node: PlanNode) -> _Stage:
        nid = counter[0]
        stage = emit_node(node)
        if count_rows:
            required[_STATS_ROWS_BASE + nid] = stage.live.sum(dtype=torch.int64)
        if node_hook is not None:
            node_hook(nid, node, stage)
        return stage

    def emit_node(node: PlanNode) -> _Stage:
        nid = counter[0]
        counter[0] += 1

        if isinstance(node, (TableScan, RemoteSource)):
            page = pages[str(nid)]
            return _Stage(scan_column_vals(page, node), page.live_mask())

        if isinstance(node, Filter):
            s = emit(node.child)
            mask = eval_predicate(node.predicate, s.cols, s.capacity, s.live.device)
            return _Stage(s.cols, s.live & mask)

        if isinstance(node, Compact):
            s = emit(node.child)
            C = caps.get(nid, s.capacity)
            if C >= s.capacity:
                # pass-through tier: nothing to gain — but REPORT the live
                # count so the post-run shrink can learn the true surviving
                # rows and tighten this point for later runs
                report(nid, s.live.sum(dtype=torch.int64))
                return s
            cols, live, req = compact_rows(s.cols, s.live, C)
            report(nid, req)
            return _Stage(cols, live)

        if isinstance(node, Project):
            s = emit(node.child)
            cols = [
                eval_expr(e, s.cols, s.capacity, s.live.device)
                for e in node.expressions
            ]
            return _Stage(cols, s.live)

        if isinstance(node, Aggregate):
            fused = _try_fused_aggregate(node, nid)
            if fused is not None:
                return fused
            s = emit(node.child)
            G = caps[nid]
            dev = s.live.device
            keys = [eval_expr(k, s.cols, s.capacity, dev) for k in node.group_keys]
            args = [
                None if a.arg is None else eval_expr(a.arg, s.cols, s.capacity, dev)
                for a in node.aggs
            ]
            args2 = [
                None if a.arg2 is None else eval_expr(a.arg2, s.cols, s.capacity, dev)
                for a in node.aggs
            ]
            specs = [
                AggSpec(a.fn, a.distinct, a.param, a.sep, a.type)
                for a in node.aggs
            ]
            aorder = [
                tuple(
                    (eval_expr(k, s.cols, s.capacity, dev), asc, nf)
                    for k, asc, nf in a.order_keys
                )
                for a in node.aggs
            ]
            out_keys, out_aggs, out_live, n_groups = group_aggregate(
                keys, args, specs, s.live, G, agg_args2=args2, agg_order=aorder
            )
            report(nid, n_groups)
            cols: list[ColumnVal] = []
            for (data, valid, khi), kv in zip(out_keys, keys):
                cols.append(ColumnVal(data, valid, kv.dict, kv.type, khi))
            for out, a, arg in zip(out_aggs, node.aggs, args):
                hi = None
                if len(out) == 4:  # decimal128 sum: (lo, valid, None, hi)
                    data, valid, d, hi = out
                elif len(out) == 3:  # host-collected: carries its own dictionary
                    data, valid, d = out
                else:
                    data, valid = out
                    d = arg.dict if (arg is not None and a.fn in ("min", "max")) else None
                cols.append(ColumnVal(data, valid, d, a.type, data2=hi))
            return _Stage(cols, out_live)

        if isinstance(node, EnforceSingleRow):
            s = emit(node.child)
            # the host raises when this exceeds 1 (the scalar-subquery
            # contract; reference: EnforceSingleRowOperator)
            report(-(nid + 1), s.live.sum(dtype=torch.int64))
            return s

        if isinstance(node, Distinct):
            s = emit(node.child)
            out_keys, _, out_live, n_groups = group_aggregate(
                s.cols, [], [], s.live, caps[nid]
            )
            report(nid, n_groups)
            cols = [
                ColumnVal(data, valid, cv.dict, cv.type, khi)
                for (data, valid, khi), cv in zip(out_keys, s.cols)
            ]
            return _Stage(cols, out_live)

        if isinstance(node, Join):
            # decimal128 columns ride the join: the expansion gathers, the
            # left/full null-extension concats and the exact key equality
            # all carry the high limb (ops/relops.py equi_join)
            left = emit(node.left)
            right = emit(node.right)
            if node.kind == "cross":
                cols, live = broadcast_single_row(
                    left.cols, left.live, right.cols, right.live
                )
                return _Stage(cols, live)
            C = caps[nid]
            lkeys = [eval_expr(k, left.cols, left.capacity, left.live.device)
                     for k in node.left_keys]
            rkeys = [eval_expr(k, right.cols, right.capacity, right.live.device)
                     for k in node.right_keys]
            lkeys, rkeys = _align_join_keys(lkeys, rkeys)
            residual = None
            if node.residual is not None:
                res_ir = node.residual

                def residual(gathered, cap, _ir=res_ir, _dev=left.live.device):
                    return eval_predicate(_ir, gathered, cap, _dev)

            cols, live, req, hash_failed = equi_join(
                node.kind, left.cols, left.live, right.cols, right.live,
                lkeys, rkeys, residual, C, force_sort=nid in sort_joins,
            )
            report(nid, req)
            report(_JOIN_GUARD + nid, hash_failed)
            return _Stage(cols, live)

        if isinstance(node, TopN):
            s = emit(node.child)  # limbed payloads ride the gathers
            dev = s.live.device
            keys = [eval_expr(k.expr, s.cols, s.capacity, dev) for k in node.keys]
            specs = [SortSpec(k.ascending, k.nulls_first) for k in node.keys]
            cols, live, req = top_n(s.cols, s.live, keys, specs, node.count, caps.get(nid))
            report(nid, req)
            return _Stage(cols, live)

        if isinstance(node, Sort):
            s = emit(node.child)  # limbed payloads ride sort_rows' gathers
            dev = s.live.device
            keys = [eval_expr(k.expr, s.cols, s.capacity, dev) for k in node.keys]
            specs = [SortSpec(k.ascending, k.nulls_first) for k in node.keys]
            cols, live = sort_rows(s.cols, s.live, keys, specs)
            return _Stage(cols, live)

        if isinstance(node, Limit):
            s = emit(node.child)
            return _Stage(s.cols, limit_mask(s.live, node.count))

        if isinstance(node, Concat):
            stages = [check_limbed(emit(c), "union") for c in node.inputs]
            cols = [
                _concat_columns([st.cols[ci] for st in stages], t)
                for ci, t in enumerate(node.output_types)
            ]
            return _Stage(cols, torch.cat([st.live for st in stages]))

        if isinstance(node, Window):
            from ..ops.window import window_eval

            s = check_limbed(emit(node.child), "window")
            dev = s.live.device
            part = [eval_expr(k, s.cols, s.capacity, dev) for k in node.partition_by]
            okeys = [eval_expr(k.expr, s.cols, s.capacity, dev) for k in node.order_by]
            ospecs = [SortSpec(k.ascending, k.nulls_first) for k in node.order_by]
            argv = [
                tuple(eval_expr(a, s.cols, s.capacity, dev) for a in c.args)
                for c in node.calls
            ]
            cols, live = window_eval(s.cols, s.live, part, okeys, ospecs, node.calls, argv)
            return _Stage(cols, live)

        if isinstance(node, Unnest):
            s = check_limbed(emit(node.child), "unnest")
            dev = s.live.device
            arrays = [eval_expr(a, s.cols, s.capacity, dev) for a in node.arrays]
            cols, live, req = unnest_expand(
                s.cols, s.live, arrays, node.element_types,
                node.with_ordinality, node.outer, caps[nid],
            )
            report(nid, req)
            return _Stage(cols, live)

        if isinstance(node, MatchRecognize):
            # a host operator: the pattern walk is a sequential backtracking
            # VM.  The reference forces such plans off its traced path onto
            # the eager one; this executor is always eager, so nothing more
            # is needed here
            from ..ops.matchrec import execute_match

            s = emit(node.child)
            cols, live = execute_match(node, s.cols, s.live)
            return _Stage(cols, live)

        if isinstance(node, Values):
            dev = torch.device(device)
            cols = []
            for ci, t in enumerate(node.types):
                vals = np.asarray([r[ci] for r in node.rows], dtype=t.np_dtype)
                cols.append(ColumnVal(torch.from_numpy(vals).to(dev), None, None, t))
            live = torch.arange(max(len(node.rows), 1), device=dev) < len(node.rows)
            if not node.types:
                live = torch.ones((len(node.rows) or 1,), dtype=torch.bool, device=dev)
            return _Stage(cols, live)

        name = type(node).__name__
        if name == "Exchange":
            raise NotImplementedError(
                "an Exchange runs between the tasks of a distributed plan: "
                "exec/spmd.py (exchanges in device memory) or exec/spill.py (out "
                "of core) executes the plan; LocalExecutor runs one fragment"
            )
        raise NotImplementedError(
            f"plan node {name} is not ported to trino_tpu_torch yet "
            f"(ROADMAP {_ROADMAP_ITEM.get(name, 'A.11')})"
        )

    events = _kernels.begin_capture()
    try:
        stage = emit(plan)
    finally:
        _kernels.end_capture()
        clear_run_memos()
        # emit and emit_node call each other through their closures: a
        # reference cycle that would keep this run's pages and intermediates
        # on the card until the cyclic collector ran.  Cut it now
        emit = emit_node = None
    _kernels.remember(plan, events)
    out_page = Page(
        tuple(
            Column(cv.type, cv.data, cv.valid, cv.dict, cv.data2)
            for cv in stage.cols
        ),
        stage.live,
    )
    return out_page, required


def _concat_columns(parts: list[ColumnVal], t) -> ColumnVal:
    """Row-concatenate column fragments; varchar fragments are re-coded into
    a merged dictionary on the host (a dictionary-less fragment is a NULL
    literal: its codes are masked)."""
    if any(p.dict is not None for p in parts):
        merged = Dictionary(np.unique(np.concatenate(
            [p.dict.values for p in parts if p.dict is not None]
        )))
        datas = []
        for p in parts:
            if p.dict is None:
                datas.append(torch.zeros_like(p.data, dtype=torch.int32))
            else:
                datas.append(translate_codes(p, merged))
        data = torch.cat(datas)
        out_dict = merged
    else:
        dtype = torch.from_numpy(np.zeros((0,), dtype=t.np_dtype)).dtype
        data = torch.cat([p.data.to(dtype) for p in parts])
        out_dict = None
    if all(p.valid is None for p in parts):
        valid = None
    else:
        valid = torch.cat([
            p.valid if p.valid is not None
            else torch.ones(p.data.shape, dtype=torch.bool, device=p.data.device)
            for p in parts
        ])
    return ColumnVal(data, valid, out_dict, t)


def _align_join_keys(lkeys: list[ColumnVal], rkeys: list[ColumnVal]):
    """Translate dictionary codes so both sides of a varchar key share one
    code space (host-side table, gathered on the device)."""
    out_l, out_r = [], []
    for a, b in zip(lkeys, rkeys):
        if a.dict is not None and b.dict is not None and a.dict is not b.dict:
            data = translate_codes(b, a.dict)
            valid = b.valid if b.valid is not None else torch.ones_like(data, dtype=torch.bool)
            # codes of -1 (absent from a's dictionary) must not match
            b = ColumnVal(data, valid & (data >= 0), a.dict, b.type)
        out_l.append(a)
        out_r.append(b)
    return out_l, out_r
