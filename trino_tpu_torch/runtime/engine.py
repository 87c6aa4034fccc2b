"""Engine facade: SQL string in, rows out.

The single-process counterpart of the reference's coordinator pipeline
(dispatcher/DispatchManager.createQuery -> SqlQueryExecution.start ->
LogicalPlanner -> scheduler -> operators), collapsed to:
parse -> plan (plan/planner.py) -> execute (exec/compiler.py), plus the
statement surface (DDL/DML/views/prepared statements/transactions/EXPLAIN/
SHOW/SET SESSION — the reference's DataDefinitionTask family and writer
plans) over writable connectors such as connectors/memory.py.

A write runs its source query on the device, exports the result page to
host numpy (`Page.to_numpy_columns`), stages it through the connector's
write handle (runtime/txn.py) and commits; the next scan of the table
uploads the new generation.  Row-level DML lowers to table rewrites
(runtime/dml.py).

A query whose estimated device bytes exceed the budget (the session's
`query_max_memory_bytes`, else 80 % of the card's memory) runs out of core
(exec/spill.py): its distributed plan's fragments one slice after another
on the card, the exchanges parked on disk.  A query the estimate admitted
but that runs out of device memory is re-run the same way.  EXECUTE takes
the prepared-statement fast path (runtime/fastpath.py: one cached plan per
template, parameters bound per run) and substitutes and re-plans only where
that path declines.

`Engine(distributed=True, devices=[...])` runs every query over a list of
devices (exec/spmd.py; a card may repeat: four workers on one card): plan()
returns the distributed plan (plan/distribute.py), whose fragments run as
one task per device with the exchanges kept in device memory.  Plans with
host-collected aggregates stay local on a fallback executor, as in the
reference; no budget and no out-of-core run apply.  EXPLAIN renders the
distributed plan, EXPLAIN ANALYZE its row counts summed over the tasks.

The multi-host cluster (runtime/coordinator.py, runtime/worker.py) runs
statements through a subclass of this engine whose queries go to the
workers; there, EXPLAIN ANALYZE renders the coordinator's QueryInfo per
stage (`_explain_analyze_distributed`), and writes journal into the
coordinator's query journal.  An in-process engine keeps neither.
"""

from __future__ import annotations

import threading
from typing import Optional
import time as _time

import numpy as np
import torch

from ..connectors.spi import CatalogManager, ColumnSchema, Connector
from ..data.page import Page
from ..exec.compiler import LocalExecutor
from ..plan.nodes import PlanNode, TableScan, format_plan
from ..plan.planner import Planner
from .session import SessionProperties
from .txn import run_write  # imported eagerly: registers the txn metrics

__all__ = ["Engine"]


def _rescale_column(arr, src_type, dst_type):
    """Align a query-result column with the target table's column type.
    Decimal lanes are scaled int64 (data/types.py DecimalType), so writing
    them into a double/int/differently-scaled column must rescale — a plain
    astype would persist the raw lanes (e.g. 1.5 stored as 15)."""
    src_dec = getattr(src_type, "scale", None) if src_type.is_decimal else None
    dst_dec = getattr(dst_type, "scale", None) if dst_type.is_decimal else None
    if src_dec is None and dst_dec is None:
        return arr
    mask = np.ma.getmaskarray(arr) if isinstance(arr, np.ma.MaskedArray) else None
    base = np.ma.getdata(arr) if mask is not None else np.asarray(arr)
    if src_dec is not None and dst_dec is None:
        out = (
            base.astype(np.float64) / (10.0**src_dec)
            if dst_type.is_floating
            else np.round(base.astype(np.float64) / (10.0**src_dec)).astype(np.int64)
        )
    elif src_dec is None and dst_dec is not None:
        out = np.round(base.astype(np.float64) * (10.0**dst_dec)).astype(np.int64)
    elif src_dec != dst_dec:
        out = np.round(base.astype(np.float64) * (10.0 ** (dst_dec - src_dec))).astype(
            np.int64
        )
    else:
        return arr
    return np.ma.MaskedArray(out, mask=mask) if mask is not None else out


def _null_column(t, n: int) -> np.ma.MaskedArray:
    """`n` NULLs of type `t`: every lane masked, over the type's empty
    value ("" for VARCHAR, () for arrays / maps / rows, 0 otherwise) so the
    column concatenates and dictionary-encodes with the table's values."""
    if t.is_string or t.is_dict_object:
        fill = np.empty((n,), dtype=object)
        fill.fill("" if t.is_string else ())
    else:
        fill = np.zeros((n,), dtype=t.np_dtype)
    return np.ma.MaskedArray(fill, mask=np.ones((n,), dtype=bool))


def _host_collected(plan: PlanNode) -> bool:
    """Plans the distributed engine runs locally: host-collected aggregates
    (array_agg / map_agg / listagg) and MATCH_RECOGNIZE (the reference's
    exec/compiler.py `_has_host_aggs`)."""
    from ..ops.relops import HOST_AGGS
    from ..plan.nodes import Aggregate, MatchRecognize, walk

    return any(
        isinstance(n, MatchRecognize)
        or (isinstance(n, Aggregate) and any(a.fn in HOST_AGGS for a in n.aggs))
        for n in walk(plan)
    )


def _compile_lines(events) -> list[str]:
    """The EXPLAIN ANALYZE `-- compile:` lines of one local run: each NVRTC
    build of kernel 2, each swap-in of a kernel built in the background and
    each fallback to the unfused path (exec/compilesvc.py)."""
    out = []
    for ev in events:
        sig = ev.get("signature", "?")
        if ev.get("mode") == "fallback":
            out.append(
                f"-- compile: {sig} fallback ({ev.get('reason', '?')}, waited "
                f"{ev.get('wait_ms', 0.0):.1f} ms"
                + (f", {ev['error']}" if ev.get("error") else "") + ")"
            )
        elif ev.get("compile_s") is None:
            out.append(f"-- compile: {sig} async (joined after {ev.get('wait_ms', 0.0):.1f} ms)")
        else:
            out.append(
                f"-- compile: NVRTC {sig} {ev['compile_s'] * 1e3:.1f} ms "
                f"[disk cache: {ev.get('cache', '?')}]"
            )
    return out


def _compile_cache_line() -> str:
    """The footprint of kernel 2's cubin cache on disk (utils/compilecache.py)."""
    from ..utils.profiler import PROFILER

    disk = PROFILER.disk_cache()
    return f"-- compile cache: {disk['entries']} cubins, {disk['bytes']} bytes on disk"


class Engine:
    """`device` is where table pages live and operators run: the CUDA card by
    default (raises when there is none), the CPU only on request.
    `distributed=True` runs every query over `devices` (default: every
    visible card; on the CPU, `device` alone) through exec/spmd.py — the
    in-process counterpart of the reference's DistributedQueryRunner."""

    def __init__(
        self, default_catalog: str = "tpch", device="cuda", distributed: bool = False,
        devices=None,
    ):
        self.catalogs = CatalogManager()
        self.default_catalog = default_catalog
        self.planner = Planner(self.catalogs, default_catalog)
        self.distributed = distributed
        if distributed:
            from ..exec.spmd import SpmdExecutor

            if devices is None and torch.device(device).type != "cuda":
                devices = [device]
            self.executor = SpmdExecutor(self.catalogs, default_catalog, devices)
            # plans with host-collected aggregates run here, on the first device
            self._local_fallback = LocalExecutor(
                self.catalogs, default_catalog, device=self.executor.device
            )
        else:
            self.executor = LocalExecutor(self.catalogs, default_catalog, device=device)
            self._local_fallback = self.executor
        self.device = self.executor.device
        self.session = SessionProperties()
        self._prepared: dict[str, str] = {}
        self._view_sql: dict[tuple[str, str], str] = {}  # SHOW CREATE VIEW
        self._tx_views = None  # (views, view_sql) snapshot inside a tx
        self._tx_snapshots = None  # name -> connector snapshot, inside a tx
        from .security import AllowAllAccessControl

        # reference: security/AccessControlManager consulted before planning
        self.access_control = AllowAllAccessControl()
        self.user = "user"
        # write-transaction plane (runtime/txn.py): per-thread write sequence
        # of the transaction ids; a FaultInjector (runtime/failure.py) set
        # here fires the write faults; a coordinator's statement surface
        # sets its query journal (runtime/journal.py)
        self.txn_journal = None
        self.write_fault_injector = None
        self._txn_local = threading.local()
        self._last_txn_info = None  # EXPLAIN ANALYZE `-- txn:` footer
        # the out-of-core executor of the last query that spilled (its
        # spilled_bytes / spill_files / rows_pruned); None until one does
        self.last_spill = None
        self._device_bytes = None  # the card's memory, read at the first budget
        # host milliseconds of the last statement's write-source queries,
        # split into running them (plan + execute on the device, synchronized)
        # and exporting their pages to numpy
        self.last_write_split = {"query_ms": 0.0, "export_ms": 0.0}

    def register_catalog(self, name: str, connector: Connector) -> None:
        self.catalogs.register(name, connector)

    # ------------------------------------------------------------- queries
    def plan(self, sql_or_query) -> PlanNode:
        from ..plan.nodes import walk
        from ..plan.optimizer import optimize

        plan = optimize(self.planner.plan(sql_or_query), self.catalogs, self.session)
        # table-level SELECT checks on the final plan: base tables of views/
        # CTEs/subqueries are all visible as scans here (reference:
        # checkCanSelectFromColumns per analyzed table reference)
        for n in walk(plan):
            if isinstance(n, TableScan):
                self.access_control.check_can_select(
                    self.user, n.catalog, n.table, n.column_names
                )
        if self.distributed and not _host_collected(plan):
            from ..plan.distribute import distribute

            plan = distribute(plan, self.catalogs, self.executor.num_devices, self.session)
        return plan

    def explain(self, sql: str) -> str:
        return format_plan(self.plan(sql))

    def execute_page(self, sql) -> Page:
        return self._execute_planned(self.plan(sql))

    def _device_memory_budget(self) -> int:
        """Per-query device-memory budget in bytes: the session property
        when set, else (0 = auto) 80 % of the card's memory; -1 turns the
        budget off (never out of core).  0 = no budget: on the CPU unless
        the session sets one."""
        budget = int(self.session.get("query_max_memory_bytes") or 0)
        if budget == -1:
            return 0
        if budget:
            return budget
        if self.device.type != "cuda":
            return 0
        if self._device_bytes is None:  # the card's size: one driver call per engine
            self._device_bytes = int(torch.cuda.mem_get_info(self.device)[1])
        return int(self._device_bytes * 0.8)

    @staticmethod
    def _is_device_oom(e: Exception) -> bool:
        """A device out-of-memory error (torch's, or one carrying the
        reference's markers); nothing else re-runs out of core."""
        if isinstance(e, torch.cuda.OutOfMemoryError):
            return True
        s = str(e)
        return "RESOURCE_EXHAUSTED" in s or "Out of memory" in s or "OOM" in s

    def _run_out_of_core(self, plan, est: int, budget: int, params: tuple = ()) -> Page:
        from ..exec.spill import OutOfCoreExecutor

        parts = max(2, min(16, -(-est // max(budget, 1))))
        # pow2 slices, capped at 16: past that the per-slice overhead
        # outweighs the memory saved
        parts = 1 << (parts - 1).bit_length()
        ooc = OutOfCoreExecutor(
            self.catalogs, self.default_catalog, parts, self.session, device=self.device,
        )
        self.last_spill = ooc  # observable: spilled_bytes / spill_files
        return ooc.execute(plan, params)

    def _execute_planned(self, plan, params: tuple = ()) -> Page:
        """Run a planned query: every read path comes here (queries, the
        sources of writes, EXECUTE and EXPLAIN ANALYZE EXECUTE).  `params`
        are a prepared statement's bound values."""
        self._apply_kernel_props()
        if self.distributed:  # no budget, no out-of-core run
            return self._executor_for(plan).execute(plan, params=params)
        budget = self._device_memory_budget()
        if not budget:
            return self.executor.execute(plan, params=params)
        from ..exec.spill import estimate_plan_bytes

        est = estimate_plan_bytes(plan, self.catalogs)
        if est > budget:
            return self._run_out_of_core(plan, est, budget, params)
        try:
            return self.executor.execute(plan, params=params)
        except RuntimeError as e:  # torch.cuda.OutOfMemoryError is one
            if not self._is_device_oom(e):
                raise
        # REACTIVE spill (reference: revocable memory +
        # SpillableHashAggregationBuilder): the estimate admitted the query
        # but its state outgrew the card.  Outside the handler, so the
        # failed attempt's tensors are gone; the whole tables it uploaded
        # leave the card too, then P is sized from the shortfall
        self.executor.drop_scans()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return self._run_out_of_core(plan, max(est, budget) * 2, budget, params)

    def _executor_for(self, plan: PlanNode):
        """The executor of a planned query: a distributed engine's host-
        collected plans came back undistributed and run locally."""
        if self.distributed and _host_collected(plan):
            return self._local_fallback
        return self.executor

    def _apply_kernel_props(self) -> None:
        """Session → data-plane kernel policy (ops/kernels.py) and the
        compile plane's knobs on the executors (exec/compilesvc.py): how
        long a query waits for kernel 2's build, and the build's hard
        deadline.  Re-applied per statement so SET SESSION takes effect
        immediately."""
        from ..ops import kernels as _kernels

        for ex in {self.executor, self._local_fallback}:
            ex.compile_wait_budget_ms = int(self.session.get("compile_wait_budget_ms") or 0)
            ex.compile_deadline_s = float(self.session.get("compile_deadline_s") or 0.0)

        _kernels.set_policy(_kernels.KernelPolicy(
            enabled=bool(self.session.get("data_plane_kernels")),
            hash_agg_max_groups=int(self.session.get("hash_agg_kernel_limit")),
            hash_join_max_build=int(self.session.get("hash_join_kernel_limit")),
        ))

    def query(self, sql) -> list[tuple]:
        """Run a query, return rows as python tuples (None == NULL)."""
        return self.execute_page(sql).to_pylist()

    def warm_from_history(self, history, limit: int = 8) -> int:
        """Replay the top-``limit`` recurring FINISHED statements of a
        QueryHistoryStore, so their kernel 2 builds (through the compile
        service) and scan uploads are paid before the first client query
        (runtime/warmup.py); returns how many statements warmed."""
        from .warmup import warm_from_history as _warm

        return _warm(self.query, history, limit)

    def _query_columns(self, query) -> tuple[list, list, list]:
        """(names, types, host column arrays) of a query result — the write
        path's input."""
        t0 = _time.perf_counter()
        plan = self.plan(query)
        page = self._execute_planned(plan)
        if page.device.type == "cuda":
            torch.cuda.synchronize(page.device)
        t1 = _time.perf_counter()
        cols = page.to_numpy_columns()
        t2 = _time.perf_counter()
        self.last_write_split["query_ms"] += (t1 - t0) * 1e3
        self.last_write_split["export_ms"] += (t2 - t1) * 1e3
        return list(plan.output_names), list(plan.output_types), cols

    # ---------------------------------------------------- statement surface
    def execute(self, sql: str) -> list[tuple]:
        """Full statement surface: queries, DDL/DML, views, PREPARE /
        EXECUTE / DEALLOCATE, transactions, EXPLAIN [ANALYZE], SHOW TABLES,
        DESCRIBE, SET SESSION."""
        from ..sql import statements as S

        return self.execute_stmt(S.parse_statement(sql))

    def execute_stmt(self, stmt, prepared: Optional[dict] = None) -> list[tuple]:
        """`prepared`: the client-held prepared statements (name -> sql) a
        protocol request carries; they win over the engine's own."""
        from ..sql import statements as S

        # access control at statement dispatch (reference: AccessControl
        # checkCanInsertIntoTable / checkCanDropTable / ... before execution;
        # SELECT is checked per-scan in plan())
        if isinstance(stmt, (S.CreateTable, S.CreateTableAs)):
            self._check_write(stmt.name, "create")
        elif isinstance(stmt, (S.Insert, S.InsertValues)):
            self._check_write(stmt.table, "insert")
        elif isinstance(stmt, S.DropTable):
            self._check_write(stmt.name, "drop")
        elif isinstance(stmt, S.Delete):
            self._check_write(stmt.table, "delete")
        elif isinstance(stmt, S.Update):
            self._check_write(stmt.table, "update")
        elif isinstance(stmt, S.Merge):
            self._check_write(stmt.target, "merge")
        elif isinstance(stmt, S.CreateView):
            self._check_write(stmt.name, "create_view")
        elif isinstance(stmt, S.DropView):
            self._check_write(stmt.name, "drop_view")
        elif isinstance(stmt, S.SetSession):
            self.access_control.check_can_set_session(self.user, stmt.name)

        self.last_write_split = {"query_ms": 0.0, "export_ms": 0.0}
        if isinstance(stmt, S.QueryStmt):
            return self.query(stmt.query)

        if isinstance(stmt, S.Explain):
            return self._execute_explain(stmt, prepared)

        if isinstance(stmt, S.CreateTable):
            from ..data.types import parse_type

            conn, name = self._target_conn(stmt.name)
            if stmt.if_not_exists and name in conn.list_tables():
                return [(0,)]
            conn.create_table(
                name, [ColumnSchema(n, parse_type(t)) for n, t in stmt.columns]
            )
            return [(0,)]

        if isinstance(stmt, S.CreateTableAs):
            conn, name = self._target_conn(stmt.name)
            if stmt.if_not_exists and name in conn.list_tables():
                return [(0,)]
            _, catalog, _ = self._target_ref(stmt.name)

            def _ctas(txn):
                # recomputed per attempt: a conflict retry must stage
                # against the fresh snapshot, not stale arrays
                names, types, cols = self._query_columns(stmt.query)
                txn.stage_create(
                    [ColumnSchema(n, t) for n, t in zip(names, types)]
                )
                txn.stage_insert(dict(zip(names, cols)))
                return 0

            n = run_write(self, catalog, name, "create", _ctas)
            return [(n,)]

        if isinstance(stmt, S.Insert):
            conn, table = self._target_conn(stmt.table)
            _, catalog, _ = self._target_ref(stmt.table)

            def _insert(txn):
                _, types, cols = self._query_columns(stmt.query)
                schema = conn.table_schema(table)
                names = (
                    list(stmt.columns)
                    if stmt.columns
                    else [c.name for c in schema.columns]
                )
                if len(names) != len(cols):
                    raise ValueError(
                        f"INSERT column count mismatch: {len(names)} vs {len(cols)}"
                    )
                cols2 = [
                    _rescale_column(arr, t, schema.type_of(n))
                    for arr, t, n in zip(cols, types, names)
                ]
                return self._insert_resolved(conn, table, names, cols2, txn)

            n = run_write(self, catalog, table, "insert", _insert)
            return [(n,)]

        if isinstance(stmt, S.InsertValues):
            _, catalog, table = self._target_ref(stmt.table)
            table = table.split(".")[-1]
            n = run_write(
                self, catalog, table, "insert",
                lambda txn: self._insert_values(stmt, txn),
            )
            return [(n,)]

        if isinstance(stmt, S.DropTable):
            conn, name = self._target_conn(stmt.name)
            if stmt.if_exists and name not in conn.list_tables():
                return [(0,)]
            conn.drop_table(name)
            self.cache_invalidate(stmt.name)
            return [(0,)]

        if isinstance(stmt, S.CreateView):
            conn, catalog, name = self._target_ref(stmt.name)
            name = name.split(".")[-1]  # match the planner's (catalog, table)
            key = (catalog, name)
            if name in conn.list_tables():
                # Trino: TABLE_ALREADY_EXISTS — a view must not shadow a table
                raise ValueError(f"table already exists: {stmt.name}")
            if key in self.planner.views and not stmt.or_replace:
                raise ValueError(f"view already exists: {stmt.name}")
            prev = self.planner.views.get(key)
            self.planner.views[key] = stmt.query
            try:
                self.plan(stmt.query)  # validate now: names, types, cycles
            except Exception:
                if prev is None:
                    del self.planner.views[key]
                else:
                    self.planner.views[key] = prev
                raise
            self._view_sql[key] = stmt.sql
            return [(0,)]

        if isinstance(stmt, S.DropView):
            _, catalog, name = self._target_ref(stmt.name)
            key = (catalog, name.split(".")[-1])
            if key not in self.planner.views:
                if stmt.if_exists:
                    return [(0,)]
                raise KeyError(f"view not found: {stmt.name}")
            del self.planner.views[key]
            self._view_sql.pop(key, None)
            return [(0,)]

        if isinstance(stmt, S.ShowCreateView):
            _, catalog, name = self._target_ref(stmt.name)
            name = name.split(".")[-1]
            sql_text = self._view_sql.get((catalog, name))
            if sql_text is None:
                raise KeyError(f"view not found: {stmt.name}")
            return [(f"CREATE VIEW {name} AS {sql_text}",)]

        if isinstance(stmt, S.ShowTables):
            conn = self.catalogs.get(self.default_catalog)
            views = sorted(
                n for (c, n) in self.planner.views if c == self.default_catalog
            )
            return [(t,) for t in conn.list_tables()] + [(v,) for v in views]

        if isinstance(stmt, S.DescribeTable):
            _, catalog, name = self._target_ref(stmt.name)
            vq = self.planner.views.get((catalog, name.split(".")[-1]))
            if vq is not None:
                plan = self.plan(vq)
                return [
                    (n, t.name)
                    for n, t in zip(plan.output_names, plan.output_types)
                ]
            conn, name = self._target_conn(stmt.name)
            schema = conn.table_schema(name)
            return [(c.name, c.type.name) for c in schema.columns]

        if isinstance(stmt, S.SetSession):
            self.session.set(stmt.name, stmt.value)
            return [(1,)]

        if isinstance(stmt, S.Delete):
            from .dml import execute_delete

            return [(execute_delete(self, stmt),)]

        if isinstance(stmt, S.Update):
            from .dml import execute_update

            return [(execute_update(self, stmt),)]

        if isinstance(stmt, S.Merge):
            from .dml import execute_merge

            return [(execute_merge(self, stmt),)]

        if isinstance(stmt, S.Prepare):
            self._prepared[stmt.name] = stmt.sql
            return [(1,)]

        if isinstance(stmt, S.ExecuteStmt):
            sql_text = self._resolve_prepared(stmt.name, prepared)
            from .fastpath import NotFastpath

            try:
                return self.fastpath().execute(sql_text, stmt.parameters)
            except NotFastpath:
                pass
            # typed AST substitution + full re-plan (DML templates,
            # expression parameters, the fast path switched off)
            bound = S.parse_statement(sql_text, params=stmt.parameters)
            return self.execute_stmt(bound)

        if isinstance(stmt, S.Deallocate):
            self._prepared.pop(stmt.name, None)
            return [(1,)]

        if isinstance(stmt, S.StartTransaction):
            # per-session transaction over writable catalogs: connectors that
            # support snapshot/restore participate (reference:
            # transaction/TransactionManager + connector tx handles; here the
            # rewrite-and-swap write path makes copy-on-write snapshots cheap)
            if self._tx_snapshots is not None:
                raise RuntimeError("transaction already in progress")
            self._tx_snapshots = {
                name: self.catalogs.get(name).snapshot()
                for name in self.catalogs.names()
                if hasattr(self.catalogs.get(name), "snapshot")
            }
            # view DDL participates: restore the registry on ROLLBACK too
            self._tx_views = (dict(self.planner.views), dict(self._view_sql))
            return [(1,)]

        if isinstance(stmt, S.Commit):
            if self._tx_snapshots is None:
                raise RuntimeError("no transaction in progress")
            self._tx_snapshots = None
            self._tx_views = None
            return [(1,)]

        if isinstance(stmt, S.Rollback):
            if self._tx_snapshots is None:
                raise RuntimeError("no transaction in progress")
            for name, snap in self._tx_snapshots.items():
                self.catalogs.get(name).restore(snap)
            self._tx_snapshots = None
            if self._tx_views is not None:
                self.planner.views, self._view_sql = self._tx_views
                self._tx_views = None
            return [(1,)]

        raise NotImplementedError(f"statement {type(stmt).__name__}")

    # ------------------------------------------------------------- explain
    def fastpath(self):
        """The engine's prepared-statement fast path (runtime/fastpath.py),
        made at first use."""
        fp = getattr(self, "_fastpath", None)
        if fp is None:
            from .fastpath import FastPath

            fp = self._fastpath = FastPath(self)
        return fp

    def _explain_execute(self, stmt, prepared: Optional[dict] = None) -> list[tuple]:
        """EXPLAIN [ANALYZE] EXECUTE name [USING ...]: the fast path's plan
        and a `-- fastpath:` footer with the plan-cache disposition (hit |
        miss | bypass) and the binding split; the substitute-and-replan plan
        where the fast path declines."""
        from ..sql import statements as S
        from .fastpath import NotFastpath

        ex_stmt = stmt.execute
        sql_text = self._resolve_prepared(ex_stmt.name, prepared)
        fp = self.fastpath()
        t0 = _time.perf_counter()
        try:
            tmpl, n_params = fp._template(sql_text)
            if len(ex_stmt.parameters) != n_params:
                raise ValueError(
                    f"prepared statement takes {n_params} parameters,"
                    f" got {len(ex_stmt.parameters)}"
                )
            slots = fp._slots(ex_stmt.parameters)
            self._apply_kernel_props()  # the cache key holds this session's policy
            entry = fp._lookup(sql_text, tmpl.query, slots)
        except NotFastpath:
            bound = S.parse_statement(sql_text, params=ex_stmt.parameters)
            if not isinstance(bound, S.QueryStmt):
                raise ValueError("EXPLAIN EXECUTE requires a query template")
            inner = S.Explain(bound.query, stmt.analyze, stmt.distributed)
            text = [r[0] for r in self._execute_explain(inner)]
            text.append("-- fastpath: off (legacy substitute-and-replan path)")
            return [(line,) for line in text]
        info = fp.last_info
        text = format_plan(entry.plan).splitlines()
        if stmt.analyze:
            params = fp._param_values(entry.slots, slots)
            rows = self._execute_planned(entry.plan, params).to_pylist()
            wall = _time.perf_counter() - t0
            text.append(f"-- output rows: {len(rows)}, wall: {wall * 1e3:.1f} ms")
        window = float(self.session.get("execute_batch_window_ms") or 0.0)
        text.append(
            f"-- fastpath: plan_cache={info.cache} bound={info.bound}"
            f" baked={info.baked} batch_window_ms={window:g} executor=local"
        )
        return [(line,) for line in text]

    def _explain_analyze_distributed(self, query):
        """Override point: the multi-host coordinator's statement surface
        (runtime/coordinator.py _StatementSurface) returns its QueryInfo —
        per-stage plans, operator stats, wall intervals — here.  The
        in-process engine has none and uses its executor."""
        return None

    def _execute_explain(self, stmt, prepared: Optional[dict] = None) -> list[tuple]:
        """EXPLAIN [ANALYZE] in the session's explain_format (text | json).
        ANALYZE runs the plan once with per-operator row counts and times
        (LocalExecutor.explain_analyze); a distributed plan's counts are
        summed over its tasks (SpmdExecutor.explain_analyze); on a
        coordinator, the cluster's QueryInfo is rendered per stage."""
        import json as _json

        from ..plan.nodes import plan_to_obj

        if stmt.execute is not None:
            return self._explain_execute(stmt, prepared)
        if stmt.statement is not None:
            return self._explain_write(stmt, prepared)
        fmt = str(self.session.get("explain_format") or "text").lower()
        plan = self.plan(stmt.query)
        if not stmt.analyze:
            if fmt == "json":
                return [(_json.dumps(plan_to_obj(plan), indent=2),)]
            return [(line,) for line in format_plan(plan).splitlines()]

        t0 = _time.perf_counter()
        info = self._explain_analyze_distributed(stmt.query)
        if info is not None:
            wall = _time.perf_counter() - t0
            if fmt == "json":
                return [(_json.dumps(info, default=str, indent=2),)]
            return [
                (line,) for line in self._render_distributed_analyze(info, wall)
            ]
        self._apply_kernel_props()
        executor = self._executor_for(plan)
        n_events = len(executor.compile_events)
        page, stats = executor.explain_analyze(plan)
        n_out = len(page.to_pylist())
        wall = _time.perf_counter() - t0
        if fmt == "json":
            obj = {
                "plan": plan_to_obj(plan, stats=stats),
                "output_rows": n_out,
                "wall_ms": round(wall * 1e3, 1),
            }
            return [(_json.dumps(obj, indent=2),)]
        ann = {
            nid: (
                f"   [rows: {s.get('rows', '?')}"
                + (f", {s['ms']:.1f} ms" if "ms" in s else "")
                + "]"
            )
            for nid, s in stats.items()
        }
        text = format_plan(plan, annotations=ann).splitlines()
        timed = [(nid, s["ms"]) for nid, s in stats.items() if "ms" in s]
        if timed:
            slow_nid, slow_ms = max(timed, key=lambda kv: kv[1])
            from ..exec.compiler import _node_ids

            slow = type(_node_ids(plan)[slow_nid]).__name__
            text.append(
                f"-- slowest operator: {slow} (node {slow_nid}, {slow_ms:.1f} ms eager)"
            )
        text.append(f"-- output rows: {n_out}, wall: {wall * 1000:.1f} ms")
        from ..ops.kernels import events_for

        for op, impl, detail in events_for(plan):
            text.append(
                f"-- kernel: {impl} {op}" + (f" ({detail})" if detail else "")
            )
        events = executor.compile_events[n_events:]
        if events:
            text.extend(_compile_lines(events))
            text.append(_compile_cache_line())
        return [(line,) for line in text]

    @staticmethod
    def _render_distributed_analyze(info: dict, wall_s: float) -> list[str]:
        """Trino-style per-fragment EXPLAIN ANALYZE text from a coordinator
        QueryInfo: each stage's annotated plan under a Fragment header with
        its wall interval, then the slowest operator across all stages."""
        text: list[str] = []
        slowest = None  # (ms, operator, stage_id, nid)
        for st in info.get("stages") or []:
            hdr = f"Fragment {st['stage_id']} [{st['output_kind']}]"
            iv = st.get("wall_interval_s")
            if iv:
                hdr += f"  wall: {iv[0] * 1e3:.0f}..{iv[1] * 1e3:.0f} ms"
            hdr += f"  tasks: {len(st.get('tasks') or [])}"
            text.append(hdr)
            text.extend("  " + ln for ln in st.get("plan") or [])
            for nid, s in (st.get("operators") or {}).items():
                ms = s.get("ms")
                if ms is not None and (slowest is None or ms > slowest[0]):
                    slowest = (ms, s.get("operator", "?"), st["stage_id"], nid)
        if slowest is not None:
            text.append(
                f"-- slowest operator: {slowest[1]} (stage {slowest[2]}, "
                f"node {slowest[3]}, {slowest[0]:.1f} ms eager)"
            )
        text.append(
            f"-- output rows: {info.get('output_rows', 0)}, "
            f"wall: {wall_s * 1e3:.1f} ms, cluster cpu: "
            f"{info.get('cpu_ms', 0):.1f} ms, stages: {info.get('stage_count', 0)}, "
            f"task retries: {info.get('task_retries', 0)}"
        )
        # memory-governance line (reference: QueryStats peakMemoryReservation
        # + blocked time): peak task reservation, total blocked-on-memory
        # wall, and how many tasks ran revocation-spilled
        text.append(
            f"-- peak memory: {info.get('peak_memory_bytes', 0)} B, "
            f"blocked on memory: {info.get('memory_blocked_ms', 0.0):.1f} ms, "
            f"revocations: {info.get('memory_revocations', 0)}"
        )
        # phase ledger footer (reference: QueryStats' queued/analysis/
        # planning/execution durations): where the wall actually went
        ledger = info.get("phase_ledger") or {}
        if ledger:
            text.append(
                "-- phases: "
                + ", ".join(
                    (
                        f"{k[: -len('_ms')]} {v:.1f} ms"
                        if k.endswith("_ms")
                        else f"{k} {v}"  # plain counts (fallback_executions)
                    )
                    for k, v in ledger.items()
                    if isinstance(v, (int, float))
                )
            )
        # result-cache footer (runtime/resultcache.py): the disposition the
        # plain query would have had (EXPLAIN ANALYZE itself always
        # executes) plus the cache key and any fragment-memo seeding
        cinfo = info.get("cache") or {}
        if cinfo.get("disposition"):
            line = f"-- cache: {cinfo['disposition']}"
            if cinfo.get("reason"):
                line += f" ({cinfo['reason']})"
            if cinfo.get("key"):
                line += f" key={cinfo['key']}"
            if cinfo.get("memo_hits"):
                line += f" [fragment memo hits: {cinfo['memo_hits']}]"
            text.append(line)
        # crash-recovery footer: present only on queries a restarted
        # coordinator resumed from the journal (runtime/journal.py)
        rec = info.get("recovery") or {}
        if rec.get("resumed"):
            text.append(
                f"-- recovery: resumed from journal (replay "
                f"{rec.get('journal_replay_ms', 0.0):.1f} ms, stages "
                f"re-read from spool: {rec.get('stages_resumed', 0)}, "
                f"parts re-read: {rec.get('parts_resumed', 0)})"
            )
        # split footer: present only under split_driven_scans — how many
        # morsels the scans enumerated and what the scheduler did with
        # them (runtime/splits.py)
        spl = info.get("splits") or {}
        if spl.get("splits"):
            line = (
                f"-- splits: {spl.get('splits', 0)} total over "
                f"{spl.get('stages', 0)} scan stage(s), pad "
                f"{spl.get('pad_rows', 0)} rows "
                f"(completed: {spl.get('completed', 0)}, retries: "
                f"{spl.get('retries', 0)}, steals: {spl.get('steals', 0)}"
            )
            if spl.get("precommitted"):
                line += f", re-read from spool: {spl['precommitted']}"
            if spl.get("parked"):
                line += f", park deferrals: {spl['parked']}"
            text.append(line + ")")
        # anomaly-sentinel footer: present only when the sentinel flagged
        # this run against its planhash's rolling baseline (coordinator
        # _score_anomalies over runtime/history.py baselines)
        for a in info.get("anomalies") or []:
            base = info.get("baseline") or {}
            line = f"-- anomaly: {a.get('kind')}"
            detail = ", ".join(
                f"{k} {v}" for k, v in sorted(a.items()) if k != "kind"
            )
            if detail:
                line += f" ({detail})"
            if base.get("samples"):
                line += f" [baseline: {base['samples']} runs]"
            text.append(line)
        # fleet footer: present only on queries a surviving fleet member
        # adopted from a dead peer's journal (runtime/fleet.py)
        flt = info.get("fleet") or {}
        if flt.get("adopted"):
            text.append(
                f"-- fleet: adopted from {flt.get('adopted_from')} by "
                f"{flt.get('coordinator_id')} (stages re-read from spool: "
                f"{flt.get('stages_resumed', 0)}, parts re-read: "
                f"{flt.get('parts_resumed', 0)})"
            )
        # per-kernel compile attribution: the port's only run-time compiles
        # are kernel 2's NVRTC builds (ops/cuda/fused_codegen.py), one line
        # per generated kernel a task built or read from the disk cache
        sigs = info.get("compile_signatures") or {}
        if not sigs:
            text.append(
                "-- compile: none (NVRTC builds of kernel 2 recipes are the "
                "only compiles; this query built none)"
            )
        for sig, s in sigs.items():
            cache = s.get("cache") or {}
            cache_txt = ", ".join(
                f"{k}: {v}" for k, v in sorted(cache.items()) if v
            )
            # the compile plane's disposition (exec/compilesvc.py): which
            # path the tasks took while the kernel was (or was not) built
            flags = []
            if s.get("timeouts"):
                flags.append(f"timeout x{s['timeouts']}")
            fb = s.get("fallbacks") or {}
            if fb:
                flags.append(
                    "fallback " + ", ".join(f"{r}: {c}" for r, c in sorted(fb.items()))
                )
            if (s.get("modes") or {}).get("async"):
                flags.append("async")
            text.append(
                f"-- compile: NVRTC {sig} x{s.get('compiles', 0)} "
                f"{s.get('compile_s', 0.0) * 1e3:.1f} ms"
                + (f" [disk cache: {cache_txt}]" if cache_txt else "")
                + (f" [{'; '.join(flags)}]" if flags else "")
            )
        text.append(_compile_cache_line())
        # roofline footer (coordinator roofline plane over
        # utils/roofline.py): achieved bandwidth per executed signature
        # as a fraction of what this device can actually sustain
        roofline = info.get("roofline") or {}
        dev = roofline.get("device") or {}
        for s in roofline.get("signatures") or []:
            line = (
                f"-- roofline: {s.get('signature', '?')} "
                f"{s.get('gflop_per_sec', 0.0):.3f} GFLOP/s, "
                f"{s.get('gb_per_sec', 0.0):.3f} GB/s achieved over "
                f"{s.get('execute_ms', 0.0):.1f} ms execute"
            )
            if dev.get("hbm_gbps"):
                line += (
                    f" ({s.get('pct_of_roofline', 0.0):.1f}% of "
                    f"{dev['hbm_gbps']:g} GB/s "
                    f"{dev.get('device_kind', '?')})"
                )
            text.append(line)
        if info.get("device_gb_per_sec") is not None:
            text.append(
                f"-- device bandwidth: {info['device_gb_per_sec']:.3f} "
                f"GB/s achieved query-wide"
            )
        # exchange footer (per-stage link accounting folded by the
        # coordinator): what the exchange plane actually moved and how fast
        for st in info.get("exchange") or []:
            if not st.get("bytes"):
                continue
            line = (
                f"-- exchange: stage {st.get('stage_id')} "
                f"{st.get('bytes', 0)} B over {st.get('wall_ms', 0.0):.1f} "
                f"ms ({st.get('fetches', 0)} fetches"
            )
            if st.get("gb_per_sec") is not None:
                line += f", {st['gb_per_sec']:.3f} GB/s"
            line += f", {len(st.get('links') or {})} link(s))"
            text.append(line)
        return text

    def _explain_write(self, stmt, prepared: Optional[dict] = None) -> list[tuple]:
        """EXPLAIN [ANALYZE] over a write statement.  Plain EXPLAIN renders
        the source query's plan (if any) plus the write target without
        executing; ANALYZE executes the statement through the transactional
        path and appends the `-- txn:` commit-protocol footer."""
        from ..sql import statements as S

        inner = stmt.statement
        text: list[str] = []
        target = getattr(inner, "table", None) or getattr(inner, "name", None) \
            or getattr(inner, "target", None)
        op = type(inner).__name__
        text.append(f"Write[{op} -> {target}]")
        src = getattr(inner, "query", None)
        if src is not None and not isinstance(inner, S.Merge):
            text.extend(
                "  " + ln for ln in format_plan(self.plan(src)).splitlines()
            )
        if not stmt.analyze:
            return [(line,) for line in text]
        t0 = _time.perf_counter()
        rows = self.execute_stmt(inner, prepared=prepared)
        wall = _time.perf_counter() - t0
        n = rows[0][0] if rows and rows[0] else 0
        text.append(f"-- output rows: {n}, wall: {wall * 1e3:.1f} ms")
        info = self._last_txn_info
        if info is not None:
            text.append(
                f"-- txn: id={info['txn_id']} table={info['table']}"
                f" op={info['operation']} expected={info['expected']}"
                f" staged_bytes={info['staged_bytes']}"
                f" retries={info.get('retries', 0)}"
                f" outcome={info['outcome']}"
                f" commit_ms={info['commit_ms']:.1f}"
            )
        return [(line,) for line in text]

    # ------------------------------------------------------ targets & caches
    def cache_invalidate(self, name: str) -> None:
        """Every write statement (and runtime/dml.py) routes through here
        once its commit lands: the table's device columns are stale, so the
        executor lets go of them now rather than at the next scan, and the
        fast path drops the cached plans that scan it."""
        try:
            _, catalog, table = self._target_ref(name)
        except KeyError:
            return  # dropping an unknown catalog's table: nothing cached
        table = table.split(".")[-1]
        self.executor.drop_table_cache(catalog, table)
        if self._local_fallback is not self.executor:
            self._local_fallback.drop_table_cache(catalog, table)
        fp = getattr(self, "_fastpath", None)
        if fp is not None:
            fp.invalidate_table(catalog, table)

    def _resolve_prepared(self, name: str, prepared: Optional[dict] = None) -> str:
        if prepared and name in prepared:
            return prepared[name]
        if name not in self._prepared:
            raise KeyError(f"prepared statement not found: {name}")
        return self._prepared[name]

    def _target_conn(self, name: str):
        """Resolve a possibly `catalog.table`-qualified DDL/DML target
        (Trino 2-part semantics: an unknown first part falls back to a plain
        table name in the default catalog)."""
        conn, _catalog, table = self._target_ref(name)
        return conn, table

    def _check_write(self, name: str, operation: str) -> None:
        _, catalog, table = self._target_ref(name)
        self.access_control.check_can_write(self.user, catalog, table, operation)

    def _target_ref(self, name: str):
        """(connector, catalog name, table name) of a DDL/DML target."""
        if "." in name:
            parts = name.split(".")
            try:
                return self.catalogs.get(parts[0]), parts[0], parts[-1]
            except KeyError:
                pass
        return self.catalogs.get(self.default_catalog), self.default_catalog, name

    # ------------------------------------------------------------ write path
    def _insert_resolved(self, conn, table: str, names: list, cols: list, stage) -> int:
        """Resolve query columns against the table schema and stage them
        into the WriteTransaction `stage`."""
        schema = conn.table_schema(table)
        if len(names) != len(cols):
            raise ValueError(f"INSERT column count mismatch: {len(names)} vs {len(cols)}")
        data = {}
        for cname, arr in zip(names, cols):
            t = schema.type_of(cname)
            if t.is_string or isinstance(arr, np.ma.MaskedArray):
                # astype on a MaskedArray preserves the mask; np.asarray
                # would silently strip it and persist garbage for NULL lanes
                data[cname] = arr if t.is_string else arr.astype(t.np_dtype)
            else:
                data[cname] = np.asarray(arr).astype(t.np_dtype)
        n = len(cols[0]) if cols else 0
        for c in schema.columns:  # a column left out of the list is NULL
            if c.name not in data:
                data[c.name] = _null_column(c.type, n)
        stage.stage_insert(data)
        return n

    def _insert_values(self, stmt, stage) -> int:
        from ..plan.ir import Const
        from ..plan.planner import Scope, _cast_ir, _Translator

        conn, table = self._target_conn(stmt.table)
        schema = conn.table_schema(table)
        names = list(stmt.columns) if stmt.columns else [c.name for c in schema.columns]
        t = _Translator(Scope([]))
        rows = []
        for row in stmt.rows:
            vals = []
            for ci, e in enumerate(row):
                ir = t.translate(e)
                if not isinstance(ir, Const):
                    raise ValueError(f"INSERT VALUES must be literals: {e}")
                # coerce to the column type (e.g. 1.5 -> scaled decimal lanes)
                ir = _cast_ir(ir, schema.type_of(names[ci]))
                vals.append(ir.value)
            rows.append(vals)
        n = len(rows)
        data = {}
        for ci, cname in enumerate(names):
            typ = schema.type_of(cname)
            col = [r[ci] for r in rows]
            nulls = np.array([v is None for v in col], dtype=bool)
            if nulls.any():
                fill = "" if typ.is_string else 0
                arr = np.asarray(
                    [fill if v is None else v for v in col],
                    dtype=object if typ.is_string else typ.np_dtype,
                )
                data[cname] = np.ma.MaskedArray(arr, mask=nulls)
            else:
                data[cname] = np.asarray(
                    col, dtype=object if typ.is_string else typ.np_dtype
                )
        for c in schema.columns:  # a column left out of the list is NULL
            if c.name not in data:
                data[c.name] = _null_column(c.type, n)
        stage.stage_insert(data)
        return n
