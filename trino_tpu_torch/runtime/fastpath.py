"""Prepared-statement serving fast path.

The substitute-and-replan EXECUTE re-parses the stored SQL with the literal
values spliced in, then re-analyzes and re-plans every binding.  This module
is the reference's EXECUTE machinery (session-held prepared statements,
parameters bound at EXECUTE — sql/tree/Parameter, analyzer binding):

  * the statement text is parsed ONCE into a template whose `?` sites are
    positional `ast.Parameter` nodes (sql/statements.parse_template);
  * at EXECUTE, bindable scalar parameters (numerics, booleans, dates,
    int64-range decimals) become `ir.Param` nodes, evaluated per run from
    ops/expr.param_context — so every binding of one prepared statement
    shares ONE plan and its learned capacities (no re-plan, no new
    capacity entry, no new compile: a fused recipe takes the run's values
    as kernel arguments, ops/expr.bind_params);
  * value-dependent parameters (varchar — string operations run per
    distinct dictionary value on the host — NULLs, beyond-int64 decimals)
    are BAKED as constants, giving a plan per value, still cached per
    value;
  * plans land in a ParameterizedPlanCache: LRU, a kill switch
    (`plan_cache_enabled`), pinned to the scanned tables' version vector
    (runtime/resultcache.py; a write or a snapshot bump invalidates),
    counted in `trino_tpu_plan_cache_events_total{hit|miss|evicted|
    invalidated|bypass}`;
  * concurrent EXECUTEs of one plan inside `execute_batch_window_ms` are
    gathered by the window's leader, which runs the queued bindings one
    after another through the one cached plan — each with its learned
    capacities and one packed `required` transfer — and hands every
    follower its rows (`trino_tpu_execute_batch_total{batched|single|
    fallback}`: `batched` for a window of two or more, `fallback` for an
    entry marked `batchable = False`, which dispatches and materializes
    each query on its own).  The reference's stacked-parameter batch (one
    vectorized device program per window) has no counterpart here: the
    port's operators run eagerly, so a window's bindings share the plan,
    the resident scan pages and the capacities, not one launch.  Results
    equal sequential execution either way.

Scanned tables stay on the card across executions: the executor's scan
cache (exec/compiler.py table_page) is keyed by the tables' write
generations, the same versions the cache pin watches.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..utils.metrics import GLOBAL as _METRICS

__all__ = ["FastPath", "NotFastpath", "PLAN_CACHE_EVENTS", "EXECUTE_BATCH"]

PLAN_CACHE_EVENTS = _METRICS.counter(
    "trino_tpu_plan_cache_events_total",
    "Parameterized plan cache events on the prepared-statement fast path",
    ("event",),
)
EXECUTE_BATCH = _METRICS.counter(
    "trino_tpu_execute_batch_total",
    "Batched prepared-statement dispatch outcomes (shared small-query batching)",
    ("outcome",),
)


class NotFastpath(Exception):
    """A prepared statement cannot take the fast path (a template that is
    not a plain query, expression parameters, a planning gap, the kill
    switch): the caller falls back to substitute-and-replan."""


@dataclass
class _PlanEntry:
    plan: object
    slots: tuple                     # ("bind"|"bake", Type, value) per param
    version_vector: Optional[tuple]
    batchable: Optional[bool] = None  # False: a window dispatches per query
    # the in-flight batch group (leader / followers)
    glock: threading.Lock = field(default_factory=threading.Lock)
    queue: list = field(default_factory=list)
    leader_active: bool = False


class _Pending:
    __slots__ = ("params", "event", "rows", "error")

    def __init__(self, params):
        self.params = params
        self.event = threading.Event()
        self.rows = None
        self.error = None


@dataclass
class _Info:
    """The last fast-path disposition, shown by the EXPLAIN footer."""

    cache: str = "miss"
    bound: int = 0
    baked: int = 0


def _param_in_lambda(node) -> bool:
    """True when a lambda body anywhere in the plan reads an ir.Param."""
    import dataclasses

    from ..plan.ir import LambdaIr, Param

    stack = [(node, False)]
    while stack:
        x, inside = stack.pop()
        if isinstance(x, (tuple, list)):
            stack.extend((y, inside) for y in x)
            continue
        if not dataclasses.is_dataclass(x) or isinstance(x, type):
            continue
        if inside and isinstance(x, Param):
            return True
        inside = inside or isinstance(x, LambdaIr)
        stack.extend((getattr(x, f.name), inside) for f in dataclasses.fields(x))
    return False


class FastPath:
    """Per-engine prepared fast path: template registry, plan cache and
    batched dispatch."""

    def __init__(self, engine):
        self.engine = engine
        self._templates: dict[str, tuple] = {}   # sql -> (template stmt, n)
        self._cache: OrderedDict = OrderedDict()
        self._lock = threading.RLock()
        self.last_info: Optional[_Info] = None
        # planner calls made by this fast path (a cached binding makes none)
        self.plans_made = 0
        # the last EXECUTE's template text and output column names: a
        # coordinator's client protocol reports them (runtime/coordinator.py)
        self.last_template: Optional[str] = None
        self.last_columns: Optional[list] = None

    # --------------------------------------------------------------- template
    def _template(self, sql: str):
        from ..sql import statements as S

        hit = self._templates.get(sql)
        if hit is None:
            try:
                hit = S.parse_template(sql)
            except Exception:
                hit = (None, 0)
            self._templates[sql] = hit
        stmt, n = hit
        if not isinstance(stmt, S.QueryStmt):
            raise NotFastpath("template is not a plain query")
        return stmt, n

    # ----------------------------------------------------------------- slots
    def _slots(self, param_exprs) -> tuple:
        """EXECUTE's literal arguments as typed binding slots: bindable
        scalars -> ("bind", type, value); value-dependent or NULL ->
        ("bake", type, value)."""
        from ..data.types import BIGINT, BOOLEAN, DATE, DOUBLE
        from ..plan.ir import Const
        from ..plan.planner import Scope, _Translator

        t = _Translator(Scope([]))
        slots = []
        for e in param_exprs:
            try:
                ir = t.translate(e)
            except Exception:
                raise NotFastpath(f"non-literal parameter: {e}")
            if not isinstance(ir, Const):
                raise NotFastpath(f"non-literal parameter: {e}")
            typ, val = ir.type, ir.value
            bindable = val is not None and (
                typ in (BIGINT, DOUBLE, DATE, BOOLEAN)
                or (typ.is_decimal and -(1 << 63) <= val < (1 << 63))
            )
            slots.append(("bind" if bindable else "bake", typ, val))
        return tuple(slots)

    @staticmethod
    def _param_values(entry_slots, current_slots) -> tuple:
        """One typed numpy scalar per parameter index: the modes come from
        the cached plan's slots (what it bound, what it baked), the values
        from this execution's.  A baked slot keeps its index (no Param
        reads it)."""
        vals = []
        for (mode, typ, _entry_val), (_m, _t, val) in zip(entry_slots, current_slots):
            if mode == "bind":
                vals.append(np.asarray(val, dtype=typ.np_dtype).reshape(()))
            else:
                vals.append(np.int64(0))
        return tuple(vals)

    # ------------------------------------------------------------------ plan
    def _plan(self, query, slots):
        """Plan the template with bound parameters; positions that need a
        literal (LIKE patterns, IN lists, ...) force a re-plan with every
        parameter baked — a plan per value, still cacheable."""
        from ..plan.nodes import TableScan, walk
        from ..plan.optimizer import optimize
        from ..plan.planner import param_bindings

        eng = self.engine

        def attempt(attempt_slots):
            self.plans_made += 1
            with param_bindings(attempt_slots):
                plan = optimize(eng.planner.plan(query), eng.catalogs, eng.session)
            if _param_in_lambda(plan):
                # a lambda body compiles once into a closure: it must see
                # the value, so this template plans per value
                raise ValueError("a parameter inside a lambda body")
            return plan, attempt_slots

        try:
            plan, used = attempt(slots)
        except Exception:
            baked = tuple(("bake", t, v) for _m, t, v in slots)
            try:
                plan, used = attempt(baked)
            except Exception:
                raise NotFastpath("template does not plan with parameters")
        for n in walk(plan):
            if isinstance(n, TableScan):
                eng.access_control.check_can_select(eng.user, n.catalog, n.table, n.column_names)
        return plan, used

    def _entry_key(self, sql: str, slots) -> tuple:
        from ..ops.kernels import policy_key

        parts = []
        for mode, typ, val in slots:
            parts.append((mode, typ) if mode == "bind" else (mode, typ, val))
        return (sql, tuple(parts), policy_key())

    def _current_vector(self, plan):
        from .resultcache import plan_version_vector

        return plan_version_vector(plan, self.engine.catalogs)

    def _cache_get(self, key):
        """LRU lookup with the version-vector check; None on a miss or a
        stale pin."""
        entry = self._cache.get(key)
        if entry is None:
            return None
        vec = self._current_vector(entry.plan)
        if vec == entry.version_vector and vec is not None:
            self._cache.move_to_end(key)
            return entry
        del self._cache[key]
        PLAN_CACHE_EVENTS.labels("invalidated").inc()
        return None

    def _lookup(self, sql: str, query, slots) -> _PlanEntry:
        eng = self.engine
        cache_on = bool(eng.session.get("plan_cache_enabled"))
        key = self._entry_key(sql, slots)

        def info(kind, entry_slots):
            bound = sum(1 for m, _t, _v in entry_slots if m == "bind")
            return _Info(kind, bound, len(entry_slots) - bound)

        with self._lock:
            entry = self._cache_get(key) if cache_on else None
            if entry is not None:
                PLAN_CACHE_EVENTS.labels("hit").inc()
                self.last_info = info("hit", entry.slots)
                return entry
        plan, used = self._plan(query, slots)
        if used != slots:
            # planning BAKED the parameters: the plan depends on the values,
            # so it lives under the all-baked key, values included
            key = self._entry_key(sql, used)
            with self._lock:
                entry = self._cache_get(key) if cache_on else None
                if entry is not None:
                    PLAN_CACHE_EVENTS.labels("hit").inc()
                    self.last_info = info("hit", entry.slots)
                    return entry
        entry = _PlanEntry(plan=plan, slots=used, version_vector=self._current_vector(plan))
        if not cache_on or entry.version_vector is None:
            # kill switch / pinned scans: the plan is served, never cached
            PLAN_CACHE_EVENTS.labels("bypass").inc()
            self.last_info = info("bypass", used)
            return entry
        with self._lock:
            self._cache[key] = entry
            self._cache.move_to_end(key)
            limit = int(eng.session.get("plan_cache_max_entries") or 64)
            while len(self._cache) > limit:
                # the least recently used plan goes first (the reference also
                # shields templates that recur in the coordinator's query
                # history; an engine keeps no history, runtime/history.py
                # is the coordinator's)
                del self._cache[next(iter(self._cache))]
                PLAN_CACHE_EVENTS.labels("evicted").inc()
        PLAN_CACHE_EVENTS.labels("miss").inc()
        self.last_info = info("miss", used)
        return entry

    def invalidate_table(self, catalog: str, table: str) -> None:
        """Drop every cached plan that scans the written table (a write
        statement calls this through Engine.cache_invalidate).  Version
        bumps that bypass the engine are caught lazily by the pin check."""
        ref = f"{catalog}.{table}"
        with self._lock:
            stale = [
                k for k, e in self._cache.items()
                if e.version_vector is None or any(name == ref for name, _v in e.version_vector)
            ]
            for k in stale:
                del self._cache[k]
            if stale:
                PLAN_CACHE_EVENTS.labels("invalidated").inc(len(stale))

    # -------------------------------------------------------------- dispatch
    def execute(self, sql: str, param_exprs, analyze: bool = False):
        """EXECUTE a prepared statement's template through the fast path;
        raises NotFastpath when the caller must substitute and re-plan."""
        eng = self.engine
        if not bool(eng.session.get("prepared_fastpath_enabled")):
            raise NotFastpath("prepared_fastpath_enabled=false")
        stmt, n_params = self._template(sql)
        self.last_template = sql
        if len(param_exprs) != n_params:
            raise ValueError(
                f"prepared statement takes {n_params} parameters, got {len(param_exprs)}"
            )
        slots = self._slots(param_exprs)
        # the plan-cache key holds the kernel policy: this session's, not
        # what the process's last statement left
        eng._apply_kernel_props()
        entry = self._lookup(sql, stmt.query, slots)
        self.last_columns = list(entry.plan.output_names)
        params = self._param_values(entry.slots, slots)
        window_s = float(eng.session.get("execute_batch_window_ms") or 0.0) / 1e3
        if window_s > 0.0 and not analyze:
            return self._submit_batched(entry, params, window_s)
        return eng._execute_planned(entry.plan, params).to_pylist()

    # ------------------------------------------------- shared query batching
    def _submit_batched(self, entry: _PlanEntry, params, window_s: float):
        """Leader / follower batching: the first EXECUTE of a plan opens a
        window; whatever queued on the same plan when it closes runs in the
        leader (the result cache's in-flight idiom)."""
        pending = _Pending(params)
        with entry.glock:
            entry.queue.append(pending)
            is_leader = not entry.leader_active
            if is_leader:
                entry.leader_active = True
        if not is_leader:
            pending.event.wait(timeout=600.0)
            if not pending.event.is_set():
                raise RuntimeError("batched EXECUTE timed out")
            if pending.error is not None:
                raise pending.error
            return pending.rows
        time.sleep(window_s)
        with entry.glock:
            batch = entry.queue[:]
            entry.queue.clear()
            entry.leader_active = False
        try:
            for p, rows in zip(batch, self._run_batch(entry, [p.params for p in batch])):
                p.rows = rows
        except Exception as e:
            for p in batch:
                p.error = e
        finally:
            for p in batch:
                p.event.set()
        if pending.error is not None:
            raise pending.error
        return pending.rows

    def _run_batch(self, entry: _PlanEntry, params_list) -> list:
        run = self.engine._execute_planned  # the engine's budget and spill apply
        if len(params_list) == 1:
            EXECUTE_BATCH.labels("single").inc()
            return [run(entry.plan, params_list[0]).to_pylist()]
        if entry.batchable is False:
            EXECUTE_BATCH.labels("fallback").inc()
            return [run(entry.plan, p).to_pylist() for p in params_list]
        # the window's bindings back to back through the one plan; the rows
        # come to the host after the last of them ran
        pages = [run(entry.plan, p) for p in params_list]
        EXECUTE_BATCH.labels("batched").inc()
        return [page.to_pylist() for page in pages]
