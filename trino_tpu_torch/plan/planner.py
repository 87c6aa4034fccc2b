"""Analyzer + logical planner: AST -> typed PlanNode tree.

Condenses the reference's three-stage frontend (sql/analyzer/StatementAnalyzer
.java name/type resolution, sql/planner/{LogicalPlanner,QueryPlanner,
RelationPlanner}.java plan construction, and the subset of
sql/planner/iterative/rule/ this engine needs) into one pass:

- scopes + name/type resolution (qualified and bare column refs, aliases)
- FROM comma-lists and JOIN..ON lowered to an equi-join tree: single-table
  WHERE conjuncts are pushed below joins (PredicatePushDown), cross joins
  eliminated by routing equality conjuncts to join keys (EliminateCrossJoins),
  common conjuncts factored out of OR disjunctions (ExtractCommonPredicates,
  the rewrite that makes TPC-H Q19 a join instead of a cross product)
- aggregate extraction: GROUP BY keys + aggregate calls become an Aggregate
  node; SELECT/HAVING/ORDER BY expressions are rewritten over its output
- subquery decorrelation (reference: sql/planner/DecorrelatingVisitor /
  TransformCorrelated* rules):
    EXISTS / NOT EXISTS      -> semi / anti join (equality conjuncts become
                                join keys, other correlated conjuncts become
                                the join residual)
    x IN (subquery)          -> semi join on x = item (anti for NOT IN)
    cmp with correlated
      scalar agg subquery    -> inner Aggregate grouped on the correlation
                                keys + inner join + filter
    cmp with uncorrelated
      scalar subquery        -> single-row Aggregate + cross join + filter
"""

from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

from ..connectors.spi import CatalogManager
from ..data.types import (
    BIGINT, BOOLEAN, DATE, DOUBLE, DecimalType, INTEGER, Type, UNKNOWN, VARCHAR,
    common_super_type, date_to_days,
)
from ..sql import ast as A
from ..sql.parser import parse
from .ir import Call, CaseWhen, Const, FieldRef, InListIr, IrExpr, LikeIr, Param
from .nodes import (
    AggCall, Aggregate, Distinct, Filter, Join, Limit, PlanNode, Project,
    Sort, SortKey, TableScan, TopN, Unnest,
)

__all__ = ["Planner", "PlanningError", "param_bindings"]


class _ParamBindings(threading.local):
    """Per-thread parameter binding context for planning a prepared-statement
    template (runtime/fastpath.py).  Each slot is ("bind", type, value) —
    translate to a runtime ir.Param — or ("bake", type, value) — translate to
    a plan constant (the generic-vs-custom-plan split: value-dependent
    lowerings like dictionary string ops must see the concrete value)."""

    def __init__(self):
        self.slots = None


_PARAM_BINDINGS = _ParamBindings()


@contextmanager
def param_bindings(slots):
    prev = _PARAM_BINDINGS.slots
    _PARAM_BINDINGS.slots = slots
    try:
        yield
    finally:
        _PARAM_BINDINGS.slots = prev


class PlanningError(Exception):
    pass


_AGG_FNS = {
    "sum", "count", "min", "max", "avg",
    "approx_distinct", "approx_percentile", "count_if",
    "stddev", "stddev_samp", "stddev_pop", "variance", "var_samp", "var_pop",
    "bool_and", "bool_or", "every", "arbitrary", "any_value",
    "corr", "covar_samp", "covar_pop", "regr_slope", "regr_intercept",
    "array_agg", "map_agg", "listagg", "string_agg",
}

_CMP_OPS = {"=": "eq", "<>": "ne", "<": "lt", "<=": "le", ">": "gt", ">=": "ge"}
_CMP_FLIP = {"eq": "eq", "ne": "ne", "lt": "gt", "le": "ge", "gt": "lt", "ge": "le"}


@dataclass
class Field:
    qualifier: Optional[str]  # table alias/name; None for hidden/derived
    name: Optional[str]  # None == hidden field (decorrelation scratch)
    type: Type


class Scope:
    """Name-resolution scope: fields of the current relation + parent chain
    (reference: sql/analyzer/Scope.java)."""

    def __init__(self, fields: list[Field], parent: Optional["Scope"] = None):
        self.fields = fields
        self.parent = parent

    def try_resolve(self, parts: tuple[str, ...]) -> Optional[tuple[int, int, Type]]:
        """-> (depth, field_index, type); depth 0 == this scope."""
        depth = 0
        scope: Optional[Scope] = self
        while scope is not None:
            hit = scope._resolve_local(parts)
            if hit is not None:
                return (depth, hit[0], hit[1])
            scope = scope.parent
            depth += 1
        return None

    def _resolve_local(self, parts: tuple[str, ...]) -> Optional[tuple[int, Type]]:
        if len(parts) == 1:
            matches = [
                (i, f.type) for i, f in enumerate(self.fields) if f.name == parts[0]
            ]
        elif len(parts) == 2:
            matches = [
                (i, f.type)
                for i, f in enumerate(self.fields)
                if f.name == parts[1] and f.qualifier == parts[0]
            ]
        else:
            return None
        if len(matches) > 1:
            raise PlanningError(f"ambiguous column reference: {'.'.join(parts)}")
        return matches[0] if matches else None


@dataclass
class RelationPlan:
    node: PlanNode
    fields: list[Field]

    @property
    def scope(self) -> Scope:
        return Scope(self.fields)


class Planner:
    """Entry point: Planner(catalogs).plan(sql | Query) -> PlanNode."""

    def __init__(self, catalogs: CatalogManager, default_catalog: str = "tpch"):
        self.catalogs = catalogs
        self.default_catalog = default_catalog
        # (catalog, view name) -> parsed A.Query.  Views expand at analysis
        # like the reference (StatementAnalyzer view expansion over
        # tree/CreateView definitions); base-table access control runs on the
        # expanded plan's scans.
        self.views: dict[tuple[str, str], A.Query] = {}
        self._view_stack: list[tuple[str, str]] = []  # cycle detection

    def plan(self, query) -> PlanNode:
        if isinstance(query, str):
            query = parse(query)
        return self._plan_query(query, outer=None, ctes={})

    # ------------------------------------------------------------------ query
    def _plan_query(
        self, q: A.Query, outer: Optional[Scope], ctes: dict[str, A.Query]
    ) -> PlanNode:
        if q.ctes:
            ctes = dict(ctes)
            for name, cq in q.ctes:
                ctes[name] = cq
        rel = self._plan_body(q.select, outer, ctes, order_by=q.order_by, limit=q.limit)
        return rel.node

    def _plan_body(
        self,
        body,
        outer: Optional[Scope],
        ctes: dict[str, A.Query],
        order_by: tuple[A.SortItem, ...] = (),
        limit: Optional[int] = None,
    ) -> RelationPlan:
        if isinstance(body, A.SetOp):
            rel = self._plan_setop(body, outer, ctes)
            node = rel.node
            if order_by:
                keys = []
                for si in order_by:
                    keys.append(
                        SortKey(
                            self._setop_order_key(si.expr, rel),
                            si.ascending,
                            _nulls_first(si),
                        )
                    )
                if limit is not None:
                    node = TopN(node, tuple(keys), limit)
                else:
                    node = Sort(node, tuple(keys))
            elif limit is not None:
                node = Limit(node, limit)
            return RelationPlan(node, rel.fields)
        return self._plan_select(body, outer, ctes, order_by=order_by, limit=limit)

    def _setop_order_key(self, e: A.Expr, rel: RelationPlan) -> IrExpr:
        if isinstance(e, A.IntLit):
            if not (1 <= e.value <= len(rel.fields)):
                raise PlanningError(f"ORDER BY position {e.value} out of range")
            return FieldRef(e.value - 1, rel.fields[e.value - 1].type)
        if isinstance(e, A.Ident) and len(e.parts) == 1:
            for i, f in enumerate(rel.fields):
                if f.name == e.parts[0]:
                    return FieldRef(i, f.type)
        raise PlanningError(f"ORDER BY over a set operation must reference output columns: {e}")

    def _plan_setop(
        self, s: A.SetOp, outer: Optional[Scope], ctes: dict[str, A.Query]
    ) -> RelationPlan:
        from .nodes import Concat

        left = self._plan_body(s.left, outer, ctes)
        right = self._plan_body(s.right, outer, ctes)
        if len(left.fields) != len(right.fields):
            raise PlanningError(
                f"set operation arity mismatch: {len(left.fields)} vs {len(right.fields)}"
            )
        types = [
            common_super_type(l.type, r.type)
            for l, r in zip(left.fields, right.fields)
        ]
        left = _cast_relation(left, types)
        right = _cast_relation(right, types)
        fields = [Field(None, f.name, t) for f, t in zip(left.fields, types)]
        if s.kind == "union":
            rel = RelationPlan(Concat((left.node, right.node)), fields)
            if not s.all:
                rel = RelationPlan(Distinct(rel.node), fields)
            return rel
        if s.all:
            raise PlanningError(f"{s.kind.upper()} ALL not supported")
        keys_l = tuple(FieldRef(i, t) for i, t in enumerate(types))
        keys_r = tuple(FieldRef(i, t) for i, t in enumerate(types))
        kind = "semi" if s.kind == "intersect" else "anti"
        join = Join(kind, left.node, right.node, keys_l, keys_r, None)
        return RelationPlan(Distinct(join), fields)

    # ----------------------------------------------------------------- select
    def _plan_select(
        self,
        sel: A.Select,
        outer: Optional[Scope],
        ctes: dict[str, A.Query],
        order_by: tuple[A.SortItem, ...] = (),
        limit: Optional[int] = None,
    ) -> RelationPlan:
        # 1. FROM: relation plans + join-graph construction with pushdown
        rel = self._plan_from(sel.relations, sel.where, outer, ctes)

        # 2. aggregate extraction
        agg_calls = self._collect_aggs(sel, order_by)
        grouped = bool(sel.group_by) or bool(agg_calls)

        if grouped:
            rel, agg_scope_map = self._plan_aggregate(rel, sel, agg_calls, outer, ctes)
            translator = _Translator(rel.scope, outer, agg_map=agg_scope_map)
            if sel.having is not None:
                rel = self._apply_boolean(rel, sel.having, translator, outer, ctes)
                translator = _Translator(rel.scope, outer, agg_map=agg_scope_map)
        else:
            if sel.having is not None:
                raise PlanningError("HAVING without aggregation")
            translator = _Translator(rel.scope, outer)

        # 3. window functions (evaluate after WHERE/GROUP BY/HAVING,
        #    before the final projection — SQL evaluation order)
        win_funcs = self._collect_windows(sel, order_by)
        if win_funcs:
            was_grouped = translator.grouped
            rel, win_map = self._plan_windows(rel, win_funcs, translator, outer)
            merged = dict(translator.agg_map or {})
            merged.update(win_map)
            translator = _Translator(rel.scope, outer, agg_map=merged, grouped=was_grouped)

        # 4. SELECT projection — subqueries in select items (scalar
        # subqueries, EXISTS/IN as boolean expressions) lower to appended
        # join columns first (TPC-DS q09's CASE over scalar subqueries)
        items = self._expand_stars(sel.items, rel)
        if any(_has_subquery(it.expr) for it in items):
            rel, sub_map = self._lower_subquery_exprs(
                rel, [it.expr for it in items], outer, ctes, translator
            )
            merged = dict(translator.agg_map or {})
            merged.update(sub_map)
            translator = _Translator(
                rel.scope, outer, agg_map=merged, grouped=translator.grouped
            )
        exprs: list[IrExpr] = []
        names: list[str] = []
        for it in items:
            exprs.append(translator.translate(it.expr))
            names.append(it.alias or _derive_name(it.expr, len(names)))
        out_fields = [Field(None, n, e.type) for n, e in zip(names, exprs)]

        # ORDER BY may reference select aliases, positions, or arbitrary
        # expressions over the input scope; the latter become HIDDEN sort
        # columns dropped by a final projection (the reference's
        # QueryPlanner does the same via a synthesized Symbol).
        sort_keys: list[SortKey] = []
        hidden: list[IrExpr] = []
        for si in order_by:
            try:
                k = self._resolve_order_key(si, items, exprs, names, translator)
            except PlanningError:
                if sel.distinct:
                    raise PlanningError(
                        "for SELECT DISTINCT, ORDER BY expressions must "
                        "appear in the select list"
                    )
                t_ir = translator.translate(_substitute_aliases(si.expr, items))
                k = FieldRef(len(exprs) + len(hidden), t_ir.type)
                hidden.append(t_ir)
            sort_keys.append(SortKey(k, si.ascending, _nulls_first(si)))

        proj = Project(
            rel.node,
            tuple(exprs) + tuple(hidden),
            tuple(names) + tuple(f"_s{i}" for i in range(len(hidden))),
        )
        node: PlanNode = proj
        if sel.distinct:
            node = Distinct(node)
        if sort_keys:
            # sort keys referencing select output are FieldRefs over proj
            if limit is not None:
                node = TopN(node, tuple(sort_keys), limit)
            else:
                node = Sort(node, tuple(sort_keys))
        elif limit is not None:
            node = Limit(node, limit)
        if hidden:
            node = Project(
                node,
                tuple(FieldRef(i, e.type) for i, e in enumerate(exprs)),
                tuple(names),
            )
        return RelationPlan(node, out_fields)

    def _resolve_order_key(
        self,
        si: A.SortItem,
        items: list[A.SelectItem],
        exprs: list[IrExpr],
        names: list[str],
        translator: "_Translator",
    ) -> IrExpr:
        e = si.expr
        if isinstance(e, A.IntLit):  # ORDER BY ordinal
            if not (1 <= e.value <= len(exprs)):
                raise PlanningError(f"ORDER BY position {e.value} out of range")
            i = e.value - 1
            return FieldRef(i, exprs[i].type)
        if isinstance(e, A.Ident) and len(e.parts) == 1:
            for i, n in enumerate(names):
                if n == e.parts[0]:
                    return FieldRef(i, exprs[i].type)
        for i, it in enumerate(items):  # structural match against select items
            if it.expr == e:
                return FieldRef(i, exprs[i].type)
        # expression over the pre-projection scope that coincides with a
        # select expression after translation; select aliases may appear
        # INSIDE the expression (`order by case when lochierarchy = 0 ...`,
        # TPC-DS q36/q70/q86) — substitute them first (the reference resolves
        # aliases in ORDER BY scope, sql/analyzer/OrderByExpressionRewriter)
        e = _substitute_aliases(e, items)
        translated = translator.translate(e)
        for i, ex in enumerate(exprs):
            if ex == translated:
                return FieldRef(i, ex.type)
        raise PlanningError(f"ORDER BY expression not in select list: {e}")

    def _expand_stars(
        self, items: Sequence[A.SelectItem | A.Star], rel: RelationPlan
    ) -> list[A.SelectItem]:
        out: list[A.SelectItem] = []
        for it in items:
            if isinstance(it, A.Star):
                for f in rel.fields:
                    if f.name is None:
                        continue
                    if it.qualifier is not None and f.qualifier != it.qualifier:
                        continue
                    parts = (f.name,) if it.qualifier is None else (it.qualifier, f.name)
                    out.append(A.SelectItem(A.Ident(parts), f.name))
            else:
                out.append(it)
        return out

    # ------------------------------------------------------------------- FROM
    def _plan_from(
        self,
        relations: tuple[A.Relation, ...],
        where: Optional[A.Expr],
        outer: Optional[Scope],
        ctes: dict[str, A.Query],
    ) -> RelationPlan:
        if not relations:
            # FROM-less SELECT: single-row dummy (reference: ValuesNode)
            from .nodes import Values

            return RelationPlan(Values((), (), ((),)), [])

        # UNNEST items in a FROM list are lateral: they may reference columns
        # of the other FROM items, so they apply AFTER the base join (the
        # reference plans them as lateral join unnests,
        # RelationPlanner.planJoinUnnest)
        unnest_items = [r for r in relations if isinstance(r, A.UnnestRelation)]
        base = tuple(r for r in relations if not isinstance(r, A.UnnestRelation))
        if not base:
            from .nodes import Values

            joined0 = RelationPlan(Values((), (), ((),)), [])
            for u in unnest_items:
                joined0 = self._plan_unnest(joined0, u, outer)
            unnest_items = []
            plans: list[RelationPlan] = [joined0]
        else:
            plans = [self._plan_relation(r, outer, ctes) for r in base]

        conjuncts = _split_conjuncts(where) if where is not None else []
        conjuncts = [_extract_common_or_conjuncts(c) for c in conjuncts]
        flat: list[A.Expr] = []
        for c in conjuncts:
            flat.extend(_split_conjuncts(c))
        conjuncts = flat

        # classify conjuncts: subquery-bearing ones applied after the join
        plain: list[A.Expr] = []
        subq: list[A.Expr] = []
        for c in conjuncts:
            (subq if _has_subquery(c) else plain).append(c)

        # push single-relation predicates below the join
        remaining: list[A.Expr] = []
        for c in plain:
            hit = None
            for i, p in enumerate(plans):
                if _is_local(c, p.scope):
                    hit = i
                    break
            if hit is not None:
                p = plans[hit]
                t = _Translator(p.scope, outer)
                plans[hit] = RelationPlan(Filter(p.node, _as_bool(t.translate(c))), p.fields)
            else:
                remaining.append(c)

        # cost-based left-deep join tree over equality edges (reference:
        # iterative/rule/ReorderJoins + EliminateCrossJoins): the LARGEST
        # relation (post-pushdown stats) anchors the probe spine and the
        # remaining relations join smallest-first as RIGHT (build) sides —
        # small builds broadcast cheaply and keep expansion frames tight
        def _size(p: RelationPlan) -> float:
            from .stats import estimate as _est

            try:
                return _est(p.node, self.catalogs).rows
            except Exception:
                return 1e6

        sizes = [_size(p) for p in plans]
        start = max(range(len(plans)), key=lambda i: sizes[i])
        joined = plans[start]
        pending = [i for i in range(len(plans)) if i != start]
        while pending:
            connected = [
                j for j in pending
                if _equi_keys(remaining, joined.scope, plans[j].scope)
            ]
            pool = connected or pending
            picked = min(pool, key=lambda j: sizes[j])
            right = plans[picked]
            pending.remove(picked)
            joined = self._make_join("inner", joined, right, remaining, outer)

        # restore FROM-order field layout: the physical join order is a cost
        # decision and must not leak into name resolution or SELECT * order
        # (fields are shared objects, so identity maps join-order -> FROM-order)
        want = [f for p in plans for f in p.fields]
        if [id(f) for f in joined.fields] != [id(f) for f in want]:
            pos = {id(f): i for i, f in enumerate(joined.fields)}
            exprs = tuple(FieldRef(pos[id(f)], f.type) for f in want)
            names = tuple(
                f.name if f.name is not None else f"_h{i}" for i, f in enumerate(want)
            )
            joined = RelationPlan(Project(joined.node, exprs, names), want)

        # lateral UNNEST items apply over the joined base relations; residual
        # predicates after them so they can reference unnested columns
        unnest_fields: list[list[Field]] = []
        for u in unnest_items:
            before = len(joined.fields)
            joined = self._plan_unnest(joined, u, outer)
            unnest_fields.append(list(joined.fields[before:]))
        if unnest_items:
            # restore WRITTEN FROM-list order (an unnest before a table must
            # contribute its columns first in SELECT *), same invariant as
            # the join-order restoration above
            base_iter = iter(plans)
            ufield_iter = iter(unnest_fields)
            want2: list[Field] = []
            for r in relations:
                if isinstance(r, A.UnnestRelation):
                    want2.extend(next(ufield_iter))
                else:
                    want2.extend(next(base_iter).fields)
            if [id(f) for f in joined.fields] != [id(f) for f in want2]:
                pos = {id(f): i for i, f in enumerate(joined.fields)}
                exprs = tuple(FieldRef(pos[id(f)], f.type) for f in want2)
                names2 = tuple(
                    f.name if f.name is not None else f"_h{i}"
                    for i, f in enumerate(want2)
                )
                joined = RelationPlan(Project(joined.node, exprs, names2), want2)

        # residual multi-relation predicates
        node = joined.node
        for c in remaining:
            t = _Translator(Scope(joined.fields), outer)
            node = Filter(node, _as_bool(t.translate(c)))
        joined = RelationPlan(node, joined.fields)

        # subquery conjuncts: decorrelate one by one
        for c in subq:
            joined = self._apply_subquery_conjunct(joined, c, outer, ctes)
        return joined

    def _make_join(
        self,
        kind: str,
        left: RelationPlan,
        right: RelationPlan,
        conjuncts: list[A.Expr],
        outer: Optional[Scope],
        extra_on: Optional[A.Expr] = None,
    ) -> RelationPlan:
        """Consume applicable equality conjuncts as join keys; build the node."""
        if extra_on is not None:
            conjuncts.extend(_split_conjuncts(extra_on))
        lt = _Translator(left.scope, outer)
        rt = _Translator(right.scope, outer)
        lkeys: list[IrExpr] = []
        rkeys: list[IrExpr] = []
        residual: list[A.Expr] = []
        used: list[A.Expr] = []
        for c in conjuncts:
            pair = _as_equi_pair(c, left.scope, right.scope)
            if pair is not None:
                a, b = pair
                lkeys.append(lt.translate(a))
                rkeys.append(rt.translate(b))
                used.append(c)
            elif _is_local(c, Scope(left.fields + right.fields)):
                residual.append(c)
                used.append(c)
        for c in used:
            conjuncts.remove(c)
        fields = left.fields + right.fields
        res_ir = None
        if residual:
            ct = _Translator(Scope(fields), outer)
            res_ir = _conjoin([_as_bool(ct.translate(c)) for c in residual])
        # coerce key dtypes pairwise
        lkeys2, rkeys2 = [], []
        for a, b in zip(lkeys, rkeys):
            tt = common_super_type(a.type, b.type)
            lkeys2.append(_cast_ir(a, tt))
            rkeys2.append(_cast_ir(b, tt))
        node = Join(kind, left.node, right.node, tuple(lkeys2), tuple(rkeys2), res_ir)
        if kind in ("semi", "anti"):
            return RelationPlan(node, left.fields)
        return RelationPlan(node, fields)

    def _plan_table_function(self, r) -> RelationPlan:
        """Built-in polymorphic table functions (reference:
        spi/function/table/ + LeafTableFunctionOperator).  `sequence(start,
        stop [, step])` is the canonical leaf function — args positional or
        named (start =>, stop =>, step =>).  Lowers to UNNEST of the scalar
        sequence() array (one interned array value, device-side expansion —
        no per-row Values materialization in the plan)."""
        from .nodes import Values

        if r.name != "sequence":
            raise PlanningError(f"unknown table function: {r.name}")
        named: dict = {}
        pos: list = []
        for name, e in zip(r.arg_names, r.args):
            (named.__setitem__(name, e) if name else pos.append(e))
        start = named.get("start", pos[0] if len(pos) > 0 else A.IntLit(0))
        stop = named.get("stop", pos[1] if len(pos) > 1 else None)
        step = named.get("step", pos[2] if len(pos) > 2 else None)
        if stop is None:
            raise PlanningError("sequence() requires a stop bound")
        fn_args = (start, stop) + ((step,) if step is not None else ())
        unnest = A.UnnestRelation(
            (A.FuncCall("sequence", fn_args),),
            r.alias or "sequence",
            ("sequential_number",),
            False,
        )
        return self._plan_unnest(
            RelationPlan(Values((), (), ((),)), []), unnest, None
        )

    def _plan_relation(
        self, r: A.Relation, outer: Optional[Scope], ctes: dict[str, A.Query]
    ) -> RelationPlan:
        if isinstance(r, A.Table):
            if r.name in ctes:
                sub = self._plan_subquery_relation(ctes[r.name], outer, ctes)
                alias = r.alias or r.name
                return RelationPlan(
                    sub.node, [Field(alias, f.name, f.type) for f in sub.fields]
                )
            catalog = r.catalog or self.default_catalog
            try:
                connector = self.catalogs.get(catalog)
            except KeyError:
                if r.catalog is None:
                    raise
                # schema.table (Trino 2-part semantics): the first part is a
                # schema inside the default catalog, not a catalog name
                catalog = self.default_catalog
                connector = self.catalogs.get(catalog)
            vkey = (catalog, r.name)
            if vkey in self.views:
                if vkey in self._view_stack:
                    chain = " -> ".join(n for _, n in self._view_stack + [vkey])
                    raise PlanningError(f"view cycle detected: {chain}")
                self._view_stack.append(vkey)
                try:
                    # a view body sees no outer scope and no caller CTEs
                    sub = self._plan_subquery_relation(
                        self.views[vkey], None, {}
                    )
                finally:
                    self._view_stack.pop()
                alias = r.alias or r.name
                return RelationPlan(
                    sub.node, [Field(alias, f.name, f.type) for f in sub.fields]
                )
            schema = connector.table_schema(r.name)
            names = tuple(schema.column_names())
            types = tuple(c.type for c in schema.columns)
            node = TableScan(catalog, r.name, names, types)
            alias = r.alias or r.name
            return RelationPlan(node, [Field(alias, n, t) for n, t in zip(names, types)])
        if isinstance(r, A.SubqueryRelation):
            sub = self._plan_subquery_relation(r.query, outer, ctes)
            return RelationPlan(
                sub.node, [Field(r.alias, f.name, f.type) for f in sub.fields]
            )
        if isinstance(r, A.TableFunctionRelation):
            return self._plan_table_function(r)
        if isinstance(r, A.UnnestRelation):
            from .nodes import Values

            # standalone UNNEST (no lateral references)
            return self._plan_unnest(
                RelationPlan(Values((), (), ((),)), []), r, outer
            )
        if isinstance(r, A.JoinRelation):
            if isinstance(r.right, A.UnnestRelation):
                # [CROSS | LEFT] JOIN UNNEST(expr): lateral over the left side
                # (reference: RelationPlanner.planJoinUnnest)
                left = self._plan_relation(r.left, outer, ctes)
                if r.kind not in ("cross", "inner", "left"):
                    raise PlanningError(f"{r.kind} JOIN UNNEST not supported")
                if r.on is not None and not (
                    isinstance(r.on, A.BoolLit) and r.on.value
                ):
                    raise PlanningError("JOIN UNNEST requires ON TRUE")
                return self._plan_unnest(
                    left, r.right, outer, outer_join=(r.kind == "left")
                )
            left = self._plan_relation(r.left, outer, ctes)
            right = self._plan_relation(r.right, outer, ctes)
            if r.kind == "cross":
                return self._make_join("inner", left, right, [], outer)
            if r.kind == "right":
                return self._swap_right_join(left, right, r.on, outer)
            conjuncts: list[A.Expr] = []
            rel = self._make_join(r.kind, left, right, conjuncts, outer, extra_on=r.on)
            for c in conjuncts:  # ON leftovers that didn't classify
                t = _Translator(rel.scope, outer)
                rel = RelationPlan(Filter(rel.node, _as_bool(t.translate(c))), rel.fields)
            return rel
        if isinstance(r, A.MatchRecognizeRelation):
            return self._plan_match_recognize(r, outer, ctes)
        raise PlanningError(f"unsupported relation: {r}")

    def _plan_match_recognize(
        self,
        r: A.MatchRecognizeRelation,
        outer: Optional[Scope],
        ctes: dict[str, A.Query],
    ) -> RelationPlan:
        """MATCH_RECOGNIZE -> MatchRecognize node (reference:
        sql/analyzer/PatternRecognitionAnalyzer.java + RelationPlanner's
        pattern recognition planning).  DEFINE conditions are rewritten over
        the child schema: `L.col` (L = the defining label) and bare `col`
        reference the CURRENT row, PREV(expr[, k]) becomes a partition-aware
        shifted column.  Measures support FIRST/LAST(L.col | col), `L.col`
        (= LAST), bare columns (= LAST row of the match), CLASSIFIER(),
        MATCH_NUMBER(), and arbitrary scalar expressions over those."""
        from ..ops.matchrec import compile_pattern
        from .nodes import MatchRecognize

        child = self._plan_relation(r.input, outer, ctes)
        t = _Translator(child.scope, outer)
        part_irs = [t.translate(e) for e in r.partition_by]
        order_keys = tuple(
            SortKey(t.translate(si.expr), si.ascending, _nulls_first(si))
            for si in r.order_by
        )
        program, labels = compile_pattern(r.pattern)
        def_map = {lab.lower(): cond for lab, cond in r.defines}
        unknown = set(def_map) - set(labels)
        if unknown:
            raise PlanningError(f"DEFINE for labels not in pattern: {unknown}")

        C = len(child.fields)
        prev_exprs: list[tuple[IrExpr, int]] = []

        def strip_label(e: A.Expr, label: str) -> A.Expr:
            """L.col -> col for the defining label; other labels rejected."""
            if isinstance(e, A.Ident) and len(e.parts) == 2:
                qual = e.parts[0].lower()
                if qual == label:
                    return A.Ident((e.parts[1],))
                if qual in labels:
                    raise PlanningError(
                        f"DEFINE {label}: reference to other label"
                        f" {e.parts[0]} not supported"
                    )
            if isinstance(e, (A.ScalarSubquery, A.Exists, A.InSubquery)):
                raise PlanningError("subqueries not allowed in DEFINE")
            import dataclasses as _dc

            if not _dc.is_dataclass(e):
                return e
            changes = {}
            for f in _dc.fields(e):
                v = getattr(e, f.name)
                if isinstance(v, A.Expr):
                    nv = strip_label(v, label)
                    if nv is not v:
                        changes[f.name] = nv
                elif isinstance(v, tuple) and v and all(
                    isinstance(x, A.Expr) for x in v
                ):
                    nv = tuple(strip_label(x, label) for x in v)
                    if nv != v:
                        changes[f.name] = nv
            return _dc.replace(e, **changes) if changes else e

        def lower_prev(ir: IrExpr) -> IrExpr:
            """Call('prev'|'next', (expr[, k])) subtrees -> FieldRef(C + j).
            NEXT is recorded as a negative shift (the executor shifts the
            other way)."""
            if isinstance(ir, Call) and ir.op in ("prev", "next"):
                inner = ir.args[0]
                k = 1
                if len(ir.args) > 1:
                    if not isinstance(ir.args[1], Const):
                        raise PlanningError("PREV/NEXT offset must be a literal")
                    k = int(ir.args[1].value)
                inner = lower_prev(inner)
                prev_exprs.append((inner, k if ir.op == "prev" else -k))
                return FieldRef(C + len(prev_exprs) - 1, inner.type)
            import dataclasses as _dc

            changes = {}
            for f in _dc.fields(ir):
                v = getattr(ir, f.name)
                if isinstance(v, IrExpr):
                    nv = lower_prev(v)
                    if nv is not v:
                        changes[f.name] = nv
                elif isinstance(v, tuple) and v and all(
                    isinstance(x, IrExpr) for x in v
                ):
                    nv = tuple(lower_prev(x) for x in v)
                    if nv != v:
                        changes[f.name] = nv
            return _dc.replace(ir, **changes) if changes else ir

        define_irs: list[IrExpr] = []
        t.pattern_nav = True  # PREV/NEXT legal inside DEFINE conditions
        try:
            for lab in labels:
                cond = def_map.get(lab)
                if cond is None:
                    define_irs.append(Const(True, BOOLEAN))  # undefined: always ok
                    continue
                stripped = strip_label(cond, lab)
                ir = t.translate(stripped)
                define_irs.append(_as_bool(lower_prev(ir)))
        finally:
            t.pattern_nav = False

        # ---- measures: rewrite primitives into a prim scope ---------------
        prims: list[tuple] = []
        prim_types: list[Type] = []

        def prim_ref(kind: str, label_ix: int, field_ix: int, tt: Type) -> FieldRef:
            key = (kind, label_ix, field_ix)
            for i, p in enumerate(prims):
                if p == key:
                    return FieldRef(i, prim_types[i])
            prims.append(key)
            prim_types.append(tt)
            return FieldRef(len(prims) - 1, tt)

        def child_field(name: str) -> tuple[int, Type]:
            hit = child.scope.try_resolve((name,))
            if hit is None or hit[0] != 0:
                raise PlanningError(f"MEASURES: column not found: {name}")
            return hit[1], hit[2]

        def prim_placeholder(kind: str, label_ix: int, field_ix: int, tt: Type):
            ref = prim_ref(kind, label_ix, field_ix, tt)
            return A.Ident((f"$m{ref.index}",))

        def rewrite_measure(e: A.Expr) -> A.Expr:
            """Replace pattern primitives with $m<j> placeholder idents so
            arbitrary scalar expressions over them translate normally."""
            if isinstance(e, A.FuncCall):
                fn = e.name.lower()
                if fn == "match_number" and not e.args:
                    return prim_placeholder("match_number", -1, -1, BIGINT)
                if fn == "classifier" and not e.args:
                    return prim_placeholder("classifier", -1, -1, VARCHAR)
                if fn in ("first", "last") and len(e.args) == 1 and isinstance(
                    e.args[0], A.Ident
                ):
                    parts = e.args[0].parts
                    if len(parts) == 2 and parts[0].lower() in labels:
                        ix, tt = child_field(parts[1])
                        return prim_placeholder(
                            fn, labels.index(parts[0].lower()), ix, tt
                        )
                    if len(parts) == 1:
                        ix, tt = child_field(parts[0])
                        return prim_placeholder(fn, -1, ix, tt)
            if isinstance(e, A.Ident):
                if len(e.parts) == 2 and e.parts[0].lower() in labels:
                    ix, tt = child_field(e.parts[1])
                    return prim_placeholder(
                        "last", labels.index(e.parts[0].lower()), ix, tt
                    )
                if len(e.parts) == 1:
                    ix, tt = child_field(e.parts[0])
                    return prim_placeholder("last", -1, ix, tt)
            if isinstance(e, (A.ScalarSubquery, A.Exists, A.InSubquery)):
                raise PlanningError("subqueries not allowed in MEASURES")
            import dataclasses as _dc

            if not _dc.is_dataclass(e):
                return e
            changes = {}
            for f in _dc.fields(e):
                v = getattr(e, f.name)
                if isinstance(v, A.Expr):
                    nv = rewrite_measure(v)
                    if nv is not v:
                        changes[f.name] = nv
                elif isinstance(v, tuple) and v and all(
                    isinstance(x, A.Expr) for x in v
                ):
                    nv = tuple(rewrite_measure(x) for x in v)
                    if nv != v:
                        changes[f.name] = nv
            return _dc.replace(e, **changes) if changes else e

        rewritten = [(rewrite_measure(e), name) for e, name in r.measures]
        prim_scope = Scope(
            [Field(None, f"$m{i}", tt) for i, tt in enumerate(prim_types)]
        )
        mt = _Translator(prim_scope, None)
        measure_irs: list[IrExpr] = []
        measure_names: list[str] = []
        for e, name in rewritten:
            measure_irs.append(mt.translate(e))
            measure_names.append(name)

        # ONE ROW PER MATCH partition key columns must be plain FieldRefs so
        # output naming works
        if not r.all_rows:
            for ir in part_irs:
                if not isinstance(ir, FieldRef):
                    raise PlanningError(
                        "PARTITION BY expressions must be plain columns"
                    )

        node = MatchRecognize(
            child.node, tuple(part_irs), order_keys, labels, program,
            tuple(define_irs), tuple(prev_exprs), tuple(prims),
            tuple(prim_types), tuple(measure_irs), tuple(measure_names),
            r.all_rows, r.after_skip,
        )
        alias = r.alias
        if r.all_rows:
            fields = [
                Field(alias, f.name, f.type) for f in child.fields
            ] + [
                Field(alias, n, m.type)
                for n, m in zip(measure_names, measure_irs)
            ]
        else:
            fields = [
                Field(alias, child.fields[ir.index].name, ir.type)
                for ir in part_irs
            ] + [
                Field(alias, n, m.type)
                for n, m in zip(measure_names, measure_irs)
            ]
        return RelationPlan(node, fields)

    def _swap_right_join(self, left, right, on, outer):
        rel = self._make_join("left", right, left, [], outer, extra_on=on)
        # restore original column order (left fields first)
        nl, nr = len(left.fields), len(right.fields)
        perm = list(range(nr, nr + nl)) + list(range(nr))
        exprs = tuple(FieldRef(i, rel.fields[i].type) for i in perm)
        names = tuple(rel.fields[i].name or f"_c{k}" for k, i in enumerate(perm))
        node = Project(rel.node, exprs, names)
        return RelationPlan(node, [rel.fields[i] for i in perm])

    def _plan_unnest(
        self,
        rel: RelationPlan,
        u: A.UnnestRelation,
        outer: Optional[Scope],
        outer_join: bool = False,
    ) -> RelationPlan:
        """Lateral array expansion over `rel` (reference: UnnestNode via
        RelationPlanner.planJoinUnnest; executed by ops/relops.py
        unnest_expand)."""
        t = _Translator(rel.scope, outer)
        irs: list[IrExpr] = []
        elem_types: list[Type] = []
        for e in u.exprs:
            ir = t.translate(e)
            if not ir.type.is_array:
                raise PlanningError(f"UNNEST argument must be an array, got {ir.type}")
            irs.append(ir)
            elem_types.append(ir.type.element)
        n_el = len(irs)
        if u.column_aliases:
            expected = n_el + (1 if u.with_ordinality else 0)
            if len(u.column_aliases) not in (n_el, expected):
                raise PlanningError(
                    f"UNNEST column aliases: got {len(u.column_aliases)}, "
                    f"expected {n_el} (+1 with ordinality)"
                )
            names = list(u.column_aliases[:n_el])
            ord_name = (
                u.column_aliases[n_el]
                if len(u.column_aliases) > n_el
                else "ordinality"
            )
        else:
            names = [
                e.parts[-1] if isinstance(e, A.Ident) else f"unnest_{i}"
                for i, e in enumerate(u.exprs)
            ]
            ord_name = "ordinality"
        node = Unnest(
            rel.node, tuple(irs), tuple(names), tuple(elem_types),
            u.with_ordinality, outer_join, ord_name,
        )
        fields = list(rel.fields) + [
            Field(u.alias, nm, tt) for nm, tt in zip(names, elem_types)
        ]
        if u.with_ordinality:
            fields.append(Field(u.alias, ord_name, BIGINT))
        return RelationPlan(node, fields)

    def _plan_subquery_relation(
        self, q: A.Query, outer: Optional[Scope], ctes: dict[str, A.Query]
    ) -> RelationPlan:
        if q.ctes:
            ctes = dict(ctes)
            for name, cq in q.ctes:
                ctes[name] = cq
        return self._plan_body(q.select, outer, ctes, order_by=q.order_by, limit=q.limit)

    # ----------------------------------------------------------- aggregation
    def _collect_aggs(self, sel: A.Select, order_by) -> list[A.FuncCall]:
        found: list[A.FuncCall] = []

        def visit(e: A.Expr):
            if isinstance(e, A.FuncCall) and e.name in _AGG_FNS:
                if e not in found:
                    found.append(e)
                return  # no nested aggs
            for child in _ast_children(e):
                visit(child)

        for it in sel.items:
            if isinstance(it, A.SelectItem):
                visit(it.expr)
        if sel.having is not None:
            visit(sel.having)
        for si in order_by:
            visit(si.expr)
        return found

    def _plan_aggregate(
        self,
        rel: RelationPlan,
        sel: A.Select,
        agg_calls: list[A.FuncCall],
        outer: Optional[Scope],
        ctes: dict[str, A.Query],
    ) -> tuple[RelationPlan, dict[A.Expr, FieldRef]]:
        if sel.grouping_sets is not None:
            return self._plan_grouping_sets(rel, sel, agg_calls, outer)
        t = _Translator(rel.scope, outer)
        group_irs = [t.translate(g) for g in sel.group_by]
        aggs = self._build_agg_calls(agg_calls, t)
        names = tuple(f"_g{i}" for i in range(len(group_irs))) + tuple(
            f"_a{i}" for i in range(len(aggs))
        )
        node = Aggregate(rel.node, tuple(group_irs), tuple(aggs), names)
        # scope of the aggregate output: group fields keep their source names
        # when the group expr is a bare column, so post-agg name resolution works
        fields: list[Field] = []
        for g_ast, g_ir in zip(sel.group_by, group_irs):
            hit = (
                rel.scope.try_resolve(g_ast.parts)
                if isinstance(g_ast, A.Ident)
                else None
            )
            if hit is not None:  # bare column (not e.g. a row dereference)
                f = rel.fields[hit[1]]
                fields.append(Field(f.qualifier, f.name, g_ir.type))
            else:
                fields.append(Field(None, None, g_ir.type))
        for a in aggs:
            fields.append(Field(None, None, a.type))
        # agg_map: AST expression -> FieldRef over aggregate output
        agg_map: dict[A.Expr, FieldRef] = {}
        for i, g_ast in enumerate(sel.group_by):
            agg_map[g_ast] = FieldRef(i, group_irs[i].type)
        base = len(group_irs)
        for i, fc in enumerate(agg_calls):
            agg_map[fc] = FieldRef(base + i, aggs[i].type)
        return RelationPlan(node, fields), agg_map

    def _agg_order(self, fc: A.FuncCall, t: "_Translator"):
        """Translate an aggregate's ORDER BY into (ir, asc, nulls_first)
        triples over the child schema (reference: ordered aggregation inputs,
        docs/src/main/sphinx/functions/aggregate.md)."""
        return tuple(
            (t.translate(si.expr), si.ascending, _nulls_first(si))
            for si in fc.order_by
        )

    def _build_agg_calls(self, agg_calls: list[A.FuncCall], t: "_Translator") -> list[AggCall]:
        aggs: list[AggCall] = []
        for fc in agg_calls:
            if fc.order_by and fc.name not in ("array_agg", "listagg", "string_agg"):
                raise PlanningError(
                    f"ORDER BY in aggregate is only supported for "
                    f"array_agg/listagg, not {fc.name}"
                )
            if fc.name == "count" and not fc.args:
                aggs.append(AggCall("count_star", None, BIGINT))
                continue
            arg = t.translate(fc.args[0])
            name = fc.name
            # rewrites to the kernel-level aggregate set (reference: 224
            # accumulator files; here a small orthogonal core + rewrites)
            if name == "count_if":
                arg = CaseWhen(
                    ((_as_bool(arg), Const(1, BIGINT)),), Const(0, BIGINT), BIGINT
                )
                aggs.append(AggCall("sum", arg, BIGINT))
                continue
            if name == "approx_distinct":
                # real HyperLogLog sketch (ops/relops.py _segment_hll) — the
                # point of approx_distinct is CONSTANT state per group at
                # scale, which exact distinct cannot honor (reference:
                # aggregation/ApproximateCountDistinctAggregations,
                # spi/type/HyperLogLogType)
                aggs.append(AggCall("approx_distinct", arg, BIGINT))
                continue
            if name == "approx_percentile":
                if not arg.type.is_numeric:
                    raise PlanningError("approx_percentile requires numeric input")
                p_ir = t.translate(fc.args[1])
                if not isinstance(p_ir, Const):
                    raise PlanningError("approx_percentile fraction must be a literal")
                p = float(p_ir.value)
                if p_ir.type.is_decimal:
                    p /= 10.0 ** p_ir.type.scale
                if not (0.0 <= p <= 1.0):
                    raise PlanningError("percentile fraction must be in [0, 1]")
                aggs.append(AggCall("percentile", arg, arg.type, param=p))
                continue
            if name in ("arbitrary", "any_value"):
                # deterministic choice (min) — any value qualifies
                aggs.append(AggCall("min", arg, arg.type))
                continue
            if name in ("corr", "covar_samp", "covar_pop", "regr_slope",
                        "regr_intercept"):
                # two-argument moments (reference: aggregation/
                # CorrelationAggregation, CovarianceAggregation,
                # RegressionAggregation — pairwise sums of x, y, xx, yy, xy)
                if len(fc.args) != 2:
                    raise PlanningError(f"{name} takes exactly two arguments")
                y = _cast_ir(arg, DOUBLE)
                x = _cast_ir(t.translate(fc.args[1]), DOUBLE)
                aggs.append(AggCall(name, y, DOUBLE, arg2=x))
                continue
            if name == "array_agg":
                from ..data.types import ArrayType

                aggs.append(
                    AggCall("array_agg", arg, ArrayType(arg.type), fc.distinct,
                            order_keys=self._agg_order(fc, t))
                )
                continue
            if name == "map_agg":
                from ..data.types import MapType

                if len(fc.args) != 2:
                    raise PlanningError("map_agg takes exactly two arguments")
                v = t.translate(fc.args[1])
                aggs.append(
                    AggCall("map_agg", arg, MapType(arg.type, v.type), arg2=v)
                )
                continue
            if name in ("listagg", "string_agg"):
                sep = ","
                if len(fc.args) > 1:
                    sep_ir = t.translate(fc.args[1])
                    if not isinstance(sep_ir, Const):
                        raise PlanningError("listagg separator must be a literal")
                    sep = str(sep_ir.value)
                aggs.append(AggCall("listagg", arg, VARCHAR, fc.distinct, sep=sep,
                                    order_keys=self._agg_order(fc, t)))
                continue
            if name == "every":
                name = "bool_and"
            if name == "stddev":
                name = "stddev_samp"
            if name == "variance":
                name = "var_samp"
            if name in ("stddev_samp", "stddev_pop", "var_samp", "var_pop"):
                aggs.append(AggCall(name, _cast_ir(arg, DOUBLE), DOUBLE))
                continue
            if name in ("bool_and", "bool_or"):
                aggs.append(AggCall(name, _as_bool(arg), BOOLEAN))
                continue
            if name == "avg" and arg.type.is_decimal:
                # avg over decimals divides at the end in f64; feeding the
                # accumulator doubles keeps relops scale-agnostic
                arg = _cast_ir(arg, DOUBLE)
            out_t = _agg_type(name, arg.type)
            aggs.append(AggCall(name, arg, out_t, fc.distinct))
        return aggs

    def _plan_grouping_sets(
        self,
        rel: RelationPlan,
        sel: A.Select,
        agg_calls: list[A.FuncCall],
        outer: Optional[Scope],
    ) -> tuple[RelationPlan, dict[A.Expr, FieldRef]]:
        """GROUPING SETS / ROLLUP / CUBE (reference: GroupIdNode feeding a
        single AggregationNode, sql/planner/QueryPlanner planGroupingSets).

        Lowering: per set, project [key exprs (NULL where the key is absent
        from the set), every child column, set-id literal]; Concat the
        copies; aggregate once on (keys..., gid).  The gid keeps a data NULL
        in a key distinct from a rollup NULL, so e.g. ROLLUP totals never
        merge with a NULL-keyed data group."""
        from ..plan.ir import remap
        from .nodes import Concat

        t = _Translator(rel.scope, outer)
        key_irs = [t.translate(g) for g in sel.group_by]
        aggs = self._build_agg_calls(agg_calls, t)
        K = len(key_irs)
        n_child = len(rel.fields)
        child_types = [f.type for f in rel.fields]

        # ---- re-aggregation fast path -----------------------------------
        # When every aggregate's state combines by re-applying a function
        # (sum/count -> sum of partials, min/max/bool_* idempotent) and the
        # FINEST level is one of the sets, compute that level ONCE from the
        # raw rows and roll coarser levels up from its (small) output —
        # instead of aggregating an N-copy expansion of the raw input.  An
        # 8-key ROLLUP (TPC-DS q67) goes from 9 scans of the join frame to
        # one, and the traced program shrinks to match.  (Reference: the
        # partial-aggregation economics of AddExchanges applied vertically.)
        _REAGG = {"sum": "sum", "count": "sum", "count_star": "sum",
                  "min": "min", "max": "max", "bool_and": "bool_and",
                  "bool_or": "bool_or"}
        sets = [frozenset(s) for s in sel.grouping_sets]
        full = frozenset(range(K))
        reaggable = (
            K > 0
            and len(sets) > 1
            and full in sets
            and all(
                a.fn in _REAGG and not a.distinct and not a.order_keys
                for a in aggs
            )
        )
        if reaggable:
            base_names = tuple(f"_k{i}" for i in range(K)) + tuple(
                f"_a{i}" for i in range(len(aggs))
            )
            base = Aggregate(rel.node, tuple(key_irs), tuple(aggs), base_names)
            out_names = tuple(f"_g{i}" for i in range(K + 1)) + tuple(
                f"_a{i}" for i in range(len(aggs))
            )
            copies = []
            for sid, s in enumerate(sel.grouping_sets):
                fs = frozenset(s)
                if fs == full:
                    exprs = [FieldRef(i, key_irs[i].type) for i in range(K)]
                    exprs.append(Const(sid, BIGINT))
                    exprs += [
                        FieldRef(K + j, a.type) for j, a in enumerate(aggs)
                    ]
                    copies.append(Project(base, tuple(exprs), out_names))
                    continue
                kept = sorted(fs)
                sub_keys = [FieldRef(i, key_irs[i].type) for i in kept]
                re_aggs = [
                    AggCall(_REAGG[a.fn], FieldRef(K + j, a.type), a.type)
                    for j, a in enumerate(aggs)
                ]
                sub_names = tuple(f"_k{i}" for i in kept) + tuple(
                    f"_a{j}" for j in range(len(aggs))
                )
                agg2 = Aggregate(base, tuple(sub_keys), tuple(re_aggs), sub_names)
                pos = {k: idx for idx, k in enumerate(kept)}
                exprs = [
                    (
                        FieldRef(pos[i], key_irs[i].type)
                        if i in fs
                        else Const(None, key_irs[i].type)
                    )
                    for i in range(K)
                ]
                exprs.append(Const(sid, BIGINT))
                exprs += [
                    FieldRef(len(kept) + j, a.type) for j, a in enumerate(aggs)
                ]
                copies.append(Project(agg2, tuple(exprs), out_names))
            node = Concat(tuple(copies))
            shifted = aggs
        else:
            copies = []
            for sid, s in enumerate(sel.grouping_sets):
                exprs = [
                    (key_irs[i] if i in s else Const(None, key_irs[i].type))
                    for i in range(K)
                ]
                exprs += [FieldRef(j, child_types[j]) for j in range(n_child)]
                exprs.append(Const(sid, BIGINT))
                names = tuple(
                    [f"_k{i}" for i in range(K)]
                    + [f"_c{j}" for j in range(n_child)]
                    + ["_gid"]
                )
                copies.append(Project(rel.node, tuple(exprs), names))
            concat = Concat(tuple(copies))

            # aggregate over the expanded frame: keys are precomputed
            # columns, agg args shift past the K key columns
            shift = {j: K + j for j in range(n_child)}
            group_irs = [FieldRef(i, key_irs[i].type) for i in range(K)] + [
                FieldRef(K + n_child, BIGINT)
            ]
            shifted = [
                AggCall(
                    a.fn,
                    None if a.arg is None else remap(a.arg, shift),
                    a.type,
                    a.distinct,
                    a.param,
                    None if a.arg2 is None else remap(a.arg2, shift),
                    a.sep,
                )
                for a in aggs
            ]
            names = tuple(f"_g{i}" for i in range(K + 1)) + tuple(
                f"_a{i}" for i in range(len(shifted))
            )
            node = Aggregate(concat, tuple(group_irs), tuple(shifted), names)

        fields: list[Field] = []
        for g_ast, g_ir in zip(sel.group_by, key_irs):
            if isinstance(g_ast, A.Ident):
                hit = rel.scope.try_resolve(g_ast.parts)
                f = rel.fields[hit[1]]
                fields.append(Field(f.qualifier, f.name, g_ir.type))
            else:
                fields.append(Field(None, None, g_ir.type))
        fields.append(Field(None, None, BIGINT))  # hidden gid
        for a in shifted:
            fields.append(Field(None, None, a.type))

        agg_map: dict[A.Expr, FieldRef] = {}
        for i, g_ast in enumerate(sel.group_by):
            agg_map[g_ast] = FieldRef(i, key_irs[i].type)
        base = K + 1
        for i, fc in enumerate(agg_calls):
            agg_map[fc] = FieldRef(base + i, shifted[i].type)

        # GROUPING(e...) -> bitmask constant per set, selected by gid
        # (reference: GroupingOperationRewriter): bit b (MSB = first arg) is
        # 1 when the arg is NOT grouped in the row's set
        def _walk(e):
            yield e
            for c in _ast_children(e):
                yield from _walk(c)

        scan = [it.expr for it in sel.items if isinstance(it, A.SelectItem)]
        if sel.having is not None:
            scan.append(sel.having)
        gid_ref = FieldRef(K, BIGINT)
        for e in scan:
            for x in _walk(e):
                if (
                    isinstance(x, A.FuncCall)
                    and x.name == "grouping"
                    and x not in agg_map
                ):
                    positions = []
                    for a in x.args:
                        if a not in sel.group_by:
                            raise PlanningError(
                                "grouping() arguments must be grouping keys"
                            )
                        positions.append(sel.group_by.index(a))
                    whens = []
                    for sid, s in enumerate(sel.grouping_sets):
                        mask = 0
                        for b, pos in enumerate(positions):
                            if pos not in s:
                                mask |= 1 << (len(positions) - 1 - b)
                        whens.append(
                            (
                                Call("eq", (gid_ref, Const(sid, BIGINT)), BOOLEAN),
                                Const(mask, BIGINT),
                            )
                        )
                    agg_map[x] = CaseWhen(tuple(whens), Const(0, BIGINT), BIGINT)
        return RelationPlan(node, fields), agg_map

    # --------------------------------------------------------------- windows
    def _collect_windows(self, sel: A.Select, order_by) -> list[A.WindowFunc]:
        found: list[A.WindowFunc] = []

        def visit(e: A.Expr):
            if isinstance(e, A.WindowFunc):
                if e not in found:
                    found.append(e)
                return
            for c in _ast_children(e):
                visit(c)

        for it in sel.items:
            if isinstance(it, A.SelectItem):
                visit(it.expr)
        for si in order_by:
            visit(si.expr)
        return found

    def _plan_windows(
        self,
        rel: RelationPlan,
        win_funcs: list[A.WindowFunc],
        translator: "_Translator",
        outer: Optional[Scope],
    ) -> tuple[RelationPlan, dict[A.Expr, FieldRef]]:
        from .nodes import Window, WindowCall

        # one Window node per distinct (partition_by, order_by) spec
        groups: dict[tuple, list[A.WindowFunc]] = {}
        for wf in win_funcs:
            key = (wf.partition_by, wf.order_by)
            groups.setdefault(key, []).append(wf)

        win_map: dict[A.Expr, FieldRef] = {}
        for (partition_by, w_order_by), funcs in groups.items():
            t = _Translator(
                rel.scope, outer, agg_map=translator.agg_map, grouped=translator.grouped
            )
            part_irs = tuple(t.translate(p) for p in partition_by)
            keys = tuple(
                SortKey(t.translate(si.expr), si.ascending, _nulls_first(si))
                for si in w_order_by
            )
            calls: list[WindowCall] = []
            base = len(rel.fields)
            for wf in funcs:
                frame = wf.frame
                if frame in ("rows_unbounded", "groups_unbounded"):
                    frame = "rows"
                elif frame == "range_unbounded":
                    frame = "range"
                elif frame is None:
                    frame = "range" if w_order_by else "whole"
                fn = wf.name
                args = tuple(t.translate(a) for a in wf.args)
                if fn in ("sum", "avg") and args and args[0].type.is_decimal:
                    # window accumulators run in f64 lanes; decimals enter as
                    # doubles (exact to 2^53 on the CPU; see ops/window.py)
                    args = (_cast_ir(args[0], DOUBLE),) + args[1:]
                if fn in ("lag", "lead") and len(args) > 2:
                    # the default must land in the value column's lanes (a
                    # decimal literal would otherwise inject raw scaled ints)
                    args = args[:2] + (_cast_ir(args[2], args[0].type),)
                if fn in ("row_number", "rank", "dense_rank", "ntile"):
                    out_t = BIGINT
                elif fn == "count":
                    out_t = BIGINT
                    if not args:
                        fn = "count_star"
                elif fn in ("avg", "percent_rank", "cume_dist"):
                    out_t = DOUBLE
                elif fn == "sum":
                    out_t = _agg_type("sum", args[0].type)
                elif fn in ("min", "max", "lag", "lead", "first_value",
                            "last_value", "nth_value"):
                    out_t = args[0].type
                else:
                    raise PlanningError(f"unknown window function: {fn}")
                if frame.startswith("rows:") and fn not in (
                    "sum", "avg", "count", "count_star", "min", "max"
                ):
                    raise PlanningError(
                        f"offset frame not supported for window function {fn}"
                    )
                if frame.startswith("range:") and len(w_order_by) != 1:
                    # Trino: "Window frame of type RANGE PRECEDING or
                    # FOLLOWING requires single sort item in ORDER BY"
                    # (PatternRecognitionAnalyzer-adjacent frame validation in
                    # StatementAnalyzer); bounds resolve against ONE key.
                    raise PlanningError(
                        "RANGE offset frame requires exactly one ORDER BY key"
                    )
                if fn == "ntile" and not (args and isinstance(args[0], Const)):
                    raise PlanningError("ntile() requires a literal bucket count")
                if fn == "nth_value":
                    if len(args) < 2 or not isinstance(args[1], Const):
                        raise PlanningError("nth_value() requires a literal n")
                if fn in ("lag", "lead") and len(args) > 1 and not isinstance(args[1], Const):
                    raise PlanningError(f"{fn}() offset must be a literal")
                calls.append(WindowCall(fn, args, out_t, frame))
            names = tuple(f"_w{base + i}" for i in range(len(calls)))
            node = Window(rel.node, part_irs, keys, tuple(calls), names)
            new_fields = rel.fields + [Field(None, None, c.type) for c in calls]
            for i, wf in enumerate(funcs):
                win_map[wf] = FieldRef(base + i, calls[i].type)
            rel = RelationPlan(node, new_fields)
        return rel, win_map

    # ------------------------------------------------------------- subqueries
    def _apply_boolean(
        self,
        rel: RelationPlan,
        cond: A.Expr,
        translator: "_Translator",
        outer: Optional[Scope],
        ctes: dict[str, A.Query],
    ) -> RelationPlan:
        """Apply a HAVING/filter condition that may contain subqueries."""
        for c in _split_conjuncts(cond):
            if _has_subquery(c):
                rel = self._apply_subquery_conjunct(rel, c, outer, ctes, translator)
            else:
                rel = RelationPlan(
                    Filter(rel.node, _as_bool(translator.translate(c))), rel.fields
                )
                translator = _Translator(rel.scope, outer, agg_map=translator.agg_map)
        return rel

    def _apply_subquery_conjunct(
        self,
        rel: RelationPlan,
        c: A.Expr,
        outer: Optional[Scope],
        ctes: dict[str, A.Query],
        translator: Optional["_Translator"] = None,
    ) -> RelationPlan:
        if translator is None:
            translator = _Translator(rel.scope, outer)
        # EXISTS / NOT EXISTS ------------------------------------------------
        neg = False
        e = c
        while isinstance(e, A.Not):
            neg = not neg
            e = e.operand
        if isinstance(e, A.Exists):
            negated = neg != e.negated
            return self._plan_exists(rel, e.query, negated, outer, ctes)
        if isinstance(e, A.InSubquery):
            negated = neg != e.negated
            return self._plan_in_subquery(rel, e, negated, outer, ctes, translator)
        if isinstance(e, A.BinOp) and e.op in _CMP_OPS and not neg:
            lh, rh = e.left, e.right
            if isinstance(rh, A.ScalarSubquery):
                return self._plan_scalar_cmp(rel, lh, _CMP_OPS[e.op], rh.query, outer, ctes, translator)
            if isinstance(lh, A.ScalarSubquery):
                return self._plan_scalar_cmp(
                    rel, rh, _CMP_FLIP[_CMP_OPS[e.op]], lh.query, outer, ctes, translator
                )
        # general boolean combinations (EXISTS / IN under OR, subqueries in
        # scalar positions): mark-join lowering, then an ordinary filter over
        # the substituted predicate
        base_fields = rel.fields
        rel2, sub_map = self._lower_subquery_exprs(rel, [c], outer, ctes, translator)
        merged = dict(translator.agg_map or {})
        merged.update(sub_map)
        t2 = _Translator(rel2.scope, outer, agg_map=merged, grouped=translator.grouped)
        pred = _as_bool(t2.translate(c))
        filtered = Filter(rel2.node, pred)
        proj_back = Project(
            filtered,
            tuple(FieldRef(i, f.type) for i, f in enumerate(base_fields)),
            tuple(f.name or f"_c{i}" for i, f in enumerate(base_fields)),
        )
        return RelationPlan(proj_back, base_fields)

    def _lower_subquery_exprs(
        self,
        rel: RelationPlan,
        exprs: Sequence[A.Expr],
        outer: Optional[Scope],
        ctes: dict[str, A.Query],
        translator: Optional["_Translator"] = None,
    ) -> tuple[RelationPlan, dict[A.Expr, IrExpr]]:
        """Rewrite subqueries in general expression positions into appended
        columns over `rel`: uncorrelated scalar subqueries become
        EnforceSingleRow cross joins, EXISTS / IN become mark joins producing
        a BOOLEAN column (reference: SemiJoinNode's semiJoinOutput symbol +
        EnforceSingleRowOperator).  Returns the widened relation and an
        AST -> IR substitution map; field indices of the original relation
        are unchanged (columns only append)."""
        from .nodes import EnforceSingleRow

        sub_map: dict[A.Expr, IrExpr] = {}
        found: list[A.Expr] = []

        def collect(e: A.Expr) -> None:
            if isinstance(e, (A.ScalarSubquery, A.Exists, A.InSubquery)):
                found.append(e)
                return  # do not descend into the subquery itself
            for ch in _ast_children(e):
                collect(ch)

        for e in exprs:
            collect(e)

        for node_ast in found:
            if node_ast in sub_map:
                continue
            outer_scope = Scope(rel.fields, outer)
            merged = dict(translator.agg_map or {}) if translator else {}
            merged.update(sub_map)
            grouped = translator.grouped if translator else False
            t = _Translator(
                Scope(rel.fields, outer), outer,
                agg_map=merged or None, grouped=grouped,
            )
            if isinstance(node_ast, A.ScalarSubquery):
                sub = self._plan_subquery_relation(node_ast.query, outer_scope, ctes)
                if len(sub.fields) != 1:
                    raise PlanningError("scalar subquery must select one expression")
                node = Join(
                    "cross", rel.node, EnforceSingleRow(sub.node), (), (), None
                )
                ref = FieldRef(len(rel.fields), sub.fields[0].type)
                rel = RelationPlan(
                    node, rel.fields + [Field(None, None, sub.fields[0].type)]
                )
                sub_map[node_ast] = ref
                continue
            if isinstance(node_ast, A.InSubquery):
                sub = self._plan_subquery_relation(node_ast.query, outer_scope, ctes)
                if len(sub.fields) != 1:
                    raise PlanningError("IN subquery must produce one column")
                lkey = t.translate(node_ast.operand)
                rkey = FieldRef(0, sub.fields[0].type)
                tt = common_super_type(lkey.type, rkey.type)
                node = Join(
                    "mark_in", rel.node, sub.node,
                    (_cast_ir(lkey, tt),), (_cast_ir(rkey, tt),), None,
                )
            else:  # EXISTS
                q = node_ast.query
                if isinstance(q.select, A.SetOp):
                    raise PlanningError("EXISTS over a set operation not supported")
                if q.select.group_by or self._collect_aggs(q.select, ()):
                    raise PlanningError("EXISTS with aggregation not supported")
                inner, correlated = self._split_correlated(q, outer_scope, ctes)
                lkeys, rkeys, res_ir = self._correlation_parts(
                    rel, inner, correlated, outer, outer_t=t
                )
                if not lkeys:
                    raise PlanningError("EXISTS subquery without equality correlation")
                node = Join(
                    "mark", rel.node, inner.node,
                    tuple(lkeys), tuple(rkeys), res_ir,
                )
            mark_ref = FieldRef(len(rel.fields), BOOLEAN)
            rel = RelationPlan(node, rel.fields + [Field(None, None, BOOLEAN)])
            sub_map[node_ast] = (
                Call("not", (mark_ref,), BOOLEAN)
                if getattr(node_ast, "negated", False)
                else mark_ref
            )
        return rel, sub_map

    def _split_correlated(
        self, q: A.Query, outer_scope: Scope, ctes: dict[str, A.Query]
    ) -> tuple[RelationPlan, list[A.Expr]]:
        """Plan the subquery FROM + local WHERE; return correlated conjuncts."""
        if isinstance(q.select, A.SetOp):
            raise PlanningError("correlated set-operation subqueries not supported")
        sel = q.select
        if q.ctes:
            ctes = dict(ctes)
            for name, cq in q.ctes:
                ctes[name] = cq
        # plan FROM without where first to get the inner scope
        inner = self._plan_from(sel.relations, None, outer_scope, ctes)
        local: list[A.Expr] = []
        correlated: list[A.Expr] = []
        if sel.where is not None:
            conjuncts: list[A.Expr] = []
            for c in _split_conjuncts(sel.where):
                # (corr-eq AND x) OR (corr-eq AND y) -> corr-eq AND (x OR y):
                # hoisting the shared correlation out of OR branches is what
                # makes TPC-DS q41's correlated count decorrelatable
                # (reference: ExtractCommonPredicatesExpressionRewriter)
                conjuncts.extend(_split_conjuncts(_extract_common_or_conjuncts(c)))
            for conj in conjuncts:
                if _is_local(conj, inner.scope):
                    local.append(conj)
                else:
                    correlated.append(conj)
        if local:
            # re-plan FROM with the local predicates so pushdown/join-keying happens
            where = _and_all(local)
            inner = self._plan_from(sel.relations, where, outer_scope, ctes)
        return inner, correlated

    def _plan_exists(
        self,
        rel: RelationPlan,
        q: A.Query,
        negated: bool,
        outer: Optional[Scope],
        ctes: dict[str, A.Query],
    ) -> RelationPlan:
        if isinstance(q.select, A.SetOp):
            raise PlanningError("EXISTS over a set operation not supported")
        if q.select.group_by or self._collect_aggs(q.select, ()):
            raise PlanningError("EXISTS with aggregation not supported")
        outer_scope = Scope(rel.fields, outer)
        inner, correlated = self._split_correlated(q, outer_scope, ctes)
        return self._semi_join(rel, inner, correlated, negated, outer, extra_pairs=[])

    def _plan_in_subquery(
        self,
        rel: RelationPlan,
        e: A.InSubquery,
        negated: bool,
        outer: Optional[Scope],
        ctes: dict[str, A.Query],
        translator: "_Translator",
    ) -> RelationPlan:
        q = e.query
        outer_scope = Scope(rel.fields, outer)
        sub = self._plan_subquery_relation(q, outer_scope, ctes)
        if len(sub.fields) != 1:
            raise PlanningError("IN subquery must produce one column")
        lkey = translator.translate(e.operand)
        rkey = FieldRef(0, sub.fields[0].type)
        tt = common_super_type(lkey.type, rkey.type)
        # NOT IN is three-valued: a NULL probe key or any NULL in the
        # subquery result yields NULL (row filtered), not TRUE — so the
        # negated lowering is the null-aware anti join, not plain anti
        # (reference: TransformCorrelatedInPredicateToJoin / SemiJoinNode).
        node = Join(
            "null_anti" if negated else "semi",
            rel.node,
            sub.node,
            (_cast_ir(lkey, tt),),
            (_cast_ir(rkey, tt),),
            None,
        )
        return RelationPlan(node, rel.fields)

    def _correlation_parts(
        self,
        rel: RelationPlan,
        inner: RelationPlan,
        correlated: list[A.Expr],
        outer: Optional[Scope],
        outer_t: Optional["_Translator"] = None,
    ) -> tuple[list[IrExpr], list[IrExpr], Optional[IrExpr]]:
        """Split correlated conjuncts into equi-join key pairs and a residual
        over the concatenated (outer ++ inner) schema — the decorrelation
        step shared by semi/anti joins and mark joins (reference:
        TransformCorrelatedExistsToJoin's correlation extraction)."""
        if outer_t is None:
            outer_t = _Translator(rel.scope, outer)
        inner_t = _Translator(inner.scope, Scope(rel.fields, outer))
        lkeys: list[IrExpr] = []
        rkeys: list[IrExpr] = []
        residual_ast: list[A.Expr] = []
        for conj in correlated:
            pair = _correlated_equi_pair(conj, rel.scope, inner.scope)
            if pair is not None:
                o_ast, i_ast = pair
                a = outer_t.translate(o_ast)
                b = inner_t.translate(i_ast)
                tt = common_super_type(a.type, b.type)
                lkeys.append(_cast_ir(a, tt))
                rkeys.append(_cast_ir(b, tt))
            else:
                residual_ast.append(conj)
        res_ir = None
        if residual_ast:
            concat_scope = Scope(rel.fields + inner.fields, outer)
            ct = _Translator(concat_scope, outer)
            res_ir = _conjoin([_as_bool(ct.translate(x)) for x in residual_ast])
        return lkeys, rkeys, res_ir

    def _semi_join(
        self,
        rel: RelationPlan,
        inner: RelationPlan,
        correlated: list[A.Expr],
        negated: bool,
        outer: Optional[Scope],
        extra_pairs: list[tuple[IrExpr, IrExpr]],
    ) -> RelationPlan:
        lkeys, rkeys, res_ir = self._correlation_parts(rel, inner, correlated, outer)
        lkeys = [p[0] for p in extra_pairs] + lkeys
        rkeys = [p[1] for p in extra_pairs] + rkeys
        if not lkeys:
            raise PlanningError("EXISTS subquery without equality correlation")
        node = Join(
            "anti" if negated else "semi",
            rel.node,
            inner.node,
            tuple(lkeys),
            tuple(rkeys),
            res_ir,
        )
        return RelationPlan(node, rel.fields)

    def _plan_scalar_cmp(
        self,
        rel: RelationPlan,
        operand_ast: A.Expr,
        cmp_op: str,
        q: A.Query,
        outer: Optional[Scope],
        ctes: dict[str, A.Query],
        translator: "_Translator",
    ) -> RelationPlan:
        if isinstance(q.select, A.SetOp):
            raise PlanningError("scalar subquery over a set operation not supported")
        sel = q.select
        outer_scope = Scope(rel.fields, outer)
        inner, correlated = self._split_correlated(q, outer_scope, ctes)
        agg_calls = self._collect_aggs(sel, ())
        if not agg_calls or sel.group_by:
            if correlated:
                raise PlanningError(
                    "correlated scalar subquery must be a single ungrouped aggregate"
                )
            # uncorrelated arbitrary scalar subquery (SELECT DISTINCT x ...,
            # grouped selects, ...): plan the whole query and broadcast its
            # single row through a cross join (reference:
            # EnforceSingleRowOperator; TPC-DS q06's d_month_seq lookup)
            sub = self._plan_subquery_relation(q, outer_scope, ctes)
            if len(sub.fields) != 1:
                raise PlanningError("scalar subquery must select one expression")
            from .nodes import EnforceSingleRow

            node = Join("cross", rel.node, EnforceSingleRow(sub.node), (), (), None)
            new_fields = rel.fields + [Field(None, None, sub.fields[0].type)]
            joined = RelationPlan(node, new_fields)
            op_t = _Translator(joined.scope, outer, agg_map=translator.agg_map)
            lhs = op_t.translate(operand_ast)
            rhs = FieldRef(len(new_fields) - 1, sub.fields[0].type)
            pred = _cmp(cmp_op, lhs, rhs)
            filtered = Filter(joined.node, pred)
            proj_back = Project(
                filtered,
                tuple(FieldRef(i, rel.fields[i].type) for i in range(len(rel.fields))),
                tuple(f.name or f"_c{i}" for i, f in enumerate(rel.fields)),
            )
            return RelationPlan(proj_back, rel.fields)

        # correlation equalities -> inner group keys
        outer_t = _Translator(rel.scope, outer)
        inner_t = _Translator(inner.scope, outer_scope)
        outer_keys: list[IrExpr] = []
        inner_keys: list[IrExpr] = []
        for conj in correlated:
            pair = _correlated_equi_pair(conj, rel.scope, inner.scope)
            if pair is None:
                raise PlanningError(f"non-equality correlation in scalar subquery: {conj}")
            o_ast, i_ast = pair
            a = outer_t.translate(o_ast)
            b = inner_t.translate(i_ast)
            tt = common_super_type(a.type, b.type)
            outer_keys.append(_cast_ir(a, tt))
            inner_keys.append(_cast_ir(b, tt))

        aggs: list[AggCall] = []
        for fc in agg_calls:
            if fc.name == "count" and not fc.args:
                aggs.append(AggCall("count_star", None, BIGINT))
            else:
                arg = inner_t.translate(fc.args[0])
                if fc.name == "avg" and arg.type.is_decimal:
                    arg = _cast_ir(arg, DOUBLE)
                aggs.append(AggCall(fc.name, arg, _agg_type(fc.name, arg.type), fc.distinct))
        nk = len(inner_keys)
        agg_names = tuple(f"_g{i}" for i in range(nk)) + tuple(
            f"_a{i}" for i in range(len(aggs))
        )
        agg_node = Aggregate(inner.node, tuple(inner_keys), tuple(aggs), agg_names)

        # rewrite the subquery's single select expression over the agg output
        agg_map: dict[A.Expr, FieldRef] = {}
        for i, fc in enumerate(agg_calls):
            agg_map[fc] = FieldRef(nk + i, aggs[i].type)
        items = [it for it in sel.items if isinstance(it, A.SelectItem)]
        if len(items) != 1:
            raise PlanningError("scalar subquery must select one expression")
        sub_t = _Translator(
            Scope([Field(None, None, t) for t in agg_node.output_types]),
            outer,
            agg_map=agg_map,
        )
        value_ir = sub_t.translate(items[0].expr)
        proj_exprs = tuple(FieldRef(i, inner_keys[i].type) for i in range(nk)) + (value_ir,)
        proj = Project(agg_node, proj_exprs, tuple(f"_k{i}" for i in range(nk)) + ("_v",))

        if nk == 0:
            # uncorrelated: single-row cross join then filter
            node = Join("cross", rel.node, proj, (), (), None)
        else:
            node = Join(
                "inner",
                rel.node,
                proj,
                tuple(outer_keys),
                tuple(FieldRef(i, inner_keys[i].type) for i in range(nk)),
                None,
            )
        new_fields = rel.fields + [Field(None, None, e.type) for e in proj_exprs]
        joined = RelationPlan(node, new_fields)
        # the comparison: operand <op> value  (value is the last field)
        op_t = _Translator(joined.scope, outer, agg_map=translator.agg_map)
        lhs = op_t.translate(operand_ast)
        rhs = FieldRef(len(new_fields) - 1, value_ir.type)
        pred = _cmp(cmp_op, lhs, rhs)  # decimal-overflow-aware comparison
        filtered = Filter(joined.node, pred)
        # project away the scratch columns
        keep = list(range(len(rel.fields)))
        proj_back = Project(
            filtered,
            tuple(FieldRef(i, rel.fields[i].type) for i in keep),
            tuple(f.name or f"_c{i}" for i, f in enumerate(rel.fields)),
        )
        return RelationPlan(proj_back, rel.fields)


# ============================================================== translation


class _Translator:
    """AST expression -> typed IR over a scope (reference:
    sql/analyzer/ExpressionAnalyzer.java + sql/planner/TranslationMap)."""

    def __init__(
        self,
        scope: Scope,
        outer: Optional[Scope] = None,
        agg_map: Optional[dict[A.Expr, FieldRef]] = None,
        grouped: Optional[bool] = None,
    ):
        self.scope = scope
        self.outer = outer
        self.agg_map = agg_map
        # grouped: bare columns must resolve through the agg_map (GROUP BY
        # context).  A window substitution map alone does not imply grouping.
        self.grouped = grouped if grouped is not None else (agg_map is not None)
        # MATCH_RECOGNIZE DEFINE context: pattern navigation (PREV/NEXT)
        # resolves as Call nodes that _plan_match_recognize lowers into
        # partition-aware shifted columns (reference: pattern navigation in
        # sql/analyzer/PatternRecognitionAnalyzer.java)
        self.pattern_nav = False

    def translate(self, e: A.Expr) -> IrExpr:
        if self.agg_map is not None and e in self.agg_map:
            return self.agg_map[e]
        if isinstance(e, A.Ident):
            hit = self.scope.try_resolve(e.parts)
            if hit is None and len(e.parts) >= 2:
                # dereference: the prefix may resolve to a ROW-typed column
                # and the last part to one of its fields (reference:
                # DereferenceExpression -> RowBlock field access)
                base = self.scope.try_resolve(e.parts[:-1])
                if base is not None:
                    depth, idx, bt = base
                    if depth == 0 and bt.is_row:
                        fi = bt.field_index(e.parts[-1])
                        ftype = bt.fields[fi][1]
                        return Call(
                            "row_field",
                            (FieldRef(idx, bt), Const(fi, BIGINT)),
                            ftype,
                        )
            if hit is None:
                raise PlanningError(f"column not found: {e}")
            depth, idx, t = hit
            if depth != 0:
                raise PlanningError(f"unexpected correlated reference: {e}")
            if self.grouped:
                raise PlanningError(f"column {e} must appear in GROUP BY")
            return FieldRef(idx, t)
        if isinstance(e, A.Parameter):
            slots = _PARAM_BINDINGS.slots
            if slots is None or e.index >= len(slots):
                raise PlanningError(f"parameter ${e.index} has no binding")
            mode, typ, value = slots[e.index]
            if mode == "bind":
                return Param(e.index, typ)
            return Const(value, typ)
        if isinstance(e, A.IntLit):
            return Const(e.value, BIGINT)
        if isinstance(e, A.FloatLit):
            return Const(e.value, DOUBLE)
        if isinstance(e, A.DecimalLit):
            p = max(len(str(abs(e.unscaled))), e.scale)
            return Const(e.unscaled, DecimalType(p, e.scale))
        if isinstance(e, A.StrLit):
            return Const(e.value, VARCHAR)
        if isinstance(e, A.BoolLit):
            return Const(e.value, BOOLEAN)
        if isinstance(e, A.NullLit):
            return Const(None, UNKNOWN)
        if isinstance(e, A.DateLit):
            return Const(date_to_days(e.value), DATE)
        if isinstance(e, A.Neg):
            a = self.translate(e.operand)
            if isinstance(a, Const) and a.value is not None:
                return Const(-a.value, a.type)
            return Call("neg", (a,), a.type)
        if isinstance(e, A.Not):
            return Call("not", (_as_bool(self.translate(e.operand)),), BOOLEAN)
        if isinstance(e, A.BinOp):
            return self._binop(e)
        if isinstance(e, A.FuncCall):
            return self._func(e)
        if isinstance(e, A.CaseExpr):
            whens = []
            rtypes = []
            for cnd, res in e.whens:
                ci = _as_bool(self.translate(cnd))
                ri = self.translate(res)
                whens.append((ci, ri))
                rtypes.append(ri.type)
            dflt = None if e.default is None else self.translate(e.default)
            if dflt is not None:
                rtypes.append(dflt.type)
            out_t = rtypes[0]
            for t in rtypes[1:]:
                out_t = common_super_type(out_t, t)
            whens = tuple((c, _cast_ir(r, out_t)) for c, r in whens)
            dflt = None if dflt is None else _cast_ir(dflt, out_t)
            return CaseWhen(whens, dflt, out_t)
        if isinstance(e, A.Cast):
            from ..data.types import parse_type

            target = parse_type(e.type_name)
            operand = self.translate(e.operand)
            if e.try_ and operand.type == VARCHAR and target != VARCHAR:
                # TRY_CAST from varchar: parse failures are NULL, not errors
                # (reference: scalar/TryCastFunction); non-string casts in
                # this engine cannot fail, so they lower to a plain cast
                if isinstance(operand, Const):
                    try:
                        return _cast_ir(operand, target)
                    except Exception:
                        return Const(None, target)
                return Call("try_cast", (operand,), target)
            return _cast_ir(operand, target)
        if isinstance(e, A.Between):
            a = self.translate(e.operand)
            lo = self.translate(e.low)
            hi = self.translate(e.high)
            ge = _cmp("ge", a, lo)
            le = _cmp("le", a, hi)
            both = Call("and", (ge, le), BOOLEAN)
            return Call("not", (both,), BOOLEAN) if e.negated else both
        if isinstance(e, A.InList):
            a = self.translate(e.operand)
            vals = []
            for it in e.items:
                v = self.translate(it)
                if not isinstance(v, Const):
                    raise PlanningError("IN list items must be literals")
                vals.append(v.value)
            return InListIr(a, tuple(vals), e.negated)
        if isinstance(e, A.Like):
            a = self.translate(e.operand)
            p = self.translate(e.pattern)
            if not isinstance(p, Const) or not isinstance(p.value, str):
                raise PlanningError("LIKE pattern must be a string literal")
            if a.type != VARCHAR:
                raise PlanningError("LIKE requires a varchar operand")
            return LikeIr(a, p.value, e.negated)
        if isinstance(e, A.IsNull):
            a = self.translate(e.operand)
            isn = Call("is_null", (a,), BOOLEAN)
            return Call("not", (isn,), BOOLEAN) if e.negated else isn
        if isinstance(e, A.Extract):
            a = self.translate(e.operand)
            if e.field not in ("year", "month", "day"):
                raise PlanningError(f"EXTRACT({e.field}) not supported")
            return Call(f"extract_{e.field}", (a,), BIGINT)
        if isinstance(e, (A.ScalarSubquery, A.InSubquery, A.Exists)):
            raise PlanningError(
                "subquery in unsupported position (only WHERE/HAVING conjuncts)"
            )
        raise PlanningError(f"cannot translate expression: {e}")

    def _binop(self, e: A.BinOp) -> IrExpr:
        if e.op in ("and", "or"):
            return Call(
                e.op,
                (_as_bool(self.translate(e.left)), _as_bool(self.translate(e.right))),
                BOOLEAN,
            )
        a = self.translate(e.left)
        b = self.translate(e.right)
        if e.op in _CMP_OPS:
            return _cmp(_CMP_OPS[e.op], a, b)
        # arithmetic
        op = {"+": "add", "-": "sub", "*": "mul", "/": "div", "%": "mod"}[e.op]
        a = _tighten_int_const(a, b.type)
        b = _tighten_int_const(b, a.type)
        dec_mix = (a.type.is_decimal or b.type.is_decimal) and not (
            a.type.is_floating or b.type.is_floating
        )
        if dec_mix and op == "mul":
            # decimal multiply: scales add on the raw int64 lanes — no
            # operand rescaling (reference: decimal operator typing)
            ta = a.type if a.type.is_decimal else DecimalType(18, 0)
            tb = b.type if b.type.is_decimal else DecimalType(18, 0)
            out_t = DecimalType(min(38, ta.precision + tb.precision), ta.scale + tb.scale)
            if isinstance(a, Const) and isinstance(b, Const) and a.value is not None and b.value is not None:
                return Const(a.value * b.value, out_t)
            return Call("mul", (a, b), out_t)
        if dec_mix and op == "div":
            # decimal division degrades to DOUBLE (Int128 rescale division is
            # future work; TPC-H divisions all feed double expressions)
            a = _cast_ir(a, DOUBLE)
            b = _cast_ir(b, DOUBLE)
            out_t = DOUBLE
            if isinstance(a, Const) and isinstance(b, Const) and a.value is not None and b.value is not None:
                return Const(_fold_arith(op, a.value, b.value), out_t)
            return Call(op, (a, b), out_t)
        out_t = common_super_type(a.type, b.type)
        # constant folding keeps literals out of kernels where possible
        a = _cast_ir(a, out_t)
        b = _cast_ir(b, out_t)
        if isinstance(a, Const) and isinstance(b, Const) and a.value is not None and b.value is not None:
            return Const(_fold_arith(op, a.value, b.value, out_t), out_t)
        return Call(op, (a, b), out_t)

    _HOF_FNS = {
        "transform", "filter", "reduce", "any_match", "all_match",
        "none_match", "zip_with", "transform_keys", "transform_values",
        "map_filter",
    }

    def _lambda_body(self, lam, param_types) -> IrExpr:
        """Translate a lambda body with its parameters bound to LambdaVarIr
        (reference: ExpressionAnalyzer lambda scopes).  Enclosing-row column
        captures are rejected — HOFs evaluate per distinct dictionary value
        on the host, where row context does not exist."""
        from .ir import LambdaVarIr, field_refs

        if not isinstance(lam, A.Lambda):
            raise PlanningError("expected a lambda argument (x -> expression)")
        if len(lam.params) != len(param_types):
            raise PlanningError(
                f"lambda takes {len(lam.params)} parameters, expected {len(param_types)}"
            )
        sub = _LambdaTranslator(self, dict(zip(lam.params, param_types)))
        body = sub.translate(lam.body)
        if field_refs(body):
            raise PlanningError(
                "lambda capture of enclosing columns is not supported"
            )
        if body.type.is_decimal:
            # the host interpreter evaluates decimals as plain floats
            body = _cast_ir(body, DOUBLE)
        return body

    def _hof(self, e: A.FuncCall) -> IrExpr:
        """Higher-order array/map functions (reference: sql/gen/
        LambdaBytecodeGenerator + operator/scalar/ArrayTransformFunction,
        ArrayFilterFunction, ArrayReduceFunction, ZipWithFunction,
        MapTransformValuesFunction...)."""
        from ..data.types import ArrayType, MapType
        from .ir import LambdaIr

        name = e.name
        _arity = {
            "transform": 2, "filter": 2, "any_match": 2, "all_match": 2,
            "none_match": 2, "reduce": 4, "zip_with": 3, "transform_keys": 2,
            "transform_values": 2, "map_filter": 2,
        }
        if len(e.args) != _arity[name]:
            raise PlanningError(
                f"{name} takes {_arity[name]} arguments, got {len(e.args)}"
            )
        if name in ("transform", "filter", "any_match", "all_match", "none_match"):
            arr = self.translate(e.args[0])
            if not arr.type.is_array:
                raise PlanningError(f"{name} requires an array argument")
            body = self._lambda_body(e.args[1], [arr.type.element])
            lam = LambdaIr(e.args[1].params, body, body.type)
            if name == "transform":
                return Call("transform", (arr, lam), ArrayType(body.type))
            if name == "filter":
                return Call("filter_arr", (arr, lam), arr.type)
            return Call(name, (arr, lam), BOOLEAN)
        if name == "reduce":
            arr = self.translate(e.args[0])
            if not arr.type.is_array:
                raise PlanningError("reduce requires an array argument")
            init = self.translate(e.args[1])
            comb_body = self._lambda_body(
                e.args[2], [init.type, arr.type.element]
            )
            finish_body = self._lambda_body(e.args[3], [init.type])
            comb = LambdaIr(e.args[2].params, comb_body, comb_body.type)
            fin = LambdaIr(e.args[3].params, finish_body, finish_body.type)
            return Call("reduce", (arr, init, comb, fin), finish_body.type)
        if name == "zip_with":
            a = self.translate(e.args[0])
            b = self.translate(e.args[1])
            if not (a.type.is_array and b.type.is_array):
                raise PlanningError("zip_with requires two array arguments")
            body = self._lambda_body(
                e.args[2], [a.type.element, b.type.element]
            )
            lam = LambdaIr(e.args[2].params, body, body.type)
            return Call("zip_with", (a, b, lam), ArrayType(body.type))
        # map HOFs
        m = self.translate(e.args[0])
        if not m.type.is_map:
            raise PlanningError(f"{name} requires a map argument")
        body = self._lambda_body(e.args[1], [m.type.key, m.type.value])
        lam = LambdaIr(e.args[1].params, body, body.type)
        if name == "transform_keys":
            return Call("transform_keys", (m, lam), MapType(body.type, m.type.value))
        if name == "transform_values":
            return Call("transform_values", (m, lam), MapType(m.type.key, body.type))
        return Call("map_filter", (m, lam), m.type)

    def _func(self, e: A.FuncCall) -> IrExpr:
        name = e.name
        if e.order_by:
            # only collection aggregates take ORDER BY (checked there);
            # silently dropping it on a scalar call would mask user mistakes
            raise PlanningError(f"ORDER BY not allowed in a call to {name}")
        if name in ("prev", "next"):
            if not self.pattern_nav:
                raise PlanningError(
                    f"{name.upper()}() is only allowed in MATCH_RECOGNIZE DEFINE"
                )
            args = tuple(self.translate(a) for a in e.args)
            if not 1 <= len(args) <= 2:
                raise PlanningError(f"{name.upper()} takes 1 or 2 arguments")
            return Call(name, args, args[0].type)
        if name in _AGG_FNS:
            raise PlanningError(f"aggregate {name} in non-aggregate context")
        if name in self._HOF_FNS:
            return self._hof(e)
        args = tuple(self.translate(a) for a in e.args)
        if name == "date_add":
            base, n, unit = args
            assert isinstance(n, Const) and isinstance(unit, Const)
            if isinstance(base, Const) and base.type == DATE:
                return Const(_date_add_const(base.value, n.value, unit.value), DATE)
            if unit.value == "day":
                return Call("add_days", (base, n), DATE)
            raise PlanningError("month/year interval arithmetic requires a literal date")
        if name == "substring" or name == "substr":
            if args[0].type != VARCHAR:
                raise PlanningError("substring requires varchar")
            return Call("substring", args, VARCHAR)
        if name == "coalesce":
            out_t = args[0].type
            for a in args[1:]:
                out_t = common_super_type(out_t, a.type)
            return Call("coalesce", tuple(_cast_ir(a, out_t) for a in args), out_t)
        if name in ("abs", "round", "floor", "ceil", "ceiling", "sqrt"):
            op = "ceil" if name == "ceiling" else name
            if name == "abs":
                return Call("abs", args, args[0].type)
            # float functions: decimals go in as doubles (the runtime kernels
            # are f64 lanes; Trino's decimal round/floor is future work)
            args = tuple(
                _cast_ir(a, DOUBLE) if a.type.is_decimal else a for a in args
            )
            if name == "round" and len(args) == 2:
                return Call("round", args, args[0].type)
            return Call(op, args, DOUBLE)
        if name == "power" or name == "pow":
            args = tuple(
                _cast_ir(a, DOUBLE) if a.type.is_decimal else a for a in args
            )
            return Call("power", args, DOUBLE)
        if name in ("year", "month", "day", "quarter", "week",
                    "day_of_week", "dow", "day_of_year", "doy"):
            op = {
                "year": "extract_year", "month": "extract_month",
                "day": "extract_day", "quarter": "extract_quarter",
                "week": "extract_week", "day_of_week": "extract_dow",
                "dow": "extract_dow", "day_of_year": "extract_doy",
                "doy": "extract_doy",
            }[name]
            return Call(op, args, BIGINT)
        if name == "length":
            if args[0].type != VARCHAR:
                raise PlanningError("length requires varchar")
            return Call("length", args, BIGINT)

        # ---- float math ---------------------------------------------------
        if name in ("ln", "log2", "log10", "exp", "sin", "cos", "tan", "asin",
                    "acos", "atan", "cbrt", "degrees", "radians", "truncate"):
            args = tuple(
                _cast_ir(a, DOUBLE) if a.type.is_decimal else a for a in args
            )
            if (
                name == "truncate"
                and len(args) == 1
                and isinstance(args[0], Const)
                and args[0].value is not None
            ):
                import math as _math

                return Const(float(_math.trunc(args[0].value)), DOUBLE)
            return Call(name, args, DOUBLE)
        if name == "atan2":
            return Call("atan2", args, DOUBLE)
        if name == "mod":
            out_t = common_super_type(args[0].type, args[1].type)
            return Call("mod", tuple(_cast_ir(a, out_t) for a in args), out_t)
        if name == "sign":
            if args[0].type.is_floating:
                return Call("sign", args, DOUBLE)
            # decimal lanes carry scaled ints: the raw sign is already right
            return Call("sign", args, BIGINT)
        if name == "pi":
            import math as _math

            return Const(_math.pi, DOUBLE)
        if name in ("now", "current_timestamp", "localtimestamp"):
            # per-query constant, folded at plan time (Trino semantics: one
            # now() per query, not per row) — microseconds since epoch on
            # TIMESTAMP int64 lanes (data/types.py).  Because it folds to a
            # fresh Const every planning, the plan hash changes per query
            # and the result cache additionally bypasses on the AST
            # (runtime/resultcache.py has_nondeterministic)
            import time as _time

            from ..data.types import TIMESTAMP

            if e.args:
                raise PlanningError(f"{name} takes no arguments")
            return Const(int(_time.time() * 1e6), TIMESTAMP)
        if name in ("random", "rand"):
            # plan-time constant per query — a deviation from Trino's
            # per-row random(), acceptable on traced lanes where runtime
            # RNG state can't live in the plan; still non-deterministic
            # ACROSS queries, which is what the cache bypass keys on
            import random as _random

            if e.args:
                raise PlanningError(f"{name} takes no arguments")
            return Const(_random.random(), DOUBLE)
        if name in ("bitwise_and", "bitwise_or", "bitwise_xor",
                    "bitwise_left_shift", "bitwise_right_shift"):
            op = {
                "bitwise_and": "bitwise_and", "bitwise_or": "bitwise_or",
                "bitwise_xor": "bitwise_xor",
                "bitwise_left_shift": "shift_left",
                "bitwise_right_shift": "shift_right",
            }[name]
            return Call(op, args, BIGINT)

        # ---- conditional --------------------------------------------------
        if name == "nullif":
            return Call("nullif", args, args[0].type)
        if name == "if":
            whens = ((_as_bool(args[0]), args[1]),)
            default = args[2] if len(args) > 2 else Const(None, args[1].type)
            return CaseWhen(whens, default, args[1].type)
        if name in ("greatest", "least"):
            out_t = args[0].type
            for a in args[1:]:
                out_t = common_super_type(out_t, a.type)
            return Call(name, tuple(_cast_ir(a, out_t) for a in args), out_t)

        # ---- date ---------------------------------------------------------
        if name == "date_trunc":
            # ('unit', date) in Trino argument order
            unit, d = args[0], args[1]
            assert isinstance(unit, Const), "date_trunc unit must be a literal"
            return Call("date_trunc", (d, unit), DATE)
        if name == "date_diff":
            unit, a, b = args
            assert isinstance(unit, Const) and unit.value == "day", (
                "date_diff supports 'day'"
            )
            return Call("date_diff_days", (a, b), BIGINT)
        if name == "last_day_of_month":
            return Call("last_day_of_month", args, DATE)

        # ---- strings ------------------------------------------------------
        if name in ("upper", "lower", "trim", "ltrim", "rtrim"):
            return Call(name, args, VARCHAR)
        if name == "reverse":
            return Call("reverse_str", args, VARCHAR)
        if name in ("replace", "lpad", "rpad", "split_part", "regexp_replace",
                    "regexp_extract"):
            return Call(name, args, VARCHAR)
        if name == "concat":
            coerced = []
            for a in args:
                if a.type == VARCHAR:
                    coerced.append(a)
                elif isinstance(a, Const) and a.value is not None:
                    coerced.append(Const(str(a.value), VARCHAR))
                else:
                    # dictionary-coded lanes can't synthesize strings from
                    # traced numeric data on device
                    raise PlanningError(
                        "|| / concat requires varchar operands "
                        f"(got {a.type.name}); cast on the client side"
                    )
            return Call("concat_str", tuple(coerced), VARCHAR)
        if name == "strpos" or name == "position":
            return Call("strpos", args, BIGINT)
        if name == "starts_with":
            return Call("starts_with", args, BOOLEAN)
        if name == "regexp_like":
            return Call("regexp_like", args, BOOLEAN)

        # ---- json (over varchar lanes) -------------------------------------
        if name in ("json_extract_scalar", "json_extract"):
            if args[0].type != VARCHAR:
                raise PlanningError(f"{name} requires varchar json input")
            return Call(name, args, VARCHAR)
        if name in ("json_array_length", "json_size"):
            if args[0].type != VARCHAR:
                raise PlanningError(f"{name} requires varchar json input")
            return Call(name, args, BIGINT)

        # ---- arrays (data/types.py ArrayType: dict-coded distinct tuples) --
        from ..data.types import ArrayType

        if name == "array_constructor":
            if not args:
                return Const((), ArrayType(UNKNOWN))
            el_t = args[0].type
            for a in args[1:]:
                el_t = common_super_type(el_t, a.type)
            vals = []
            for a in args:
                a = _cast_ir(a, el_t)
                if not isinstance(a, Const):
                    raise PlanningError(
                        "ARRAY[...] elements must be literals (runtime array "
                        "construction is not supported on dict-coded lanes)"
                    )
                vals.append(a.value)
            return Const(tuple(vals), ArrayType(el_t))
        if name == "sequence":
            if not all(isinstance(a, Const) for a in args):
                raise PlanningError("sequence() bounds must be literals")
            start, stop = int(args[0].value), int(args[1].value)
            step = int(args[2].value) if len(args) > 2 else (1 if stop >= start else -1)
            if step == 0:
                raise PlanningError("sequence() step must not be zero")
            rng = range(start, stop + (1 if step > 0 else -1), step)
            if len(rng) > 1_000_000:  # O(1) length check BEFORE materializing
                raise PlanningError("sequence() longer than 1000000")
            return Const(tuple(rng), ArrayType(BIGINT))
        if name == "split":
            if args[0].type != VARCHAR:
                raise PlanningError("split requires varchar")
            return Call("split", args, ArrayType(VARCHAR))
        if name == "cardinality":
            if not (args[0].type.is_array or args[0].type.is_map):
                raise PlanningError("cardinality requires an array or map")
            return Call("cardinality", args, BIGINT)
        if name == "element_at":
            if args[0].type.is_map:
                if not isinstance(args[1], Const):
                    raise PlanningError("map subscript key must be a literal")
                return Call("map_element_at", args, args[0].type.value)
            if not args[0].type.is_array:
                raise PlanningError("element_at requires an array or map")
            return Call("element_at", args, args[0].type.element)
        if name == "map":
            from ..data.types import MapType

            if len(args) != 2 or not (args[0].type.is_array and args[1].type.is_array):
                raise PlanningError("map() takes two array arguments")
            return Call(
                "map_construct", args,
                MapType(args[0].type.element, args[1].type.element),
            )
        if name == "map_keys":
            if not args[0].type.is_map:
                raise PlanningError("map_keys requires a map")
            return Call("map_keys", args, ArrayType(args[0].type.key))
        if name == "map_values":
            if not args[0].type.is_map:
                raise PlanningError("map_values requires a map")
            return Call("map_values", args, ArrayType(args[0].type.value))
        if name == "contains":
            if not args[0].type.is_array:
                raise PlanningError("contains requires an array")
            return Call("contains", args, BOOLEAN)
        if name == "array_position":
            if not args[0].type.is_array:
                raise PlanningError("array_position requires an array")
            if not isinstance(args[1], Const):
                raise PlanningError("array_position needle must be a literal")
            return Call("array_position", args, BIGINT)
        if name in ("array_distinct", "array_sort"):
            if not args[0].type.is_array:
                raise PlanningError(f"{name} requires an array")
            return Call(name, args, args[0].type)
        if name == "array_join":
            if not args[0].type.is_array:
                raise PlanningError("array_join requires an array")
            return Call("array_join", args, VARCHAR)
        if name in ("array_min", "array_max"):
            if not args[0].type.is_array:
                raise PlanningError(f"{name} requires an array")
            return Call(name, args, args[0].type.element)
        raise PlanningError(f"unknown function: {name}")


# ------------------------------------------------------------------ helpers


def _tighten_int_const(e: IrExpr, other: Type) -> IrExpr:
    """An integer literal next to a decimal gets its actual digit count as
    precision (1 -> decimal(1,0)), not the worst-case decimal(18,0) — the
    reference's analyzer does the same so small literals don't force
    everything to DOUBLE."""
    if (
        other.is_decimal
        and isinstance(e, Const)
        and e.type.is_integer
        and e.value is not None
    ):
        return Const(e.value, DecimalType(max(1, len(str(abs(e.value)))), 0))
    return e


def _cmp(op: str, a: IrExpr, b: IrExpr) -> IrExpr:
    a = _tighten_int_const(a, b.type)
    b = _tighten_int_const(b, a.type)
    tt = common_super_type(a.type, b.type)
    if tt.is_decimal:
        # a RESCALED operand must stay inside int64 lanes (whole digits +
        # common scale <= 18) — else compare as doubles.  Operands already
        # at the common scale never rescale: decimal128 lanes compare
        # exactly via the two-limb path (ops/expr.py _limbed_op)
        for t in (a.type, b.type):
            whole = (t.precision - t.scale) if t.is_decimal else 18
            scale = t.scale if t.is_decimal else 0
            if scale != tt.scale and whole + tt.scale > 18:
                tt = DOUBLE
                break
    return Call(op, (_cast_ir(a, tt), _cast_ir(b, tt)), BOOLEAN)


def _cast_ir(e: IrExpr, target: Type) -> IrExpr:
    if e.type == target:
        return e
    if isinstance(e, Const):
        return Const(_cast_const(e.value, target, e.type), target)
    return Call("cast", (e,), target)


def _round_half(v: int, div: int) -> int:
    """Round-half-away-from-zero integer division (Trino decimal rescale)."""
    sign = -1 if v < 0 else 1
    return sign * ((abs(v) + div // 2) // div)


def _cast_const(v, target: Type, source: Type = UNKNOWN):
    if v is None:
        return None
    if target.is_decimal:
        src_scale = source.scale if source.is_decimal else 0
        if source.is_floating or isinstance(v, float):
            return round(float(v) * 10**target.scale)
        if target.scale >= src_scale:
            return int(v) * 10 ** (target.scale - src_scale)
        return _round_half(int(v), 10 ** (src_scale - target.scale))
    if source.is_decimal:
        if target.is_floating:
            return int(v) / 10**source.scale
        if target.is_integer:
            return _round_half(int(v), 10**source.scale)
    if target.is_floating:
        return float(v)
    if target.is_integer:
        return int(v)
    if target == DATE and isinstance(v, str):
        return date_to_days(v.strip())
    if target == BOOLEAN and isinstance(v, str):
        return {"true": True, "false": False}[v.strip().lower()]
    if target == VARCHAR and not isinstance(v, str):
        return str(v)
    return v


class NumericValueOutOfRange(OverflowError):
    """An integer constant expression whose result leaves its type's range
    (Trino's NUMERIC_VALUE_OUT_OF_RANGE, e.g. "bigint addition overflow:
    9223372036854775807 + 1")."""

    error_code = "NUMERIC_VALUE_OUT_OF_RANGE"


_OP_WORDS = {
    "add": ("addition", "+"), "sub": ("subtraction", "-"),
    "mul": ("multiplication", "*"), "div": ("division", "/"), "mod": ("modulus", "%"),
}


def _fold_arith(op: str, a, b, out_t: Type = UNKNOWN):
    """`a op b` over two constants.  Integer division and modulus truncate
    toward zero in exact integer arithmetic (the sign of the dividend for
    the modulus), as the column path and Trino do.  An integer result
    outside `out_t`'s range raises NumericValueOutOfRange."""
    if op == "add":
        out = a + b
    elif op == "sub":
        out = a - b
    elif op == "mul":
        out = a * b
    elif isinstance(a, float) or isinstance(b, float):
        if b == 0:
            raise ZeroDivisionError(f"float {_OP_WORDS[op][0]} by zero")
        return a / b if op == "div" else math.fmod(a, b)
    elif op == "div":
        q = abs(a) // abs(b)
        out = -q if (a < 0) != (b < 0) else q
    elif op == "mod":
        r = abs(a) % abs(b)
        out = -r if a < 0 else r
    else:
        raise AssertionError(op)
    if isinstance(out, int) and out_t.is_integer:
        bits = out_t.np_dtype.itemsize * 8
        if not -(1 << (bits - 1)) <= out < (1 << (bits - 1)):
            word, sym = _OP_WORDS[op]
            raise NumericValueOutOfRange(f"{out_t.name} {word} overflow: {a} {sym} {b}")
    return out


def _date_add_const(days: int, n: int, unit: str) -> int:
    import datetime

    from ..data.types import days_to_date

    d = days_to_date(days)
    if unit == "day":
        return days + n
    if unit == "month":
        m = d.month - 1 + n
        y = d.year + m // 12
        m = m % 12 + 1
        day = min(d.day, _days_in_month(y, m))
        return date_to_days(datetime.date(y, m, day).isoformat())
    if unit == "year":
        y = d.year + n
        day = min(d.day, _days_in_month(y, d.month))
        return date_to_days(datetime.date(y, d.month, day).isoformat())
    raise PlanningError(f"unsupported interval unit {unit}")


def _days_in_month(y: int, m: int) -> int:
    import calendar

    return calendar.monthrange(y, m)[1]


def _cast_relation(rel: RelationPlan, types: list[Type]) -> RelationPlan:
    """Wrap a Project applying columnwise casts when needed."""
    if all(f.type == t for f, t in zip(rel.fields, types)):
        return rel
    exprs = tuple(
        _cast_ir(FieldRef(i, f.type), t)
        for i, (f, t) in enumerate(zip(rel.fields, types))
    )
    names = tuple(f.name or f"_c{i}" for i, f in enumerate(rel.fields))
    node = Project(rel.node, exprs, names)
    return RelationPlan(node, [Field(f.qualifier, f.name, t) for f, t in zip(rel.fields, types)])


class _LambdaTranslator(_Translator):
    """Translator with lambda parameters in scope (innermost wins); chains
    through nested lambdas by merging the parent's parameter map."""

    def __init__(self, parent: _Translator, params: dict):
        super().__init__(parent.scope, parent.outer, parent.agg_map, parent.grouped)
        merged = dict(getattr(parent, "_lambda_params", {}))
        merged.update(params)
        self._lambda_params = merged

    def translate(self, e: A.Expr) -> IrExpr:
        if isinstance(e, A.Ident) and len(e.parts) == 1:
            t = self._lambda_params.get(e.parts[0])
            if t is not None:
                from .ir import LambdaVarIr

                return LambdaVarIr(e.parts[0], t)
        return super().translate(e)


def _as_bool(e: IrExpr) -> IrExpr:
    if e.type != BOOLEAN:
        raise PlanningError(f"expected boolean expression, got {e.type}")
    return e


def _conjoin(parts: list[IrExpr]) -> IrExpr:
    out = parts[0]
    for p in parts[1:]:
        out = Call("and", (out, p), BOOLEAN)
    return out


def _and_all(parts: list[A.Expr]) -> A.Expr:
    out = parts[0]
    for p in parts[1:]:
        out = A.BinOp("and", out, p)
    return out


def _split_conjuncts(e: Optional[A.Expr]) -> list[A.Expr]:
    if e is None:
        return []
    if isinstance(e, A.BinOp) and e.op == "and":
        return _split_conjuncts(e.left) + _split_conjuncts(e.right)
    return [e]


def _split_disjuncts(e: A.Expr) -> list[A.Expr]:
    if isinstance(e, A.BinOp) and e.op == "or":
        return _split_disjuncts(e.left) + _split_disjuncts(e.right)
    return [e]


def _extract_common_or_conjuncts(e: A.Expr) -> A.Expr:
    """(a and x) or (a and y) -> a and (x or y)  — the rewrite that turns
    TPC-H Q19's disjunction into an equi-join (reference:
    iterative/rule/ExtractCommonPredicatesExpressionRewriter)."""
    branches = _split_disjuncts(e)
    if len(branches) < 2:
        return e
    conj_sets = [_split_conjuncts(b) for b in branches]
    common = [c for c in conj_sets[0] if all(c in s for s in conj_sets[1:])]
    if not common:
        return e
    remains = []
    for s in conj_sets:
        rest = [c for c in s if c not in common]
        remains.append(_and_all(rest) if rest else A.BoolLit(True))
    out: A.Expr = remains[0]
    for r in remains[1:]:
        out = A.BinOp("or", out, r)
    for c in common:
        out = A.BinOp("and", c, out)
    return out


def _substitute_aliases(e: A.Expr, items: Sequence[A.SelectItem]) -> A.Expr:
    """Replace bare identifiers that name select-item aliases with the
    aliased expression (ORDER BY expression scope includes output names)."""
    import dataclasses as _dc

    if isinstance(e, A.Ident) and len(e.parts) == 1:
        for it in items:
            if it.alias == e.parts[0]:
                return it.expr
        return e
    if isinstance(e, (A.ScalarSubquery, A.Exists)):
        return e  # alias scope does not reach into subqueries
    if isinstance(e, A.CaseExpr):
        whens = tuple(
            (_substitute_aliases(c, items), _substitute_aliases(r, items))
            for c, r in e.whens
        )
        default = (
            None if e.default is None else _substitute_aliases(e.default, items)
        )
        return _dc.replace(e, whens=whens, default=default)
    if not _dc.is_dataclass(e):
        return e
    changes = {}
    for f in _dc.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, A.Expr):
            nv = _substitute_aliases(v, items)
            if nv is not v:
                changes[f.name] = nv
        elif (
            isinstance(v, tuple)
            and v
            and all(isinstance(x, A.Expr) for x in v)
        ):
            nv = tuple(_substitute_aliases(x, items) for x in v)
            if nv != v:
                changes[f.name] = nv
    return _dc.replace(e, **changes) if changes else e


def _ast_children(e: A.Expr) -> list[A.Expr]:
    if isinstance(e, A.BinOp):
        return [e.left, e.right]
    if isinstance(e, (A.Not, A.Neg)):
        return [e.operand]
    if isinstance(e, A.FuncCall):
        return list(e.args)
    if isinstance(e, A.CaseExpr):
        out = []
        for c, r in e.whens:
            out += [c, r]
        if e.default is not None:
            out.append(e.default)
        return out
    if isinstance(e, A.Cast):
        return [e.operand]
    if isinstance(e, A.Between):
        return [e.operand, e.low, e.high]
    if isinstance(e, (A.InList, A.Like)):
        return [e.operand] + (list(e.items) if isinstance(e, A.InList) else [])
    if isinstance(e, A.IsNull):
        return [e.operand]
    if isinstance(e, A.Extract):
        return [e.operand]
    if isinstance(e, A.InSubquery):
        return [e.operand]
    if isinstance(e, A.WindowFunc):
        return (
            list(e.args)
            + list(e.partition_by)
            + [si.expr for si in e.order_by]
        )
    return []


def _has_subquery(e: A.Expr) -> bool:
    if isinstance(e, (A.ScalarSubquery, A.InSubquery, A.Exists)):
        return True
    return any(_has_subquery(c) for c in _ast_children(e))


def _is_local(e: A.Expr, scope: Scope) -> bool:
    """True iff every column reference resolves in `scope` itself (depth 0)."""
    if isinstance(e, A.Ident):
        hit = scope.try_resolve(e.parts)
        return hit is not None and hit[0] == 0
    if isinstance(e, (A.ScalarSubquery, A.Exists)):
        return False
    if isinstance(e, A.InSubquery):
        return False
    return all(_is_local(c, scope) for c in _ast_children(e))


def _as_equi_pair(
    e: A.Expr, left: Scope, right: Scope
) -> Optional[tuple[A.Expr, A.Expr]]:
    """a = b with a over left and b over right (either order) -> (a, b)."""
    if not (isinstance(e, A.BinOp) and e.op == "="):
        return None
    a, b = e.left, e.right
    if _is_local(a, left) and _is_local(b, right):
        return (a, b)
    if _is_local(b, left) and _is_local(a, right):
        return (b, a)
    return None


def _correlated_equi_pair(
    e: A.Expr, outer: Scope, inner: Scope
) -> Optional[tuple[A.Expr, A.Expr]]:
    """outer_expr = inner_expr (either order) -> (outer_ast, inner_ast)."""
    if not (isinstance(e, A.BinOp) and e.op == "="):
        return None
    a, b = e.left, e.right
    if _is_local(a, inner) and not _is_local(b, inner) and _is_local(b, outer):
        return (b, a)
    if _is_local(b, inner) and not _is_local(a, inner) and _is_local(a, outer):
        return (a, b)
    return None


def _equi_keys(conjuncts: list[A.Expr], left: Scope, right: Scope) -> list:
    return [c for c in conjuncts if _as_equi_pair(c, left, right) is not None]


def _agg_type(fn: str, arg_t: Type) -> Type:
    if fn == "count":
        return BIGINT
    if fn == "avg":
        return DOUBLE
    if fn == "sum":
        if arg_t.is_integer:
            return BIGINT
        if arg_t.is_decimal:
            # widen to the max short-decimal precision (reference widens to
            # decimal(38,s); int64 lanes cap at 18)
            return DecimalType(38, arg_t.scale)
        return DOUBLE if arg_t.is_floating else arg_t
    return arg_t  # min / max


def _derive_name(e: A.Expr, i: int) -> str:
    if isinstance(e, A.Ident):
        return e.parts[-1]
    return f"_col{i}"


def _nulls_first(si: A.SortItem) -> bool:
    if si.nulls_first is not None:
        return si.nulls_first
    return not si.ascending  # Trino default: NULLS LAST for ASC, FIRST for DESC
