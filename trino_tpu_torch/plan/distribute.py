"""Distributed planning: insert Exchange nodes + split aggregations.

The reference's AddExchanges (sql/planner/optimizations/AddExchanges.java:143)
walks the plan inserting REMOTE REPARTITION / REPLICATE / GATHER exchanges and
splitting aggregations into partial/final around them; join distribution
(partitioned vs broadcast) is cost-chosen (DetermineJoinDistributionType.java
:51).  This pass does the same over the SPMD model (a copy of the JAX
package's pass; in the port, plan/fragmenter.py cuts its output and
exec/spill.py runs the P parts one after another on one card):

- every operator runs on all D devices over local shards (scans are split
  round-robin by the executor);
- `Exchange(repartition, keys)` hash-routes rows across devices (an
  all-to-all), `broadcast`/`gather` replicate (all_gather);
- Aggregate splits into partial (pre-exchange, local) and final
  (post-exchange), with avg decomposed into sum+count and the division
  re-applied by a Project (the reference's partial/final accumulator states);
- join distribution is picked from connector row-count estimates: small build
  sides broadcast, large ones repartition both inputs;
- tracked output partitioning elides exchanges when data is already
  co-located (e.g. GROUP BY on the join key just joined on).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..connectors.spi import CatalogManager
from ..data.types import BIGINT, DOUBLE
from .ir import Call, Const, FieldRef, IrExpr
from .nodes import (
    AggCall, Aggregate, Concat, Distinct, EnforceSingleRow, Exchange, Filter,
    Join, Limit, PlanNode, Project, Sort, TableScan, TopN, Values, Window,
)

__all__ = ["distribute"]

_BROADCAST_LIMIT = 100_000  # est. rows below which a build side is replicated


@dataclass(frozen=True)
class _Part:
    """Tracked partitioning of a node's output.
    kind: any (arbitrary/source) | hash | replicated | single"""

    kind: str
    keys: tuple[IrExpr, ...] = ()


def distribute(
    plan: PlanNode,
    catalogs: CatalogManager,
    num_devices: int,
    session=None,
    connector_buckets: bool = False,
) -> PlanNode:
    """Rewrite a single-node plan into an SPMD plan for `num_devices`.

    connector_buckets: treat connector-bucketed scans as hash-partitioned
    (only the multi-host worker runtime honors connector split routing; the
    in-process SPMD executor shards scans by row range, where assuming
    bucket alignment would be wrong)."""
    if num_devices <= 1:
        return plan
    d = _Distributor(catalogs, session, num_devices)
    d.connector_buckets = connector_buckets
    node, part = d.visit(plan)
    if part.kind != "replicated":
        node = Exchange(node, "gather")
        node = _re_finalize(node, plan)
    return node


def _re_finalize(node: PlanNode, original: PlanNode) -> PlanNode:
    """After the final gather, re-apply order/limit that local stages only
    enforced per-shard."""
    if isinstance(original, TopN):
        return TopN(node, original.keys, original.count)
    if isinstance(original, Sort):
        return Sort(node, original.keys)
    if isinstance(original, Limit):
        return Limit(node, original.count)
    return node


class _Distributor:
    def __init__(self, catalogs: CatalogManager, session=None, num_devices: int = 2):
        self.catalogs = catalogs
        self.session = session
        self.num_devices = num_devices

    def _join_mode(self) -> str:
        if self.session is None:
            return "AUTOMATIC"
        return self.session.get("join_distribution_type")

    def _broadcast_limit(self) -> int:
        if self.session is None:
            return _BROADCAST_LIMIT
        return self.session.get("broadcast_join_row_limit")

    def _broadcast_fanout(self, probe: PlanNode) -> float:
        """How many consumers fetch a replicated build.  Classically one
        per device; under split_driven_scans (runtime/splits.py) a
        morselized probe runs ceil(rows / split_target_rows) tasks and
        EACH fetches the whole build — broadcast cost scales with the
        split count, never less than the device count."""
        if self.session is None or not self.session.get("split_driven_scans"):
            return float(self.num_devices)
        target = int(self.session.get("split_target_rows") or 65536)
        pad = 1 << max(0, (max(1, target) - 1).bit_length())
        nsplits = -(-self.est_rows(probe) // pad)
        return float(max(self.num_devices, nsplits))

    # ------------------------------------------------------------ size model
    def est_rows(self, node: PlanNode) -> float:
        """Cardinality from the stats calculator (plan/stats.py): connector
        NDV/min-max stats drive filter selectivity, join fan-out and group
        counts (reference: cost/ — FilterStatsCalculator, JoinStatsRule)."""
        from .stats import estimate

        return estimate(node, self.catalogs).rows

    # --------------------------------------------------------------- visitor
    def visit(self, node: PlanNode) -> tuple[PlanNode, _Part]:
        if isinstance(node, TableScan):
            if getattr(self, "connector_buckets", False):
                # bucketed table: the scan is BORN hash-partitioned on the
                # bucket keys (reference: BucketNodeMap — bucketed execution
                # skips the reshuffle) when buckets divide evenly over
                # workers and the keys survive column pruning
                conn = self.catalogs.get(node.catalog)
                bp = conn.table_partitioning(node.table)
                if bp is not None:
                    cols, nb = bp
                    if nb % self.num_devices == 0 and all(
                        c in node.column_names for c in cols
                    ):
                        keys = tuple(
                            FieldRef(
                                node.column_names.index(c),
                                node.output_types[node.column_names.index(c)],
                            )
                            for c in cols
                        )
                        return node, _Part("hash", keys)
            return node, _Part("any")
        if isinstance(node, Values):
            return node, _Part("replicated")

        if isinstance(node, Filter):
            child, part = self.visit(node.child)
            return Filter(child, node.predicate), part

        from .nodes import Compact as _Compact

        if isinstance(node, _Compact):
            child, part = self.visit(node.child)
            return _Compact(child), part

        if isinstance(node, EnforceSingleRow):
            # the at-most-one-row check must see ALL rows once: gather
            # partitioned input (a per-device count would under-report)
            child, part = self.visit(node.child)
            if part.kind != "replicated":
                child = Exchange(child, "gather")
                part = _Part("replicated")
            return EnforceSingleRow(child), part

        if isinstance(node, Project):
            child, part = self.visit(node.child)
            return Project(child, node.expressions, node.names), _project_part(
                part, node
            )

        if isinstance(node, Aggregate):
            return self._visit_aggregate(node)

        if isinstance(node, Distinct):
            child, part = self.visit(node.child)
            keys = tuple(
                FieldRef(i, t) for i, t in enumerate(node.child.output_types)
            )
            if part.kind == "replicated":
                return Distinct(child), part
            # local pre-distinct shrinks the exchange, then exact distinct
            local = Distinct(child)
            exch = Exchange(local, "repartition", keys)
            return Distinct(exch), _Part("hash", keys)

        if isinstance(node, Join):
            return self._visit_join(node)

        if isinstance(node, TopN):
            child, part = self.visit(node.child)
            if part.kind == "replicated":
                return TopN(child, node.keys, node.count), part
            local = TopN(child, node.keys, node.count)
            exch = Exchange(local, "gather")
            return TopN(exch, node.keys, node.count), _Part("replicated")

        if isinstance(node, Sort):
            child, part = self.visit(node.child)
            if part.kind == "replicated":
                return Sort(child, node.keys), part
            exch = Exchange(child, "gather")
            return Sort(exch, node.keys), _Part("replicated")

        if isinstance(node, Limit):
            child, part = self.visit(node.child)
            if part.kind == "replicated":
                return Limit(child, node.count), part
            local = Limit(child, node.count)
            exch = Exchange(local, "gather")
            return Limit(exch, node.count), _Part("replicated")

        if isinstance(node, Concat):
            new_inputs = []
            for c in node.inputs:
                cc, cpart = self.visit(c)
                if cpart.kind == "replicated":
                    cc = Exchange(cc, "single")  # count replicated rows once
                new_inputs.append(cc)
            return Concat(tuple(new_inputs)), _Part("any")

        from .nodes import Unnest as _Unnest

        if isinstance(node, _Unnest):
            # row-local expansion: child columns keep their indices, so any
            # hash partitioning on them is preserved
            child, part = self.visit(node.child)
            return (
                _Unnest(
                    child, node.arrays, node.element_names, node.element_types,
                    node.with_ordinality, node.outer, node.ordinality_name,
                ),
                part,
            )

        if isinstance(node, Window):
            child, part = self.visit(node.child)
            if part.kind == "replicated":
                return (
                    Window(child, node.partition_by, node.order_by, node.calls, node.call_names),
                    part,
                )
            if node.partition_by:
                already = part.kind == "hash" and all(
                    any(k == p for p in node.partition_by) for k in part.keys
                )
                if not already:
                    child = Exchange(child, "repartition", node.partition_by)
                    part = _Part("hash", node.partition_by)
                return (
                    Window(child, node.partition_by, node.order_by, node.calls, node.call_names),
                    part,
                )
            # no PARTITION BY: the whole relation is one window partition
            child = Exchange(child, "gather")
            return (
                Window(child, node.partition_by, node.order_by, node.calls, node.call_names),
                _Part("replicated"),
            )

        from .nodes import MatchRecognize as _MR

        if isinstance(node, _MR):
            # like Window: pattern matching is per-partition sequential work,
            # so hash-repartition on PARTITION BY (or gather when absent)
            import dataclasses as _dc

            child, part = self.visit(node.child)
            if part.kind == "replicated":
                return _dc.replace(node, child=child), part
            if node.partition_keys:
                already = part.kind == "hash" and all(
                    any(k == p for p in node.partition_keys) for k in part.keys
                )
                if not already:
                    child = Exchange(child, "repartition", node.partition_keys)
                    part = _Part("hash", node.partition_keys)
                return _dc.replace(node, child=child), part
            child = Exchange(child, "gather")
            return _dc.replace(node, child=child), _Part("replicated")

        raise NotImplementedError(f"distribute: {type(node).__name__}")

    # ------------------------------------------------------------- aggregate
    def _visit_aggregate(self, node: Aggregate) -> tuple[PlanNode, _Part]:
        child, part = self.visit(node.child)
        nk = len(node.group_keys)

        if part.kind == "replicated":
            return (
                Aggregate(child, node.group_keys, node.aggs, node.names, "single"),
                part,
            )

        # already partitioned on a subset of the group keys: aggregate locally
        if (
            part.kind == "hash"
            and nk > 0
            and all(any(k == g for g in node.group_keys) for k in part.keys)
        ):
            return (
                Aggregate(child, node.group_keys, node.aggs, node.names, "single"),
                part,
            )

        # aggregates whose state does not combine by re-applying the same fn
        # must see raw rows: repartition (or gather, keyless) then aggregate
        # once (the reference splits these via intermediate state types;
        # raw-row repartition is the simpler equivalent)
        # approx_distinct: an HLL estimate of per-worker estimates is garbage
        # (merging would need the sketch registers, not the counts)
        _raw_only = {"percentile", "stddev_samp", "stddev_pop", "var_samp",
                     "var_pop", "approx_distinct",
                     "corr", "covar_samp", "covar_pop", "regr_slope",
                     "regr_intercept", "array_agg", "map_agg", "listagg"}
        has_distinct = any(a.distinct for a in node.aggs)
        if has_distinct or any(a.fn in _raw_only for a in node.aggs):
            if nk == 0:
                exch = Exchange(child, "gather")
                out = Aggregate(exch, (), node.aggs, node.names, "single")
                return out, _Part("replicated")
            # repartition raw rows on the group keys, then aggregate once
            exch = Exchange(child, "repartition", node.group_keys)
            out = Aggregate(exch, node.group_keys, node.aggs, node.names, "single")
            return out, _Part("hash", _output_key_refs(node))

        # partial -> exchange -> final (+ avg fix-up projection)
        partial_aggs: list[AggCall] = []
        partial_names: list[str] = list(node.names[:nk])
        slots: list[tuple[int, ...]] = []  # per original agg: partial col indices
        for a in node.aggs:
            base = nk + len(partial_aggs)
            if a.fn == "avg":
                partial_aggs.append(AggCall("sum", a.arg, DOUBLE))
                partial_aggs.append(AggCall("count", a.arg, BIGINT))
                partial_names += [f"_p{base}", f"_p{base + 1}"]
                slots.append((base, base + 1))
            elif a.fn == "count_star":
                partial_aggs.append(AggCall("count_star", None, BIGINT))
                partial_names.append(f"_p{base}")
                slots.append((base,))
            else:
                partial_aggs.append(AggCall(a.fn, a.arg, a.type))
                partial_names.append(f"_p{base}")
                slots.append((base,))
        partial = Aggregate(
            child,
            node.group_keys,
            tuple(partial_aggs),
            tuple(partial_names),
            "partial",
        )
        key_refs = tuple(FieldRef(i, k.type) for i, k in enumerate(node.group_keys))
        if nk > 0:
            exch = Exchange(partial, "repartition", key_refs)
            out_part = _Part("hash", key_refs)
        else:
            exch = Exchange(partial, "gather")
            out_part = _Part("replicated")

        # final step over the partial schema
        final_aggs: list[AggCall] = []
        for (a, slot) in zip(node.aggs, slots):
            if a.fn == "avg":
                final_aggs.append(
                    AggCall("sum", FieldRef(slot[0], DOUBLE), DOUBLE)
                )
                final_aggs.append(
                    AggCall("sum", FieldRef(slot[1], BIGINT), BIGINT)
                )
            elif a.fn in ("count", "count_star"):
                final_aggs.append(AggCall("sum", FieldRef(slot[0], BIGINT), BIGINT))
            else:  # sum/min/max combine with themselves
                final_aggs.append(AggCall(a.fn, FieldRef(slot[0], a.type), a.type))
        final = Aggregate(
            exch,
            key_refs,
            tuple(final_aggs),
            tuple(f"_f{i}" for i in range(nk + len(final_aggs))),
            "final",
        )

        # fix-up projection back to the original schema (avg division,
        # count null->0 handled by sum validity rules)
        exprs: list[IrExpr] = [
            FieldRef(i, node.group_keys[i].type) for i in range(nk)
        ]
        fpos = nk
        for a in node.aggs:
            if a.fn == "avg":
                s = FieldRef(fpos, DOUBLE)
                c = FieldRef(fpos + 1, BIGINT)
                exprs.append(Call("div", (s, Call("cast", (c,), DOUBLE)), DOUBLE))
                fpos += 2
            elif a.fn in ("count", "count_star"):
                # count over zero partials must be 0, not NULL
                exprs.append(
                    Call("coalesce", (FieldRef(fpos, BIGINT), Const(0, BIGINT)), BIGINT)
                )
                fpos += 1
            else:
                exprs.append(FieldRef(fpos, a.type))
                fpos += 1
        proj = Project(final, tuple(exprs), node.names)
        return proj, (out_part if nk > 0 else _Part("replicated"))

    # ------------------------------------------------------------------ join
    def _visit_join(self, node: Join) -> tuple[PlanNode, _Part]:
        left, lpart = self.visit(node.left)
        right, rpart = self.visit(node.right)

        if node.kind == "cross":
            # single-row right (scalar subquery): must be replicated
            if rpart.kind != "replicated":
                right = Exchange(right, "gather")
            return (
                Join("cross", left, right, (), (), None, "broadcast"),
                lpart,
            )

        est_right = self.est_rows(node.right)
        mode = self._join_mode()
        # Cost comparison (reference: iterative/rule/
        # DetermineJoinDistributionType.java:51, getSourceTablesSizeInBytes):
        # broadcast replicates the build to every device (R_bytes * D over
        # ICI) but never moves the probe; a partitioned join all_to_all's
        # both sides once (L_bytes + R_bytes).  AUTOMATIC picks the cheaper
        # plan, with the session row limit as a memory guard — every device
        # must HOLD a replicated build, so an unboundedly wide-but-cheap
        # broadcast is still capped (join_max_broadcast_table_size analogue).
        cheaper_to_broadcast = False
        if mode == "AUTOMATIC" and est_right <= self._broadcast_limit():
            r_bytes = est_right * _bytes_per_row(node.right.output_types)
            l_bytes = self.est_rows(node.left) * _bytes_per_row(
                node.left.output_types
            )
            cheaper_to_broadcast = (
                r_bytes * self._broadcast_fanout(node.left)
                <= l_bytes + r_bytes
            )
        broadcast = (
            (mode == "BROADCAST")
            or cheaper_to_broadcast
            or not node.left_keys
            or rpart.kind == "replicated"
            # null_anti needs a global view of the build side: a NULL build
            # key in ANY partition nullifies every probe row, so a
            # hash-partitioned build (NULLs routed to partition 0) would
            # give partition-local answers.
            or node.kind == "null_anti"
            # mark_in shares null_anti's need for a global build view (its
            # FALSE-vs-NULL answer depends on build emptiness and NULLs)
            or node.kind == "mark_in"
        )
        if node.kind == "full":
            # a replicated build would emit its unmatched rows once PER
            # DEVICE; full outer must co-partition both sides (the reference
            # makes the same restriction in DetermineJoinDistributionType)
            broadcast = False
            if lpart.kind == "replicated":
                left = Exchange(left, "single")
                lpart = _Part("any")
            if rpart.kind == "replicated":
                right = Exchange(right, "single")
                rpart = _Part("any")

        if broadcast:
            if rpart.kind != "replicated":
                right = Exchange(right, "broadcast")
            out = Join(
                node.kind, left, right, node.left_keys, node.right_keys,
                node.residual, "broadcast",
            )
            return out, lpart

        # partitioned join: co-locate both sides on the join keys
        if not (lpart.kind == "hash" and lpart.keys == node.left_keys):
            left = Exchange(left, "repartition", node.left_keys)
        if not (rpart.kind == "hash" and rpart.keys == node.right_keys):
            right = Exchange(right, "repartition", node.right_keys)
        out = Join(
            node.kind, left, right, node.left_keys, node.right_keys,
            node.residual, "partitioned",
        )
        return out, _Part("hash", node.left_keys)


def _bytes_per_row(types) -> float:
    """Estimated bytes per row of a schema: fixed-width types by lane dtype,
    varchar by a nominal dictionary-code + amortized-value estimate."""
    total = 0.0
    for t in types:
        if getattr(t, "is_string", False):
            total += 24.0  # int32 code lane + amortized dictionary bytes
        else:
            try:
                total += float(t.np_dtype.itemsize)
            except Exception:
                total += 8.0
    return max(total, 8.0)


def _output_key_refs(node: Aggregate) -> tuple[IrExpr, ...]:
    return tuple(FieldRef(i, k.type) for i, k in enumerate(node.group_keys))


def _project_part(part: _Part, node: Project) -> _Part:
    """Track hash partitioning through a projection: keys survive if each key
    expression appears verbatim as a projected expression."""
    if part.kind != "hash":
        return part
    new_keys = []
    for k in part.keys:
        hit = None
        for i, e in enumerate(node.expressions):
            if e == k:
                hit = FieldRef(i, e.type)
                break
        if hit is None:
            return _Part("any")
        new_keys.append(hit)
    return _Part("hash", tuple(new_keys))
