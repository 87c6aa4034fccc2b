"""Row-level DML: DELETE / UPDATE / MERGE, lowered onto the query engine.

The reference implements row-level writes with a dedicated operator pipeline
(operator/MergeWriterOperator + MergeProcessorOperator, planner
createMergePipeline) driven by connector row IDs.  A columnar engine on an
accelerator has no per-row virtual calls to hook into — but it has a fast
whole-relation query path.  So DML is lowered to *table rewrites*: the new
table contents are computed as an ordinary (device-executed) query over the
current contents, then swapped into the connector atomically:

  DELETE FROM t WHERE p       -> keep rows of t where p IS NOT TRUE
  UPDATE t SET c=e WHERE p    -> project CASE WHEN p THEN e ELSE c END
  MERGE INTO t USING s ON c   -> survivors(t LEFT JOIN s) UNION inserts(s)

First-match-wins across WHEN clauses is encoded with a computed action
marker (CASE ... THEN 'u0'/'d'/'k'), mirroring the reference's merge row
operations (spi/connector/MergePage: insert/delete/update ops per row).

The swap is transactional (runtime/txn.py): the statement journals a write
intent, its new contents are computed as a query over the live pre-image
and STAGED via the connector's begin_write handle (never touching the live
table), then committed at a single atomic point guarded by a snapshot CAS
— with the commit marker journaled for exactly-once crash replay and cache
invalidation fired only after the commit lands.

A copy of the JAX package's module: the statement rewrites are SQL ASTs,
so they run unchanged on the port's planner and executor (MERGE's LEFT
JOIN and its multi-match guard take the hash join and hash GROUP BY on
the card).
"""

from __future__ import annotations

from typing import Optional

from ..sql import statements as S
from ..sql.ast import (
    BinOp, BoolLit, CaseExpr, Cast, Expr, FuncCall, Ident, IsNull, Not, Query,
    Select, SelectItem, Star, StrLit, SubqueryRelation, Table, JoinRelation,
    Exists, IntLit,
)
from .txn import run_write

__all__ = ["execute_delete", "execute_update", "execute_merge"]


def _not_true(pred: Expr) -> Expr:
    """p IS NOT TRUE: survives rows where p is FALSE or NULL."""
    return Not(FuncCall("coalesce", (pred, BoolLit(False))))


def _is_true(pred: Expr) -> Expr:
    return FuncCall("coalesce", (pred, BoolLit(False)))


def _stage_replace(txn, engine, query: Query) -> int:
    """Run `query` over the live pre-image and stage its result as the
    table's replacement contents.  Returns the staged (new) row count.
    Nothing mutates: staging is invisible until txn.commit()."""
    names, _types, cols = engine._query_columns(query)
    n = len(cols[0]) if cols else 0
    txn.stage_truncate()
    engine._insert_resolved(txn.conn, txn.table, names, cols, stage=txn)
    return n


def execute_delete(engine, stmt: S.Delete) -> int:
    conn, catalog, table = engine._target_ref(stmt.table)
    if stmt.where is None:
        # bare DELETE FROM t rides the same transactional staged-swap path
        # as predicated DML (it used to truncate in place with no snapshot
        # guard at all — a crash mid-statement lost the table)
        def _truncate_all(txn):
            old_n = conn.estimated_row_count(table) or 0
            txn.stage_truncate()
            return old_n

        return run_write(engine, catalog, table, "delete", _truncate_all)

    survivors = Query(
        Select(
            items=(Star(),),
            relations=(Table(table, None, catalog),),
            where=_not_true(stmt.where),
        )
    )

    def _attempt(txn):
        # recomputed per attempt: a conflict retry re-reads the fresh
        # pre-image instead of re-staging stale survivors
        old_n = conn.estimated_row_count(table) or 0
        new_n = _stage_replace(txn, engine, survivors)
        return old_n - new_n

    return run_write(engine, catalog, table, "delete", _attempt)


def execute_update(engine, stmt: S.Update) -> int:
    conn, catalog, table = engine._target_ref(stmt.table)
    schema = conn.table_schema(table)
    assigned = dict(stmt.assignments)
    unknown = set(assigned) - {c.name for c in schema.columns}
    if unknown:
        raise KeyError(f"UPDATE unknown column(s): {sorted(unknown)}")
    items = []
    for c in schema.columns:
        if c.name in assigned:
            # cast to the column type so e.g. a decimal literal assigned to a
            # DOUBLE column rescales instead of writing raw scaled lanes
            e: Expr = Cast(assigned[c.name], c.type.name)
            if stmt.where is not None:
                e = CaseExpr(((_is_true(stmt.where), e),), Ident((c.name,)))
        else:
            e = Ident((c.name,))
        items.append(SelectItem(e, c.name))
    rewrite = Query(
        Select(items=tuple(items), relations=(Table(table, None, catalog),))
    )
    count_q = None
    if stmt.where is not None:
        # count on the PRE-image: WHERE may reference assigned columns
        count_q = Query(
            Select(
                items=(SelectItem(FuncCall("count", ()), "n"),),
                relations=(Table(table, None, catalog),),
                where=_is_true(stmt.where),
            )
        )

    def _attempt(txn):
        if count_q is None:
            affected = conn.estimated_row_count(table) or 0
        else:
            affected = int(engine.query(count_q)[0][0] or 0)
        _stage_replace(txn, engine, rewrite)
        return affected

    return run_write(engine, catalog, table, "update", _attempt)


def execute_merge(engine, stmt: S.Merge) -> int:
    """MERGE INTO target USING source ON cond WHEN ... THEN ...

    Builds (a) the survivors query: target LEFT JOIN marked-source, each
    column projected through the first-matching-clause action, delete rows
    filtered; (b) the insert query: source rows with no target match
    (NOT EXISTS over the ON condition).  Applies both as one swap.
    """
    conn, catalog, table = engine._target_ref(stmt.target)
    schema = conn.table_schema(table)
    col_names = [c.name for c in schema.columns]
    t_alias = stmt.target_alias or table

    # mark the source: wrap it so matched rows are detectable after the LEFT
    # JOIN (non-null marker == the reference's "row present" join channel).
    # An unaliased table source keeps its table name as the alias so the
    # user's qualified references (s.k) still resolve.
    src = stmt.source
    s_alias = (
        getattr(src, "alias", None)
        or getattr(src, "name", None)
        or "__merge_src"
    )
    marked_src = SubqueryRelation(
        Query(
            Select(
                items=(Star(), SelectItem(BoolLit(True), "__merge_m")),
                relations=(src,),
            )
        ),
        s_alias,
    )
    matched_e = IsNull(Ident((s_alias, "__merge_m")), True)  # IS NOT NULL

    matched_clauses = [c for c in stmt.clauses if c.matched]
    insert_clauses = [c for c in stmt.clauses if not c.matched]

    guard: Optional[Query] = None
    if matched_clauses:
        # reference semantics: a target row matched by more than one source
        # row is an error ('One MERGE target table row matched more than one
        # source row'), not a silent duplication through the LEFT JOIN
        from ..sql.ast import WindowFunc

        rid_target = SubqueryRelation(
            Query(
                Select(
                    items=(
                        Star(),
                        SelectItem(WindowFunc("row_number", (), (), (), None), "__rid"),
                    ),
                    relations=(Table(table, t_alias, catalog),),
                )
            ),
            t_alias,
        )
        guard = Query(
            Select(
                items=(SelectItem(FuncCall("max", (Ident(("cnt",)),)), "m"),),
                relations=(
                    SubqueryRelation(
                        Query(
                            Select(
                                items=(SelectItem(FuncCall("count", ()), "cnt"),),
                                relations=(
                                    JoinRelation("inner", rid_target, src, stmt.on),
                                ),
                                group_by=(Ident((t_alias, "__rid")),),
                            )
                        ),
                        "__merge_guard",
                    ),
                ),
            )
        )
    # action marker: first matching WHEN clause in order ('u<k>' update,
    # 'd' delete, 'k' keep)
    whens = []
    for k, cl in enumerate(matched_clauses):
        cond = matched_e if cl.condition is None else BinOp("and", matched_e, cl.condition)
        tag = "d" if cl.kind == "delete" else f"u{k}"
        whens.append((cond, StrLit(tag)))
    action: Expr = CaseExpr(tuple(whens), StrLit("k")) if whens else StrLit("k")

    items = []
    for c in schema.columns:
        base = Ident((t_alias, c.name))
        upd_whens = []
        for k, cl in enumerate(matched_clauses):
            if cl.kind != "update":
                continue
            assigns = dict(cl.assignments)
            if c.name in assigns:
                upd_whens.append(
                    (
                        BinOp("=", action, StrLit(f"u{k}")),
                        Cast(assigns[c.name], c.type.name),
                    )
                )
        e = CaseExpr(tuple(upd_whens), base) if upd_whens else base
        items.append(SelectItem(e, c.name))
    survivors: Optional[Query] = Query(
        Select(
            items=tuple(items),
            relations=(
                JoinRelation("left", Table(table, t_alias, catalog), marked_src, stmt.on),
            ),
            where=BinOp("<>", action, StrLit("d")),
        )
    )

    insert_names: list[str] = []
    insert_query: Optional[Query] = None
    if insert_clauses:
        if len(insert_clauses) > 1:
            raise NotImplementedError("multiple WHEN NOT MATCHED clauses")
        cl = insert_clauses[0]
        names = [n for n, _ in cl.assignments]
        if names[0] is None:  # positional: schema order
            if len(cl.assignments) > len(col_names):
                raise ValueError("MERGE INSERT has more values than target columns")
            names = col_names[: len(cl.assignments)]
        insert_names = names
        anti = Not(
            Exists(
                Query(
                    Select(
                        items=(SelectItem(IntLit(1), "x"),),
                        relations=(Table(table, t_alias, catalog),),
                        where=stmt.on,
                    )
                )
            )
        )
        where = anti
        if cl.condition is not None:
            where = BinOp("and", anti, _is_true(cl.condition))
        insert_query = Query(
            Select(
                items=tuple(
                    SelectItem(Cast(e, schema.type_of(n).name), n)
                    for n, (_, e) in zip(names, cl.assignments)
                ),
                relations=(src,),
                where=where,
            )
        )

    # affected = updated + deleted + inserted; count updates on the pre-image
    cq: Optional[Query] = None
    if any(cl.kind == "update" for cl in matched_clauses):
        cq = Query(
            Select(
                items=(
                    SelectItem(
                        FuncCall(
                            "sum",
                            (
                                CaseExpr(
                                    (
                                        (
                                            BinOp(
                                                "and",
                                                BinOp("<>", action, StrLit("d")),
                                                BinOp("<>", action, StrLit("k")),
                                            ),
                                            IntLit(1),
                                        ),
                                    ),
                                    IntLit(0),
                                ),
                            ),
                        ),
                        "n",
                    ),
                ),
                relations=(
                    JoinRelation(
                        "left", Table(table, t_alias, catalog), marked_src, stmt.on
                    ),
                ),
            )
        )
    # everything data-dependent runs INSIDE the attempt so a conflict retry
    # recomputes against the fresh pre-image.  Survivors and inserts stage
    # into one transaction and land at one commit point — insert-only MERGE
    # skips the survivors rewrite entirely (the target is untouched, and the
    # fan-out LEFT JOIN could otherwise duplicate target rows matched by
    # several source rows).
    def _attempt(txn):
        if guard is not None:
            worst = engine.query(guard)[0][0]
            if worst is not None and worst > 1:
                raise ValueError(
                    "MERGE: one target table row matched more than one source row"
                )
        old_n = conn.estimated_row_count(table) or 0
        upd_count = int(engine.query(cq)[0][0] or 0) if cq is not None else 0
        ins_cols = None
        if insert_query is not None:
            _, _, ins_cols = engine._query_columns(insert_query)
        deleted = 0
        if matched_clauses:
            new_n = _stage_replace(txn, engine, survivors)
            deleted = old_n - new_n
        inserted = 0
        if ins_cols is not None:
            inserted = len(ins_cols[0]) if ins_cols else 0
            engine._insert_resolved(conn, table, insert_names, ins_cols,
                                    stage=txn)
        return upd_count + deleted + inserted

    return run_write(engine, catalog, table, "merge", _attempt)
