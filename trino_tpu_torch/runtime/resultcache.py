"""Version vectors of the tables a plan reads, and the nondeterminism test.

The three functions the prepared-statement plan cache (runtime/fastpath.py)
pins its entries with, copied from the JAX package's result-cache module:
a cached plan is served only while every table it scans is at the version it
was planned against.  The result cache and the fragment memo themselves
(`ResultCache`, `FragmentMemo`) belong to the coordinator and port with the
control plane (ROADMAP A.11).
"""

from __future__ import annotations

__all__ = ["plan_version_vector", "table_version", "has_nondeterministic"]


_NONDETERMINISTIC_FNS = frozenset(
    {"now", "current_timestamp", "localtimestamp", "random", "rand", "uuid"}
)


def table_version(conn, table: str) -> int:
    """A table's cache version: the Iceberg-lite snapshot id when the
    connector tracks per-table snapshots (an external commit moves it even
    when no engine-side invalidation hook fired), else the connector's
    DML-bumped ``generation`` counter (0 for immutable generator catalogs
    like tpch/faker, which never need invalidating)."""
    loader = getattr(conn, "_load_meta", None)
    if loader is not None:
        try:
            return int(loader(table).get("current_snapshot_id") or 0)
        except Exception:
            pass  # not a table of this connector / no snapshot yet
    return int(getattr(conn, "generation", 0) or 0)


def plan_version_vector(plan, catalogs):
    """Sorted ``(("catalog.table", version), ...)`` over every TableScan of
    ``plan`` — the snapshot half of the cache key.  Returns None when any
    scan is pinned (time-travel ``t@<snap>``) or a metadata table
    (``t$snapshots``): those read immutable or synthetic data and bypass
    the cache rather than risk keying it wrong."""
    from ..plan.nodes import TableScan, walk

    vec: dict[str, int] = {}
    for n in walk(plan):
        if not isinstance(n, TableScan):
            continue
        ref = n.table
        if "@" in ref or "$" in ref:
            return None
        try:
            conn = catalogs.get(n.catalog)
        except KeyError:
            return None
        vec[f"{n.catalog}.{ref}"] = table_version(conn, ref)
    return tuple(sorted(vec.items()))


def has_nondeterministic(node) -> bool:
    """True when the statement AST calls a non-deterministic function
    (now/current_timestamp/random/...).  Checked on the AST, not the plan:
    the planner folds these to per-query constants, so they are invisible
    after planning.  Generic dataclass walk — new AST node types are
    covered without registration."""
    import dataclasses

    seen: set[int] = set()
    stack = [node]
    while stack:
        x = stack.pop()
        if isinstance(x, (tuple, list)):
            stack.extend(x)
            continue
        if not dataclasses.is_dataclass(x) or isinstance(x, type):
            continue
        if id(x) in seen:
            continue
        seen.add(id(x))
        if (
            type(x).__name__ == "FuncCall"
            and str(getattr(x, "name", "")).lower() in _NONDETERMINISTIC_FNS
        ):
            return True
        for f in dataclasses.fields(x):
            stack.append(getattr(x, f.name))
    return False

