"""Startup cache warming: replay the top recurring statements from the
query history so their kernels are built (kernel 2's NVRTC recipes) and
their table slices uploaded into the workers' scan caches before the first
client query pays for them.

Reference shape: the engine ships no warmer, but production deployments
universally front-run the morning dashboard load by replaying yesterday's
queries.  The warmer closes the loop between ``runtime/history.py``, which
knows which statements recur, and the caches a replay fills (the NVRTC
disk cache under trino_tpu_torch/build/nvrtc/, the workers' ScanCache).

``TRINO_TPU_WARM_SIGNATURES=<K>`` on the coordinator warms the top-K
recurring FINISHED statements from the history file at startup (a daemon
thread, so the server is accepting queries while it warms).  Each warmed
statement counts a ``warm`` event in
``trino_tpu_persistent_cache_events_total`` via ``PROFILER.record_warm``.
"""

from __future__ import annotations

from typing import Callable

from ..utils.profiler import PROFILER

__all__ = ["top_statements", "warm_from_history"]

# statements that can't (or shouldn't) be replayed for warming: writes and
# DDL mutate state; EXPLAIN/SET don't build the programs we care about;
# "<planned>" is the Engine's marker for non-SQL plan objects
_SKIP_PREFIXES = (
    "insert", "create", "drop", "delete", "update", "alter", "merge",
    "explain", "set ", "show", "describe", "use ", "grant", "deny",
    "revoke", "call", "comment", "analyze", "refresh", "truncate",
)


def _replayable(sql: str) -> bool:
    s = (sql or "").strip()
    if not s or s == "<planned>":
        return False
    head = s.lstrip("(").lower()
    return not any(head.startswith(p) for p in _SKIP_PREFIXES)


def top_statements(history, limit: int) -> list[str]:
    """The top-``limit`` distinct replayable statements from a
    QueryHistoryStore, ranked by recurrence count then recency (newest
    first).  Only FINISHED queries qualify — replaying known failures
    would just re-trip the compile breaker."""
    counts: dict[str, int] = {}
    order: dict[str, int] = {}  # first (i.e. most recent) position seen
    for i, rec in enumerate(history.list(state="FINISHED", limit=1000)):
        sql = rec.get("sql")
        if not isinstance(sql, str) or not _replayable(sql):
            continue
        key = sql.strip()
        counts[key] = counts.get(key, 0) + 1
        order.setdefault(key, i)
    ranked = sorted(counts, key=lambda s: (-counts[s], order[s]))
    return ranked[: max(0, int(limit))]


def warm_from_history(
    run_sql: Callable[[str], object], history, limit: int
) -> int:
    """Replay the top-``limit`` statements through ``run_sql``; returns how
    many warmed successfully.  A statement that fails (table dropped since,
    syntax drift across versions) is skipped — warming must never take the
    server down."""
    warmed = 0
    for sql in top_statements(history, limit):
        try:
            run_sql(sql)
        except Exception:
            continue
        PROFILER.record_warm()
        warmed += 1
    return warmed
