"""Result & fragment cache plane: coordinator result reuse over snapshots.

Dashboard traffic is overwhelmingly *repeated* queries over slowly-changing
data.  The reference serves it with materialized/cached result machinery on
the coordinator (per PAPER.md: result reuse over immutable Iceberg
snapshots); this module is that plane, in two layers:

``ResultCache`` — whole-result reuse.  An entry is keyed by
``(canonical plan hash, version vector)`` where the plan hash is
``utils/profiler.signature_of`` over the OPTIMIZED plan (pow2-bucketed,
identity-collapsed: textually different but structurally identical queries
share an entry) and the version vector is the sorted
``(catalog.table, version)`` pairs of every referenced table.  Versions come
from the Iceberg-lite connector's ``current_snapshot_id`` when the table is
snapshot-versioned, else from the connector's DML-bumped ``generation``
counter — so an external Iceberg commit is detected as a key mismatch even
when no invalidation hook fired.  Admission is history-driven: only plans
whose signature recurred in the ``runtime/history.py`` store get stored
(cache what repeats, not what happens once).  Eviction is
LRU-by-last-hit under a bytes budget, plus a per-entry TTL.  Invalidation
is typed: DML through ``runtime/dml.py`` / the engine write path calls
``invalidate_table``; time-travel scans (``"t@<snapshot>"``) and
non-deterministic functions (now(), random()) never enter the cache at all
(``bypass``).  Two identical in-flight queries collapse to ONE execution:
the first registers as leader, followers block on its completion event and
reuse its rows (the ``exec/compilesvc.py`` in-flight dedup idiom).

``FragmentMemo`` — shared subplan reuse one level down.  A leaf
scan+filter+project fragment's committed spool output (phased mode) is
renamed into a ``memo_…`` namespace after the query finishes —
``SpooledExchange.adopt`` — and a later query with the same fragment hash
and version vector seeds its stage as precommitted ``spool`` sources, the
exact idiom the crash-resume path uses: the scan is RE-READ, never
recomputed.

Cache state is deliberately NEVER journaled: a restarted coordinator comes
up cold, so a snapshot that advanced while it was down can never be served
stale (runtime/journal.py interplay).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from collections import OrderedDict
from typing import Optional

from ..utils import metrics as _metrics

__all__ = [
    "ResultCache", "FragmentMemo", "plan_version_vector",
    "table_version", "has_nondeterministic", "MEMO_PREFIX",
]

# registered at import (the spool.py idiom) so HELP text is present in
# every /metrics scrape even before the first query
_CACHE_EVENTS = _metrics.GLOBAL.counter(
    "trino_tpu_result_cache_events_total",
    "Result-cache outcomes per query (hit: rows served from the cache or an "
    "identical in-flight leader; miss: executed; bypass: time-travel / "
    "non-deterministic / uncacheable statement; invalidated: entries "
    "dropped by typed DML invalidation or a version-vector mismatch; "
    "evicted: entries dropped by the LRU bytes budget or TTL)",
    ("event",),
)
_CACHE_BYTES = _metrics.GLOBAL.gauge(
    "trino_tpu_result_cache_bytes",
    "Estimated bytes of result rows currently held by the result cache",
)
_MEMO_EVENTS = _metrics.GLOBAL.counter(
    "trino_tpu_fragment_memo_events_total",
    "Fragment-memoization outcomes per memoizable leaf fragment (hit: "
    "stage seeded from a memoized spool dir; miss: fragment executed and "
    "its committed output adopted into the memo namespace)",
    ("event",),
)

# spool namespace for adopted fragment dirs: survives remove_query (which
# matches "{query_id}_") and is shielded from the age GC by _gc_spool
MEMO_PREFIX = "memo"

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


def _estimate_bytes(columns, rows) -> int:
    """Cheap result-size estimate for the bytes budget: per-row/-cell
    overheads plus string payloads.  Exactness doesn't matter — the budget
    bounds growth, it doesn't account RAM."""
    total = 64 + 24 * len(columns or [])
    for r in rows:
        total += 48
        for v in r:
            total += 16
            if isinstance(v, (str, bytes)):
                total += len(v)
    return total


class _Inflight:
    """One in-flight execution of a cache key: the leader executes, every
    follower waits on ``event`` and reuses ``rows`` (None when the leader
    failed or was a kind that produces no shareable rows)."""

    __slots__ = ("event", "rows", "columns")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.rows = None
        self.columns = None


class _Entry:
    __slots__ = ("rows", "columns", "nbytes", "created", "last_hit", "hits")

    def __init__(self, rows, columns, nbytes: int) -> None:
        self.rows = rows
        self.columns = columns
        self.nbytes = nbytes
        self.created = time.time()
        self.last_hit = self.created
        self.hits = 0


class ResultCache:
    """Coordinator result-set cache.  Thread-safe; all state in-memory —
    deliberately not journaled (a restart must come up cold)."""

    def __init__(self, history=None, max_bytes: int = 64 << 20):
        self.history = history
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._bytes = 0
        # secondary indexes: planhash -> keys (stale-version sweep at
        # lookup), "catalog.table" -> keys (typed DML invalidation)
        self._by_hash: dict[str, set] = {}
        self._by_table: dict[str, set] = {}
        self._inflight: dict[tuple, _Inflight] = {}

    # ------------------------------------------------------------- events
    @staticmethod
    def count(event: str, n: int = 1) -> None:
        _CACHE_EVENTS.labels(event).inc(n)

    @staticmethod
    def key_text(key: tuple) -> str:
        """Human-readable key for the EXPLAIN ANALYZE footer / tests:
        ``planhash@v:catalog.table=NN,...``."""
        planhash, vvec = key
        return planhash + "@v:" + ",".join(f"{t}={v}" for t, v in vvec)

    # ------------------------------------------------------------ admission
    def admissible(self, planhash: str, min_recurrences: int) -> bool:
        """History-driven admission: cache only plans whose signature
        already recurred ``min_recurrences`` times in the history store —
        one-off queries never displace the hot set."""
        if min_recurrences <= 0:
            return True
        if self.history is None:
            return False
        n = 0
        for rec in self.history.list(limit=1000):
            if rec.get("planhash") == planhash:
                n += 1
                if n >= min_recurrences:
                    return True
        return False

    # --------------------------------------------------------------- lookup
    def lookup(self, key: tuple, ttl_s: float = 0.0):
        """(rows, columns) on a valid hit, else None.  A same-planhash entry
        under a DIFFERENT version vector is stale — the table moved under it
        (e.g. an external Iceberg commit) — and is dropped as a typed
        ``invalidated`` event, not silently aged out."""
        planhash, _ = key
        now = time.time()
        with self._lock:
            stale = [
                k for k in self._by_hash.get(planhash, ()) if k != key
            ]
            for k in stale:
                self._drop(k)
                _CACHE_EVENTS.labels("invalidated").inc()
            e = self._entries.get(key)
            if e is None:
                return None
            if ttl_s and now - e.created > ttl_s:
                self._drop(key)
                _CACHE_EVENTS.labels("evicted").inc()
                return None
            e.last_hit = now
            e.hits += 1
            self._entries.move_to_end(key)
            return e.rows, e.columns

    def store(self, key: tuple, rows, columns) -> None:
        nbytes = _estimate_bytes(columns, rows)
        if nbytes > self.max_bytes:
            return  # one oversized result would evict the whole hot set
        planhash, vvec = key
        with self._lock:
            if key in self._entries:
                self._drop(key)
            self._entries[key] = _Entry(rows, columns, nbytes)
            self._bytes += nbytes
            self._by_hash.setdefault(planhash, set()).add(key)
            for table, _v in vvec:
                self._by_table.setdefault(table, set()).add(key)
            while self._bytes > self.max_bytes and len(self._entries) > 1:
                old_key = next(iter(self._entries))  # LRU end of the ring
                if old_key == key:
                    break  # never evict the entry being stored
                self._drop(old_key)
                _CACHE_EVENTS.labels("evicted").inc()
            _CACHE_BYTES.set(self._bytes)

    def _drop(self, key: tuple) -> None:
        """Unlink one entry from the ring and both indexes (lock held)."""
        e = self._entries.pop(key, None)
        if e is None:
            return
        self._bytes -= e.nbytes
        planhash, vvec = key
        self._by_hash.get(planhash, set()).discard(key)
        if not self._by_hash.get(planhash):
            self._by_hash.pop(planhash, None)
        for table, _v in vvec:
            self._by_table.get(table, set()).discard(key)
            if not self._by_table.get(table):
                self._by_table.pop(table, None)
        _CACHE_BYTES.set(self._bytes)

    # ---------------------------------------------------------- invalidation
    def invalidate_table(self, catalog: str, table: str) -> int:
        """Typed invalidation: drop every entry whose version vector
        references ``catalog.table`` (DML through runtime/dml.py, engine
        write statements, Iceberg commits).  Returns entries dropped."""
        tkey = f"{catalog}.{table}"
        with self._lock:
            keys = list(self._by_table.get(tkey, ()))
            for k in keys:
                self._drop(k)
            if keys:
                _CACHE_EVENTS.labels("invalidated").inc(len(keys))
            return len(keys)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._by_hash.clear()
            self._by_table.clear()
            self._bytes = 0
            _CACHE_BYTES.set(0)

    # --------------------------------------------------------- in-flight dedup
    def begin(self, key: tuple):
        """(is_leader, inflight).  The leader executes and MUST call
        ``finish``; followers wait on ``inflight.event`` and reuse its rows
        — two identical concurrent queries cost one execution (the
        exec/compilesvc.py per-signature dedup idiom)."""
        with self._lock:
            fl = self._inflight.get(key)
            if fl is None:
                fl = _Inflight()
                self._inflight[key] = fl
                return True, fl
            return False, fl

    def finish(self, key: tuple, fl: _Inflight, rows=None, columns=None) -> None:
        """Leader hand-off: publish rows (None on failure) and wake every
        follower.  Always runs — a leader that failed must not wedge its
        followers."""
        with self._lock:
            if self._inflight.get(key) is fl:
                del self._inflight[key]
        fl.rows = rows
        fl.columns = columns
        fl.event.set()

    # ------------------------------------------------------------ inspection
    def entries_for_table(self, catalog: str, table: str) -> int:
        """Warm-entry count for ``catalog.table`` — the write plane's
        exactly-once invalidation contract (invalidate at the commit point,
        never on abort) is asserted against this in tests: a FAILED write
        must leave the count unchanged."""
        with self._lock:
            return len(self._by_table.get(f"{catalog}.{table}", ()))

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "inflight": len(self._inflight),
            }


class _MemoEntry:
    __slots__ = ("task_ids", "vvec", "tables", "spool_dir", "created")

    def __init__(self, task_ids, vvec, tables, spool_dir) -> None:
        self.task_ids = task_ids  # part -> memo task id (spool dir name)
        self.vvec = vvec
        self.tables = tables  # {"catalog.table", ...}
        self.spool_dir = spool_dir
        self.created = time.time()


class FragmentMemo:
    """Shared subplan memoization over the spooled exchange.

    A *memoizable* fragment is a leaf (no exchange inputs) whose subtree is
    only TableScan/Filter/Project — the common scan+filter prefix of
    concurrent dashboard queries — over versioned, non-time-travel tables.
    A Compact over such a subtree is memoizable too: the optimizer wraps
    every filter of a table past 65,536 estimated rows in one, and it only
    gathers the live rows (the JAX package's memo declines it, so no
    filtered scan of a large table is ever reused there).
    Its key hashes the fragment plan JSON, the output partitioning
    (kind/keys/fan-in/fan-out) and the version vector, so a reused dir is
    bit-compatible with the consumer that reads it."""

    def __init__(self, capacity: int = 32):
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, _MemoEntry]" = OrderedDict()

    # ------------------------------------------------------------------ key
    @staticmethod
    def fragment_key(frag, payload_base: dict, catalogs):
        """(key, vvec, tables) for a memoizable fragment, else None.
        ``payload_base`` is the coordinator's already-built task payload —
        fragment JSON and output partitioning come from it verbatim, so the
        hash covers exactly what a consumer task would observe."""
        from ..plan.nodes import Compact, Filter, Project, TableScan, walk

        if frag.inputs or frag.output_kind == "result":
            return None
        nodes = list(walk(frag.root))
        if not any(isinstance(n, TableScan) for n in nodes):
            return None
        if not all(isinstance(n, (TableScan, Filter, Project, Compact)) for n in nodes):
            return None
        vvec = plan_version_vector(frag.root, catalogs)
        if not vvec:  # None (time-travel) or empty (no scans)
            return None
        blob = json.dumps(
            [
                payload_base.get("fragment"),
                payload_base.get("output_kind"),
                payload_base.get("output_keys"),
                payload_base.get("num_parts"),
                payload_base.get("out_parts"),
                list(vvec),
            ],
            sort_keys=True,
            default=str,
        )
        key = hashlib.sha1(blob.encode()).hexdigest()[:16]
        tables = {t for t, _v in vvec}
        return key, vvec, tables

    @staticmethod
    def task_id(key: str, part: int) -> str:
        return f"{MEMO_PREFIX}_{key}_p{part}"

    # --------------------------------------------------------------- lookup
    def lookup(self, key: str, vvec, num_parts: int, spool):
        """{part -> memo task id} when every part's spool dir is still
        committed under the current version vector, else None (a swept or
        stale entry is dropped — trust the disk, not the map)."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return None
            if e.vvec != vvec or len(e.task_ids) != num_parts:
                self._unlink(key, remove_dirs=True)
                return None
            if not all(spool.is_committed(t) for t in e.task_ids.values()):
                self._unlink(key, remove_dirs=True)  # GC swept part of it
                return None
            self._entries.move_to_end(key)
            return dict(e.task_ids)

    # -------------------------------------------------------------- adoption
    def adopt(self, key: str, vvec, tables, parts: dict, spool) -> bool:
        """Rename a finished query's committed fragment dirs into the memo
        namespace and register the entry.  First query wins per dir
        (``os.rename`` onto an existing dir fails): a loser's un-renamed
        dirs die with its remove_query, and the winner's entry stands."""
        ids = {}
        for p, tid in parts.items():
            memo_tid = self.task_id(key, p)
            if not spool.adopt(tid, memo_tid) and not spool.is_committed(
                memo_tid
            ):
                return False  # neither ours nor a winner's: bail
            ids[p] = memo_tid
        with self._lock:
            self._entries[key] = _MemoEntry(ids, vvec, tables, spool.dir)
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._unlink(next(iter(self._entries)), remove_dirs=True)
        return True

    # ---------------------------------------------------------- invalidation
    def invalidate_table(self, catalog: str, table: str) -> int:
        """Drop (and delete the spool dirs of) every memo entry reading
        ``catalog.table`` — rides the same typed DML hooks as ResultCache."""
        tkey = f"{catalog}.{table}"
        with self._lock:
            keys = [k for k, e in self._entries.items() if tkey in e.tables]
            for k in keys:
                self._unlink(k, remove_dirs=True)
            return len(keys)

    def _unlink(self, key: str, remove_dirs: bool) -> None:
        e = self._entries.pop(key, None)
        if e is None or not remove_dirs:
            return
        for tid in e.task_ids.values():
            shutil.rmtree(os.path.join(e.spool_dir, tid), ignore_errors=True)

    def clear(self) -> None:
        with self._lock:
            for k in list(self._entries):
                self._unlink(k, remove_dirs=True)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @staticmethod
    def count(event: str, n: int = 1) -> None:
        _MEMO_EVENTS.labels(event).inc(n)
