"""The port's result cache and fragment memo (runtime/resultcache.py and the
coordinator's side of it): ports of the 24 cases of tests/test_result_cache.py,
every node on the CPU.

Hit / miss / eviction, typed DML invalidation (DELETE / UPDATE / INSERT / MERGE
and Iceberg commits), time travel and non-deterministic bypass, admission by
recurrences, the in-flight dedup race (one execution), fragment memoization
against the uncached run, and the cold restart.  "Executed" and "served" are
proven by what ran, beside the connector reads the reference counts: a
worker's scan cache serves a repeated scan without a read, so the tests also
count the scans each task runs (`scans`, a wrapper of
`LocalExecutor.table_page`) and the tasks the coordinator scheduled (`tasks`,
a wrapper of `Worker.submit_task`).
"""

import threading
import time

import numpy as np
import pytest

try:  # arrow and its parquet writer before torch: the Iceberg cases write
    import pyarrow  # noqa: F401    Parquet from coordinator threads
    import pyarrow.parquet  # noqa: F401
except ImportError:
    pass
import torch

from trino_tpu_torch.connectors.memory import MemoryConnector
from trino_tpu_torch.connectors.spi import ColumnSchema
from trino_tpu_torch.data.types import BIGINT
from trino_tpu_torch.exec.compiler import LocalExecutor
from trino_tpu_torch.runtime.resultcache import (
    FragmentMemo, ResultCache, has_nondeterministic,
)
from trino_tpu_torch.runtime.worker import Worker
from trino_tpu_torch.testing import DistributedQueryRunner

pytestmark = pytest.mark.smoke

torch.set_num_threads(1)


# ------------------------------------------------------------------ helpers


class CountingMemoryConnector(MemoryConnector):
    """Counts read_split calls per table and can block reads on a gate for
    deterministic concurrency tests."""

    def __init__(self):
        super().__init__()
        self.reads: dict[str, int] = {}
        self.gate = threading.Event()
        self.gate.set()
        self._rlock = threading.Lock()

    def read_split(self, split, columns):
        with self._rlock:
            self.reads[split.table] = self.reads.get(split.table, 0) + 1
        assert self.gate.wait(timeout=60), "test gate never opened"
        return super().read_split(split, columns)


def make_table():
    """`t` (k bigint, v bigint): k = 0..99, v = (k % 7) * 10."""
    conn = CountingMemoryConnector()
    conn.create_table("t", [ColumnSchema("k", BIGINT), ColumnSchema("v", BIGINT)])
    conn.insert("t", {
        "k": np.arange(100, dtype=np.int64),
        "v": (np.arange(100, dtype=np.int64) % 7) * 10,
    })
    return conn


@pytest.fixture
def scans(monkeypatch):
    """Scans run per table, counted at the executor (the recompute witness:
    a worker's scan cache may serve a repeated scan without a read)."""
    counts: dict[str, int] = {}
    lock = threading.Lock()
    plain = LocalExecutor.table_page

    def counted(self, catalog, table, *args, **kwargs):
        with lock:
            counts[table] = counts.get(table, 0) + 1
        return plain(self, catalog, table, *args, **kwargs)

    monkeypatch.setattr(LocalExecutor, "table_page", counted)
    return counts


@pytest.fixture
def tasks(monkeypatch):
    """Task ids every worker accepted, in order (a hit schedules none)."""
    seen: list[str] = []
    lock = threading.Lock()
    plain = Worker.submit_task

    def counted(self, req):
        with lock:
            seen.append(req["task_id"])
        return plain(self, req)

    monkeypatch.setattr(Worker, "submit_task", counted)
    return seen


def start_cluster(conn, catalog="memory", device="cpu", **kw):
    """A started cluster of two workers on `device` over `conn`, every
    result admitted at its first run."""
    r = DistributedQueryRunner(
        device=device, num_workers=2, default_catalog=catalog, **kw
    )
    r.register_catalog(catalog, conn)
    r.start()
    r.coordinator.session.set("result_cache_min_recurrences", "0")
    r.conn = conn
    return r


@pytest.fixture()
def runner():
    r = start_cluster(make_table())
    yield r
    r.stop()


def _run(runner, sql):
    """Submit through the managed path and return (rows, record): the record
    carries the cached flag and the cache disposition."""
    coord = runner.coordinator
    qid = coord.submit_query(sql)
    rec = coord.queries[qid]
    assert rec["done"].wait(timeout=120), "query never finished"
    assert rec["sm"].state == "FINISHED", rec["sm"].error
    return rec["result"], rec


def _memo_session(coord, tmp_path):
    coord.session.set("retry_policy", "TASK")
    coord.session.set("exchange_spool_dir", str(tmp_path / "spool"))
    # partitioned join: BOTH scan sides become leaf scan+filter fragments
    coord.session.set("join_distribution_type", "PARTITIONED")
    # admission never opens: every run re-executes, so the second run's
    # reuse can only come from the fragment memo
    coord.session.set("result_cache_min_recurrences", "99")


SQL = "select v, count(*) from t group by v order by v"
EXPECTED = [(v * 10, int(((np.arange(100) % 7) == v).sum())) for v in range(7)]
JOIN_SQL = "select sum(a.v + b.v) from t a, t b where a.k = b.k and b.k < 50"

# The statements of this file in one sequence over `t` and TPC-H, each read
# twice where the second may hit: chip_smoke.py runs it on a card cluster
# against a CPU cluster (rows and dispositions step by step).
CROSS_STEPS = (
    SQL, SQL,
    "select k from t where k < 5 order by k", "SELECT k FROM t WHERE k < 5 ORDER BY k",
    "select count(*) from t where random() < 2.0", "select count(*) from t where random() < 2.0",
    "select count(*) from t", "select count(*) from t",
    "delete from t where k < 10", "select count(*) from t", "select count(*) from t",
    "select sum(v) from t", "update t set v = 0 where k >= 90", "select sum(v) from t",
    "insert into t values (1000, 1)", "select count(*) from t", "select count(*) from t",
    "create table s (k bigint, v bigint)", "insert into s values (10, 999), (11, 999)",
    "select max(v) from t",
    "merge into t using s on t.k = s.k when matched then update set v = s.v",
    "select max(v) from t", "select max(v) from t",
    JOIN_SQL, JOIN_SQL, "select min(k), max(k) from t",
    "select count(*), sum(l_quantity) from tpch.lineitem where l_discount > 0.05",
    "select count(*), sum(l_quantity) from tpch.lineitem where l_discount > 0.05",
)


# ---------------------------------------------------------- hit/miss basics


def test_second_identical_query_hits(runner, scans, tasks):
    rows1, rec1 = _run(runner, SQL)
    reads1, scans1, tasks1 = dict(runner.conn.reads), dict(scans), len(tasks)
    assert scans1.get("t") and tasks1
    rows2, rec2 = _run(runner, SQL)
    assert not rec1.get("cached")
    assert rec2.get("cached") is True
    assert rows2 == rows1 == EXPECTED
    # a hit runs NOTHING on the cluster: no read, no scan, no task, no stage
    assert runner.conn.reads == reads1
    assert scans == scans1 and len(tasks) == tasks1
    assert rec2["query_info"]["stage_count"] == 0
    assert rec2["query_info"]["cache"]["disposition"] == "hit"
    # hits still reach the history store (admission feeds on recurrences)
    hist = [
        h for h in runner.coordinator.history.list(limit=10)
        if h.get("query_id") == rec2["sm"].query_id
    ]
    assert hist and hist[0].get("cached") is True


def test_textually_different_equivalent_plans_share_entry(runner, tasks):
    _run(runner, "select k from t where k < 5 order by k")
    n = len(tasks)
    rows, rec = _run(runner, "SELECT k FROM t WHERE k < 5 ORDER BY k")
    assert rec.get("cached") is True and len(tasks) == n
    assert rows == [(i,) for i in range(5)]


def test_disabled_session_property_bypasses(runner, scans):
    _run(runner, SQL)
    runner.coordinator.session.set("result_cache_enabled", "false")
    before = scans.get("t", 0)
    rows, rec = _run(runner, SQL)
    assert not rec.get("cached")
    assert scans.get("t", 0) > before and rows == EXPECTED


# ------------------------------------------------------- typed invalidation


def test_delete_invalidates(runner, scans):
    rows1, _ = _run(runner, "select count(*) from t")
    assert rows1 == [(100,)]
    _run(runner, "delete from t where k < 10")
    before = scans.get("t", 0)
    rows2, rec2 = _run(runner, "select count(*) from t")
    assert not rec2.get("cached") and scans.get("t", 0) > before
    assert rows2 == [(90,)]


def test_update_invalidates(runner, scans):
    rows1, _ = _run(runner, "select sum(v) from t")
    _run(runner, "update t set v = 0 where k >= 0")
    before = scans.get("t", 0)
    rows2, rec2 = _run(runner, "select sum(v) from t")
    assert not rec2.get("cached") and scans.get("t", 0) > before
    assert rows2 == [(0,)]
    assert rows2 != rows1


def test_merge_invalidates(runner, scans):
    runner.conn.create_table("s", [ColumnSchema("k", BIGINT), ColumnSchema("v", BIGINT)])
    runner.conn.insert("s", {
        "k": np.arange(5, dtype=np.int64),
        "v": np.full(5, 999, dtype=np.int64),
    })
    rows1, _ = _run(runner, "select max(v) from t")
    assert rows1 == [(60,)]
    _run(runner, "merge into t using s on t.k = s.k when matched then update set v = s.v")
    before = scans.get("t", 0)
    rows2, rec2 = _run(runner, "select max(v) from t")
    assert not rec2.get("cached") and scans.get("t", 0) > before
    assert rows2 == [(999,)]


def test_insert_invalidates(runner, scans):
    _run(runner, "select count(*) from t")
    _run(runner, "insert into t values (1000, 1)")
    before = scans.get("t", 0)
    rows, rec = _run(runner, "select count(*) from t")
    assert not rec.get("cached") and scans.get("t", 0) > before
    assert rows == [(101,)]


# ------------------------------------------ snapshot versioning (iceberg)


def _iceberg_runner(tmp_path, journal=False):
    from trino_tpu_torch.connectors.iceberg import IcebergConnector

    return start_cluster(
        IcebergConnector(str(tmp_path / "wh")), catalog="iceberg",
        journal_path=(str(tmp_path / "journal.jsonl") if journal else None),
    )


def test_external_iceberg_commit_invalidates(tmp_path, tasks):
    """A commit that never touched the engine (an external writer moving the
    snapshot id) is caught by the version vector at lookup, not by TTL."""
    r = _iceberg_runner(tmp_path)
    try:
        _run(r, "create table ice (k bigint)")
        _run(r, "insert into ice values (1), (2)")
        rows1, _ = _run(r, "select count(*) from ice")
        n = len(tasks)
        _, rec = _run(r, "select count(*) from ice")
        assert rec.get("cached") is True and rows1 == [(2,)] and len(tasks) == n
        # external commit: straight through the connector, no engine hook
        r.conn.insert("ice", {"k": np.array([3], dtype=np.int64)})
        rows2, rec2 = _run(r, "select count(*) from ice")
        assert not rec2.get("cached") and len(tasks) > n
        assert rows2 == [(3,)]
    finally:
        r.stop()


def test_time_travel_bypasses(tmp_path):
    r = _iceberg_runner(tmp_path)
    try:
        _run(r, "create table ice (k bigint)")
        _run(r, "insert into ice values (1)")
        _run(r, "insert into ice values (2), (3)")
        for _ in range(2):
            rows, rec = _run(r, 'select k from "ice@2" order by k')
            assert rows == [(1,)]
            assert not rec.get("cached")
            assert rec["cache"]["disposition"] == "bypass"
    finally:
        r.stop()


# ------------------------------------------------- non-determinism bypass


def test_nondeterministic_bypasses(runner):
    # random() < 2.0 is always true: a deterministic RESULT, but the call makes
    # the statement uncacheable (folded at plan time, so only the AST shows it)
    for _ in range(2):
        rows, rec = _run(runner, "select count(*) from t where random() < 2.0")
        assert rows == [(100,)]
        assert not rec.get("cached")
        assert rec["cache"]["disposition"] == "bypass"
        assert rec["cache"]["reason"] == "nondeterministic"


def test_has_nondeterministic_on_ast():
    from trino_tpu_torch.sql import statements as S

    det = S.parse_statement("select k + 1 from t where k < 3")
    rnd = S.parse_statement("select k from t where random() < 0.5")
    assert not has_nondeterministic(det.query)
    assert has_nondeterministic(rnd.query)


# --------------------------------------------------- history-driven admission


def test_admission_threshold(runner, tasks):
    runner.coordinator.session.set("result_cache_min_recurrences", "3")
    sql = "select min(k), max(k) from t"
    # run N sees N-1 history records for the signature: runs 1-4 execute
    # (admission opens at run 4, which stores), run 5 is the first hit
    for i in range(4):
        n = len(tasks)
        _, rec = _run(runner, sql)
        assert not rec.get("cached"), f"run {i + 1} cached too early"
        assert len(tasks) > n
    n = len(tasks)
    rows, rec = _run(runner, sql)
    assert rec.get("cached") is True and len(tasks) == n
    assert rows == [(0, 99)]


# ------------------------------------------------------ eviction / TTL (unit)


def test_lru_eviction_under_bytes_budget():
    rows = [("x" * 100,)]  # one entry estimates to 64 + 24 + 48 + 16 + 100
    c = ResultCache(max_bytes=2 * 252 + 50)  # room for two entries, not three
    k1 = ("h1", (("m.t", 0),))
    k2 = ("h2", (("m.t", 0),))
    k3 = ("h3", (("m.t", 0),))
    c.store(k1, rows, ["c"])
    c.store(k2, rows, ["c"])
    assert c.lookup(k1) is not None  # k1 now MRU
    c.store(k3, rows, ["c"])  # over budget: k2 (LRU) goes
    assert c.lookup(k2) is None
    assert c.lookup(k1) is not None
    assert c.lookup(k3) is not None


def test_ttl_expiry_and_oversized_store():
    c = ResultCache(max_bytes=10_000)
    key = ("h", (("m.t", 0),))
    c.store(key, [(1,)], ["c"])
    e = c._entries[key]
    e.created -= 100.0  # age it past any ttl
    assert c.lookup(key, ttl_s=1.0) is None
    # a single result larger than the whole budget is never stored
    c.store(("big", ()), [("y" * 20_000,)], ["c"])
    assert c.lookup(("big", ())) is None


def test_stale_version_vector_dropped_as_invalidated():
    c = ResultCache(max_bytes=10_000)
    old = ("h", (("m.t", 1),))
    new = ("h", (("m.t", 2),))
    c.store(old, [(1,)], ["c"])
    assert c.lookup(new) is None  # same planhash, moved table: drops old
    assert c.lookup(old) is None


def test_invalidate_table_unit():
    c = ResultCache(max_bytes=10_000)
    c.store(("h1", (("m.t", 1),)), [(1,)], ["c"])
    c.store(("h2", (("m.u", 1),)), [(2,)], ["c"])
    assert c.invalidate_table("m", "t") == 1
    assert c.lookup(("h1", (("m.t", 1),))) is None
    assert c.lookup(("h2", (("m.u", 1),))) is not None


# ------------------------------------------------------- in-flight dedup race


def test_concurrent_identical_queries_execute_once(runner, scans, tasks):
    coord = runner.coordinator
    # baseline: reads, scans and tasks of one full execution
    _run(runner, SQL)
    reads_per_exec = sum(runner.conn.reads.values())
    scans_per_exec = sum(scans.values())
    tasks_per_exec = len(tasks)
    coord.result_cache.clear()
    # the workers' scan caches would serve the leader's scan without a read,
    # and the gate below would then hold nothing
    for w in runner.workers:
        w.scan_cache.drop_device()
    runner.conn.reads.clear()
    scans.clear()
    del tasks[:]

    runner.conn.gate.clear()  # block execution mid-scan
    q1 = coord.submit_query(SQL)
    r1 = coord.queries[q1]
    # wait until the leader is actually executing (a read arrived)
    deadline = time.monotonic() + 30
    while not runner.conn.reads.get("t") and time.monotonic() < deadline:
        time.sleep(0.02)
    assert runner.conn.reads.get("t"), "the leader never reached its scan"
    q2 = coord.submit_query(SQL)
    r2 = coord.queries[q2]
    runner.conn.gate.set()
    assert r1["done"].wait(timeout=120) and r2["done"].wait(timeout=120)
    assert r1["sm"].state == "FINISHED", r1["sm"].error
    assert r2["sm"].state == "FINISHED", r2["sm"].error
    assert r1["result"] == r2["result"] == EXPECTED
    # exactly ONE execution: its reads, scans and tasks; one record is a hit
    assert sum(runner.conn.reads.values()) == reads_per_exec
    assert sum(scans.values()) == scans_per_exec
    assert len(tasks) == tasks_per_exec
    assert [bool(r1.get("cached")), bool(r2.get("cached"))].count(True) == 1


# ------------------------------------------------------- fragment memoization


def _join_expected(deleted=()):
    """numpy's answer to JOIN_SQL over `t` less the keys `deleted`."""
    k = np.arange(100, dtype=np.int64)
    v = (k % 7) * 10
    live = (k < 50) & ~np.isin(k, list(deleted))
    return [(int(2 * v[live].sum()),)]


def test_fragment_memo_reuses_leaf_scans(tmp_path, scans):
    conn = make_table()
    r = start_cluster(conn)
    coord = r.coordinator
    _memo_session(coord, tmp_path)
    try:
        rows1, rec1 = _run(r, JOIN_SQL)
        assert rows1 == _join_expected()
        assert rec1.get("memo_misses", 0) >= 1
        assert len(coord.fragment_memo) >= 1
        reads1, scans1 = sum(conn.reads.values()), scans.get("t", 0)
        rows2, rec2 = _run(r, JOIN_SQL)
        assert rows2 == rows1
        assert rec2.get("memo_hits", 0) >= 1
        # memoized leaf fragments re-read the spool: no read and no scan
        assert sum(conn.reads.values()) == reads1
        assert scans.get("t", 0) == scans1
        # oracle: same rows with the whole plane off
        coord.session.set("result_cache_enabled", "false")
        rows3, _ = _run(r, JOIN_SQL)
        assert rows3 == rows1
        assert scans.get("t", 0) > scans1
    finally:
        r.stop()


def test_fragment_memo_invalidated_by_dml(tmp_path, scans):
    conn = make_table()
    r = start_cluster(conn)
    _memo_session(r.coordinator, tmp_path)
    try:
        rows1, _ = _run(r, JOIN_SQL)
        _run(r, "delete from t where k = 1")
        before = scans.get("t", 0)
        rows2, rec2 = _run(r, JOIN_SQL)
        assert not rec2.get("memo_hits")  # version vector moved
        assert scans.get("t", 0) > before
        assert rows2 != rows1
        assert rows2 == _join_expected(deleted=[1])
    finally:
        r.stop()


def test_fragment_memo_reuses_a_filtered_scan_of_a_large_table(tmp_path, scans):
    """Repair: a filter over a table past the optimizer's 65,536-row Compact
    threshold is wrapped in a Compact, and the memo declined such a leaf,
    so no filtered scan of a large table was ever reused.  Both leaves of
    the join hit the memo on the second run, and run no scan."""
    from trino_tpu_torch.plan.optimizer import _COMPACT_MIN_SRC

    n = _COMPACT_MIN_SRC + 1000
    conn = CountingMemoryConnector()
    conn.create_table("big", [ColumnSchema("k", BIGINT), ColumnSchema("v", BIGINT)])
    k = np.arange(n, dtype=np.int64)
    conn.insert("big", {"k": k, "v": k % 13})
    r = start_cluster(conn)
    _memo_session(r.coordinator, tmp_path)
    sql = "select count(*), sum(a.v) from big a, big b where a.k = b.k and b.v < 3"
    want = [(int((k % 13 < 3).sum()), int((k % 13)[k % 13 < 3].sum()))]
    try:
        rows1, rec1 = _run(r, sql)
        assert rows1 == want
        assert rec1.get("memo_misses", 0) == 2
        before = scans.get("big", 0)
        rows2, rec2 = _run(r, sql)
        assert rows2 == want
        assert rec2.get("memo_hits", 0) == 2
        assert scans.get("big", 0) == before
    finally:
        r.stop()


def test_fragment_key_rejects_non_leaf():
    class Frag:
        inputs = [1]
        output_kind = "hash"
        root = None

    assert FragmentMemo.fragment_key(Frag(), {}, None) is None


# ------------------------------------------- crash-restart cold-cache contract


def test_restart_never_serves_pre_crash_snapshot(tmp_path):
    """The cache is never journaled.  A coordinator that cached a result,
    died, and missed an external snapshot advance comes up cold and
    re-executes: the pre-crash rows would be stale."""
    r = _iceberg_runner(tmp_path, journal=True)
    try:
        _run(r, "create table ice (k bigint)")
        _run(r, "insert into ice values (1), (2)")
        rows1, _ = _run(r, "select count(*) from ice")
        _, rec = _run(r, "select count(*) from ice")
        assert rec.get("cached") is True and rows1 == [(2,)]

        port = r.kill_coordinator()
        # snapshot advances while the coordinator is down
        r.conn.insert("ice", {"k": np.array([3, 4], dtype=np.int64)})
        r.restart_coordinator(port)
        r.coordinator.session.set("result_cache_min_recurrences", "0")

        rows2, rec2 = _run(r, "select count(*) from ice")
        assert not rec2.get("cached"), "restarted coordinator served stale"
        assert rows2 == [(4,)]
        assert r.coordinator.result_cache.stats()["entries"] <= 1
    finally:
        r.stop()


# ----------------------------------------------------------- cache chaos tier


def test_chaos_no_stale_reads_under_dml_and_failures(tmp_path):
    """A hot cached query interleaved with DML, a worker kill, and a
    coordinator restart never returns a stale row count."""
    conn = make_table()
    r = start_cluster(
        conn, heartbeat_interval=0.2, journal_path=str(tmp_path / "journal.jsonl"),
    )
    coord = r.coordinator
    coord.session.set("retry_policy", "TASK")
    coord.session.set("exchange_spool_dir", str(tmp_path / "spool"))
    sql = "select count(*) from t"
    expected = 100
    try:
        for _ in range(2):  # warm + hit
            rows, _ = _run(r, sql)
            assert rows == [(expected,)]

        _run(r, "delete from t where k < 10")
        expected -= 10
        rows, rec = _run(r, sql)
        assert rows == [(expected,)] and not rec.get("cached")

        r.kill_worker(0)  # cached entries must survive OR re-execute right
        rows, _ = _run(r, sql)
        assert rows == [(expected,)]

        _run(r, "insert into t values (2000, 1), (2001, 2)")
        expected += 2
        rows, rec = _run(r, sql)
        assert rows == [(expected,)] and not rec.get("cached")

        port = r.kill_coordinator()
        conn.truncate("t")  # external mutation while the coordinator is down
        expected = 0
        r.restart_coordinator(port)
        r.coordinator.session.set("result_cache_min_recurrences", "0")
        # the replacement coordinator re-learns liveness from heartbeats;
        # wait for the detector to quarantine the worker killed above so
        # scheduling lands on the survivor
        dead = r.workers[0].url
        deadline = time.time() + 15
        while dead in r.coordinator.alive_workers() and time.time() < deadline:
            time.sleep(0.05)
        assert dead not in r.coordinator.alive_workers(), "killed worker never quarantined"
        rows, rec = _run(r, sql)
        assert rows == [(expected,)], "stale read after restart"
        assert not rec.get("cached")
    finally:
        r.stop()


# ------------------------------------------------------ observability surface


def test_explain_analyze_cache_footer(runner):
    _run(runner, SQL)
    _run(runner, SQL)  # second: the plain query would hit
    rows, _ = _run(runner, f"explain analyze {SQL}")
    text = "\n".join(r[0] for r in rows)
    assert "-- cache: hit" in text
    assert "key=" in text


def test_metrics_families_present(runner):
    import urllib.request

    _run(runner, SQL)
    _run(runner, SQL)
    with urllib.request.urlopen(f"{runner.coordinator.url}/metrics", timeout=10) as resp:
        body = resp.read().decode()
    assert 'trino_tpu_result_cache_events_total{event="hit"}' in body
    assert "trino_tpu_result_cache_bytes" in body
    assert "trino_tpu_fragment_memo_events_total" in body
