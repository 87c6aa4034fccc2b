"""The port's split-driven scan execution (runtime/splits.py); ports of the
15 cases of tests/test_splits.py, every node on the CPU: morsel enumeration,
lazy scheduling with bounded per-worker queues, split-level retry and
straggler stealing, memory-revocation parking, and the scale-invariance
promise — data size moves the split COUNT, never the compiled shapes.

Reference behaviors being matched:
- SourcePartitionedScheduler's lazy split queueing + bounded node queues
  (execution/scheduler/SourcePartitionedScheduler.java);
- FTE retry one level finer: a lost morsel is re-assigned ALONE, and a
  spool-COMMITTED morsel is re-served, never re-read (the exactly-once
  proof here is a literal connector read count);
- the pow2 capacity-bucketing signature collapse (ROADMAP): the same
  query at two data scales executes the same NUMBER of plan signatures
  (`utils/profiler.signature_of(plan, caps)`; the port compiles no jit
  program, so the executed signatures stand in for the reference's jit
  signatures).

Two repairs of the port close the file: a worker's scan cache no longer
holds its lock across a connector read.
"""

import os
import threading
import time

import numpy as np
import pytest

from tests.tpch_queries import QUERIES
try:  # arrow before torch: loaded after it, arrow's parquet writer crashes the process
    import pyarrow  # noqa: F401
except ImportError:
    pass
import torch

from trino_tpu_torch.connectors.memory import MemoryConnector
from trino_tpu_torch.connectors.spi import CatalogManager, ColumnSchema
from trino_tpu_torch.data.types import BIGINT
from trino_tpu_torch.plan.nodes import TableScan
from trino_tpu_torch.runtime.splits import (
    SplitScheduler,
    current_backlog,
    scan_split_plan,
)
from trino_tpu_torch.testing import DistributedQueryRunner
from trino_tpu_torch.utils.profiler import PROFILER

pytestmark = pytest.mark.smoke


# ---------------------------------------------------------------- helpers


def _wait(pred, timeout=30.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return bool(pred())


def _committed_dirs(spool_dir):
    if not os.path.isdir(spool_dir):
        return []
    return [n for n in os.listdir(spool_dir)
            if os.path.exists(os.path.join(spool_dir, n, "COMMITTED"))]


def _split_info(coord):
    """The `splits` block of the most recent query that had one."""
    out = None
    for rec in coord.queries.values():
        qi = rec.get("query_info") or {}
        if qi.get("splits"):
            out = qi["splits"]
    return out


def _cluster(tmp_path, conn, catalog="memory", workers=2, **session):
    runner = DistributedQueryRunner(
        device="cpu", num_workers=workers, default_catalog=catalog, heartbeat_interval=0.2,
    )
    runner.register_catalog(catalog, conn)
    runner.start()
    s = runner.coordinator.session
    s.set("retry_policy", "TASK")
    s.set("exchange_spool_dir", str(tmp_path / "spool"))
    s.set("split_driven_scans", "true")
    for k, v in session.items():
        s.set(k, str(v))
    return runner


def _sched(n, depth=2, parked=None):
    s = SplitScheduler(n, queue_depth=depth, is_parked=parked)
    for p in range(n):
        s.add(p)
    return s


# ------------------------------------------------- scheduler unit behavior


def test_assign_bounded_queues_least_loaded():
    s = _sched(10, depth=2)
    got = s.assign(["w0", "w1"])
    # 2 workers x depth 2: the queue bound, not the pool size, is the cap
    assert len(got) == 4
    assert {w for _, w in got} == {"w0", "w1"}
    assert s.backlog() == 6
    # a full cluster assigns nothing more until a slot frees
    assert s.assign(["w0", "w1"]) == []
    p0, w0 = got[0]
    s.on_done(p0)
    more = s.assign(["w0", "w1"])
    assert len(more) == 1 and more[0][1] == w0  # exactly the freed slot
    s.close()
    assert s.backlog() == 0


def test_backlog_is_process_wide_and_released_on_close():
    base = current_backlog()
    s = _sched(5, depth=1)
    assert current_backlog() == base + 5
    s.assign(["w0"])  # one split in flight, four still queued
    assert current_backlog() == base + 4
    s.close()
    assert current_backlog() == base


def test_parked_worker_splits_wait_instead_of_resliced():
    parked = {"w0"}
    s = _sched(4, depth=2, parked=lambda u: u in parked)
    got = s.assign(["w0", "w1"])
    # the revoked worker gets NOTHING; its share waits in the pool
    assert len(got) == 2 and all(w == "w1" for _, w in got)
    assert s.backlog() == 2
    assert s.stats["parked"] == 1
    parked.clear()  # lease re-granted: the parked splits drain normally
    got2 = s.assign(["w0", "w1"])
    assert len(got2) == 2 and all(w == "w0" for _, w in got2)
    s.close()


def test_retry_reassigns_single_split_away_from_failure():
    s = _sched(2, depth=2)
    owners = dict(s.assign(["w0", "w1"]))
    p = next(p for p, w in owners.items() if w == "w0")
    assert s.retry(p, ["w0", "w1"], exclude="w0") == "w1"
    assert s.stats["retries"] == 1
    # sole survivor: the excluded worker is still better than nothing
    assert s.retry(p, ["w1"], exclude="w1") == "w1"
    s.close()


def test_steal_requires_dry_pool_and_is_once_per_split():
    s = _sched(3, depth=2)
    assigned = dict(s.assign(["w0"]))  # w0 full (2), one split queued
    assert s.steal(["w0", "w1"]) is None  # pool not dry: assign, don't steal
    more = s.assign(["w0", "w1"])
    assert len(more) == 1 and more[0][1] == "w1"
    s.on_done(more[0][0])  # w1 idle, pool dry, w0 straggling
    st = s.steal(["w0", "w1"])
    assert st is not None
    p, thief = st
    assert thief == "w1" and p in assigned
    assert s.steal(["w0", "w1"], parts={p}) is None  # one steal per split
    s.steal_abort(p, thief)  # thief died pre-POST: bookkeeping undone
    assert s.steal(["w0", "w1"], parts={p}) == (p, thief)
    s.close()


def test_steal_respects_lagging_parts_filter():
    s = _sched(2, depth=2)
    owners = dict(s.assign(["w0"]))
    parts = set(owners)
    lagging = {min(parts)}
    st = s.steal(["w0", "w1"], parts=lagging)
    assert st is not None and st[0] == min(parts)
    s.close()


# --------------------------------------------------------- split planning


def _mem_catalogs(conn):
    cm = CatalogManager()
    cm.register("memory", conn)
    return cm


def test_scan_split_plan_pow2_count_scales_pad_does_not():
    conn = MemoryConnector()
    conn.create_table("t", [ColumnSchema("k", BIGINT)])
    conn.insert("t", {"k": np.arange(1000, dtype=np.int64)})
    cats = _mem_catalogs(conn)
    scan = TableScan("memory", "t", ("k",), (BIGINT,))
    n, pad = scan_split_plan(scan, cats, 100)
    assert pad == 128  # pow2 bucket of the target
    assert n == -(-1000 // 128)
    # 10x the data: the pad (the compiled shape) is IDENTICAL — only the
    # morsel count moves
    conn.insert("t", {"k": np.arange(9000, dtype=np.int64)})
    n2, pad2 = scan_split_plan(scan, cats, 100)
    assert (n2, pad2) == (-(-10000 // 128), pad)


def test_scan_split_plan_skips_bucketed_tables():
    class Bucketed(MemoryConnector):
        def table_partitioning(self, table):
            return (("k",), 4)

    conn = Bucketed()
    conn.create_table("t", [ColumnSchema("k", BIGINT)])
    conn.insert("t", {"k": np.arange(100, dtype=np.int64)})
    cats = CatalogManager()
    cats.register("memory", conn)
    scan = TableScan("memory", "t", ("k",), (BIGINT,))
    # morselizing a connector-bucketed scan would break collocated-join
    # alignment: the fragment keeps its bucket-count fan-out
    assert scan_split_plan(scan, cats, 100) is None


# ------------------------------------------------------- cluster behavior


def _make_table(conn, nrows, groups=7):
    conn.create_table(
        "t", [ColumnSchema("k", BIGINT), ColumnSchema("v", BIGINT)]
    )
    conn.insert("t", {"k": np.arange(nrows, dtype=np.int64) % groups,
                      "v": np.arange(nrows, dtype=np.int64)})
    return int(np.arange(nrows).sum())


def test_split_lost_fault_retries_one_morsel_not_the_scan(tmp_path):
    conn = MemoryConnector()
    oracle = _make_table(conn, 2000)
    runner = _cluster(tmp_path, conn, split_target_rows=256)
    try:
        runner.inject_task_failure(
            worker_index=0, task_id="*", mode="SPLIT_LOST", count=1
        )
        rows = runner.query("select sum(v) from t")
        assert [list(r) for r in rows] == [[oracle]]
        info = _split_info(runner.coordinator)
        assert info["splits"] == 8 and info["completed"] == 8
        # ONE morsel was re-assigned; the other seven were never touched
        assert info["retries"] == 1
    finally:
        runner.stop()


class HalfGatedConnector(MemoryConnector):
    """The first `free_reads` morsel reads pass (and their task outputs
    COMMIT to the spool); every later read blocks on `gate`.  Counts each
    read_split per table — the exactly-once proof is this count: a
    committed morsel is re-SERVED downstream, never re-read."""

    def __init__(self, free_reads):
        super().__init__()
        self.gate = threading.Event()
        self.gated_table = None
        self.free_reads = free_reads
        self.reads: dict[str, int] = {}
        self._rlock = threading.Lock()

    def read_split(self, split, columns):
        with self._rlock:
            self.reads[split.table] = self.reads.get(split.table, 0) + 1
            n = self.reads[split.table]
        if split.table == self.gated_table and n > self.free_reads:
            assert self.gate.wait(timeout=120), "test gate never opened"
        return super().read_split(split, columns)


@pytest.mark.chaos
def test_worker_kill_mid_scan_split_retry_exactly_once(tmp_path):
    """The headline chaos scenario: kill a worker holding part of a scan's
    splits mid-read.  Zero client-visible failures; only the LOST morsels
    are re-read (retries < splits); every spool-committed morsel is served
    from its committed task dir, never recomputed."""
    conn = HalfGatedConnector(free_reads=4)
    oracle = _make_table(conn, 2000)
    conn.gated_table = "t"
    runner = _cluster(
        tmp_path, conn, split_target_rows=256, split_queue_depth=1
    )
    spool = str(tmp_path / "spool")
    res: dict = {}

    def go():
        try:
            res["rows"] = runner.query("select sum(v) from t")
        except Exception as e:  # pragma: no cover - re-raised below
            res["err"] = e

    th = threading.Thread(target=go, daemon=True)
    try:
        th.start()
        # four morsels committed, both workers blocked mid-read on a fifth
        # and sixth — the query is genuinely mid-scan
        ready = _wait(
            lambda: len(_committed_dirs(spool)) >= 4
            and conn.reads.get("t", 0) >= 6,
            timeout=60,
        )
        assert ready, (
            f"scan never reached mid-flight: committed="
            f"{len(_committed_dirs(spool))} reads={conn.reads}"
        )
        runner.kill_worker(1)
        conn.gate.set()
        th.join(timeout=120)
        assert not th.is_alive(), "query wedged after worker death"
        assert "err" not in res, f"client saw a failure: {res.get('err')}"
        assert [list(r) for r in res["rows"]] == [[oracle]]
        info = _split_info(runner.coordinator)
        assert info["splits"] == 8 and info["completed"] == 8
        # split-level retry: strictly fewer re-runs than morsels
        assert 1 <= info["retries"] < info["splits"]
        # exactly-once: total connector reads = one per morsel plus ONLY
        # the lost attempts — the four pre-kill committed morsels were
        # never read again
        budget = info["splits"] + info["retries"] + info["steals"]
        assert info["splits"] <= conn.reads["t"] <= budget, (
            conn.reads, info,
        )
    finally:
        conn.gate.set()
        runner.stop()


# ------------------------------------------------- signature invariance


def _used_sigs(before, after):
    def uses(e):
        return (e.get("executes", 0) + e.get("compiles", 0)
                + e.get("fallback_executes", 0))

    return {s for s, e in after.items() if uses(e) > uses(before.get(s, {}))}


def test_executed_signature_count_invariant_across_scales(tmp_path):
    """Counterpart of test_jit_signature_count_invariant_across_scales: same
    query, 8x the data: more morsels, the SAME number of distinct executed
    plan signatures (profiler-witnessed) — the planner no longer bakes data
    size into scan shapes."""
    sql = "select k, sum(v) from t group by k order by k"
    used, splits = [], []
    for i, nrows in enumerate((1000, 8000)):
        conn = MemoryConnector()
        _make_table(conn, nrows)
        sub = tmp_path / f"scale{i}"
        sub.mkdir()
        runner = _cluster(sub, conn, split_target_rows=256)
        try:
            before = PROFILER.snapshot()
            rows = runner.query(sql)
            after = PROFILER.snapshot()
            exp = {k: 0 for k in range(7)}
            for r in range(nrows):
                exp[r % 7] += r
            assert [list(r) for r in rows] == [
                [k, exp[k]] for k in sorted(exp)
            ]
            splits.append(_split_info(runner.coordinator)["splits"])
            used.append(_used_sigs(before, after))
        finally:
            runner.stop()
    assert splits == [4, 32]  # data scale moved the morsel COUNT...
    assert used[0], "no executed signatures witnessed"
    # ...and nothing else: same signature count at both scales
    assert len(used[0]) == len(used[1]), (splits, used)


@pytest.mark.slow
@pytest.mark.chaos
def test_tpch_worker_kill_mid_scan_at_scale(tmp_path):
    """The acceptance drill at data scale: kill a worker mid-scan of
    TPC-H lineitem at CHAOS_SF (default sf1; crank it for bigger hosts).
    Zero client-visible failures, split retries strictly below the split
    count, and the connector read count proves committed morsels were
    never recomputed."""
    from trino_tpu_torch.connectors.tpch import TpchConnector, tpch_data

    sf = float(os.environ.get("CHAOS_SF", "1"))

    class GatedTpch(TpchConnector):
        def __init__(self, scale, free_reads):
            super().__init__(scale)
            self.gate = threading.Event()
            self.free_reads = free_reads
            self.reads = 0
            self._rlock = threading.Lock()

        def read_split(self, split, columns):
            if split.table == "lineitem":
                with self._rlock:
                    self.reads += 1
                    n = self.reads
                if n > self.free_reads:
                    assert self.gate.wait(timeout=300), "gate never opened"
            return super().read_split(split, columns)

    li = tpch_data("lineitem", sf)  # generate outside the timed drill
    nrows = len(li["l_quantity"])
    oracle_count = nrows
    conn = GatedTpch(sf, free_reads=4)
    runner = _cluster(
        tmp_path, conn, catalog="tpch",
        split_target_rows=65536, split_queue_depth=1,
    )
    spool = str(tmp_path / "spool")
    res: dict = {}

    def go():
        try:
            res["rows"] = runner.query("select count(*) from lineitem")
        except Exception as e:
            res["err"] = e

    th = threading.Thread(target=go, daemon=True)
    try:
        th.start()
        ready = _wait(
            lambda: len(_committed_dirs(spool)) >= 4 and conn.reads >= 6,
            timeout=120,
        )
        assert ready, (
            f"scan never reached mid-flight: committed="
            f"{len(_committed_dirs(spool))} reads={conn.reads}"
        )
        runner.kill_worker(1)
        conn.gate.set()
        th.join(timeout=300)
        assert not th.is_alive(), "query wedged after worker death"
        assert "err" not in res, f"client saw a failure: {res.get('err')}"
        assert [list(r) for r in res["rows"]] == [[oracle_count]]
        info = _split_info(runner.coordinator)
        expected_splits = -(-nrows // 65536)
        assert info["splits"] == expected_splits
        assert info["completed"] == expected_splits
        assert 1 <= info["retries"] < info["splits"]
        budget = info["splits"] + info["retries"] + info["steals"]
        assert info["splits"] <= conn.reads <= budget, (conn.reads, info)
    finally:
        conn.gate.set()
        runner.stop()


@pytest.mark.slow
@pytest.mark.chaos
@pytest.mark.parametrize("name", ["q01", "q06"])
def test_tpch_signature_invariance_two_scales(name, tmp_path):
    from trino_tpu_torch.connectors.tpch import TpchConnector

    used, splits = [], []
    for i, sf in enumerate((0.01, 0.02)):
        sub = tmp_path / f"sf{i}"
        sub.mkdir()
        runner = _cluster(
            sub, TpchConnector(sf), catalog="tpch", split_target_rows=8192
        )
        try:
            before = PROFILER.snapshot()
            rows = runner.query(QUERIES[name])
            after = PROFILER.snapshot()
            assert rows, f"{name} at sf={sf} returned nothing"
            splits.append(_split_info(runner.coordinator)["splits"])
            used.append(_used_sigs(before, after))
        finally:
            runner.stop()
    assert splits[1] > splits[0]  # 2x lineitem -> more morsels
    assert used[0], "no executed signatures witnessed"
    assert len(used[0]) == len(used[1]), (splits, used)


# ------------------------------------------------- file-backed splits


def _write_parquet_dir(root, table, files=3, groups_per_file=2, rows=1000):
    """A partitioned parquet table: `files` files x `groups_per_file` row
    groups of `rows` rows each, bigint k/v."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    tdir = os.path.join(str(root), table)
    os.makedirs(tdir, exist_ok=True)
    total = 0
    for f in range(files):
        n = rows * groups_per_file
        k = np.arange(total, total + n, dtype=np.int64)
        t = pa.table({"k": k, "v": k * 2})
        pq.write_table(
            t, os.path.join(tdir, f"part-{f}.parquet"), row_group_size=rows
        )
        total += n
    return total


def test_file_backed_scan_unit_plan(tmp_path):
    """The Parquet connector exposes its physical (file, row-group) units
    and the split plan deals one unit per morsel: the split COUNT follows
    the layout, the pad pow2-buckets the largest unit."""
    pytest.importorskip("pyarrow")
    from trino_tpu_torch.connectors.parquet import ParquetConnector

    _write_parquet_dir(tmp_path, "t", files=3, groups_per_file=2, rows=1000)
    conn = ParquetConnector(str(tmp_path))
    assert conn.scan_unit_plan("t") == (6, 1000)

    cat = CatalogManager()
    cat.register("pq", conn)
    plan = scan_split_plan(
        TableScan("pq", "t", ("k", "v"), (BIGINT, BIGINT)), cat, 65536
    )
    assert plan is not None
    nsplits, pad = plan
    assert nsplits == 6  # one morsel per (file, row-group) unit
    assert pad == 1024  # pow2 over the 1000-row max unit
    # splits enumerate one unit each, file by file: every bucket reads
    # exactly 1000 rows
    splits = conn.get_splits("t", nsplits)
    assert len(splits) == 6
    assert all(
        len(conn.read_split(s, ["k"])["k"]) == 1000 for s in splits
    )


def test_file_backed_splits_distributed_query(tmp_path):
    """A partitioned parquet dir streams file-by-file through the split
    scheduler: 6 units -> 6 morsels, all completed, rows exact."""
    pytest.importorskip("pyarrow")
    from trino_tpu_torch.connectors.parquet import ParquetConnector

    total = _write_parquet_dir(
        tmp_path / "data", "t", files=3, groups_per_file=2, rows=1000
    )
    runner = _cluster(
        tmp_path, ParquetConnector(str(tmp_path / "data")), catalog="pq",
        split_target_rows=65536,
    )
    try:
        rows = runner.query("select count(*), sum(v) from t")
        n = total
        assert [list(r) for r in rows] == [[n, int(np.arange(n).sum()) * 2]]
        info = _split_info(runner.coordinator)
        assert info["splits"] == 6
        assert info["completed"] == 6
    finally:
        runner.stop()


# ------------------------------------------ the worker's scan cache (repair)


class PartGatedConnector(MemoryConnector):
    """Blocks the read of one morsel (`gated_part`) on `gate` and counts
    every read by morsel."""

    def __init__(self, gated_part):
        super().__init__()
        self.gate = threading.Event()
        self.entered = threading.Event()
        self.gated_part = gated_part
        self.reads: dict[int, int] = {}
        self._rlock = threading.Lock()

    def read_split(self, split, columns):
        with self._rlock:
            self.reads[split.part] = self.reads.get(split.part, 0) + 1
        if split.part == self.gated_part:
            self.entered.set()
            assert self.gate.wait(timeout=30), "test gate never opened"
        return super().read_split(split, columns)


def _morsel_executor(conn, cache, part, nsplits, pad=256):
    """An executor as a worker's split-driven task makes one: morsel `part`
    of `nsplits`, padded to `pad`, over the worker's shared scan cache."""
    from trino_tpu_torch.exec.compiler import LocalExecutor

    ex = LocalExecutor(_mem_catalogs(conn), "memory", device="cpu", scan_cache=cache)
    ex.split = (part, nsplits)
    ex.split_pad_rows = pad
    return ex


def _morsel_sum(ex):
    page = ex.table_page("memory", "t", ["v"])
    v = page.columns[0].data
    live = page.live if page.live is not None else torch.ones_like(v, dtype=torch.bool)
    return int(v[live].sum())


def _expected_morsel_sum(conn, part, nsplits):
    split = conn.get_splits("t", nsplits)[part]
    return int(MemoryConnector.read_split(conn, split, ["v"])["v"].sum())


def test_blocked_morsel_read_does_not_stall_the_workers_other_morsels():
    """Port repair: two morsels of one worker share its scan cache.  The
    first morsel's connector read blocks; the second morsel reads, uploads
    and answers while the first is still held (the scan cache's lock is no
    longer held across `read_split`), as the reference's uncached reads do."""
    from trino_tpu_torch.exec.compiler import ScanCache

    conn = PartGatedConnector(gated_part=0)
    _make_table(conn, 2000)
    cache = ScanCache()
    held = _morsel_executor(conn, cache, 0, 8)
    other = _morsel_executor(conn, cache, 1, 8)
    res: dict = {}
    th = threading.Thread(target=lambda: res.setdefault("held", _morsel_sum(held)),
                          daemon=True)
    try:
        th.start()
        assert conn.entered.wait(timeout=10), "the first morsel never read"
        assert _morsel_sum(other) == _expected_morsel_sum(conn, 1, 8)
        assert th.is_alive() and "held" not in res, "the first read was not held"
    finally:
        conn.gate.set()
    th.join(timeout=10)
    assert not th.is_alive()
    assert res["held"] == _expected_morsel_sum(conn, 0, 8)
    assert conn.reads == {0: 1, 1: 1}


def test_two_tasks_needing_one_slice_read_it_once():
    """Port repair: a column in flight is read by the task that marked it;
    a second task needing the same slice waits for it and reads nothing."""
    from trino_tpu_torch.exec.compiler import ScanCache

    class Markers(dict):
        """Counts the lookups of a marker another task set."""

        looked_up = 0

        def __getitem__(self, key):
            Markers.looked_up += 1
            return super().__getitem__(key)

    conn = PartGatedConnector(gated_part=3)
    _make_table(conn, 2000)
    cache = ScanCache()
    cache.inflight = Markers()
    first = _morsel_executor(conn, cache, 3, 8)
    second = _morsel_executor(conn, cache, 3, 8)
    res: dict = {}
    threads = [
        threading.Thread(target=lambda: res.setdefault("first", _morsel_sum(first)),
                         daemon=True),
        threading.Thread(target=lambda: res.setdefault("second", _morsel_sum(second)),
                         daemon=True),
    ]
    try:
        threads[0].start()
        assert conn.entered.wait(timeout=10), "the first task never read"
        threads[1].start()
        # the second task found the first one's marker and waits on it
        assert _wait(lambda: Markers.looked_up >= 1, timeout=10)
        assert "second" not in res and conn.reads == {3: 1}
    finally:
        conn.gate.set()
    for th in threads:
        th.join(timeout=10)
        assert not th.is_alive()
    want = _expected_morsel_sum(conn, 3, 8)
    assert res == {"first": want, "second": want}
    assert conn.reads == {3: 1}
    assert cache.inflight == {}
