"""The port's multi-host runtime: a coordinator and workers over loopback
HTTP in one process, every task on the CPU here (`device="cpu"`), with the
sqlite oracle as the reference and fault injection for the retry paths.

Ports of tests/test_multihost.py: the TPC-H queries, the client protocol,
discovery and heartbeat, a task failure that fails the query, QUERY and
TASK retry, a killed worker under TASK, the chunked exchange, the
statement surface, the adaptive memory budget and its refusal, the
bucketed table, and the task-retry drills: a worker killed after its stage
output finished, an asymmetric partition and a gray slow producer routed
around by the hedged exchange, and the phased schedule.  One test holds the port's cluster against the JAX
package's (Q3 and Q18: rows and each stage's operator row counts)."""

import threading
import time

import numpy as np
import pytest

try:  # arrow before torch: loaded after it, arrow's parquet writer crashes the process
    import pyarrow  # noqa: F401
except ImportError:
    pass
import torch

from tests.oracle import assert_rows_equal
from tests.tpch_queries import ORDERED, QUERIES

torch.set_num_threads(1)


def port_runner(workers: int, catalog: str = "tpch", conn=None, **kw):
    """A started port cluster of `workers` CPU workers; TPC-H SF 0.01
    unless `conn` is given."""
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.testing import DistributedQueryRunner

    runner = DistributedQueryRunner(
        num_workers=workers, default_catalog=catalog, device="cpu", **kw
    )
    runner.register_catalog(catalog, conn if conn is not None else TpchConnector(0.01))
    return runner.start()


@pytest.fixture(scope="module")
def cluster(tpch_tiny):
    runner = port_runner(3)
    yield runner
    runner.stop()


@pytest.mark.parametrize("name", ["q01", "q03", "q06", "q13", "q18"])
def test_multihost_tpch(name, cluster, oracle):
    sql = QUERIES[name]
    got = cluster.query(sql)
    assert_rows_equal(got, oracle.query(sql), ordered=ORDERED[name])


def test_client_protocol(cluster, oracle):
    sql = "select count(*) from lineitem"
    got = cluster.query_via_protocol(sql)
    assert_rows_equal(got, oracle.query(sql))


def test_discovery_and_heartbeat(cluster):
    from trino_tpu_torch.client import StatementClient

    info = StatementClient(cluster.coordinator.url).server_info()
    assert len(info["workers"]) == 3
    assert all(w["alive"] for w in info["workers"])
    # every node runs where it was told to
    assert cluster.coordinator.device == torch.device("cpu")
    assert all(w.device == torch.device("cpu") for w in cluster.workers)


def _disarm(cluster):
    """Drop fault rules a test armed but its query never reached (a rule
    left armed would fail the next test's query on that worker)."""
    for w in cluster.workers:
        w.fault_injector.clear()


def test_task_failure_fails_query(cluster):
    cluster.inject_task_failure(worker_index=0, task_id="*")
    try:
        with pytest.raises(RuntimeError, match="injected|failed"):
            cluster.query("select sum(l_quantity) from lineitem")
    finally:
        _disarm(cluster)
    # the injection is one-shot per task id; later queries succeed
    rows = cluster.query("select count(*) from lineitem")
    assert rows[0][0] > 0


def test_query_retry_policy(cluster):
    cluster.coordinator.session.set("retry_policy", "QUERY")
    try:
        cluster.inject_task_failure(worker_index=1, task_id="*")
        rows = cluster.query("select count(*) from orders")
        assert rows[0][0] > 0  # retried transparently
    finally:
        _disarm(cluster)
        cluster.coordinator.session.set("retry_policy", "NONE")


def test_task_level_retry(cluster, oracle):
    """retry_policy=TASK re-schedules the failed task on another worker:
    the query completes without a whole-query retry."""
    cluster.coordinator.session.set("retry_policy", "TASK")
    try:
        cluster.inject_task_failure(worker_index=0, task_id="*")
        sql = QUERIES["q03"]
        got = cluster.query(sql)
        assert_rows_equal(got, oracle.query(sql), ordered=ORDERED["q03"])
    finally:
        _disarm(cluster)
        cluster.coordinator.session.set("retry_policy", "NONE")


def test_kill_worker_mid_query_task_retry(tpch_tiny, oracle):
    """A dead worker is routed around under retry_policy=TASK."""
    runner = port_runner(3, heartbeat_interval=0.3)
    try:
        runner.coordinator.session.set("retry_policy", "TASK")
        runner.query("select count(*) from lineitem")  # warm every worker
        # kill one worker outright; its tasks become UNREACHABLE and must
        # be re-scheduled onto the surviving two
        runner.workers[1].stop()
        sql = "select sum(l_quantity), count(*) from lineitem"
        assert_rows_equal(runner.query(sql), oracle.query(sql))
    finally:
        runner.stop()


def test_streaming_chunked_exchange(cluster, oracle):
    """Token-sequenced chunked fetches reassemble exactly once when a
    buffer spans many chunks (the port's wire CHUNK_ROWS shrunk to 512)."""
    from trino_tpu_torch.runtime import wire

    old = wire.CHUNK_ROWS
    wire.CHUNK_ROWS = 512  # lineitem tiny ~60k rows -> ~120 chunks per buffer
    try:
        sql = "select l_orderkey, count(*) from lineitem group by l_orderkey"
        assert_rows_equal(cluster.query(sql), oracle.query(sql))
    finally:
        wire.CHUNK_ROWS = old


def test_statement_surface_via_coordinator(cluster, oracle):
    """DDL/DML/utility statements through the HTTP protocol: embedded
    SELECTs run distributed, metadata operations run on the coordinator
    (the port's Engine statement path under the coordinator's catalogs)."""
    from trino_tpu_torch.connectors.memory import MemoryConnector

    cluster.register_catalog("memory2", MemoryConnector())
    cluster.query_via_protocol(
        "create table memory2.t_stmt as "
        "select l_orderkey, l_quantity from lineitem where l_quantity > 45"
    )
    got = cluster.query_via_protocol("select count(*), sum(l_quantity) from memory2.t_stmt")
    want = oracle.query(
        "select count(*), sum(l_quantity) from lineitem where l_quantity > 45"
    )
    assert_rows_equal(got, want)
    cluster.query_via_protocol("insert into memory2.t_stmt values (1, 2.5), (2, null)")
    got = cluster.query_via_protocol(
        "select count(*), count(l_quantity) from memory2.t_stmt"
    )
    assert got[0][0] == want[0][0] + 2 and got[0][1] == want[0][0] + 1
    desc = cluster.query_via_protocol("describe memory2.t_stmt")
    assert ("l_quantity", "decimal(12,2)") in [tuple(r) for r in desc]
    cluster.query_via_protocol("drop table memory2.t_stmt")


def test_adaptive_memory_budget_grows_on_retry(cluster, oracle):
    """With a task memory budget too small for the plan, the first attempt
    is refused by the worker's executor; the retry runs with a 4x budget
    and succeeds only because the budget grew."""
    cluster.coordinator.session.set("retry_policy", "TASK")
    cluster.coordinator.session.set("task_memory_budget_bytes", 200_000)
    try:
        sql = QUERIES["q01"]
        assert_rows_equal(cluster.query(sql), oracle.query(sql), ordered=ORDERED["q01"])
    finally:
        cluster.coordinator.session.set("task_memory_budget_bytes", 0)
        cluster.coordinator.session.set("retry_policy", "NONE")


def test_memory_budget_refusal_without_retry_fails(cluster):
    """The same budget under retry_policy=NONE fails the query: the budget
    is enforced (the test above passes because it grew)."""
    cluster.coordinator.session.set("task_memory_budget_bytes", 200_000)
    try:
        with pytest.raises(Exception, match="budget"):
            cluster.query(QUERIES["q01"])
    finally:
        cluster.coordinator.session.set("task_memory_budget_bytes", 0)


def test_bucketed_table_skips_repartition(tpch_tiny):
    """A memory table bucketed on the group key by the engine's partition
    hash is born hash-partitioned: the distributed plan aggregates with no
    repartition exchange, and agrees with an unbucketed run."""
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.connectors.spi import ColumnSchema
    from trino_tpu_torch.data.types import BIGINT
    from trino_tpu_torch.plan.distribute import distribute
    from trino_tpu_torch.plan.nodes import Exchange, walk
    from trino_tpu_torch.plan.optimizer import optimize

    rng = np.random.default_rng(3)
    n = 5000
    k = rng.integers(0, 97, n).astype(np.int64)
    v = rng.integers(0, 1000, n).astype(np.int64)
    schema = [ColumnSchema("k", BIGINT), ColumnSchema("v", BIGINT)]
    conn = MemoryConnector()
    conn.create_table("b", schema, bucketed_by=["k"], bucket_count=4)
    conn.insert("b", {"k": k, "v": v})
    flat = MemoryConnector()
    flat.create_table("b", schema)
    flat.insert("b", {"k": k, "v": v})

    sql = "select k, sum(v) as s, count(*) as c from b group by k order by k"
    runner = port_runner(2, catalog="mem", conn=conn)
    try:
        coord = runner.coordinator
        plan = optimize(coord.planner.plan(sql), coord.catalogs, coord.session)
        dplan = distribute(plan, coord.catalogs, 2, coord.session, connector_buckets=True)
        kinds = [n.kind for n in walk(dplan) if isinstance(n, Exchange)]
        assert "repartition" not in kinds, kinds
        got = runner.query(sql)
    finally:
        runner.stop()
    single = port_runner(1, catalog="mem", conn=flat)
    try:
        want = single.query(sql)
    finally:
        single.stop()
    assert got == want
    assert len(got) == 97 and sum(r[2] for r in got) == n


def test_shared_scan_cache_under_concurrent_tasks(tpch_tiny):
    """A worker's tasks share one ScanCache.  Sixteen threads (more than
    the cores, a short switch interval) read slices of one table at once:
    each gets its slice's rows, and each slice is read and uploaded once."""
    import sys
    import threading

    from trino_tpu_torch.connectors.spi import CatalogManager
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.exec.compiler import LocalExecutor, ScanCache

    conn = TpchConnector(0.01)
    reads, lock = [], threading.Lock()
    real_read = conn.read_split

    def counted(split, columns):
        with lock:
            reads.append(split)
        return real_read(split, columns)

    conn.read_split = counted
    catalogs = CatalogManager()
    catalogs.register("tpch", conn)
    cols = ["o_orderkey", "o_totalprice", "o_orderpriority"]
    parts = 4

    def rows_of(executor, part):
        executor.split = (part, parts)
        return executor.table_page("tpch", "orders", cols).to_pylist()

    want = [rows_of(LocalExecutor(catalogs, device="cpu"), p) for p in range(parts)]
    reads.clear()
    cache = ScanCache()
    got, errors = {}, []

    def task(i):
        try:
            got[i] = rows_of(LocalExecutor(catalogs, device="cpu", scan_cache=cache), i % parts)
        except Exception as ex:  # noqa: BLE001 - reported below
            errors.append(ex)

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=task, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(saved)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert all(got[i] == want[i % parts] for i in range(16))
    assert len(reads) == parts  # one read (and upload) per slice
    assert sum(len(w) for w in want) == 15000


def _stage_rows(info: dict) -> dict:
    """{stage id: (output kind, {node id: rows})} of a QueryInfo."""
    return {
        st["stage_id"]: (
            st["output_kind"],
            {int(nid): s["rows"] for nid, s in st["operators"].items() if "rows" in s},
        )
        for st in info["stages"]
    }


def test_port_cluster_matches_the_reference_cluster(tpch_tiny, monkeypatch):
    """Q3 and Q18 through both packages' DistributedQueryRunner, two
    workers each (the reference's on JAX's CPU backend, the port's with
    device="cpu"): the same rows, and in every stage the same live row
    count at every operator both report (the reference reports every node;
    the port every node but the inside of a fused scan -> filter ->
    project -> aggregate chain).  The reference's eager capacity sizing is
    off: it compiles op by op and changes no count."""
    import trino_tpu.exec.compiler as ref_compiler
    from trino_tpu.connectors.tpch import TpchConnector as RefTpch
    from trino_tpu.testing import DistributedQueryRunner as RefRunner

    monkeypatch.setattr(ref_compiler, "_EAGER_SIZING_LIMIT", 0)

    ref = RefRunner(num_workers=2)
    ref.register_catalog("tpch", RefTpch(0.01))
    ref.start()
    port = port_runner(2)
    try:
        for name in ("q03", "q18"):
            sql = QUERIES[name]
            want = ref.query(sql)
            ref_info = ref.coordinator.queries[list(ref.coordinator.queries)[-1]]["query_info"]
            got = port.query(sql)
            port_info = port.coordinator.queries[
                list(port.coordinator.queries)[-1]]["query_info"]
            assert_rows_equal(got, want, ordered=ORDERED[name])
            ref_stages, port_stages = _stage_rows(ref_info), _stage_rows(port_info)
            assert sorted(ref_stages) == sorted(port_stages), name
            compared = 0
            for sid, (kind, rows) in ref_stages.items():
                p_kind, p_rows = port_stages[sid]
                assert p_kind == kind, (name, sid)
                common = sorted(set(rows) & set(p_rows))
                assert common, (name, sid, rows, p_rows)
                assert {n: p_rows[n] for n in common} == {n: rows[n] for n in common}, (
                    name, sid)
                compared += len(common)
            assert compared >= len(ref_stages) * 2, (name, compared)
    finally:
        port.stop()
        ref.stop()


# ------------------------------------------------ task-retry drills (the four
# remaining cases of tests/test_multihost.py)


def test_kill_worker_with_finished_stage_output_mid_query():
    """A worker dies AFTER a producer stage FINISHED on it, while a consumer
    stage still runs.  Under retry_policy=TASK the scheduler re-schedules
    the dead worker's consumer task AND recomputes the producer output that
    died with it, instead of retrying fetches against the dead URL.  The
    probe side's read_split blocks until the worker is killed, so the build
    stage is finished and buffered on every worker first; the row equals
    the numpy sum."""
    from tests.test_torch_spool import GatedMemoryConnector, _make_tables

    conn = GatedMemoryConnector()
    expect = _make_tables(conn)
    runner = port_runner(2, catalog="memory", conn=conn, heartbeat_interval=0.3)
    try:
        runner.coordinator.session.set("retry_policy", "TASK")
        sql = "select sum(v + w) from probe, build where probe.k = build.k"
        conn.gated_table = "probe"
        qid = runner.coordinator.submit_query(sql)
        deadline = time.monotonic() + 60
        while conn.entered == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert conn.entered > 0, "probe stage never started"
        time.sleep(0.3)  # let the other probe tasks reach the gate too
        runner.workers[1].stop()  # its buffered build output and probe task die
        conn.gate.set()
        sm = runner.coordinator.queries[qid]["sm"]
        deadline = time.monotonic() + 120
        while sm.state not in ("FINISHED", "FAILED") and time.monotonic() < deadline:
            time.sleep(0.1)
        assert sm.state == "FINISHED", f"query {sm.state}: {sm.error}"
        assert runner.coordinator.queries[qid]["result"] == [(expect,)]
    finally:
        conn.gate.set()
        runner.stop()


def test_asymmetric_partition_hedged_exchange(tpch_tiny, oracle, tmp_path):
    """The A->B exchange link black-holes: worker B 503s every results
    fetch from worker A while its heartbeats and every other consumer's
    fetches work.  Q18 completes equal to sqlite with no client-visible
    failure: A grades the link DEAD and the hedged fetch serves B's
    committed partitions from the spool; the coordinator's link matrix
    shows the impaired link while neither endpoint is quarantined."""
    from trino_tpu_torch.runtime.health import HEDGED_FETCHES

    runner = port_runner(3, heartbeat_interval=0.3)
    try:
        runner.coordinator.session.set("retry_policy", "TASK")
        runner.coordinator.session.set("exchange_spool_dir", str(tmp_path))
        # one task per worker and stage, so worker A consumes worker B's
        # output whatever the placement of split-driven scans
        runner.coordinator.session.set("split_driven_scans", "false")
        runner.query("select count(*) from lineitem")  # each link's baseline
        won0 = HEDGED_FETCHES.value("won")
        runner.partition_link(producer_index=1, consumer_index=0)
        sql = QUERIES["q18"]
        assert_rows_equal(runner.query(sql), oracle.query(sql), ordered=ORDERED["q18"])
        assert HEDGED_FETCHES.value("won") > won0
        a, b = runner.workers[0], runner.workers[1]
        assert a.link_health.state(b.url) in ("SUSPECT", "DEAD")
        deadline = time.monotonic() + 10
        impaired = {}
        while time.monotonic() < deadline:
            impaired = {
                (c, p): cell["state"]
                for c, row in runner.coordinator.link_matrix().items()
                for p, cell in row.items()
                if cell.get("state") != "HEALTHY"
            }
            if (a.url, b.url) in impaired:
                break
            time.sleep(0.2)
        assert impaired.get((a.url, b.url)) in ("SUSPECT", "DEAD"), impaired
        det = runner.coordinator.failure_detector
        assert det.is_dispatchable(a.url) and det.is_dispatchable(b.url)
    finally:
        runner.stop()


def _hold_stage(workers, fragment_id: int):
    """Every task of fragment `fragment_id` waits on the returned gate as it
    starts (the workers' fault hook): the query cannot end before the test
    opens it.  Returns (gate, the held task ids)."""
    gate, held = threading.Event(), []
    for w in workers:
        inj = w.fault_injector
        plain = type(inj).task_fault

        def hook(task_id, sleep=time.sleep, _p=plain, _i=inj):
            if f"_f{fragment_id}_" in task_id:
                held.append(task_id)
                assert gate.wait(60), "the test's gate never opened"
            return _p(_i, task_id, sleep=sleep)

        inj.task_fault = hook
    return gate, held


def _wait(pred, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.02)


def test_gray_slow_producer_hedge_wins(tpch_tiny, oracle, tmp_path):
    """A producer serves exchange pages correctly but late, with no error
    anywhere: only the hedge race (a fetch in flight past the link's
    history-quantile delay -> spool re-read) keeps Q18 off the slow path.
    The delay is an event the test holds closed while the hedges win; the
    query's last worker stage is held meanwhile, so the late answers land
    while the producer's buffers live, 30x later than their links' fastest
    answer: the links grade from latency alone.  Zero client-visible
    failures, nobody quarantined, rows equal sqlite.  (The reference's test
    slows every consumer, the coordinator's unhedged fetch included, by a
    fixed 800 ms.)"""
    from trino_tpu_torch.runtime.health import HEDGED_FETCHES

    runner = port_runner(3, heartbeat_interval=0.3)
    gate = threading.Event()
    b = runner.workers[1]
    others = [w for w in runner.workers if w is not b]
    plain = type(b.fault_injector).link_fault
    b.fault_injector.link_fault = (
        lambda task_id, consumer="", sleep=None: plain(
            b.fault_injector, task_id, consumer, sleep=gate.wait)
    )
    coord = runner.coordinator
    last_gate = threading.Event()
    try:
        coord.session.set("retry_policy", "TASK")
        coord.session.set("exchange_spool_dir", str(tmp_path))
        coord.session.set("result_cache_enabled", "false")
        # one task per worker and stage: split-driven scans may place a
        # leaf stage's only task anywhere, and then no consumer fetches
        # from the slow producer at all
        coord.session.set("split_driven_scans", "false")
        sql = QUERIES["q18"]
        # the same query first: every (consumer, producer) link gets a
        # healthy baseline to judge a gray failure against
        runner.query(sql)
        times = coord.queries[list(coord.queries)[-1]]["stage_times"]
        last_gate, held = _hold_stage(runner.workers, max(times, key=lambda f: times[f][0]))
        won0 = HEDGED_FETCHES.value("won")
        # scoped to the consuming workers: the coordinator's own fetch of
        # the root stage's input has no hedge
        for consumer in (0, 2):
            runner.gray_slow(producer_index=1, delay_ms=60_000, consumer_index=consumer)
        t0 = time.monotonic()
        qid = coord.submit_query(sql)
        # every stage before the last one finished: the hedges carried them
        _wait(lambda: len(held) >= len(runner.workers))
        assert HEDGED_FETCHES.value("won") > won0
        base_ms = max(w.link_health.snapshot().get(b.url, {}).get("baseline_ms") or 0.0
                      for w in others)
        _wait(lambda: time.monotonic() - t0 >= 30 * base_ms / 1e3)
        gate.set()  # the late primaries answer now, their latency scored
        grades: set = set()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            grades = {w.link_health.state(b.url) for w in others}
            if grades & {"DEGRADED", "SUSPECT", "DEAD"}:
                break
            time.sleep(0.02)
        assert grades & {"DEGRADED", "SUSPECT", "DEAD"}, grades
        last_gate.set()
        sm = coord.queries[qid]["sm"]
        _wait(lambda: sm.done)
        assert sm.state == "FINISHED", sm.error
        assert_rows_equal(coord.queries[qid]["result"], oracle.query(sql),
                          ordered=ORDERED["q18"])
        det = coord.failure_detector
        assert all(det.is_dispatchable(w.url) for w in runner.workers)
    finally:
        gate.set()
        last_gate.set()
        runner.stop()


def test_phased_schedule_overlaps_independent_subtrees(cluster, oracle):
    """PHASED mode (retry_policy=TASK) runs independent sibling stages
    concurrently: in a UNION ALL of two aggregations over different
    tables, one branch STARTS before the other ENDS."""
    cluster.coordinator.session.set("retry_policy", "TASK")
    try:
        sql = """
          select count(*) as c from lineitem
          union all
          select count(*) as c from orders
        """
        assert_rows_equal(cluster.query(sql), oracle.query(sql), ordered=False)
        times = cluster.coordinator.last_stage_times
        assert len(times) >= 2, times
        ivs = sorted(times.values())
        overlapping = any(
            a_start < b_end and b_start < a_end
            for i, (a_start, a_end) in enumerate(ivs)
            for (b_start, b_end) in ivs[i + 1:]
        )
        assert overlapping, f"no overlapping stage intervals: {times}"
    finally:
        cluster.coordinator.session.set("retry_policy", "NONE")


# ------------------------------------------------------- repaired faults


DISTINCT_SQL = {
    "global": "select sum(distinct l_quantity), avg(distinct l_quantity) from lineitem",
    "grouped": (
        "select l_returnflag, sum(distinct l_quantity), avg(distinct l_quantity), "
        "sum(distinct l_extendedprice), avg(distinct l_discount) "
        "from lineitem group by l_returnflag"
    ),
}


@pytest.mark.parametrize("form", sorted(DISTINCT_SQL))
@pytest.mark.parametrize("path", ["local", "local_operators", "distributed", "cluster"])
def test_sum_and_avg_distinct_equal_sqlite(path, form, cluster, oracle):
    """sum / avg(DISTINCT x) reduce over each value's first occurrence in
    its group, as count(DISTINCT) counts it: equal to sqlite on the local
    engine in both kernel settings, with distributed=True and through the
    cluster.  (The reference engine answers the global form with a wrong
    sum and raises on the grouped one.)"""
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.ops import kernels
    from trino_tpu_torch.runtime.engine import Engine

    sql = DISTINCT_SQL[form]
    saved = kernels.get_policy()
    try:
        if path == "cluster":
            got = cluster.query(sql)
        else:
            kw = {"distributed": True, "devices": ["cpu"] * 3} if path == "distributed" else {}
            eng = Engine(device="cpu", **kw)
            eng.register_catalog("tpch", TpchConnector(0.01))
            if path == "local_operators":
                eng.session.set("data_plane_kernels", "false")
            got = eng.query(sql)
    finally:
        kernels.set_policy(saved)
    assert_rows_equal(got, oracle.query(sql))


def _nested_catalog(package: str = "trino_tpu_torch"):
    """A memory table with a ROW and a MAP column (NULL fields and values
    among them) and a table to join it with, in the port's connector or,
    with package="trino_tpu", the reference's, on the same data."""
    import importlib

    MemoryConnector = importlib.import_module(f"{package}.connectors.memory").MemoryConnector
    ColumnSchema = importlib.import_module(f"{package}.connectors.spi").ColumnSchema
    T = importlib.import_module(f"{package}.data.types")

    n = 300
    rows = np.empty(n, dtype=object)
    rows[:] = [(i % 7, f"s{i % 5}") if i % 11 else (None, "z") for i in range(n)]
    maps = np.empty(n, dtype=object)
    maps[:] = [{"a": i % 3, "b": None if i % 4 == 0 else i} for i in range(n)]
    conn = MemoryConnector()
    conn.create_table("nt", [
        ColumnSchema("k", T.BIGINT),
        ColumnSchema("r", T.RowType((("a", T.BIGINT), ("b", T.VARCHAR)))),
        ColumnSchema("m", T.MapType(T.VARCHAR, T.BIGINT)),
    ])
    conn.insert("nt", {"k": np.arange(n, dtype=np.int64), "r": rows, "m": maps})
    conn.create_table("o", [ColumnSchema("k", T.BIGINT), ColumnSchema("w", T.BIGINT)])
    conn.insert("o", {"k": np.arange(0, n, 3, dtype=np.int64),
                      "w": np.arange(0, n, 3, dtype=np.int64) * 2})
    return conn


NESTED_WIRE_SQL = {
    "map_agg": (
        "select n_regionkey, map_agg(n_name, n_nationkey) from tpch.tiny.nation "
        "group by n_regionkey order by n_regionkey"
    ),
    "map_agg_null_values": (
        "select n_regionkey, map_agg(n_name, case when n_nationkey % 2 = 0 then null "
        "else n_nationkey end) from tpch.tiny.nation group by n_regionkey order by n_regionkey"
    ),
    "row_and_map_through_a_join": (
        "select nt.k, nt.r, nt.m, o.w from nt join o on nt.k = o.k order by nt.k"
    ),
    "row_group_key": "select r, count(*), sum(k) from nt group by r order by 3",
}


def test_map_and_row_columns_cross_the_wire(tpch_tiny):
    """Map and row columns travel between the cluster's nodes as JSON text
    re-encoded into the receiver's dictionaries: map_agg (with NULL values),
    a row and a map column carried through a repartitioned join, and a row
    group key equal the reference's local engine on the same tables (the
    reference's cluster answers map_agg with empty maps) and the port's."""
    from trino_tpu.connectors.tpch import TpchConnector as RefTpch
    from trino_tpu.runtime.engine import Engine as RefEngine
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.runtime.engine import Engine

    ref = RefEngine(default_catalog="mem")
    ref.register_catalog("tpch", RefTpch(0.01))
    ref.register_catalog("mem", _nested_catalog("trino_tpu"))
    local = Engine(device="cpu", default_catalog="mem")
    local.register_catalog("tpch", TpchConnector(0.01))
    local.register_catalog("mem", _nested_catalog())
    runner = port_runner(3, catalog="mem", conn=_nested_catalog())
    runner.register_catalog("tpch", TpchConnector(0.01))
    try:
        for name, sql in NESTED_WIRE_SQL.items():
            want = ref.query(sql)
            assert want, name
            assert runner.query(sql) == want, name
            assert local.query(sql) == want, name
    finally:
        runner.stop()
