"""The port's multi-host runtime: a coordinator and workers over loopback
HTTP in one process, every task on the CPU here (`device="cpu"`), with the
sqlite oracle as the reference and fault injection for the retry paths.

Ports of tests/test_multihost.py: the TPC-H queries, the client protocol,
discovery and heartbeat, a task failure that fails the query, QUERY and
TASK retry, a killed worker under TASK, the chunked exchange, the
statement surface, the adaptive memory budget and its refusal, and the
bucketed table.  One test holds the port's cluster against the JAX
package's (Q3 and Q18: rows and each stage's operator row counts)."""

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
