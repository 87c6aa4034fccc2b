"""The distributed cases of the reference's test files, ported to
`Engine(distributed=True)` over CPU workers (exec/spmd.py), and the port's
bucketed memory tables against the JAX package's connector and planner.

Ports of: test_joins.test_outer_join_distributed,
test_grouping_sets.test_grouping_sets_distributed,
test_setops.test_setop_distributed, test_window.test_window_distributed,
test_agg_functions.test_distributed_new_aggs and
test_approx_distinct_distributed_matches_local,
test_reorder.test_scalar_subquery_multi_row_error_distributed,
test_nulls.test_distributed_group_by_nullable_key,
test_arrays.test_unnest_distributed, test_lambdas.test_array_agg_distributed_gather,
test_orc.test_stripe_splits_distributed and
test_dbapi_connector.test_distributed_scan_splits.  Each reference test ran
on its virtual devices (4 or 8, as the reference chose); here as many CPU
workers."""

import numpy as np
import pytest
try:  # arrow before torch: loaded after it, arrow's parquet writer crashes the process
    import pyarrow  # noqa: F401
except ImportError:
    pass
import torch

from tests.distributed_cases import (
    BUCKET_GROUP_BY, BUCKET_JOIN, MEMORY_CASES, bucket_inserts, bucketed_tables, tpch_cases,
)
from tests.oracle import assert_rows_equal

torch.set_num_threads(1)
CASES = tpch_cases()


@pytest.fixture(autouse=True)
def _restore_kernel_policy():
    from trino_tpu_torch.ops import kernels

    saved = kernels.get_policy()
    yield
    kernels.set_policy(saved)


def dist(workers: int, catalog: str = "tpch", conn=None):
    """A distributed port engine over `workers` CPU workers; TPC-H SF 0.01
    unless `conn` is given."""
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.runtime.engine import Engine

    eng = Engine(default_catalog=catalog, device="cpu", distributed=True,
                 devices=["cpu"] * workers)
    eng.register_catalog(catalog, conn if conn is not None else TpchConnector(0.01))
    return eng


def _exchange_kinds(plan) -> set:
    from trino_tpu_torch.plan.nodes import Exchange, walk

    return {n.kind for n in walk(plan) if isinstance(n, Exchange)}


def test_outer_join_distributed(oracle):
    from tests.test_joins import _HAS_FULL_JOIN

    if not _HAS_FULL_JOIN:
        pytest.skip("sqlite lacks RIGHT/FULL OUTER JOIN")
    eng = dist(4)
    for name in ("joins_full_many", "joins_right_basic"):
        sql, oracle_sql = CASES[name]
        assert_rows_equal(eng.query(sql), oracle.query(oracle_sql), ordered=False)


def test_grouping_sets_distributed(oracle):
    eng = dist(4)
    sql, oracle_sql = CASES["grouping_sets_rollup"]
    assert_rows_equal(eng.query(sql), oracle.query(oracle_sql), ordered=False)


def test_setop_distributed(oracle):
    eng = dist(8)
    for name in ("setops_union_all", "setops_union_distinct", "setops_except"):
        sql, oracle_sql = CASES[name]
        assert_rows_equal(eng.query(sql), oracle.query(oracle_sql), ordered=False)


def test_window_distributed(oracle):
    eng = dist(4)
    sql, _ = CASES["window_whole_partition"]
    assert "repartition" in _exchange_kinds(eng.plan(sql))
    assert_rows_equal(eng.query(sql), oracle.query(sql), ordered=False)
    # global (unpartitioned) windows gather to one task
    sql, _ = CASES["window_global_window"]
    assert_rows_equal(eng.query(sql), oracle.query(sql), ordered=False)


def _memory_engine(workers: int):
    from trino_tpu_torch.connectors.memory import MemoryConnector

    return dist(workers, "memory", MemoryConnector())


def _memory_case(eng, name: str) -> None:
    setup, sql, want = MEMORY_CASES[name]
    for stmt in setup:
        eng.execute(stmt)
    assert_rows_equal(eng.execute(sql), want, ordered=True)


def test_distributed_new_aggs():
    eng = _memory_engine(4)
    _memory_case(eng, "new_aggs")
    _memory_case(eng, "keyless_percentile")


def test_approx_distinct_distributed_matches_local():
    """approx_distinct repartitions RAW rows on the group keys: the
    distributed estimate equals the local one exactly."""
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.connectors.spi import ColumnSchema
    from trino_tpu_torch.data.types import BIGINT
    from trino_tpu_torch.runtime.engine import Engine

    rng = np.random.default_rng(5)
    n = 40_000
    g = rng.integers(0, 3, n).astype(np.int64)
    x = rng.integers(0, 8000, n).astype(np.int64)
    conn = MemoryConnector()
    conn.create_table("d", [ColumnSchema("g", BIGINT), ColumnSchema("x", BIGINT)])
    conn.insert("d", {"g": g, "x": x})
    sql = "select g, approx_distinct(x) as ad from d group by g order by g"
    local = Engine(default_catalog="mem", device="cpu")
    local.register_catalog("mem", conn)
    got_local = local.query(sql)
    got_dist = dist(8, "mem", conn).query(sql)
    assert got_local == got_dist, (got_local, got_dist)
    for gv, ad in got_local:
        true = len(np.unique(x[g == gv]))
        assert abs(ad - true) / true < 0.05, (gv, ad, true)


def test_scalar_subquery_multi_row_error_distributed():
    """The EnforceSingleRow guard also fires distributed (the count is
    max-reduced over the tasks after the gather)."""
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.connectors.spi import ColumnSchema
    from trino_tpu_torch.data.types import BIGINT, VARCHAR

    rng = np.random.default_rng(7)
    conn = MemoryConnector()
    n_fact, n_dim, n_tiny = 20_000, 5_000, 20
    conn.create_table("fact", [ColumnSchema("f_id", BIGINT), ColumnSchema("f_dim", BIGINT),
                               ColumnSchema("f_tiny", BIGINT), ColumnSchema("f_val", BIGINT)])
    conn.insert("fact", {
        "f_id": np.arange(n_fact, dtype=np.int64),
        "f_dim": rng.integers(0, n_dim, n_fact).astype(np.int64),
        "f_tiny": rng.integers(0, n_tiny, n_fact).astype(np.int64),
        "f_val": rng.integers(0, 1000, n_fact).astype(np.int64),
    })
    conn.create_table("tiny", [ColumnSchema("t_id", BIGINT), ColumnSchema("t_name", VARCHAR)])
    conn.insert("tiny", {
        "t_id": np.arange(n_tiny, dtype=np.int64),
        "t_name": np.asarray([f"t{i}" for i in range(n_tiny)], dtype=object),
    })
    deng = dist(8, "mem", conn)
    ok = deng.query(
        "SELECT count(*) AS c FROM fact WHERE f_tiny = (SELECT t_id FROM tiny WHERE t_id = 3)"
    )
    assert ok == [(int((conn._data["fact"]["f_tiny"] == 3).sum()),)]
    with pytest.raises(Exception, match="multiple rows"):
        deng.query(
            "SELECT count(*) AS c FROM fact WHERE f_tiny = (SELECT t_id FROM tiny WHERE t_id < 3)"
        )


def test_distributed_group_by_nullable_key():
    # one NULL group even when rows spread across tasks
    _memory_case(_memory_engine(8), "nullable_group_key")


def test_unnest_distributed():
    _memory_case(_memory_engine(8), "unnest_group_by")


def test_array_agg_distributed_gather():
    """Host-collected aggregates run undistributed on the engine's local
    fallback, as in the reference."""
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.connectors.spi import ColumnSchema
    from trino_tpu_torch.data.types import BIGINT

    conn = MemoryConnector()
    conn.create_table("d", [ColumnSchema("k", BIGINT), ColumnSchema("v", BIGINT)])
    conn.insert("d", {
        "k": np.arange(16, dtype=np.int64) % 4,
        "v": np.arange(16, dtype=np.int64),
    })
    eng = dist(8, "mem", conn)
    sql = "select k, array_agg(v) as a from d group by k order by k"
    assert _exchange_kinds(eng.plan(sql)) == set()
    rows = eng.execute(sql)
    assert [r[0] for r in rows] == [0, 1, 2, 3]
    assert sorted(rows[0][1]) == [0, 4, 8, 12]


def _big_table(eng) -> None:
    eng.execute("create table big (k bigint)")
    eng.execute("insert into big values " + ", ".join(f"({i})" for i in range(100)))


def test_stripe_splits_distributed(tmp_path):
    from trino_tpu_torch.connectors.orc import OrcConnector
    from trino_tpu_torch.runtime.engine import Engine

    local = Engine(default_catalog="orc", device="cpu")
    local.register_catalog("orc", OrcConnector(str(tmp_path)))
    _big_table(local)
    eng = dist(8, "orc", OrcConnector(str(tmp_path)))
    assert eng.execute("select count(*), sum(k) from big") == [(100, 4950)]


def test_distributed_scan_splits(tmp_path):
    import sqlite3

    from trino_tpu_torch.connectors.dbapi import SqliteConnector

    db = str(tmp_path / "ext.db")
    conn = sqlite3.connect(db)
    conn.execute("create table ext (k integer, v real, s text)")
    conn.executemany("insert into ext values (?, ?, ?)",
                     [(1, 1.5, "a"), (2, 2.5, "b"), (3, None, "c"), (4, 4.5, None)])
    conn.commit()
    conn.close()
    eng = dist(8, "sqlite", SqliteConnector(db, splits_per_table=2))
    assert eng.execute("select count(*), sum(k) from ext") == [(4, 10)]


# ---------------------------------------------------------------- buckets


def test_bucketed_table_splits_equal_the_reference():
    """One split per bucket whatever the parallelism asked for, and each
    split's rows equal the JAX connector's for the same inserts."""
    inserts = bucket_inserts()
    ref, port = bucketed_tables("trino_tpu", inserts), bucketed_tables("trino_tpu_torch", inserts)
    assert port.table_partitioning("b") == ref.table_partitioning("b") == (("k", "s"), 4)
    assert port.table_partitioning("d") is None
    for parts in (1, 3, 8):
        splits = port.get_splits("b", parts)
        assert [(s.part, s.num_parts) for s in splits] == [(b, 4) for b in range(4)]
    total = 0
    for sp, rsp in zip(port.get_splits("b", 2), ref.get_splits("b", 2)):
        got = port.read_split(sp, ["k", "s", "v"])
        want = ref.read_split(rsp, ["k", "s", "v"])
        for c in ("k", "s", "v"):
            assert np.array_equal(np.ma.getdata(got[c]), np.ma.getdata(want[c])), c
            assert np.array_equal(np.ma.getmaskarray(got[c]), np.ma.getmaskarray(want[c])), c
        total += len(got["k"])
    assert total == 1000


def _planned(pkg: str, conn, sql: str, workers: int):
    import importlib

    Engine = importlib.import_module(f"{pkg}.runtime.engine").Engine
    distribute = importlib.import_module(f"{pkg}.plan.distribute").distribute
    optimize = importlib.import_module(f"{pkg}.plan.optimizer").optimize
    serde = importlib.import_module(f"{pkg}.plan.serde")
    eng = Engine(default_catalog="mem", **({"device": "cpu"} if pkg.endswith("torch") else {}))
    eng.register_catalog("mem", conn)
    plan = optimize(eng.planner.plan(sql), eng.catalogs, eng.session)
    return serde.plan_to_json(distribute(plan, eng.catalogs, workers, eng.session,
                                         connector_buckets=True))


def test_bucketed_plans_equal_the_reference():
    """distribute(..., connector_buckets=True) plans a join and a GROUP BY on
    the bucket keys as the JAX package does: the scans are born
    hash-partitioned, no repartition where 4 buckets divide over the
    workers, a repartition where they do not."""
    inserts = bucket_inserts()
    ref, port = bucketed_tables("trino_tpu", inserts), bucketed_tables("trino_tpu_torch", inserts)
    for workers in (2, 3, 4):
        got = _planned("trino_tpu_torch", port, BUCKET_JOIN, workers)
        assert got == _planned("trino_tpu", ref, BUCKET_JOIN, workers)
        assert ('"repartition"' in got) == (workers == 3)


def test_bucketed_table_answers_distributed_and_local():
    """The executors split a bucketed table's scans by row range and plan
    without the bucket alignment: distributed, out of core and local runs
    agree with numpy."""
    from trino_tpu_torch.runtime.engine import Engine

    inserts = bucket_inserts()
    k = np.concatenate([b["k"] for b in inserts])
    s = np.concatenate([b["s"] for b in inserts])
    v = np.ma.concatenate([b["v"] for b in inserts])
    want = {}
    for kk, ss, vv in zip(k, s, v):
        t, c = want.get((int(kk), ss), (None, 0))
        if vv is not np.ma.masked:
            t = (t or 0) + int(vv)
        want[(int(kk), ss)] = (t, c + 1)  # sum over NULLs alone is NULL
    sql = BUCKET_GROUP_BY
    local = Engine(default_catalog="mem", device="cpu")
    local.register_catalog("mem", bucketed_tables("trino_tpu_torch", inserts))
    ooc = Engine(default_catalog="mem", device="cpu")
    ooc.register_catalog("mem", bucketed_tables("trino_tpu_torch", inserts))
    ooc.session.set("query_max_memory_bytes", 4_000)
    for eng in (dist(4, "mem", bucketed_tables("trino_tpu_torch", inserts)), local, ooc):
        got = {(r[0], r[1]): (r[2], r[3]) for r in eng.query(sql)}
        assert got == want
    assert ooc.last_spill is not None
