"""The port's Iceberg connector (trino_tpu_torch/connectors/iceberg.py): the
ten tests of tests/test_iceberg.py on a CPU engine, EXECUTE across a commit
(the fast path's plan cache and the executor's scan cache both move), and a
warehouse the port wrote read back by the JAX package's connector."""

import pytest
try:  # arrow before torch: loaded after it, arrow's parquet writer crashes the process
    import pyarrow  # noqa: F401
except ImportError:
    pyarrow = None
import torch

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(pyarrow is None, reason="needs pyarrow")


@pytest.fixture(autouse=True)
def _restore_kernel_policy():
    from trino_tpu_torch.ops import kernels

    saved = kernels.get_policy()
    yield
    kernels.set_policy(saved)


@pytest.fixture()
def engine(tmp_path):
    from trino_tpu_torch.connectors.iceberg import IcebergConnector
    from trino_tpu_torch.runtime.engine import Engine

    eng = Engine(default_catalog="iceberg", device="cpu")
    eng.register_catalog("iceberg", IcebergConnector(str(tmp_path / "wh")))
    return eng


def test_create_insert_select(engine):
    engine.execute("create table t (k bigint, v double, s varchar)")
    engine.execute("insert into t values (1, 1.5, 'a'), (2, 2.5, 'b')")
    engine.execute("insert into t values (3, 3.5, 'c')")
    assert engine.execute("select k, v, s from t order by k") == [
        (1, 1.5, "a"), (2, 2.5, "b"), (3, 3.5, "c"),
    ]
    assert engine.execute("select count(*) from t") == [(3,)]


def test_ctas(engine):
    engine.execute("create table src (k bigint)")
    engine.execute("insert into src values (1), (2)")
    engine.execute("create table dst as select k * 10 as k10 from src")
    assert engine.execute("select k10 from dst order by k10") == [(10,), (20,)]


def test_snapshots_metadata_table(engine):
    engine.execute("create table t (k bigint)")
    engine.execute("insert into t values (1)")
    engine.execute("insert into t values (2), (3)")
    rows = engine.execute(
        'select snapshot_id, file_count, row_count from "t$snapshots" order by snapshot_id')
    assert rows == [(1, 0, 0), (2, 1, 1), (3, 2, 3)]


def test_time_travel(engine):
    engine.execute("create table t (k bigint)")
    engine.execute("insert into t values (1)")       # snapshot 2
    engine.execute("insert into t values (2), (3)")  # snapshot 3
    assert engine.execute('select k from "t@2" order by k') == [(1,)]
    assert engine.execute('select k from "t@3" order by k') == [(1,), (2,), (3,)]
    assert engine.execute("select count(*) from t") == [(3,)]


def test_rollback(engine):
    conn = engine.catalogs.get("iceberg")
    engine.execute("create table t (k bigint)")
    engine.execute("insert into t values (1)")  # snapshot 2
    engine.execute("insert into t values (2)")  # snapshot 3
    conn.rollback_to_snapshot("t", 2)
    assert engine.execute("select k from t") == [(1,)]
    assert engine.execute('select k from "t@3" order by k') == [(1,), (2,)]


def test_dml_on_iceberg(engine):
    engine.execute("create table t (k bigint, v double)")
    engine.execute("insert into t values (1, 1.0), (2, 2.0), (3, 3.0)")
    assert engine.execute("delete from t where k = 2") == [(1,)]
    assert engine.execute("select k from t order by k") == [(1,), (3,)]
    engine.execute("update t set v = v * 10 where k = 3")
    assert engine.execute("select k, v from t order by k") == [(1, 1.0), (3, 30.0)]
    assert len(engine.catalogs.get("iceberg").snapshots("t")) >= 4


def test_nulls_roundtrip(engine):
    engine.execute("create table t (k bigint, s varchar)")
    engine.execute("insert into t values (1, null), (2, 'x')")
    assert engine.execute("select k, s from t order by k") == [(1, None), (2, "x")]
    assert engine.execute("select count(s) from t") == [(1,)]


def test_stats_for_cbo(engine):
    engine.execute("create table t (k bigint)")
    engine.execute("insert into t values (5), (10), (15)")
    stats = engine.catalogs.get("iceberg").table_stats("t")
    assert stats.row_count == 3
    assert stats.columns["k"].min == 5.0 and stats.columns["k"].max == 15.0


def test_transactions_snapshot_on_iceberg(engine):
    engine.execute("create table t (k bigint)")
    engine.execute("start transaction")
    engine.execute("insert into t values (1)")
    engine.execute("commit")
    assert engine.execute("select count(*) from t") == [(1,)]


def test_drop_table_rollback(engine):
    engine.execute("create table t (k bigint)")
    engine.execute("insert into t values (7)")
    engine.execute("start transaction")
    engine.execute("drop table t")
    assert engine.execute("show tables") == []
    engine.execute("rollback")
    assert engine.execute("select k from t") == [(7,)]


def test_execute_after_a_commit_sees_the_new_snapshot(engine):
    """A prepared statement EXECUTEd before and after a commit: the table's
    version moves (runtime/resultcache.py table_version reads the current
    snapshot), the fast path re-plans, the executor uploads the new
    snapshot's columns, and the rows follow."""
    from trino_tpu_torch.exec.compiler import _generation
    from trino_tpu_torch.runtime.resultcache import table_version

    conn = engine.catalogs.get("iceberg")
    engine.execute("create table t (k bigint, v double)")
    engine.execute("insert into t values (1, 1.0), (2, 2.0), (3, 3.0)")
    engine.execute("prepare p from select count(*), sum(v) from t where k >= ?")
    assert engine.execute("execute p using 2") == [(2, 5.0)]
    assert engine.execute("execute p using 1") == [(3, 6.0)]
    fp = engine.fastpath()
    assert fp.last_info.cache == "hit"
    version, gen = table_version(conn, "t"), _generation(conn, "t")
    engine.execute("insert into t values (4, 4.0)")
    assert table_version(conn, "t") != version and _generation(conn, "t") != gen
    assert engine.execute("execute p using 2") == [(3, 9.0)]
    assert fp.last_info.cache == "miss"
    cached = {k[-1] for k in engine.executor._table_cols if k[1] == "t"}
    assert cached == {_generation(conn, "t")}  # the old snapshot's columns left
    engine.execute("delete from t where k = 3")
    assert engine.execute("execute p using 1") == [(3, 7.0)]


def test_a_warehouse_the_port_wrote_reads_back_in_the_reference(engine, tmp_path):
    from tests.test_torch_parquet import assert_arrays_equal
    from trino_tpu.connectors.iceberg import IcebergConnector as RefIceberg

    engine.execute("create table t (k bigint, v decimal(12,2), s varchar, d date)")
    engine.execute("insert into t values (1, 1.25, 'a', date '1995-01-02'), "
                   "(2, null, null, date '1996-03-04')")
    engine.execute("insert into t values (3, -7.50, 'c', null)")
    engine.execute("delete from t where k = 1")
    port, ref = engine.catalogs.get("iceberg"), RefIceberg(str(tmp_path / "wh"))
    assert port.snapshots("t") == ref.snapshots("t")
    for table in ("t", "t@3", "t$snapshots"):
        names = [c.name for c in ref.table_schema(table).columns]
        assert port.estimated_row_count(table) == ref.estimated_row_count(table)
        for s, rs in zip(port.get_splits(table, 2), ref.get_splits(table, 2)):
            got, want = port.read_split(s, names), ref.read_split(rs, names)
            for c in names:
                assert_arrays_equal(got[c], want[c], f"{table}.{c}")
    got, want = port.table_stats("t"), ref.table_stats("t")
    assert got.row_count == want.row_count
    bounds = lambda st: {c: (v.min, v.max) for c, v in st.columns.items()}
    assert bounds(got) == bounds(want)
