"""The port's DB-API connectors (trino_tpu_torch/connectors/dbapi.py): the
seven single-process tests of tests/test_dbapi_connector.py on a CPU engine,
`read_split` against the JAX package's connector in 1 and 2 splits, and a
table of one split scanned out of core in more parts than it has splits."""

import sqlite3

import pytest
try:  # arrow before torch: loaded after it, arrow's parquet writer crashes the process
    import pyarrow  # noqa: F401
except ImportError:
    pass
import torch

torch.set_num_threads(1)

ROWS = [(1, 1.5, "a"), (2, 2.5, "b"), (3, None, "c"), (4, 4.5, None)]


@pytest.fixture(autouse=True)
def _restore_kernel_policy():
    from trino_tpu_torch.ops import kernels

    saved = kernels.get_policy()
    yield
    kernels.set_policy(saved)


@pytest.fixture()
def db(tmp_path):
    path = str(tmp_path / "ext.db")
    conn = sqlite3.connect(path)
    conn.execute("create table ext (k integer, v real, s text)")
    conn.executemany("insert into ext values (?, ?, ?)", ROWS)
    conn.commit()
    conn.close()
    return path


@pytest.fixture()
def engine(db):
    from trino_tpu_torch.connectors.dbapi import SqliteConnector
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.runtime.engine import Engine

    eng = Engine(default_catalog="sqlite", device="cpu")
    eng.register_catalog("sqlite", SqliteConnector(db, splits_per_table=2))
    eng.register_catalog("memory", MemoryConnector())
    return eng


def test_schema_discovery(engine):
    assert engine.execute("show tables") == [("ext",)]
    assert engine.execute("describe ext") == [
        ("k", "bigint"), ("v", "double"), ("s", "varchar"),
    ]


def test_scan_with_nulls(engine):
    assert engine.execute("select k, v, s from ext order by k") == ROWS


def test_aggregate_over_dbapi(engine):
    assert engine.execute("select count(*), sum(v) from ext") == [(4, 8.5)]


def test_join_with_memory_catalog(engine):
    engine.execute("create table memory.dim (k bigint, name varchar)")
    engine.execute("insert into memory.dim values (1, 'one'), (3, 'three')")
    rows = engine.execute(
        "select e.k, d.name from ext e join memory.dim d on e.k = d.k order by e.k")
    assert rows == [(1, "one"), (3, "three")]


def test_write_path(engine):
    engine.execute("create table out_t (k bigint, s varchar)")
    engine.execute("insert into out_t values (10, 'x'), (20, null)")
    assert engine.execute("select k, s from out_t order by k") == [(10, "x"), (20, None)]
    db = engine.catalogs.get("sqlite").database
    raw = sqlite3.connect(db).execute("select k, s from out_t order by k").fetchall()
    assert raw == [(10, "x"), (20, None)]


def test_dml_through_engine(engine):
    engine.execute("create table d (k bigint)")
    engine.execute("insert into d values (1), (2), (3)")
    assert engine.execute("select count(*) from d") == [(3,)]


def test_decimal_scaling(engine, tmp_path):
    from trino_tpu_torch.connectors.dbapi import SqliteConnector

    path = str(tmp_path / "dec.db")
    c = sqlite3.connect(path)
    c.execute("create table m (price decimal(10,2))")
    c.execute("insert into m values (12.34)")
    c.commit()
    c.close()
    engine.register_catalog("sq", SqliteConnector(path))
    assert engine.execute("select price from sq.m") == [(12.34,)]


@pytest.mark.parametrize("parts", [1, 2])
def test_read_split_equals_the_reference(parts, db):
    from trino_tpu.connectors.dbapi import SqliteConnector as RefSqlite
    from trino_tpu_torch.connectors.dbapi import SqliteConnector
    from tests.test_torch_parquet import assert_arrays_equal

    port, ref = SqliteConnector(db, splits_per_table=2), RefSqlite(db, splits_per_table=2)
    assert port.list_tables() == ref.list_tables()
    assert [(c.name, c.type.name) for c in port.table_schema("ext").columns] == [
        (c.name, c.type.name) for c in ref.table_schema("ext").columns]
    names = ["k", "v", "s"]
    for s, rs in zip(port.get_splits("ext", parts), ref.get_splits("ext", parts)):
        got, want = port.read_split(s, names), ref.read_split(rs, names)
        for c in names:
            assert_arrays_equal(got[c], want[c], f"ext.{c} part {s.part}/{parts}")


def test_one_split_out_of_core_in_more_parts(db):
    """A DB-API table makes one split: out of core in 2 parts, the second
    slice is empty and the rows equal the in-memory run's."""
    from trino_tpu_torch.connectors.dbapi import SqliteConnector
    from trino_tpu_torch.runtime.engine import Engine

    eng = Engine(default_catalog="sqlite", device="cpu")
    eng.register_catalog("sqlite", SqliteConnector(db))
    sql = "select s, count(*), sum(v) from ext group by s order by s"
    want = eng.query(sql)
    eng.session.set("query_max_memory_bytes", "1")
    try:
        assert eng.query(sql) == want
    finally:
        eng.session.set("query_max_memory_bytes", "0")
    assert eng.last_spill is not None and eng.last_spill.parts >= 2
