"""The port's statement surface over its writable memory catalog: the cases
of tests/test_statements.py (DDL, INSERT, CTAS, views, SHOW / DESCRIBE /
EXPLAIN) and the CTAS / INSERT NULL cases of tests/test_nulls.py with the
reference tests' own expected values, on `Engine(device="cpu")` in both
kernel settings; scans of empty tables and of tables that grew after a
plan learned its capacities; the device cache across write generations;
the host write format through `to_numpy_columns` / `Column.from_numpy`;
and whole statement sequences through the reference engine and the port
on the same numpy data (exact, doubles to rel 1e-9)."""

import math

import numpy as np
import pytest
try:  # arrow before torch: loaded after it, arrow's parquet writer crashes the process
    import pyarrow  # noqa: F401
except ImportError:
    pass
import torch

torch.set_num_threads(1)

KERNELS = pytest.mark.parametrize(
    "kernels_on", [True, False], ids=["kernels_on", "kernels_off"]
)


@pytest.fixture(autouse=True)
def _restore_kernel_policy():
    """Every port statement re-applies its session's kernel policy, which is
    process-global: put back what the next test in this worker expects."""
    from trino_tpu_torch.ops import kernels

    saved = kernels.get_policy()
    yield
    kernels.set_policy(saved)


def _port_engine(kernels_on: bool = True, connector=None):
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.runtime.engine import Engine

    eng = Engine(default_catalog="memory", device="cpu")
    eng.register_catalog("memory", connector if connector is not None else MemoryConnector())
    eng.execute(f"set session data_plane_kernels = {'true' if kernels_on else 'false'}")
    return eng


@pytest.fixture(params=[True, False], ids=["kernels_on", "kernels_off"])
def engine(request):
    return _port_engine(request.param)


# ------------------------------------------- tests/test_statements.py, ported


def test_create_insert_select(engine):
    engine.execute("create table t (a bigint, b varchar, c double)")
    assert engine.execute("show tables") == [("t",)]
    assert engine.execute("describe t") == [
        ("a", "bigint"), ("b", "varchar"), ("c", "double"),
    ]
    n = engine.execute("insert into t values (1, 'x', 1.5), (2, 'y', 2.5), (3, 'x', 3.5)")
    assert n == [(3,)]
    rows = engine.execute("select b, sum(a) as s from t group by b order by b")
    assert rows == [("x", 4), ("y", 2)]


def test_insert_select_roundtrip(engine):
    engine.execute("create table src (k bigint, v double)")
    engine.execute("insert into src values (1, 10.0), (2, 20.0), (3, 30.0)")
    engine.execute("create table dst (k bigint, v double)")
    engine.execute("insert into dst select k, v * 2 from src where k <= 2")
    assert engine.execute("select k, v from dst order by k") == [(1, 20.0), (2, 40.0)]


def test_ctas(engine):
    engine.execute("create table src (k bigint)")
    engine.execute("insert into src values (5), (6)")
    n = engine.execute("create table copy as select k + 1 as k1 from src")
    assert n == [(2,)]
    assert engine.execute("select k1 from copy order by k1") == [(6,), (7,)]


def test_drop(engine):
    engine.execute("create table t (a bigint)")
    engine.execute("drop table t")
    assert engine.execute("show tables") == []
    assert engine.execute("drop table if exists t") == [(0,)]


def test_insert_invalidates_scan_cache(engine):
    engine.execute("create table t (a bigint)")
    engine.execute("insert into t values (1)")
    assert engine.execute("select count(*) from t") == [(1,)]
    engine.execute("insert into t values (2), (3)")
    assert engine.execute("select count(*) from t") == [(3,)]


def test_explain_and_session(engine):
    engine.execute("create table t (a bigint)")
    lines = engine.execute("explain select * from t")
    assert any("TableScan" in row[0] for row in lines)
    engine.execute("set session join_distribution_type = 'BROADCAST'")
    assert engine.session.get("join_distribution_type") == "BROADCAST"
    with pytest.raises(Exception):
        engine.execute("set session nonexistent_prop = 1")


def test_blackhole(engine):
    from trino_tpu_torch.connectors.memory import BlackholeConnector

    bh = BlackholeConnector()
    engine.register_catalog("blackhole", bh)
    bh.create_table("sink", [])
    bh.insert("sink", {"x": np.arange(10)})
    assert bh.rows_swallowed == 10
    assert bh.read_split(bh.get_splits("sink", 1)[0], []) == {}


def test_create_view_and_query(engine):
    engine.execute("create table vt (a bigint, b varchar)")
    engine.execute("insert into vt values (1, 'x'), (2, 'y'), (3, 'x')")
    engine.execute("create view v1 as select b, sum(a) as s from vt group by b")
    assert engine.execute("select * from v1 order by b") == [("x", 4), ("y", 2)]
    assert ("v1",) in engine.execute("show tables")
    assert engine.execute("describe v1") == [("b", "varchar"), ("s", "bigint")]
    assert "CREATE VIEW v1 AS" in engine.execute("show create view v1")[0][0]


def test_view_over_view_and_join(engine):
    engine.execute("create table base (k bigint, v bigint)")
    engine.execute("insert into base values (1, 10), (2, 20), (3, 30)")
    engine.execute("create view even as select k, v from base where k % 2 = 0")
    engine.execute("create view doubled as select k, v * 2 as v2 from even")
    assert engine.execute("select k, v2 from doubled order by k") == [(2, 40)]
    rows = engine.execute(
        "select d.v2, b.v from doubled d join base b on d.k = b.k"
    )
    assert rows == [(40, 20)]


def test_view_replace_drop_and_errors(engine):
    engine.execute("create table rt (x bigint)")
    engine.execute("insert into rt values (1), (2)")
    engine.execute("create view rv as select x from rt")
    with pytest.raises(Exception, match="already exists"):
        engine.execute("create view rv as select x + 1 as y from rt")
    engine.execute("create or replace view rv as select x + 1 as y from rt")
    assert engine.execute("select * from rv order by y") == [(2,), (3,)]
    engine.execute("drop view rv")
    with pytest.raises(Exception):
        engine.execute("select * from rv")
    engine.execute("drop view if exists rv")  # no error
    with pytest.raises(Exception, match="not found"):
        engine.execute("drop view rv")


def test_view_validated_at_create(engine):
    with pytest.raises(Exception):
        engine.execute("create view bad as select nope from missing_table")
    assert ("bad",) not in engine.execute("show tables")


def test_view_cycle_detected(engine):
    engine.execute("create table ct (x bigint)")
    engine.execute("create view cv1 as select x from ct")
    engine.execute("create view cv2 as select x from cv1")
    with pytest.raises(Exception, match="cycle"):
        engine.execute("create or replace view cv1 as select x from cv2")
    # the failed replace must roll back to the previous definition
    engine.execute("insert into ct values (7)")
    assert engine.execute("select * from cv2") == [(7,)]


def test_view_base_table_access_control(engine):
    from trino_tpu_torch.runtime.security import (
        AllowAllAccessControl, FileBasedAccessControl,
    )

    engine.execute("create table sec (x bigint)")
    engine.execute("insert into sec values (1)")
    engine.execute("create view sv as select x from sec")
    engine.access_control = FileBasedAccessControl(
        {"tables": [{"user": "*", "table": "other", "privileges": ["SELECT"]}]}
    )
    try:
        with pytest.raises(Exception):
            engine.execute("select * from sv")
    finally:
        engine.access_control = AllowAllAccessControl()


def test_view_cannot_shadow_table(engine):
    engine.execute("create table shadowed (x bigint)")
    with pytest.raises(Exception, match="already exists"):
        engine.execute("create view shadowed as select 1 as y")


def test_view_ddl_in_rolled_back_transaction(engine):
    engine.execute("create table txt (x bigint)")
    engine.execute("insert into txt values (1)")
    engine.execute("create view keepv as select x from txt")
    engine.execute("start transaction")
    engine.execute("create view tempv as select x + 1 as y from txt")
    engine.execute("drop view keepv")
    engine.execute("rollback")
    assert ("tempv",) not in engine.execute("show tables")
    assert engine.execute("select * from keepv") == [(1,)]


def test_schema_qualified_view_name(engine):
    engine.execute("create table qt (x bigint)")
    engine.execute("insert into qt values (9)")
    engine.execute("create view myschema.qv as select x from qt")
    assert engine.execute("select * from myschema.qv") == [(9,)]
    assert engine.execute("select * from qv") == [(9,)]
    engine.execute("drop view myschema.qv")
    assert ("qv",) not in engine.execute("show tables")


# ---------------------------- tests/test_nulls.py write path cases, ported


def test_ctas_preserves_nulls_from_left_join(engine):
    engine.execute("create table l (k bigint)")
    engine.execute("insert into l values (1), (2)")
    engine.execute("create table r (k bigint, v double)")
    engine.execute("insert into r values (1, 10.0)")
    engine.execute(
        "create table joined as "
        "select l.k as k, r.v as v from l left join r on l.k = r.k"
    )
    rows = engine.execute("select k, v from joined order by k")
    assert rows == [(1, 10.0), (2, None)]
    assert engine.execute("select count(v) from joined") == [(1,)]
    assert engine.execute("select k from joined where v is null") == [(2,)]


def test_insert_select_preserves_null_literals(engine):
    engine.execute("create table t (a bigint, b varchar)")
    engine.execute("insert into t values (1, 'x'), (null, null)")
    engine.execute("create table u (a bigint, b varchar)")
    engine.execute("insert into u select a, b from t")
    rows = engine.execute("select a, b from u order by a nulls first")
    assert rows == [(None, None), (1, "x")]


# ------------------------------------------------------- the port's repairs


@pytest.mark.parametrize("sql,want", [
    ("select count(*), sum(x) from e", [(0, None)]),
    ("select count(*), min(s), max(d) from e", [(0, None, None)]),
    ("select s, count(*) from e group by s", []),
    ("select x, s from e order by x limit 3", []),
    ("select e.x from e join f on e.x = f.y", []),
    ("select f.y, e.x from f left join e on e.x = f.y order by f.y", [(1, None), (2, None)]),
], ids=["global", "min_max", "grouped", "topn", "inner_join", "left_join"])
def test_empty_table_scans(engine, sql, want):
    """An empty table scans as one dead row: aggregates over it give their
    empty-input values instead of raising."""
    engine.execute("create table e (x bigint, s varchar, d date)")
    engine.execute("create table f (y bigint)")
    engine.execute("insert into f values (1), (2)")
    assert engine.execute(sql) == want


@KERNELS
def test_growth_after_learned_capacities(kernels_on):
    """A plan that learned its capacities before a write keeps every row
    after it: a table that grew 2500-fold, and one whose row count stayed
    while an UPDATE turned one group into 5000."""
    eng = _port_engine(kernels_on)
    eng.execute("create table g (k bigint, v bigint)")
    eng.execute("insert into g values (1, 1), (2, 2)")
    sql = "select k, sum(v) from g group by k order by k"
    assert eng.execute(sql) == [(1, 1), (2, 2)]
    n = 5000
    eng.execute(
        "insert into g values " + ", ".join(f"({k}, {k})" for k in range(3, n + 1))
    )
    assert eng.execute(sql) == [(k, k) for k in range(1, n + 1)]
    eng.execute("update g set k = 7")
    assert eng.execute(sql) == [(7, n * (n + 1) // 2)]
    eng.execute("update g set k = v")
    assert eng.execute(sql) == [(k, k) for k in range(1, n + 1)]


def test_stale_generations_leave_the_device_cache(engine):
    """After each write only the current generation of a table stays cached."""
    engine.execute("create table w (a bigint, b varchar)")
    for i in range(4):
        engine.execute(f"insert into w values ({i}, 's{i}')")
        assert engine.execute("select count(*), max(b) from w") == [(i + 1, f"s{i}")]
        ex = engine.executor
        gens = {k[-1] for k in ex._table_cols if k[:2] == ("memory", "w")}
        assert gens == {engine.catalogs.get("memory").generation}
        assert {k[-1] for k in ex._table_pages if k[:2] == ("memory", "w")} == gens
    engine.execute("drop table w")
    assert not [k for k in engine.executor._table_cols if k[:2] == ("memory", "w")]


def test_write_keeps_other_tables_cached(engine):
    """Generations are per table: a write re-uploads only the table it
    changed, and a table dropped and created again never meets its old
    columns."""
    engine.execute("create table a (x bigint)")
    engine.execute("create table b (y bigint)")
    engine.execute("insert into a values (1), (2)")
    engine.execute("insert into b values (10)")
    assert engine.execute("select sum(y) from b") == [(10,)]
    cached_b = {k: v for k, v in engine.executor._table_cols.items() if k[1] == "b"}
    engine.execute("insert into a values (3)")
    engine.execute("delete from a where x = 1")
    assert engine.execute("select sum(y) from b") == [(10,)]
    assert {k: v for k, v in engine.executor._table_cols.items() if k[1] == "b"} == cached_b
    assert engine.execute("select sum(x) from a") == [(5,)]
    engine.execute("drop table b")
    engine.execute("create table b (y bigint)")
    engine.execute("insert into b values (20)")
    assert engine.execute("select sum(y) from b") == [(20,)]
    engine.execute("start transaction")
    engine.execute("insert into b values (1)")
    assert engine.execute("select sum(y) from b") == [(21,)]
    engine.execute("rollback")
    assert engine.execute("select sum(y) from b") == [(20,)]


def test_write_format_round_trips():
    """`to_numpy_columns` gives NULL lanes as masked arrays, decimal128 as
    exact python ints and VARCHAR as object strings, and `Column.from_numpy`
    takes each back unchanged; a CTAS through the port keeps them."""
    from trino_tpu_torch.convert import memory_catalog_from_numpy
    from trino_tpu_torch.data.page import Column, Page
    from trino_tpu_torch.data.types import parse_type

    big = 10 ** 30 + 7
    schema = [("i", "bigint"), ("s", "varchar"), ("d", "decimal(38,2)"), ("f", "double")]
    data = {
        "i": np.ma.MaskedArray(np.array([1, 0, 3], np.int64), mask=[False, True, False]),
        "s": np.array(["a", "bb", "a"], dtype=object),
        "d": np.array([big, -big, 5], dtype=object),
        "f": np.array([0.5, 1.5, -2.0]),
    }
    types = [parse_type(t) for _, t in schema]
    page = Page.from_numpy(types, [data[n] for n, _ in schema], device="cpu")
    out = page.to_numpy_columns()
    assert isinstance(out[0], np.ma.MaskedArray)
    assert out[0].mask.tolist() == [False, True, False]
    assert out[0].compressed().tolist() == [1, 3]
    assert out[1].dtype == object and out[1].tolist() == ["a", "bb", "a"]
    assert out[2].dtype == object and out[2].tolist() == [big, -big, 5]
    assert all(type(v) is int for v in out[2])
    assert out[3].tolist() == [0.5, 1.5, -2.0]
    again = Page(tuple(Column.from_numpy(t, a, device="cpu") for t, a in zip(types, out)))
    assert again.to_pylist() == page.to_pylist()

    eng = _port_engine(True, memory_catalog_from_numpy({"src": (schema, data)}))
    eng.execute("create table dst as select * from src")
    assert eng.execute("select * from dst") == page.to_pylist()
    assert eng.execute("select count(i), count(*) from dst") == [(2, 3)]


# ------------------------------------- whole sequences: reference vs the port

SEQ_SCHEMA = {
    "items": [("k", "bigint"), ("g", "varchar"), ("q", "bigint"), ("p", "double"),
              ("d", "date")],
    "updates": [("k", "bigint"), ("p", "double")],
}

SEQUENCES = {
    "ctas_insert_delete_update": [
        "create table work as select k, g, q, p, d from items where q > 10",
        "insert into work select k + 1000, g, q, p * 2, d from items where g = 'b'",
        "delete from work where p > 400 and g <> 'c'",
        "update work set q = q + 1, p = p / 2 where g = 'a'",
        "insert into work values (9999, 'z', 1, 0.25, date '1999-01-01'), "
        "(9998, null, null, null, null)",
    ],
    "merge": [
        "create table work as select k, g, q, p from items",
        "merge into work t using updates s on t.k = s.k "
        "when matched and s.p > 450 then delete "
        "when matched then update set p = s.p, q = t.q + 1 "
        "when not matched then insert (k, g, q, p) values (s.k, 'new', 0, s.p)",
    ],
    "rollback": [
        "create table work as select k, g, p from items",
        "start transaction",
        "delete from work where k % 3 = 0",
        "insert into work values (5000, 'x', 1.0)",
        "update work set p = 0.0",
        "rollback",
        "start transaction",
        "delete from work where g = 'd'",
        "commit",
    ],
}


def _seq_data():
    rng = np.random.default_rng(20261017)
    n = 300
    g = rng.choice(np.array(["a", "b", "c", "d"], dtype=object), n)
    q = rng.integers(0, 50, n).astype(np.int64)
    qmask = rng.random(n) < 0.05
    items = {
        "k": np.arange(n, dtype=np.int64),
        "g": g,
        "q": np.ma.MaskedArray(q, mask=qmask),
        "p": np.round(rng.random(n) * 500, 2),
        "d": rng.integers(9000, 11000, n).astype(np.int32),
    }
    uk = np.concatenate([rng.choice(n, 40, replace=False), np.arange(n, n + 15)])
    updates = {"k": uk.astype(np.int64), "p": np.round(rng.random(len(uk)) * 500, 2)}
    return {"items": items, "updates": updates}


def _rows_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for x, y in zip(g, w):
            if isinstance(x, float) or isinstance(y, float):
                assert x is not None and y is not None
                assert math.isclose(x, y, rel_tol=1e-9, abs_tol=1e-12), (g, w)
            else:
                assert x == y, (g, w)


@pytest.fixture()
def reference_policy():
    """The reference engine applies its session's policy to its own
    process-global kernel switch: restore it too."""
    from trino_tpu.ops import kernels as ref_kernels

    saved = ref_kernels.get_policy()
    yield
    ref_kernels.set_policy(saved)


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_sequence_equals_reference(name, reference_policy):
    from trino_tpu.connectors.memory import MemoryConnector as RefMemory
    from trino_tpu.connectors.spi import ColumnSchema as RefColumn
    from trino_tpu.data.types import parse_type as ref_type
    from trino_tpu.runtime.engine import Engine as RefEngine
    from trino_tpu_torch.convert import memory_catalog_from_numpy

    data = _seq_data()
    ref_conn = RefMemory()
    for t, schema in SEQ_SCHEMA.items():
        ref_conn.create_table(t, [RefColumn(c, ref_type(ty)) for c, ty in schema])
        ref_conn.insert(t, {c: data[t][c] for c, _ in schema})
    ref = RefEngine(default_catalog="memory")
    ref.register_catalog("memory", ref_conn)
    port = _port_engine(True, memory_catalog_from_numpy(
        {t: (schema, data[t]) for t, schema in SEQ_SCHEMA.items()}
    ))
    for sql in SEQUENCES[name]:
        assert port.execute(sql) == ref.execute(sql), sql
    final = "select * from work order by k"
    _rows_close(port.execute(final), ref.execute(final))


# ------------------------------------ EXPLAIN, and errors against the reference


def test_explain_analyze_query(engine):
    engine.execute("create table x (k bigint, g varchar)")
    engine.execute("insert into x values (1, 'a'), (2, 'b'), (3, 'a')")
    lines = [r[0] for r in engine.execute(
        "explain analyze select g, count(*) from x group by g order by g"
    )]
    assert any("TableScan memory.x" in ln for ln in lines)
    assert any("[rows: 2" in ln for ln in lines), lines
    assert any(ln.startswith("-- slowest operator: ") for ln in lines)
    assert "-- output rows: 2," in "\n".join(lines)
    assert engine.execute("select g, count(*) from x group by g order by g") == [
        ("a", 2), ("b", 1),
    ]


def test_explain_json_and_execute(engine):
    import json

    engine.execute("create table x (k bigint)")
    engine.execute("insert into x values (1), (2), (3)")
    engine.execute("set session explain_format = 'json'")
    obj = json.loads(engine.execute("explain select k from x where k > 1")[0][0])
    assert "TableScan" in json.dumps(obj)
    engine.execute("set session explain_format = 'text'")
    engine.execute("prepare p from select k from x where k > ? order by k")
    lines = [r[0] for r in engine.execute("explain analyze execute p using 1")]
    assert "-- output rows: 2," in "\n".join(lines)
    assert lines[-1] == ("-- fastpath: plan_cache=miss bound=1 baked=0 "
                         "batch_window_ms=0 executor=local")
    lines = [r[0] for r in engine.execute("explain delete from x where k = 1")]
    assert lines == ["Write[Delete -> x]"]
    assert engine.execute("select count(*) from x") == [(3,)]  # not executed


ERRORS = {
    "insert_arity": "insert into t (k) select k, k from t",
    "insert_values_not_literal": "insert into t values (1 + k, 'x')",
    "update_unknown_column": "update t set nope = 1",
    "drop_view_missing": "drop view nope",
    "show_create_view_missing": "show create view nope",
    "view_exists": "create view tv as select 1 as y",
    "view_shadows_table": "create view t as select 1 as y",
    "table_exists": "create table t (a bigint)",
    "execute_missing": "execute nope",
    "commit_without_transaction": "commit",
    "rollback_without_transaction": "rollback",
    "merge_multi_match": "merge into t using (select 1 as k union all select 1 as k) s "
                         "on t.k = s.k when matched then delete",
    "merge_two_inserts": "merge into t using t s on t.k = s.k "
                         "when not matched then insert values (s.k, s.s) "
                         "when not matched then insert values (s.k, s.s)",
    "scalar_subquery_rows": "insert into t select (select k from t), 'x'",
}


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_error_equals_reference(name, reference_policy):
    """Each failing statement raises the reference's exception type with the
    reference's message, and leaves the table as it was."""
    from trino_tpu.connectors.memory import MemoryConnector as RefMemory
    from trino_tpu.runtime.engine import Engine as RefEngine

    ref = RefEngine(default_catalog="memory")
    ref.register_catalog("memory", RefMemory())
    port = _port_engine(True)
    outcomes = []
    for eng in (ref, port):
        eng.execute("create table t (k bigint, s varchar)")
        eng.execute("insert into t values (1, 'a'), (2, 'b')")
        eng.execute("create view tv as select k from t")
        with pytest.raises(Exception) as info:
            eng.execute(ERRORS[name])
        outcomes.append((type(info.value).__name__, str(info.value)))
        assert eng.execute("select k, s from t order by k") == [(1, "a"), (2, "b")]
    assert outcomes[1] == outcomes[0]
