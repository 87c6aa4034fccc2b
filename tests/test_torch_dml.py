"""The port's row-level DML (DELETE / UPDATE / MERGE), prepared statements
and transactions: the cases of tests/test_dml.py on the port's
`Engine(device="cpu")` over its memory catalog, in both kernel settings
(every statement reads through operators: the rewrites are queries, MERGE's
a LEFT JOIN and a GROUP BY guard).  Each case keeps the reference test's
expected values, or its sqlite mirror: the same SQL applied to an in-memory
sqlite database and the results diffed after the writes (exact)."""

import sqlite3

import pytest
try:  # arrow before torch: loaded after it, arrow's parquet writer crashes the process
    import pyarrow  # noqa: F401
except ImportError:
    pass
import torch

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _restore_kernel_policy():
    """Every port statement re-applies its session's kernel policy, which is
    process-global: put back what the next test in this worker expects."""
    from trino_tpu_torch.ops import kernels

    saved = kernels.get_policy()
    yield
    kernels.set_policy(saved)


@pytest.fixture(params=[True, False], ids=["kernels_on", "kernels_off"])
def engine(request):
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.runtime.engine import Engine

    eng = Engine(default_catalog="memory", device="cpu")
    eng.register_catalog("memory", MemoryConnector())
    eng.execute(f"set session data_plane_kernels = {'true' if request.param else 'false'}")
    return eng


@pytest.fixture()
def mirror(engine):
    """(engine, sqlite) pair that applies the same SQL to both and diffs."""
    db = sqlite3.connect(":memory:")

    class Mirror:
        def both(self, sql):
            engine.execute(sql)
            db.execute(sql)

        def check(self, sql):
            got = engine.execute(sql)
            want = [tuple(r) for r in db.execute(sql).fetchall()]
            assert got == want, f"{sql}\n got={got}\nwant={want}"

    m = Mirror()
    m.both("create table t (k bigint, v double, s varchar)")
    m.both("insert into t values (1, 1.5, 'a'), (2, 2.5, 'b'), "
           "(3, NULL, 'c'), (4, 4.0, NULL), (5, 5.5, 'b')")
    yield m
    db.close()


# ------------------------------------------------------------------- DELETE


def test_delete_where(mirror):
    mirror.both("delete from t where v > 2.0")
    mirror.check("select k, v, s from t order by k")


def test_delete_null_predicate_survives(mirror):
    # v is NULL for k=3: predicate is NULL there -> row must survive
    mirror.both("delete from t where v < 100.0")
    mirror.check("select k, v, s from t order by k")


def test_delete_string_predicate(mirror):
    mirror.both("delete from t where s = 'b'")
    mirror.check("select k, v, s from t order by k")


def test_delete_all(engine):
    engine.execute("create table d (x bigint)")
    engine.execute("insert into d values (1), (2), (3)")
    assert engine.execute("delete from d") == [(3,)]
    assert engine.execute("select count(*) from d") == [(0,)]


def test_delete_count(engine):
    engine.execute("create table d (x bigint)")
    engine.execute("insert into d values (1), (2), (3), (4)")
    assert engine.execute("delete from d where x >= 3") == [(2,)]


# ------------------------------------------------------------------- UPDATE


def test_update_where(mirror):
    mirror.both("update t set v = v * 10 where k <= 2")
    mirror.check("select k, v, s from t order by k")


def test_update_multiple_columns(mirror):
    mirror.both("update t set v = 0.0, s = 'z' where k = 4")
    mirror.check("select k, v, s from t order by k")


def test_update_all_rows(mirror):
    mirror.both("update t set v = 1.0")
    mirror.check("select k, v, s from t order by k")


def test_update_null_predicate_untouched(mirror):
    # rows where the predicate is NULL must keep their values
    mirror.both("update t set s = 'hit' where v > 0")
    mirror.check("select k, v, s from t order by k")


def test_update_string_case(engine):
    engine.execute("create table u (k bigint, s varchar)")
    engine.execute("insert into u values (1, 'a'), (2, 'b')")
    engine.execute("update u set s = upper(s) where k = 2")
    assert engine.execute("select s from u order by k") == [("a",), ("B",)]


def test_update_count(engine):
    engine.execute("create table u (k bigint)")
    engine.execute("insert into u values (1), (2), (3)")
    assert engine.execute("update u set k = k + 100 where k >= 2") == [(2,)]


# -------------------------------------------------------------------- MERGE


def test_merge_update_delete_insert(engine):
    engine.execute("create table tgt (k bigint, v double)")
    engine.execute("insert into tgt values (1, 10.0), (2, 20.0), (3, 30.0)")
    engine.execute("create table src (k bigint, v double)")
    engine.execute("insert into src values (2, 200.0), (3, 300.0), (4, 400.0)")
    n = engine.execute(
        "merge into tgt t using src s on t.k = s.k "
        "when matched and s.v > 250 then delete "
        "when matched then update set v = s.v "
        "when not matched then insert (k, v) values (s.k, s.v)"
    )
    assert n == [(3,)]  # 1 update + 1 delete + 1 insert
    assert engine.execute("select k, v from tgt order by k") == [
        (1, 10.0), (2, 200.0), (4, 400.0),
    ]


def test_merge_clause_order_first_match_wins(engine):
    # an earlier UPDATE clause must shadow a later DELETE clause
    engine.execute("create table tgt (k bigint, v double)")
    engine.execute("insert into tgt values (1, 10.0)")
    engine.execute("create table src (k bigint, v double)")
    engine.execute("insert into src values (1, 99.0)")
    engine.execute(
        "merge into tgt t using src s on t.k = s.k "
        "when matched and s.v > 50 then update set v = s.v "
        "when matched then delete"
    )
    assert engine.execute("select k, v from tgt") == [(1, 99.0)]


def test_merge_subquery_source(engine):
    engine.execute("create table tgt (k bigint, v double)")
    engine.execute("insert into tgt values (1, 1.0)")
    engine.execute("create table raw (k bigint, v double)")
    engine.execute("insert into raw values (1, 5.0), (1, 7.0), (2, 9.0)")
    engine.execute(
        "merge into tgt t using "
        "(select k, sum(v) as sv from raw group by k) s on t.k = s.k "
        "when matched then update set v = s.sv "
        "when not matched then insert (k, v) values (s.k, s.sv)"
    )
    assert engine.execute("select k, v from tgt order by k") == [(1, 12.0), (2, 9.0)]


def test_merge_insert_only(engine):
    engine.execute("create table tgt (k bigint, v double)")
    engine.execute("insert into tgt values (1, 1.0)")
    engine.execute("create table src (k bigint, v double)")
    engine.execute("insert into src values (1, 9.0), (5, 55.0)")
    n = engine.execute(
        "merge into tgt t using src s on t.k = s.k "
        "when not matched then insert values (s.k, s.v)"
    )
    assert n == [(1,)]
    assert engine.execute("select k, v from tgt order by k") == [(1, 1.0), (5, 55.0)]


# --------------------------------------------------- PREPARE / EXECUTE


def test_prepare_execute(engine):
    engine.execute("create table t (k bigint, s varchar)")
    engine.execute("insert into t values (1,'a'), (2,'b'), (3,'c')")
    engine.execute("prepare q1 from select k, s from t where k > ? order by k")
    assert engine.execute("execute q1 using 1") == [(2, "b"), (3, "c")]
    assert engine.execute("execute q1 using 2") == [(3, "c")]


def test_prepare_string_param(engine):
    engine.execute("create table t (k bigint, s varchar)")
    engine.execute("insert into t values (1,'a'), (2,'b')")
    engine.execute("prepare q from select k from t where s = ?")
    assert engine.execute("execute q using 'b'") == [(2,)]


def test_prepare_dml(engine):
    engine.execute("create table t (k bigint)")
    engine.execute("insert into t values (1), (2), (3)")
    engine.execute("prepare d from delete from t where k = ?")
    assert engine.execute("execute d using 2") == [(1,)]
    assert engine.execute("select k from t order by k") == [(1,), (3,)]


def test_deallocate(engine):
    engine.execute("create table t (k bigint)")
    engine.execute("prepare q from select * from t")
    engine.execute("deallocate prepare q")
    with pytest.raises(KeyError):
        engine.execute("execute q")


def test_execute_unknown_raises(engine):
    with pytest.raises(KeyError):
        engine.execute("execute nope")


# ------------------------------------------------------------- transactions


def test_transaction_rollback(engine):
    engine.execute("create table t (k bigint)")
    engine.execute("insert into t values (1), (2)")
    engine.execute("start transaction")
    engine.execute("insert into t values (9)")
    engine.execute("delete from t where k = 1")
    assert engine.execute("select k from t order by k") == [(2,), (9,)]
    engine.execute("rollback")
    assert engine.execute("select k from t order by k") == [(1,), (2,)]


def test_transaction_commit(engine):
    engine.execute("create table t (k bigint)")
    engine.execute("insert into t values (1)")
    engine.execute("begin")
    engine.execute("update t set k = 100")
    engine.execute("commit")
    assert engine.execute("select k from t") == [(100,)]


def test_transaction_rollback_ddl(engine):
    engine.execute("start transaction")
    engine.execute("create table t2 (k bigint)")
    engine.execute("rollback")
    assert engine.execute("show tables") == []


def test_nested_transaction_raises(engine):
    engine.execute("start transaction")
    with pytest.raises(RuntimeError):
        engine.execute("start transaction")
    engine.execute("commit")
    with pytest.raises(RuntimeError):
        engine.execute("commit")


def test_merge_multi_match_is_error(engine):
    # reference semantics: 'One MERGE target table row matched more than one
    # source row' is an error, not silent duplication
    engine.execute("create table tgt (k bigint, v double)")
    engine.execute("insert into tgt values (1, 1.0)")
    engine.execute("create table src (k bigint, v double)")
    engine.execute("insert into src values (1, 5.0), (1, 7.0)")
    with pytest.raises(ValueError):
        engine.execute(
            "merge into tgt t using src s on t.k = s.k "
            "when matched then update set v = s.v"
        )
    # target unchanged
    assert engine.execute("select k, v from tgt") == [(1, 1.0)]


def test_update_count_pre_image(engine):
    # WHERE references the assigned column: count on the pre-image
    engine.execute("create table u2 (x bigint)")
    engine.execute("insert into u2 values (6), (7), (1)")
    assert engine.execute("update u2 set x = 0 where x > 5") == [(2,)]


def test_insert_arity_mismatch_raises(engine):
    engine.execute("create table a1 (x bigint)")
    engine.execute("insert into a1 values (1)")
    with pytest.raises(ValueError):
        engine.execute("insert into a1 (x) select x, x from a1")


def test_merge_insert_only_multimatch_source(engine):
    # insert-only MERGE must not rewrite (and so cannot duplicate) the
    # target, even when one target row matches several source rows;
    # unaliased table source resolves by its table name
    engine.execute("create table t2 (k bigint, v double)")
    engine.execute("insert into t2 values (1, 10.0)")
    engine.execute("create table s2 (k bigint, v double)")
    engine.execute("insert into s2 values (1, 111.0), (1, 222.0), (2, 20.0)")
    n = engine.execute(
        "merge into t2 using s2 on t2.k = s2.k "
        "when not matched then insert (k, v) values (s2.k, s2.v)"
    )
    assert n == [(1,)]
    assert engine.execute("select k, v from t2 order by k") == [(1, 10.0), (2, 20.0)]


# ------------------------------------------------ INSERT with a column list


def test_insert_column_list_leaves_the_other_columns_null(engine):
    """Columns left out of an INSERT's column list are NULL, of every type
    (VARCHAR included), through INSERT ... VALUES and INSERT ... SELECT, and
    the table stays readable after a later full-row insert — against the
    same statements on sqlite.  (The reference fills them with zeros, and
    with the integer 0 for VARCHAR: ROADMAP C.)"""
    db = sqlite3.connect(":memory:")

    def both(sql):
        engine.execute(sql)
        db.execute(sql)

    def check(sql):
        got = engine.execute(sql)
        want = [tuple(r) for r in db.execute(sql).fetchall()]
        assert got == want, f"{sql}\n got={got}\nwant={want}"
        return got

    both("create table w (a bigint, c double, d date, s varchar)")
    both("insert into w (a) values (1)")
    assert check("select a, c, d, s from w") == [(1, None, None, None)]
    check("select c is null, d is null, s is null from w")
    both("insert into w (s, a) select 'q', a + 10 from w")
    both("insert into w (c, a) select 2.5, a + 20 from w where a = 1")
    both("insert into w values (2, 1.5, '2020-01-01', 'x')")
    check("select a, c, d, s from w order by a")
    check("select count(*), count(c), count(d), count(s) from w")
    check("select s, count(*) from w group by s order by s nulls last")
    db.close()
