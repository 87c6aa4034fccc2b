"""The port's prepared-statement fast path (runtime/fastpath.py, ir.Param in
ops/expr.py): the Engine-level cases of tests/test_fastpath.py on
`Engine(device="cpu")` — one plan-cache miss then hits with no re-plan and no
new learned-capacity entry after the first binding (the reference's
zero-retrace witness, with the port's own counters), bindings equal to the
literal query, the plan-cache events, quote-bearing strings staying data,
invalidation by DML, the kill switch, arity errors, batched and fallback
windows — and every EXECUTE and EXPLAIN EXECUTE footer held against the
reference engine's.  Then the protocol cases on a port cluster of CPU workers:
PREPARE / EXECUTE / DEALLOCATE through `StatementClient` (and a client holding
only the header registry), the EXPLAIN ANALYZE EXECUTE footer, DB-API binding."""

import re
import threading

import numpy as np
import pytest
try:  # arrow before torch: loaded after it, arrow's parquet writer crashes the process
    import pyarrow  # noqa: F401
except ImportError:
    pass
import torch

torch.set_num_threads(1)


def assert_rows_equal(*args, **kw):
    # imported here: chip_smoke.py loads this file for TEMPLATES and
    # port_engine on a machine without the JAX package
    from tests.oracle import assert_rows_equal as check

    check(*args, **kw)


def port_engine(device):
    """A port engine over TPC-H SF 0.01 (the tests' and chip_smoke's)."""
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.runtime.engine import Engine

    eng = Engine(default_catalog="tpch", device=device)
    eng.register_catalog("tpch", TpchConnector(0.01))
    return eng


@pytest.fixture(autouse=True)
def _restore_kernel_policy():
    from trino_tpu_torch.ops import kernels

    saved = kernels.get_policy()
    yield
    kernels.set_policy(saved)


@pytest.fixture(scope="module")
def engine():
    return port_engine("cpu")


@pytest.fixture(scope="module")
def ref_engine():
    from trino_tpu.connectors.tpch import TpchConnector
    from trino_tpu.runtime.engine import Engine

    eng = Engine(default_catalog="tpch")
    eng.register_catalog("tpch", TpchConnector(0.01))
    return eng


# --------------------------------------------------------------- zero re-plan
def test_one_plan_serves_every_binding(engine):
    """>= 3 distinct bindings share ONE cached plan: one miss, then hits; no
    planner call and no new learned-capacity entry after the first."""
    from trino_tpu_torch.runtime.fastpath import PLAN_CACHE_EVENTS

    engine.execute(
        "PREPARE zr FROM select l_returnflag, count(*) c, sum(l_quantity) q "
        "from lineitem where l_quantity < ? group by l_returnflag "
        "order by l_returnflag"
    )
    fp = engine.fastpath()
    planner_calls = []
    real_plan = engine.planner.plan
    engine.planner.plan = lambda *a, **kw: planner_calls.append(1) or real_plan(*a, **kw)
    h0, m0 = PLAN_CACHE_EVENTS.value("hit"), PLAN_CACHE_EVENTS.value("miss")
    try:
        engine.execute("EXECUTE zr USING 11.0")
        caps = len(engine.executor._learned_caps)
        plans, calls = fp.plans_made, len(planner_calls)
        for v in (24.0, 37.0, 49.0):
            engine.execute(f"EXECUTE zr USING {v}")
        assert len(engine.executor._learned_caps) == caps
        assert fp.plans_made == plans and len(planner_calls) == calls == 1
    finally:
        engine.planner.plan = real_plan
    assert PLAN_CACHE_EVENTS.value("miss") - m0 == 1
    assert PLAN_CACHE_EVENTS.value("hit") - h0 == 3
    assert fp.last_info.cache == "hit" and fp.last_info.bound == 1


def test_bindings_match_full_replan_oracle(engine):
    engine.execute(
        "PREPARE orc FROM select l_returnflag, count(*) c from lineitem "
        "where l_quantity < ? group by l_returnflag order by l_returnflag"
    )
    for v in (5.0, 24.0, 49.0):
        got = engine.execute(f"EXECUTE orc USING {v}")
        want = engine.query(
            "select l_returnflag, count(*) c from lineitem "
            f"where l_quantity < {v} group by l_returnflag order by l_returnflag"
        )
        assert got == want, (v, got, want)


def test_bigint_binding(engine):
    engine.execute("PREPARE bk FROM select n_name from nation where n_regionkey = ? order by n_name")
    for k in (0, 1, 2):
        got = engine.execute(f"EXECUTE bk USING {k}")
        want = engine.query(f"select n_name from nation where n_regionkey = {k} order by n_name")
        assert got == want


# ----------------------------------------------------------------- plan cache
def test_plan_cache_hit_events(engine):
    from trino_tpu_torch.runtime.fastpath import PLAN_CACHE_EVENTS

    engine.execute("PREPARE pc FROM select count(*) from orders where o_custkey = ?")
    h0, m0 = PLAN_CACHE_EVENTS.value("hit"), PLAN_CACHE_EVENTS.value("miss")
    engine.execute("EXECUTE pc USING 7")
    engine.execute("EXECUTE pc USING 13")
    engine.execute("EXECUTE pc USING 29")
    assert PLAN_CACHE_EVENTS.value("miss") - m0 == 1
    assert PLAN_CACHE_EVENTS.value("hit") - h0 == 2


def test_plan_cache_key_takes_the_sessions_kernel_policy():
    """The plan-cache key holds the kernel policy of the EXECUTing session,
    not the process-global one another engine's statement left: after a
    statement elsewhere ran with kernels off, the second EXECUTE still hits
    (it missed, and re-planned, before the fast path applied the session's
    policy ahead of its lookup)."""
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.ops import kernels
    from trino_tpu_torch.runtime.engine import Engine

    eng = Engine(default_catalog="mem", device="cpu")
    eng.register_catalog("mem", MemoryConnector())
    eng.execute("CREATE TABLE t (k bigint, v double)")
    eng.execute("INSERT INTO t VALUES (1, 1.0), (2, 2.0), (3, 3.0)")
    eng.execute("PREPARE p FROM select count(*), sum(v) from t where k >= ?")
    kernels.set_policy(kernels.KernelPolicy(enabled=False))  # another session's
    assert eng.execute("EXECUTE p USING 2") == [(2, 5.0)]
    assert eng.execute("EXECUTE p USING 1") == [(3, 6.0)]
    assert eng.fastpath().last_info.cache == "hit"
    assert eng.fastpath().plans_made == 1


def test_injection_quote_bearing_string_param(engine):
    """A quote-bearing varchar parameter stays DATA (a textual substitution
    would splice it into the predicate)."""
    engine.execute("PREPARE inj FROM select count(*) from nation where n_name = ?")
    assert engine.execute("EXECUTE inj USING 'x'' or ''1''=''1'") == [(0,)]
    assert engine.execute("EXECUTE inj USING 'FRANCE'") == [(1,)]
    assert engine.fastpath().last_info.baked == 1


def test_plan_cache_invalidation_on_dml():
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.runtime.engine import Engine
    from trino_tpu_torch.runtime.fastpath import PLAN_CACHE_EVENTS

    eng = Engine(default_catalog="mem", device="cpu")
    eng.register_catalog("mem", MemoryConnector())
    eng.execute("CREATE TABLE t (a bigint, b bigint)")
    eng.execute("INSERT INTO t VALUES (1, 10), (2, 20), (3, 30)")
    eng.execute("PREPARE p FROM select b from t where a = ?")
    assert eng.execute("EXECUTE p USING 2") == [(20,)]
    inv0 = PLAN_CACHE_EVENTS.value("invalidated")
    eng.execute("INSERT INTO t VALUES (4, 40)")
    # the stale plan (pinned to the pre-INSERT table version) must NOT serve
    assert eng.execute("EXECUTE p USING 4") == [(40,)]
    assert PLAN_CACHE_EVENTS.value("invalidated") > inv0


def test_kill_switch_falls_back_to_legacy(engine):
    from trino_tpu_torch.runtime.fastpath import PLAN_CACHE_EVENTS

    engine.execute("PREPARE ks FROM select count(*) from nation where n_regionkey = ?")
    engine.execute("SET SESSION prepared_fastpath_enabled = false")
    try:
        before = PLAN_CACHE_EVENTS.value("hit") + PLAN_CACHE_EVENTS.value("miss")
        assert engine.execute("EXECUTE ks USING 0") == [(5,)]
        after = PLAN_CACHE_EVENTS.value("hit") + PLAN_CACHE_EVENTS.value("miss")
        assert after == before, "kill switch did not bypass the plan cache"
    finally:
        engine.execute("SET SESSION prepared_fastpath_enabled = true")


def test_execute_arity_mismatch(engine):
    engine.execute("PREPARE ar FROM select count(*) from nation where n_regionkey = ?")
    with pytest.raises(Exception, match="parameter"):
        engine.execute("EXECUTE ar USING 1, 2")


# ------------------------------------------------------------------- batching
def _threads(engine, stmt, vals):
    results, errors = {}, []

    def run(v):
        try:
            results[v] = engine.execute(f"EXECUTE {stmt} USING {v}")
        except Exception as e:  # surfaced below; threads must not die silently
            errors.append(e)

    ts = [threading.Thread(target=run, args=(v,)) for v in vals]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not errors, errors
    return results


def test_batched_dispatch_matches_sequential_oracle(engine):
    from trino_tpu_torch.runtime.fastpath import EXECUTE_BATCH

    engine.execute(
        "PREPARE bat FROM select l_returnflag, count(*) c from lineitem "
        "where l_quantity < ? group by l_returnflag order by l_returnflag"
    )
    engine.execute("EXECUTE bat USING 24.0")  # warm: learn the capacities
    b0 = EXECUTE_BATCH.value("batched")
    engine.execute("SET SESSION execute_batch_window_ms = 25")
    try:
        vals = [5.0, 10.0, 15.0, 20.0, 25.0, 30.0]
        results = _threads(engine, "bat", vals)
    finally:
        engine.execute("SET SESSION execute_batch_window_ms = 0")
    for v in vals:
        want = engine.query(
            "select l_returnflag, count(*) c from lineitem "
            f"where l_quantity < {v} group by l_returnflag order by l_returnflag"
        )
        assert results[v] == want, (v, results[v], want)
    assert EXECUTE_BATCH.value("batched") > b0, "window never formed a batch"


def test_unbatchable_plan_falls_back_pipelined(engine):
    """A plan marked un-batchable still answers every query in the window
    (per-query dispatch), counted under outcome=fallback."""
    from trino_tpu_torch.runtime.fastpath import EXECUTE_BATCH

    engine.execute("PREPARE nb FROM select count(*) c from orders where o_custkey = ?")
    engine.execute("EXECUTE nb USING 7")  # warm + create the cache entry
    fp = engine.fastpath()
    with fp._lock:
        entries = [e for k, e in fp._cache.items()
                   if k[0].startswith("select count(*) c from orders")]
    assert entries, "prepared plan missing from the cache"
    for e in entries:
        e.batchable = False  # force the can't-batch path
    f0 = EXECUTE_BATCH.value("fallback")
    engine.execute("SET SESSION execute_batch_window_ms = 25")
    try:
        keys = [1, 2, 3, 4]
        results = _threads(engine, "nb", keys)
    finally:
        engine.execute("SET SESSION execute_batch_window_ms = 0")
    for k in keys:
        want = engine.query(f"select count(*) c from orders where o_custkey = {k}")
        assert results[k] == want, (k, results[k], want)
    assert EXECUTE_BATCH.value("fallback") > f0


# --------------------------------------------- against the reference engine
TEMPLATES = {
    "q6_shape": (
        "select sum(l_extendedprice * l_discount) as revenue from lineitem "
        "where l_shipdate >= ? and l_shipdate < ? and l_discount between ? and ? "
        "and l_quantity < ?",
        ["date '1994-01-01'", "date '1995-01-01'", "0.05", "0.07", "24"],
    ),
    "q1_shape": (
        "select l_returnflag, l_linestatus, sum(l_quantity), avg(l_extendedprice), count(*) "
        "from lineitem where l_shipdate <= ? group by l_returnflag, l_linestatus "
        "order by l_returnflag, l_linestatus",
        ["date '1998-09-02'"],
    ),
    "q3_shape": (
        "select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue, "
        "o_orderdate, o_shippriority from customer, orders, lineitem "
        "where c_mktsegment = ? and c_custkey = o_custkey and l_orderkey = o_orderkey "
        "and o_orderdate < ? and l_shipdate > ? "
        "group by l_orderkey, o_orderdate, o_shippriority "
        "order by revenue desc, o_orderdate, l_orderkey limit 10",
        ["'BUILDING'", "date '1995-03-15'", "date '1995-03-15'"],
    ),
    "boolean_and_bigint": (
        "select count(*) from orders where (o_totalprice > ?) = ? and o_custkey < ?",
        ["100000.0", "true", "500"],
    ),
}


@pytest.mark.parametrize("name", sorted(TEMPLATES))
def test_execute_equals_the_reference_engine(name, engine, ref_engine):
    sql, args = TEMPLATES[name]
    for eng in (engine, ref_engine):
        eng.execute(f"PREPARE {name} FROM {sql}")
    stmt = f"EXECUTE {name} USING {', '.join(args)}"
    got = engine.execute(stmt)
    assert_rows_equal(got, ref_engine.execute(stmt), ordered=True)
    literal = sql
    for a in args:
        literal = literal.replace("?", a, 1)
    assert_rows_equal(got, engine.query(literal), ordered=True)
    assert engine.fastpath().last_info.cache in ("miss", "hit")


def test_bindings_from_a_seed_equal_the_literal_query(engine, monkeypatch):
    """Twenty seeded bindings of the Q6 and Q3 shapes equal Engine.query
    with the literals.  The Q6 shape's one plan runs the fused pipeline,
    as the literal query does, with the run's values as the recipe's
    constants: every binding (two equal bounds among them) builds a recipe
    of one structure, so the card compiles one kernel for all of them."""
    from trino_tpu_torch.ops import kernels
    from trino_tpu_torch.ops.cuda import fused, fused_codegen

    structures = []
    real_run = fused.run

    def spy(recipe, *a, **kw):
        structures.append(fused_codegen.cache_key(recipe))
        return real_run(recipe, *a, **kw)

    rng = np.random.default_rng(17)
    sql6, _ = TEMPLATES["q6_shape"]
    engine.execute(f"PREPARE seeded6 FROM {sql6}")
    bindings = []
    for _ in range(20):
        y = int(rng.integers(1993, 1998))
        d = int(rng.integers(2, 9))
        bindings.append([f"date '{y}-01-01'", f"date '{y + 1}-01-01'",
                         f"{(d - 1) / 100:.2f}", f"{(d + 1) / 100:.2f}",
                         str(int(rng.integers(10, 50)))])
    bindings.append(["date '1994-01-01'", "date '1995-01-01'", "0.06", "0.06", "24"])
    for args in bindings:
        with monkeypatch.context() as m:
            m.setattr(fused, "run", spy)
            got = engine.execute(f"EXECUTE seeded6 USING {', '.join(args)}")
        literal = sql6
        for a in args:
            literal = literal.replace("?", a, 1)
        assert got == engine.query(literal), args
    assert len(structures) == len(bindings) and len(set(structures)) == 1
    fp = engine.fastpath()
    entry = next(e for k, e in fp._cache.items() if k[0] == sql6)
    assert "fused_pipeline" in {op for op, _impl, _d in kernels.events_for(entry.plan)}
    assert "fused_pipeline" in {op for op, _i, _d in kernels.events_for(engine.plan(literal))}
    sql3, _ = TEMPLATES["q3_shape"]
    engine.execute(f"PREPARE seeded3 FROM {sql3}")
    for _ in range(6):
        seg = ["'BUILDING'", "'MACHINERY'", "'AUTOMOBILE'"][int(rng.integers(0, 3))]
        day = f"date '1995-0{int(rng.integers(1, 7))}-15'"
        args = [seg, day, day]
        literal = sql3
        for a in args:
            literal = literal.replace("?", a, 1)
        assert engine.execute(f"EXECUTE seeded3 USING {', '.join(args)}") == engine.query(literal)
    assert fp.last_info.baked == 1 and fp.last_info.bound == 2


@pytest.mark.parametrize("name", ["q6_shape", "q3_shape"])
def test_execute_over_the_budget_runs_out_of_core(name, engine, ref_engine):
    """A prepared statement over the session's device-memory budget runs out
    of core, as the same SELECT through Engine.query does, with its bound
    values in every slice; so does its EXPLAIN ANALYZE EXECUTE.  The rows
    equal the reference engine's EXECUTE."""
    sql, args = TEMPLATES[name]
    for eng in (engine, ref_engine):
        eng.execute(f"PREPARE ooc_{name} FROM {sql}")
    stmt = f"EXECUTE ooc_{name} USING {', '.join(args)}"
    want = ref_engine.execute(stmt)
    engine.session.set("query_max_memory_bytes", "3000000")
    try:
        engine.last_spill = None
        got = engine.execute(stmt)
        spill = engine.last_spill
        assert engine.fastpath().last_info.bound > 0
        engine.last_spill = None
        engine.execute(f"EXPLAIN ANALYZE {stmt}")
        explained = engine.last_spill
    finally:
        engine.session.set("query_max_memory_bytes", "0")
    assert spill is not None and spill.parts >= 2 and spill.spill_files > 0
    assert explained is not None and explained.spill_files > 0
    assert_rows_equal(got, want, ordered=True)


def test_a_shared_plan_keeps_the_largest_compaction_tier():
    """One plan serves every binding, so a Compact point keeps the largest
    tier a binding needed: bindings that alternate between few and nearly
    all surviving rows re-run for capacity once, at the first binding that
    keeps more rows than any before it (lineitem at SF 0.02 is large
    enough for the optimizer's Compact)."""
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.plan.nodes import Compact, walk
    from trino_tpu_torch.runtime.engine import Engine

    eng = Engine(device="cpu")
    eng.register_catalog("tpch", TpchConnector(0.02))
    sql = ("select l_orderkey, l_linenumber, l_extendedprice from lineitem "
           "where l_shipdate > ? order by l_extendedprice desc, l_orderkey, l_linenumber "
           "limit 10")
    eng.execute(f"PREPARE tiers FROM {sql}")
    reruns = []
    for day in ["1998-11-01", "1992-02-01"] * 3:
        got = eng.execute(f"EXECUTE tiers USING date '{day}'")
        reruns.append(len(eng.executor.last_retries))
        assert got == eng.query(sql.replace("?", f"date '{day}'")), day
    entry = next(e for k, e in eng.fastpath()._cache.items() if k[0] == sql)
    assert any(isinstance(n, Compact) for n in walk(entry.plan))
    assert reruns == [0, 1, 0, 0, 0, 0], reruns


def _footer(rows):
    lines = [r[0] for r in rows]
    foot = [ln for ln in lines if ln.startswith("-- fastpath:")]
    out = [ln for ln in lines if ln.startswith("-- output rows:")]
    return foot, [re.sub(r"wall: [0-9.]+ ms", "wall: <t> ms", ln) for ln in out], \
        [ln for ln in lines if not ln.startswith("--")]


@pytest.mark.parametrize("analyze", [False, True], ids=["explain", "explain_analyze"])
def test_explain_execute_footer_equals_the_reference(analyze, engine, ref_engine):
    sql = "select count(*) from nation where n_regionkey = ?"
    word = "EXPLAIN ANALYZE" if analyze else "EXPLAIN"
    for eng in (engine, ref_engine):
        eng.execute(f"PREPARE ef{int(analyze)} FROM {sql}")
        eng.execute(f"EXECUTE ef{int(analyze)} USING 1")
    stmt = f"{word} EXECUTE ef{int(analyze)} USING 1"
    got, want = _footer(engine.execute(stmt)), _footer(ref_engine.execute(stmt))
    assert got[0] == want[0] and got[0], (got, want)
    assert "plan_cache=hit" in got[0][0]
    assert got[1] == want[1]
    assert got[2] == want[2]  # the plan text


def test_a_lambda_body_refuses_a_parameter(engine):
    """Lambda closures are compiled once per plan; one holding a bound value
    would answer the next binding with it, so a Param there is refused and
    EXECUTE substitutes and re-plans instead."""
    sql = ("select count(*) from nation "
           "where any_match(split(n_comment, ' '), w -> length(w) > ?)")
    engine.execute(f"PREPARE lam FROM {sql}")
    fp = engine.fastpath()
    for k in (3, 9, 12, 40):
        got = engine.execute(f"EXECUTE lam USING {k}")
        assert got == engine.query(sql.replace("?", str(k)))
        assert fp.last_info.baked == 1 and fp.last_info.bound == 0


# ------------------------------------------------------------------- protocol
@pytest.fixture(scope="module")
def cluster():
    """A port cluster of two CPU workers over TPC-H SF 0.01."""
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.testing import DistributedQueryRunner

    runner = DistributedQueryRunner(num_workers=2, default_catalog="tpch", device="cpu")
    runner.register_catalog("tpch", TpchConnector(0.01))
    runner.start()
    yield runner
    runner.stop()


def test_protocol_prepare_execute_deallocate(cluster, engine):
    from trino_tpu_torch.client import StatementClient

    c = StatementClient(cluster.coordinator.url)
    sql = (
        "select l_returnflag, count(*) c from lineitem where l_quantity < ? "
        "group by l_returnflag order by l_returnflag"
    )
    c.execute(f"PREPARE proto FROM {sql}")
    # server-side PREPARE echoes into the client registry (addedPrepare)
    assert c.prepared.get("proto") == sql

    cols, rows = c.execute("EXECUTE proto USING 24.0")
    assert cols == ["l_returnflag", "c"], cols
    want = engine.query(sql.replace("?", "24.0"))
    assert [tuple(r) for r in rows] == want

    # a FRESH client holding only the header registry (no server session):
    # the X-Trino-Prepared-Statement header alone must resolve the EXECUTE
    c2 = StatementClient(cluster.coordinator.url)
    c2.prepared["proto"] = sql
    cols2, rows2 = c2.execute("EXECUTE proto USING 24.0")
    assert (cols2, rows2) == (cols, rows)

    c.execute("DEALLOCATE PREPARE proto")
    assert "proto" not in c.prepared  # deallocatedPrepare delta applied


def test_protocol_explain_analyze_footer(cluster):
    from trino_tpu_torch.client import StatementClient

    c = StatementClient(cluster.coordinator.url)
    c.prepared["ef"] = "select count(*) from nation where n_regionkey = ?"
    _, rows = c.execute("EXECUTE ef USING 1")
    assert [tuple(r) for r in rows] == [(5,)]
    _, rows = c.execute("EXPLAIN ANALYZE EXECUTE ef USING 1")
    text = "\n".join(r[0] for r in rows)
    assert "-- fastpath:" in text, text
    assert "plan_cache=hit" in text, text


def test_dbapi_binds_instead_of_splicing(cluster):
    from trino_tpu_torch.client.dbapi import connect

    conn = connect(cluster.coordinator.url)
    cur = conn.cursor()
    # a quote-bearing parameter must not terminate the predicate
    cur.execute("select count(*) from nation where n_name = ?", ("x' or '1'='1",))
    assert cur.fetchone() == (0,)
    cur.execute("select count(*) from nation where n_name = ?", ("FRANCE",))
    assert cur.fetchone() == (1,)
    # the statement went through the prepared registry, not text splicing
    assert any(k.startswith("dbapi_") for k in conn._client.prepared)
    # repeats reuse the registry slot (one server plan-cache entry)
    n = len(conn._client.prepared)
    cur.execute("select count(*) from nation where n_name = ?", ("KENYA",))
    assert cur.fetchone() == (1,)
    assert len(conn._client.prepared) == n
