"""The port as a whole: `Engine.query` of the port (device="cpu") against
the reference engine and the sqlite oracle, through the kernels' plain
versions (data_plane_kernels on: fused pipeline, hash joins and group-bys)
and through the operator-at-a-time and sort paths (off)."""

import pytest
try:  # arrow before torch: loaded after it, arrow's parquet writer crashes the process
    import pyarrow  # noqa: F401
except ImportError:
    pass
import torch

from tests.oracle import assert_rows_equal
from tests.tpch_queries import ORDERED, QUERIES

torch.set_num_threads(1)

STATEMENTS = {
    "q01": (QUERIES["q01"], ORDERED["q01"]),
    "q06": (QUERIES["q06"], ORDERED["q06"]),
    "minmax": (
        "select l_returnflag, min(l_shipdate), max(l_extendedprice), count(*) "
        "from lineitem group by l_returnflag order by 1",
        True,
    ),
    "global": (
        "select count(*), sum(l_extendedprice), avg(l_discount), min(l_quantity), "
        "count(l_tax) from lineitem",
        True,
    ),
    "all_filtered_grouped": (
        "select l_returnflag, sum(l_quantity), count(*) from lineitem "
        "where l_shipdate < date '1970-01-01' group by l_returnflag",
        False,
    ),
    "all_filtered_global": (
        "select sum(l_quantity), count(*), avg(l_extendedprice) from lineitem "
        "where l_shipdate < date '1970-01-01'",
        True,
    ),
    "limit": (
        "select l_linestatus, count(*) as c from lineitem group by l_linestatus limit 5",
        False,
    ),
}
# which kernel serves the aggregate with data_plane_kernels = true
FUSED = {"q01", "q06", "all_filtered_grouped", "all_filtered_global", "limit"}


@pytest.fixture(scope="module")
def engines(tpch_tiny):
    from trino_tpu.connectors.tpch import TpchConnector as RefConn
    from trino_tpu.runtime.engine import Engine as RefEngine
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.runtime.engine import Engine

    ref = RefEngine()  # a private engine: its session re-applies its own policy
    ref.register_catalog("tpch", RefConn(0.01))
    port = Engine(device="cpu")
    port.register_catalog("tpch", TpchConnector(0.01))
    return ref, port


@pytest.fixture(scope="module")
def reference_rows(engines):
    ref, _ = engines
    return {name: ref.query(sql) for name, (sql, _) in STATEMENTS.items()}


def _dispatch(op, impl):
    from trino_tpu_torch.ops import kernels

    return kernels._DISPATCH.value(op, impl)


@pytest.mark.parametrize("kernels_on", [True, False], ids=["kernels_on", "kernels_off"])
@pytest.mark.parametrize("name", sorted(STATEMENTS))
def test_rows_equal_reference_and_oracle(name, kernels_on, engines, reference_rows, oracle):
    from trino_tpu_torch.ops import kernels

    _, port = engines
    sql, ordered = STATEMENTS[name]
    port.execute(f"set session data_plane_kernels = {'true' if kernels_on else 'false'}")
    want_op = "fused_pipeline" if (kernels_on and name in FUSED) else "segment_reduce"
    other_op = "segment_reduce" if want_op == "fused_pipeline" else "fused_pipeline"
    before = (_dispatch(want_op, "torch"), _dispatch(other_op, "torch"),
              _dispatch(want_op, "cuda"))
    try:
        rows = port.query(sql)
    finally:
        port.execute("set session data_plane_kernels = true")
    assert_rows_equal(rows, reference_rows[name], ordered=ordered)
    assert_rows_equal(rows, oracle.query(sql), ordered=ordered)
    # the CPU engine ran the kernel's plain version, labelled `torch`
    assert _dispatch(want_op, "torch") == before[0] + 1
    assert _dispatch(other_op, "torch") == before[1]
    assert _dispatch(want_op, "cuda") == before[2]
    events = kernels.events_for(port.plan(sql))
    assert [(op, impl) for op, impl, _ in events] == [(want_op, "torch")]


@pytest.mark.parametrize("name", ["q01", "q06"])
def test_result_pages_match_reference_column_by_column(name, engines):
    """Same capacities, live masks, lanes and limbs as the reference's page."""
    import numpy as np

    ref, port = engines
    sql = STATEMENTS[name][0]
    port.execute("set session data_plane_kernels = false")
    try:
        got = port.execute_page(sql)
    finally:
        port.execute("set session data_plane_kernels = true")
    want = ref.execute_page(sql)
    assert got.capacity == want.capacity
    live = np.asarray(want.live_mask())
    assert np.array_equal(got.live_mask().numpy(), live)
    for g, w in zip(got.columns, want.columns):
        assert g.type.name == w.type.name
        assert (g.data2 is None) == (w.data2 is None)
        gv = np.ones_like(live) if g.valid is None else g.valid.numpy()
        wv = np.ones_like(live) if w.valid is None else np.asarray(w.valid)
        assert np.array_equal(gv[live], wv[live])
        ok = live & gv
        if g.type.is_floating:
            assert np.allclose(g.data.numpy()[ok], np.asarray(w.data)[ok], rtol=1e-12, atol=0)
        else:
            assert np.array_equal(g.data.numpy()[ok], np.asarray(w.data)[ok].astype(np.int64))
        if g.data2 is not None:
            assert np.array_equal(g.data2.numpy()[ok], np.asarray(w.data2)[ok])


def test_set_session_and_unported_plan_nodes(engines):
    _, port = engines
    assert port.execute("set session data_plane_kernels = false") == [(1,)]
    assert port.session.get("data_plane_kernels") is False
    port.execute("set session data_plane_kernels = true")
    # Unnest and JSON raised naming ROADMAP A.8b until the nested-value
    # family was ported; they now run and equal the reference
    ref, _ = engines
    for sql in ("select n_name, x from nation cross join unnest(array[1, 2]) as t(x)",
                "select n_name, json_extract_scalar(n_comment, '$.a') from nation"):
        assert sorted(port.query(sql), key=repr) == sorted(ref.query(sql), key=repr)
    assert len(port.query("select n_name, x from nation cross join unnest(array[1, 2]) as t(x)")) == 50


# The second slice: joins of every shape the planner emits for TPC-H, the
# hash GROUP BY, DISTINCT, TopN by radix select, scalar subqueries.  Each
# name maps to (sql, ordered, {data_plane_kernels: expected (op, impl)
# dispatch events in plan order}).
_Q = "select l_orderkey, l_linenumber, l_extendedprice from lineitem"
JOIN_STATEMENTS = {
    "q03": (QUERIES["q03"], ORDERED["q03"], {
        True: [("join", "torch"), ("join", "torch"), ("group_by", "torch"),
               ("segment_reduce", "torch"), ("topn", "sort")],
        False: [("join", "sort"), ("join", "sort"), ("group_by", "sort"),
                ("segment_reduce", "torch"), ("topn", "sort")],
    }),
    # the ten most expensive line items: radix select (forced at SF 0.01)
    "topn": (_Q + " order by l_extendedprice desc, l_orderkey, l_linenumber limit 10", True, {
        flag: [("topn", "torch"), ("segment_reduce", "torch")] for flag in (True, False)
    }),
    "semi": ("select count(*) from orders where o_orderkey in "
             "(select l_orderkey from lineitem where l_quantity > 49)", True, None),
    "anti": ("select count(*) from customer where not exists "
             "(select * from orders where o_custkey = c_custkey)", True, None),
    "left": ("select c_custkey, count(o_orderkey) from customer left join orders "
             "on c_custkey = o_custkey and o_orderstatus = 'F' "
             "group by c_custkey order by 2 desc, 1 limit 10", True, None),
    "distinct": ("select count(*), min(l_partkey), max(l_suppkey) from "
                 "(select distinct l_partkey, l_suppkey from lineitem)", True, {
                     True: [("group_by", "torch"), ("segment_reduce", "torch")],
                     False: [("group_by", "sort"), ("segment_reduce", "torch")],
                 }),
    "scalar": ("select count(*) from lineitem where l_extendedprice > "
               "(select avg(l_extendedprice) from lineitem)", True, None),
}
_JOIN_REF_ROWS: dict = {}


@pytest.mark.parametrize("kernels_on", [True, False], ids=["kernels_on", "kernels_off"])
@pytest.mark.parametrize("name", sorted(JOIN_STATEMENTS))
def test_join_topn_statements_equal_reference_and_oracle(
    name, kernels_on, engines, oracle, monkeypatch
):
    from trino_tpu_torch.ops import kernels
    from trino_tpu_torch.ops.cuda import topk

    ref, port = engines
    sql, ordered, dispatch = JOIN_STATEMENTS[name]
    if name not in _JOIN_REF_ROWS:
        _JOIN_REF_ROWS[name] = ref.query(sql)
    monkeypatch.setattr(topk, "FORCE", True)  # 60k rows: under the radix size
    port.execute(f"set session data_plane_kernels = {'true' if kernels_on else 'false'}")
    try:
        rows = port.query(sql)
    finally:
        port.execute("set session data_plane_kernels = true")
    assert_rows_equal(rows, _JOIN_REF_ROWS[name], ordered=ordered)
    assert_rows_equal(rows, oracle.query(sql), ordered=ordered)
    events = [(op, impl) for op, impl, _ in kernels.events_for(port.plan(sql))]
    if dispatch is not None:
        assert events == dispatch[kernels_on]
    if name in ("semi", "anti", "left"):
        assert ("join", "torch" if kernels_on else "sort") in events


def test_scalar_subquery_of_many_rows_raises(engines):
    _, port = engines
    with pytest.raises(RuntimeError, match="multiple rows"):
        port.query("select count(*) from orders where o_totalprice = "
                   "(select o_totalprice from orders)")


def test_failed_hash_join_reruns_on_the_sort_path(engines, monkeypatch):
    """A probe walk past its budget sets the join's guard; the executor
    re-runs the plan with that join sorted and the rows stay right."""
    from trino_tpu_torch.ops import kernels
    from trino_tpu_torch.ops.cuda import hashjoin

    _, port = engines
    sql = JOIN_STATEMENTS["semi"][0]
    want = port.query(sql)
    monkeypatch.setattr(hashjoin, "PROBE_LIMIT", 0)
    port.executor._learned_caps.clear()
    assert port.query(sql) == want
    events = [(op, impl) for op, impl, _ in kernels.events_for(port.plan(sql))]
    assert ("join", "sort") in events and ("join", "torch") not in events
    port.executor._learned_caps.clear()


# DATE min/max over no rows: the empty group's sentinel sits in a NULL lane,
# and the result surface must not decode it.  (The reference raises
# OverflowError on these; the sqlite oracle decides.)
NULL_DATE_STATEMENTS = {
    "min_no_rows": "select min(l_shipdate) from lineitem where l_quantity < 0",
    "max_no_rows": "select max(o_orderdate) from orders where o_orderkey < 0",
    "left_join_min": "select c_custkey, min(o_orderdate) from customer left join orders "
                     "on c_custkey = o_custkey group by c_custkey",
}


@pytest.mark.parametrize("kernels_on", [True, False], ids=["kernels_on", "kernels_off"])
@pytest.mark.parametrize("name", sorted(NULL_DATE_STATEMENTS))
def test_null_dates_equal_oracle(name, kernels_on, engines, oracle):
    _, port = engines
    sql = NULL_DATE_STATEMENTS[name]
    port.execute(f"set session data_plane_kernels = {'true' if kernels_on else 'false'}")
    try:
        rows = port.query(sql)
    finally:
        port.execute("set session data_plane_kernels = true")
    assert_rows_equal(rows, oracle.query(sql), ordered=False)
    assert any(None in r for r in rows)
