"""All 22 TPC-H queries through the port's `Engine.query` (device="cpu")
against the sqlite oracle at SF 0.01, with the data-plane kernels' plain
versions on (hash joins and GROUP BYs, the fused pipeline) and off (the sort
and operator-at-a-time paths).  Q18 returns no rows at SF 0.01, so a twin
with a threshold of 250 (65 rows) stands beside it.  q08, q12, q14, q16 and
q22 — between them CASE, IN, LIKE, substring and count(DISTINCT) — are
also held against the reference engine.  Doubles within rel 1e-9
(`assert_rows_equal`: the engines add in different orders)."""

import pytest
try:  # arrow before torch: loaded after it, arrow's parquet writer crashes the process
    import pyarrow  # noqa: F401
except ImportError:
    pass
import torch

from tests.oracle import assert_rows_equal
from tests.tpch_queries import ORDERED, QUERIES

torch.set_num_threads(1)

STATEMENTS = dict(QUERIES)
STATEMENTS["q18_250"] = QUERIES["q18"].replace("> 300", "> 250")
ORDER = dict(ORDERED, q18_250=ORDERED["q18"])
REFERENCE_HELD = ["q08", "q12", "q14", "q16", "q22"]


@pytest.fixture(scope="module")
def port():
    """The port's engine on the CPU at SF 0.01; tests/test_torch_aggregates.py
    imports it too."""
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.runtime.engine import Engine

    eng = Engine(device="cpu")
    eng.register_catalog("tpch", TpchConnector(0.01))
    return eng


@pytest.fixture(scope="module")
def reference(tpch_tiny):
    from trino_tpu.connectors.tpch import TpchConnector
    from trino_tpu.runtime.engine import Engine

    eng = Engine()
    eng.register_catalog("tpch", TpchConnector(0.01))
    return eng


def run_with_kernels(port, sql, kernels_on: bool):
    """`port.query(sql)` with `data_plane_kernels` set for this one statement."""
    port.execute(f"set session data_plane_kernels = {'true' if kernels_on else 'false'}")
    try:
        return port.query(sql)
    finally:
        port.execute("set session data_plane_kernels = true")


@pytest.mark.parametrize("kernels_on", [True, False], ids=["kernels_on", "kernels_off"])
@pytest.mark.parametrize("name", sorted(STATEMENTS))
def test_tpch_query_equals_oracle(name, kernels_on, port, oracle):
    sql = STATEMENTS[name]
    rows = run_with_kernels(port, sql, kernels_on)
    assert_rows_equal(rows, oracle.query(sql), ordered=ORDER[name])
    if name == "q18_250":
        assert len(rows) == 65


@pytest.mark.parametrize("name", REFERENCE_HELD)
def test_tpch_query_equals_reference(name, port, reference):
    sql = QUERIES[name]
    assert_rows_equal(run_with_kernels(port, sql, True), reference.query(sql),
                      ordered=ORDERED[name])


def test_count_distinct_takes_the_sort_path_through_kernel_one(port):
    """q16's count(DISTINCT ps_suppkey) declines the hash GROUP BY and rides
    the segmented reduction of the sorted grouping."""
    from trino_tpu_torch.ops import kernels

    run_with_kernels(port, QUERIES["q16"], True)
    events = [(op, impl) for op, impl, _ in kernels.events_for(port.plan(QUERIES["q16"]))]
    assert events[-2:] == [("group_by", "sort"), ("segment_reduce", "torch")]


def test_chip_smoke_numpy_references_equal_the_port(port, oracle):
    """chip_smoke.py holds Q18, q12, q14, q16, q22 and its aggregate
    statement at SF 1 against numpy references: here they are held against
    the oracle (the SQL queries) and the CPU engine at SF 0.01."""
    import chip_smoke as cs
    from trino_tpu_torch.connectors.tpch import tpch_data

    t = {n: tpch_data(n, 0.01) for n in
         ("lineitem", "orders", "customer", "part", "partsupp", "supplier")}
    want = cs.tpch_reference_rows(t)
    want["q18_250"] = cs.q18_reference(t["lineitem"], t["orders"], t["customer"], 250)
    for name, rows in want.items():
        assert_rows_equal(rows, oracle.query(STATEMENTS[name]), ordered=ORDER[name])
        got = port.query(STATEMENTS[name])
        if not ORDER[name]:
            got, rows = sorted(got, key=repr), sorted(rows, key=repr)
        cs.rows_match(got, rows, name)
    rows, tols = cs.agg_reference(t["lineitem"])
    cs.agg_rows_match(port.query(cs.AGG), rows, tols, "agg")


# coalesce over varchar branches with different dictionaries: each lane must
# name its own branch's string (the reference gets this wrong, ROADMAP §C)
COALESCE_STATEMENTS = {
    "const": "select n_nationkey, coalesce(case when n_nationkey % 3 = 0 then n_name end, "
             "'none') from nation order by 1",
    "columns": "select n_nationkey, coalesce(case when n_nationkey < 10 then n_name end, "
               "r_name) from nation join region on n_regionkey = r_regionkey order by 1",
}


@pytest.mark.parametrize("kernels_on", [True, False], ids=["kernels_on", "kernels_off"])
@pytest.mark.parametrize("name", sorted(COALESCE_STATEMENTS))
def test_coalesce_over_varchar_equals_oracle(name, kernels_on, port, oracle):
    sql = COALESCE_STATEMENTS[name]
    assert_rows_equal(run_with_kernels(port, sql, kernels_on), oracle.query(sql), ordered=True)
