"""Lambdas, higher-order functions and the aggregates of tests/test_lambdas.py
in the port: each statement on `Engine(device="cpu")` and on the
reference's engine over the same memory table, the rows equal (doubles to
a relative 1e-9), and the reference test's expected values checked.  A
lambda body is interpreted on the host once per distinct array or map
(ops/expr.py `_py_compile`)."""

import math

import numpy as np
import pytest
try:  # arrow before torch: loaded after it, arrow's parquet writer crashes the process
    import pyarrow  # noqa: F401
except ImportError:
    pass
import torch

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _restore_kernel_policy():
    from trino_tpu_torch.ops import kernels

    saved = kernels.get_policy()
    yield
    kernels.set_policy(saved)


def _table():
    rng = np.random.default_rng(5)
    n = 300
    x = rng.normal(size=n)
    return {
        "k": np.arange(n, dtype=np.int64),
        "g": np.asarray([f"g{i % 3}" for i in range(n)], dtype=object),
        "x": x,
        "y": 3.0 * x + rng.normal(size=n) * 0.01,
        "s": np.asarray([f"s{i % 4}" for i in range(n)], dtype=object),
    }


def load_tables(eng, conn, schema, T) -> None:
    """Tables `t` (the reference test's) and `d` (its distributed test's
    rows) written into `conn`, registered on `eng` as `mem` (either
    package, with its ColumnSchema and types module)."""
    conn.create_table("t", [schema("k", T.BIGINT), schema("g", T.VARCHAR),
                            schema("x", T.DOUBLE), schema("y", T.DOUBLE),
                            schema("s", T.VARCHAR)])
    conn.insert("t", _table())
    conn.create_table("d", [schema("k", T.BIGINT), schema("v", T.BIGINT)])
    conn.insert("d", {"k": np.arange(16, dtype=np.int64) % 4,
                      "v": np.arange(16, dtype=np.int64)})
    eng.register_catalog("mem", conn)


def port_engine(device):
    """The port's engine on `device` with catalog `mem`."""
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.connectors.spi import ColumnSchema
    from trino_tpu_torch.data import types as PT
    from trino_tpu_torch.runtime.engine import Engine

    eng = Engine(default_catalog="mem", device=device)
    load_tables(eng, MemoryConnector(), ColumnSchema, PT)
    return eng


@pytest.fixture(scope="module")
def engines():
    """(port, reference) engines over the same tables."""
    from trino_tpu.connectors.memory import MemoryConnector as RefMemory
    from trino_tpu.connectors.spi import ColumnSchema as RefSchema
    from trino_tpu.data import types as RT
    from trino_tpu.runtime.engine import Engine as RefEngine
    from trino_tpu_torch.ops import kernels

    saved = kernels.get_policy()
    port = port_engine("cpu")
    ref = RefEngine(default_catalog="mem")
    load_tables(ref, RefMemory(), RefSchema, RT)
    kernels.set_policy(saved)
    return port, ref


def _same(got, want):
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert len(g) == len(w), (g, w)
        for a, b in zip(g, w):
            if isinstance(a, float) and isinstance(b, float):
                assert a == pytest.approx(b, rel=1e-9, abs=1e-12), (g, w)
            else:
                assert a == b, (g, w)


# (sql, the reference test's expected rows or None)
CASES = {
    "transform": ("select transform(array[1,2,3], x -> x * 2)", [([2, 4, 6],)]),
    "filter": ("select filter(array[1,2,3,4], x -> x > 2)", [([3, 4],)]),
    "transform_strings": ("select transform(array['a','bb'], x -> length(x))", [([1, 2],)]),
    "reduce_sum": ("select reduce(array[1,2,3,4], 0, (s, x) -> s + x, s -> s)", [(10,)]),
    "reduce_output_function": (
        "select reduce(array[2,3], 1, (s, x) -> s * x, s -> s * 10)", [(60,)]),
    "matches": (
        "select any_match(array[1,2], x -> x > 1), all_match(array[1,2], x -> x > 1),"
        " none_match(array[1,2], x -> x > 5)", [(True, False, True)]),
    "zip_with": (
        "select zip_with(array[1,2,3], array[10,20,30], (x, y) -> x + y)",
        [([11, 22, 33],)]),
    "nested_hof": (
        "select transform(filter(array[1,2,3,4], x -> x % 2 = 0), x -> x + 1)", [([3, 5],)]),
    "hof_over_column_arrays": (
        "select g, cardinality(filter(split(s, 's'), x -> length(x) > 0)) as c"
        " from t where k < 4 order by k", None),
    "transform_values": (
        "select transform_values(map(array['a','b'], array[1,2]), (k, v) -> v * 10)",
        [({"a": 10, "b": 20},)]),
    "map_filter": (
        "select map_filter(map(array['a','b'], array[1,2]), (k, v) -> v > 1)",
        [({"b": 2},)]),
    "corr_grouped": ("select g, corr(y, x) as c from t group by g order by g", None),
    "array_agg": (
        "select g, array_agg(k) as a from t where k < 6 group by g order by g",
        [("g0", [0, 3]), ("g1", [1, 4]), ("g2", [2, 5])]),
    "map_agg": ("select g, map_agg(s, k) as m from t where k < 6 group by g order by g", None),
    "listagg": (
        "select g, listagg(s, '|') as l from t where k < 6 group by g order by g",
        [("g0", "s0|s3"), ("g1", "s1|s0"), ("g2", "s2|s1")]),
    # tests/test_lambdas.py gathers this one distributed (ported in
    # tests/test_torch_distributed.py)
    "array_agg_over_four_keys": (
        "select k, array_sort(array_agg(v)) as a from d group by k order by k",
        [(0, [0, 4, 8, 12]), (1, [1, 5, 9, 13]), (2, [2, 6, 10, 14]), (3, [3, 7, 11, 15])]),
    "bigint_division_exact": (
        "select transform(array[9007199254740993], v -> v / 1)", [([9007199254740993],)]),
    "modulus_sign_of_dividend": ("select transform(array[-7, 7], v -> v % 3)", [([-1, 1],)]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_lambda_statement_equals_reference(name, engines):
    port, ref = engines
    sql, want = CASES[name]
    got = port.execute(sql)
    if want is not None:
        assert got == want, f"{name}: port {got}"
    _same(got, ref.execute(sql))
    if name == "hof_over_column_arrays":
        assert [r[1] for r in got] == [1, 1, 1, 1]
    if name == "corr_grouped":
        assert len(got) == 3 and all(c > 0.99 for _, c in got)
    if name == "map_agg":
        assert got[0][1] == {"s0": 0, "s3": 3}


def test_corr_covar_regr(engines):
    port, ref = engines
    sql = ("select corr(y, x) as c, covar_pop(y, x) as cp, covar_samp(y, x) as cs,"
           " regr_slope(y, x) as sl, regr_intercept(y, x) as ic from t")
    got = port.execute(sql)
    _same(got, ref.execute(sql))
    data = _table()
    x, y = data["x"], data["y"]
    c, cp, cs, sl, ic = got[0]
    slope, intercept = np.polyfit(x, y, 1)
    for v, w in ((c, np.corrcoef(y, x)[0, 1]), (cp, np.cov(y, x, bias=True)[0, 1]),
                 (cs, np.cov(y, x)[0, 1]), (sl, slope), (ic, intercept)):
        assert math.isclose(v, float(w), rel_tol=0, abs_tol=1e-6)


def test_lambda_capture_and_arity_are_rejected(engines):
    port, ref = engines
    for eng in (port, ref):
        with pytest.raises(Exception, match="capture"):
            eng.execute("select transform(array[1,2], x -> x + k) from t")
        with pytest.raises(Exception, match="argument"):
            eng.execute("select reduce(array[1,2], 0)")


def test_distinct_host_aggregates_and_views(engines):
    port, ref = engines
    sql = ("select array_agg(distinct g) as a, listagg(distinct g, ',') as l"
           " from t where k < 9")
    got = port.execute(sql)
    assert sorted(got[0][0]) == ["g0", "g1", "g2"] and got[0][1].count("g0") == 1
    want = ref.execute(sql)
    assert sorted(got[0][0]) == sorted(want[0][0])
    assert sorted(got[0][1].split(",")) == sorted(want[0][1].split(","))
    for eng in (port, ref):
        eng.execute("create view sch.lv as select k from t where k < 2")
        assert eng.execute("describe sch.lv") == [("k", "bigint")]
        eng.execute("drop view sch.lv")
