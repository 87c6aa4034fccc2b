"""The rest of the aggregation path and the set operations, port against
reference: `group_aggregate` of both packages over the same seeded numpy
columns, grouped (by a nullable integer key — the port's hash path or its
sort exit — and by a dictionary key, its direct-code path) and global, for
every aggregate beyond sum/count/avg/min/max; then UNION ALL / INTERSECT /
EXCEPT / VALUES statements over the TPC-H tables against the sqlite oracle.
(chip_smoke.py's aggregate statement over `lineitem` is held against its
numpy reference in tests/test_torch_tpch.py.)

Tolerances: integers, booleans, counts, count(DISTINCT), approx_percentile,
approx_distinct and the host-collected values exact; doubles of the
variance and moment family within rel 1e-9 (both sides add the same terms
in different orders)."""

import math

import numpy as np
import pytest
try:  # arrow before torch: loaded after it, arrow's parquet writer crashes the process
    import pyarrow  # noqa: F401
except ImportError:
    pass
import torch

from tests.oracle import assert_rows_equal
from tests.test_setops import SETOP_QUERIES
from tests.test_torch_tpch import port, run_with_kernels  # noqa: F401 (a fixture)

torch.set_num_threads(1)

_WORDS = np.asarray(["", "ab", "cd", "ef", "gh", "ij", "kl", "mn"], dtype=object)
_COLS = ["g", "k", "x", "y", "i", "s", "b"]

# name -> [(fn, arg, arg2, distinct, param, sep, order=(arg, ascending))]
CASES = {
    "bool_and": [("bool_and", "b", None, False, None, None, None)],
    "bool_or": [("bool_or", "b", None, False, None, None, None)],
    "stddev_samp": [("stddev_samp", "x", None, False, None, None, None)],
    "stddev_pop": [("stddev_pop", "x", None, False, None, None, None)],
    "var_samp": [("var_samp", "i", None, False, None, None, None)],
    "var_pop": [("var_pop", "x", None, False, None, None, None)],
    "corr": [("corr", "y", "x", False, None, None, None)],
    "covar_samp": [("covar_samp", "y", "x", False, None, None, None)],
    "covar_pop": [("covar_pop", "x", "i", False, None, None, None)],
    "regr_slope": [("regr_slope", "y", "x", False, None, None, None)],
    "regr_intercept": [("regr_intercept", "y", "i", False, None, None, None)],
    "count_distinct_int": [("count", "i", None, True, None, None, None)],
    "count_distinct_str": [("count", "s", None, True, None, None, None)],
    "count_distinct_double": [("count", "x", None, True, None, None, None)],
    "percentile_double": [("percentile", "x", None, False, 0.5, None, None)],
    "percentile_int": [("percentile", "i", None, False, 0.9, None, None)],
    "approx_distinct_int": [("approx_distinct", "i", None, False, None, None, None)],
    "approx_distinct_double": [("approx_distinct", "x", None, False, None, None, None)],
    "approx_distinct_str": [("approx_distinct", "s", None, False, None, None, None)],
    "array_agg": [("array_agg", "i", None, False, None, None, None)],
    "array_agg_ordered": [("array_agg", "i", None, False, None, None, ("x", False))],
    "listagg_ordered": [("listagg", "s", None, False, None, "|", ("i", True))],
    "map_agg": [("map_agg", "s", "i", False, None, None, None)],
    # two DISTINCT arguments (two sorts), a percentile and plain sums in one node
    "mixed": [
        ("count", "i", None, True, None, None, None),
        ("count", "s", None, True, None, None, None),
        ("percentile", "y", None, False, 0.25, None, None),
        ("sum", "x", None, False, None, None, None),
        ("stddev_samp", "y", None, False, None, None, None),
        ("corr", "x", "y", False, None, None, None),
        ("approx_distinct", "x", None, False, None, None, None),
        ("count_star", None, None, False, None, None, None),
    ],
}
_FLOAT_FNS = {"stddev_samp", "stddev_pop", "var_samp", "var_pop", "corr", "covar_samp",
              "covar_pop", "regr_slope", "regr_intercept", "sum"}


def _columns():
    """400 rows: g nullable integer key (one group of a single row: 99), k
    varchar key, x double null, y double, i bigint null, s varchar null, b
    bool null.  NULL lanes of i and s carry the payload of a live value (0,
    ''), the case where count(DISTINCT) must not count the NULL lane."""
    rng = np.random.default_rng(31)
    n = 400
    m = lambda p: rng.random(n) < p
    g = rng.integers(0, 12, n).astype(np.int32)
    g[7] = 99
    gmask = m(0.08)
    gmask[7] = False
    i = rng.integers(0, 30, n)
    i[:40] = 0
    return n, [
        np.ma.MaskedArray(g, mask=gmask), _WORDS[1 + rng.integers(0, 3, n)],
        np.ma.MaskedArray(np.round(rng.normal(50.0, 20.0, n), 2), mask=m(0.15)),
        rng.normal(size=n),
        np.ma.MaskedArray(i, mask=m(0.15)),
        np.ma.MaskedArray(_WORDS[rng.integers(0, len(_WORDS), n)], mask=m(0.15)),
        np.ma.MaskedArray(m(0.7), mask=m(0.1)),
    ], rng.random(n) > 0.1


def _types(T):
    return [T.INTEGER, T.VARCHAR, T.DOUBLE, T.DOUBLE, T.BIGINT, T.VARCHAR, T.BOOLEAN]


@pytest.fixture(scope="module")
def sides():
    import jax.numpy as jnp

    from trino_tpu.data import types as RT
    from trino_tpu.data.page import Page as RefPage
    from trino_tpu.ops import expr as ref_expr
    from trino_tpu.ops import relops as ref_relops
    from trino_tpu_torch.data import types as PT
    from trino_tpu_torch.data.page import Page
    from trino_tpu_torch.ops import expr as port_expr
    from trino_tpu_torch.ops import relops as port_relops

    n, cols, live = _columns()
    rpage = RefPage.from_numpy(_types(RT), cols)
    ppage = Page.from_numpy(_types(PT), cols, device="cpu")
    ref = (ref_relops, dict(zip(_COLS, [ref_expr.column_val(c) for c in rpage.columns])),
           jnp.asarray(live))
    port = (port_relops, dict(zip(_COLS, [port_expr.column_val(c) for c in ppage.columns])),
            torch.from_numpy(live))
    return ref, port


def _value(data, valid, d, i):
    if valid is not None and not bool(np.asarray(valid)[i]):
        return None
    v = np.asarray(data)[i]
    return d.values[int(v)] if d is not None else v.item()


def _grouped(side, case, keys):
    relops, cols, live = side
    specs = [relops.AggSpec(fn, distinct, param, sep) for fn, _, _, distinct, param, sep, _ in case]
    args = [None if a is None else cols[a] for _, a, _, _, _, _, _ in case]
    args2 = [None if a is None else cols[a] for _, _, a, _, _, _, _ in case]
    order = [() if o is None else ((cols[o[0]], o[1], False),) for *_, o in case]
    kvs = [cols[k] for k in keys]
    out_keys, out_aggs, out_live, n_groups = relops.group_aggregate(
        kvs, args, specs, live, 32, agg_args2=args2, agg_order=order
    )
    assert int(np.asarray(n_groups)) <= 32
    rows = {}
    for gi in np.flatnonzero(np.asarray(out_live)):
        key = tuple(_value(d, v, kv.dict, gi) for (d, v, _), kv in zip(out_keys, kvs))
        vals = []
        for out, arg in zip(out_aggs, args):
            d = out[2] if len(out) == 3 else None
            vals.append(_value(out[0], out[1], d, gi))
        rows[key] = vals
    return rows


@pytest.mark.parametrize("keys", [("g",), ("k",), ()], ids=["int_key", "dict_key", "global"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_aggregate_matches_reference(name, keys, sides):
    ref, port = sides
    case = CASES[name]
    want = _grouped(ref, case, keys)
    got = _grouped(port, case, keys)
    assert sorted(got, key=repr) == sorted(want, key=repr)
    for key, wvals in want.items():
        for (fn, *_), g, w in zip(case, got[key], wvals):
            if fn in _FLOAT_FNS and g is not None and w is not None:
                assert math.isclose(g, w, rel_tol=1e-9, abs_tol=1e-12), (name, key, g, w)
            else:
                assert g == w, (name, key, fn, g, w)
    if keys == ("g",) and name in ("stddev_samp", "var_samp", "covar_samp"):
        assert got[(99,)] == [None]  # a group of one row: the sample forms are NULL


@pytest.mark.parametrize("grouped", [False, True], ids=["global", "grouped"])
def test_approx_distinct_equals_reference_at_scale(grouped):
    """Past the small-range correction (> 2.5·4096 distinct): the same
    registers give the same estimate, within 4 standard errors of exact."""
    import jax.numpy as jnp

    from trino_tpu.data import types as RT
    from trino_tpu.data.page import Column as RefColumn
    from trino_tpu.ops import expr as ref_expr
    from trino_tpu.ops import relops as ref_relops
    from trino_tpu_torch.data import types as PT
    from trino_tpu_torch.data.page import Column
    from trino_tpu_torch.ops import expr as port_expr
    from trino_tpu_torch.ops import relops as port_relops

    rng = np.random.default_rng(41)
    n = 60_000
    x = rng.integers(0, 40_000, n).astype(np.int64)
    g = rng.integers(0, 2, n).astype(np.int64) if grouped else None
    out = []
    for relops, expr, col, T, asarr in (
        (ref_relops, ref_expr, RefColumn, RT, jnp.asarray),
        (port_relops, port_expr, Column, PT, torch.from_numpy),
    ):
        kw = {} if col is RefColumn else {"device": "cpu"}
        xv = expr.column_val(col.from_numpy(T.BIGINT, x, **kw))
        keys = [] if g is None else [expr.column_val(col.from_numpy(T.BIGINT, g, **kw))]
        live = asarr(np.ones(n, bool))
        _, aggs, _, _ = relops.group_aggregate(
            keys, [xv], [relops.AggSpec("approx_distinct")], live, 2
        )
        out.append(np.asarray(aggs[0][0]).tolist())
    assert out[0] == out[1]
    groups = [x] if g is None else [x[g == 0], x[g == 1]]
    for est, vals in zip(out[1], groups):
        exact = len(np.unique(vals))
        assert exact > 2.5 * 4096
        assert abs(est - exact) <= 4 * 1.04 / math.sqrt(4096) * exact


@pytest.mark.parametrize("kind", ["int64", "float64"])
def test_hll_hash_and_bit_length_equal_reference(kind):
    """approx_distinct's register inputs bit for bit: splitmix64 of the value
    bits masked to 63 bits, and the six-step bit length of its low bits."""
    import jax.numpy as jnp

    from trino_tpu.ops import relops as ref_relops
    from trino_tpu_torch.ops import relops as port_relops

    rng = np.random.default_rng(43)
    if kind == "int64":
        x = rng.integers(-(2**63), 2**63 - 1, 4096, dtype=np.int64)
        x[:6] = [0, -1, 1, 2**62, -(2**63), 2**63 - 1]
    else:
        x = rng.normal(scale=1e6, size=4096)
        x[:5] = [0.0, -0.0, 1.0, np.inf, -np.inf]
    want_h = np.asarray(ref_relops._hash64(jnp.asarray(x)))
    got_h = port_relops._hash64(torch.from_numpy(x)).numpy()
    assert np.array_equal(got_h, want_h)
    low = want_h & ((1 << 51) - 1)
    low[:4] = [0, 1, (1 << 51) - 1, 1 << 50]
    assert np.array_equal(
        port_relops._bitlen64(torch.from_numpy(low)).numpy(),
        np.asarray(ref_relops._bitlen64(jnp.asarray(low))),
    )


# ---------------------------------------------------------- statements


SET_STATEMENTS = dict(SETOP_QUERIES)
SET_STATEMENTS["values"] = "select 1 as a, 'x' as b, 2.5 as c"
SET_STATEMENTS["union_values"] = (
    "select n_name, n_nationkey from nation where n_nationkey < 3 "
    "union all select 'ATLANTIS', 99"
)


@pytest.mark.parametrize("kernels_on", [True, False], ids=["kernels_on", "kernels_off"])
@pytest.mark.parametrize("name", sorted(SET_STATEMENTS))
def test_set_operation_statements_equal_oracle(name, kernels_on, port, oracle):
    sql = SET_STATEMENTS[name]
    assert_rows_equal(run_with_kernels(port, sql, kernels_on), oracle.query(sql),
                      ordered="order by" in sql)
