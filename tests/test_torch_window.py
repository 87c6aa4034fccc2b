"""Window functions of the port (trino_tpu_torch/ops/window.py and the Window
handler of exec/compiler.py).

- The 16 statements of tests/test_window.py's WINDOW_QUERIES through the
  port's `Engine(device="cpu")` at SF 0.01, with the data-plane kernels'
  plain versions on and off, against the sqlite oracle; `window_over_agg`
  refuses its decimal128 sum as the reference does.
- `window_eval` of the port against the reference's on the same seeded numpy
  columns (NULL keys and values, ties, one-row partitions, dead rows), one
  case per function family and frame kind: integers and ranks exact,
  doubles within rel 1e-12.
- Dead rows form partitions of their own in the port, so a live partition's
  size and last row never reach one; the reference lets them join the last
  live partition (ROADMAP §C) — held against the oracle here.
"""

import numpy as np
import pytest
try:  # arrow before torch: loaded after it, arrow's parquet writer crashes the process
    import pyarrow  # noqa: F401
except ImportError:
    pass
import torch

from tests.oracle import assert_rows_equal
from tests.test_torch_tpch import port, run_with_kernels  # noqa: F401 (fixture)
from tests.test_window import WINDOW_QUERIES

torch.set_num_threads(1)

_RUNNABLE = sorted(n for n in WINDOW_QUERIES if n != "window_over_agg")


@pytest.mark.parametrize("kernels_on", [True, False], ids=["kernels_on", "kernels_off"])
@pytest.mark.parametrize("name", _RUNNABLE)
def test_window_query_equals_oracle(name, kernels_on, port, oracle):  # noqa: F811
    sql = WINDOW_QUERIES[name]
    assert_rows_equal(run_with_kernels(port, sql, kernels_on), oracle.query(sql), ordered=False)


@pytest.mark.parametrize("kernels_on", [True, False], ids=["kernels_on", "kernels_off"])
def test_window_over_decimal128_refuses_as_the_reference_does(kernels_on, port):  # noqa: F811
    with pytest.raises(NotImplementedError, match="decimal128 columns through window"):
        run_with_kernels(port, WINDOW_QUERIES["window_over_agg"], kernels_on)


# Dead rows next to a live partition with the same keys: the global window
# over a filtered scan, and a window over a GROUP BY's output (whose frame
# holds dead group slots past the live groups)
DEAD_ROW_STATEMENTS = {
    "cume_dist_global": "select o_orderkey, cume_dist() over (order by o_orderkey) "
                        "from orders where o_orderkey < 200",
    "over_group_by": "select o_custkey, count(*), ntile(2) over (order by o_custkey), "
                     "last_value(o_custkey) over (order by o_custkey rows between "
                     "unbounded preceding and unbounded following) "
                     "from orders where o_custkey < 30 group by o_custkey",
    "percent_rank_global": "select o_orderkey, percent_rank() over (order by o_orderdate) "
                           "from orders where o_orderkey < 100",
}


@pytest.mark.parametrize("name", sorted(DEAD_ROW_STATEMENTS))
def test_dead_rows_stay_out_of_live_partitions(name, port, oracle):  # noqa: F811
    sql = DEAD_ROW_STATEMENTS[name]
    for kernels_on in (True, False):
        assert_rows_equal(run_with_kernels(port, sql, kernels_on), oracle.query(sql),
                          ordered=False)


# ----------------------------------------------- window_eval, module level


def _columns(n=233, seed=5):
    """[p partition key int null, q second key int, o order key int null
    (ties), x double null, v bigint null, s varchar null], plus the live
    mask.  Keys 0..19 with partition 19 holding one row."""
    rng = np.random.default_rng(seed)
    m = lambda p: rng.random(n) < p
    p = rng.integers(0, 19, n)
    p[7] = 19  # a one-row partition
    o = rng.integers(0, 12, n)  # ties within every partition
    words = np.asarray(["ant", "bee", "cat", "dog", "eel"], dtype=object)
    cols = [
        np.ma.MaskedArray(p, mask=m(0.05) & (np.arange(n) != 7)),
        rng.integers(0, 2, n),
        np.ma.MaskedArray(o, mask=m(0.1)),
        np.ma.MaskedArray(rng.normal(scale=1e3, size=n), mask=m(0.15)),
        np.ma.MaskedArray(rng.integers(-10**6, 10**6, n), mask=m(0.15)),
        np.ma.MaskedArray(words[rng.integers(0, len(words), n)], mask=m(0.1)),
    ]
    # dead rows carry keys no live row has, so both packages put them in
    # partitions of their own (where the reference joins them to a live
    # partition it is wrong: see test_dead_rows_stay_out_of_live_partitions)
    live = ~m(0.1)
    live[7] = True
    cols[0] = np.ma.MaskedArray(np.where(live, cols[0].data, 1000 + np.arange(n)),
                                mask=np.ma.getmaskarray(cols[0]) & live)
    return cols, live


def _types(T):
    return [T.BIGINT, T.INTEGER, T.BIGINT, T.DOUBLE, T.BIGINT, T.VARCHAR]


# (label, function, argument columns / literals, result type name, frame,
#  partition keys, order keys as (column, ascending, nulls_first))
_P, _PQ = (0,), (0, 1)
_O = ((2, True, False),)
_OD = ((2, False, True), (4, True, False))
_CASES = [
    ("row_number", "row_number", (), "BIGINT", "rows", _P, _OD),
    ("rank", "rank", (), "BIGINT", "range", _P, _O),
    ("dense_rank", "dense_rank", (), "BIGINT", "range", _PQ, _OD),
    ("rank_global", "rank", (), "BIGINT", "range", (), _O),
    ("lag", "lag", (4,), "BIGINT", "range", _P, _OD),
    ("lead_2", "lead", (4, ("BIGINT", 2)), "BIGINT", "range", _P, _OD),
    ("lag_default", "lag", (4, ("BIGINT", 1), ("BIGINT", -7)), "BIGINT", "range", _P, _OD),
    ("lag_varchar_default", "lag", (5, ("BIGINT", 1), ("VARCHAR", "zzz")), "VARCHAR",
     "range", _P, _OD),
    ("first_value", "first_value", (3,), "DOUBLE", "range", _P, _OD),
    ("nth_value_whole", "nth_value", (4, ("BIGINT", 2)), "BIGINT", "whole", _P, _OD),
    ("nth_value_rows", "nth_value", (4, ("BIGINT", 3)), "BIGINT", "rows", _P, _OD),
    ("nth_value_range", "nth_value", (4, ("BIGINT", 2)), "BIGINT", "range", _P, _O),
    ("ntile", "ntile", (("BIGINT", 3),), "BIGINT", "range", _P, _OD),
    ("percent_rank", "percent_rank", (), "DOUBLE", "range", _P, _O),
    ("cume_dist", "cume_dist", (), "DOUBLE", "range", _PQ, _O),
    ("last_value_range", "last_value", (3,), "DOUBLE", "range", _P, _O),
    ("last_value_whole", "last_value", (5,), "VARCHAR", "whole", _P, _OD),
    ("count_star_range", "count_star", (), "BIGINT", "range", _P, _O),
    ("count_rows", "count", (3,), "BIGINT", "rows", _P, _OD),
    ("sum_f_rows", "sum", (3,), "DOUBLE", "rows", _P, _OD),
    ("sum_i_range", "sum", (4,), "BIGINT", "range", _P, _O),
    ("sum_f_whole", "sum", (3,), "DOUBLE", "whole", _P, ()),
    ("avg_range", "avg", (4,), "DOUBLE", "range", _PQ, _O),
    ("min_rows", "min", (3,), "DOUBLE", "rows", _P, _OD),
    ("max_whole", "max", (4,), "BIGINT", "whole", _P, _O),
    ("max_range", "max", (3,), "DOUBLE", "range", _P, _O),
    ("sum_rows_offset", "sum", (3,), "DOUBLE", "rows:-2:1", _P, _OD),
    ("count_rows_offset", "count_star", (), "BIGINT", "rows:-1:1", _P, _OD),
    ("avg_rows_following", "avg", (4,), "DOUBLE", "rows:1:u", _P, _OD),
    ("min_rows_offset", "min", (3,), "DOUBLE", "rows:-2:0", _P, _OD),
    ("max_rows_unbounded_lo", "max", (4,), "BIGINT", "rows:u:1", _P, _OD),
    ("min_rows_unbounded_hi", "min", (3,), "DOUBLE", "rows:0:u", _P, _OD),
    ("sum_range_offset", "sum", (4,), "BIGINT", "range:-3:2", _P, _O),
    ("count_range_desc", "count", (3,), "BIGINT", "range:-2:2", _P, ((2, False, True),)),
    ("max_range_following", "max", (3,), "DOUBLE", "range:u:2", _P, _O),
]


def _calls(nodes, ir, T, case):
    label, fn, args, tname, frame, _, _ = case
    types = _types(T)
    irs = []
    for a in args:
        if isinstance(a, int):
            irs.append(ir.FieldRef(a, types[a]))
        else:
            irs.append(ir.Const(a[1], getattr(T, a[0])))
    return nodes.WindowCall(fn, tuple(irs), getattr(T, tname), frame)


def _run(case, pkg):
    """One case through `pkg`'s window_eval: (sorted live mask, result)."""
    if pkg == "port":
        from trino_tpu_torch.data import types as T
        from trino_tpu_torch.data.page import Page
        from trino_tpu_torch.ops import expr, relops, window
        from trino_tpu_torch.plan import ir, nodes

        page_of = lambda ts, cs: Page.from_numpy(ts, cs, device="cpu")
        live_of = lambda lv: torch.from_numpy(lv)
    else:
        import jax.numpy as jnp
        from trino_tpu.data import types as T
        from trino_tpu.data.page import Page
        from trino_tpu.ops import expr, relops, window
        from trino_tpu.plan import ir, nodes

        page_of = Page.from_numpy
        live_of = jnp.asarray
    cols, live = _columns()
    page = page_of(_types(T), cols)
    vals = [expr.column_val(c) for c in page.columns]
    n = page.capacity
    live_full = np.zeros(n, dtype=bool)
    live_full[: len(live)] = live
    call = _calls(nodes, ir, T, case)
    argv = tuple(expr.eval_expr(a, vals, n) for a in call.args)
    _, _, _, _, _, parts, orders = case
    out, live_s = window.window_eval(
        vals, live_of(live_full), [vals[i] for i in parts], [vals[i] for i, _, _ in orders],
        [relops.SortSpec(asc, nf) for _, asc, nf in orders], [call], [argv],
    )
    return np.asarray(live_s), out[-1], out[:len(cols)]


@pytest.mark.parametrize("case", _CASES, ids=[c[0] for c in _CASES])
def test_window_eval_matches_reference(case):
    p_live, got, p_cols = _run(case, "port")
    r_live, want, r_cols = _run(case, "reference")
    assert np.array_equal(p_live, r_live), "live rows sort differently"
    lv = p_live
    # the same rows in the same sorted order
    for pc, rc in zip(p_cols, r_cols):
        assert np.array_equal(pc.data.numpy()[lv], np.asarray(rc.data)[lv])
    n = len(lv)
    gv = np.ones(n, bool) if got.valid is None else got.valid.numpy()
    wv = np.ones(n, bool) if want.valid is None else np.asarray(want.valid)
    assert np.array_equal(gv[lv], wv[lv]), "validity differs"
    ok = lv & gv
    gd, wd = got.data.numpy(), np.asarray(want.data)
    if got.dict is not None:
        assert list(got.dict.values[gd[ok]]) == list(want.dict.values[wd[ok]])
    elif np.issubdtype(gd.dtype, np.floating):
        a, b = gd[ok], wd[ok].astype(np.float64)
        assert np.all(np.abs(a - b) <= 1e-12 * np.maximum(np.abs(b), 1e-300)), (a, b)
    else:
        assert np.array_equal(gd[ok].astype(np.int64), wd[ok].astype(np.int64))


def test_window_eval_refusals_match_the_reference():
    """The reference's refusals, with its messages."""
    cases = [
        ("min varchar", "min", (5,), "VARCHAR", "range", _P, _O, "window min/max over varchar"),
        ("wide rows", "max", (3,), "DOUBLE", "rows:-200:0", _P, _O,
         "ROWS frame wider than 128 for min/max"),
        ("range lo", "min", (3,), "DOUBLE", "range:-2:0", _P, _O,
         "min/max over a RANGE frame with a bounded PRECEDING edge"),
    ]
    for *case, message in cases:
        for pkg in ("port", "reference"):
            with pytest.raises(NotImplementedError, match=message):
                _run(tuple(case), pkg)


def test_segmented_scan_restarts_at_every_boundary():
    """The log-step scan against a python loop: add over doubles and ints,
    max and min, with a boundary at row 0, isolated one-row segments and a
    long run."""
    from trino_tpu_torch.ops.window import _seg_scan

    rng = np.random.default_rng(11)
    n = 1000
    boundary = rng.random(n) < 0.05
    boundary[0] = True
    boundary[500:503] = True
    for x in (rng.normal(size=n), rng.integers(-1000, 1000, n)):
        for op, fn in (("add", lambda a, b: a + b), ("max", max), ("min", min)):
            want = []
            for i in range(n):
                want.append(x[i] if boundary[i] else fn(want[-1], x[i]))
            got = _seg_scan(op, torch.from_numpy(x), torch.from_numpy(boundary)).numpy()
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-12, atol=1e-9)


def test_chip_smoke_window_checksums_equal_the_oracle(port, oracle, tpch_tiny):  # noqa: F811
    """chip_smoke.py holds W1 and W2 at SF 1 against numpy references: here
    those references are held against the oracle (the SQL statements) and
    against the port in both kernel settings at SF 0.01."""
    import chip_smoke as cs
    from trino_tpu_torch.connectors.tpch import tpch_data

    want = {"w1": cs.w1_reference(tpch_data("orders", 0.01)),
            "w2": cs.w2_reference(tpch_data("lineitem", 0.01))}
    for name, sql in (("w1", cs.W1), ("w2", cs.W2)):
        assert_rows_equal(want[name], oracle.query(sql), ordered=True)
        for kernels_on in (True, False):
            cs.rows_match(run_with_kernels(port, sql, kernels_on), want[name], name)
