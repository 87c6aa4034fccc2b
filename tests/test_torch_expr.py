"""Expression evaluator of the port vs the reference, expression by
expression: every filter / projection / aggregate argument TPC-H Q1 and Q6
reach, plus the operators of the ported subset over NULL-bearing columns.
Integers (and decimal128 limbs) exact, doubles within 1 ulp."""

from types import SimpleNamespace

import numpy as np
import pytest
try:  # arrow before torch: loaded after it, arrow's parquet writer crashes the process
    import pyarrow  # noqa: F401
except ImportError:
    pass
import torch

from tests.tpch_queries import QUERIES

torch.set_num_threads(1)


def _np(x):
    return None if x is None else np.asarray(x)


def _assert_same(port_val, ref_val, what):
    pd, rd = port_val.data.numpy(), _np(ref_val.data)
    pv = np.ones(len(pd), bool) if port_val.valid is None else port_val.valid.numpy()
    rv = np.ones(len(rd), bool) if ref_val.valid is None else _np(ref_val.valid)
    assert np.array_equal(pv, rv), f"{what}: validity differs"
    assert (port_val.data2 is None) == (ref_val.data2 is None), f"{what}: limbs differ"
    if np.issubdtype(pd.dtype, np.floating):
        a, b = pd[pv], rd[rv].astype(np.float64)
        assert np.all(np.abs(a - b) <= np.spacing(np.abs(b))), f"{what}: > 1 ulp"
    else:
        assert np.array_equal(pd[pv].astype(np.int64), rd[rv].astype(np.int64)), what
    if port_val.data2 is not None:
        assert np.array_equal(port_val.data2.numpy()[pv], _np(ref_val.data2)[rv]), what


# ------------------------------------------------- Q1 / Q6 plan expressions


def _plan_exprs(plan, nodes_mod):
    """[(label, expr, input scan node)] for every Filter predicate, Project
    expression and aggregate argument sitting directly over the scan chain."""
    out = []
    for node in nodes_mod.walk(plan):
        if isinstance(node, nodes_mod.Filter):
            out.append(("filter", node.predicate, node.child))
        elif isinstance(node, nodes_mod.Aggregate):
            for i, a in enumerate(node.aggs):
                if a.arg is not None:
                    out.append((f"agg{i}", a.arg, node.child))
    return out


def _scan_of(node, nodes_mod):
    while not isinstance(node, nodes_mod.TableScan):
        assert isinstance(node, (nodes_mod.Filter, nodes_mod.Compact)), type(node)
        node = node.child
    return node


@pytest.fixture(scope="module")
def engines(tpch_tiny):
    from trino_tpu.connectors.tpch import TpchConnector as RefConn
    from trino_tpu.runtime.engine import Engine as RefEngine
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.runtime.engine import Engine

    ref = RefEngine()
    ref.register_catalog("tpch", RefConn(0.01))
    port = Engine(device="cpu")
    port.register_catalog("tpch", TpchConnector(0.01))
    return ref, port


@pytest.mark.parametrize("name", ["q01", "q06"])
def test_query_expressions_match_reference(name, engines):
    from trino_tpu.ops import expr as ref_expr
    from trino_tpu.plan import nodes as ref_nodes
    from trino_tpu_torch.exec.compiler import scan_column_vals
    from trino_tpu_torch.ops import expr as port_expr
    from trino_tpu_torch.plan import nodes as port_nodes

    ref, port = engines
    ref_list = _plan_exprs(ref.plan(QUERIES[name]), ref_nodes)
    port_list = _plan_exprs(port.plan(QUERIES[name]), port_nodes)
    assert len(ref_list) == len(port_list) >= 6
    for (label, re_, rchild), (_, pe, pchild) in zip(ref_list, port_list):
        rscan = _scan_of(rchild, ref_nodes)
        pscan = _scan_of(pchild, port_nodes)
        rpage = ref.executor.table_page(
            rscan.catalog, rscan.table, rscan.column_names, rscan.output_types
        )
        ppage = port.executor.table_page(
            pscan.catalog, pscan.table, pscan.column_names, pscan.output_types
        )
        rcols = [ref_expr.column_val(c) for c in rpage.columns]
        for cv, t in zip(rcols, rscan.output_types):
            cv.type = t
        pcols = scan_column_vals(ppage, pscan)
        n = ppage.capacity
        assert n == rpage.capacity
        _assert_same(
            port_expr.eval_expr(pe, pcols, n), ref_expr.eval_expr(re_, rcols, n),
            f"{name} {label} {pe}",
        )
        if label == "filter":
            assert np.array_equal(
                port_expr.eval_predicate(pe, pcols, n).numpy(),
                np.asarray(ref_expr.eval_predicate(re_, rcols, n)),
            )


# ---------------------------------------------- the ported operator subset


def _build_cases(ir, T):
    """(label, expr) over columns [a dec(12,2) null, b dec(12,2), d date null,
    x double null, y double, f bool null, g bool null, w dec(38,2) limbed,
    i integer]."""
    d12, d13, d25, d38_2, d38_4 = (
        T.DecimalType(12, 2), T.DecimalType(13, 2), T.DecimalType(25, 4),
        T.DecimalType(38, 2), T.DecimalType(38, 4),
    )
    A, B = ir.FieldRef(0, d12), ir.FieldRef(1, d12)
    D, X, Y = ir.FieldRef(2, T.DATE), ir.FieldRef(3, T.DOUBLE), ir.FieldRef(4, T.DOUBLE)
    F, G = ir.FieldRef(5, T.BOOLEAN), ir.FieldRef(6, T.BOOLEAN)
    W, I = ir.FieldRef(7, d38_2), ir.FieldRef(8, T.INTEGER)
    C = lambda op, ty, *args: ir.Call(op, tuple(args), ty)
    cmpd = lambda op: C(op, T.BOOLEAN, A, B)
    cases = [
        ("const_dec", ir.Const(100, d13)), ("const_null", ir.Const(None, T.DOUBLE)),
        ("const_wide", ir.Const((1 << 70) + 3, d38_2)), ("const_date", ir.Const(10471, T.DATE)),
        ("add", C("add", d13, A, B)), ("sub", C("sub", d13, A, B)),
        ("mul_limbed", C("mul", d25, A, B)),
        ("mul_chain", C("mul", d38_4, W, C("sub", d13, ir.Const(100, d13), C("cast", d13, B)))),
        ("neg", C("neg", d12, A)), ("neg_wide", C("neg", d38_2, W)),
        ("abs", C("abs", d12, A)), ("abs_wide", C("abs", d38_2, W)),
        ("add_wide", C("add", d38_2, W, C("cast", d38_2, A))),
        ("sub_wide", C("sub", d38_2, W, W)),
        ("div_int", C("div", d12, A, B)), ("mod_int", C("mod", d12, A, B)),
        ("add_f", C("add", T.DOUBLE, X, Y)), ("mul_f", C("mul", T.DOUBLE, X, Y)),
        ("div_f", C("div", T.DOUBLE, X, Y)), ("mod_f", C("mod", T.DOUBLE, X, Y)),
        ("cast_dec_double", C("cast", T.DOUBLE, A)), ("cast_wide_double", C("cast", T.DOUBLE, W)),
        ("cast_up", C("cast", T.DecimalType(18, 4), A)),
        ("cast_down", C("cast", T.DecimalType(12, 1), A)),
        ("cast_dec_int", C("cast", T.BIGINT, A)), ("cast_double_dec", C("cast", d12, X)),
        ("cast_int_double", C("cast", T.DOUBLE, I)), ("cast_int_dec", C("cast", d12, I)),
        ("cast_widen_limbed", C("cast", T.DecimalType(38, 2), W)),
        ("add_days", C("add_days", T.DATE, D, I)),
        ("year", C("extract_year", T.BIGINT, D)), ("month", C("extract_month", T.BIGINT, D)),
        ("day", C("extract_day", T.BIGINT, D)),
        ("and", C("and", T.BOOLEAN, F, G)), ("or", C("or", T.BOOLEAN, F, G)),
        ("not", C("not", T.BOOLEAN, F)), ("is_null", C("is_null", T.BOOLEAN, A)),
        ("and_mixed", C("and", T.BOOLEAN, F, C("le", T.BOOLEAN, D, ir.Const(9500, T.DATE)))),
        ("or_nonnull", C("or", T.BOOLEAN, C("lt", T.BOOLEAN, B, ir.Const(0, d12)),
                         C("gt", T.BOOLEAN, Y, ir.Const(0.5, T.DOUBLE)))),
        ("cmp_int_date", C("ge", T.BOOLEAN, D, ir.Const(9000, T.DATE))),
    ]
    for op in ("eq", "ne", "lt", "le", "gt", "ge"):
        cases.append((f"{op}_dec", cmpd(op)))
        cases.append((f"{op}_wide", C(op, T.BOOLEAN, W, C("cast", d38_2, A))))
        cases.append((f"{op}_f", C(op, T.BOOLEAN, X, Y)))
    return cases


def _columns():
    rng = np.random.default_rng(17)
    n = 257
    m = lambda p: rng.random(n) < p
    wide = np.empty(n, dtype=object)
    wide[:] = [int(v) * (1 << 30) for v in rng.integers(-(2**62), 2**62, n)]
    wide[:5] = [(1 << 90) + 1, -(1 << 90), 0, -1, 5]
    b = rng.integers(-10**9, 10**9, n)
    b[:3] = 0  # zero divisors
    y = rng.normal(size=n)
    y[3:6] = 0.0
    a = rng.integers(-10**10, 10**10, n)
    a[:8] = b[:8]  # equal pairs for the comparisons
    return [
        np.ma.MaskedArray(a, mask=m(0.2)), b,
        np.ma.MaskedArray(rng.integers(-20000, 30000, n).astype(np.int32), mask=m(0.1)),
        np.ma.MaskedArray(rng.normal(scale=1e3, size=n), mask=m(0.2)), y,
        np.ma.MaskedArray(m(0.5), mask=m(0.3)), np.ma.MaskedArray(m(0.5), mask=m(0.3)),
        wide, rng.integers(-400, 400, n).astype(np.int32),
    ]


def _types(T):
    return [T.DecimalType(12, 2), T.DecimalType(12, 2), T.DATE, T.DOUBLE, T.DOUBLE,
            T.BOOLEAN, T.BOOLEAN, T.DecimalType(38, 2), T.INTEGER]


_LABELS = [label for label, _ in _build_cases(
    __import__("trino_tpu_torch.plan.ir", fromlist=["x"]),
    __import__("trino_tpu_torch.data.types", fromlist=["x"]),
)]


@pytest.fixture(scope="module")
def both_sides():
    from trino_tpu.data import types as RT
    from trino_tpu.data.page import Page as RefPage
    from trino_tpu.ops import expr as ref_expr
    from trino_tpu.plan import ir as ref_ir
    from trino_tpu_torch.data import types as PT
    from trino_tpu_torch.data.page import Page
    from trino_tpu_torch.ops import expr as port_expr
    from trino_tpu_torch.plan import ir as port_ir

    cols = _columns()
    rpage = RefPage.from_numpy(_types(RT), cols)
    ppage = Page.from_numpy(_types(PT), cols, device="cpu")
    rcols = [ref_expr.column_val(c) for c in rpage.columns]
    pcols = [port_expr.column_val(c) for c in ppage.columns]
    return (
        dict(_build_cases(ref_ir, RT)), rcols, ref_expr,
        dict(_build_cases(port_ir, PT)), pcols, port_expr, ppage.capacity,
    )


@pytest.mark.parametrize("label", _LABELS)
def test_operator_matches_reference(label, both_sides):
    rcases, rcols, ref_expr, pcases, pcols, port_expr, n = both_sides
    _assert_same(
        port_expr.eval_expr(pcases[label], pcols, n),
        ref_expr.eval_expr(rcases[label], rcols, n),
        label,
    )


def test_civil_date_helpers_round_trip():
    from trino_tpu_torch.ops.expr import _civil_from_days, _days_from_civil
    import datetime

    days = torch.arange(-800000, 800000, 997, dtype=torch.int64)
    y, m, d = _civil_from_days(days)
    assert torch.equal(_days_from_civil(y, m, d), days)
    epoch = datetime.date(1970, 1, 1)
    for z, yy, mm, dd in zip(days[::97].tolist(), y[::97].tolist(), m[::97].tolist(), d[::97].tolist()):
        if -700000 < z < 700000:
            want = epoch + datetime.timedelta(days=z)
            assert (yy, mm, dd) == (want.year, want.month, want.day)


def test_unported_operators_name_their_roadmap_item(both_sides):
    # JSON ran behind an A.8b refusal until the nested-value family was
    # ported: it now equals the reference; the prepared-statement fast path's
    # parameter ran behind an A.9b refusal until that path was ported: bound
    # in a context it equals the reference's, outside one it still raises
    from trino_tpu.data import types as RT
    from trino_tpu.plan import ir as ref_ir
    from trino_tpu_torch.data import types as PT
    from trino_tpu_torch.plan import ir as port_ir

    _, rcols, ref_expr, _, pcols, port_expr, n = both_sides
    doc = '{"a": [1, 2, 3], "b": {"c": 4}}'
    got = port_expr.eval_expr(
        port_ir.Call("json_size", (port_ir.Const(doc, PT.VARCHAR),), PT.BIGINT), pcols, n)
    want = ref_expr.eval_expr(
        ref_ir.Call("json_size", (ref_ir.Const(doc, RT.VARCHAR),), RT.BIGINT), rcols, n)
    _assert_same(got, want, "json_size")
    assert int(got.data[0]) == 2
    with pytest.raises(NotImplementedError, match="outside a binding context"):
        port_expr.eval_expr(port_ir.Param(0, PT.BIGINT), pcols, n)
    def pred(ir, T):  # column 0 (decimal(12,2)) < $1, the bound unscaled lane
        d = T.DecimalType(12, 2)
        return ir.Call("lt", (ir.FieldRef(0, d), ir.Param(1, d)), T.BOOLEAN)

    values = (np.int64(0), np.int64(int(np.median(np.asarray(pcols[0].data)))))
    with port_expr.param_context(values):
        got = port_expr.eval_expr(pred(port_ir, PT), pcols, n)
        assert port_expr.eval_expr(port_ir.Param(1, PT.BIGINT), pcols, n).data.shape == (n,)
    with ref_expr.param_context(values):
        want = ref_expr.eval_expr(pred(ref_ir, RT), rcols, n)
    _assert_same(got, want, "param")
    assert 0 < int(got.data.sum()) < n


# ------------------------------- IN, LIKE, substring, CASE and coalesce


_WORDS = np.asarray(
    ["", "abc", "a%b", "x_y", "PROMO BRUSHED TIN", "special packages requests",
     "Brand#12", "13-555", "31-907", "SM CASE", "MED BOX", "zz"], dtype=object,
)


def _string_cases(ir, T):
    """(label, expr) over columns [s varchar null, k integer null,
    a dec(12,2), w dec(38,2) limbed, x double null, y double, f bool]."""
    d12, d38 = T.DecimalType(12, 2), T.DecimalType(38, 2)
    S, K = ir.FieldRef(0, T.VARCHAR), ir.FieldRef(1, T.INTEGER)
    A, W = ir.FieldRef(2, d12), ir.FieldRef(3, d38)
    X, Y, F = ir.FieldRef(4, T.DOUBLE), ir.FieldRef(5, T.DOUBLE), ir.FieldRef(6, T.BOOLEAN)
    C = lambda op, ty, *args: ir.Call(op, tuple(args), ty)
    K3 = C("gt", T.BOOLEAN, K, ir.Const(3, T.INTEGER))
    cases = [
        ("in_str", ir.InListIr(S, ("abc", "zz", "", "absent"), False)),
        ("not_in_str", ir.InListIr(S, ("SM CASE", "MED BOX"), True)),
        ("in_int", ir.InListIr(K, (1, 5, 7), False)),
        ("not_in_int", ir.InListIr(K, (0, 2), True)),
        ("substr_len", C("substring", T.VARCHAR, S, ir.Const(1, T.BIGINT), ir.Const(2, T.BIGINT))),
        ("substr_tail", C("substring", T.VARCHAR, S, ir.Const(3, T.BIGINT))),
        ("in_substr", ir.InListIr(
            C("substring", T.VARCHAR, S, ir.Const(1, T.BIGINT), ir.Const(2, T.BIGINT)),
            ("13", "31"), False)),
        ("case_dec", ir.CaseWhen(((K3, A),), C("neg", d12, A), d12)),
        ("case_no_else", ir.CaseWhen(((K3, X), (F, Y)), None, T.DOUBLE)),
        ("case_dec128", ir.CaseWhen(((F, W), (K3, C("cast", d38, A))), ir.Const(0, d38), d38)),
        ("case_dec128_no_else", ir.CaseWhen(((K3, W),), None, d38)),
        ("case_str", ir.CaseWhen(((K3, S),), ir.Const("other", T.VARCHAR), T.VARCHAR)),
        ("case_str_no_else", ir.CaseWhen(((F, S), (K3, ir.Const("k", T.VARCHAR))), None, T.VARCHAR)),
        ("case_null_cond", ir.CaseWhen(((C("gt", T.BOOLEAN, X, ir.Const(0.0, T.DOUBLE)), Y),),
                                       X, T.DOUBLE)),
        ("coalesce_f", C("coalesce", T.DOUBLE, X, Y)),
        ("coalesce_int", C("coalesce", T.INTEGER, K, ir.Const(-1, T.INTEGER))),
        ("coalesce_str", C("coalesce", T.VARCHAR, S, ir.Const("none", T.VARCHAR))),
    ]
    for pat in ("%b%", "a_c", "a%b", "x_y", "PROMO%", "%special%requests%", "%", "",
                "Brand#1_", "_%BOX"):
        cases.append((f"like[{pat}]", ir.LikeIr(S, pat, False)))
        cases.append((f"not_like[{pat}]", ir.LikeIr(S, pat, True)))
    return cases


def _string_columns():
    rng = np.random.default_rng(23)
    n = 301
    m = lambda p: rng.random(n) < p
    wide = np.empty(n, dtype=object)
    wide[:] = [int(v) * (1 << 30) for v in rng.integers(-(2**62), 2**62, n)]
    return [
        np.ma.MaskedArray(_WORDS[rng.integers(0, len(_WORDS), n)], mask=m(0.15)),
        np.ma.MaskedArray(rng.integers(0, 8, n).astype(np.int32), mask=m(0.15)),
        rng.integers(-10**9, 10**9, n), wide,
        np.ma.MaskedArray(rng.normal(size=n), mask=m(0.2)), rng.normal(size=n), m(0.4),
    ]


def _string_types(T):
    return [T.VARCHAR, T.INTEGER, T.DecimalType(12, 2), T.DecimalType(38, 2),
            T.DOUBLE, T.DOUBLE, T.BOOLEAN]


_STRING_LABELS = [label for label, _ in _string_cases(
    __import__("trino_tpu_torch.plan.ir", fromlist=["x"]),
    __import__("trino_tpu_torch.data.types", fromlist=["x"]),
)]


@pytest.fixture(scope="module")
def string_sides():
    from trino_tpu.data import types as RT
    from trino_tpu.data.page import Page as RefPage
    from trino_tpu.ops import expr as ref_expr
    from trino_tpu.plan import ir as ref_ir
    from trino_tpu_torch.data import types as PT
    from trino_tpu_torch.data.page import Page
    from trino_tpu_torch.ops import expr as port_expr
    from trino_tpu_torch.plan import ir as port_ir

    cols = _string_columns()
    rpage = RefPage.from_numpy(_string_types(RT), cols)
    ppage = Page.from_numpy(_string_types(PT), cols, device="cpu")
    return (
        dict(_string_cases(ref_ir, RT)), [ref_expr.column_val(c) for c in rpage.columns],
        ref_expr, dict(_string_cases(port_ir, PT)),
        [port_expr.column_val(c) for c in ppage.columns], port_expr, ppage.capacity, cols,
    )


# The reference labels coalesce's merged codes with its first argument's
# dictionary, so a lane taken from a later branch names the wrong string
# (ROADMAP §C).  For these labels the port is held to the strings SQL
# defines, computed here from the numpy columns.
_EXPECTED_STRINGS = {
    "coalesce_str": lambda cols: [
        "none" if masked else s for s, masked in zip(cols[0].data, np.ma.getmaskarray(cols[0]))
    ],
}


@pytest.mark.parametrize("label", _STRING_LABELS)
def test_dictionary_and_case_nodes_match_reference(label, string_sides):
    """Each new node on NULL-bearing operands: validity exact, integers and
    limbs exact, doubles within 1 ulp, varchar results equal as strings
    (their dictionaries too)."""
    rcases, rcols, ref_expr, pcases, pcols, port_expr, n, cols = string_sides
    got = port_expr.eval_expr(pcases[label], pcols, n)
    if label in _EXPECTED_STRINGS:
        assert got.valid is None or bool(got.valid.numpy()[: len(cols[0])].all()), label
        gs = got.dict.values[got.data.numpy()[: len(cols[0])]]
        assert list(gs) == _EXPECTED_STRINGS[label](cols), label
        return
    want = ref_expr.eval_expr(rcases[label], rcols, n)
    assert (got.dict is None) == (want.dict is None), label
    if got.dict is None:
        _assert_same(got, want, label)
        return
    gv = np.ones(n, bool) if got.valid is None else got.valid.numpy()
    wv = np.ones(n, bool) if want.valid is None else _np(want.valid)
    assert np.array_equal(gv, wv), f"{label}: validity differs"
    assert list(got.dict.values) == list(want.dict.values), f"{label}: dictionaries differ"
    gs = got.dict.values[got.data.numpy()[gv]]
    ws = want.dict.values[_np(want.data)[wv]]
    assert list(gs) == list(ws), label


# ----------------------------- the scalar library: math, dates, casts, strings


_SCALAR_WORDS = np.asarray(
    ["", "abc", " padded ", "a b c", "42", "-7", "3.25", "1998-12-01", "true", "False",
     "xyz", "banana split", "1e3", "AN ant"], dtype=object,
)
_OTHER_WORDS = np.asarray(["-", "abc", "Zed", "q r"], dtype=object)
_NUMBERS = np.asarray(["1", "22", "-5", "300", "0"], dtype=object)
_DATES = np.asarray(["1998-12-01", "2000-02-29", "1970-01-01", "1992-07-15"], dtype=object)


def _scalar_cases(ir, T):
    """(label, expr) over columns [x double null, y double, i bigint null,
    j bigint, k integer 0..10, d date null, e date, s varchar null,
    t varchar, u varchar of integers, w varchar of dates]."""
    X, Y = ir.FieldRef(0, T.DOUBLE), ir.FieldRef(1, T.DOUBLE)
    I, J, K = ir.FieldRef(2, T.BIGINT), ir.FieldRef(3, T.BIGINT), ir.FieldRef(4, T.INTEGER)
    D, E = ir.FieldRef(5, T.DATE), ir.FieldRef(6, T.DATE)
    S, Tt = ir.FieldRef(7, T.VARCHAR), ir.FieldRef(8, T.VARCHAR)
    U, W = ir.FieldRef(9, T.VARCHAR), ir.FieldRef(10, T.VARCHAR)
    C = lambda op, ty, *args: ir.Call(op, tuple(args), ty)
    lit = lambda v, ty: ir.Const(v, ty)
    s_ = lambda v: ir.Const(v, T.VARCHAR)
    cases = [
        ("round", C("round", T.DOUBLE, X)), ("round_2", C("round", T.DOUBLE, X, lit(2, T.INTEGER))),
        ("round_neg", C("round", T.DOUBLE, X, lit(-1, T.INTEGER))),
        ("floor", C("floor", T.DOUBLE, X)), ("ceil", C("ceil", T.DOUBLE, X)),
        ("floor_int", C("floor", T.DOUBLE, I)), ("sqrt", C("sqrt", T.DOUBLE, X)),
        ("power", C("power", T.DOUBLE, X, Y)), ("power_int", C("power", T.DOUBLE, I, K)),
        ("atan2", C("atan2", T.DOUBLE, X, Y)),
        ("sign_f", C("sign", T.DOUBLE, X)), ("sign_i", C("sign", T.BIGINT, I)),
        ("truncate", C("truncate", T.DOUBLE, X)),
        ("truncate_1", C("truncate", T.DOUBLE, X, lit(1, T.INTEGER))),
        ("nullif_i", C("nullif", T.BIGINT, I, J)),
        ("nullif_str", C("nullif", T.VARCHAR, S, Tt)),
        ("nullif_str_const", C("nullif", T.VARCHAR, S, s_("abc"))),
        ("greatest", C("greatest", T.BIGINT, I, J, lit(5, T.BIGINT))),
        ("least", C("least", T.DOUBLE, X, Y)),
        ("quarter", C("extract_quarter", T.BIGINT, D)), ("dow", C("extract_dow", T.BIGINT, D)),
        ("doy", C("extract_doy", T.BIGINT, D)), ("week", C("extract_week", T.BIGINT, D)),
        ("last_day", C("last_day_of_month", T.DATE, D)),
        ("date_diff", C("date_diff_days", T.BIGINT, D, E)),
        ("try_cast_bigint", C("try_cast", T.BIGINT, S)),
        ("try_cast_double", C("try_cast", T.DOUBLE, S)),
        ("try_cast_date", C("try_cast", T.DATE, S)),
        ("try_cast_bool", C("try_cast", T.BOOLEAN, S)),
        ("try_cast_decimal", C("try_cast", T.DecimalType(10, 2), S)),
        ("cast_bigint", C("cast", T.BIGINT, U)), ("cast_double", C("cast", T.DOUBLE, U)),
        ("cast_date", C("cast", T.DATE, W)),
        ("length", C("length", T.BIGINT, S)),
        ("replace", C("replace", T.VARCHAR, S, s_("a"), s_("xy"))),
        ("strpos", C("strpos", T.BIGINT, S, s_("a"))),
        ("starts_with", C("starts_with", T.BOOLEAN, S, s_("a"))),
        ("lpad", C("lpad", T.VARCHAR, S, lit(5, T.BIGINT), s_("*"))),
        ("rpad", C("rpad", T.VARCHAR, S, lit(4, T.BIGINT))),
        ("split_part", C("split_part", T.VARCHAR, S, s_(" "), lit(2, T.BIGINT))),
        ("regexp_like", C("regexp_like", T.BOOLEAN, S, s_("^[a-c]"))),
        ("regexp_replace", C("regexp_replace", T.VARCHAR, S, s_("[aeiou]"), s_("_"))),
        ("regexp_replace_drop", C("regexp_replace", T.VARCHAR, S, s_(" "))),
        ("regexp_extract", C("regexp_extract", T.VARCHAR, S, s_("([a-z]+) "), lit(1, T.BIGINT))),
        ("regexp_extract_all", C("regexp_extract", T.VARCHAR, S, s_("[0-9]+"))),
        ("concat", C("concat_str", T.VARCHAR, S, s_("-"), Tt)),
        ("concat_lead_literal", C("concat_str", T.VARCHAR, s_("x="), S)),
    ]
    for op in ("ln", "log2", "log10", "exp", "sin", "cos", "tan", "asin", "acos", "atan",
               "cbrt", "degrees", "radians"):
        cases.append((op, C(op, T.DOUBLE, X)))
    for op in ("bitwise_and", "bitwise_or", "bitwise_xor", "shift_left", "shift_right"):
        cases.append((op, C(op, T.BIGINT, I, K if op.startswith("shift") else J)))
    for unit in ("year", "quarter", "month", "week", "day"):
        cases.append((f"date_trunc_{unit}", C("date_trunc", T.DATE, D, s_(unit))))
    for op in ("upper", "lower", "trim", "ltrim", "rtrim", "reverse_str"):
        cases.append((op, C(op, T.VARCHAR, S)))
    return cases


def _scalar_columns():
    rng = np.random.default_rng(29)
    n = 311
    m = lambda p: rng.random(n) < p
    i = rng.integers(-1000, 1000, n)
    j = rng.integers(-1000, 1000, n)
    j[:20] = i[:20]  # equal pairs for nullif
    x = rng.normal(scale=3.0, size=n)
    x[:6] = [0.5, -0.5, 2.5, -2.5, 0.125, 1e-3]  # halves for round, small for the trig domain
    return [
        np.ma.MaskedArray(x, mask=m(0.15)), rng.normal(size=n),
        np.ma.MaskedArray(i, mask=m(0.15)), j, rng.integers(0, 11, n).astype(np.int32),
        np.ma.MaskedArray(rng.integers(-20000, 30000, n).astype(np.int32), mask=m(0.1)),
        rng.integers(-20000, 30000, n).astype(np.int32),
        np.ma.MaskedArray(_SCALAR_WORDS[rng.integers(0, len(_SCALAR_WORDS), n)], mask=m(0.15)),
        _OTHER_WORDS[rng.integers(0, len(_OTHER_WORDS), n)],
        _NUMBERS[rng.integers(0, len(_NUMBERS), n)], _DATES[rng.integers(0, len(_DATES), n)],
    ]


def _scalar_types(T):
    return [T.DOUBLE, T.DOUBLE, T.BIGINT, T.BIGINT, T.INTEGER, T.DATE, T.DATE,
            T.VARCHAR, T.VARCHAR, T.VARCHAR, T.VARCHAR]


_SCALAR_LABELS = [label for label, _ in _scalar_cases(
    __import__("trino_tpu_torch.plan.ir", fromlist=["x"]),
    __import__("trino_tpu_torch.data.types", fromlist=["x"]),
)]


@pytest.fixture(scope="module")
def scalar_sides():
    from trino_tpu.data import types as RT
    from trino_tpu.data.page import Page as RefPage
    from trino_tpu.ops import expr as ref_expr
    from trino_tpu.plan import ir as ref_ir
    from trino_tpu_torch.data import types as PT
    from trino_tpu_torch.data.page import Page
    from trino_tpu_torch.ops import expr as port_expr
    from trino_tpu_torch.plan import ir as port_ir

    cols = _scalar_columns()
    rpage = RefPage.from_numpy(_scalar_types(RT), cols)
    ppage = Page.from_numpy(_scalar_types(PT), cols, device="cpu")
    return (
        dict(_scalar_cases(ref_ir, RT)), [ref_expr.column_val(c) for c in rpage.columns],
        ref_expr, dict(_scalar_cases(port_ir, PT)),
        [port_expr.column_val(c) for c in ppage.columns], port_expr, ppage.capacity,
    )


# round() over x's exact ties (0.5, -0.5, 2.5, -2.5, 0.125): the port rounds
# half away from zero, as Trino and sqlite do; the reference rounds half to
# even (ROADMAP C), so these cases are held against sqlite's round()
_SQLITE_HELD = {"round": "round(x)", "round_2": "round(x, 2)"}


def _sqlite_round(label: str, n: int):
    import sqlite3

    x = _scalar_columns()[0]
    db = sqlite3.connect(":memory:")
    db.execute("create table xs (i integer, x double)")
    db.executemany("insert into xs values (?, ?)",
                   [(i, None if x.mask[i] else float(x.data[i])) for i in range(n)])
    rows = db.execute(f"select {_SQLITE_HELD[label]} from xs order by i").fetchall()
    db.close()
    return SimpleNamespace(
        data=np.asarray([0.0 if v is None else v for (v,) in rows]),
        valid=np.asarray([v is not None for (v,) in rows]), dict=None)


@pytest.mark.parametrize("label", _SCALAR_LABELS)
def test_scalar_function_matches_reference(label, scalar_sides):
    """Each new operator on NULL-bearing operands against the reference's
    eval_expr (round over exact ties against sqlite): validity exact,
    integers and strings exact (dictionaries too), doubles within rel 1e-12
    (NaN where the reference has NaN)."""
    rcases, rcols, ref_expr, pcases, pcols, port_expr, n = scalar_sides
    got = port_expr.eval_expr(pcases[label], pcols, n)
    if label in _SQLITE_HELD:
        want = _sqlite_round(label, n)
        ties = [float(v) for v in got.data[2:5]]  # x = 2.5, -2.5, 0.125
        assert ties == ([3.0, -3.0, 0.0] if label == "round" else [2.5, -2.5, 0.13])
    else:
        want = ref_expr.eval_expr(rcases[label], rcols, n)
    gv = np.ones(n, bool) if got.valid is None else got.valid.numpy()
    wv = np.ones(n, bool) if want.valid is None else _np(want.valid)
    assert np.array_equal(gv, wv), f"{label}: validity differs"
    assert (got.dict is None) == (want.dict is None), label
    gd, wd = got.data.numpy()[gv], _np(want.data)[wv]
    if got.dict is not None:
        assert list(got.dict.values) == list(want.dict.values), f"{label}: dictionaries differ"
        assert list(got.dict.values[gd]) == list(want.dict.values[wd]), label
    elif np.issubdtype(gd.dtype, np.floating):
        wd = wd.astype(np.float64)
        assert np.array_equal(np.isnan(gd), np.isnan(wd)), f"{label}: NaN lanes differ"
        a, b = gd[~np.isnan(gd)], wd[~np.isnan(wd)]
        assert np.all(np.abs(a - b) <= 1e-12 * np.abs(b) + 1e-300), f"{label}: > rel 1e-12"
    else:
        assert np.array_equal(gd.astype(np.int64), wd.astype(np.int64)), label


def test_cast_varchar_to_decimal_parses_the_strings(scalar_sides):
    """cast(varchar as decimal): each distinct string parsed at the target
    scale (the reference rescales the dictionary codes instead, so this
    case is held to the strings' values)."""
    from trino_tpu_torch.data import types as PT
    from trino_tpu_torch.plan import ir as port_ir

    *_, pcols, port_expr, n = scalar_sides
    e = port_ir.Call("cast", (port_ir.FieldRef(9, PT.VARCHAR),), PT.DecimalType(10, 2))
    got = port_expr.eval_expr(e, pcols, n)
    strings = pcols[9].dict.values[pcols[9].data.numpy()]
    assert got.data.tolist() == [int(s) * 100 for s in strings]


# ------------------------------------------- repairs held against sqlite
# (the reference keeps these faults, ROADMAP C: its constants fold with
# floor division, its round() is half to even, a bigint constant overflow
# wraps)


@pytest.mark.parametrize("sql", [
    "select -7 / 2, -7 % 2, 7 % -2",
    "select 7 / -2, -7 / -2, -7 % -2, 0 / 5, 9 % 3",
    "select round(2.5), round(-2.5), round(0.125, 2)",
    "select round(0.5), round(-0.5), round(1.5), round(-1.5), round(2.675, 1)",
], ids=["fold_truncates", "fold_signs", "round_ties", "round_more_ties"])
def test_constant_repairs_equal_sqlite(sql, engines):
    import sqlite3

    _, port = engines
    db = sqlite3.connect(":memory:")
    want = [tuple(r) for r in db.execute(sql).fetchall()]
    db.close()
    assert port.query(sql) == want
    if sql == "select -7 / 2, -7 % 2, 7 % -2":
        assert want == [(-3, -1, 1)]


@pytest.mark.parametrize("sql", [
    "select n_nationkey, round(n_nationkey / 2.0) from nation order by n_nationkey",
    "select l_discount, round(l_discount * 10) from lineitem "
    "group by l_discount order by l_discount",
    "select l_orderkey, l_linenumber, round(l_extendedprice / 8, 1) from lineitem "
    "where l_orderkey < 2000 order by l_orderkey, l_linenumber",
], ids=["nation_halves", "lineitem_discount_halves", "lineitem_one_digit"])
def test_round_half_away_from_zero_over_columns_equals_sqlite(sql, engines, oracle):
    from tests.oracle import assert_rows_equal

    _, port = engines
    assert_rows_equal(port.query(sql), oracle.query(sql), ordered=True)


@pytest.mark.parametrize("sql,message", [
    ("select 9223372036854775807 + 1", "bigint addition overflow: 9223372036854775807 + 1"),
    ("select -9223372036854775807 - 2", "bigint subtraction overflow: -9223372036854775807 - 2"),
    ("select 4611686018427387904 * 2", "bigint multiplication overflow: 4611686018427387904 * 2"),
], ids=["add", "sub", "mul"])
def test_bigint_constant_overflow_raises_typed_error(sql, message, engines):
    from trino_tpu_torch.plan.planner import NumericValueOutOfRange

    _, port = engines
    with pytest.raises(NumericValueOutOfRange) as info:
        port.query(sql)
    assert str(info.value) == message
    assert isinstance(info.value, OverflowError)
    assert info.value.error_code == "NUMERIC_VALUE_OUT_OF_RANGE"
    assert port.query("select 9223372036854775806 + 1") == [(9223372036854775807,)]
