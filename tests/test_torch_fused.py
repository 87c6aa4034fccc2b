"""Fused scan→aggregate pipeline of the port: `plan_pipeline` accepts and
declines what the reference does, the bytecode interpreter (the plain version
of the CUDA kernel) agrees exactly with the port's operator-at-a-time path,
and within the reference kernel's tolerance (rel 1e-6) with the reference's
`fused.run` in interpret mode."""

import struct

import numpy as np
import pytest
try:  # arrow before torch: loaded after it, arrow's parquet writer crashes the process
    import pyarrow  # noqa: F401
except ImportError:
    pass
import torch

torch.set_num_threads(1)

N = 3000


class _Side:
    """One package's view of the same seeded columns and IR."""

    def __init__(self, port: bool):
        if port:
            from trino_tpu_torch.data import types as T
            from trino_tpu_torch.data.page import Page
            from trino_tpu_torch.ops import expr
            from trino_tpu_torch.ops.cuda import fused
            from trino_tpu_torch.plan import ir
        else:
            from trino_tpu.data import types as T
            from trino_tpu.data.page import Page
            from trino_tpu.ops import expr
            from trino_tpu.ops.pallas import fused
            from trino_tpu.plan import ir
        self.T, self.ir, self.expr, self.fused, self.port = T, ir, expr, fused, port
        rng = np.random.default_rng(23)
        m = lambda p: rng.random(N) < p
        strs = lambda k: np.asarray([f"k{v}" for v in rng.integers(0, k, N)], dtype=object)
        d12 = T.DecimalType(12, 2)
        self.types = [
            d12, d12, d12, d12,            # 0 qty, 1 price, 2 disc, 3 tax
            T.VARCHAR, T.VARCHAR,          # 4 flag (3 values), 5 status (2 values)
            T.DATE,                        # 6 shipdate
            d12,                           # 7 nullable decimal
            T.DOUBLE,                      # 8 nullable double
            T.BIGINT,                      # 9 bigint
            T.VARCHAR,                     # 10 wide key (700 values)
            T.VARCHAR,                     # 11 nullable key
            T.BOOLEAN,                     # 12 nullable flag
            T.INTEGER,                     # 13 integer
        ]
        arrays = [
            rng.integers(100, 5001, N), rng.integers(90000, 10**7, N),
            rng.integers(0, 11, N), rng.integers(0, 9, N),
            strs(3), strs(2), rng.integers(8036, 10562, N).astype(np.int32),
            np.ma.MaskedArray(rng.integers(-10**9, 10**9, N), mask=m(0.3)),
            np.ma.MaskedArray(rng.normal(scale=100.0, size=N), mask=m(0.2)),
            rng.integers(-10**15, 10**15, N), strs(700),
            np.ma.MaskedArray(strs(4), mask=m(0.1)),
            np.ma.MaskedArray(m(0.5), mask=m(0.2)),
            rng.integers(-1000, 1000, N).astype(np.int32),
        ]
        page = Page.from_numpy(self.types, arrays, device="cpu") if port else Page.from_numpy(self.types, arrays)
        self.cols = [expr.column_val(c) for c in page.columns]
        self.live = rng.random(N) < 0.9

    # ---- IR constructors (each package's own classes)
    def f(self, i):
        return self.ir.FieldRef(i, self.types[i])

    def c(self, op, ty, *args):
        return self.ir.Call(op, tuple(args), ty)

    def k(self, v, ty):
        return self.ir.Const(v, ty)


def _fragments(s: _Side):
    """name -> (filters, keys, fns, args, out types)."""
    T = s.T
    d13, d25, d38_2, d38_4, d38_6 = (
        T.DecimalType(13, 2), T.DecimalType(25, 4), T.DecimalType(38, 2),
        T.DecimalType(38, 4), T.DecimalType(38, 6),
    )
    one_minus = s.c("sub", d13, s.k(100, d13), s.c("cast", d13, s.f(2)))
    one_plus = s.c("add", d13, s.k(100, d13), s.c("cast", d13, s.f(3)))
    disc_price = s.c("mul", d25, s.f(1), one_minus)
    charge = s.c("mul", d38_6, disc_price, one_plus)
    dbl = lambda i: s.c("cast", T.DOUBLE, s.f(i))
    ship = s.c("le", T.BOOLEAN, s.f(6), s.k(10471, T.DATE))
    q1 = (
        [ship], [s.f(4), s.f(5)],
        ["sum", "sum", "sum", "sum", "avg", "avg", "avg", "count_star"],
        [s.f(0), s.f(1), disc_price, charge, dbl(0), dbl(1), dbl(2), None],
        [d38_2, d38_2, d38_4, d38_6, T.DOUBLE, T.DOUBLE, T.DOUBLE, T.BIGINT],
    )
    q6 = (
        [s.c("ge", T.BOOLEAN, s.f(6), s.k(8766, T.DATE)),
         s.c("lt", T.BOOLEAN, s.f(6), s.k(9131, T.DATE)),
         s.c("le", T.BOOLEAN, s.c("cast", d13, s.f(2)), s.k(7, d13)),
         s.c("ge", T.BOOLEAN, s.c("cast", d13, s.f(2)), s.k(5, d13)),
         s.c("lt", T.BOOLEAN, s.c("cast", d13, s.f(0)), s.k(2400, d13))],
        [], ["sum"], [s.c("mul", T.DecimalType(24, 4), s.f(1), s.f(2))], [d38_4],
    )
    nulls = (
        [s.c("or", T.BOOLEAN,
             s.c("and", T.BOOLEAN, s.f(12), s.c("not", T.BOOLEAN, s.c("is_null", T.BOOLEAN, s.f(7)))),
             s.c("gt", T.BOOLEAN, s.f(8), s.k(-50.0, T.DOUBLE)))],
        [s.f(4)],
        ["sum", "count", "sum", "avg", "count_star", "sum", "count"],
        [s.f(7), s.f(7), s.f(8), s.f(8), None,
         s.c("neg", d13, s.c("add", d13, s.c("cast", d13, s.f(7)), s.k(None, d13))), s.f(8)],
        [d38_2, T.BIGINT, T.DOUBLE, T.DOUBLE, T.BIGINT, d38_2, T.BIGINT],
    )
    all_filtered = (
        [s.c("lt", T.BOOLEAN, s.f(6), s.k(0, T.DATE))], [s.f(4)],
        ["sum", "avg", "count_star"], [s.f(0), dbl(0), None], [d38_2, T.DOUBLE, T.BIGINT],
    )
    ok = {"q1": q1, "q6": q6, "nulls": nulls, "all_filtered": all_filtered}
    declined = {
        "agg_min": ([], [s.f(4)], ["min"], [s.f(0)], [T.DecimalType(12, 2)]),
        "computed_key": ([], [s.c("cast", T.VARCHAR, s.f(4))], ["count_star"], [None], [T.BIGINT]),
        "wide_domain": ([], [s.f(10)], ["count_star"], [None], [T.BIGINT]),
        "bigint_column": ([], [s.f(4)], ["sum"], [s.f(9)], [T.BIGINT]),
        "dict_in_expr": ([s.c("eq", T.BOOLEAN, s.f(4), s.f(5))], [], ["count_star"], [None], [T.BIGINT]),
        "nullable_key": ([], [s.f(11)], ["count_star"], [None], [T.BIGINT]),
        "non_dict_key": ([], [s.f(6)], ["count_star"], [None], [T.BIGINT]),
        "mixed_arith": ([], [], ["sum"], [s.c("add", T.DOUBLE, s.f(8), s.f(0))], [T.DOUBLE]),
        "integer_add": ([], [], ["count"], [s.c("add", T.INTEGER, s.f(13), s.f(13))], [T.BIGINT]),
        "scales_differ": ([s.c("lt", T.BOOLEAN, s.f(0), s.f(6))], [], ["count_star"], [None], [T.BIGINT]),
        "non_bool_filter": ([s.f(0)], [], ["count_star"], [None], [T.BIGINT]),
        "sum_over_bool": ([], [], ["sum"], [s.f(12)], [T.BIGINT]),
        "key_as_value": ([], [s.f(4)], ["count"], [s.f(4)], [T.BIGINT]),
        "mul_rescale": ([], [], ["sum"], [s.c("mul", d38_2, s.f(0), s.f(1))], [d38_2]),
        "narrowing_cast": ([], [], ["sum"], [s.c("cast", T.DecimalType(12, 1), s.f(0))], [d38_2]),
        "unknown_op": ([], [], ["sum"], [s.c("abs", T.DecimalType(12, 2), s.f(0))], [d38_2]),
    }
    return ok, declined


@pytest.fixture(scope="module")
def sides():
    return _Side(port=True), _Side(port=False)


_OK = ["q1", "q6", "nulls", "all_filtered"]
_DECLINED = [
    "agg_min", "computed_key", "wide_domain", "bigint_column", "dict_in_expr",
    "nullable_key", "non_dict_key", "mixed_arith", "integer_add", "scales_differ",
    "non_bool_filter", "sum_over_bool", "key_as_value", "mul_rescale",
    "narrowing_cast", "unknown_op",
]


@pytest.mark.parametrize("name", _OK + _DECLINED)
def test_plan_pipeline_accepts_and_declines_like_the_reference(name, sides):
    port, ref = sides
    frag_p = {**_fragments(port)[0], **_fragments(port)[1]}[name]
    frag_r = {**_fragments(ref)[0], **_fragments(ref)[1]}[name]
    got, why = port.fused.plan_pipeline(port.cols, *frag_p)
    want, ref_why = ref.fused.plan_pipeline(ref.cols, *frag_r)
    assert (got is None) == (want is None) == (name in _DECLINED), (why, ref_why)
    assert why == ref_why
    if got is not None:
        assert got.domain == want.domain and got.keys == want.keys
        assert len(got.program) <= 256 and got.n_regs <= 32


def test_port_only_declines_name_their_reason(sides):
    port, _ = sides
    T = port.T
    d12 = T.DecimalType(12, 2)
    _, why = port.fused.plan_pipeline(port.cols, [], [], ["avg"], [port.f(0)], [d12])
    assert why == "avg with decimal result"
    _, why = port.fused.plan_pipeline(
        port.cols, [], [], ["sum"], [port.c("add", T.DOUBLE, port.f(0), port.f(1))], [T.DOUBLE]
    )
    assert why == "integer operands with double result"
    # a constant beyond the reference's float-pair range is fine here
    wide = port.c("add", T.DecimalType(38, 2), port.c("cast", T.DecimalType(38, 2), port.f(0)),
                  port.k(1 << 100, T.DecimalType(38, 2)))
    recipe, why = port.fused.plan_pipeline(
        port.cols, [], [], ["sum"], [wide], [T.DecimalType(38, 2)]
    )
    assert recipe is not None, why


def _operator_path(s: _Side, frag, live):
    """The port's operator-at-a-time evaluation of a fragment."""
    from trino_tpu_torch.ops.relops import AggSpec, group_aggregate

    filters, keys, fns, args, types = frag
    for flt in filters:
        live = live & s.expr.eval_predicate(flt, s.cols, N)
    kv = [s.expr.eval_expr(k, s.cols, N) for k in keys]
    av = [None if a is None else s.expr.eval_expr(a, s.cols, N) for a in args]
    specs = [AggSpec(fn, type=t) for fn, t in zip(fns, types)]
    return group_aggregate(kv, av, specs, live, 1024)


@pytest.mark.parametrize("name", _OK)
def test_bytecode_interpreter_equals_operator_path_exactly(name, sides):
    port, _ = sides
    frag = _fragments(port)[0][name]
    live = torch.from_numpy(port.live)
    recipe, why = port.fused.plan_pipeline(port.cols, *frag)
    assert recipe is not None, why
    totals = port.fused.run(recipe, port.cols, live)
    key_codes, agg_cols, out_live, n_groups = port.fused.assemble(recipe, totals)
    want_keys, want_aggs, want_live, want_groups = _operator_path(port, frag, live)
    assert torch.equal(out_live, want_live) and int(n_groups) == int(want_groups)
    assert len(key_codes) == len(want_keys) and len(agg_cols) == len(want_aggs)
    for code, (data, _, _) in zip(key_codes, want_keys):
        assert torch.equal(code, data)
    for got, want in zip(agg_cols, want_aggs):
        assert len(got) == len(want)
        for g, w in zip(got, want):  # data, valid[, None, hi]
            if g is None or w is None:
                assert g is None and w is None
            elif g.dtype.is_floating_point:
                ok = out_live if got[1] is None else (out_live & got[1])
                assert torch.equal(g[ok], w[ok])  # same additions in the same order
            else:
                assert g.dtype == w.dtype and torch.equal(g, w)
    if name == "all_filtered":
        assert int(n_groups) == 0


def _as_python(cols, live):
    """Aggregate tuples -> per-column lists of python numbers (None = NULL)."""
    out = []
    live = np.asarray(live)
    for col in cols:
        data = np.asarray(col[0])
        valid = None if col[1] is None else np.asarray(col[1])
        hi = np.asarray(col[3]) if len(col) == 4 else None
        vals = []
        for i in np.nonzero(live)[0]:
            if valid is not None and not valid[i]:
                vals.append(None)
            elif hi is not None:
                lo = int(data[i])
                vals.append(int(hi[i]) * (1 << 64) + (lo + (1 << 64) if lo < 0 else lo))
            else:
                vals.append(data[i].item())
        out.append(vals)
    return out


@pytest.mark.parametrize("name", ["q1", "q6"])
def test_bytecode_interpreter_vs_reference_kernel_interpreted(name, sides):
    import jax.numpy as jnp

    port, ref = sides
    frag_p, frag_r = _fragments(port)[0][name], _fragments(ref)[0][name]
    recipe, _ = port.fused.plan_pipeline(port.cols, *frag_p)
    totals = port.fused.run(recipe, port.cols, torch.from_numpy(port.live))
    _, agg_cols, out_live, n_groups = port.fused.assemble(recipe, totals)
    ref_recipe, why = ref.fused.plan_pipeline(ref.cols, *frag_r)
    assert ref_recipe is not None, why
    ref_totals = ref.fused.run(ref_recipe, ref.cols, jnp.asarray(ref.live), interpret=True)
    _, ref_aggs, ref_live, ref_groups = ref.fused.assemble(ref_recipe, ref_totals)
    assert int(n_groups) == int(ref_groups)
    assert np.array_equal(out_live.numpy(), np.asarray(ref_live))
    got = _as_python([tuple(None if t is None else t.numpy() for t in c) for c in agg_cols],
                     out_live.numpy())
    want = _as_python(ref_aggs, ref_live)
    for fn, g_col, w_col in zip(frag_p[2], got, want):
        for g, w in zip(g_col, w_col):
            if fn == "count_star":
                assert g == w
            else:  # the reference kernel sums f32 partials: rel 1e-6
                assert g is not None and w is not None
                assert abs(float(g) - float(w)) <= 1e-6 * max(abs(float(w)), 1.0), (fn, g, w)


def test_run_counts_no_launch_on_cpu_and_checks_dtypes(sides):
    port, _ = sides
    frag = _fragments(port)[0]["q6"]
    recipe, _ = port.fused.plan_pipeline(port.cols, *frag)
    before = port.fused.launches()
    port.fused.run(recipe, port.cols, None)
    assert port.fused.launches() == before
    import copy

    wrong = copy.copy(port.cols)
    wrong[1] = port.expr.ColumnVal(port.cols[1].data.to(torch.int32), None, None, port.cols[1].type)
    with pytest.raises(TypeError, match="does not match"):
        port.fused.run(recipe, wrong, None)


# ------------------------------------------- the kernel generated per recipe
#
# The generated CUDA source is checked here without a card, NVRTC or triton;
# compiling and running it is the card's part (the `cuda` tests below and
# chip_smoke.py).


def _recipe(s: _Side, name: str):
    recipe, why = s.fused.plan_pipeline(s.cols, *_fragments(s)[0][name])
    assert recipe is not None, why
    return recipe


@pytest.mark.parametrize("name", _OK)
def test_generator_emits_deterministic_source_for_every_recipe(name, sides):
    from trino_tpu_torch.ops.cuda import fused_codegen as fc

    port, _ = sides
    recipe = _recipe(port, name)
    first, again = fc.generate(recipe), fc.generate(_recipe(port, name))
    assert first == again
    assert f'extern "C" __global__ void __launch_bounds__({fc.THREADS}) {first.name}(' in first.source
    assert first.source.count("__any_sync") >= 1 + sum(
        1 for ins in recipe.program if ins[0] == port.fused.OP_FILTER)
    assert first.route == fc.route_for(recipe)[0]
    # the route's rows per thread, 32 apart in the warp's tile
    rows = first.rows_per_thread
    assert f"r{rows - 1} = base + lane + {32 * (rows - 1)}" in first.source
    assert f"r{rows} = " not in first.source


def test_generator_routes_by_table_size(sides):
    from trino_tpu_torch.ops.cuda import fused_codegen as fc

    port, _ = sides
    assert fc.route_for(_recipe(port, "q6"))[0] == "reg"      # D = 1
    route, smem = fc.route_for(_recipe(port, "q1"))            # 8 streams x D = 6
    assert route == "warp" and smem == (fc.THREADS // 32) * 8 * 6 * 16
    T = port.T
    wide, why = port.fused.plan_pipeline(
        port.cols, [], [port.f(4), port.f(10)], ["count_star", "sum"],
        [None, port.f(0)], [T.BIGINT, T.DecimalType(38, 2)])
    assert wide is None and "key domain" in why  # 3 x 700 > 512: declined up front
    import dataclasses

    q1 = _recipe(port, "q1")
    big = dataclasses.replace(q1, domain=512)
    assert fc.route_for(big)[0] == "global"


def test_cache_key_ignores_column_pointers_and_constants(sides):
    from trino_tpu_torch.ops.cuda import fused_codegen as fc

    port, _ = sides
    recipe = _recipe(port, "q6")
    # the same fragment over other columns (new tensors, other data) of the
    # same dtypes: the same kernel
    other = [port.expr.ColumnVal(c.data.clone() + 1 if c.data.dtype != torch.bool else c.data.clone(),
                                 None if c.valid is None else c.valid.clone(), c.dict, c.type)
             for c in port.cols]
    again, _ = port.fused.plan_pipeline(other, *_fragments(port)[0]["q6"])
    assert fc.cache_key(again) == fc.cache_key(recipe)
    # another literal is a kernel argument, not another kernel
    T = port.T
    d13 = T.DecimalType(13, 2)
    frag = list(_fragments(port)[0]["q6"])
    frag[0] = frag[0][:-1] + [port.c("lt", T.BOOLEAN, port.c("cast", d13, port.f(0)), port.k(2500, d13))]
    shifted, _ = port.fused.plan_pipeline(port.cols, *frag)
    assert fc.cache_key(shifted) == fc.cache_key(recipe)
    assert fc.constants(shifted) != fc.constants(recipe)
    assert 2400 in fc.constants(recipe) and 2500 in fc.constants(shifted)


def test_cache_key_differs_with_program_dtypes_and_domain(sides, monkeypatch):
    import dataclasses

    from trino_tpu_torch.ops.cuda import fused_codegen as fc
    from trino_tpu_torch.ops.cuda import nvrtc

    port, _ = sides
    q1, q6 = _recipe(port, "q1"), _recipe(port, "q6")
    keys = {fc.cache_key(q1), fc.cache_key(q6)}
    # program: one comparison flipped
    prog = list(q6.program)
    i = next(k for k, ins in enumerate(prog) if ins[0] == port.fused.OP_LT_I)
    prog[i] = (port.fused.OP_LE_I,) + tuple(prog[i][1:])
    keys.add(fc.cache_key(dataclasses.replace(q6, program=tuple(prog))))
    # dtypes: the date column read as int64
    table = tuple((w, c, 1 if code == 0 else code) for w, c, code in q6.table)
    keys.add(fc.cache_key(dataclasses.replace(q6, table=table)))
    # D
    keys.add(fc.cache_key(dataclasses.replace(q1, domain=12)))
    # the target architecture is compiled in too
    monkeypatch.setattr(nvrtc, "ARCH", "sm_100a")
    keys.add(fc.cache_key(q1))
    assert len(keys) == 6
    # and the cubin on disk is named by the compiler's version as well
    assert fc.cubin_stem("k", "12.8") != fc.cubin_stem("k", "12.9")


def test_recipe_past_the_limits_raises_a_named_error(sides):
    import dataclasses

    from trino_tpu_torch.ops.cuda import fused_codegen as fc

    port, _ = sides
    q1 = _recipe(port, "q1")
    for bad, what in (
        (dataclasses.replace(q1, domain=1024), "key domain"),
        (dataclasses.replace(q1, streams=q1.streams * 9), "streams"),
        (dataclasses.replace(q1, program=q1.program * 11), "instructions"),
        (dataclasses.replace(q1, n_regs=33), "registers"),
        (dataclasses.replace(q1, program=q1.program + ((99, 0, 0, 0, 0),)), "opcode"),
    ):
        with pytest.raises(fc.FusedCodegenError, match=what):
            fc.generate(bad)


def test_run_on_cpu_is_the_plain_version(sides):
    port, _ = sides
    for name in _OK:
        recipe = _recipe(port, name)
        live = torch.from_numpy(port.live)
        before = port.fused.launches()
        got = port.fused.run(recipe, port.cols, live)
        assert port.fused.launches() == before
        assert torch.equal(got, port.fused.run_plain(recipe, port.cols, live))


def _warp_case(port, name):
    """Columns, recipe and live mask of one warp-level card case."""
    rng = np.random.default_rng(29)
    n = 4096
    T = port.T
    d18, d38_2, d38_4 = T.DecimalType(18, 2), T.DecimalType(38, 2), T.DecimalType(38, 4)
    vals = rng.integers(-10**15, 10**15, size=n).astype(np.int64)
    if name == "carries":
        vals = np.where(np.arange(n) % 2 == 0, 2**63 - 1, -(2**63)).astype(np.int64)
    codes = {
        "all_dead_warps": [rng.integers(0, 6, n)], "single_live_lane": [rng.integers(0, 6, n)],
        "one_group": [np.zeros(n, np.int64)], "distinct_codes": [np.arange(n) % 32],
        "d512": [np.arange(n) % 32, (np.arange(n) // 32) % 16], "carries": [np.zeros(n, np.int64)],
    }[name]
    domains = {"distinct_codes": [32], "d512": [32, 16]}.get(name, [6])
    from trino_tpu_torch.data.page import Dictionary

    cols = [port.expr.ColumnVal(torch.from_numpy(vals), None, None, d18)]
    for c, k in zip(codes, domains):
        cols.append(port.expr.ColumnVal(
            torch.from_numpy(c.astype(np.int32)), None,
            Dictionary(np.asarray([f"v{i}" for i in range(k)], dtype=object)), None))
    A = port.ir.FieldRef(0, d18)
    recipe, why = port.fused.plan_pipeline(
        cols, [], [port.ir.FieldRef(i + 1, None) for i in range(len(codes))],
        ["sum", "sum", "count_star", "sum"],
        [A, port.c("mul", d38_4, A, A), None, port.c("cast", T.DOUBLE, A)],
        [d38_2, d38_4, T.BIGINT, T.DOUBLE])
    assert recipe is not None, why
    live = None
    if name == "all_dead_warps":
        live = torch.from_numpy((np.arange(n) // 32) % 3 == 0)
    elif name == "single_live_lane":
        live = torch.zeros(n, dtype=torch.bool)
        live[37] = True
    return recipe, cols, live


_WARP_CASES = ["all_dead_warps", "single_live_lane", "one_group", "distinct_codes", "d512", "carries"]


@pytest.mark.parametrize("name", _WARP_CASES)
def test_warp_cases_plain_version(name, sides):
    """The card cases' inputs on the CPU: the plain version's totals agree
    with python's exact sums (and so fix what the card must produce)."""
    port, _ = sides
    recipe, cols, live = _warp_case(port, name)
    totals = port.fused.run(recipe, cols, live)
    vals = cols[0].data.numpy().astype(object)
    lv = np.ones(len(vals), bool) if live is None else live.numpy()
    code = np.zeros(len(vals), np.int64)
    for ci, d, stride in recipe.keys:
        code += cols[ci].data.numpy().astype(np.int64) * stride
    for si, (tag, _) in enumerate(recipe.streams):
        if tag != "isum":
            continue
        for g in range(recipe.domain):
            sel = lv & (code == g)
            lo, hi = int(totals[si, 0, g]), int(totals[si, 1, g])
            got = ((hi % (1 << 64)) << 64) | (lo % (1 << 64))
            first = si == next(i for i, (t, _) in enumerate(recipe.streams) if t == "isum")
            want = sum(v if first else v * v for v in vals[sel]) % (1 << 128)
            assert got == want, (name, si, g)


@pytest.mark.cuda
@pytest.mark.parametrize("name", _WARP_CASES)
def test_generated_kernel_matches_plain_version_on_the_card(name, sides):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and NVRTC (run chip_smoke.py on the card)")
    port, _ = sides
    recipe, cols, live = _warp_case(port, name)
    dev = torch.device("cuda")
    cols = [port.expr.ColumnVal(c.data.to(dev), None, c.dict, c.type) for c in cols]
    live = None if live is None else live.to(dev)
    got = port.fused.run(recipe, cols, live)
    want = port.fused.run_plain(recipe, cols, live)
    for si, (tag, _) in enumerate(recipe.streams):
        if tag == "fsum":  # atomic order: 2 n 2^-53 of sum |x| over the summed doubles
            g, w = got[si, 0].view(torch.float64), want[si, 0].view(torch.float64)
            x = cols[0].data.double() / 10 ** cols[0].type.scale  # the stream: cast(A, DOUBLE)
            if live is not None:
                x = x[live]
            tol = 2 * x.numel() * 2.0**-53 * float(x.abs().sum())
            assert float((g - w).abs().max()) <= tol
        else:
            assert torch.equal(got[si], want[si]), (name, tag)


@pytest.mark.parametrize("scale", range(0, 9))
def test_division_free_cast_is_correctly_rounded(scale):
    """The generated kernel casts a decimal to double as RN(x / 10^s) without
    a division (csrc/fused_pipeline.cuh `div_by`): q = RN(x y) with y =
    RN(1 / d), r = x - q d exactly (one FMA), result RN(q + r y) (one FMA).
    The same steps in exact rational arithmetic give the correctly rounded
    quotient — the plain version's `x / d` — on integers and on doubles of
    every magnitude."""
    from fractions import Fraction

    from trino_tpu_torch.ops.cuda import fused_codegen as fc

    d = 10.0 ** scale
    y = float(Fraction(1) / Fraction(d))
    rng = np.random.default_rng(100 + scale)
    ints = rng.integers(-(2**53), 2**53, 1500).astype(np.float64)
    small = rng.integers(-10**7, 10**7, 1500).astype(np.float64)
    bits = rng.integers(0, 0x7FE0000000000000, 1000, dtype=np.int64)
    anything = bits.view(np.float64) * np.where(rng.random(1000) < 0.5, -1.0, 1.0)
    anything = anything[(np.abs(anything) > 1e-290) & (np.abs(anything) < 1e290)]
    for x in np.concatenate([ints, small, anything]).tolist():
        q = x * y
        r = Fraction(x) - Fraction(q) * Fraction(d)
        assert float(r) == r  # the residual is exact under one FMA
        assert float(r * Fraction(y) + Fraction(q)) == x / d, (scale, x)
    words = fc.constants(_recipe_with_cast(scale))
    assert struct.unpack("<d", struct.pack("<Q", words[-1]))[0] == y


def _recipe_with_cast(scale):
    """A recipe whose only constant is a decimal(18, scale) -> double cast."""
    from trino_tpu_torch.data import types as T
    from trino_tpu_torch.ops import expr
    from trino_tpu_torch.ops.cuda import fused
    from trino_tpu_torch.plan import ir

    dec = T.DecimalType(18, scale)
    cols = [expr.ColumnVal(torch.arange(4, dtype=torch.int64), None, None, dec)]
    recipe, why = fused.plan_pipeline(
        cols, [], [], ["sum"], [ir.Call("cast", (ir.FieldRef(0, dec),), T.DOUBLE)], [T.DOUBLE])
    assert recipe is not None, why
    return recipe
