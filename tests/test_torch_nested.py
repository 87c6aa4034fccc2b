"""JSON, maps, rows, the pair tables of map() / zip_with, the sequence()
table function and `unnest_expand` in the port, each held against the
reference: statements through both packages' engines (the JSON cases and
test_table_function_sequence of tests/test_functions.py keep their
expected values), and `unnest_expand` called directly on the same
numpy-made inputs as the reference's."""

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


def _nested_tables(conn, schema, T) -> None:
    """`nt`: a MAP, a ROW and two varchar columns whose splits pair up (some
    of unequal length, some NULL), the same in both packages."""
    maps = np.empty(4, dtype=object)
    maps[:] = [{"a": 1, "b": 2}, {}, {"b": 7}, {"a": 1, "b": 2}]
    rows = np.empty(4, dtype=object)
    rows[:] = [(1, "x"), (2, "y"), (1, "x"), (3, None)]
    conn.create_table("nt", [
        schema("k", T.BIGINT), schema("m", T.MapType(T.VARCHAR, T.BIGINT)),
        schema("r", T.RowType((("a", T.BIGINT), ("b", T.VARCHAR)))),
        schema("ks", T.VARCHAR), schema("vs", T.VARCHAR),
    ])
    conn.insert("nt", {
        "k": np.arange(4, dtype=np.int64), "m": maps, "r": rows,
        "ks": np.ma.MaskedArray(np.asarray(["a,b", "c", "a,b", "x,y,z"], dtype=object),
                                mask=[False, False, False, True]),
        "vs": np.asarray(["1,2", "3,4", "5,6", "7"], dtype=object),
    })


def port_engine(device):
    """The port's engine on `device`: TPC-H SF 0.01 as `tpch` (the default)
    and a memory catalog `mem` holding `nt`."""
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.connectors.spi import ColumnSchema
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.data import types as PT
    from trino_tpu_torch.runtime.engine import Engine

    eng = Engine(device=device)
    eng.register_catalog("tpch", TpchConnector(0.01))
    mem = MemoryConnector()
    _nested_tables(mem, ColumnSchema, PT)
    eng.register_catalog("mem", mem)
    return eng


@pytest.fixture(scope="module")
def engines(tpch_tiny):
    """(port, reference) engines over the same catalogs."""
    from trino_tpu.connectors.memory import MemoryConnector as RefMemory
    from trino_tpu.connectors.spi import ColumnSchema as RefSchema
    from trino_tpu.connectors.tpch import TpchConnector as RefTpch
    from trino_tpu.data import types as RT
    from trino_tpu.runtime.engine import Engine as RefEngine
    from trino_tpu_torch.ops import kernels

    saved = kernels.get_policy()
    port, ref = port_engine("cpu"), RefEngine()
    ref.register_catalog("tpch", RefTpch(0.01))
    mem = RefMemory()
    _nested_tables(mem, RefSchema, RT)
    ref.register_catalog("mem", mem)
    kernels.set_policy(saved)
    return port, ref


_DOC = "(select '{\"a\": \"x\", \"b\": [10, 20, 30]}' as j from nation limit 1)"

# (sql, expected rows or None): JSON from tests/test_functions.py, then maps,
# rows and the pair tables over columns
CASES = {
    "json_functions": (
        "select json_extract_scalar(j, '$.a'), json_extract_scalar(j, '$.b[1]'),"
        " json_extract(j, '$.b'), json_array_length(j),"
        " json_array_length(json_extract(j, '$.b')), json_size(j, '$') from " + _DOC,
        [("x", "20", "[10,20,30]", None, 3, 2)]),
    "json_malformed_is_null": (
        "select json_extract_scalar(j, '$.a') from (select 'not json' as j from nation limit 1)",
        [(None,)]),
    "json_over_a_column": (
        "select n_name, json_extract_scalar(n_comment, '$'), json_size(n_comment, '$') "
        "from nation order by n_name", None),
    "map_functions": (
        "select k, cardinality(m), element_at(m, 'a'), m['b'], map_keys(m), map_values(m) "
        "from mem.nt order by k",
        [(0, 2, 1, 2, ["a", "b"], [1, 2]), (1, 0, None, None, [], []),
         (2, 1, None, 7, ["b"], [7]), (3, 2, 1, 2, ["a", "b"], [1, 2])]),
    "map_hofs_over_a_column": (
        "select k, transform_values(m, (x, v) -> v * 10), map_filter(m, (x, v) -> v > 1), "
        "transform_keys(m, (x, v) -> upper(x)) from mem.nt order by k", None),
    "row_field": (
        "select k, r.a, r.b from mem.nt order by k",
        [(0, 1, "x"), (1, 2, "y"), (2, 1, "x"), (3, 3, None)]),
    "map_construct_over_columns": (
        "select k, map(split(ks, ','), split(vs, ',')) from mem.nt order by k",
        [(0, {"a": "1", "b": "2"}), (1, None), (2, {"a": "5", "b": "6"}), (3, None)]),
    "zip_with_over_columns": (
        "select k, zip_with(split(ks, ','), split(vs, ','), (x, y) -> concat(x, y)) "
        "from mem.nt order by k",
        [(0, ["a1", "b2"]), (1, ["c3", None]), (2, ["a5", "b6"]), (3, None)]),
    "zip_with_over_tpch": (
        "select n_nationkey, zip_with(split(n_name, ' '), split(r_name, ' '), "
        "(x, y) -> coalesce(x, '') || '/' || coalesce(y, '')) "
        "from nation join region on n_regionkey = r_regionkey order by n_nationkey", None),
    "unnest_over_tpch_with_ordinality": (
        "select n_nationkey, w, o from nation cross join unnest(split(n_comment, ' ')) "
        "with ordinality as t(w, o) where o <= 3 order by n_nationkey, o", None),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_nested_statement_equals_reference(name, engines):
    port, ref = engines
    sql, want = CASES[name]
    got = port.query(sql)
    if want is not None:
        assert got == want, f"{name}: port {got}"
    assert got == ref.query(sql), f"{name}: port differs from the reference"
    if name == "unnest_over_tpch_with_ordinality":
        assert len(got) == 75


def test_json_path_strictness(engines):
    # unsupported JSONPath syntax is an error, not a silent prefix match
    for eng in engines:
        with pytest.raises(Exception, match="JSON path"):
            eng.query("select json_extract(j, '$.b[*]') from"
                      " (select '{}' as j from nation limit 1)")


@pytest.mark.parametrize("sql,want", [
    ("SELECT sum(sequential_number) AS s FROM TABLE(sequence(1, 100))", [(5050,)]),
    ("SELECT count(*) FROM TABLE(sequence(start => 0, stop => 20, step => 5))", [(5,)]),
    ("SELECT count(*) FROM TABLE(sequence(1, 10)) a"
     " JOIN TABLE(sequence(1, 20)) b ON a.sequential_number = b.sequential_number", [(10,)]),
], ids=["sum", "named_arguments", "join"])
def test_table_function_sequence(sql, want, engines):
    """FROM TABLE(sequence(...)) plans to Unnest over one interned array."""
    port, ref = engines
    got = port.query(sql)
    assert got == want
    assert got == ref.query(sql)


def test_pair_table_holds_only_occurring_pairs():
    """map() over two columns builds its table over the code pairs that
    occur, not over every pair of the two dictionaries."""
    from trino_tpu_torch.data.page import Column
    from trino_tpu_torch.data.types import ArrayType, BIGINT, MapType
    from trino_tpu_torch.ops import expr
    from trino_tpu_torch.plan.ir import Call, FieldRef

    n = 1000
    ka = np.empty(n, dtype=object)
    va = np.empty(n, dtype=object)
    ka[:] = [(i, i + 1) for i in range(n)]
    va[:] = [(-i, i * i) for i in range(n)]
    T = ArrayType(BIGINT)
    cols = [expr.column_val(Column.from_numpy(T, a, device="cpu")) for a in (ka, va)]
    e = Call("map_construct", (FieldRef(0, T), FieldRef(1, T)), MapType(BIGINT, BIGINT))
    out = expr.eval_expr(e, cols, n)
    assert len(out.dict) == n  # n occurring pairs of a 10^6-pair product
    got = [out.dict.values[c] for c in out.data.tolist()]
    assert got == [((i, -i), (i + 1, i * i)) for i in range(n)]


def _unnest_inputs():
    """k bigint; a array(bigint) with a NULL, an empty array and unequal
    lengths; b array(varchar); one dead row."""
    a = np.empty(6, dtype=object)
    a[:] = [(1, 2, 3), (), (4,), (5, 6), (7, None), (8,)]
    b = np.empty(6, dtype=object)
    b[:] = [("x",), ("y", "z"), (), ("u", "v", "w"), ("p",), ("q", "r")]
    return (np.arange(6, dtype=np.int64), a, b,
            np.asarray([1, 1, 0, 1, 1, 1], dtype=bool),  # a NULL at row 2
            np.asarray([1, 1, 1, 1, 1, 0], dtype=bool))  # row 5 dead


def _decode(cv, live, n):
    data = np.asarray(cv.data)[:n]
    valid = np.ones(n, bool) if cv.valid is None else np.asarray(cv.valid)[:n]
    out = []
    for i in range(n):
        if not live[i]:
            continue
        v = data[i].item()
        out.append(None if not valid[i] else (cv.dict.values[v] if cv.dict is not None else v))
    return out


@pytest.mark.parametrize("arrays,ordinality,outer,C", [
    ((1,), False, False, 32), ((1, 2), False, False, 32), ((1, 2), True, False, 32),
    ((1,), True, True, 32), ((1, 2), True, True, 32), ((2,), False, True, 32),
    ((1, 2), True, True, 4),
], ids=["one", "zipped", "zipped_ordinality", "outer_ordinality", "zipped_outer",
        "strings_outer", "capacity_below_true_size"])
def test_unnest_expand_equals_reference(arrays, ordinality, outer, C):
    import jax.numpy as jnp

    from trino_tpu.data import types as RT
    from trino_tpu.data.page import Column as RefColumn
    from trino_tpu.ops import expr as ref_expr
    from trino_tpu.ops.relops import unnest_expand as ref_unnest
    from trino_tpu_torch.data import types as PT
    from trino_tpu_torch.data.page import Column
    from trino_tpu_torch.ops import expr
    from trino_tpu_torch.ops.relops import unnest_expand

    k, a, b, a_valid, live = _unnest_inputs()
    data = {1: a, 2: b}
    valids = {1: a_valid, 2: None}

    def columns(ColumnCls, column_val, T, **kw):
        base = [column_val(ColumnCls.from_numpy(T.BIGINT, k, **kw))]
        arrs = [column_val(ColumnCls.from_numpy(
            T.ArrayType(T.BIGINT if i == 1 else T.VARCHAR), data[i], valids[i], **kw))
            for i in arrays]
        ets = [T.BIGINT if i == 1 else T.VARCHAR for i in arrays]
        return base, arrs, ets

    pb, pa, pet = columns(Column, expr.column_val, PT, device="cpu")
    rb, ra, ret = columns(RefColumn, ref_expr.column_val, RT)
    pcols, plive, ptotal = unnest_expand(pb, torch.from_numpy(live), pa, pet, ordinality, outer, C)
    rcols, rlive, rtotal = ref_unnest(rb, jnp.asarray(live), ra, ret, ordinality, outer, C)
    assert int(ptotal) == int(rtotal)
    if C == 4:
        assert int(ptotal) > C  # the capacity pass re-runs at the reported size
    assert np.array_equal(plive.numpy(), np.asarray(rlive))
    assert len(pcols) == len(rcols) == 1 + len(arrays) + int(ordinality)
    out_live = plive.numpy()
    for pc, rc in zip(pcols, rcols):
        assert _decode(pc, out_live, C) == _decode(rc, out_live, C)
