"""ARRAY values and UNNEST in the port: the cases of tests/test_arrays.py on
`Engine(device="cpu")`, each statement also run through the reference's
engine over the same memory tables, the rows equal, and the reference test's
expected values checked.  Arrays are dictionary-coded tuples; UNNEST reads
their elements from a flat table on the device (ops/relops.py
unnest_expand)."""

import numpy as np
import pytest
try:  # arrow before torch: loaded after it, arrow's parquet writer crashes the process
    import pyarrow  # noqa: F401
except ImportError:
    pass
import torch

torch.set_num_threads(1)

# the tables each statement reads, created once in both engines
_SETUP = (
    "create table ts (k bigint, s varchar)",
    "insert into ts values (1,'a,b'), (2,'c'), (3,'')",
    "create table tl (k bigint, s varchar)",
    "insert into tl values (1,'a,b'), (2,'c')",
    "create table tf (k bigint, s varchar)",
    "insert into tf values (1,'a,b'), (2,'b,c')",
    "create table tn (k bigint, s varchar)",
    "insert into tn values (1,'a'), (2,'')",
    "create table tg (k bigint, s varchar)",
    "insert into tg values (1,'x,y,z'), (2,'x,y'), (3,'x')",
    "create table td (k bigint, s varchar)",
    "insert into td values (1,'a,b'), (2,'b,c'), (3,'c,d'), (4,'d,e')",
    "create table tk (k bigint)",
    "insert into tk values (1), (2), (3), (4)",
    "create table tc (k bigint)",
    "insert into tc values (1), (2), (5)",
    "create table so (k bigint)",
    "insert into so values (5)",
)


@pytest.fixture(autouse=True)
def _restore_kernel_policy():
    from trino_tpu_torch.ops import kernels

    saved = kernels.get_policy()
    yield
    kernels.set_policy(saved)


def load_tables(eng, schema, T) -> None:
    """The statements' tables, written into `eng`'s `memory` catalog (an
    engine of either package, with its ColumnSchema and types module)."""
    for sql in _SETUP:
        eng.execute(sql)
    vals = np.empty(3, dtype=object)
    vals[0], vals[1], vals[2] = (1, 2), (), (3, 4, 5)
    conn = eng.catalogs.get("memory")
    conn.create_table("arr_t", [schema("k", T.BIGINT), schema("v", T.ArrayType(T.BIGINT))])
    conn.insert("arr_t", {"k": np.asarray([1, 2, 3]), "v": vals})


def port_engine(device):
    """The port's engine on `device` over a memory catalog holding the
    tables."""
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.connectors.spi import ColumnSchema
    from trino_tpu_torch.data import types as PT
    from trino_tpu_torch.runtime.engine import Engine

    eng = Engine(default_catalog="memory", device=device)
    eng.register_catalog("memory", MemoryConnector())
    load_tables(eng, ColumnSchema, PT)
    return eng


@pytest.fixture(scope="module")
def engines():
    """(port, reference) engines over memory catalogs holding the same
    tables, among them `arr_t` with an ARRAY(BIGINT) column written through
    the connector."""
    from trino_tpu.connectors.memory import MemoryConnector as RefMemory
    from trino_tpu.connectors.spi import ColumnSchema as RefSchema
    from trino_tpu.data import types as RT
    from trino_tpu.runtime.engine import Engine as RefEngine
    from trino_tpu_torch.ops import kernels

    saved = kernels.get_policy()
    port = port_engine("cpu")
    ref = RefEngine(default_catalog="memory")
    ref.register_catalog("memory", RefMemory())
    load_tables(ref, RefSchema, RT)
    kernels.set_policy(saved)
    return port, ref


# (sql, the reference test's expected rows)
CASES = {
    "literal_functions": (
        "select cardinality(array[1,2,3]), element_at(array[10,20], 2), "
        "contains(array[1,2], 5), contains(array[1,2], 2)", [(3, 20, False, True)]),
    "subscript": ("select array[7,8,9][2]", [(8,)]),
    "element_at_out_of_bounds_is_null": ("select element_at(array[1,2], 5)", [(None,)]),
    "element_at_negative_index": ("select element_at(array[1,2,3], -1)", [(3,)]),
    "sequence": ("select sequence(2, 5)", [([2, 3, 4, 5],)]),
    "sequence_step": ("select sequence(5, 1, -2)", [([5, 3, 1],)]),
    "array_sort": ("select array_sort(array[3,1,2])", [([1, 2, 3],)]),
    "array_distinct": ("select array_distinct(array[1,2,1,3,2])", [([1, 2, 3],)]),
    "array_join": ("select array_join(array[1,2,3], '-')", [("1-2-3",)]),
    "array_min_max": ("select array_min(array[4,2,9]), array_max(array[4,2,9])", [(2, 9)]),
    "array_position": ("select array_position(array[5,6,7], 6)", [(2,)]),
    "split_cardinality": (
        "select k, cardinality(split(s, ',')) from ts order by k", [(1, 2), (2, 1), (3, 1)]),
    "split_subscript": (
        "select split(s, ',')[1] from ts order by k", [("a",), ("c",), ("",)]),
    "dynamic_element_at": (
        "select k, element_at(array[10,20,30], k) from tk order by k",
        [(1, 10), (2, 20), (3, 30), (4, None)]),
    "dynamic_contains": (
        "select k, contains(array[1,5], k) from tc order by k",
        [(1, True), (2, False), (5, True)]),
    "array_column_cardinality": (
        "select k, cardinality(v) from arr_t order by k", [(1, 2), (2, 0), (3, 3)]),
    "array_column_unnest": (
        "select k, x from arr_t cross join unnest(v) as u(x) order by k, x",
        [(1, 1), (1, 2), (3, 3), (3, 4), (3, 5)]),
    "array_column_values": (
        "select k, v from arr_t order by k", [(1, [1, 2]), (2, []), (3, [3, 4, 5])]),
    "unnest_standalone": ("select * from unnest(array[1,2,3])", [(1,), (2,), (3,)]),
    "unnest_with_ordinality": (
        "select x, o from unnest(sequence(5,7)) with ordinality as u(x, o)",
        [(5, 1), (6, 2), (7, 3)]),
    "unnest_lateral_split": (
        "select k, part from tl cross join unnest(split(s, ',')) as u(part) "
        "order by k, part", [(1, "a"), (1, "b"), (2, "c")]),
    "unnest_in_from_list": (
        "select k, part from tl, unnest(split(s, ',')) as u(part) order by k, part",
        [(1, "a"), (1, "b"), (2, "c")]),
    "unnest_filter_on_element": (
        "select k from tf, unnest(split(s, ',')) as u(part) where part = 'b' order by k",
        [(1,), (2,)]),
    "unnest_zip": (
        "select * from unnest(array[1,2,3], array[10,20])", [(1, 10), (2, 20), (3, None)]),
    "left_join_unnest_keeps_empty": (
        "select k, x from tn left join unnest(split(nullif(s,''), ',')) as u(x) "
        "on true order by k", [(1, "a"), (2, None)]),
    "unnest_aggregate": (
        "select part, count(*) as c from tg, unnest(split(s, ',')) as u(part) "
        "group by part order by part", [("x", 3), ("y", 2), ("z", 1)]),
    # tests/test_arrays.py runs this one distributed (ported in
    # tests/test_torch_distributed.py): here the same statement single-process
    "unnest_group_by_four_rows": (
        "select part, count(*) as c from td, unnest(split(s, ',')) as u(part) "
        "group by part order by part",
        [("a", 1), ("b", 2), ("c", 2), ("d", 2), ("e", 1)]),
    "unnest_select_star_order": ("select * from unnest(array[7]) as un(y), so", [(7, 5)]),
    "array_min_max_strings": (
        "select array_min(array['b','a']), array_max(array['b','a'])", [("a", "b")]),
    "array_null_elements": (
        "select array_min(array[3,null,1]), array_sort(array[3,null,1])",
        [(None, [1, 3, None])]),
    "outer_unnest_ordinality_null": (
        "select k, x, o from tn left join "
        "unnest(split(nullif(s,''), ',')) with ordinality as un(x, o) on true order by k",
        [(1, "a", 1), (2, None, None)]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_array_statement_equals_reference(name, engines):
    port, ref = engines
    sql, want = CASES[name]
    got = port.execute(sql)
    assert got == want, f"{name}: port {got}"
    assert got == ref.execute(sql), f"{name}: port differs from the reference"


def test_sequence_limit_is_cheap(engines):
    from trino_tpu.plan.planner import PlanningError as RefPlanningError
    from trino_tpu_torch.plan.planner import PlanningError

    port, ref = engines
    with pytest.raises(PlanningError, match="longer than"):
        port.execute("select sequence(1, 10000000000)")
    with pytest.raises(RefPlanningError, match="longer than"):
        ref.execute("select sequence(1, 10000000000)")


def test_array_columns_round_trip_through_a_page():
    """An ARRAY column written to the card and read back (tests/test_arrays.py
    sends it over the wire format; here through the page)."""
    from trino_tpu_torch.data.page import Column, Page
    from trino_tpu_torch.data.types import ArrayType, BIGINT

    vals = np.empty(3, dtype=object)
    vals[0], vals[1], vals[2] = (1, 2), (), (3,)
    col = Column.from_numpy(ArrayType(BIGINT), vals, device="cpu")
    assert Page((col,)).to_pylist() == [([1, 2],), ([],), ([3],)]
    assert len(col.dictionary) == 3 and col.data.dtype == torch.int32
