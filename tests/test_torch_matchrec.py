"""MATCH_RECOGNIZE in the port: the cases of tests/test_matchrec.py on
`Engine(device="cpu")`, held on their hand-derived values (sqlite has no
MATCH_RECOGNIZE) and against the reference's engine over the same memory
tables.  The sort, the partition runs, PREV / NEXT and the DEFINE masks run
as tensor ops; the pattern walk is the host VM (ops/matchrec.py)."""

import pytest
try:  # arrow before torch: loaded after it, arrow's parquet writer crashes the process
    import pyarrow  # noqa: F401
except ImportError:
    pass
import torch

torch.set_num_threads(1)

_SETUP = (
    "create table ticks (sym varchar, ts bigint, price double)",
    "insert into ticks values "
    "('a',1,10.0),('a',2,8.0),('a',3,7.0),('a',4,9.0),('a',5,12.0),"
    "('b',1,5.0),('b',2,6.0),('b',3,4.0),('b',4,3.0),('b',5,7.0)",
    "create table seq (ts bigint, x bigint)",
    "insert into seq values (1,1),(2,2),(3,3),(4,4),(5,5)",
    "create table alt_t (ts bigint, x bigint)",
    "insert into alt_t values (1,5),(2,20)",
    "create table po (ts bigint, price double)",
    "insert into po values (1,1.0),(2,2.0),(3,5.0),(4,1.0)",
    "create table nx (ts bigint, price double)",
    "insert into nx values (1,3.0),(2,5.0),(3,2.0),(4,4.0)",
    "create table pi (p varchar, ts bigint, x bigint)",
    "insert into pi values ('p1',1,1),('p2',1,1)",
    "create table oq (ts bigint, x bigint)",
    "insert into oq values (1,1),(2,3),(3,1),(4,2),(5,3)",
    "create table mn (p varchar, ts bigint, x bigint)",
    "insert into mn values ('p1',1,1),('p1',2,1),('p2',1,1),('p2',2,1)",
    "create table npk (p bigint, ts bigint, x bigint)",
    "insert into npk values (null,1,1),(null,2,1),(1,1,1),(1,2,1)",
    "create table nv2 (ts bigint, x double)",
    "insert into nv2 values (1,1.0),(2,2.0),(3,4.0),(4,5.0)",
)

_V = ("partition by sym order by ts {measures} {rows} {skip} pattern (down+ up+) "
      "define down as price < prev(price), up as price > prev(price)")


def _mr(table: str, body: str, select: str = "*", where: str = "") -> str:
    return f"select {select} from {table} match_recognize ({body}){where}"


# (sql, the reference test's expected rows)
CASES = {
    "v_shape_one_row_per_match": (_mr("ticks", _V.format(
        measures="measures match_number() as mno, classifier() as cls, "
                 "first(down.ts) as start_ts, last(up.ts) as end_ts",
        rows="one row per match", skip="after match skip past last row")),
        [("a", 1, "UP", 2, 5), ("b", 1, "UP", 3, 5)]),
    "all_rows_per_match_running_classifier": (_mr("ticks", _V.format(
        measures="measures classifier() as cls, match_number() as mno",
        rows="all rows per match", skip=""), "sym, ts, cls, mno", " where sym = 'b'"),
        [("b", 3, "DOWN", 1), ("b", 4, "DOWN", 1), ("b", 5, "UP", 1)]),
    "greedy_plus_takes_longest": (_mr(
        "seq", "order by ts measures last(b.ts) as b_at one row per match "
        "pattern (a+ b) define b as x >= 3"), [(5,)]),
    "reluctant_plus_takes_shortest": (_mr(
        "seq", "order by ts measures last(b.ts) as b_at one row per match "
        "pattern (a+? b) define b as x >= 3"), [(3,), (5,)]),
    "bounded_repetition": (_mr(
        "seq", "order by ts measures first(a.ts) as f, last(a.ts) as l one row per match "
        "after match skip past last row pattern (a{2,3}) define a as x < 10"),
        [(1, 3), (4, 5)]),
    "alternation_prefers_left": (_mr(
        "alt_t", "order by ts measures first(a.ts) as ats, classifier() as cls "
        "one row per match pattern (a | b) define a as x > 10, b as x > 0"),
        [(None, "B"), (2, "A")]),
    "after_match_skip_past_last_row": (_mr(
        "seq", "order by ts measures first(a.ts) as f, last(a.ts) as l one row per match "
        "after match skip past last row pattern (a a) define a as x <= 4"),
        [(1, 2), (3, 4)]),
    "after_match_skip_to_next_row": (_mr(
        "seq", "order by ts measures first(a.ts) as f, last(a.ts) as l one row per match "
        "after match skip to next row pattern (a a) define a as x <= 4"),
        [(1, 2), (2, 3), (3, 4)]),
    "prev_with_offset": (_mr(
        "po", "order by ts measures first(a.ts) as at one row per match "
        "pattern (a) define a as price > prev(price, 2)"), [(3,)]),
    "next_navigation": (_mr(
        "nx", "order by ts measures first(a.ts) as at one row per match "
        "after match skip past last row pattern (a) define a as price < next(price)"),
        [(1,), (3,)]),
    "pattern_cannot_cross_partitions": (_mr(
        "pi", "partition by p order by ts measures first(a.ts) as f one row per match "
        "pattern (a a) define a as x = 1"), []),
    "optional_quantifier": (_mr(
        "oq", "order by ts measures first(a.ts) as f, last(c.ts) as l one row per match "
        "after match skip past last row pattern (a b? c) "
        "define a as x = 1, b as x = 2, c as x = 3"), [(1, 2), (3, 5)]),
    "measure_arithmetic_over_primitives": (_mr("ticks", _V.format(
        measures="measures last(up.price) - first(down.price) as delta",
        rows="one row per match", skip=""), "sym, delta"), [("a", 4.0), ("b", 3.0)]),
    "match_number_counts_per_partition": (_mr(
        "mn", "partition by p order by ts measures match_number() as mno, first(a.ts) as f "
        "one row per match after match skip past last row pattern (a) define a as x = 1"),
        [("p1", 1, 1), ("p1", 2, 2), ("p2", 1, 1), ("p2", 2, 2)]),
    "star_quantifier_and_undefined_label": (_mr(
        "seq", "order by ts measures first(a.ts) as f, last(b.ts) as l one row per match "
        "pattern (a b*) define a as x = 1"), [(1, 5)]),
    "match_recognize_as_subquery_input": (
        "select count(*), max(end_ts) from (" + _mr("ticks", _V.format(
            measures="measures last(up.ts) as end_ts", rows="one row per match",
            skip="")) + ")", [(2, 5)]),
    # an input with no rows: no match, one dead output lane
    "no_rows_one_row_per_match": (_mr(
        "(select * from seq where x > 100)",
        "order by ts measures first(a.ts) as f, match_number() as mno, classifier() as c "
        "one row per match pattern (a+) define a as x > 0"), []),
    "no_rows_all_rows_per_match": (_mr(
        "(select * from ticks where price > 100)",
        "partition by sym order by ts measures last(a.ts) as l all rows per match "
        "pattern (a) define a as price > 0"), []),
    "nested_prev_navigation": (_mr(
        "nv2", "order by ts measures first(a.ts) as at one row per match "
        "after match skip past last row pattern (a) "
        "define a as x - prev(x) > prev(x - prev(x))"), [(3,)]),
}


@pytest.fixture(autouse=True)
def _restore_kernel_policy():
    from trino_tpu_torch.ops import kernels

    saved = kernels.get_policy()
    yield
    kernels.set_policy(saved)


def port_engine(device):
    """The port's engine on `device` over a memory catalog holding the
    tables."""
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.runtime.engine import Engine

    eng = Engine(default_catalog="memory", device=device)
    eng.register_catalog("memory", MemoryConnector())
    for sql in _SETUP:
        eng.execute(sql)
    return eng


@pytest.fixture(scope="module")
def engines():
    from trino_tpu.connectors.memory import MemoryConnector as RefMemory
    from trino_tpu.runtime.engine import Engine as RefEngine
    from trino_tpu_torch.ops import kernels

    saved = kernels.get_policy()
    port = port_engine("cpu")
    ref = RefEngine(default_catalog="memory")
    ref.register_catalog("memory", RefMemory())
    for sql in _SETUP:
        ref.execute(sql)
    kernels.set_policy(saved)
    return port, ref


@pytest.mark.parametrize("name", sorted(CASES))
def test_match_recognize_equals_expected_and_reference(name, engines):
    port, ref = engines
    sql, want = CASES[name]
    got = port.query(sql)
    assert got == want, f"{name}: port {got}"
    assert got == ref.query(sql), f"{name}: port differs from the reference"


def test_null_partition_keys_group_together(engines):
    """NULL partition-key rows form ONE partition (what lies under the
    validity mask must not split the run)."""
    port, ref = engines
    sql = _mr("npk", "partition by p order by ts measures first(a.ts) as f, last(a.ts) as l "
                     "one row per match after match skip past last row pattern (a a) "
                     "define a as x = 1")
    got = sorted(port.query(sql), key=lambda r: (r[0] is None, r))
    assert got == [(1, 1, 2), (None, 1, 2)]
    assert got == sorted(ref.query(sql), key=lambda r: (r[0] is None, r))


def test_find_matches_walks_partitions_on_the_host():
    """The VM over hand-made masks: two partitions, greedy a+ then b (a+
    takes row 5 too, since b can still match row 6)."""
    import numpy as np

    from trino_tpu.ops.matchrec import find_matches as ref_find
    from trino_tpu_torch.ops.matchrec import find_matches
    from trino_tpu_torch.ops.matchrec import compile_pattern
    from trino_tpu_torch.sql.ast import PatConcat, PatLabel, PatQuant

    program, labels = compile_pattern(
        PatConcat((PatQuant(PatLabel("a"), 1, None, True), PatLabel("b"))))
    masks = np.asarray([[1, 1, 0, 1, 1, 1, 0], [0, 1, 1, 0, 1, 1, 1]], dtype=bool)
    part = np.asarray([0, 0, 0, 3, 3, 3, 3])
    for skip in ("past_last", "next_row"):
        got = find_matches(program, masks, part, skip)
        assert got == ref_find(program, masks, part, skip)
    assert find_matches(program, masks, part, "past_last") == [
        (1, [(0, 0), (1, 0), (2, 1)]), (1, [(3, 0), (4, 0), (5, 0), (6, 1)])]
