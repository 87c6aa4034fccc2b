"""Statements and tables of the distributed plane's test files
(tests/test_torch_exchange.py, tests/test_torch_distributed.py), importable
without JAX: chip_smoke.py runs them at SF 0.01 on the card and on the CPU,
each through `Engine(distributed=True)` over four workers.

The reference's own distributed cases are read from its test files as
literals (`reference_literal`), so they are neither copied nor imported."""

from __future__ import annotations

import ast
import importlib
from pathlib import Path

import numpy as np

_TESTS = Path(__file__).resolve().parent


def reference_literal(test_file: str, name: str):
    """The value of the top-level literal assignment `name` in
    tests/<test_file>.py, read without running the file."""
    tree = ast.parse((_TESTS / f"{test_file}.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == name for t in node.targets
        ):
            return ast.literal_eval(node.value)
    raise KeyError(f"{name} in tests/{test_file}.py")


def tpch_cases() -> dict:
    """name -> (sql over TPC-H, the sqlite oracle's sql): the reference's
    distributed cases over TPC-H and the `single` statement."""
    joins = reference_literal("test_joins", "QUERIES")
    setops = reference_literal("test_setops", "SETOP_QUERIES")
    windows = reference_literal("test_window", "WINDOW_QUERIES")
    rollup, rollup_oracle = reference_literal("test_grouping_sets", "CASES")["rollup"]
    cases = {f"joins_{n}": (joins[n], joins[n]) for n in ("full_many", "right_basic")}
    cases["grouping_sets_rollup"] = (rollup, rollup_oracle)
    cases.update({f"setops_{n}": (setops[n], setops[n])
                  for n in ("union_all", "union_distinct", "except")})
    cases.update({f"window_{n}": (windows[n], windows[n])
                  for n in ("whole_partition", "global_window")})
    cases["single_over_replicated"] = (SINGLE_SQL, SINGLE_SQL)
    cases["second_run_join"] = (SECOND_RUN_SQL, SECOND_RUN_SQL)
    return cases


# a `single` exchange over a replicated input: the global count of region,
# gathered to every task, is one row of the union
SINGLE_SQL = ("select count(*), sum(k) from (select n_nationkey as k from nation "
              "union all select count(*) as k from region)")
SECOND_RUN_SQL = ("select o_orderpriority, count(*) from orders join customer "
                  "on o_custkey = c_custkey group by o_orderpriority")

# memory-catalog statements: (setup, query, expected rows); the reference's
# test_agg_functions / test_nulls / test_arrays distributed cases
_NULLABLE = [(i % 3 if i % 4 else None, i) for i in range(40)]
MEMORY_CASES = {
    "new_aggs": (
        ["create table t (g bigint, x double)",
         "insert into t values (1, 1.0), (1, 2.0), (1, 3.0), (2, 10.0), "
         "(2, 20.0), (1, 4.0), (2, 30.0), (1, 5.0)"],
        "select g, stddev_pop(x), approx_percentile(x, 0.5), approx_distinct(x) "
        "from t group by g order by g",
        [(1, 2.0 ** 0.5, 3.0, 5), (2, (200.0 / 3.0) ** 0.5, 20.0, 3)]),
    # keyless raw-only aggregate gathers then aggregates once (nearest rank:
    # sorted [1,2,3,4,5,10,20,30], index round(0.5*7) == 4)
    "keyless_percentile": (
        [], "select approx_percentile(x, 0.5) from t", [(5.0,)]),
    "nullable_group_key": (
        ["create table nk (g bigint, v bigint)",
         "insert into nk values " + ", ".join(
             f"({'null' if g is None else g}, {v})" for g, v in _NULLABLE)],
        "select g, count(*) from nk group by g order by g nulls first",
        [(None, 10), (0, 10), (1, 10), (2, 10)]),
    "unnest_group_by": (
        ["create table un (k bigint, s varchar)",
         "insert into un values (1,'a,b'), (2,'b,c'), (3,'c,d'), (4,'d,e')"],
        "select part, count(*) as c from un, unnest(split(s, ',')) as u(part) "
        "group by part order by part",
        [("a", 1), ("b", 2), ("c", 2), ("d", 2), ("e", 1)]),
}

# a broadcast join, a partial / final aggregate around a repartition, a
# global count gathered and replicated, counted once through `single`, a
# final gather
EXPLAIN_SQL = (
    "select g, sum(v) as s from (select f.g, f.v from f join d on f.k = d.k) t group by g "
    "union all select -1, count(*) from d"
)


def explain_tables(pkg: str):
    """A memory connector of package `pkg` (trino_tpu or trino_tpu_torch)
    with fact f (k, g, v) of 300 seeded rows and dimension d (k, name)."""
    mem = importlib.import_module(f"{pkg}.connectors.memory")
    spi = importlib.import_module(f"{pkg}.connectors.spi")
    types = importlib.import_module(f"{pkg}.data.types")
    rng = np.random.default_rng(3)
    n = 300
    conn = mem.MemoryConnector()
    big = types.BIGINT
    conn.create_table("f", [spi.ColumnSchema("k", big), spi.ColumnSchema("g", big),
                            spi.ColumnSchema("v", big)])
    conn.insert("f", {"k": rng.integers(0, 12, n).astype(np.int64),
                      "g": rng.integers(0, 7, n).astype(np.int64),
                      "v": rng.integers(0, 100, n).astype(np.int64)})
    conn.create_table("d", [spi.ColumnSchema("k", big), spi.ColumnSchema("name", types.VARCHAR)])
    conn.insert("d", {"k": np.arange(10, dtype=np.int64),
                      "name": np.array([f"n{i % 4}" for i in range(10)], dtype=object)})
    return conn


def bucket_inserts() -> list[dict]:
    """Two seeded inserts into the bucketed table b (k, s, v; v with NULLs)."""
    rng = np.random.default_rng(21)
    out = []
    for n in (700, 300):
        k = rng.integers(0, 50, n).astype(np.int64)
        s = np.asarray([f"s{i}" for i in rng.integers(0, 9, n)], dtype=object)
        v = np.ma.MaskedArray(rng.integers(0, 100, n).astype(np.int64), mask=rng.random(n) < 0.1)
        out.append({"k": k, "s": s, "v": v})
    return out


def bucketed_tables(pkg: str, inserts: list[dict]):
    """A memory connector of package `pkg` with table b (k bigint, s
    varchar, v bigint) bucketed by (k, s) in 4 buckets after `inserts`, and
    an unbucketed table d (k, w)."""
    mem = importlib.import_module(f"{pkg}.connectors.memory")
    spi = importlib.import_module(f"{pkg}.connectors.spi")
    types = importlib.import_module(f"{pkg}.data.types")
    conn = mem.MemoryConnector()
    cs = spi.ColumnSchema
    conn.create_table("b", [cs("k", types.BIGINT), cs("s", types.VARCHAR), cs("v", types.BIGINT)],
                      bucketed_by=["k", "s"], bucket_count=4)
    conn.create_table("d", [cs("k", types.BIGINT), cs("w", types.BIGINT)])
    for batch in inserts:
        conn.insert("b", dict(batch))
    conn.insert("d", {"k": np.arange(50, dtype=np.int64), "w": np.arange(50, dtype=np.int64) * 3})
    return conn


BUCKET_GROUP_BY = "select k, s, sum(v), count(*) from b group by k, s"
BUCKET_JOIN = ("select b.k, b.s, sum(b.v) as t, count(*) as c from b join "
               "(select k, s, max(v) as m from b group by k, s) x on b.k = x.k and b.s = x.s "
               "where b.v <= x.m group by b.k, b.s")
