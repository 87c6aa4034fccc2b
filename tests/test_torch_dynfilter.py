"""The port's dynamic filters (exec/dynfilter.py, LocalExecutor.scan_filters)
against the JAX package's: the filters collected from a fragmented
broadcast join and from a string-keyed star join equal the reference's,
scan pruning keeps results and counts the rows it dropped as the reference
does, and an out-of-core join whose build side narrows its probe scan
equals the reference engine's run: rows, parts, spill files and pruned
rows."""

import numpy as np
import pytest
try:  # arrow before torch: loaded after it, arrow's parquet writer crashes the process
    import pyarrow  # noqa: F401
except ImportError:
    pass
import torch

from tests.oracle import assert_rows_equal

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _restore_kernel_policy():
    from trino_tpu_torch.ops import kernels

    saved = kernels.get_policy()
    yield
    kernels.set_policy(saved)


def _pkg(name: str):
    """The modules one package needs here, by short name."""
    import importlib

    root = "trino_tpu_torch" if name == "port" else "trino_tpu"
    mods = {}
    for short, path in (
        ("spi", "connectors.spi"), ("tpch", "connectors.tpch"), ("memory", "connectors.memory"),
        ("types", "data.types"), ("distribute", "plan.distribute"),
        ("fragmenter", "plan.fragmenter"), ("nodes", "plan.nodes"), ("planner", "plan.planner"),
        ("session", "runtime.session"), ("wire", "runtime.wire"),
        ("compiler", "exec.compiler"), ("dynfilter", "exec.dynfilter"),
    ):
        mods[short] = importlib.import_module(f"{root}.{path}")
    return mods


def _executor(m, pkg, catalogs, default):
    if pkg == "port":
        return m["compiler"].LocalExecutor(catalogs, default, device="cpu")
    return m["compiler"].LocalExecutor(catalogs, default)


def _from_wire(m, pkg, blobs, types):
    if pkg == "port":
        return m["wire"].wire_to_page(blobs, types, device="cpu")
    return m["wire"].wire_to_page(blobs, types)


def _broadcast_fragment(m, catalogs, default, sql):
    plan = m["planner"].Planner(catalogs, default).plan(sql)
    frags = m["fragmenter"].fragment_plan(
        m["distribute"].distribute(plan, catalogs, 2, m["session"].SessionProperties())
    )
    target = None
    for f in frags:
        def joins(n):
            out = [n] if isinstance(n, m["nodes"].Join) else []
            for c in n.children:
                out.extend(joins(c))
            return out

        for j in joins(f.root):
            if isinstance(j.right, m["nodes"].RemoteSource):
                target = (f, j)
    assert target is not None, "expected a broadcast join fragment"
    f, j = target
    build = next(fr for fr in frags if fr.id == j.right.fragment_id)
    return f, build


def _collect(pkg: str, sql: str):
    m = _pkg(pkg)
    catalogs = m["spi"].CatalogManager()
    catalogs.register("tpch", m["tpch"].TpchConnector(0.01))
    f, build = _broadcast_fragment(m, catalogs, "tpch", sql)
    page = _executor(m, pkg, catalogs, "tpch").execute(build.root)
    fetched = _from_wire(m, pkg, m["wire"].page_to_wire_chunks(page),
                         list(build.root.output_types))
    return m["dynfilter"].collect_dynamic_filters(f.root, {build.id: fetched})


def test_collect_from_fragmented_broadcast_join():
    """A broadcast join fragment (Join(scan…, RemoteSource)) yields a range
    filter on the probe scan column from the fetched build page — the
    reference's filter."""
    sql = ("select o_orderkey from orders, customer "
           "where o_custkey = c_custkey and c_acctbal > 9000")
    filters = _collect("port", sql)
    assert filters, "expected a dynamic filter on the probe scan"
    sf = next(iter(filters.values()))[0]
    assert sf.column == "o_custkey"
    assert sf.min <= sf.max
    want = _collect("ref", sql)
    assert {k: [(f.column, f.min, f.max, f.values) for f in v] for k, v in filters.items()} \
        == {k: [(f.column, f.min, f.max, f.values) for f in v] for k, v in want.items()}


def _pruned_run(pkg: str, sql: str, column: str, lo, hi):
    m = _pkg(pkg)
    if pkg == "port":
        from trino_tpu_torch.runtime.engine import Engine

        eng = Engine(device="cpu")
    else:
        from trino_tpu.runtime.engine import Engine

        eng = Engine()
    eng.register_catalog("tpch", m["tpch"].TpchConnector(0.01))
    plan = eng.plan(sql)
    scan_id = next(
        i for i, n in m["compiler"]._node_ids(plan).items() if isinstance(n, m["nodes"].TableScan)
    )
    eng.executor.scan_filters = {scan_id: (m["dynfilter"].ScanFilter(column, lo, hi),)}
    return eng.executor.execute(plan).to_pylist(), eng.executor.rows_pruned


def test_scan_pruning_counts_and_correctness():
    """Executor level: a range filter on the scan drops rows on the host,
    the result stays the unfiltered one, and the dropped rows are counted
    as the reference counts them."""
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.runtime.engine import Engine

    sql = "select count(*), sum(o_totalprice) from orders where o_custkey <= 50"
    eng = Engine(device="cpu")
    eng.register_catalog("tpch", TpchConnector(0.01))
    unfiltered = eng.query(sql)
    filtered, pruned = _pruned_run("port", sql, "o_custkey", 1, 50)
    assert filtered == unfiltered
    assert pruned > 0
    ref_rows, ref_pruned = _pruned_run("ref", sql, "o_custkey", 1, 50)
    assert pruned == ref_pruned
    assert_rows_equal(filtered, ref_rows)


def _star(pkg: str):
    m = _pkg(pkg)
    conn = m["memory"].MemoryConnector()
    names = np.asarray([f"day_{i:02d}" for i in range(20)], dtype=object)
    VARCHAR, BIGINT = m["types"].VARCHAR, m["types"].BIGINT
    ColumnSchema = m["spi"].ColumnSchema
    conn.create_table("fact", [ColumnSchema("f_day", VARCHAR), ColumnSchema("f_val", BIGINT)])
    rng = np.random.default_rng(3)
    conn.insert("fact", {"f_day": names[rng.integers(0, 20, 5000)],
                         "f_val": rng.integers(0, 100, 5000).astype(np.int64)})
    conn.create_table("dim", [ColumnSchema("d_day", VARCHAR), ColumnSchema("d_keep", BIGINT)])
    conn.insert("dim", {"d_day": names, "d_keep": (np.arange(20) < 2).astype(np.int64)})
    catalogs = m["spi"].CatalogManager()
    catalogs.register("mem", conn)
    sql = "select sum(f_val) from fact, dim where f_day = d_day and d_keep = 1"
    f, build = _broadcast_fragment(m, catalogs, "mem", sql)
    page = _executor(m, pkg, catalogs, "mem").execute(build.root)
    fetched = _from_wire(m, pkg, m["wire"].page_to_wire_chunks(page),
                         list(build.root.output_types))
    filters = m["dynfilter"].collect_dynamic_filters(f.root, {build.id: fetched})
    ex = _executor(m, pkg, catalogs, "mem")
    ex.scan_filters = filters
    rows = ex.execute(f.root, {build.id: fetched}).to_pylist()
    return conn, filters, rows, ex.rows_pruned


def test_string_dictionary_set_filter():
    """A star join keyed on a STRING: the build side's distinct dictionary
    values become a membership domain that prunes probe rows on the host
    (reference: DynamicFilterService discrete TupleDomain sets); the filter,
    the pruned count and the result equal the reference's."""
    conn, filters, rows, pruned = _star("port")
    assert filters, "expected a string dynamic filter"
    sf = next(iter(filters.values()))[0]
    assert sf.column == "f_day" and sf.values is not None
    assert set(sf.values) == {"day_00", "day_01"}
    assert pruned > 0, "string set domain never pruned"
    f_day = conn._data["fact"]["f_day"]
    f_val = conn._data["fact"]["f_val"]
    expect = int(f_val[np.isin(f_day, ["day_00", "day_01"])].sum())
    assert sum(r[0] for r in rows if r[0] is not None) == expect
    _, ref_filters, ref_rows, ref_pruned = _star("ref")
    assert [(f.column, f.values) for fs in filters.values() for f in fs] == \
        [(f.column, f.values) for fs in ref_filters.values() for f in fs]
    assert pruned == ref_pruned
    assert sorted(rows) == sorted(ref_rows)


NARROW_JOIN = ("select count(*), sum(l_extendedprice) from lineitem, part "
               "where l_partkey = p_partkey and p_partkey <= 200")


def test_out_of_core_join_prunes_its_probe_scan_as_the_reference(oracle):
    """The engine level: under a 400,000-byte budget the join runs out of
    core, the part scan's fragment is the build side, and the lineitem
    scan drops every row outside p_partkey's [min, max] before upload.
    Rows, part count, spill files and pruned rows equal the reference's."""
    from trino_tpu.connectors.tpch import TpchConnector as RefTpch
    from trino_tpu.runtime.engine import Engine as RefEngine
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.runtime.engine import Engine

    got = {}
    for name, eng in (("port", Engine(device="cpu")), ("ref", RefEngine())):
        eng.register_catalog("tpch", (TpchConnector if name == "port" else RefTpch)(0.01))
        eng.session.set("query_max_memory_bytes", "400000")
        rows = eng.query(NARROW_JOIN)
        s = eng.last_spill
        got[name] = (rows, s.parts, s.spill_files, s.rows_pruned)
    rows, parts, files, pruned = got["port"]
    assert (parts, files, pruned) == got["ref"][1:] == (8, 16, 53_779)
    assert_rows_equal(rows, got["ref"][0])
    assert_rows_equal(rows, oracle.query(NARROW_JOIN))
