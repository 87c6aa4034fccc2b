"""The port's exchanges (trino_tpu_torch/parallel/exchange.py) against the
JAX package's collectives, and the distributed executor's contract
(exec/spmd.py): the placement of every live row after a repartition and a
gather equals JAX's `repartition` / `gather_all` under shard_map over the
first D virtual devices, D in {2, 3, 8}, on the same seeded shards (BIGINT,
DOUBLE, VARCHAR with two dictionaries, decimal128 with a high limb, NULL keys,
dead rows); an exchange reads nothing to the host but its count matrix;
EXPLAIN ANALYZE row counts equal the JAX SpmdExecutor's on a plan with a
repartition, a broadcast, a gather and a `single`; a `single` exchange over a
replicated input counts its rows once, distributed and out of core; a second
run of a query uploads nothing."""

import numpy as np
import pytest
try:  # arrow before torch: loaded after it, arrow's parquet writer crashes the process
    import pyarrow  # noqa: F401
except ImportError:
    pass
import torch

from tests.distributed_cases import EXPLAIN_SQL, SECOND_RUN_SQL, SINGLE_SQL, explain_tables
from tests.oracle import assert_rows_equal

torch.set_num_threads(1)

N = 48  # rows per shard
# repartition key sets, by column: bigint / (varchar, double) / decimal128
KEY_SETS = ((0,), (2, 1), (4,))
# (name, type) of the shard columns; column 2 is the VARCHAR key whose
# dictionary differs from shard to shard in the port's inputs
COLUMNS = (("b", "bigint"), ("x", "double"), ("s", "varchar"), ("t", "varchar"),
           ("m", "decimal(38,2)"))
WORDS = np.array(["ash", "birch", "cedar", "elm", "fir", "oak", "pine", "yew"], dtype=object)


@pytest.fixture(autouse=True)
def _restore_kernel_policy():
    from trino_tpu_torch.ops import kernels

    saved = kernels.get_policy()
    yield
    kernels.set_policy(saved)


def _shards(D: int, seed: int) -> list[dict]:
    """D shards of N rows: each column (data, valid or None, data2 or None)
    plus `live`.  Shard 1 is all dead, so a destination may get nothing from
    it."""
    rng = np.random.default_rng(seed)
    out = []
    for d in range(D):
        valid = lambda: rng.random(N) > 0.2  # noqa: E731
        lo = rng.integers(-(1 << 62), 1 << 62, N, dtype=np.int64)
        hi = np.where(rng.random(N) < 0.5, lo >> 63, rng.integers(-3, 4, N)).astype(np.int64)
        cols = [
            (rng.integers(0, 40, N).astype(np.int64), valid(), None),
            (rng.integers(-50, 50, N) / 4.0, None, None),
            (rng.integers(0, len(WORDS), N).astype(np.int32), valid(), None),
            (rng.integers(0, 3, N).astype(np.int32), None, None),
            (lo, valid(), hi),
        ]
        live = rng.random(N) > 0.25
        if d == 1:
            live[:] = False
        out.append({"cols": cols, "live": live})
    return out


def _decode(cols, dicts, live, types) -> list[tuple]:
    rows = []
    for r in np.nonzero(live)[0]:
        row = []
        for (data, valid, data2), dic, t in zip(cols, dicts, types):
            if valid is not None and not valid[r]:
                row.append(None)
            elif dic is not None:
                row.append(str(dic.values[int(data[r])]))
            elif data2 is not None:
                row.append((int(data2[r]) << 64) + (int(data[r]) & ((1 << 64) - 1)))
            else:
                row.append(float(data[r]) if t.is_floating else int(data[r]))
        rows.append(tuple(row))
    return rows


def _jax_exchanges(D: int, shards: list[dict]):
    """The JAX package's repartition over each key set and gather_all, in one
    shard_map program over the first D virtual devices.  Returns
    ([per key set: (rows per destination, required)], rows per destination
    of the gather)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    try:
        from jax import shard_map
    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map

    from trino_tpu.data.page import Dictionary
    from trino_tpu.data.types import parse_type
    from trino_tpu.ops.expr import ColumnVal
    from trino_tpu.parallel.exchange import AXIS, gather_all, repartition

    types = [parse_type(t) for _, t in COLUMNS]
    dicts = [None, None, Dictionary(WORDS), Dictionary(np.array(["p", "q", "r"], dtype=object)),
             None]
    arrs = {"live": jnp.asarray(np.concatenate([s["live"] for s in shards]))}
    for i in range(len(COLUMNS)):
        for j, tag in enumerate("dvh"):
            if shards[0]["cols"][i][j] is not None:
                arrs[f"{tag}{i}"] = jnp.asarray(np.concatenate([s["cols"][i][j] for s in shards]))

    def step(a):
        cols = [ColumnVal(a[f"d{i}"], a.get(f"v{i}"), dicts[i], types[i], a.get(f"h{i}"))
                for i in range(len(COLUMNS))]
        out = {}
        for k, ks in enumerate(KEY_SETS):
            oc, ol, req = repartition(cols, a["live"], [cols[i] for i in ks], D, N, AXIS)
            out[f"r{k}"] = ([(c.data, c.valid, c.data2) for c in oc], ol, req[None])
        gc, gl = gather_all(cols, a["live"], AXIS)
        out["g"] = ([(c.data, c.valid, c.data2) for c in gc], gl)
        return out

    try:
        fn = shard_map(step, mesh=Mesh(np.array(jax.devices()[:D]), (AXIS,)),
                       in_specs=(P(AXIS),), out_specs=P(AXIS), check_vma=False)
    except TypeError:  # pre-0.8 jax
        fn = shard_map(step, mesh=Mesh(np.array(jax.devices()[:D]), (AXIS,)),
                       in_specs=(P(AXIS),), out_specs=P(AXIS), check_rep=False)
    res = jax.device_get(jax.jit(fn)(arrs))

    def per_dest(cols, live):
        width = len(live) // D
        out = []
        for d in range(D):
            sl = slice(d * width, (d + 1) * width)
            dcols = [tuple(None if x is None else np.asarray(x)[sl] for x in c) for c in cols]
            out.append(_decode(dcols, dicts, np.asarray(live)[sl], types))
        return out

    reps = [(per_dest(*res[f"r{k}"][:2]), int(np.max(res[f"r{k}"][2])))
            for k in range(len(KEY_SETS))]
    return reps, per_dest(*res["g"])


def _port_pages(shards: list[dict]):
    """The shards as port pages on the CPU; the VARCHAR key column of every
    odd shard is re-coded into a reversed dictionary."""
    from trino_tpu_torch.data.page import Column, Dictionary, Page
    from trino_tpu_torch.data.types import parse_type

    words = Dictionary(WORDS)
    reversed_words = Dictionary(WORDS[::-1].copy())
    tags = Dictionary(np.array(["p", "q", "r"], dtype=object))
    pages = []
    for d, s in enumerate(shards):
        cols = []
        for i, ((_, t), (data, valid, data2)) in enumerate(zip(COLUMNS, s["cols"])):
            dic = {2: words, 3: tags}.get(i)
            if i == 2 and d % 2:
                dic, data = reversed_words, (len(WORDS) - 1 - data).astype(np.int32)
            cols.append(Column(
                parse_type(t), torch.from_numpy(data.copy()),
                None if valid is None else torch.from_numpy(valid.copy()), dic,
                None if data2 is None else torch.from_numpy(data2.copy()),
            ))
        pages.append(Page(tuple(cols), torch.from_numpy(s["live"].copy())))
    return pages


def _page_rows(page) -> list[tuple]:
    cols = [(c.data.numpy(), None if c.valid is None else c.valid.numpy(),
             None if c.data2 is None else c.data2.numpy()) for c in page.columns]
    return _decode(cols, [c.dictionary for c in page.columns], page.live_mask().numpy(),
                   [c.type for c in page.columns])


@pytest.mark.parametrize("D", [2, 3, 8])
def test_exchange_placement_equals_jax(D):
    """Every destination holds the same live rows in the same order as the
    JAX package's destination device; `required` is JAX's max bucket fill;
    outputs share one pow2 capacity.  At D = 3 the parts differ from
    runtime/wire.py's partition_ids (the 64-bit unsigned remainder), which
    the exchange therefore does not use."""
    from trino_tpu_torch.plan.ir import FieldRef
    from trino_tpu_torch.parallel.exchange import gather_all, repartition
    from trino_tpu_torch.runtime.wire import partition_ids

    shards = _shards(D, seed=100 + D)
    want_reps, want_gather = _jax_exchanges(D, shards)
    pages = _port_pages(shards)
    for ks, (want_rows, want_req) in zip(KEY_SETS, want_reps):
        keys = [FieldRef(i, pages[0].columns[i].type) for i in ks]
        out, req = repartition(pages, keys, D)
        assert req == want_req
        assert len({p.capacity for p in out}) == 1
        assert [_page_rows(p) for p in out] == want_rows
        assert sum(len(r) for r in want_rows) == sum(int(s["live"].sum()) for s in shards)
        if D == 3 and ks == (0,):
            wire = torch.cat([partition_ids(p, keys, D)[p.live_mask()] for p in pages])
            ours = []
            for d, rows in enumerate(want_rows):
                ours += [d] * len(rows)
            # same multiset of rows, routed by another rule
            assert sorted(wire.tolist()) != sorted(ours)
    got = gather_all(pages)
    assert [_page_rows(p) for p in got] == want_gather
    assert all(p is got[0] for p in got)  # one device: one shared page


def test_exchange_reads_only_its_count_matrix_to_the_host():
    """No exchanged column crosses to the host: the only reads into host
    values inside a repartition and a gather are the count matrix (D x D)
    and the live counts (D).  (Here every tensor lies on the CPU; on the card
    chip_smoke.py also watches the targets of Tensor.to.)"""
    from torch.overrides import TorchFunctionMode

    from trino_tpu_torch.plan.ir import FieldRef
    from trino_tpu_torch.parallel.exchange import gather_all, repartition

    reads = []
    host = {"tolist", "numpy", "item", "cpu", "__array__", "__index__", "__int__",
            "__float__", "__bool__"}

    class Watch(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            name = getattr(func, "__name__", "")
            if name in host and args and isinstance(args[0], torch.Tensor):
                reads.append((name, args[0].numel()))
            return func(*args, **(kwargs or {}))

    D = 4
    pages = _port_pages(_shards(D, seed=7))
    keys = [FieldRef(2, pages[0].columns[2].type), FieldRef(0, pages[0].columns[0].type)]
    with Watch():
        out, _ = repartition(pages, keys, D)
        gathered = gather_all(pages)
    assert reads == [("tolist", D * D), ("tolist", D)], reads
    assert sum(len(_page_rows(p)) for p in out) == len(_page_rows(gathered[0]))


def test_explain_analyze_row_counts_equal_jax(monkeypatch):
    """Per-node row counts of the distributed plan over 4 workers equal the
    JAX SpmdExecutor's (summed over shards; the replicated root's D copies
    counted as there).  The reference's eager capacity pre-sizing is turned
    off: it compiles op by op (about 50 s on a CPU) and changes no count."""
    import jax

    import trino_tpu.exec.spmd as ref_spmd
    from trino_tpu.runtime.engine import Engine as RefEngine
    from trino_tpu_torch.runtime.engine import Engine

    monkeypatch.setattr(ref_spmd, "_EAGER_SIZING_LIMIT", 0)
    ref = RefEngine(default_catalog="mem", distributed=True, devices=jax.devices()[:4])
    ref.register_catalog("mem", explain_tables("trino_tpu"))
    port = Engine(default_catalog="mem", device="cpu", distributed=True, devices=["cpu"] * 4)
    port.register_catalog("mem", explain_tables("trino_tpu_torch"))
    rplan, pplan = ref.plan(EXPLAIN_SQL), port.plan(EXPLAIN_SQL)
    kinds = {n.kind for n in _walk(pplan) if type(n).__name__ == "Exchange"}
    assert kinds == {"repartition", "broadcast", "gather", "single"}
    from trino_tpu.plan.nodes import format_plan as ref_format
    from trino_tpu_torch.plan.nodes import format_plan

    assert format_plan(pplan) == ref_format(rplan)
    ref_page, want = ref.executor.explain_analyze(rplan)
    page, got = port.executor.explain_analyze(pplan)
    assert got == {nid: {"rows": s["rows"]} for nid, s in want.items()}
    assert_rows_equal(page.to_pylist(), ref_page.to_pylist())
    text = [r[0] for r in port.execute("explain analyze " + EXPLAIN_SQL)]
    assert text[0] == "Exchange gather   [rows: 32]"
    assert any("Exchange single   [rows: 1]" in line for line in text)


def _walk(plan):
    yield plan
    for c in plan.children:
        yield from _walk(c)


@pytest.mark.parametrize("path", ["distributed", "out_of_core"])
def test_single_exchange_counts_a_replicated_input_once(path, oracle):
    """A `single` exchange over a replicated input (a global count, gathered
    to every task) keeps one copy: distributed, and out of core in 4 slices
    (which read every slice's copy, 4x the rows, before the exchange kinds
    were shared with exec/spmd.py)."""
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.runtime.engine import Engine

    from trino_tpu_torch.exec.spill import estimate_plan_bytes

    if path == "distributed":
        eng = Engine(device="cpu", distributed=True, devices=["cpu"] * 4)
        eng.register_catalog("tpch", TpchConnector(0.01))
    else:
        eng = Engine(device="cpu")
        eng.register_catalog("tpch", TpchConnector(0.01))
        est = estimate_plan_bytes(eng.plan(SINGLE_SQL), eng.catalogs)
        eng.session.set("query_max_memory_bytes", -(-est // 4))  # 4 slices
    plan = eng.plan(SINGLE_SQL) if path == "distributed" else None
    if plan is not None:
        assert "single" in {n.kind for n in _walk(plan) if type(n).__name__ == "Exchange"}
    got = eng.query(SINGLE_SQL)
    if path == "out_of_core":
        assert eng.last_spill is not None and eng.last_spill.parts == 4
    assert_rows_equal(got, oracle.query(SINGLE_SQL))
    assert got == [(26, 305)]


def test_second_run_uploads_nothing_and_shards_share_the_columns():
    """Scans upload each column once per device and write generation: a
    second run of a query uploads nothing; every task's shard is a view of
    the one uploaded column (its Dictionary shared), the last shard's tail
    dead."""
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.plan.nodes import TableScan
    from trino_tpu_torch.runtime.engine import Engine

    D = 7  # orders' 15,000 rows: six shards of 2,143 and one of 2,142 + a pad row
    eng = Engine(device="cpu", distributed=True, devices=["cpu"] * D)
    eng.register_catalog("tpch", TpchConnector(0.01))
    sql = SECOND_RUN_SQL
    first = eng.query(sql)
    assert eng.executor.last_upload_ms > 0
    assert eng.query(sql) == first
    assert eng.executor.last_upload_ms == 0
    scan = next(n for n in _walk(eng.plan(sql)) if isinstance(n, TableScan)
                and n.table == "orders")
    ex = eng.executor
    full = ex._card(ex.devices[0]).table_page(scan.catalog, scan.table, scan.column_names,
                                              scan.output_types)
    shards = [ex.sharded_table_page(scan, d) for d in range(D)]
    cap = shards[0].capacity
    assert cap == -(-full.capacity // D) == 2143
    for d, sh in enumerate(shards[:-1]):
        for c, f in zip(sh.columns, full.columns):
            assert c.data.data_ptr() == f.data[d * cap:].data_ptr()
            assert c.dictionary is f.dictionary
    assert shards[-1].capacity == cap
    assert shards[-1].live_mask().tolist() == [True] * 2142 + [False]
    assert sum(int(s.live_mask().sum()) for s in shards) == full.capacity
