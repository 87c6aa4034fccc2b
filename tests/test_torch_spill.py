"""The port's out-of-core path (exec/spill.py over plan/distribute.py,
plan/fragmenter.py and runtime/wire.py) against the JAX package's: memory
accounting, the fragment trees of all 22 TPC-H queries, the byte estimate
and part count, Q1 / Q3 / Q18 at SF 0.01 under a ~3 MB budget (rows equal
the reference engine's out-of-core rows and sqlite, spill files written), a
budget that admits the query, the reactive re-run after a device
out-of-memory error, and a CPU engine that never touches a CUDA device."""

import pytest
try:  # arrow before torch: loaded after it, arrow's parquet writer crashes the process
    import pyarrow  # noqa: F401
except ImportError:
    pass
import torch

from tests.oracle import assert_rows_equal
from tests.tpch_queries import ORDERED, QUERIES

torch.set_num_threads(1)

BUDGET = 3_000_000  # ~3 MB: several slices at SF 0.01


@pytest.fixture(autouse=True)
def _restore_kernel_policy():
    """Engine statements set the process-global kernel policy: put back what
    the next test in this worker expects."""
    from trino_tpu_torch.ops import kernels

    saved = kernels.get_policy()
    yield
    kernels.set_policy(saved)


@pytest.fixture(scope="module")
def port():
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.runtime.engine import Engine

    eng = Engine(device="cpu")
    eng.register_catalog("tpch", TpchConnector(0.01))
    return eng


@pytest.fixture(scope="module")
def ref():
    from trino_tpu.connectors.tpch import TpchConnector
    from trino_tpu.runtime.engine import Engine

    eng = Engine()
    eng.register_catalog("tpch", TpchConnector(0.01))
    return eng


def test_memory_pool_accounting():
    from trino_tpu_torch.runtime.memory import MemoryContext, MemoryExceeded, QueryMemoryPool

    pool = QueryMemoryPool(budget=1000)
    ctx = MemoryContext(pool, "op1")
    ctx.set(600)
    assert pool.used == 600
    ctx.set(300)  # shrink frees
    assert pool.used == 300
    with pytest.raises(MemoryExceeded):
        MemoryContext(pool, "op2").set(800)
    ctx.close()
    assert pool.used == 0
    assert pool.peak == 600


def _fragments(pkg: str, sql: str, parts: int):
    if pkg == "port":
        from trino_tpu_torch.connectors.spi import CatalogManager
        from trino_tpu_torch.connectors.tpch import TpchConnector
        from trino_tpu_torch.plan import serde
        from trino_tpu_torch.plan.distribute import distribute
        from trino_tpu_torch.plan.fragmenter import fragment_plan
        from trino_tpu_torch.plan.optimizer import optimize
        from trino_tpu_torch.plan.planner import Planner
        from trino_tpu_torch.runtime.session import SessionProperties
    else:
        from trino_tpu.connectors.spi import CatalogManager
        from trino_tpu.connectors.tpch import TpchConnector
        from trino_tpu.plan import serde
        from trino_tpu.plan.distribute import distribute
        from trino_tpu.plan.fragmenter import fragment_plan
        from trino_tpu.plan.optimizer import optimize
        from trino_tpu.plan.planner import Planner
        from trino_tpu.runtime.session import SessionProperties
    catalogs = CatalogManager()
    catalogs.register("tpch", TpchConnector(0.01))
    session = SessionProperties()
    plan = optimize(Planner(catalogs, "tpch").plan(sql), catalogs, session)
    frags = fragment_plan(distribute(plan, catalogs, parts, session))
    return [
        (f.id, f.output_kind, repr(f.output_keys), list(f.inputs), serde.plan_to_json(f.root))
        for f in frags
    ]


def test_fragment_trees_equal_the_reference_for_all_22_queries():
    cut = 0
    for name in sorted(QUERIES):
        got = _fragments("port", QUERIES[name], 4)
        want = _fragments("ref", QUERIES[name], 4)
        assert got == want, name
        cut += len(got) > 1
    assert cut >= 20  # nearly every query has exchanges to cut


def test_estimate_and_part_count_equal_the_reference(port, ref):
    from trino_tpu.exec.spill import estimate_plan_bytes as ref_estimate
    from trino_tpu_torch.exec.spill import estimate_plan_bytes

    def parts_of(est, budget):
        p = max(2, min(16, -(-est // budget)))
        return 1 << (p - 1).bit_length()

    for name in sorted(QUERIES):
        est = estimate_plan_bytes(port.plan(QUERIES[name]), port.catalogs)
        assert est == ref_estimate(ref.plan(QUERIES[name]), ref.catalogs), name
        assert est > 0
    # the engine picks the reference's part count from the estimate
    seen = []
    real = type(port)._run_out_of_core

    def spy(self, plan, est, budget, *params):
        seen.append(parts_of(est, budget))
        return real(self, plan, est, budget, *params)

    type(port)._run_out_of_core = spy
    port.session.set("query_max_memory_bytes", str(BUDGET))
    try:
        port.query(QUERIES["q06"])
    finally:
        type(port)._run_out_of_core = real
        port.session.set("query_max_memory_bytes", "0")
    assert seen == [port.last_spill.parts]


def _out_of_core(engine, sql):
    engine.session.set("query_max_memory_bytes", str(BUDGET))
    try:
        return engine.query(sql), engine.last_spill
    finally:
        engine.session.set("query_max_memory_bytes", "0")


@pytest.mark.parametrize("name", ["q01", "q03", "q18"])
def test_out_of_core_equals_the_reference_and_sqlite(name, port, ref, oracle):
    got, spill = _out_of_core(port, QUERIES[name])
    assert spill is not None and spill.spill_files > 0 and spill.spilled_bytes > 0
    want, ref_spill = _out_of_core(ref, QUERIES[name])
    assert spill.parts == ref_spill.parts >= 2
    assert_rows_equal(got, want, ordered=ORDERED[name])
    assert_rows_equal(got, oracle.query(QUERIES[name]), ordered=ORDERED[name])
    assert spill.spill_files == ref_spill.spill_files
    assert spill.rows_pruned == getattr(ref_spill, "rows_pruned", 0)


def test_a_budget_large_enough_stays_in_memory(port):
    port.session.set("query_max_memory_bytes", str(10 ** 12))
    port.last_spill = None
    try:
        rows = port.query("select count(*) from lineitem")
        assert rows[0][0] > 0
        assert port.last_spill is None
    finally:
        port.session.set("query_max_memory_bytes", "0")
    # no budget on the CPU unless the session sets one; -1 turns it off
    assert port._device_memory_budget() == 0
    port.session.set("query_max_memory_bytes", "-1")
    assert port._device_memory_budget() == 0
    port.session.set("query_max_memory_bytes", "0")


def test_a_write_source_over_the_budget_runs_out_of_core(port, oracle):
    """The query under CREATE TABLE AS runs out of core over the budget, as
    Engine.query does; the table it writes holds the query's rows."""
    from trino_tpu_torch.connectors.memory import MemoryConnector

    if "memory" not in port.catalogs.names():
        port.register_catalog("memory", MemoryConnector())
    port.session.set("query_max_memory_bytes", str(BUDGET))
    port.last_spill = None
    try:
        port.execute(f"create table memory.q03_out as {QUERIES['q03']}")
    finally:
        port.session.set("query_max_memory_bytes", "0")
    assert port.last_spill is not None and port.last_spill.spill_files > 0
    got = port.query("select * from memory.q03_out")
    port.execute("drop table memory.q03_out")
    assert_rows_equal(got, oracle.query(QUERIES["q03"]), ordered=False)


SQL_OOM = ("select l_returnflag, count(*) as c, sum(l_quantity) as q "
           "from lineitem group by l_returnflag order by l_returnflag")


def test_reactive_rerun_after_a_device_out_of_memory_error(port, oracle):
    """The estimate admits the query, the executor then runs out of device
    memory once (torch.cuda.OutOfMemoryError): the engine re-runs it out of
    core and the rows still equal the oracle."""
    real = port.executor.execute
    calls = {"n": 0}

    def oom_once(plan, *a, **kw):
        if calls["n"] == 0:
            calls["n"] += 1
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 80.00 GiB")
        return real(plan, *a, **kw)

    port.executor.execute = oom_once
    port.session.set("query_max_memory_bytes", str(10 ** 12))
    port.last_spill = None
    try:
        got = port.query(SQL_OOM)
    finally:
        del port.executor.execute
        port.session.set("query_max_memory_bytes", "0")
    assert calls["n"] == 1
    assert port.last_spill is not None and port.last_spill.spilled_bytes > 0
    assert_rows_equal(got, oracle.query(SQL_OOM), ordered=True)


def test_other_errors_are_not_rerun_out_of_core(port):
    def boom(plan, *a, **kw):
        raise RuntimeError("capacity retry loop did not converge")

    port.executor.execute = boom
    port.session.set("query_max_memory_bytes", str(10 ** 12))
    port.last_spill = None
    try:
        with pytest.raises(RuntimeError, match="did not converge"):
            port.query(SQL_OOM)
    finally:
        del port.executor.execute
        port.session.set("query_max_memory_bytes", "0")
    assert port.last_spill is None


def test_cpu_engine_out_of_core_never_touches_a_cuda_device(port, monkeypatch):
    """Every executor and every page of the out-of-core run is on the CPU:
    a stray "cuda" default would raise here (no card), and on a card it
    would allocate — the allocator's counter must not move."""
    from trino_tpu_torch.exec import compiler, spill

    devices = []
    real_init = compiler.LocalExecutor.__init__

    def record(self, *a, **kw):
        real_init(self, *a, **kw)
        devices.append(self.device.type)

    monkeypatch.setattr(spill.LocalExecutor, "__init__", record)
    before = torch.cuda.memory_allocated() if torch.cuda.is_available() else 0
    got, ooc = _out_of_core(port, QUERIES["q03"])
    after = torch.cuda.memory_allocated() if torch.cuda.is_available() else 0
    assert got and ooc.device.type == "cpu"
    assert devices and set(devices) == {"cpu"}
    assert after == before


def test_no_reference_cycle_keeps_tensors_after_a_run(port):
    """A run's pages and intermediates are freed when the run returns, not
    when the cyclic collector next runs: the executor's recursive closures
    (the plan walk, the capacity sizing, the filter collection) are cut.
    Out of core this is what keeps one slice's working set on the card."""
    import gc
    import warnings

    gc.collect()
    gc.disable()
    try:
        for budget in ("0", str(BUDGET)):
            port.session.set("query_max_memory_bytes", budget)
            port.executor._learned_caps.clear()  # the capacity sizing runs too
            port.query(QUERIES["q03"])
            port.executor.drop_scans()
            with warnings.catch_warnings():  # the walk touches deprecated torch objects
                warnings.simplefilter("ignore", FutureWarning)
                held = [o for o in gc.get_objects() if isinstance(o, torch.Tensor)]
            assert held == [], f"{len(held)} tensors held by reference cycles"
            gc.collect()
    finally:
        gc.enable()
        port.session.set("query_max_memory_bytes", "0")
