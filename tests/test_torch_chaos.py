"""The port's seeded chaos harness (trino_tpu_torch/testing/chaos.py), every
task on the CPU.  Ports of tests/test_chaos.py: a retry_policy=TASK cluster
under seeded random fault schedules (ERROR / TIMEOUT / SLOW / EXCHANGE_DROP,
a random target worker, a random delay and count) returns the rows a clean
run returns.  A failure replays from its seed.

The memory-table smoke runs in tier-1; the TPC-H tier is marked `chaos` and
`slow`, as the reference marks it (`pytest -m chaos`)."""

import time

import numpy as np
import pytest

try:  # arrow before torch: loaded after it, arrow's parquet writer crashes the process
    import pyarrow  # noqa: F401
except ImportError:
    pass
import torch

from tests.oracle import assert_rows_equal
from tests.tpch_queries import ORDERED, QUERIES

torch.set_num_threads(1)

CHAOS_QUERIES = ["q01", "q03", "q06", "q13", "q18"]
ROUNDS = 2
SEED = 1234


@pytest.mark.chaos
@pytest.mark.slow
def test_chaos_tpch_matches_oracle(tpch_tiny, oracle):
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.testing import make_chaos_cluster

    runner, chaos = make_chaos_cluster(
        lambda: TpchConnector(0.01), num_workers=3, seed=SEED, device="cpu"
    )
    try:
        for rnd in range(ROUNDS):
            for name in CHAOS_QUERIES:
                sql = QUERIES[name]
                got = chaos.run_query(sql)
                try:
                    assert_rows_equal(got, oracle.query(sql), ordered=ORDERED[name])
                except AssertionError as e:
                    raise AssertionError(
                        f"round {rnd} {name} diverged under {chaos.schedule[-1]}: {e}"
                    ) from None
        fired = chaos.fired_modes()
        assert len(fired) >= 3, f"only {fired} fired across {chaos.schedule}"
    finally:
        runner.stop()


def _table():
    rng = np.random.default_rng(2)
    return (rng.integers(0, 20, 5000).astype(np.int64),
            rng.integers(0, 100, 5000).astype(np.int64))


def test_chaos_harness_smoke():
    """A seeded chaos pass over a memory table keeps the harness in tier-1:
    every faulted run equals numpy's rows, the schedule was armed, and the
    same seed arms the same schedule again."""
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.connectors.spi import ColumnSchema
    from trino_tpu_torch.data.types import BIGINT
    from trino_tpu_torch.testing import ChaosRunner, make_chaos_cluster

    def catalog():
        conn = MemoryConnector()
        conn.create_table("t", [ColumnSchema("k", BIGINT), ColumnSchema("v", BIGINT)])
        k, v = _table()
        conn.insert("t", {"k": k, "v": v})
        return conn

    k, v = _table()
    want = [(int(g), int(v[k == g].sum())) for g in np.unique(k)]
    runner, chaos = make_chaos_cluster(
        catalog, num_workers=2, default_catalog="mem", seed=99, device="cpu"
    )
    try:
        # every run executes: a result-cache hit would leave armed faults idle
        runner.coordinator.session.set("result_cache_enabled", "false")
        sql = "select k, sum(v) from t group by k order by k"
        assert runner.query(sql) == want
        for _ in range(3):
            assert chaos.run_query(sql) == want
        assert chaos.schedule and chaos.armed_modes()
        assert not any(w.fault_injector._rules for w in runner.workers)  # disarmed
        replay = ChaosRunner(runner, seed=99)
        for events in chaos.schedule:
            assert replay.arm_random_faults() == events
            replay.clear_faults()
    finally:
        runner.stop()


def test_chaos_query_survives_a_worker_drained_mid_flight():
    """Lifecycle chaos: a worker drained from a background thread while the
    query runs (ChaosRunner.run_query_with_action); whenever the drain lands,
    the query returns numpy's rows and the worker ends drained."""
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.connectors.spi import ColumnSchema
    from trino_tpu_torch.data.types import BIGINT
    from trino_tpu_torch.testing import make_chaos_cluster

    def catalog():
        conn = MemoryConnector()
        conn.create_table("t", [ColumnSchema("k", BIGINT), ColumnSchema("v", BIGINT)])
        k, v = _table()
        conn.insert("t", {"k": k, "v": v})
        return conn

    k, v = _table()
    want = [(int(g), int(v[k == g].sum())) for g in np.unique(k)]
    runner, chaos = make_chaos_cluster(
        catalog, num_workers=2, default_catalog="mem", seed=5, device="cpu"
    )
    try:
        sql = "select k, sum(v) from t group by k order by k"
        assert chaos.run_query_with_action(sql, lambda: runner.drain_worker(1), 0.0) == want
        w = runner.workers[1]
        deadline = time.monotonic() + 30
        while w.state != "drained" and time.monotonic() < deadline:
            time.sleep(0.02)
        assert w.state == "drained"
        assert runner.query(sql) == want  # the survivor serves the next query alone
    finally:
        runner.stop()
