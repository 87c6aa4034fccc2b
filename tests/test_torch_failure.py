"""The port's failure layer: Backoff schedules, circuit-breaker
transitions, the worker fault matrix, exchange-retry idempotency,
quarantine-aware dispatch, query expiry and memory-kill degradation.
Ports of the 23 cases of tests/test_failure.py.

Unit tests drive trino_tpu_torch/runtime/failure.py with injected clocks
and rngs; integration tests run the port's coordinator and workers over
loopback HTTP, every task on the CPU, with faults armed through the same
POST /v1/inject_failure surface the chaos harness uses.  The cluster's
GROUP BY rows are held against numpy.
"""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

try:  # arrow before torch: loaded after it, arrow's parquet writer crashes the process
    import pyarrow  # noqa: F401
except ImportError:
    pass
import torch

from trino_tpu_torch.runtime.failure import (
    OK,
    QUARANTINED,
    SUSPECT,
    Backoff,
    FailureDetector,
    FaultInjector,
)

torch.set_num_threads(1)


# --------------------------------------------------------------- Backoff


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_backoff_delay_schedule():
    """min_delay * factor^k capped at max_delay; jitter=0 == exact."""
    b = Backoff(min_delay=0.05, max_delay=0.5, max_elapsed=100.0,
                factor=2.0, jitter=0.0, clock=FakeClock(), sleep=lambda s: None)
    delays = []
    for _ in range(6):
        b.failure()
        delays.append(b.delay())
    assert delays == [0.05, 0.1, 0.2, 0.4, 0.5, 0.5]


def test_backoff_jitter_bounded_and_seeded():
    import random

    b = Backoff(min_delay=0.1, max_delay=10.0, factor=1.0, jitter=0.25,
                rng=random.Random(7), clock=FakeClock(), sleep=lambda s: None)
    b.failure()
    ds = [b.delay() for _ in range(100)]
    assert all(0.075 <= d <= 0.125 for d in ds)
    b2 = Backoff(min_delay=0.1, max_delay=10.0, factor=1.0, jitter=0.25,
                 rng=random.Random(7), clock=FakeClock(), sleep=lambda s: None)
    b2.failure()
    assert [b2.delay() for _ in range(100)] == ds  # same seed, same schedule


def test_backoff_deadline_escalates_and_success_resets():
    clock = FakeClock()
    b = Backoff(min_delay=0.05, max_elapsed=1.0, clock=clock, sleep=lambda s: None)
    assert b.failure() is False  # first failure starts the streak
    clock.t = 0.5
    assert b.failure() is False
    clock.t = 1.0  # deadline since FIRST failure of the streak
    assert b.failure() is True
    b.success()
    assert b.failure_count == 0 and b.first_failure_at is None
    clock.t = 5.0
    assert b.failure() is False  # fresh streak after success


def test_backoff_sleep_uses_injected_sleep():
    slept = []
    b = Backoff(min_delay=0.05, jitter=0.0, clock=FakeClock(),
                sleep=slept.append)
    b.failure()
    b.sleep()
    assert slept == [0.05]


# ------------------------------------------------------- FailureDetector


def test_detector_ok_suspect_quarantine_cycle():
    clock = FakeClock()
    det = FailureDetector(probe_interval=4.0, clock=clock)
    url = "http://w0"
    assert det.state(url) == OK and det.is_dispatchable(url)
    det.record_failure(url)
    assert det.state(url) == SUSPECT
    assert det.is_dispatchable(url)  # degraded but still serving
    det.record_failure(url)  # 2nd consecutive -> breaker opens
    assert det.state(url) == QUARANTINED
    assert not det.is_dispatchable(url)


def test_detector_half_open_probe_restores():
    clock = FakeClock()
    det = FailureDetector(probe_interval=4.0, clock=clock)
    url = "http://w0"
    det.record_failure(url)
    det.record_failure(url)
    assert det.state(url) == QUARANTINED
    # inside the quarantine window: no probes, no dispatches
    clock.t = 2.0
    assert not det.should_probe(url)
    assert not det.is_dispatchable(url)
    # window opens: half-open probe allowed
    clock.t = 4.5
    assert det.should_probe(url)
    # failed probe restarts the clock
    det.record_failure(url)
    clock.t = 6.0
    assert not det.should_probe(url)
    clock.t = 9.0
    assert det.should_probe(url)
    # successful probe: full restore
    det.record_success(url, latency=0.01)
    assert det.state(url) == OK
    assert det.is_dispatchable(url)


def test_detector_suspect_recovers_on_success():
    det = FailureDetector(clock=FakeClock())
    url = "http://w0"
    det.record_failure(url)
    assert det.state(url) == SUSPECT
    for _ in range(5):  # ewma decays below suspect threshold
        det.record_success(url)
    assert det.state(url) == OK


def test_detector_reset_forgets_history():
    det = FailureDetector(clock=FakeClock())
    det.record_failure("http://w0")
    det.record_failure("http://w0")
    det.reset("http://w0")  # worker re-announced after restart
    assert det.state("http://w0") == OK
    assert det.snapshot()["http://w0"]["consecutive_failures"] == 0


# ---------------------------------------------------------- FaultInjector


def test_injector_error_is_one_shot():
    inj = FaultInjector()
    inj.arm(task_id="*", mode="ERROR")
    with pytest.raises(RuntimeError, match="injected failure"):
        inj.task_fault("q1_t0")
    inj.task_fault("q1_t1")  # rule consumed: no-op
    assert inj.fired == [("ERROR", "q1_t0")]


def test_injector_timeout_sleeps_then_raises():
    inj = FaultInjector()
    inj.arm(mode="TIMEOUT", delay_ms=250)
    slept = []
    with pytest.raises(RuntimeError, match="injected timeout"):
        inj.task_fault("t0", sleep=slept.append)
    assert slept == [0.25]


def test_injector_slow_delays_without_failing():
    inj = FaultInjector()
    inj.arm(mode="SLOW", delay_ms=100, count=2)
    slept = []
    inj.task_fault("t0", sleep=slept.append)
    inj.task_fault("t1", sleep=slept.append)
    inj.task_fault("t2", sleep=slept.append)  # exhausted
    assert slept == [0.1, 0.1]


def test_injector_exchange_drop_counted():
    inj = FaultInjector()
    inj.arm(mode="EXCHANGE_DROP", count=3)
    assert [inj.drop_fetch("t") for t in "abcd"] == [True, True, True, False]


def test_injector_task_prefix_matching():
    inj = FaultInjector()
    inj.arm(task_id="q_abc", mode="ERROR")
    inj.task_fault("q_xyz_f0_p0")  # no match: rule stays armed
    with pytest.raises(RuntimeError):
        inj.task_fault("q_abc_f1_p2")


def test_injector_probabilistic_seeded():
    def firings(seed):
        inj = FaultInjector()
        inj.arm(mode="EXCHANGE_DROP", count=10**6, probability=0.3, seed=seed)
        return [inj.drop_fetch("t") for _ in range(200)]

    a, b = firings(11), firings(11)
    assert a == b  # deterministic replay from the seed
    assert 20 < sum(a) < 100  # ~30% of 200
    assert firings(12) != a


def test_injector_rejects_unknown_mode():
    with pytest.raises(ValueError, match="unknown fault mode"):
        FaultInjector().arm(mode="KERNEL_PANIC")


def test_injector_clear():
    inj = FaultInjector()
    inj.arm(mode="ERROR")
    inj.clear()
    inj.task_fault("t0")  # disarmed: no raise


# ------------------------------------------------- cluster integration


def _table_t():
    rng = np.random.default_rng(5)
    return (rng.integers(0, 50, 20_000).astype(np.int64),
            rng.integers(0, 1000, 20_000).astype(np.int64))


def _group_rows():
    """GROUP_SQL's rows computed in numpy."""
    k, v = _table_t()
    return [(int(g), int(v[k == g].sum()), int((k == g).sum())) for g in np.unique(k)]


@pytest.fixture(scope="module")
def mem_cluster():
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.connectors.spi import ColumnSchema
    from trino_tpu_torch.data.types import BIGINT
    from trino_tpu_torch.testing import DistributedQueryRunner

    conn = MemoryConnector()
    conn.create_table("t", [ColumnSchema("k", BIGINT), ColumnSchema("v", BIGINT)])
    k, v = _table_t()
    conn.insert("t", {"k": k, "v": v})
    runner = DistributedQueryRunner(
        num_workers=2, default_catalog="mem", heartbeat_interval=0.3, device="cpu"
    )
    runner.register_catalog("mem", conn)
    runner.start()
    # fault-injection tests arm per-worker fault budgets and need every
    # repeated GROUP_SQL run to actually execute to consume them; a result
    # cache hit would leave armed faults to leak into later tests
    runner.coordinator.session.set("result_cache_enabled", "false")
    yield runner
    runner.stop()


GROUP_SQL = "select k, sum(v) as s, count(*) as c from t group by k order by k"


def test_inject_failure_http_rejects_unknown_mode(mem_cluster):
    req = urllib.request.Request(
        f"{mem_cluster.workers[0].url}/v1/inject_failure",
        data=json.dumps({"task_id": "*", "mode": "KERNEL_PANIC"}).encode(),
    )
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=10)
    assert ei.value.code == 400


def test_exchange_drop_retry_is_idempotent(mem_cluster):
    """Dropped page fetches retry through Backoff and resume from the ack
    token: the rows (counts AND sums — any double-counted page would skew
    both) are byte-identical with and without EXCHANGE_DROP armed."""
    clean = mem_cluster.query(GROUP_SQL)
    assert clean == _group_rows()
    for i in range(len(mem_cluster.workers)):
        mem_cluster.inject_task_failure(
            worker_index=i, mode="EXCHANGE_DROP", count=2
        )
    faulted = mem_cluster.query(GROUP_SQL)
    assert faulted == clean
    dropped = [
        m for w in mem_cluster.workers for (m, _) in w.fault_injector.fired
        if m == "EXCHANGE_DROP"
    ]
    assert dropped, "no page fetch was actually dropped"


def test_slow_fault_recovers_without_retry_policy(mem_cluster):
    clean = _group_rows()
    mem_cluster.inject_task_failure(worker_index=0, mode="SLOW", delay_ms=200)
    assert mem_cluster.query(GROUP_SQL) == clean


def test_error_and_timeout_recover_under_task_retry(mem_cluster):
    clean = _group_rows()
    mem_cluster.coordinator.session.set("retry_policy", "TASK")
    try:
        mem_cluster.inject_task_failure(worker_index=0, mode="ERROR")
        assert mem_cluster.query(GROUP_SQL) == clean
        mem_cluster.inject_task_failure(worker_index=1, mode="TIMEOUT", delay_ms=100)
        assert mem_cluster.query(GROUP_SQL) == clean
    finally:
        mem_cluster.coordinator.session.set("retry_policy", "NONE")


def test_dead_worker_quarantined_and_not_dispatched(mem_cluster):
    """A worker that stops answering heartbeats trips the breaker: state
    QUARANTINED, excluded from alive_workers (so it receives no new
    dispatches), and queries keep succeeding on the survivors.  Uses its
    own cluster because the worker stays dead."""
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.connectors.spi import ColumnSchema
    from trino_tpu_torch.data.types import BIGINT
    from trino_tpu_torch.testing import DistributedQueryRunner

    conn = MemoryConnector()
    conn.create_table("t", [ColumnSchema("k", BIGINT)])
    conn.insert("t", {"k": np.arange(1000, dtype=np.int64)})
    runner = DistributedQueryRunner(
        num_workers=2, default_catalog="mem", heartbeat_interval=0.2, device="cpu"
    )
    runner.register_catalog("mem", conn)
    runner.start()
    try:
        dead = runner.workers[1]
        dead.stop()
        det = runner.coordinator.failure_detector
        deadline = time.monotonic() + 10
        while det.state(dead.url) != QUARANTINED and time.monotonic() < deadline:
            time.sleep(0.05)
        assert det.state(dead.url) == QUARANTINED
        assert not det.is_dispatchable(dead.url)
        assert dead.url not in runner.coordinator.alive_workers()
        rows = runner.query("select count(*) from t")
        assert rows == [(1000,)]
    finally:
        runner.stop()


def test_finished_queries_expire_after_max_age(mem_cluster):
    coord = mem_cluster.coordinator
    old_age = coord.query_expiration_seconds
    coord.query_expiration_seconds = 0.4
    try:
        qid = coord.submit_query("select count(*) from t")
        coord.queries[qid]["done"].wait(30)
        assert qid in coord.queries
        deadline = time.monotonic() + 10
        while qid in coord.queries and time.monotonic() < deadline:
            time.sleep(0.1)  # heartbeat sweep expires it
        assert qid not in coord.queries
    finally:
        coord.query_expiration_seconds = old_age


def test_memory_kill_requeues_through_spill_executor(mem_cluster):
    """A cluster-memory kill degrades instead of failing: the run loop
    observes requeue_spill and re-runs the query through the out-of-core
    executor (sequential slices, disk exchanges)."""
    coord = mem_cluster.coordinator
    clean = _group_rows()
    orig, requeues = coord._run_once, coord.memory_requeues

    def killed(record, attempt=0):
        record["requeue_spill"] = True  # what _enforce_cluster_memory sets
        record["cancel"] = True
        raise RuntimeError("Query killed: cluster memory limit exceeded")

    coord._run_once = killed
    try:
        got = mem_cluster.query(GROUP_SQL)
    finally:
        coord._run_once = orig
    assert got == clean
    assert coord.memory_requeues == requeues + 1
