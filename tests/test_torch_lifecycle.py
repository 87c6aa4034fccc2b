"""The port's graceful lifecycle plane: drain, speculation, watchdogs,
shedding.  Ports of the 10 cases of tests/test_lifecycle.py, every task on
the CPU; rows are held against the numpy sum of the two tables.

Injected delays are events: a SLOW fault's sleep waits on a gate the test
opens when it is done with the straggler (`_gated_sleeps`), so no case
races the clock — the straggler's replacement must finish while the gate is
still closed, which proves it was not waited out.

Reference behaviors being matched:
- server/GracefulShutdownHandler + NodeState.DRAINING: a draining worker
  rejects new tasks (503), finishes running ones, keeps serving its output
  buffers, then deregisters — consumers never notice (zero retries).
- execution/scheduler speculative execution: a straggler past the
  speculation quantile gets a backup attempt; the spool commit arbitrates
  exactly-once.
- QueryTracker.enforceTimeLimits: typed EXCEEDED_TIME_LIMIT /
  EXCEEDED_QUEUED_TIME_LIMIT kills surfaced to the client.
- dispatcher/DispatchManager backpressure: past the dispatch queue bound
  new statements get 429 + Retry-After instead of unbounded queueing.
"""

import os
import threading
import time
import urllib.error
import urllib.request

import pytest

try:  # arrow before torch: loaded after it, arrow's parquet writer crashes the process
    import pyarrow  # noqa: F401
except ImportError:
    pass
import torch

from tests.test_torch_spool import GatedMemoryConnector, _make_tables
from trino_tpu_torch.client import QueryFailed, StatementClient
from trino_tpu_torch.connectors.memory import MemoryConnector
from trino_tpu_torch.testing import DistributedQueryRunner

torch.set_num_threads(1)

pytestmark = pytest.mark.smoke

JOIN_SQL = "select sum(v + w) from probe, build where probe.k = build.k"


def _start_cluster(conn, tmp_path=None, num_workers=2, heartbeat=0.2):
    runner = DistributedQueryRunner(
        num_workers=num_workers, default_catalog="memory",
        heartbeat_interval=heartbeat, device="cpu",
    )
    runner.register_catalog("memory", conn)
    runner.start()
    # every run executes: the result and fragment cache would answer a
    # repeated statement (its scan fragments memoized in the spool) without
    # dispatching the task a fault is armed for
    runner.coordinator.session.set("result_cache_enabled", "false")
    if tmp_path is not None:
        runner.coordinator.session.set("retry_policy", "TASK")
        runner.coordinator.session.set("exchange_spool_dir", str(tmp_path))
    return runner


def _wait(pred, timeout=30.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            return False
        time.sleep(interval)
    return True


def _gated_sleeps(worker) -> threading.Event:
    """Make the worker's SLOW / TIMEOUT faults wait on the returned gate (at
    most their delay) instead of sleeping: the test opens it when it is done
    with the straggler."""
    gate = threading.Event()
    inj = worker.fault_injector
    plain = type(inj).task_fault
    inj.task_fault = lambda task_id, sleep=None: plain(inj, task_id, sleep=gate.wait)
    return gate


def _await_query(runner, qid, timeout=120.0):
    sm = runner.coordinator.queries[qid]["sm"]
    assert _wait(lambda: sm.done, timeout), f"query stuck in {sm.state}"
    return sm


# --------------------------------------------------------------- drain


@pytest.mark.chaos
def test_drain_mid_query_zero_retries(tmp_path):
    """Drain 1 of 2 workers mid-query: the query finishes correctly with
    ZERO task retries and ZERO quarantine transitions — drain is invisible
    to the data plane, unlike a crash."""
    conn = GatedMemoryConnector()
    expect = _make_tables(conn)
    runner = _start_cluster(conn, tmp_path, heartbeat=0.1)
    coord = runner.coordinator
    # one probe task per worker: split-driven scans may hand every probe
    # split to worker 0, and a victim with no running task drains at once
    # and deregisters before any heartbeat reads DRAINING (the reference's
    # test waits for the first probe task only)
    coord.session.set("split_driven_scans", "false")
    try:
        conn.gated_table = "probe"
        qid = coord.submit_query(JOIN_SQL)
        assert _wait(lambda: conn.entered >= len(runner.workers), 60), (
            "the probe tasks never started"
        )

        victim = runner.workers[1]
        runner.drain_worker(1)
        # the breaker must flip the worker to DRAINING (not QUARANTINED)
        # before we let the query proceed — no dispatch race
        det = coord.failure_detector
        assert _wait(lambda: det.state(victim.url) == "DRAINING", 10), (
            f"breaker never saw DRAINING (state={det.state(victim.url)})"
        )
        conn.gate.set()

        sm = _await_query(runner, qid)
        record = coord.queries[qid]
        assert sm.state == "FINISHED", f"query {sm.state}: {sm.error}"
        assert record["result"] == [(expect,)]

        # the whole point: drain is NOT a failure
        assert record.get("task_retries", 0) == 0, "drain caused task retries"
        assert coord._m_retries.value() == 0
        assert coord._m_breaker.value("QUARANTINED") == 0, (
            "drain tripped the circuit breaker"
        )
        with urllib.request.urlopen(coord.url + "/metrics", timeout=10) as r:
            text = r.read().decode()
        for line in text.splitlines():
            if 'to="QUARANTINED"' in line:
                assert line.rstrip().endswith(" 0"), line
        assert "trino_tpu_worker_drains_total 1" in _worker_metrics(victim)

        # drain completes: running tasks done, buffers served, deregistered
        assert _wait(lambda: victim.state == "drained", 30), (
            f"drain never completed (state={victim.state})"
        )
        assert _wait(lambda: victim.url not in coord.workers, 10), (
            "drained worker never deregistered"
        )
    finally:
        conn.gate.set()
        runner.stop()


def _worker_metrics(worker) -> str:
    with urllib.request.urlopen(worker.url + "/metrics", timeout=10) as r:
        return r.read().decode()


@pytest.mark.chaos
def test_draining_worker_rejects_new_tasks():
    """New task POSTs against a DRAINING worker get 503 + Retry-After."""
    import json

    conn = MemoryConnector()
    runner = _start_cluster(conn, num_workers=1)
    try:
        w = runner.workers[0]
        runner.drain_worker(0)
        assert _wait(lambda: w.state in ("draining", "drained"), 10)
        req = urllib.request.Request(
            f"{w.url}/v1/task/t_reject",
            data=json.dumps(
                {"task_id": "t_reject", "fragment": {}, "sources": []}
            ).encode(),
        )
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10)
        assert ei.value.code == 503
        assert ei.value.headers.get("Retry-After")
        ei.value.read()
    finally:
        runner.stop()


@pytest.mark.chaos
@pytest.mark.slow  # ~30s: the survivor rides out the exchange Backoff
# deadline against the dead worker before escalating; run via
# `scripts/chaos_tier.sh kill9` (the fast drain twin stays in tier-1)
def test_kill9_recovers_from_spool(tmp_path):
    """The contrast case: a hard kill (SIGKILL analogue) of the same worker
    is NOT invisible — recovery comes only from TASK retry re-reading the
    committed spool output."""
    conn = GatedMemoryConnector()
    expect = _make_tables(conn)
    runner = _start_cluster(conn, tmp_path, heartbeat=0.3)
    coord = runner.coordinator
    try:
        conn.gated_table = "probe"
        qid = coord.submit_query(JOIN_SQL)
        assert _wait(lambda: conn.entered > 0, 60), "probe stage never started"
        time.sleep(0.3)  # pre-probe stages commit to the spool
        runner.kill_worker(1)
        conn.gate.set()

        sm = _await_query(runner, qid)
        record = coord.queries[qid]
        assert sm.state == "FINISHED", f"query {sm.state}: {sm.error}"
        assert record["result"] == [(expect,)]
        # unlike drain, the crash shows up as retry/heal work
        recovered = record.get("task_retries", 0) + record.get("task_heals", 0)
        assert recovered >= 1, "kill -9 was absorbed without any retry/heal?"
    finally:
        conn.gate.set()
        runner.stop()


# --------------------------------------------------------------- watchdogs


def test_no_progress_watchdog_kills_wedged_task(tmp_path):
    """A SLOW-wedged task whose stats freeze while RUNNING is failed by the
    worker watchdog well under the fault duration; TASK retry completes the
    query elsewhere."""
    conn = MemoryConnector()
    expect = _make_tables(conn)
    runner = _start_cluster(conn, tmp_path, heartbeat=0.2)
    coord = runner.coordinator
    gates = [_gated_sleeps(w) for w in runner.workers]
    try:
        # warm-up: scan caches and learned capacities, so the run below
        # measures the watchdog
        assert runner.query(JOIN_SQL) == [(expect,)]

        coord.session.set("task_no_progress_timeout_s", "1.0")
        # armed on every worker: split-driven scans hand a run's splits to
        # whichever worker asks, so a fault armed on one worker alone may
        # never meet a task (the reference's test arms worker 0 only)
        for i in range(len(runner.workers)):
            runner.inject_task_failure(worker_index=i, mode="SLOW",
                                       delay_ms=60_000, count=1)
        assert runner.query(JOIN_SQL) == [(expect,)]
        # the wedged tasks are still asleep: the query did not wait them out
        assert not any(g.is_set() for g in gates)
        fired = [m for w in runner.workers for m, _ in w.fault_injector.fired]
        assert "SLOW" in fired, "the fault never met a task"
        kills = sum(w._m_no_progress.value() for w in runner.workers)
        assert kills >= 1, "watchdog never fired"
    finally:
        for g in gates:
            g.set()
        runner.stop()


def test_query_max_run_time_typed_reason():
    """query_max_run_time_s=1 kills a wedged query with a typed
    EXCEEDED_TIME_LIMIT reason the client can branch on."""
    conn = GatedMemoryConnector()
    _make_tables(conn)
    runner = _start_cluster(conn, heartbeat=0.1)
    try:
        runner.coordinator.session.set("query_max_run_time_s", "1")
        conn.gated_table = "probe"
        client = StatementClient(runner.coordinator.url)
        with pytest.raises(QueryFailed) as ei:
            client.execute(JOIN_SQL, timeout=60)
        assert "EXCEEDED_TIME_LIMIT" in str(ei.value)
        assert ei.value.error_code == "EXCEEDED_TIME_LIMIT"
        assert runner.coordinator._m_deadline.value("run_time") >= 1
    finally:
        conn.gate.set()
        runner.stop()


def test_query_max_queued_time_kill(tmp_path):
    """A query stuck QUEUED in its resource group past
    query_max_queued_time_s is shed with EXCEEDED_QUEUED_TIME_LIMIT while
    the running query ahead of it is untouched."""
    from trino_tpu_torch.runtime.resourcegroups import (
        ResourceGroupConfig, ResourceGroupManager,
    )

    conn = GatedMemoryConnector()
    expect = _make_tables(conn)
    runner = _start_cluster(conn, heartbeat=0.1)
    coord = runner.coordinator
    try:
        # one concurrency slot: the second query must queue behind the first
        coord.resource_groups = ResourceGroupManager(
            ResourceGroupConfig(name="global", max_concurrency=1)
        )
        coord.session.set("query_max_queued_time_s", "0.5")
        conn.gated_table = "probe"
        q1 = coord.submit_query(JOIN_SQL)
        assert _wait(lambda: conn.entered > 0, 60), "q1 never started"
        q2 = coord.submit_query(JOIN_SQL)

        sm2 = _await_query(runner, q2, timeout=15)
        assert sm2.state == "FAILED"
        assert sm2.error_code == "EXCEEDED_QUEUED_TIME_LIMIT"
        assert coord._m_deadline.value("queued_time") >= 1

        conn.gate.set()
        sm1 = _await_query(runner, q1)
        assert sm1.state == "FINISHED", f"q1 {sm1.state}: {sm1.error}"
        assert coord.queries[q1]["result"] == [(expect,)]
    finally:
        conn.gate.set()
        runner.stop()


# --------------------------------------------------------------- speculation


def test_speculation_backup_wins(tmp_path):
    """Under retry_policy=TASK with speculation enabled, a SLOW straggler
    gets a backup attempt on the other worker; exactly one attempt commits
    and the query returns well before the fault duration."""
    conn = MemoryConnector()
    expect = _make_tables(conn)
    runner = _start_cluster(conn, tmp_path, heartbeat=0.2)
    coord = runner.coordinator
    gate = _gated_sleeps(runner.workers[0])
    try:
        assert runner.query(JOIN_SQL) == [(expect,)]

        # whole-task speculation is the machinery under test; split-driven
        # stages (the default since the storage-governance release) handle
        # stragglers by split STEALING instead and never speculate, so this
        # test pins the classic whole-scan path
        coord.session.set("split_driven_scans", "false")
        coord.session.set("speculation_enabled", "true")
        coord.session.set("speculation_quantile", "1.5")
        runner.inject_task_failure(worker_index=0, mode="SLOW",
                                   delay_ms=60_000, count=1)
        assert runner.query(JOIN_SQL) == [(expect,)]
        # the straggler is still asleep: it was speculated, not waited out
        assert not gate.is_set()
        gate.set()
        spec = coord._m_speculative
        assert spec.value("launched") >= 1, "no backup attempt launched"
        assert spec.value("won") + spec.value("lost") >= 1
        # exactly-once: the losing attempt must not have left a second
        # commit or a staging dir behind
        leftovers = [n for n in os.listdir(tmp_path) if ".tmp-" in n]
        assert not leftovers, f"staging dirs leaked: {leftovers}"
    finally:
        gate.set()
        runner.stop()


# --------------------------------------------------------------- shedding


def test_load_shedding_429():
    """Past dispatch_queue_limit active queries, POST /v1/statement is
    answered 429 + Retry-After before resource-group admission; a client
    honoring the backpressure succeeds once load clears."""
    conn = GatedMemoryConnector()
    expect = _make_tables(conn)
    runner = _start_cluster(conn, heartbeat=0.2)
    coord = runner.coordinator
    try:
        coord.session.set("dispatch_queue_limit", "1")
        conn.gated_table = "probe"
        client = StatementClient(coord.url)
        client.submit(JOIN_SQL)  # fills the only dispatch slot
        assert _wait(lambda: conn.entered > 0, 60), "q1 never started"

        req = urllib.request.Request(
            f"{coord.url}/v1/statement", data=JOIN_SQL.encode()
        )
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10)
        assert ei.value.code == 429
        assert ei.value.headers.get("Retry-After")
        ei.value.read()
        assert coord._m_shed.value() >= 1

        # a backpressure-aware client rides out the shed window
        threading.Timer(0.5, conn.gate.set).start()
        patient = StatementClient(coord.url, shed_retries=30)
        _, rows = patient.execute(JOIN_SQL, timeout=120)
        assert [tuple(r) for r in rows] == [(expect,)]
    finally:
        conn.gate.set()
        runner.stop()


# --------------------------------------------------------------- spool


def test_spool_first_commit_wins(tmp_path):
    """Two attempts of the same task commit concurrently-ish: the first
    rename wins, the second returns False and leaves no staging dir."""
    from trino_tpu_torch.runtime.spool import SpooledExchange

    spool = SpooledExchange(str(tmp_path))
    assert spool.commit_task("q1_t0", {0: [b"winner"]}, attempt="0") is True
    assert spool.commit_task("q1_t0", {0: [b"loser"]}, attempt="s1") is False
    assert spool.read_chunks("q1_t0", 0) == [b"winner"]
    assert not [n for n in os.listdir(tmp_path) if ".tmp-" in n]


def test_spool_remove_query_prefix_safe(tmp_path):
    """remove_query("q1") must not eat q10's output (prefix collision)."""
    from trino_tpu_torch.runtime.spool import SpooledExchange

    spool = SpooledExchange(str(tmp_path))
    spool.commit_task("q1_t0", {0: [b"one"]})
    spool.commit_task("q10_t0", {0: [b"ten"]})
    spool.remove_query("q1")
    assert not spool.is_committed("q1_t0")
    assert spool.is_committed("q10_t0")
    assert spool.read_chunks("q10_t0", 0) == [b"ten"]
