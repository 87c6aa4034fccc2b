"""The port's cluster memory governance: node pools, blocked-on-memory,
revocation, low-memory killer — plus end-to-end page integrity.  Ports of
the 17 cases of tests/test_memory_governance.py, every node on the CPU
(`device="cpu"`); rows are held against numpy sums.  One case of the port's
own: a revocation also gives back the worker's cached columns.

Reference behaviors being matched:
- memory/ClusterMemoryManager.java:92 + TotalReservationLowMemoryKiller: a
  node over budget past the killer delay loses the query with the largest
  cluster-wide total reservation, with a typed CLUSTER_OUT_OF_MEMORY error.
- lib/trino-memory-context LocalMemoryContext.java:31: setBytes against a
  full pool returns a non-immediate future — the task parks BLOCKED and
  resumes when a peer frees bytes.
- Revocable memory + spill: before killing anything, revocable leases are
  force-spilled (the worker honors the shrunken lease with sliced
  out-of-core execution, exec/spill.py's idiom) so both queries finish.
- serde/PagesSerdeUtil page checksums: every wire chunk carries a crc32
  frame; a flipped bit anywhere surfaces as PAGE_TRANSPORT_ERROR and the
  fetch retries from its token instead of producing wrong rows.
"""

import threading
import time

import numpy as np
import pytest

try:  # arrow before torch: loaded after it, arrow's parquet writer crashes the process
    import pyarrow  # noqa: F401
except ImportError:
    pass
import torch

from trino_tpu_torch.connectors.memory import MemoryConnector
from trino_tpu_torch.connectors.spi import ColumnSchema
from trino_tpu_torch.data.types import BIGINT
from trino_tpu_torch.runtime import memory as memory_mod
from trino_tpu_torch.runtime.memory import (
    ClusterMemoryManager,
    MemoryExceeded,
    NodeMemoryPool,
    QueryMemoryPool,
)
from trino_tpu_torch.runtime.spool import SpooledExchange
from trino_tpu_torch.runtime.wire import (
    FRAME_MAGIC,
    PageTransportError,
    frame_chunk,
    unframe_chunk,
)
from trino_tpu_torch.testing import DistributedQueryRunner

pytestmark = pytest.mark.smoke


@pytest.fixture(autouse=True)
def _whole_scan_tasks(monkeypatch):
    """This file asserts the classic whole-scan memory plane: eager
    round-robin task dispatch (every worker gets a task whose lease the
    asserts watch) and REVOKE_SPILL_PARTS sliced re-execution under a
    revoked lease.  split_driven_scans — ON by default since the
    storage-governance release — replaces both with morsel scheduling
    (lazy least-loaded placement, parked revocations), whose memory
    interactions tests/test_splits.py covers.  Pin the classic path."""
    import dataclasses

    from trino_tpu_torch.runtime import session as session_mod

    monkeypatch.setitem(
        session_mod.PROPERTIES,
        "split_driven_scans",
        dataclasses.replace(
            session_mod.PROPERTIES["split_driven_scans"], default=False
        ),
    )


def _wait(pred, timeout=30.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            return False
        time.sleep(interval)
    return True


# ------------------------------------------------------ page integrity (unit)


def test_frame_roundtrip_and_corruption_detection():
    blob = b"some serialized page bytes" * 17
    framed = frame_chunk(blob)
    assert framed[:4] == FRAME_MAGIC
    assert unframe_chunk(framed) == blob

    # flip one payload byte: crc must catch it, with the typed error code
    mut = bytearray(framed)
    mut[len(mut) // 2] ^= 0xFF
    with pytest.raises(PageTransportError, match=r"\[PAGE_TRANSPORT_ERROR\]"):
        unframe_chunk(bytes(mut))

    # flip a checksum byte: same
    mut = bytearray(framed)
    mut[5] ^= 0x01
    with pytest.raises(PageTransportError):
        unframe_chunk(bytes(mut))

    # truncated / foreign bytes are rejected, not misread
    with pytest.raises(PageTransportError):
        unframe_chunk(framed[:6])
    with pytest.raises(PageTransportError):
        unframe_chunk(b"XXXX" + framed[4:])


def test_spool_read_verifies_frame(tmp_path):
    """Silent disk corruption of a committed spool chunk surfaces as a typed
    PAGE_TRANSPORT_ERROR at read time, never as wrong rows."""
    spool = SpooledExchange(str(tmp_path))
    good = frame_chunk(b"payload bytes for buffer zero" * 9)
    assert spool.commit_task("q1_a0_f0_t0", {0: [good]})
    assert spool.read_chunks("q1_a0_f0_t0", 0) == [good]

    path = spool.chunk_path("q1_a0_f0_t0", 0, 0)
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(raw))
    with pytest.raises(PageTransportError, match="spool chunk"):
        spool.read_chunks("q1_a0_f0_t0", 0)


# -------------------------------------------------------- node pool (unit)


def test_blocked_reserve_unblocks_on_peer_free():
    pool = NodeMemoryPool(1000)
    a = pool.reserve("qa", 800)
    got = {}
    blocked_seen = threading.Event()

    def second():
        got["lease"] = pool.reserve(
            "qb", 500, on_block=lambda: blocked_seen.set()
        )

    t = threading.Thread(target=second, daemon=True)
    t.start()
    assert blocked_seen.wait(5), "second reservation never parked"
    assert _wait(lambda: pool.blocked == 1, 5)
    assert "lease" not in got  # genuinely parked, not failed

    a.release()  # peer frees -> waiter resumes
    t.join(timeout=10)
    assert not t.is_alive(), "blocked reservation never resumed"
    assert pool.blocked == 0
    assert pool.reserved == 500
    assert pool.blocked_ms_total > 0  # the wait was measured
    got["lease"].release()
    assert pool.reserved == 0


def test_blocked_reserve_timeout_escalates():
    pool = NodeMemoryPool(100)
    hold = pool.reserve("qa", 100)
    with pytest.raises(MemoryExceeded, match="memory_blocked_timeout_s"):
        pool.reserve("qb", 50, timeout_s=0.15)
    hold.release()


def test_reserve_larger_than_pool_fails_fast():
    pool = NodeMemoryPool(100)
    # waiting can never succeed: no timeout needed, immediate escalation
    with pytest.raises(MemoryExceeded):
        pool.reserve("qa", 101, timeout_s=None)


def test_blocked_reserve_aborts_with_task_cancel():
    pool = NodeMemoryPool(100)
    hold = pool.reserve("qa", 100)
    canceled = threading.Event()
    err = []

    def second():
        try:
            pool.reserve("qb", 50, abort=canceled.is_set)
        except RuntimeError as e:
            err.append(e)

    t = threading.Thread(target=second, daemon=True)
    t.start()
    assert _wait(lambda: pool.blocked == 1, 5)
    canceled.set()
    t.join(timeout=10)
    assert err and "canceled" in str(err[0])
    assert pool.blocked == 0
    hold.release()


def test_revoke_query_shrinks_revocable_and_wakes_waiters():
    pool = NodeMemoryPool(1000)
    revoked = threading.Event()
    pool.reserve("qa", 800, revocable=True, on_revoke=revoked.set)
    b = pool.reserve("qb", 100)  # non-revocable, different query

    freed = pool.revoke_query("qa", spill_parts=4)
    assert freed == 800 - 800 // 4
    assert revoked.is_set()
    assert pool.revocations == 1
    snap = pool.snapshot()
    assert snap["by_query"]["qa"]["reserved"] == 200
    assert snap["by_query"]["qa"]["revocable"] == 0  # already revoked
    assert snap["by_query"]["qb"] == {"reserved": 100, "revocable": 0}
    # idempotent: nothing left to revoke for qa, qb is not revocable
    assert pool.revoke_query("qa") == 0
    assert pool.revoke_query("qb") == 0
    b.release()


def test_memory_pressure_shrink_marks_pool_over_budget():
    pool = NodeMemoryPool(1000)
    pool.reserve("qa", 800)
    pool.set_capacity(300)  # MEMORY_PRESSURE chaos lever
    snap = pool.snapshot()
    assert snap["reserved"] > snap["capacity"]  # the killer's over signal


def test_free_underflow_counted_not_masked(capsys):
    before = memory_mod._UNDERFLOWS.value()
    qp = QueryMemoryPool(budget=1000, name="underflow-test")
    qp.reserve(100)
    qp.free(150)  # double-free: 50 bytes more than reserved
    assert qp.used == 0  # balance still floors at zero...
    assert memory_mod._UNDERFLOWS.value() == before + 1  # ...but counted
    assert "underflow" in capsys.readouterr().err

    npool = NodeMemoryPool(1000, name="underflow-node")
    npool.reserve("qa", 100).detach()
    npool.free("qa", 150)
    assert npool.reserved == 0
    assert memory_mod._UNDERFLOWS.value() == before + 2


def test_query_pool_layers_under_node_pool():
    node = NodeMemoryPool(1000)
    qp = QueryMemoryPool(budget=600, parent=node, query_id="qa")
    qp.reserve(400)
    assert node.reserved == 400
    with pytest.raises(MemoryExceeded):  # query budget first
        qp.reserve(300)
    assert node.reserved == 400  # failed reserve did not leak into the node
    qp.free(400)
    assert node.reserved == 0 and qp.used == 0


# ------------------------------------------- cluster memory manager (unit)


def test_cluster_manager_escalates_revoke_then_kill():
    t = [0.0]
    mgr = ClusterMemoryManager(clock=lambda: t[0])
    snap = {
        "w1": {
            "capacity": 100, "reserved": 150, "blocked": 1,
            "by_query": {
                "qa": {"reserved": 100, "revocable": 80},
                "qb": {"reserved": 50, "revocable": 0},
            },
        }
    }
    # pressure must PERSIST past the delay before anything fires
    assert mgr.sweep(snap, killer_delay_s=5.0) == []
    t[0] = 6.0
    acts = mgr.sweep(snap, killer_delay_s=5.0)
    assert acts == [
        {"action": "revoke", "node": "w1", "query_id": "qa", "bytes": 80}
    ]
    # the revoke resets the clock: the spill gets a delay window to land
    assert mgr.sweep(snap, killer_delay_s=5.0) == []
    # nothing revocable (or revocation disabled) -> kill, not revoke
    t[0] = 12.0
    acts = mgr.sweep(snap, killer_delay_s=5.0, revocation_enabled=False)
    assert acts == [{"action": "kill", "query_id": "qa", "bytes": 100}]


def test_killer_victim_is_largest_total_reservation():
    t = [0.0]
    mgr = ClusterMemoryManager(clock=lambda: t[0])
    snaps = {
        "w1": {
            "capacity": 100, "reserved": 120, "blocked": 0,
            "by_query": {
                "qa": {"reserved": 70, "revocable": 0},
                "qb": {"reserved": 50, "revocable": 0},
            },
        },
        "w2": {
            "capacity": 100, "reserved": 80, "blocked": 0,
            "by_query": {"qb": {"reserved": 80, "revocable": 0}},
        },
    }
    mgr.sweep(snaps, killer_delay_s=1.0, revocation_enabled=False)
    t[0] = 2.0
    acts = mgr.sweep(snaps, killer_delay_s=1.0, revocation_enabled=False)
    # qb holds less than qa ON the pressured node, but 130 bytes cluster-wide
    # (Trino's TotalReservationLowMemoryKiller picks the cluster total)
    assert acts == [{"action": "kill", "query_id": "qb", "bytes": 130}]


def test_cluster_manager_pressure_clears_when_node_recovers():
    t = [0.0]
    mgr = ClusterMemoryManager(clock=lambda: t[0])
    over = {"w1": {"capacity": 100, "reserved": 150, "blocked": 0,
                   "by_query": {"qa": {"reserved": 150, "revocable": 0}}}}
    ok = {"w1": {"capacity": 100, "reserved": 50, "blocked": 0,
                 "by_query": {"qa": {"reserved": 50, "revocable": 0}}}}
    mgr.sweep(over, killer_delay_s=5.0)
    t[0] = 3.0
    mgr.sweep(ok, killer_delay_s=5.0)  # recovered: timer resets
    t[0] = 6.0
    assert mgr.sweep(over, killer_delay_s=5.0) == []  # fresh window


# ------------------------------------------------------------- e2e clusters


def _make_probe(conn, rows=2000):
    conn.create_table(
        "probe", [ColumnSchema("k", BIGINT), ColumnSchema("v", BIGINT)]
    )
    conn.insert("probe", {
        "k": np.arange(rows, dtype=np.int64) % 50,
        "v": np.arange(rows, dtype=np.int64),
    })
    return int(np.arange(rows).sum())


def _make_join_tables(conn):
    conn.create_table(
        "build", [ColumnSchema("k", BIGINT), ColumnSchema("w", BIGINT)]
    )
    conn.insert("build", {
        "k": np.arange(50, dtype=np.int64),
        "w": np.arange(50, dtype=np.int64) * 10,
    })
    expect_probe = _make_probe(conn)
    return expect_probe + int(((np.arange(2000) % 50) * 10).sum())


AGG_SQL = "select sum(v) from probe"
JOIN_SQL = "select sum(v + w) from probe, build where probe.k = build.k"


def _governed_cluster(conn, node_bytes, reserve, killer_delay="0.3"):
    # 2 workers: single-worker plans collapse into the coordinator-local
    # result fragment and never touch a node pool
    runner = DistributedQueryRunner(
        device="cpu", num_workers=2, default_catalog="memory",
        heartbeat_interval=0.1, node_memory_bytes=node_bytes,
    )
    runner.register_catalog("memory", conn)
    runner.start()
    coord = runner.coordinator
    coord.session.set("retry_policy", "TASK")
    coord.session.set("task_memory_reserve_bytes", str(reserve))
    coord.session.set("low_memory_killer_delay_s", killer_delay)
    coord.session.set("memory_blocked_timeout_s", "30")
    return runner


def _await(runner, qid, timeout=120.0):
    sm = runner.coordinator.queries[qid]["sm"]
    assert _wait(lambda: sm.done, timeout), f"query stuck in {sm.state}"
    return sm


def test_revocation_spill_clears_pressure_without_kill():
    """Acceptance (a): two concurrent queries whose reservations exceed one
    worker's pool.  The first holds revocable state, so sustained pressure
    triggers REVOCATION (forced sliced/spilled execution) — both queries
    finish correctly, at least one revocation fires, nothing is killed."""
    conn = MemoryConnector()
    expect = _make_probe(conn)
    runner = _governed_cluster(conn, node_bytes=1000, reserve=600)
    coord = runner.coordinator
    try:
        # SLOW fires AFTER the reservation: the first query's scan task
        # holds its 600 bytes while sleeping — deterministic pressure
        runner.inject_task_failure(0, mode="SLOW", delay_ms=2500, count=1)
        qa = coord.submit_query(AGG_SQL)
        pool = runner.workers[0].memory_pool
        assert _wait(lambda: pool.reserved >= 600, 30), "qa never reserved"
        qb = coord.submit_query(AGG_SQL)  # 600 + 600 > 1000: qb parks

        assert _wait(lambda: pool.revocations >= 1, 30), (
            "pressure never triggered a revocation"
        )
        sm_a, sm_b = _await(runner, qa), _await(runner, qb)
        assert sm_a.state == "FINISHED", f"qa {sm_a.state}: {sm_a.error}"
        assert sm_b.state == "FINISHED", f"qb {sm_b.state}: {sm_b.error}"
        assert coord.queries[qa]["result"] == [(expect,)]
        assert coord.queries[qb]["result"] == [(expect,)]

        assert coord.oom_kills == 0, "revocation should have prevented kills"
        assert coord._m_revocations_requested.value() >= 1
        assert runner.workers[0]._m_revocations.value() >= 1
        assert pool.snapshot()["blocked_ms_total"] > 0  # qb really parked
    finally:
        runner.stop()


def test_revocation_gives_back_the_nodes_cached_columns():
    """Port extension: the node pool counts nominal bytes, the card holds
    real ones.  A revocation on a worker also drops the columns its scan
    cache holds (device memory, here host tensors), and both queries still
    finish correctly with no kill."""
    conn = MemoryConnector()
    expect = _make_probe(conn)
    runner = _governed_cluster(conn, node_bytes=1000, reserve=600)
    coord = runner.coordinator
    try:
        assert runner.query(AGG_SQL) == [(expect,)]  # warms the scan caches
        victim = runner.workers[0]
        assert victim.scan_cache.cols, "the warm run cached no column"
        runner.inject_task_failure(0, mode="SLOW", delay_ms=2500, count=1)
        qa = coord.submit_query(AGG_SQL)
        pool = victim.memory_pool
        assert _wait(lambda: pool.reserved >= 600, 30), "qa never reserved"
        qb = coord.submit_query(AGG_SQL)
        assert _wait(lambda: pool.revocations >= 1, 30), "no revocation"
        # the worker drops its cache just after the pool counts the revoke
        assert _wait(lambda: victim.revoked_device_bytes > 0, 10)
        sm_a, sm_b = _await(runner, qa), _await(runner, qb)
        assert (sm_a.state, sm_b.state) == ("FINISHED", "FINISHED")
        assert coord.queries[qa]["result"] == [(expect,)]
        assert coord.queries[qb]["result"] == [(expect,)]
        assert coord.oom_kills == 0
    finally:
        runner.stop()


def test_low_memory_killer_kills_largest_reservation():
    """Acceptance (b): same pressure with revocation DISABLED — exactly one
    query (the largest reservation holder) dies with a typed
    CLUSTER_OUT_OF_MEMORY error; the other completes correctly."""
    conn = MemoryConnector()
    expect = _make_probe(conn)
    runner = _governed_cluster(conn, node_bytes=1000, reserve=600)
    coord = runner.coordinator
    coord.session.set("memory_revocation_enabled", "false")
    try:
        runner.inject_task_failure(0, mode="SLOW", delay_ms=2500, count=1)
        qa = coord.submit_query(AGG_SQL)
        pool = runner.workers[0].memory_pool
        assert _wait(lambda: pool.reserved >= 600, 30), "qa never reserved"
        qb = coord.submit_query(AGG_SQL)

        sm_a, sm_b = _await(runner, qa), _await(runner, qb)
        assert sm_a.state == "FAILED", (
            f"killer never fired: qa {sm_a.state}"
        )
        assert "CLUSTER_OUT_OF_MEMORY" in (sm_a.error or "")
        assert sm_b.state == "FINISHED", f"qb {sm_b.state}: {sm_b.error}"
        assert coord.queries[qb]["result"] == [(expect,)]

        assert coord.oom_kills == 1, "exactly one victim"
        assert coord._m_oom_kills.value() == 1
        assert pool.revocations == 0  # revocation was disabled
    finally:
        runner.stop()


@pytest.mark.chaos
def test_corrupted_frames_detected_and_refetched():
    """CORRUPT chaos: served page frames get a flipped byte.  The consumer's
    crc32 check rejects them and re-fetches the same token — the query
    returns byte-correct results, never corrupted rows."""
    conn = MemoryConnector()
    expect = _make_join_tables(conn)
    runner = DistributedQueryRunner(
        device="cpu", num_workers=2, default_catalog="memory", heartbeat_interval=0.3
    )
    runner.register_catalog("memory", conn)
    runner.start()
    try:
        runner.coordinator.session.set("retry_policy", "TASK")
        from trino_tpu_torch.runtime import wire as wire_mod

        before = wire_mod._TRANSPORT_ERRORS.value()
        for i in range(2):
            runner.inject_task_failure(i, mode="CORRUPT", count=2)
        assert runner.query(JOIN_SQL) == [(expect,)]

        fired = {
            m for w in runner.workers for (m, _) in w.fault_injector.fired
        }
        assert "CORRUPT" in fired, "no frame was actually corrupted"
        assert wire_mod._TRANSPORT_ERRORS.value() > before, (
            "corruption was served but never detected"
        )

        # satellite: the distributed EXPLAIN ANALYZE memory line renders
        lines = [r[0] for r in runner.query("explain analyze " + JOIN_SQL)]
        assert any(
            "peak memory:" in ln and "blocked on memory:" in ln
            for ln in lines
        ), lines
    finally:
        runner.stop()


@pytest.mark.chaos
def test_memory_pressure_chaos_returns_correct_rows():
    """MEMORY_PRESSURE chaos on a 2-worker cluster: one worker's pool is
    shrunk mid-query below its live reservations (over-budget on the next
    heartbeats), then restored.  The query still returns correct rows and
    nothing is killed (the pressure window is shorter than the killer
    delay)."""
    conn = MemoryConnector()
    expect = _make_join_tables(conn)
    runner = DistributedQueryRunner(
        device="cpu", num_workers=2, default_catalog="memory",
        heartbeat_interval=0.2, node_memory_bytes=10_000,
    )
    runner.register_catalog("memory", conn)
    runner.start()
    coord = runner.coordinator
    try:
        coord.session.set("retry_policy", "TASK")
        coord.session.set("task_memory_reserve_bytes", "2000")
        # default low_memory_killer_delay_s (5s) >> the pressure window

        runner.inject_task_failure(0, mode="SLOW", delay_ms=1500, count=1)
        qid = coord.submit_query(JOIN_SQL)
        pool = runner.workers[0].memory_pool
        assert _wait(lambda: pool.reserved >= 2000, 30), "no reservation"

        runner.memory_pressure(0, 500)  # reserved 2000 > capacity 500
        assert pool.capacity == 500
        time.sleep(0.5)  # let heartbeats observe the over-budget node
        assert coord.workers[runner.workers[0].url].mem is not None
        runner.memory_pressure(0, 10_000)  # restore; waiters wake

        sm = _await(runner, qid)
        assert sm.state == "FINISHED", f"{sm.state}: {sm.error}"
        assert coord.queries[qid]["result"] == [(expect,)]
        assert coord.oom_kills == 0
        fired = {m for (m, _) in runner.workers[0].fault_injector.fired}
        assert "MEMORY_PRESSURE" in fired
    finally:
        runner.stop()
