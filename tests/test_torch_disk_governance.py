"""The port's storage-pressure survivability (runtime/disk.py + the
self-healing spool); ports of the 18 cases of tests/test_disk_governance.py,
every node on the CPU: disk-pool lease accounting, the refresh -> reclaim -> block ->
typed-shed escalation, ENOSPC conversion at the single write gate, the
adopt-pin vs reclaim race, and the cluster-level chaos contracts —
DISK_FULL on one node rotates work away via task retry, SPOOL_LOST on a
committed partition drives a producer REPRODUCTION under
first-commit-wins, and neither ever surfaces to the client.

Fast unit tests run in tier-1; the cluster drills are slow+chaos, as in
the reference (CHAOS_SF cranks the at-scale drill).
"""

import os
import threading
import time

import numpy as np
import pytest

try:  # arrow before torch: loaded after it, arrow's parquet writer crashes the process
    import pyarrow  # noqa: F401
except ImportError:
    pass
import torch

from trino_tpu_torch.runtime.disk import (
    EXCEEDED_SPILL_LIMIT,
    DiskExceeded,
    NodeDiskPool,
    guarded_write,
)
from trino_tpu_torch.runtime.spool import SpooledExchange, _pin, _unpin


# ---------------------------------------------------------------- helpers


def _wait(pred, timeout=30.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return bool(pred())


# ------------------------------------------------- disk pool lease plane


def test_reserve_release_accounting():
    pool = NodeDiskPool(100)
    a = pool.reserve("q1_t0", 40)
    b = pool.reserve("q1_t1", 30)
    assert pool.reserved == 70 and pool.peak == 70
    a.release()
    a.release()  # idempotent: finish and delete may both release
    assert pool.reserved == 30
    b.release()
    assert pool.reserved == 0 and pool.peak == 70


def test_oversized_reservation_sheds_typed():
    pool = NodeDiskPool(100)
    with pytest.raises(DiskExceeded) as ei:
        pool.reserve("q1_t0", 101, timeout_s=5.0)
    assert EXCEEDED_SPILL_LIMIT in str(ei.value)
    assert pool.sheds == 1
    assert pool.reserved == 0  # nothing leaked


def test_block_until_peer_release():
    pool = NodeDiskPool(100)
    held = pool.reserve("q1_t0", 80)
    threading.Timer(0.2, held.release).start()
    t0 = time.monotonic()
    lease = pool.reserve("q2_t0", 60, timeout_s=10.0)
    assert time.monotonic() - t0 >= 0.1  # it actually parked
    assert pool.blocked_ms_total > 0
    assert pool.reserved == 60
    lease.release()


def test_blocked_timeout_sheds_typed():
    pool = NodeDiskPool(100)
    pool.reserve("q1_t0", 80)
    with pytest.raises(DiskExceeded) as ei:
        pool.reserve("q2_t0", 60, timeout_s=0.2)
    assert "disk_blocked_timeout_s exceeded" in str(ei.value)
    assert EXCEEDED_SPILL_LIMIT in str(ei.value)


def test_refresh_harvests_deleted_path_leases(tmp_path):
    """A lease whose backing path another actor deleted (spool GC,
    remove_query, consumer ack) returns its bytes at the next pressure
    event — no cross-actor release plumbing."""
    pool = NodeDiskPool(100)
    gone = tmp_path / "q1_t0"
    gone.write_bytes(b"x" * 10)
    pool.reserve("q1_t0", 90, path=str(gone))
    os.remove(gone)  # out-of-band deletion
    # full pool, but refresh harvests the dead lease instead of blocking
    lease = pool.reserve("q2_t0", 50, timeout_s=5.0)
    assert pool.reserved == 50
    lease.release()


def test_release_prefix_frees_only_that_query(tmp_path):
    pool = NodeDiskPool(100)
    pool.reserve("q1_a0_f0_p0_t0", 30)
    pool.reserve("q1_a0_f1_p0_t1", 30)
    keep = pool.reserve("q2_a0_f0_p0_t0", 30)
    assert pool.release_prefix("q1") == 60
    assert pool.reserved == 30
    keep.release()


def test_set_capacity_shrink_and_grow():
    pool = NodeDiskPool(100)
    pool.reserve("q1_t0", 50)
    pool.set_capacity(40)  # DISK_FULL chaos: below current reservations
    with pytest.raises(DiskExceeded):
        pool.reserve("q2_t0", 10, timeout_s=0.2)
    got: list = []

    def blocked_writer():
        got.append(pool.reserve("q2_t0", 10, timeout_s=30.0))

    th = threading.Thread(target=blocked_writer, daemon=True)
    th.start()
    assert _wait(lambda: pool.blocked == 1, timeout=5.0)
    pool.set_capacity(100)  # growing wakes the parked writer
    th.join(timeout=5.0)
    assert got and pool.reserved == 60


def test_guarded_write_converts_enospc(tmp_path, monkeypatch):
    import builtins
    import errno

    path = str(tmp_path / "chunk.bin")
    assert guarded_write(path, b"abc") == 3  # the happy path writes

    real_open = builtins.open

    def full_disk(p, *a, **k):
        if str(p) == path:
            raise OSError(errno.ENOSPC, "No space left on device")
        return real_open(p, *a, **k)

    monkeypatch.setattr(builtins, "open", full_disk)
    with pytest.raises(DiskExceeded) as ei:
        guarded_write(path, b"abcdef")
    assert "ENOSPC" in str(ei.value) and EXCEEDED_SPILL_LIMIT in str(ei.value)
    monkeypatch.undo()
    assert not os.path.exists(path)  # the partial file was removed


# ------------------------------------- pressure reclaim escalation order


def _committed(spool, task_id, nbytes):
    assert spool.commit_task(task_id, {0: [b"x" * nbytes]})
    return os.path.join(spool.dir, task_id)


def test_reclaim_evicts_memo_before_nonlive_never_live(tmp_path):
    """The escalation a full pool runs before any writer blocks: fragment
    memo namespaces first (a cache), then non-live query dirs — and a
    LIVE query's dirs are untouchable no matter the pressure."""
    d = str(tmp_path / "spool")
    spool = SpooledExchange(d)
    memo = _committed(spool, "memo_k1_p0", 40)
    dead = _committed(spool, "dead_a0_f0_p0_t0", 40)
    live = _committed(spool, "live_a0_f0_p0_t0", 40)
    os.utime(memo, (1, 1))  # oldest; deterministic eviction order
    os.utime(dead, (2, 2))

    freed = spool.reclaim(10, live_query_ids=["live"])
    assert freed >= 40
    assert not os.path.exists(memo)  # memo evicted FIRST...
    assert os.path.exists(dead)  # ...and nothing more than needed

    freed = spool.reclaim(10, live_query_ids=["live"])
    assert freed >= 40
    assert not os.path.exists(dead)  # escalated to non-live dirs

    assert spool.reclaim(10, live_query_ids=["live"]) == 0
    assert os.path.exists(live)  # live is never evictable


def test_worker_side_reclaim_stops_after_memo(tmp_path):
    """A worker cannot know fleet-wide liveness, so its reclaim call
    (live_query_ids=None) must stop after memo namespaces."""
    d = str(tmp_path / "spool")
    spool = SpooledExchange(d)
    memo = _committed(spool, "memo_k1_p0", 40)
    q = _committed(spool, "q_a0_f0_p0_t0", 40)
    assert spool.reclaim(1000, live_query_ids=None) >= 40
    assert not os.path.exists(memo)
    assert os.path.exists(q)  # only the coordinator may evict query dirs


def test_pool_reclaimer_escalation_frees_a_blocked_commit(tmp_path):
    """End-to-end: a commit against a FULL pool runs the spool's reclaim
    (memo eviction), the refresh pass harvests the evicted dirs' leases,
    and the commit lands — no block, no shed."""
    d = str(tmp_path / "spool")
    pool = NodeDiskPool(100)
    spool = SpooledExchange(d, disk_pool=pool)
    spool.disk_blocked_timeout_s = 5.0
    assert spool.commit_task("memo_k1_p0", {0: [b"x" * 80]})
    assert pool.reserved == 80
    # pool is near-full; the next commit's reserve must evict the memo
    assert spool.commit_task("q_a0_f0_p0_t0", {0: [b"y" * 60]})
    assert not os.path.exists(os.path.join(d, "memo_k1_p0"))
    assert os.path.exists(os.path.join(d, "q_a0_f0_p0_t0", "COMMITTED"))
    assert pool.reserved == 60


def test_adopt_pin_blocks_reclaim_and_gc(tmp_path):
    """Race regression: a spool dir mid-adoption (a fleet peer renaming a
    dead coordinator's task output to its own query id) is PINNED — a
    concurrent pressure reclaim or gc sweeping 'non-live' dirs must skip
    it, else the adopter re-reads a deleted partition."""
    d = str(tmp_path / "spool")
    spool = SpooledExchange(d)
    path = _committed(spool, "orphan_a0_f0_p0_t0", 40)
    _pin(d, "orphan_a0_f0_p0_t0")
    try:
        # neither pressure reclaim nor the age-based sweep may touch it
        assert spool.reclaim(1000, live_query_ids=[]) == 0
        spool.gc([], age_s=0.0)
        assert os.path.exists(path)
    finally:
        _unpin(d, "orphan_a0_f0_p0_t0")
    # unpinned, the same pressure call evicts it
    assert spool.reclaim(1000, live_query_ids=[]) >= 40
    assert not os.path.exists(path)


def test_adopt_itself_pins_across_the_rename(tmp_path):
    """The public adopt() path pins old+new names for the rename window
    and unpins after — the dir survives under its new name."""
    d = str(tmp_path / "spool")
    spool = SpooledExchange(d)
    _committed(spool, "dead_a0_f0_p0_t0", 40)
    assert spool.adopt("dead_a0_f0_p0_t0", "heir_a0_f0_p0_t0")
    assert spool.is_committed("heir_a0_f0_p0_t0")
    # pins were released: the adopted dir is evictable once non-live again
    assert spool.reclaim(1000, live_query_ids=[]) >= 40


# ------------------------------------------------------- cluster contracts


def _mem_catalog(rows=20000, groups=50):
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.connectors.spi import ColumnSchema
    from trino_tpu_torch.data.types import BIGINT

    conn = MemoryConnector()
    conn.create_table(
        "t", [ColumnSchema("k", BIGINT), ColumnSchema("v", BIGINT)]
    )
    rng = np.random.default_rng(7)
    conn.insert("t", {
        "k": rng.integers(0, groups, rows).astype(np.int64),
        "v": rng.integers(0, 100, rows).astype(np.int64),
    })
    return conn


def _storage_cluster(tmp_path, disk_budget_bytes=64 << 20, workers=2):
    from trino_tpu_torch.testing import DistributedQueryRunner

    runner = DistributedQueryRunner(
        device="cpu", num_workers=workers,
        default_catalog="mem",
        heartbeat_interval=0.2,
        disk_budget_bytes=disk_budget_bytes,
    )
    runner.register_catalog("mem", _mem_catalog())
    runner.start()
    s = runner.coordinator.session
    s.set("retry_policy", "TASK")
    s.set("exchange_spool_dir", str(tmp_path / "spool"))
    # repeated identical SQL must actually RE-RUN (the drills below run
    # the same query clean-then-chaotic and need fresh spool commits)
    s.set("result_cache_enabled", "false")
    for w in runner.workers:
        w.disk_blocked_timeout_s = 0.5  # fast block->shed in tests
    return runner


SQL = "select k, sum(v) from t group by k order by k"


@pytest.mark.slow
@pytest.mark.chaos
def test_gc_pressure_reclaim_respects_fleet_live_union(tmp_path):
    """The coordinator's heartbeat-driven pressure reclaim passes the
    LOCAL ∪ FLEET live set: a PEER coordinator's running query — live
    only in the fleet lease files — must survive the sweep while a
    dead query's dirs are evicted."""
    runner = _storage_cluster(tmp_path)
    try:
        coord = runner.coordinator
        d = str(tmp_path / "spool")
        spool = SpooledExchange(d)
        peer = _committed(spool, "peer_a0_f0_p0_t0", 40)
        dead = _committed(spool, "dead_a0_f0_p0_t0", 40)

        class FakeFleet:
            def is_gc_owner(self):
                return True

            def fleet_live_queries(self):
                return {"peer"}  # live on a PEER member only

        coord.fleet = FakeFleet()
        try:
            # fake a pressure heartbeat: one node's pool is >80% used
            w = next(iter(coord.workers.values()))
            w.disk = {"capacity": 100, "reserved": 95}
            coord._gc_spool()
        finally:
            coord.fleet = None
        assert os.path.exists(peer), "evicted a fleet-live query's spool"
        assert not os.path.exists(dead), "pressure reclaim never ran"
    finally:
        runner.stop()


@pytest.mark.slow
@pytest.mark.chaos
def test_disk_full_one_node_query_survives(tmp_path):
    """DISK_FULL shrinks one worker's pool mid-run: every spool commit
    there reclaims, blocks 0.5s, then sheds typed — task retry rotates
    the attempts to the healthy node and the CLIENT sees only rows."""
    runner = _storage_cluster(tmp_path)
    try:
        clean = runner.query(SQL)
        runner.disk_full(0, capacity_bytes=64)  # far below any commit
        assert runner.query(SQL) == clean
        pool = runner.workers[0].disk_pool
        assert pool.sheds >= 1, "the shrunk pool never actually shed"
        # the typed error stayed inside the retry loop: the record shows a
        # finished query, not a failure
        rec = list(runner.coordinator.queries.values())[-1]
        assert rec["sm"].state == "FINISHED"
    finally:
        runner.stop()


@pytest.mark.slow
@pytest.mark.chaos
def test_spool_lost_drives_reproduction(tmp_path):
    """SPOOL_LOST deletes committed partitions right before consumers
    read them; the coordinator parses the typed marker, re-runs each
    producer under first-commit-wins, and the query succeeds with
    spool_reproductions > 0 (the self-healing metric)."""
    runner = _storage_cluster(tmp_path)
    try:
        clean = runner.query(SQL)
        before = runner.coordinator._m_spool_repro.value()
        for i in range(len(runner.workers)):
            runner.inject_task_failure(i, mode="SPOOL_LOST")
        assert runner.query(SQL) == clean
        rec = list(runner.coordinator.queries.values())[-1]
        repro = rec.get("spool_reproductions", 0)
        assert repro >= 1, "no producer was ever reproduced"
        limit = int(runner.coordinator.session.get("spool_reproduce_limit"))
        assert repro <= limit, f"reproductions {repro} exceeded the bound"
        assert runner.coordinator._m_spool_repro.value() - before == repro
    finally:
        for w in runner.workers:
            w.fault_injector.clear()
        runner.stop()


@pytest.mark.slow
@pytest.mark.chaos
def test_spool_lost_out_of_band_deletion_heals(tmp_path, monkeypatch):
    """No injector at all: an operator (or a dying disk) rm -rf's a
    committed partition the instant it lands — the consumer (or root)
    fetch hits the hole and the coordinator reproduces the producer.
    The deletion rides a commit hook rather than a polling thread so the
    drill bites deterministically (a 20k-row query commits and cleans up
    faster than any filesystem poller can observe)."""
    import shutil

    runner = _storage_cluster(tmp_path)
    try:
        clean = runner.query(SQL)
        spool_dir = str(tmp_path / "spool")
        victim: list = []
        lock = threading.Lock()
        orig_commit = SpooledExchange.commit_task

        def commit_then_reap(self, task_id, buffers, attempt="0"):
            out = orig_commit(self, task_id, buffers, attempt=attempt)
            with lock:
                first = not victim
                if first:
                    victim.append(task_id)
            if first:
                # out-of-band: straight rm -rf on the committed dir, no
                # injector — the reproduced attempt re-commits unmolested
                shutil.rmtree(
                    os.path.join(spool_dir, task_id), ignore_errors=True
                )
            return out

        monkeypatch.setattr(SpooledExchange, "commit_task", commit_then_reap)
        rows = runner.query(SQL)
        assert rows == clean
        assert victim, "nothing ever committed — the drill never bit"
        rec = list(runner.coordinator.queries.values())[-1]
        assert rec["sm"].state == "FINISHED"
    finally:
        runner.stop()


@pytest.mark.slow
@pytest.mark.chaos
def test_storage_chaos_drill_tpch(tmp_path, tpch_tiny, oracle):
    """The acceptance drill: TPC-H under seeded schedules drawn from
    RECOVERABLE + STORAGE modes with split_driven_scans on — SPOOL_LOST
    and DISK_FULL both fire across the run, results stay
    oracle-identical, zero client-visible failures, and
    spool_reproductions_total moved.  CHAOS_SF cranks the data scale
    (CI runs the tiny tier; the sf10 bar runs on big hosts)."""
    from tests.oracle import assert_rows_equal
    from tests.tpch_queries import ORDERED, QUERIES
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.testing.chaos import (
        RECOVERABLE_MODES,
        STORAGE_MODES,
        make_chaos_cluster,
    )

    sf = float(os.environ.get("CHAOS_SF", "0.01"))
    if sf != 0.01:
        # at-scale run: the session oracle holds sf0.01 — rebuild it over
        # the same generated data at the requested scale
        from tests.oracle import SqliteOracle
        from trino_tpu_torch.connectors.tpch import tpch_data
        from trino_tpu_torch.connectors.tpch.generator import TPCH_SCHEMAS

        oracle = SqliteOracle({t: tpch_data(t, sf) for t in TPCH_SCHEMAS})
    budget = 256 << 20
    runner, chaos = make_chaos_cluster(
        device="cpu", catalog_factory=lambda: TpchConnector(sf), num_workers=2, seed=4242,
        modes=RECOVERABLE_MODES + STORAGE_MODES,
        disk_budget_bytes=budget,
    )
    s = runner.coordinator.session
    s.set("exchange_spool_dir", str(tmp_path / "spool"))
    s.set("split_driven_scans", "true")
    for w in runner.workers:
        w.disk_blocked_timeout_s = 0.5
    try:
        before = runner.coordinator._m_spool_repro.value()
        for name in ("q01", "q03", "q06", "q13"):
            sql = QUERIES[name]
            # guarantee the storage modes bite at least once per query on
            # top of whatever the seeded schedule draws
            runner.inject_task_failure(0, mode="SPOOL_LOST")
            runner.disk_full(1, capacity_bytes=1 << 20)
            got = chaos.run_query(sql)
            assert_rows_equal(got, oracle.query(sql), ordered=ORDERED[name])
            for w in runner.workers:  # DISK_FULL shrink persists; reset
                if w.disk_pool is not None:
                    w.disk_pool.set_capacity(budget)
        assert runner.coordinator._m_spool_repro.value() > before, (
            "SPOOL_LOST fired but nothing was ever reproduced"
        )
    finally:
        runner.stop()
