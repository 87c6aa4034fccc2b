"""The port's write transactions (runtime/txn.py) on a plain engine, the
cases of tests/test_write_txn.py that need no coordinator or journal:
two-writer conflict arbitration with a retry, the exhausted conflict budget,
the staging gauge on commit and abort, the EXPLAIN ANALYZE `-- txn:` footer
of a write, and the engine-level fault cases (runtime/failure.py's
FaultInjector on `engine.write_fault_injector`): a commit crash at each
phase boundary leaves the pre-image XOR the post-image on memory, Parquet
and Iceberg tables, a write stall delays but commits, and a full disk pool
during staging aborts clean.  Then the seven coordinator cases, each on a
DistributedQueryRunner on the CPU with a journal: a coordinator crash at
the intent / commit boundary replays to a clean abort, a crash after the
commit replays as a no-op, the connector's commit marker wins over a lost
journal marker, a failed UPDATE leaves the result cache warm, and the
janitor reclaims orphaned staging and spares staging inside its grace."""

import socket
import threading
import time

import numpy as np
import pytest
try:  # arrow before torch: loaded after it, arrow's parquet writer crashes the process
    import pyarrow  # noqa: F401
except ImportError:
    pass
import torch

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _restore_kernel_policy():
    """Every port statement re-applies its session's kernel policy, which is
    process-global: put back what the next test in this worker expects."""
    from trino_tpu_torch.ops import kernels

    saved = kernels.get_policy()
    yield
    kernels.set_policy(saved)


def _seed(conn, n: int = 5):
    from trino_tpu_torch.connectors.spi import ColumnSchema
    from trino_tpu_torch.data.types import BIGINT

    conn.create_table("t", [ColumnSchema("k", BIGINT), ColumnSchema("v", BIGINT)])
    conn.insert("t", {"k": np.arange(n, dtype=np.int64),
                      "v": np.arange(n, dtype=np.int64) * 10})


def _engine(conn=None):
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.runtime.engine import Engine

    conn = conn if conn is not None else MemoryConnector()
    eng = Engine(default_catalog="memory", device="cpu")
    eng.register_catalog("memory", conn)
    return eng, conn


def _table_rows(conn):
    cols = conn.read_split(conn.get_splits("t", 1)[0], ["k", "v"])
    return sorted(zip(cols["k"].tolist(), cols["v"].tolist()))


def test_two_writer_conflict_retries_then_wins():
    from trino_tpu_torch.runtime.txn import TXN_TOTAL, run_write

    eng, conn = _engine()
    _seed(conn)
    rival, _ = _engine(conn)
    conflicts0 = TXN_TOTAL.value("conflict")
    fired = []

    def attempt(txn):
        # deterministic race: the rival commits between this writer's
        # snapshot and its commit, exactly once
        if not fired:
            fired.append(1)
            rival.execute("insert into t values (999, 9990)")
        txn.stage_insert({"k": np.array([50], dtype=np.int64),
                          "v": np.array([500], dtype=np.int64)})
        return 1

    assert run_write(eng, "memory", "t", "insert", attempt) == 1
    assert TXN_TOTAL.value("conflict") == conflicts0 + 1
    rows = _table_rows(conn)
    assert (50, 500) in rows and (999, 9990) in rows
    assert eng._last_txn_info["retries"] == 1
    assert eng._last_txn_info["outcome"] == "committed"
    assert eng.execute("select count(*), sum(v) from t") == [(7, 100 + 500 + 9990)]


def test_conflict_budget_exhausted_raises_typed_error():
    from trino_tpu_torch.runtime.txn import WriteConflict, run_write

    eng, conn = _engine()
    _seed(conn)
    rival, _ = _engine(conn)
    eng.session.set("write_conflict_retries", "1")

    def always_racing(txn):
        rival.execute("insert into t values (777, 7770)")  # every attempt
        txn.stage_insert({"k": np.array([51], dtype=np.int64),
                          "v": np.array([510], dtype=np.int64)})
        return 1

    with pytest.raises(WriteConflict, match=r"\[WRITE_CONFLICT\]"):
        run_write(eng, "memory", "t", "insert", always_racing)
    assert (51, 510) not in _table_rows(conn), "loser's staging leaked"
    assert _table_rows(conn).count((777, 7770)) == 2


def test_staging_gauge_drains_on_commit_and_abort():
    from trino_tpu_torch.runtime.txn import STAGING_BYTES, TXN_TOTAL, run_write

    eng, conn = _engine()
    _seed(conn)
    base = STAGING_BYTES.value()
    eng.execute("insert into t values (7, 70)")
    assert STAGING_BYTES.value() == base  # committed: fully drained
    aborted0 = TXN_TOTAL.value("aborted")
    seen = []

    def stage_then_fail(txn):
        txn.stage_insert({"k": np.arange(100, dtype=np.int64),
                          "v": np.arange(100, dtype=np.int64)})
        seen.append(STAGING_BYTES.value())
        raise RuntimeError("statement failed after staging")

    with pytest.raises(RuntimeError, match="after staging"):
        run_write(eng, "memory", "t", "insert", stage_then_fail)
    assert seen and seen[0] >= base + 1600  # 100 rows x two int64 columns
    assert STAGING_BYTES.value() == base  # aborted: drained as well
    assert TXN_TOTAL.value("aborted") == aborted0 + 1
    assert eng._last_txn_info["outcome"] == "aborted"
    assert len(_table_rows(conn)) == 6  # the failed statement left no rows


def test_explain_analyze_write_txn_footer():
    eng, conn = _engine()
    _seed(conn)
    lines = [r[0] for r in eng.execute(
        "explain analyze insert into t select k + 10, v from t"
    )]
    assert lines[0] == "Write[Insert -> t]"
    txn_lines = [l for l in lines if l.startswith("-- txn:")]
    assert len(txn_lines) == 1
    footer = txn_lines[0]
    assert "outcome=committed" in footer
    assert "op=insert" in footer
    assert "table=memory.t" in footer
    assert "-- output rows: 5," in "\n".join(lines)
    # EXPLAIN ANALYZE really executed the write
    assert len(_table_rows(conn)) == 10


# ------------------------------------------- engine-level fault injection


def _connector(kind, tmp_path):
    if kind == "memory":
        from trino_tpu_torch.connectors.memory import MemoryConnector

        return MemoryConnector()
    if kind == "parquet":
        from trino_tpu_torch.connectors.parquet import ParquetConnector

        return ParquetConnector(str(tmp_path / "pq"))
    from trino_tpu_torch.connectors.iceberg import IcebergConnector

    return IcebergConnector(str(tmp_path / "wh"))


@pytest.mark.parametrize("kind", ["memory", "parquet", "iceberg"])
@pytest.mark.parametrize("phase", ["intent", "commit", "ack"])
def test_crash_leaves_pre_xor_post_image(phase, kind, tmp_path):
    """At every phase boundary the table is exactly the pre-image XOR the
    post-image: staged data is invisible until the single commit point."""
    from trino_tpu_torch.runtime.failure import FaultInjector, InjectedCommitCrash

    if kind != "memory":
        pytest.importorskip("pyarrow")
    eng, conn = _engine(_connector(kind, tmp_path))
    _seed(conn)
    eng.write_fault_injector = FaultInjector()
    pre = _table_rows(conn)
    post = sorted(pre + [(k + 100, v) for k, v in pre])
    eng.write_fault_injector.arm(task_id=f"{phase}:", mode="COMMIT_CRASH")
    with pytest.raises(InjectedCommitCrash):
        eng.execute("insert into t select k + 100, v from t")
    [(mode, key)] = eng.write_fault_injector.fired
    assert mode == "COMMIT_CRASH" and key.startswith(f"{phase}:")
    assert _table_rows(conn) == (post if phase == "ack" else pre)
    # a crash runs no abort: the pre-commit phases leave one orphaned
    # staging namespace behind for replay / janitor reclaim
    orphans = conn.orphaned_staging()
    if phase in ("intent", "commit"):
        assert len(orphans) == 1
        assert conn.reclaim_staging(next(iter(orphans))) >= 0
    assert conn.orphaned_staging() == {} or phase == "ack"
    assert eng.execute("select count(*) from t") == [(len(post if phase == "ack" else pre),)]


def test_write_stall_fault_delays_but_commits():
    import time

    from trino_tpu_torch.runtime.failure import FaultInjector

    eng, conn = _engine()
    _seed(conn)
    eng.write_fault_injector = FaultInjector()
    eng.write_fault_injector.arm(task_id="commit:", mode="WRITE_STALL", delay_ms=120)
    t0 = time.monotonic()
    eng.execute("insert into t values (99, 990)")
    assert time.monotonic() - t0 >= 0.1
    assert (99, 990) in _table_rows(conn)


def test_staging_gauge_holds_a_crashed_write_until_a_later_settle():
    """The engine-level half of tests/test_write_txn.py's
    test_staging_gauge_drains_on_commit_and_abort: a crash skips the settle,
    so the orphan's bytes stay in the gauge until reclaim and a later write."""
    from trino_tpu_torch.runtime.failure import FaultInjector, InjectedCommitCrash
    from trino_tpu_torch.runtime.txn import STAGING_BYTES

    eng, conn = _engine()
    _seed(conn)
    base = STAGING_BYTES.value()
    eng.execute("insert into t values (7, 70)")
    assert STAGING_BYTES.value() == base
    eng.write_fault_injector = FaultInjector()
    eng.write_fault_injector.arm(task_id="commit:", mode="COMMIT_CRASH")
    with pytest.raises(InjectedCommitCrash):
        eng.execute("insert into t values (8, 80)")
    assert STAGING_BYTES.value() > base
    for txn_id in list(conn.orphaned_staging()):
        conn.reclaim_staging(txn_id)
    eng.execute("insert into t values (9, 90)")
    assert STAGING_BYTES.value() >= base
    assert (8, 80) not in _table_rows(conn) and (9, 90) in _table_rows(conn)


def test_disk_full_during_staging_aborts_clean(tmp_path):
    pytest.importorskip("pyarrow")
    from trino_tpu_torch.connectors.parquet import ParquetConnector
    from trino_tpu_torch.runtime.disk import DiskExceeded, NodeDiskPool
    from trino_tpu_torch.runtime.txn import TXN_TOTAL

    conn = ParquetConnector(str(tmp_path / "wh"))
    _seed(conn, n=50)
    eng, _ = _engine(conn)
    pre = eng.execute("select k, v from t order by k")
    conn.disk_pool = NodeDiskPool(64, name="write-stage-test")
    conn.write_stage_timeout_s = 0.2
    aborted0 = TXN_TOTAL.value("aborted")
    with pytest.raises(DiskExceeded):
        eng.execute("insert into t select k + 100, v from t")
    assert TXN_TOTAL.value("aborted") == aborted0 + 1
    assert conn.orphaned_staging() == {}, "abort left staging behind"
    assert conn.disk_pool.reserved == 0, "abort leaked a disk lease"
    conn.disk_pool = None
    conn._invalidate("t")
    assert eng.execute("select k, v from t order by k") == pre


# ------------------------------------------------ coordinator crash replay


def _wait(pred, timeout=30.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return bool(pred())


def _wait_port_free(port, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        s = socket.socket()
        # match ThreadingHTTPServer's bind semantics: TIME_WAIT remnants of
        # accepted connections share the listener port and must not count
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.bind(("127.0.0.1", port))
            s.close()
            return
        except OSError:
            s.close()
            time.sleep(0.05)
    raise TimeoutError(f"port {port} never freed")


def _start_cluster(tmp_path, conn, num_workers=1, journal=True, heartbeat=0.2):
    from trino_tpu_torch.testing import DistributedQueryRunner

    runner = DistributedQueryRunner(
        num_workers=num_workers, default_catalog="memory",
        heartbeat_interval=heartbeat,
        journal_path=str(tmp_path / "journal.jsonl") if journal else None,
        device="cpu",
    )
    runner.register_catalog("memory", conn)
    runner.start()
    return runner


def _crash_write(runner, sql, phase):
    """Arm COMMIT_CRASH at `phase`, fire `sql`, wait for the simulated
    coordinator death (no abort, no terminal journal record)."""
    runner.inject_write_failure(phase=phase)
    coord = runner.coordinator

    def _go():
        try:
            coord.execute_query(sql)
        except Exception:
            pass  # the dying coordinator returns nothing useful

    threading.Thread(target=_go, daemon=True).start()
    assert _wait(lambda: coord._killed), "COMMIT_CRASH never fired"


@pytest.mark.parametrize("phase", ["intent", "commit"])
def test_coordinator_crash_uncommitted_replays_to_clean_abort(tmp_path, phase):
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.runtime.journal import QueryJournal
    from trino_tpu_torch.runtime.txn import TXN_TOTAL

    conn = MemoryConnector()
    _seed(conn)
    runner = _start_cluster(tmp_path, conn)
    try:
        runner.query("insert into t values (100, 1000)")
        pre = _table_rows(conn)
        aborted0 = TXN_TOTAL.value("aborted")
        _crash_write(runner, "insert into t select k + 200, v from t", phase)
        assert _table_rows(conn) == pre, "staged data leaked into the table"
        assert len(conn.orphaned_staging()) == 1
        port = runner.coordinator.port
        _wait_port_free(port)
        coord2 = runner.restart_coordinator(port=port)
        assert _wait(lambda: conn.orphaned_staging() == {}), \
            "replay never reclaimed the orphaned staging"
        assert _table_rows(conn) == pre, "abort replay mutated the table"
        assert _wait(lambda: TXN_TOTAL.value("aborted") == aborted0 + 1)
        assert _wait(lambda: all(
            rec["done"].is_set() for rec in coord2.queries.values()
        ))
        jq = QueryJournal.replay(str(tmp_path / "journal.jsonl"))
        crashed = [q for q in jq.values() if q.write_aborts]
        assert len(crashed) == 1
        assert crashed[0].state == "FAILED"
        assert crashed[0].error_code == "WRITE_ABORTED"
    finally:
        runner.stop()


def test_coordinator_crash_committed_unacked_replays_noop(tmp_path):
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.runtime.journal import QueryJournal
    from trino_tpu_torch.runtime.txn import TXN_TOTAL

    conn = MemoryConnector()
    _seed(conn)
    runner = _start_cluster(tmp_path, conn)
    try:
        pre = _table_rows(conn)
        post = sorted(pre + [(k + 200, v) for k, v in pre])
        noop0 = TXN_TOTAL.value("replayed_noop")
        _crash_write(runner, "insert into t select k + 200, v from t", "ack")
        assert _table_rows(conn) == post, "commit landed before the crash"
        port = runner.coordinator.port
        _wait_port_free(port)
        coord2 = runner.restart_coordinator(port=port)
        assert _wait(lambda: TXN_TOTAL.value("replayed_noop") == noop0 + 1)
        # exactly once: replay applied NOTHING on top of the commit
        assert _table_rows(conn) == post
        assert conn.orphaned_staging() == {}
        jq = QueryJournal.replay(str(tmp_path / "journal.jsonl"))
        committed = [q for q in jq.values() if q.write_commits]
        assert committed and all(q.state == "FINISHED" for q in committed)
        # the recovered query answers with the committed row count
        qid = [qid for qid, q in jq.items()
               if q.write_commits and len(q.write_intents) == 1][-1]
        record = coord2.queries[qid]
        assert _wait(lambda: record["done"].is_set())
        assert record["result"] == [(len(pre),)]
    finally:
        runner.stop()


def test_ack_crash_journal_marker_lost_connector_marker_wins(tmp_path):
    """The coordinator can die between the connector commit and the journal
    fsync of the marker: connector state is truth, and replay must repair
    the journal instead of double-applying."""
    import json

    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.runtime.journal import QueryJournal

    conn = MemoryConnector()
    _seed(conn)
    runner = _start_cluster(tmp_path, conn)
    try:
        pre = _table_rows(conn)
        post = sorted(pre + [(k + 300, v) for k, v in pre])
        _crash_write(runner, "insert into t select k + 300, v from t", "ack")
        assert _table_rows(conn) == post
        # simulate the marker never reaching the journal: rewrite the file
        # without its write_commit records
        jpath = str(tmp_path / "journal.jsonl")
        with open(jpath) as f:
            recs = [json.loads(line) for line in f if line.strip()]
        with open(jpath, "w") as f:
            for r in recs:
                if r.get("kind") != "write_commit":
                    f.write(json.dumps(r) + "\n")
        port = runner.coordinator.port
        _wait_port_free(port)
        runner.restart_coordinator(port=port)
        assert _wait(
            lambda: any(
                q.write_commits
                for q in QueryJournal.replay(jpath).values()
            )
        ), "replay never repaired the journal from the connector marker"
        assert _table_rows(conn) == post, "double-applied a committed write"
    finally:
        runner.stop()


def _failing_apply_connector():
    from trino_tpu_torch.connectors.memory import MemoryConnector

    class FailingApplyConnector(MemoryConnector):
        """Commit-time failure lever: the CAS passes but applying the staged
        data blows up — run_write must abort WITHOUT touching the caches."""

        def __init__(self):
            super().__init__()
            self.fail_next_apply = False

        def _apply_staged(self, handle):
            if self.fail_next_apply:
                self.fail_next_apply = False
                raise RuntimeError("injected apply failure")
            return super()._apply_staged(handle)

    return FailingApplyConnector()


def test_failed_update_leaves_result_cache_warm(tmp_path):
    """Invalidate exactly once, at the commit point, never on abort: a
    failed UPDATE leaves the warm result-cache entry valid; the following
    successful UPDATE drops it."""
    conn = _failing_apply_connector()
    _seed(conn)
    runner = _start_cluster(tmp_path, conn, journal=False, heartbeat=0.5)
    try:
        coord = runner.coordinator
        coord.session.set("result_cache_min_recurrences", "0")
        sql = "select sum(v) from t"
        want = runner.query(sql)
        assert coord.result_cache.entries_for_table("memory", "t") == 1
        # the failing UPDATE itself runs (and caches) helper SELECTs — the
        # regression is that no PRE-EXISTING entry gets dropped on abort
        keys0 = set(coord.result_cache._by_table.get("memory.t", ()))
        conn.fail_next_apply = True
        with pytest.raises(Exception, match="injected apply failure"):
            runner.query("update t set v = v + 1 where k = 1")
        assert keys0 <= set(coord.result_cache._by_table.get("memory.t", ())), \
            "abort must NOT invalidate the cache"
        assert _table_rows(conn) == sorted(
            (k, v) for k, v in zip(range(5), range(0, 50, 10))
        )
        assert runner.query(sql) == want  # warm entry still valid
        runner.query("update t set v = v + 1 where k = 1")
        assert coord.result_cache.entries_for_table("memory", "t") == 0, \
            "commit must invalidate the warm entry"
        assert runner.query(sql) == [(want[0][0] + 1,)]
    finally:
        runner.stop()


def test_janitor_reclaims_orphaned_staging(tmp_path):
    pytest.importorskip("pyarrow")
    from trino_tpu_torch.connectors.parquet import ParquetConnector
    from trino_tpu_torch.runtime.txn import RECLAIMED_TOTAL

    conn = ParquetConnector(str(tmp_path / "wh"))
    _seed(conn, n=10)
    # a writer that died without journal or abort: stage and walk away
    handle = conn.begin_write("t", "q_dead-w0", "insert")
    handle.stage_insert({"k": np.array([5], dtype=np.int64),
                         "v": np.array([55], dtype=np.int64)})
    assert list(conn.orphaned_staging()) == ["q_dead-w0"]
    runner = _start_cluster(tmp_path, conn, num_workers=0, journal=False,
                            heartbeat=0.5)
    try:
        coord = runner.coordinator
        coord.session.set("write_staging_grace_s", "0.05")
        reclaimed0 = RECLAIMED_TOTAL.value()
        time.sleep(0.1)  # age past the grace window
        coord._gc_write_staging()
        assert conn.orphaned_staging() == {}
        assert RECLAIMED_TOTAL.value() > reclaimed0
        eng, _ = _engine(conn)
        assert len(eng.execute("select * from t")) == 10
    finally:
        runner.stop()


def test_janitor_spares_live_and_in_grace_staging(tmp_path):
    pytest.importorskip("pyarrow")
    from trino_tpu_torch.connectors.parquet import ParquetConnector

    conn = ParquetConnector(str(tmp_path / "wh"))
    _seed(conn, n=3)
    handle = conn.begin_write("t", "q_young-w0", "insert")
    handle.stage_insert({"k": np.array([9], dtype=np.int64),
                         "v": np.array([99], dtype=np.int64)})
    runner = _start_cluster(tmp_path, conn, num_workers=0, journal=False,
                            heartbeat=0.5)
    try:
        coord = runner.coordinator
        coord.session.set("write_staging_grace_s", "3600")
        coord._gc_write_staging()
        assert list(conn.orphaned_staging()) == ["q_young-w0"], \
            "janitor reclaimed staging inside the grace window"
        conn.abort_write(handle)
        assert conn.orphaned_staging() == {}
    finally:
        runner.stop()
