"""The port's coordinator crash recovery: durable query journal, in-flight
resumption from the spool, client re-attach.  Ports of the 7 cases of
tests/test_recovery.py, every node on the CPU.  The recompute witness is the
scans each stage runs (`scans`), beside the connector reads the reference
counts: a worker's scan cache may serve a re-run stage's slices, so a read
count alone would not show a recompute.

Reference behaviors being matched:
- the FTE promise that a stage output COMMITTED to durable storage is
  RE-READ, never recomputed (spi/exchange/ExchangeManager +
  trino-exchange-filesystem) — here extended across COORDINATOR death via
  the query journal (runtime/journal.py);
- StatementClientV1 polling nextUri through transient coordinator
  unavailability instead of failing the first refused connect.
"""

import os
import threading
import time
import urllib.request

import numpy as np
import pytest

try:  # arrow before torch: loaded after it, arrow's parquet writer crashes the process
    import pyarrow  # noqa: F401
except ImportError:
    pass
import torch

from trino_tpu_torch.client import QueryFailed, StatementClient
from trino_tpu_torch.connectors.memory import MemoryConnector
from trino_tpu_torch.connectors.spi import CatalogManager, ColumnSchema
from trino_tpu_torch.data.types import BIGINT
from trino_tpu_torch.exec.compiler import LocalExecutor
from trino_tpu_torch.runtime.journal import QueryJournal
from trino_tpu_torch.runtime.spool import SpooledExchange
from trino_tpu_torch.testing import DistributedQueryRunner

pytestmark = pytest.mark.smoke

JOIN_SQL = "select sum(v + w) from probe, build where probe.k = build.k"


class GatedMemoryConnector(MemoryConnector):
    """read_split blocks on `gate` for `gated_table` and counts reads per
    table — deterministic kill-mid-query timing plus proof of which stages
    recomputed after a restart (same fixture shape as test_spool)."""

    def __init__(self):
        super().__init__()
        self.gate = threading.Event()
        self.gated_table = None
        self.reads: dict[str, int] = {}
        self._rlock = threading.Lock()

    def read_split(self, split, columns):
        with self._rlock:
            self.reads[split.table] = self.reads.get(split.table, 0) + 1
        if split.table == self.gated_table:
            assert self.gate.wait(timeout=120), "test gate never opened"
        return super().read_split(split, columns)


def _make_tables(conn):
    conn.create_table("build", [ColumnSchema("k", BIGINT), ColumnSchema("w", BIGINT)])
    conn.insert("build", {"k": np.arange(50, dtype=np.int64),
                          "w": np.arange(50, dtype=np.int64) * 10})
    conn.create_table("probe", [ColumnSchema("k", BIGINT), ColumnSchema("v", BIGINT)])
    conn.insert("probe", {"k": np.arange(2000, dtype=np.int64) % 50,
                          "v": np.arange(2000, dtype=np.int64)})
    return int((np.arange(2000) + (np.arange(2000) % 50) * 10).sum())


def _wait(pred, timeout=30.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return bool(pred())


def _committed_dirs(spool_dir):
    if not os.path.isdir(spool_dir):
        return []
    return [n for n in os.listdir(spool_dir)
            if os.path.exists(os.path.join(spool_dir, n, "COMMITTED"))]


@pytest.fixture
def scans(monkeypatch):
    """Scans run per table, counted at the executor: the port's workers
    keep uploaded slices in a scan cache, so a re-run stage may read its
    connector no more — the scan itself is the recompute witness."""
    counts: dict[str, int] = {}
    lock = threading.Lock()
    plain = LocalExecutor.table_page

    def counted(self, catalog, table, *args, **kwargs):
        with lock:
            counts[table] = counts.get(table, 0) + 1
        return plain(self, catalog, table, *args, **kwargs)

    monkeypatch.setattr(LocalExecutor, "table_page", counted)
    return counts


def _start_cluster(tmp_path, conn):
    runner = DistributedQueryRunner(
        device="cpu", num_workers=2, default_catalog="memory", heartbeat_interval=0.2,
        journal_path=str(tmp_path / "journal.jsonl"),
    )
    runner.register_catalog("memory", conn)
    runner.start()
    runner.coordinator.session.set("retry_policy", "TASK")
    runner.coordinator.session.set("exchange_spool_dir", str(tmp_path / "spool"))
    return runner


def _restart_session(tmp_path, policy):
    return {
        "retry_policy": "TASK",
        "exchange_spool_dir": str(tmp_path / "spool"),
        "resume_policy": policy,
    }


class _ClientThread(threading.Thread):
    """One protocol client riding a query across the coordinator restart."""

    def __init__(self, url, sql):
        super().__init__(daemon=True)
        self.client = StatementClient(url, reattach_max_elapsed_s=60.0)
        self.sql = sql
        self.result = None
        self.error = None

    def run(self):
        try:
            self.result = self.client.execute(self.sql, timeout=120)
        except Exception as e:  # re-raised on the main thread by the test
            self.error = e


def _crash_mid_query(tmp_path, conn, policy):
    """Start the gated join, wait until the build side COMMITTED to the
    spool and the probe side is mid-read, then kill the coordinator and
    boot a replacement on the same port with the given resume policy."""
    runner = _start_cluster(tmp_path, conn)
    spool = str(tmp_path / "spool")
    conn.gated_table = "probe"
    t = _ClientThread(runner.coordinator.url, JOIN_SQL)
    t.start()
    ready = _wait(
        lambda: _committed_dirs(spool) and conn.reads.get("probe", 0) > 0,
        timeout=60,
    )
    assert ready, "build stage never committed / probe stage never started"
    builds_before = conn.reads.get("build", 0)
    assert builds_before > 0
    port = runner.kill_coordinator()
    runner.restart_coordinator(port, session=_restart_session(tmp_path, policy))
    return runner, t, builds_before


def test_journal_roundtrip(tmp_path):
    p = str(tmp_path / "j.jsonl")
    j = QueryJournal(p)
    j.append("admit", "q_aa", sql="select 1", session={"retry_policy": "TASK"},
             spooled=True)
    j.append("dispatch", "q_aa", fragment=1, ntasks=2, attempt=0)
    j.append("commit", "q_aa", fragment=1, part=0, task_id="q_aa_a0_f1_p0_t0")
    j.append("admit", "q_bb", sql="select 2", session={}, spooled=False)
    j.append("finish", "q_bb", state="FINISHED", error=None, error_code=None)
    j.close()
    with open(p, "a") as f:
        f.write('{"kind": "adm')  # torn trailing write at crash
    states = QueryJournal.replay(p)
    aa = states["q_aa"]
    assert aa.state == "INFLIGHT"
    assert aa.sql == "select 1"
    assert aa.session == {"retry_policy": "TASK"}
    assert aa.spooled is True
    assert aa.dispatches == {1: 2}
    assert aa.commits == {1: {0: "q_aa_a0_f1_p0_t0"}}
    assert aa.next_attempt == 1  # pre-crash attempt 0 -> resume tags at 1
    bb = states["q_bb"]
    assert bb.state == "FINISHED"
    assert QueryJournal.replay(str(tmp_path / "missing.jsonl")) == {}


def test_resume_skips_committed_stages(tmp_path, scans):
    """resume_policy=RESUME: the client's poll loop rides through the
    restart, the query completes correctly, and the spool-committed build
    stage is re-read — ZERO build recomputation."""
    conn = GatedMemoryConnector()
    expect = _make_tables(conn)
    runner, t, builds_before = _crash_mid_query(tmp_path, conn, "RESUME")
    build_scans = scans["build"]
    try:
        conn.gate.set()
        t.join(timeout=120)
        assert not t.is_alive(), "client never finished after restart"
        assert t.error is None, f"query failed across restart: {t.error!r}"
        _, rows = t.result
        assert int(rows[0][0]) == expect
        # committed build output came from the spool, not a re-run
        assert conn.reads.get("build", 0) == builds_before
        assert scans["build"] == build_scans
        coord = runner.coordinator
        assert _wait(lambda: coord._m_resumed.value("completed") >= 1, 15)
        body = urllib.request.urlopen(f"{coord.url}/metrics", timeout=10).read()
        assert b'trino_tpu_queries_resumed_total{outcome="completed"}' in body
        assert b"trino_tpu_journal_records_total" in body
    finally:
        conn.gate.set()
        runner.stop()


def test_restart_policy_recomputes_everything(tmp_path, scans):
    """resume_policy=RESTART ignores the journaled commits: the query still
    completes correctly across the restart but the build side re-runs."""
    conn = GatedMemoryConnector()
    expect = _make_tables(conn)
    runner, t, builds_before = _crash_mid_query(tmp_path, conn, "RESTART")
    build_scans = scans["build"]
    try:
        conn.gate.set()
        t.join(timeout=120)
        assert not t.is_alive(), "client never finished after restart"
        assert t.error is None, f"query failed across restart: {t.error!r}"
        _, rows = t.result
        assert int(rows[0][0]) == expect
        assert _wait(lambda: scans["build"] > build_scans, 10)
    finally:
        conn.gate.set()
        runner.stop()


def test_resume_policy_fail_typed_error_and_cleanup(tmp_path):
    """resume_policy=FAIL: the re-attached client gets the typed
    COORDINATOR_RESTART failure (410 on the poll), the orphan sweep cancels
    the dead query's worker tasks, and the spool GC reclaims its dirs."""
    conn = GatedMemoryConnector()
    _make_tables(conn)
    runner, t, _ = _crash_mid_query(tmp_path, conn, "FAIL")
    spool = str(tmp_path / "spool")
    try:
        t.join(timeout=60)
        assert not t.is_alive(), "client never observed the refusal"
        assert isinstance(t.error, QueryFailed), f"got {t.error!r}"
        assert t.error.error_code == "COORDINATOR_RESTART"
        assert runner.coordinator._m_resumed.value("refused") >= 1
        # the new coordinator's sweep cancels tasks of the abandoned query
        assert _wait(lambda: all(len(w.tasks) == 0 for w in runner.workers), 15)
        conn.gate.set()  # release reader threads parked inside read_split
        # age-0 GC reclaims the crashed query's committed + staging dirs
        runner.coordinator.session.set("spool_gc_age_s", "0")
        assert _wait(
            lambda: not any(
                os.path.isdir(os.path.join(spool, n))
                for n in os.listdir(spool)
            ),
            timeout=20,
        ), f"spool dirs never reclaimed: {os.listdir(spool)}"
    finally:
        conn.gate.set()
        runner.stop()


def test_first_commit_wins_late_precrash_attempt(tmp_path):
    """A pre-crash attempt finishing AFTER the resumed attempt committed
    must lose the rename race and never clobber the winner's chunks."""
    sp = SpooledExchange(str(tmp_path))
    assert sp.commit_task("q_x_a1_f1_p0_t0", {0: [b"winner"]}, attempt="1")
    assert not sp.commit_task("q_x_a1_f1_p0_t0", {0: [b"late"]}, attempt="0")
    assert sp.read_chunks("q_x_a1_f1_p0_t0", 0) == [b"winner"]
    # the loser's staging dir was discarded, not published
    assert not os.path.exists(
        os.path.join(str(tmp_path), "q_x_a1_f1_p0_t0.tmp-0")
    )


def test_spool_gc(tmp_path):
    d = str(tmp_path)
    sp = SpooledExchange(d)
    sp.commit_task("q_dead_a0_f1_p0_t0", {0: [b"x"]})
    sp.commit_task("q_live_a0_f1_p0_t0", {0: [b"y"]})
    os.makedirs(os.path.join(d, "q_dead_a0_f1_p1_t0.tmp-0", "buf0"))
    with open(os.path.join(d, "spill_0001.bin"), "wb") as f:
        f.write(b"z")  # stray file sharing the dir is NOT spool-owned
    assert sp.gc({"q_live"}, age_s=0.0) == {"committed": 1, "staging": 1}
    assert sp.is_committed("q_live_a0_f1_p0_t0")
    assert not sp.is_committed("q_dead_a0_f1_p0_t0")
    assert os.path.exists(os.path.join(d, "spill_0001.bin"))
    # young dirs under an age threshold survive (another coordinator may
    # still be writing them)
    sp.commit_task("q_dead2_a0_f1_p0_t0", {0: [b"x"]})
    assert sp.gc({"q_live"}, age_s=3600.0) == {"committed": 0, "staging": 0}
    assert sp.is_committed("q_dead2_a0_f1_p0_t0")


def test_journal_replay_folds_terminal_into_history(tmp_path):
    """Queries the journal knows FINISHED before the crash become history
    records on the replacement coordinator, not resumed queries."""
    from trino_tpu_torch.runtime.coordinator import Coordinator

    p = str(tmp_path / "j.jsonl")
    j = QueryJournal(p)
    j.append("admit", "q_done", sql="select 1", session={}, spooled=False)
    j.append("finish", "q_done", state="FINISHED", error=None, error_code=None)
    j.close()
    coord = Coordinator(CatalogManager(), "memory", journal_path=p, device="cpu")
    coord.start()
    try:
        info = coord.history.get("q_done")
        assert info is not None and info["state"] == "FINISHED"
        assert "q_done" not in coord.queries
    finally:
        coord.stop()


def test_orphan_sweep_spares_a_query_admitted_during_its_listing(tmp_path, monkeypatch):
    """Port repair: the sweep takes the live set, then lists each worker's
    tasks.  A query admitted in between (its tasks already posted when the
    listing is read) is live, and its tasks stay; a task of a query nobody
    knows is still deleted."""
    import io
    import json as _json

    from trino_tpu_torch.runtime import coordinator as coord_mod
    from trino_tpu_torch.runtime.statemachine import QueryStateMachine

    coord = coord_mod.Coordinator(CatalogManager(), "memory",
                        journal_path=str(tmp_path / "j.jsonl"), device="cpu")
    coord.start()
    deleted = []
    monkeypatch.setattr(coord, "_delete_task_quiet", lambda url, tid: deleted.append(tid))
    worker = coord_mod._WorkerInfo("http://127.0.0.1:1")

    class Listing(io.BytesIO):
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    def urlopen(url, timeout=None):
        assert url == f"{worker.url}/v1/task"
        # admitted after the sweep took its live set, before this listing
        coord.queries["q_late"] = {"sm": QueryStateMachine("q_late"),
                                   "done": threading.Event()}
        return Listing(_json.dumps({"tasks": [
            {"query_id": "q_late", "task_id": "q_late_a0_f1_p0_t0"},
            {"query_id": "q_gone", "task_id": "q_gone_a0_f1_p0_t0"},
        ]}).encode())

    monkeypatch.setattr(coord_mod.urllib.request, "urlopen", urlopen)
    try:
        coord._sweep_orphan_tasks([worker])
    finally:
        monkeypatch.undo()
        coord.stop()
    assert deleted == ["q_gone_a0_f1_p0_t0"]
