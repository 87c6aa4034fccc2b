"""The port's spooled durable exchange and bounded worker output memory,
every task on the CPU.  Ports of tests/test_spool.py:

- under TASK retry, a dead producer whose output COMMITTED to the spool is
  re-pointed at storage: consumers re-read it, nothing recomputes;
- un-acknowledged output chunks past a worker's byte budget live on disk.
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
from trino_tpu_torch.testing import DistributedQueryRunner

torch.set_num_threads(1)


class GatedMemoryConnector(MemoryConnector):
    """read_split blocks on `gate` for `gated_table`: deterministic timing
    for a worker killed mid-query."""

    def __init__(self):
        super().__init__()
        self.gate = threading.Event()
        self.gated_table = None
        self.entered = 0
        self._elock = threading.Lock()

    def read_split(self, split, columns):
        if split.table == self.gated_table:
            with self._elock:
                self.entered += 1
            assert self.gate.wait(timeout=60), "test gate never opened"
        return super().read_split(split, columns)


def _make_tables(conn):
    conn.create_table("build", [ColumnSchema("k", BIGINT), ColumnSchema("w", BIGINT)])
    conn.insert("build", {"k": np.arange(50, dtype=np.int64),
                          "w": np.arange(50, dtype=np.int64) * 10})
    conn.create_table("probe", [ColumnSchema("k", BIGINT), ColumnSchema("v", BIGINT)])
    conn.insert("probe", {"k": np.arange(2000, dtype=np.int64) % 50,
                          "v": np.arange(2000, dtype=np.int64)})
    return int((np.arange(2000) + (np.arange(2000) % 50) * 10).sum())


def test_spooled_exchange_reread_not_recompute(tmp_path):
    """Kill a worker holding FINISHED producer output mid-query.  The
    committed output is re-read from the spool: the query succeeds and no
    producer task is re-posted."""
    conn = GatedMemoryConnector()
    expect = _make_tables(conn)
    runner = DistributedQueryRunner(num_workers=2, default_catalog="memory",
                                    heartbeat_interval=0.3, device="cpu")
    runner.register_catalog("memory", conn)
    runner.start()
    try:
        runner.coordinator.session.set("retry_policy", "TASK")
        runner.coordinator.session.set("exchange_spool_dir", str(tmp_path))
        sql = "select sum(v + w) from probe, build where probe.k = build.k"
        conn.gated_table = "probe"
        qid = runner.coordinator.submit_query(sql)
        deadline = time.monotonic() + 60
        while conn.entered == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert conn.entered > 0, "probe stage never started"
        time.sleep(0.3)
        # every stage before the probe FINISHED: committed to the spool
        victim = runner.workers[1]
        tasks_before = {w: len(w.tasks) for w in runner.workers}
        victim.stop()
        conn.gate.set()
        sm = runner.coordinator.queries[qid]["sm"]
        deadline = time.monotonic() + 120
        while sm.state not in ("FINISHED", "FAILED") and time.monotonic() < deadline:
            time.sleep(0.1)
        assert sm.state == "FINISHED", f"query {sm.state}: {sm.error}"
        assert runner.coordinator.queries[qid]["result"] == [(expect,)]
        # the survivor got the re-scheduled probe task, not a recomputed
        # build chain
        survivor = runner.workers[0]
        new_tasks = len(survivor.tasks) - tasks_before[survivor]
        assert new_tasks <= 2, f"{new_tasks} tasks re-posted: recomputed, not re-read"
    finally:
        conn.gate.set()
        runner.stop()


def test_spool_commit_marker(tmp_path):
    """A task directory without the COMMITTED marker is invisible."""
    import os

    from trino_tpu_torch.runtime.spool import SpooledExchange

    spool = SpooledExchange(str(tmp_path))
    spool.commit_task("q1_t0", {0: [b"abc", b"defg"], 1: [b"x"]})
    assert spool.is_committed("q1_t0")
    assert spool.read_chunks("q1_t0", 0) == [b"abc", b"defg"]
    assert spool.read_chunks("q1_t0", 1) == [b"x"]
    assert spool.read_chunks("q1_t0", 2) == []  # an absent buffer reads empty
    os.makedirs(tmp_path / "q1_t1" / "buf0", exist_ok=True)
    (tmp_path / "q1_t1" / "buf0" / "000000.bin").write_bytes(b"partial")
    assert not spool.is_committed("q1_t1")
    with pytest.raises(FileNotFoundError):
        spool.read_chunks("q1_t1", 0)
    # a query's cleanup drops only that query's tasks
    spool.commit_task("q2_t0", {0: [b"keep"]})
    spool.remove_query("q1")
    assert not spool.is_committed("q1_t0")
    assert spool.read_chunks("q2_t0", 0) == [b"keep"]


def test_spool_reads_chunks_the_port_wrote(tmp_path):
    """Pages the port's wire writes through the spool come back as the same
    rows (the spool stores the JAX package's wire format, framed)."""
    from trino_tpu_torch.data.page import Page
    from trino_tpu_torch.runtime.spool import SpooledExchange
    from trino_tpu_torch.runtime.wire import page_to_wire_chunks, wire_to_page

    from trino_tpu_torch.data.page import Column

    vals = np.arange(1000, dtype=np.int64) * 7
    page = Page((Column.from_numpy(BIGINT, vals, device="cpu"),), None)
    spool = SpooledExchange(str(tmp_path))
    spool.commit_task("q3_t0", {0: page_to_wire_chunks(page, chunk_rows=300)})
    chunks = spool.read_chunks("q3_t0", 0)
    assert len(chunks) == 4
    back = wire_to_page(chunks, [BIGINT], device="cpu")
    assert [r[0] for r in back.to_pylist()] == vals.tolist()


def test_worker_buffer_memory_bound(oracle, tpch_tiny):
    """With a byte budget set, a query's un-acknowledged output past the
    bound lives on disk: buffered bytes stay under the budget and the rows
    are still right."""
    from tests.oracle import assert_rows_equal
    from trino_tpu_torch.connectors.tpch import TpchConnector

    bound = 4096
    runner = DistributedQueryRunner(num_workers=2, worker_buffer_memory_bytes=bound,
                                    device="cpu")
    runner.register_catalog("tpch", TpchConnector(0.01))
    runner.start()
    try:
        sql = ("select l_orderkey, l_partkey, l_quantity, l_extendedprice "
               "from lineitem where l_quantity < 30")
        assert_rows_equal(runner.query(sql), oracle.query(sql), ordered=False)
        assert any(w.spilled_chunks > 0 for w in runner.workers), (
            "the bound never forced a spill: the test is vacuous"
        )
        for w in runner.workers:
            assert w.buffered_bytes() <= bound, f"buffered {w.buffered_bytes()} > {bound}"
    finally:
        runner.stop()
