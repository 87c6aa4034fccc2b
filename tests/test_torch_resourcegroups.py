"""The port's resource governance: admission control, queueing, rejection,
declared-memory admission, and query cancellation.  Ports of the 9 cases of
tests/test_resourcegroups.py, every node on the CPU.

Reference: execution/resourcegroups/InternalResourceGroup.java (hierarchy,
hard concurrency, max queued), dispatcher/DispatchManager (queued phase),
memory/ClusterMemoryManager.java:92 (pool admission), TaskResource DELETE
(cancel)."""

import threading
import time

import pytest

try:  # arrow before torch: loaded after it, arrow's parquet writer crashes the process
    import pyarrow  # noqa: F401
except ImportError:
    pass
import torch

from trino_tpu_torch.runtime.resourcegroups import (
    QueryRejected, ResourceGroupConfig, ResourceGroupManager,
)


def test_concurrency_and_fifo_queue():
    mgr = ResourceGroupManager(ResourceGroupConfig(max_concurrency=1, max_queued=10))
    started = []
    mgr.submit("global", "q1", 0, lambda: started.append("q1"))
    mgr.submit("global", "q2", 0, lambda: started.append("q2"))
    mgr.submit("global", "q3", 0, lambda: started.append("q3"))
    assert started == ["q1"]
    mgr.finish("q1")
    assert started == ["q1", "q2"]
    mgr.finish("q2")
    mgr.finish("q3")
    assert started == ["q1", "q2", "q3"]


def test_queue_full_rejects():
    mgr = ResourceGroupManager(ResourceGroupConfig(max_concurrency=1, max_queued=1))
    mgr.submit("global", "q1", 0, lambda: None)
    mgr.submit("global", "q2", 0, lambda: None)
    with pytest.raises(QueryRejected):
        mgr.submit("global", "q3", 0, lambda: None)


def test_hierarchy_parent_limit():
    cfg = ResourceGroupConfig(
        "global", max_concurrency=1,
        subgroups=(
            ResourceGroupConfig("a", max_concurrency=1),
            ResourceGroupConfig("b", max_concurrency=1),
        ),
    )
    mgr = ResourceGroupManager(cfg)
    started = []
    mgr.submit("a", "qa", 0, lambda: started.append("qa"))
    # parent slot is taken: b's query queues even though b itself is free
    mgr.submit("b", "qb", 0, lambda: started.append("qb"))
    assert started == ["qa"]
    mgr.finish("qa")
    assert started == ["qa", "qb"]


def test_memory_admission():
    mgr = ResourceGroupManager(
        ResourceGroupConfig(max_concurrency=10, memory_limit_bytes=100)
    )
    started = []
    mgr.submit("global", "q1", 60, lambda: started.append("q1"))
    mgr.submit("global", "q2", 60, lambda: started.append("q2"))  # over limit
    assert started == ["q1"]
    mgr.finish("q1")
    assert started == ["q1", "q2"]


def test_oversized_budget_rejected_not_wedged():
    # a budget that can never fit must reject at submit, not queue forever
    mgr = ResourceGroupManager(
        ResourceGroupConfig(max_concurrency=10, memory_limit_bytes=100)
    )
    with pytest.raises(QueryRejected):
        mgr.submit("global", "qbig", 200, lambda: None)
    started = []
    mgr.submit("global", "q1", 50, lambda: started.append("q1"))
    assert started == ["q1"]  # group not wedged


def test_cancel_queued_atomicity():
    mgr = ResourceGroupManager(ResourceGroupConfig(max_concurrency=1))
    mgr.submit("global", "q1", 0, lambda: None)
    mgr.submit("global", "q2", 0, lambda: None)  # queued
    assert mgr.cancel_queued("q2") is True
    assert mgr.cancel_queued("q1") is False  # running: must not free the slot
    assert mgr.stats()["global"]["running"] == 1


def test_admission_and_cancel_via_coordinator(tpch_tiny):
    from trino_tpu_torch.client import StatementClient
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.testing import DistributedQueryRunner

    runner = DistributedQueryRunner(device="cpu", num_workers=1)
    runner.register_catalog("tpch", TpchConnector(0.01))
    runner.start()
    try:
        cli = StatementClient(runner.coordinator.url)
        # cancel a queued query deterministically: occupy the only slot
        runner.coordinator.resource_groups = __import__(
            "trino_tpu_torch.runtime.resourcegroups", fromlist=["ResourceGroupManager"]
        ).ResourceGroupManager(ResourceGroupConfig(max_concurrency=1, max_queued=5))
        gate = threading.Event()
        release = threading.Event()

        def hog():
            runner.coordinator.resource_groups.submit(
                "global", "hog", 0, lambda: gate.set()
            )
            release.wait(30)
            runner.coordinator.resource_groups.finish("hog")

        t = threading.Thread(target=hog, daemon=True)
        t.start()
        assert gate.wait(5)
        qid = cli.submit("select count(*) from lineitem")
        time.sleep(0.2)
        assert cli.query_state(qid) == "QUEUED"
        assert cli.cancel(qid)
        deadline = time.monotonic() + 10
        while cli.query_state(qid) != "FAILED" and time.monotonic() < deadline:
            time.sleep(0.05)
        assert cli.query_state(qid) == "FAILED"
        release.set()
        t.join(10)
        # the freed slot admits and completes a fresh query
        cols, rows = cli.execute("select count(*) from region")
        assert rows[0][0] == 5
        info = cli.server_info()
        assert "resource_groups" in info
    finally:
        runner.stop()


def test_weighted_fair_sibling_scheduling():
    """Siblings drain in weighted-fair share order: group a (weight 3) gets
    ~3x the admissions of group b (weight 1) while the shared parent slot
    pool is contended (reference: resourcegroups/WeightedFairQueue.java)."""
    from trino_tpu_torch.runtime.resourcegroups import (
        ResourceGroupConfig, ResourceGroupManager,
    )

    root = ResourceGroupConfig(
        "global", max_concurrency=4, max_queued=100,
        subgroups=(
            ResourceGroupConfig("a", max_concurrency=4, scheduling_weight=3),
            ResourceGroupConfig("b", max_concurrency=4, scheduling_weight=1),
        ),
    )
    mgr = ResourceGroupManager(root)
    admitted: list[str] = []

    def starter(name):
        return lambda: admitted.append(name)

    # fill the parent with 4 running, queue 8 more per group
    for i in range(4):
        mgr.submit("a" if i % 2 == 0 else "b", f"seed{i}", 0, starter("seed"))
    for i in range(8):
        mgr.submit("a", f"a{i}", 0, starter("a"))
        mgr.submit("b", f"b{i}", 0, starter("b"))
    admitted.clear()
    # finish the seeds: each release triggers weighted-fair draining
    for i in range(4):
        mgr.finish(f"seed{i}")
    # drain everything by finishing whatever got admitted, in order
    done = set()
    queue_ids = [f"a{i}" for i in range(8)] + [f"b{i}" for i in range(8)]
    # keep finishing admitted queries until all drained
    for _ in range(40):
        for q in queue_ids:
            g = mgr._group_of.get(q)
            if g is not None and q in g.running and q not in done:
                done.add(q)
                mgr.finish(q)
    first8 = admitted[:8]
    a_share = sum(1 for x in first8 if x == "a")
    # weight 3:1 -> a should take ~6 of the first 8 admissions
    assert a_share >= 5, (a_share, admitted)


def test_cluster_memory_kill_biggest_query(tpch_tiny):
    """Cluster memory enforcement: when worker-reported buffered bytes
    exceed the cluster limit, the coordinator kills the query holding the
    most (reference: ClusterMemoryManager + TotalReservation LowMemoryKiller)
    — then degrades gracefully: the killed query is requeued through the
    out-of-core spill executor and still returns correct rows."""
    import threading
    import time

    import numpy as np

    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.connectors.spi import ColumnSchema
    from trino_tpu_torch.data.types import BIGINT
    from trino_tpu_torch.testing import DistributedQueryRunner

    class GatedMemoryConnector(MemoryConnector):
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
                assert self.gate.wait(timeout=60), "gate never opened"
            return super().read_split(split, columns)

    conn = GatedMemoryConnector()
    conn.create_table("build", [ColumnSchema("k", BIGINT), ColumnSchema("w", BIGINT)])
    conn.insert("build", {"k": np.arange(500, dtype=np.int64),
                          "w": np.arange(500, dtype=np.int64)})
    conn.create_table("probe", [ColumnSchema("k", BIGINT), ColumnSchema("v", BIGINT)])
    conn.insert("probe", {"k": np.arange(1000, dtype=np.int64) % 500,
                          "v": np.arange(1000, dtype=np.int64)})

    runner = DistributedQueryRunner(
        device="cpu", num_workers=2, default_catalog="memory", heartbeat_interval=0.2,
        cluster_memory_limit_bytes=64,  # below the build stage's output
    )
    runner.register_catalog("memory", conn)
    runner.start()
    try:
        runner.coordinator.session.set("retry_policy", "TASK")
        conn.gated_table = "probe"
        qid = runner.coordinator.submit_query(
            "select sum(v + w) from probe, build where probe.k = build.k"
        )
        deadline = time.monotonic() + 60
        while conn.entered == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert conn.entered > 0
        # build output is buffered un-acked on workers; the heartbeat sweep
        # must mark the query for death
        deadline = time.monotonic() + 30
        while runner.coordinator.memory_kills == 0 and time.monotonic() < deadline:
            time.sleep(0.1)
        assert runner.coordinator.memory_kills > 0, "no memory kill happened"
        conn.gate.set()
        sm = runner.coordinator.queries[qid]["sm"]
        deadline = time.monotonic() + 120
        while sm.state not in ("FINISHED", "FAILED") and time.monotonic() < deadline:
            time.sleep(0.1)
        # graceful degradation: the kill requeues through the out-of-core
        # executor instead of surfacing a failure
        assert sm.state == "FINISHED", f"{sm.state}: {sm.error}"
        assert runner.coordinator.memory_requeues > 0
        expect = int((np.arange(1000) + (np.arange(1000) % 500)).sum())
        assert runner.coordinator.queries[qid]["result"] == [(expect,)]
    finally:
        conn.gate.set()
        runner.stop()
