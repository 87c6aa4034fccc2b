"""Worker node: asynchronous HTTP task execution server.

Reference wiring this replaces (SURVEY §2.8, §3.2-3.3):
  POST /v1/task/{id}          TaskResource.createOrUpdateTask
                              (TaskResource.java:142) — returns IMMEDIATELY;
                              the task runs on the worker's executor pool
                              (SqlTaskManager.updateTask:491 semantics)
  GET  /v1/task/{id}/status?wait=s
                              long-poll task status, the reference's
                              ContinuousTaskStatusFetcher
                              (server/remotetask/HttpRemoteTask.java:339)
  GET  /v1/task/{id}/results/{buffer}/{token}
                              token-sequenced chunked page fetch
                              (HttpPageBufferClient.sendGetResults:355);
                              response headers carry X-Complete /X-No-Data;
                              re-reading a token is idempotent
                              (at-least-once with client-side dedup)
  GET  /v1/task/{id}/results/{buffer}/{token}/acknowledge
                              frees chunks below `token`
                              (HttpPageBufferClient.java:406-424)
  DELETE /v1/task/{id}        abort + free buffers
  GET  /v1/info               heartbeat (failuredetector/HeartbeatFailureDetector);
                              reports the worker lifecycle state
                              (active | draining | drained)
  PUT  /v1/info/state         graceful drain trigger — body "DRAINING" (or
                              the reference's "SHUTTING_DOWN") flips the
                              worker into DRAINING: new task POSTs get 503
                              + Retry-After, running tasks finish and
                              commit their output, exchange fetches keep
                              serving until consumers are done, then the
                              worker deregisters (server/GracefulShutdownHandler
                              + NodeStateChangeHandler PUT /v1/info/state)
  POST /v1/memory/revoke      cluster-memory-manager revocation request:
                              force-spill the query's revocable leases on
                              this node (reference: the revoke-memory task
                              update that triggers spillable operators)
  POST /v1/inject_failure     test-only fault matrix (ERROR | TIMEOUT |
                              SLOW | EXCHANGE_DROP | CORRUPT |
                              MEMORY_PRESSURE | DISK_FULL | SPOOL_LOST |
                              PARTITION | GRAY_SLOW | FLAKY_LINK,
                              counted/probabilistic/consumer-scoped;
                              execution/FailureInjector.java:33 — see
                              runtime/failure.py FaultInjector)

A task executes its fragment with the port's LocalExecutor on the worker's
`device` (the CUDA card by default; the CPU only when asked) over its split
range, and partitions output rows per the fragment's output kind into
token-addressed chunk lists per partition buffer: each output page leaves
the card in one packed device->host copy with its partition ids computed on
the card (runtime/wire.py), and fetched pages are uploaded to the worker's
device.  The tasks of a worker share one scan cache (exec/compiler.py
ScanCache): a warm query re-reads and re-uploads no table slice.  Source fetch streams
chunk-by-chunk with acknowledge, so a consumer's in-flight HTTP memory is
bounded by one chunk per producer even when the exchange moves gigabytes.
"""

from __future__ import annotations

import json
import os
import threading
import time
import traceback
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import quote, unquote

import torch

from ..connectors.spi import CatalogManager
from ..data.page import Page
from .. import resolve_device
from ..exec.compiler import LocalExecutor, ScanCache
from ..plan.serde import plan_from_json
from ..utils import flightrecorder as _fr
from ..utils import metrics as _metrics
from ..utils import timeseries as _ts
from ..utils.tracing import Tracer, add_exporters_from_env
from .disk import DiskExceeded, NodeDiskPool, guarded_write
from .failure import Backoff, FaultInjector
from .health import DEAD, DEADLINE_ABORTS, HEDGED_FETCHES, LinkHealth
from .memory import NodeMemoryPool
from .spool import SPOOL_URL, SpooledExchange
from .wire import (
    PageTransportError,
    page_to_wire_chunks,
    partition_page,
    unframe_chunk,
    wire_to_page,
)

__all__ = ["Worker", "DrainingError"]

# sub-slices a revoked task degrades to; matches NodeMemoryPool.revoke_query's
# default lease shrink factor (the retained lease covers one slice's set)
REVOKE_SPILL_PARTS = 4


def _fragment_revocable(fragment) -> bool:
    """May this task's reservation be revoked (forced to spill)?  Sliced
    re-execution needs a TableScan to sub-split, and only fragments with
    stateful operators (hash agg/join/distinct/topn capacities) hold
    enough working set to be worth revoking."""
    from ..plan.nodes import Aggregate, Distinct, Join, TableScan, TopN, walk

    nodes = list(walk(fragment))  # fragment IS the root plan node
    return any(isinstance(n, TableScan) for n in nodes) and any(
        isinstance(n, (Aggregate, Distinct, Join, TopN)) for n in nodes
    )


class DrainingError(RuntimeError):
    """Task submission refused because the worker is draining/drained —
    surfaced over HTTP as 503 + Retry-After (reference: a SHUTTING_DOWN
    node answering TaskResource POSTs with SERVER_SHUTTING_DOWN)."""


class _Task:
    """One task's lifecycle + output buffers (reference: SqlTask.java:498).

    A buffer entry is one of: bytes (RAM-resident chunk), a str file path
    (chunk spooled/spilled to disk — read back on fetch), or None
    (acknowledged and freed).  Only bytes entries count against the
    worker's buffered_bytes — bounding worker memory is the point of the
    file form (reference: OutputBufferMemoryManager)."""

    def __init__(self, task_id: str, query_id: Optional[str] = None):
        self.task_id = task_id
        # explicit query id from the task payload (deriving it by
        # slicing the task id silently breaks per-query memory accounting if
        # the id format ever changes)
        self.query_id = query_id
        # RUNNING | BLOCKED (parked on node memory) | FINISHED | FAILED
        self.state = "RUNNING"
        # node-pool reservation (runtime/memory.py MemoryLease); released in
        # _run_task's finally and on delete — release is idempotent
        self.mem_lease = None
        # the cluster memory manager asked this task to force-spill: execute
        # degrades to sliced (partitioned) execution instead of full-width
        self.revoke_requested = False
        self.error: Optional[str] = None
        # buffer_id -> list of entries (bytes | path str | None)
        self.buffers: dict[int, list] = {}
        self.complete = False  # all output chunks present
        self.canceled = False
        self.cond = threading.Condition()
        # per-task stats shipped to the coordinator in /status (reference:
        # TaskStats inside TaskInfo): operator rows/ms, wall, exchange bytes
        self.stats: dict = {}
        self.bytes_served = 0  # result-buffer bytes handed to consumers
        # no-progress watchdog (reference: the stats-freeze detection the
        # coordinator's _wait_task ceiling papers over today): execution
        # milestones beat `progress()`; the worker's monitor thread fails a
        # RUNNING task whose beats freeze past no_progress_timeout_s.  Armed
        # only once the task THREAD starts — a task queued behind a full
        # executor pool is waiting, not wedged.
        self.no_progress_timeout_s = 0.0
        self.last_progress_at = time.monotonic()
        self.watchdog_armed = False

    def progress(self) -> None:
        self.last_progress_at = time.monotonic()

    def finish(self, buffers: dict[int, list]) -> None:
        with self.cond:
            if self.state not in ("RUNNING", "BLOCKED"):
                return  # watchdog/abort already terminated this attempt
            self.buffers = {k: list(v) for k, v in buffers.items()}
            self.complete = True
            self.state = "FINISHED"
            self.cond.notify_all()

    def fail(self, msg: str) -> None:
        with self.cond:
            if self.state not in ("RUNNING", "BLOCKED"):
                return  # terminal states absorb (first outcome wins)
            self.state = "FAILED"
            self.error = msg
            self.cond.notify_all()

    def set_blocked(self, blocked: bool) -> None:
        """Flip RUNNING <-> BLOCKED (parked on node memory) — visible in
        /v1/task/{id}/status; terminal states absorb."""
        with self.cond:
            if blocked and self.state == "RUNNING":
                self.state = "BLOCKED"
            elif not blocked and self.state == "BLOCKED":
                self.state = "RUNNING"
            self.cond.notify_all()
        # a just-unparked task must not be killed for the progress it could
        # not make while legitimately waiting on memory
        self.progress()


class Worker:
    def __init__(
        self,
        catalogs: CatalogManager,
        default_catalog: str,
        port: int = 0,
        task_concurrency: int = 4,
        buffer_memory_bytes: Optional[int] = None,
        node_memory_bytes: Optional[int] = None,
        disk_budget_bytes: Optional[int] = None,
        disk_blocked_timeout_s: float = 10.0,
        device="cuda",
    ):
        self.catalogs = catalogs
        self.default_catalog = default_catalog
        # where this node's tasks run: the card unless the caller asks for
        # the CPU (raises without a card, as Engine does)
        self.device = resolve_device(device)
        # scan columns and learned capacities every task of this node
        # shares (keyed by split, pad, filters and write generation)
        self.scan_cache = ScanCache()
        # device bytes of cached columns given back on revocations
        self.revoked_device_bytes = 0
        self._killed = False  # kill(): handlers answer nothing more
        self.tasks: dict[str, _Task] = {}
        self.fault_injector = FaultInjector()
        # node memory pool (reference: the per-node general MemoryPool that
        # ClusterMemoryManager polls) — capacity from the
        # `memory.heap-headroom-per-node` config key; None = ungoverned
        self.memory_pool: Optional[NodeMemoryPool] = (
            NodeMemoryPool(node_memory_bytes) if node_memory_bytes else None
        )
        # node disk pool (runtime/disk.py, symmetric to the memory plane):
        # spool commits and spill files lease bytes against the
        # `spool.disk-budget-bytes` budget; None = ungoverned
        self.disk_pool: Optional[NodeDiskPool] = (
            NodeDiskPool(disk_budget_bytes) if disk_budget_bytes else None
        )
        self.disk_blocked_timeout_s = disk_blocked_timeout_s
        # output-buffer memory bound (reference: OutputBufferMemoryManager):
        # finished chunks past this byte budget spill to a local directory
        # and are served back by file read.  The dir is created eagerly (a
        # lazy init would race across concurrent task threads) and placement
        # is serialized so the budget check-and-admit is atomic.
        self.buffer_memory_bytes = buffer_memory_bytes
        if buffer_memory_bytes is not None:
            import tempfile

            self._spill_dir: Optional[str] = tempfile.mkdtemp(
                prefix="trino_tpu_spill_"
            )
        else:
            self._spill_dir = None
        self._place_lock = threading.Lock()
        self.spilled_chunks = 0  # observability
        self._lock = threading.Lock()
        # per-worker registry: two in-process workers must not alias counters
        self.metrics = _metrics.MetricsRegistry()
        self._m_tasks = self.metrics.counter(
            "trino_tpu_worker_tasks_total", "Task lifecycle events", ("event",)
        )
        self._m_task_seconds = self.metrics.histogram(
            "trino_tpu_worker_task_seconds", "Task wall time"
        )
        self._m_fetched_bytes = self.metrics.counter(
            "trino_tpu_exchange_fetched_bytes_total",
            "Exchange bytes fetched from upstream tasks",
        )
        self._m_served_bytes = self.metrics.counter(
            "trino_tpu_exchange_served_bytes_total",
            "Result-buffer bytes served to consumers",
        )
        self._m_acks = self.metrics.counter(
            "trino_tpu_exchange_chunks_acked_total",
            "Buffer chunks freed by consumer acknowledge",
        )
        # directional exchange totals (observatory plane): `in` = bytes
        # this node fetched from producers, `out` = bytes it served to
        # consumers — the same quantities the sampler turns into per-tick
        # exchange_in_bytes / exchange_out_bytes lanes
        self._m_exchange_bytes = self.metrics.counter(
            "trino_tpu_exchange_bytes_total",
            "Exchange bytes moved by this node, by direction "
            "(in: fetched from producers; out: served to consumers)",
            ("direction",),
        )
        # plain cumulative mirrors for the sampler's delta lanes (reading
        # our own counter children back out would be clumsier)
        self.exchange_bytes_in = 0
        self.exchange_bytes_out = 0
        self._m_buffered = self.metrics.gauge(
            "trino_tpu_worker_buffered_bytes", "RAM-resident output bytes"
        )
        self._m_drains = self.metrics.counter(
            "trino_tpu_worker_drains_total",
            "Graceful drain transitions entered by this worker",
        )
        self._m_no_progress = self.metrics.counter(
            "trino_tpu_worker_no_progress_kills_total",
            "Tasks failed by the no-progress watchdog",
        )
        self._m_revocations = self.metrics.counter(
            "trino_tpu_memory_revocations_total",
            "Memory revocations executed (leases force-shrunk to spill)",
        )
        self._m_pool_capacity = self.metrics.gauge(
            "trino_tpu_node_memory_capacity_bytes",
            "Node memory pool capacity",
        )
        self._m_pool_reserved = self.metrics.gauge(
            "trino_tpu_node_memory_reserved_bytes",
            "Node memory pool bytes currently reserved",
        )
        self._m_pool_blocked = self.metrics.gauge(
            "trino_tpu_node_memory_blocked_reservations",
            "Reservations currently parked waiting for pool bytes",
        )
        self.tracer = Tracer()
        add_exporters_from_env(self.tracer)
        # lifecycle state (reference: NodeState ACTIVE/SHUTTING_DOWN served
        # by ServerInfoResource): active -> draining -> drained.  DRAINING
        # rejects new task POSTs but keeps serving status + exchange fetches.
        self.state = "active"
        # set by the launcher/test runner at announce time so drain can
        # POST a goodbye-announce (deregister) instead of silently vanishing
        # and tripping the coordinator's circuit breaker.  A fleet-aware
        # worker holds the WHOLE list (TRINO_TPU_COORDINATORS): it
        # announces to — and is deregistered from — every member, so any
        # coordinator can dispatch to it and an adopter already knows it.
        self.coordinator_urls: list[str] = [
            u.strip().rstrip("/")
            for u in (os.environ.get("TRINO_TPU_COORDINATORS") or "").split(",")
            if u.strip()
        ]
        # periodic re-announce cadence (0 disables); first announce fires
        # about one interval after start — the initial registration is
        # explicit.  Decorrelated jitter: every worker announces to EVERY
        # fleet member, so a restarted member would otherwise receive the
        # whole fleet's announces in one synchronized wave each interval
        self.announce_interval_s = 2.0
        # unit-interval decorrelated walk in [0.5, 1.5], scaled by the
        # CURRENT announce_interval_s at each tick (tests shorten it live)
        self._announce_backoff = Backoff(
            min_delay=0.5, max_delay=1.5, decorrelated=True
        )
        self._next_announce = time.monotonic() + (
            self.announce_interval_s * self._announce_backoff.delay()
        )
        self._monitor_stop = threading.Event()
        self._monitor = threading.Thread(target=self._watchdog_loop, daemon=True)
        handler = _make_handler(self)
        self.httpd = ThreadingHTTPServer(("127.0.0.1", port), handler)
        self.port = self.httpd.server_port
        self.url = f"http://127.0.0.1:{self.port}"
        # task threads are named after the node: several workers share a
        # process in tests and on one card
        self._pool = ThreadPoolExecutor(
            max_workers=task_concurrency, thread_name_prefix=f"worker-{self.port}-task"
        )
        if self.memory_pool is not None:
            self.memory_pool.name = f"worker:{self.port}"
        if self.disk_pool is not None:
            self.disk_pool.name = f"worker:{self.port}"
        # consumer-side exchange link scorer (runtime/health.py): every
        # fetch this worker makes from a producer feeds its (self→producer)
        # link; the snapshot rides /v1/info so the coordinator can fold a
        # cluster link matrix — the asymmetric-partition detector
        self.link_health = LinkHealth(
            on_transition=lambda producer, old, new: _fr.record(
                "link_state", node=self.url, producer=producer,
                old=old, new=new,
            ),
        )
        # per-node utilization sampler (utils/timeseries.py): feeds this
        # worker's lane of the process-global ring TSDB every
        # timeseries.sample-interval-s; served at GET /v1/timeseries and
        # federated into the coordinator's cluster view
        self.sampler = _ts.Sampler(
            self.url,
            {
                "cpu_s": _ts.cpu_seconds,
                "rss_bytes": _ts.current_rss_bytes,
                "mem_reserved_bytes": lambda: (
                    self.memory_pool.snapshot()["reserved"]
                    if self.memory_pool is not None else None
                ),
                "mem_capacity_bytes": lambda: (
                    self.memory_pool.snapshot()["capacity"]
                    if self.memory_pool is not None else None
                ),
                "disk_reserved_bytes": lambda: (
                    self.disk_pool.snapshot()["reserved"]
                    if self.disk_pool is not None else None
                ),
                "split_backlog": self._split_backlog,
                "compile_inflight": _compile_inflight,
                "exchange_in_bytes": lambda: self.exchange_bytes_in,
                "exchange_out_bytes": lambda: self.exchange_bytes_out,
                "links_impaired": lambda: len(self.link_health.impaired()),
            },
            deltas={"cpu_s", "exchange_in_bytes", "exchange_out_bytes"},
        )
        # a short poll: kill() waits one poll for the serve loop
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, kwargs={"poll_interval": 0.05}, daemon=True
        )

    def _split_backlog(self) -> int:
        """Tasks accepted but not yet terminal — the worker-side queue
        depth the sampler tracks as `split_backlog`."""
        with self._lock:
            return sum(
                1 for t in self.tasks.values()
                if t.state in ("RUNNING", "BLOCKED")
            )

    def buffered_bytes(self) -> int:
        """Un-acknowledged output bytes parked in THIS worker's RAM (the
        number the reference's OutputBufferMemoryManager bounds); chunks
        spooled/spilled to disk do not count — that is the point."""
        return sum(self.buffered_by_query().values())

    def buffered_by_query(self) -> dict[str, int]:
        """RAM-resident output bytes per query (task ids are query-id
        prefixed) — the per-query reservation the coordinator's cluster
        memory manager aggregates to pick an OOM-kill victim (reference:
        MemoryInfo polled by ClusterMemoryManager.java:92)."""
        with self._lock:
            tasks = list(self.tasks.values())
        out: dict[str, int] = {}
        for t in tasks:
            # explicit payload query id; tasks posted without one (tests,
            # raw wire use) group under their own task id
            qid = t.query_id or t.task_id
            with t.cond:
                for chunks in t.buffers.values():
                    out[qid] = out.get(qid, 0) + sum(
                        len(c) for c in chunks if isinstance(c, (bytes, bytearray))
                    )
        return out

    def _finish_placed(self, task: _Task, buffers: dict[int, list[bytes]]) -> None:
        """Place chunks (RAM up to the byte budget, disk past it) and publish
        them — check-admit-publish holds one lock, so concurrent finishing
        tasks cannot each read a stale buffered_bytes and overcommit."""
        if self.buffer_memory_bytes is None:
            task.finish(buffers)
            return
        with self._place_lock:  # budget check-and-admit-publish is atomic
            used = self.buffered_bytes()
            out: dict[int, list] = {}
            for p, chunks in buffers.items():
                entries: list = []
                for i, blob in enumerate(chunks):
                    if used + len(blob) <= self.buffer_memory_bytes:
                        entries.append(blob)
                        used += len(blob)
                    else:
                        path = os.path.join(
                            self._spill_dir, f"{task.task_id}_b{p}_t{i}.bin"
                        )
                        # governed spill: lease the bytes (block -> reclaim
                        # -> typed shed) and write through the ENOSPC guard.
                        # The lease's path makes it self-releasing: the ack
                        # / delete_task unlink is harvested by the pool's
                        # refresh pass at the next pressure event.
                        if self.disk_pool is not None:
                            self.disk_pool.reserve(
                                task.task_id,
                                len(blob),
                                timeout_s=self.disk_blocked_timeout_s,
                                what=f"buffer spill {task.task_id}",
                                path=path,
                                abort=lambda: task.canceled,
                            )
                        guarded_write(path, blob)
                        self.spilled_chunks += 1
                        entries.append(path)
                out[p] = entries
            task.finish(out)

    def start(self) -> "Worker":
        self._thread.start()
        self._monitor.start()
        self.sampler.start()  # no-op when the timeseries plane is disabled
        return self

    # ------------------------------------------------------------ lifecycle
    def stop(self, graceful_timeout_s: float = 2.0) -> None:
        """Graceful-by-default shutdown: route through the drain path with a
        short deadline so running tasks commit their buffered output before
        exit (reference: GracefulShutdownHandler waiting out active tasks),
        then hard-stop.  `graceful_timeout_s=0` skips straight to kill()."""
        if graceful_timeout_s > 0:
            self.drain(
                task_deadline_s=graceful_timeout_s,
                ack_deadline_s=0.0,
                deregister=False,
            )
        self.kill()

    def kill(self) -> None:
        """Hard stop — the SIGKILL analogue the chaos tests use to exercise
        recovery paths: no drain, in-flight work is abandoned.  Handler
        threads still inside a request (a status long-poll) drop their
        connection unanswered, as a killed process's would: a task that
        finishes after the kill is never reported FINISHED."""
        self._killed = True
        self._monitor_stop.set()
        self.sampler.stop()
        self.httpd.shutdown()
        self.httpd.server_close()  # close the listening socket: connection
        # attempts fail fast instead of hanging in the kernel accept queue
        self._pool.shutdown(wait=False, cancel_futures=True)
        if self._spill_dir is not None:
            import shutil

            shutil.rmtree(self._spill_dir, ignore_errors=True)

    def request_drain(self) -> None:
        """Async drain trigger (PUT /v1/info/state, SIGTERM): flips the
        state immediately so the next heartbeat/dispatch sees DRAINING, and
        completes the drain on a background thread."""
        with self._lock:
            already = self.state != "active"
            if not already:
                self.state = "draining"
        if already:
            return
        self._m_drains.inc()
        threading.Thread(
            target=self.drain, kwargs={"entered": True}, daemon=True
        ).start()

    def drain(
        self,
        task_deadline_s: float = 60.0,
        ack_deadline_s: float = 30.0,
        deregister: bool = True,
        entered: bool = False,
    ) -> bool:
        """Graceful drain (reference: GracefulShutdownHandler): stop
        accepting tasks, let running tasks finish + spool-commit, keep
        serving exchange fetches until consumers are done with this
        worker's buffers (acked everything, or the coordinator deleted the
        tasks at query end), then deregister.  Returns True when the worker
        fully quiesced within the deadlines."""
        if not entered:
            with self._lock:
                first = self.state == "active"
                if first:
                    self.state = "draining"
            if first:
                self._m_drains.inc()
        with self.tracer.span("drain", worker=self.url):
            quiesced = self._await_no_running_tasks(task_deadline_s)
            drained = self._await_buffers_drained(ack_deadline_s)
        with self._lock:
            self.state = "drained"
        if deregister:
            self._deregister()
        return quiesced and drained

    def _await_no_running_tasks(self, deadline_s: float) -> bool:
        deadline = time.monotonic() + deadline_s
        while True:
            with self._lock:
                running = [
                    t for t in self.tasks.values() if t.state == "RUNNING"
                ]
            if not running:
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.05)

    def _await_buffers_drained(self, deadline_s: float) -> bool:
        """Wait until no consumer still needs this worker: every buffer
        chunk acked (entry None), or every task deleted (the coordinator
        DELETEs all tasks at query end — phased/FTE consumers never ack, so
        deletion is their 'done' signal)."""
        deadline = time.monotonic() + deadline_s
        while True:
            with self._lock:
                tasks = list(self.tasks.values())
            pending = False
            for t in tasks:
                with t.cond:
                    if t.state == "RUNNING":
                        pending = True
                    for chunks in t.buffers.values():
                        if any(c is not None for c in chunks):
                            pending = True
            if not pending:
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.05)

    @property
    def coordinator_url(self) -> Optional[str]:
        """Single-coordinator compatibility view of coordinator_urls."""
        return self.coordinator_urls[0] if self.coordinator_urls else None

    @coordinator_url.setter
    def coordinator_url(self, url: Optional[str]) -> None:
        self.coordinator_urls = [url.rstrip("/")] if url else []

    def _deregister(self) -> None:
        """Goodbye-announce (reference: the discovery server aging out a
        SHUTTING_DOWN node): tells EVERY coordinator to forget this worker
        NOW, so post-drain heartbeat probes don't read as failures and trip
        a circuit breaker into QUARANTINED."""
        for base in self.coordinator_urls:
            try:
                req = urllib.request.Request(
                    f"{base}/v1/announce",
                    data=json.dumps(
                        {"url": self.url, "event": "goodbye"}
                    ).encode(),
                    headers={"Content-Type": "application/json"},
                )
                with urllib.request.urlopen(req, timeout=5) as r:
                    r.read()
            except Exception:
                pass  # best-effort; the DRAINING overlay still holds

    def _announce(self) -> None:
        """Keep-alive announce to every fleet coordinator (best-effort):
        while one is down its announce fails silently and retries next
        interval; the moment a replacement binds the port it re-registers
        us — and every OTHER member keeps its registration the whole time,
        so an adopter dispatches to this worker without waiting."""
        for base in self.coordinator_urls:
            try:
                req = urllib.request.Request(
                    f"{base}/v1/announce",
                    data=json.dumps({"url": self.url}).encode(),
                    headers={"Content-Type": "application/json"},
                )
                with urllib.request.urlopen(req, timeout=2) as r:
                    r.read()
            except Exception:
                pass

    def _watchdog_loop(self) -> None:
        """No-progress watchdog: fail RUNNING tasks whose progress beats
        froze past their payload timeout while status still says RUNNING —
        today a wedged task blocks its consumer for the full status-poll
        ceiling (reference: stuck-task detection the coordinator's
        QueryTracker does on frozen TaskStats)).

        Also carries the periodic keep-alive announce: a coordinator
        restarted while this worker kept serving re-learns the worker
        within one announce interval, with no operator action — the
        discovery-service heartbeat the reference nodes send."""
        while not self._monitor_stop.wait(0.25):
            now = time.monotonic()
            if (
                self.coordinator_url
                and self.state == "active"
                and self.announce_interval_s > 0
                and now >= self._next_announce
            ):
                self._next_announce = now + (
                    self.announce_interval_s * self._announce_backoff.delay()
                )
                self._announce()
            with self._lock:
                tasks = list(self.tasks.values())
            for t in tasks:
                if (
                    t.watchdog_armed
                    and t.no_progress_timeout_s > 0
                    and t.state == "RUNNING"
                    and now - t.last_progress_at > t.no_progress_timeout_s
                ):
                    self._m_no_progress.inc()
                    self._m_tasks.labels("no_progress_killed").inc()
                    t.fail(
                        f"task {t.task_id} made no progress for "
                        f"{now - t.last_progress_at:.1f}s "
                        f"(no_progress_timeout_s="
                        f"{t.no_progress_timeout_s}) [NO_PROGRESS]"
                    )

    # ------------------------------------------------------- task execution
    def submit_task(self, req: dict) -> _Task:
        task_id = req["task_id"]
        with self._lock:
            if self.state != "active":
                self._m_tasks.labels("rejected_draining").inc()
                raise DrainingError(
                    f"worker {self.url} is {self.state}; not accepting tasks"
                )
            task = _Task(task_id, query_id=req.get("query_id"))
            task.no_progress_timeout_s = float(
                req.get("no_progress_timeout_s") or 0.0
            )
            self.tasks[task_id] = task
        self._m_tasks.labels("accepted").inc()
        self._pool.submit(self._run_task, task, req)
        return task

    def _run_task(self, task: _Task, req: dict) -> None:
        import time as _time

        t0 = _time.perf_counter()
        # arm the no-progress watchdog only now that the thread is live — a
        # task queued behind a saturated pool is waiting, not wedged
        task.progress()
        task.watchdog_armed = True
        # join the coordinator's trace: the task span (and any children)
        # shares the query's trace_id (W3C traceparent, utils/tracing.py)
        self.tracer.join(req.get("traceparent"))
        _fr.record(
            "task_start", node=self.url, query_id=task.query_id,
            task_id=task.task_id,
        )
        try:
            with self.tracer.span(
                "task", task_id=task.task_id, query_id=task.query_id or "",
                worker=self.url,
            ):
                self._run_task_inner(task, req, t0)
            # the watchdog may have failed this task while it was wedged;
            # a late successful run must not count (or report) as finished
            if task.state == "FINISHED":
                self._m_tasks.labels("finished").inc()
            _fr.record(
                "task_finish", node=self.url, query_id=task.query_id,
                task_id=task.task_id, state=task.state,
                wall_ms=round((_time.perf_counter() - t0) * 1e3, 1),
            )
        except Exception as e:
            if not task.canceled:  # canceled attempts fail by design
                traceback.print_exc()
            if task.state == "RUNNING":
                task.stats = {
                    "wall_ms": (_time.perf_counter() - t0) * 1e3,
                    "operators": {},
                }
            task.fail(str(e))
            self._m_tasks.labels("failed").inc()
            _fr.record(
                "task_fail", node=self.url, query_id=task.query_id,
                task_id=task.task_id, error=str(e)[:200],
                canceled=bool(task.canceled),
            )
        finally:
            if task.mem_lease is not None:
                task.mem_lease.release()  # idempotent with delete_task
            self._m_task_seconds.observe(_time.perf_counter() - t0)

    def _run_task_inner(self, task: _Task, req: dict, t0: float) -> None:
        import time as _time

        fragment = plan_from_json(req["fragment"])

        # node-pool reservation BEFORE any work touches device memory.  A
        # full pool parks the task here (state=BLOCKED, visible in /status
        # and /ui) until a peer query frees bytes — the reference's
        # non-immediate setBytes future (LocalMemoryContext.java:31) —
        # escalating to MemoryExceeded past memory_blocked_timeout_s.
        # Leases over fragments with spillable, scan-sliceable state are
        # REVOCABLE: the cluster memory manager may force-spill them
        # instead of killing a query.
        reserve_bytes = int(req.get("memory_reserve_bytes") or 0)
        mem_blocked_ms = 0.0
        if self.memory_pool is not None and reserve_bytes:
            timeout_s = req.get("memory_blocked_timeout_s")
            t_r0 = _time.perf_counter()

            # flight-recorder lane attribution rides the existing memory
            # hooks: park/unpark/revoke are the events a post-mortem needs
            # to explain a task that sat BLOCKED or degraded to spill
            def _on_block() -> None:
                task.set_blocked(True)
                _fr.record(
                    "task_park", node=self.url, query_id=task.query_id,
                    task_id=task.task_id, bytes=reserve_bytes,
                )

            def _on_unblock() -> None:
                task.set_blocked(False)
                _fr.record(
                    "task_unpark", node=self.url, query_id=task.query_id,
                    task_id=task.task_id,
                )

            def _on_revoke() -> None:
                task.revoke_requested = True
                _fr.record(
                    "task_revoke", node=self.url, query_id=task.query_id,
                    task_id=task.task_id,
                )

            task.mem_lease = self.memory_pool.reserve(
                task.query_id or task.task_id,
                reserve_bytes,
                revocable=_fragment_revocable(fragment),
                timeout_s=float(timeout_s) if timeout_s else None,
                what=f"task {task.task_id} reservation",
                on_block=_on_block,
                on_unblock=_on_unblock,
                on_revoke=_on_revoke,
                abort=lambda: task.canceled,
            )
            mem_blocked_ms = (_time.perf_counter() - t_r0) * 1e3

        # fault matrix (FailureInjector.java:33): ERROR/TIMEOUT raise
        # here, SLOW delays and falls through to normal execution.  A SLOW
        # wedge sits between two progress beats, so the no-progress
        # watchdog sees frozen stats — exactly the wedged-task shape it
        # exists to catch.  The hook runs AFTER the reservation: a SLOW
        # fault holds its bytes while sleeping, which is the deterministic
        # memory-pressure lever the governance tests lean on.
        self.fault_injector.task_fault(task.task_id)
        task.progress()
        # a revocation-sliced run drops its slices' columns between slices:
        # it gets a scan cache of its own
        revocable_run = task.revoke_requested and not req.get("analyze") \
            and not req.get("split_pad_rows")
        executor = LocalExecutor(
            self.catalogs, self.default_catalog, device=self.device,
            scan_cache=None if revocable_run else self.scan_cache,
        )
        executor.split = (req["part"], req["num_parts"])
        if req.get("split_pad_rows"):
            # split-driven scan (runtime/splits.py): this task IS one
            # fixed-capacity morsel — every scan page pads to the same
            # capacity regardless of data scale
            executor.split_pad_rows = int(req["split_pad_rows"])
        executor.collect_operator_stats = True
        if req.get("memory_budget_bytes"):
            executor.memory_budget_bytes = int(req["memory_budget_bytes"])
        # the compile plane (exec/compilesvc.py): the task waits for kernel
        # 2's build as long as the payload says, and COMPILE_SLOW /
        # COMPILE_FAIL faults armed on this worker fire inside the build
        executor.compile_wait_budget_ms = int(req.get("compile_wait_budget_ms") or 0)
        executor.compile_deadline_s = float(req.get("compile_deadline_s") or 0.0)
        executor.fault_injector = self.fault_injector
        executor.fault_task_id = task.task_id

        fetched_bytes = 0
        fetched_rows = 0
        remote_pages: dict[int, Page] = {}
        # per-link accounting (observatory plane): bytes + transfer wall
        # per producer URL, accrued inside _stream_fetch on productive
        # responses only — rides task.stats so the coordinator can fold
        # per-stage exchange GB/s without another round-trip
        link_stats: dict[str, dict] = {}
        # exchange-wait attribution for the phase ledger: the whole source
        # loop is dominated by long-polling producers' buffers (the decode
        # riding along is noise next to the waits)
        t_fetch0 = _time.perf_counter()
        for fid_str, src in req.get("sources", {}).items():
            fid = int(fid_str)
            kind = src["kind"]
            my_part = req["part"]
            blobs: list[bytes] = []
            if not (kind == "single" and my_part != 0):
                buffer_id = my_part if kind == "repartition" else 0
                # gather/broadcast/single buffers are read by EVERY
                # consumer task — acknowledging would free chunks under
                # the other readers (the reference gives each consumer
                # its own ClientBuffer; we share and skip the ack).
                # Under retry_policy=TASK the coordinator also disables
                # acks (ack_sources=False): a re-scheduled consumer must
                # be able to re-read its sources from token 0.
                ack = kind == "repartition" and req.get("ack_sources", True)
                for (u, t) in src["tasks"]:
                    if task.canceled:
                        raise RuntimeError("task canceled")
                    if u == SPOOL_URL:
                        # producer is gone; its committed output lives in
                        # the durable exchange (re-read, not recompute)
                        spool = SpooledExchange(req["exchange_dir"])
                        if self.fault_injector.spool_lost(t):
                            # SPOOL_LOST chaos: the committed partition
                            # vanishes right before we read it — the typed
                            # failure below must drive a reproduction, not
                            # a query failure
                            spool.discard(t)
                        try:
                            blobs.extend(spool.read_chunks(t, buffer_id))
                        except (FileNotFoundError, PageTransportError) as e:
                            # typed self-healing signal: the coordinator
                            # parses the producer task id out of this
                            # marker, re-runs the producer under
                            # first-commit-wins, then retries this task
                            raise RuntimeError(
                                f"SPOOL_LOST:{t}: committed spool "
                                f"partition missing or corrupt: {e}"
                            ) from e
                    else:
                        if req.get("exchange_dir") and (
                            self.fault_injector.spool_lost(t)
                        ):
                            # SPOOL_LOST chaos, HTTP flavor: the producer's
                            # committed partition vanishes from the shared
                            # exchange dir — its worker will 410 the fetch
                            SpooledExchange(req["exchange_dir"]).discard(t)
                        try:
                            blobs.extend(
                                self._fetch_source(
                                    u, t, buffer_id, ack=ack, req=req,
                                    link_stats=link_stats,
                                )
                            )
                        except RuntimeError as e:
                            if "spooled chunk removed" in str(e):
                                # the serving worker's backing file is gone
                                # (HTTP 410): same healing path as a direct
                                # spool read failure
                                raise RuntimeError(
                                    f"SPOOL_LOST:{t}: {e}"
                                ) from e
                            raise
            from ..data.types import parse_type

            fetched_bytes += sum(len(b) for b in blobs)
            types = [parse_type(t) for t in src["types"]]
            # pad exchange pages to pow2 capacity (dead-row live mask —
            # the spill executor's idiom): slices of varying sizes share
            # O(log n) shapes and one set of learned capacities
            remote_pages[fid] = wire_to_page(
                blobs, types, pad_pow2=True, device=self.device
            )
            fetched_rows += _page_rows(remote_pages[fid])
            task.progress()  # each fetched source is a watchdog beat
        exchange_wait_ms = (_time.perf_counter() - t_fetch0) * 1e3
        self._m_fetched_bytes.inc(fetched_bytes)
        self._m_exchange_bytes.labels("in").inc(fetched_bytes)
        self.exchange_bytes_in += fetched_bytes

        # dynamic filtering: fetched build-side key domains narrow the
        # probe scans before upload (exec/dynfilter.py; reference:
        # DynamicFilterService.java:103)
        from ..exec.dynfilter import collect_dynamic_filters

        executor.scan_filters = collect_dynamic_filters(fragment, remote_pages)

        out_kind = req["output_kind"]
        out_parts = req["out_parts"]
        spill_ms = 0.0
        # a split-driven task is already a single bounded morsel: re-slicing
        # it 4x buys nothing (the working set is the pad capacity either
        # way) — the coordinator honors the revocation instead by PARKING
        # the worker's queued splits (runtime/splits.py)
        revoked = (
            task.revoke_requested
            and not req.get("analyze")
            and not req.get("split_pad_rows")
        )
        if req.get("analyze"):
            # distributed EXPLAIN ANALYZE: the eager node-hook pass adds
            # per-operator wall ms on top of the exact row counts
            page, an_stats = executor.explain_analyze(fragment, remote_pages)
            operators = executor.last_operator_stats
            for nid, s in an_stats.items():
                if "ms" in s:
                    operators.setdefault(nid, {})["ms"] = round(s["ms"], 3)
        elif revoked:
            # revocation-driven spill: the cluster memory manager shrank
            # this task's lease; honor it with sliced (partitioned)
            # execution so the instantaneous working set matches the
            # shrunken reservation (exec/spill.py's time-multiplexed idiom)
            page = None
            t_spill0 = _time.perf_counter()
            buffers, rows_out, operators = self._execute_sliced(
                executor, fragment, remote_pages, req, task
            )
            spill_ms = (_time.perf_counter() - t_spill0) * 1e3
        else:
            page = executor.execute(fragment, remote_pages)
            operators = executor.last_operator_stats
        task.progress()  # execution done — beat before output partitioning

        if page is not None:
            if out_kind == "repartition":
                from ..plan.serde import _decode

                keys = [_decode(k) for k in req["output_keys"]]
                chunk_lists = partition_page(page, keys, out_parts)
                buffers = {p: chunks for p, chunks in enumerate(chunk_lists)}
            else:  # gather / broadcast / single / result
                buffers = {0: page_to_wire_chunks(page)}
            rows_out = _page_rows(page)

        # stats must be on the task BEFORE finish() notifies status waiters
        task.stats = {
            "wall_ms": round((_time.perf_counter() - t0) * 1e3, 3),
            "operators": {str(k): v for k, v in operators.items()},
            "rows_out": rows_out,
            "output_bytes": sum(
                len(c) for chunks in buffers.values() for c in chunks
            ),
            "exchange_bytes_fetched": fetched_bytes,
            "exchange_rows_fetched": fetched_rows,
            "rows_pruned": executor.rows_pruned,
            # host ms this task spent reading and uploading table slices
            # (0 when the worker's scan cache held them all)
            "upload_ms": round(executor.last_upload_ms, 3),
            "memory_reserved_bytes": reserve_bytes,
            "memory_blocked_ms": round(mem_blocked_ms, 3),
            "memory_revoked": bool(revoked),
            # phase-ledger attribution (coordinator sums these across
            # tasks): compile wall covers every kernel this task built
            # (kernel 2's NVRTC recipes), execute wall the rest of the
            # last run
            "compile_ms": round(
                sum(
                    # classic/fresh events carry the compile wall; joined
                    # and fallback events carry only the wall THIS task
                    # spent waiting on the service
                    ev["compile_s"] * 1e3 if ev.get("compile_s") is not None
                    else float(ev.get("wait_ms") or 0.0)
                    for ev in getattr(executor, "compile_events", [])
                ),
                3,
            ),
            "execute_ms": round(getattr(executor, "last_execute_ms", 0.0), 3),
            "exchange_wait_ms": round(exchange_wait_ms, 3),
            "spill_ms": round(spill_ms, 3),
            "compile_events": list(getattr(executor, "compile_events", [])),
            # roofline plane: every signature this task dispatched, with
            # execute wall and the profiler's flops/bytes per execution
            "execute_events": _execute_events(executor),
            # fallback phase attribution (compile resilience plane): the
            # coordinator folds these into QueryInfo and the phase ledger
            "fallback": bool(getattr(executor, "fallback_events", None)),
            "fallback_executions": len(
                getattr(executor, "fallback_events", []) or []
            ),
            "fallback_reasons": _count_reasons(
                getattr(executor, "fallback_events", []) or []
            ),
            # link grades ride task stats too (not just the heartbeat):
            # the coordinator sees a partition the moment the first
            # affected task reports, not an interval later
            "links_impaired": self.link_health.impaired(),
            # per-producer exchange accounting: {url: {bytes, wall_ms,
            # fetches}} — the coordinator folds these into per-stage
            # exchange GB/s and the `-- exchange:` footer
            "exchange_links": {
                u: dict(s) for u, s in link_stats.items()
            },
        }

        if task.canceled:
            # aborted mid-run (speculation loser, query cleanup): a late
            # commit after remove_query would leak task dirs in the spool
            raise RuntimeError("task canceled")
        exchange_dir = req.get("exchange_dir")
        if exchange_dir:
            # durable spooled exchange: commit to storage FIRST, then
            # serve every chunk from the spool files — worker RAM holds
            # no finished output (bounded memory + dead-producer re-read).
            # The node disk pool governs the commit: lease -> reclaim ->
            # block -> typed EXCEEDED_SPILL_LIMIT, never a raw ENOSPC.
            spool = SpooledExchange(exchange_dir, disk_pool=self.disk_pool)
            spool.disk_blocked_timeout_s = self.disk_blocked_timeout_s
            # per-attempt staging dir (speculation runs two live attempts
            # of the same task id); the spool's rename publish arbitrates
            # first-commit-wins — the loser's bytes are discarded and
            # consumers address one canonical committed dir either way
            spool.commit_task(
                task.task_id, buffers, attempt=str(req.get("attempt") or 0)
            )
            task.progress()
            task.finish(
                {
                    p: [
                        spool.chunk_path(task.task_id, p, i)
                        for i in range(len(chunks))
                    ]
                    for p, chunks in buffers.items()
                }
            )
        else:
            self._finish_placed(task, buffers)

    def _execute_sliced(
        self,
        executor: LocalExecutor,
        fragment,
        remote_pages: dict[int, Page],
        req: dict,
        task: _Task,
    ) -> tuple[dict[int, list], int, dict]:
        """Forced-spill execution after revocation: run this task's split
        range in REVOKE_SPILL_PARTS sequential sub-slices (exec/spill.py's
        time-multiplexed out-of-core idiom), so the instantaneous working
        set is ~1/P of the full-width footprint.  Correct whenever the
        fragment contains a TableScan: sub-slicing the scan range is
        indistinguishable from the coordinator having scheduled P× more
        tasks — partial aggregates / probe slices merge downstream exactly
        as more tasks would, and exchange inputs (broadcast build sides,
        dynamic-filter domains) are loop-invariant across slices."""
        from ..plan.serde import _decode

        part, num_parts = int(req["part"]), int(req["num_parts"])
        out_kind = req["output_kind"]
        out_parts = int(req["out_parts"])
        keys = (
            [_decode(k) for k in req["output_keys"]]
            if out_kind == "repartition"
            else None
        )
        # pad every slice to the slices' common size so the P executions
        # share one set of learned capacities
        executor.pad_splits = True
        nbuf = out_parts if out_kind == "repartition" else 1
        buffers: dict[int, list] = {p: [] for p in range(nbuf)}
        rows_out = 0
        operators: dict = {}
        for s in range(REVOKE_SPILL_PARTS):
            if task.canceled:
                raise RuntimeError("task canceled")
            executor.split = (
                part * REVOKE_SPILL_PARTS + s,
                num_parts * REVOKE_SPILL_PARTS,
            )
            # drop the previous slice's uploaded table columns — holding
            # them across slices is exactly what revocation forbids
            executor.drop_scans()
            page = executor.execute(fragment, remote_pages)
            rows_out += _page_rows(page)
            for nid, st in executor.last_operator_stats.items():
                agg = operators.setdefault(nid, {})
                for k, v in st.items():
                    if isinstance(v, (int, float)):
                        agg[k] = agg.get(k, 0) + v
                    else:
                        agg[k] = v
            if keys is not None:
                for p, chunks in enumerate(
                    partition_page(page, keys, out_parts)
                ):
                    buffers[p].extend(chunks)
            else:
                buffers[0].extend(page_to_wire_chunks(page))
            task.progress()  # each finished slice is a watchdog beat
        return buffers, rows_out, operators

    # ---------------------------------------------------- hedged source fetch
    def _fetch_source(
        self, u: str, t: str, buffer_id: int, ack: bool, req: dict,
        link_stats: Optional[dict] = None,
    ) -> list[bytes]:
        """Fetch one producer buffer with link-health accounting, a
        propagated deadline budget, and — when the durable exchange is
        configured — a HEDGED alternate path: a fetch still in flight past
        the link's history-quantile hedge delay (or whose link breaker is
        already open) races a direct read of the producer's spool-committed
        partition.  First result wins via the existing token idempotency;
        the loser is canceled at its next attempt.  Reference: the tail-
        at-scale hedged-request pattern applied to the FTE exchange."""
        deadline_ts = float(req.get("deadline_ts") or 0.0)
        headroom_s = (
            float(req.get("exchange_deadline_headroom_ms") or 500.0) / 1000.0
        )
        rotate = int(req.get("exchange_retry_rotate") or 3)
        quantile = float(req.get("hedge_delay_quantile") or 0.95)
        exchange_dir = req.get("exchange_dir") or ""
        lh = self.link_health

        def _read_spool() -> Optional[list[bytes]]:
            try:
                return SpooledExchange(exchange_dir).try_read_chunks(
                    t, buffer_id
                )
            except Exception:
                return None  # corrupt/unreadable: the HTTP path decides

        if not exchange_dir:
            # no durable exchange => no hedge path: plain fetch, but the
            # link still accrues health and honors the deadline budget
            return _stream_fetch(
                u, t, buffer_id, ack=ack, node=self.url, consumer=self.url,
                health=lh, deadline_ts=deadline_ts, headroom_s=headroom_s,
                link_stats=link_stats,
            )
        if lh.state(u) == DEAD and not lh.should_probe(u):
            # link breaker OPEN and the half-open window closed: skip the
            # doomed primary entirely when the spool can serve (consult
            # link state BEFORE re-hitting a dead endpoint)
            blobs = _read_spool()
            if blobs is not None:
                HEDGED_FETCHES.labels("won").inc()
                _fr.record(
                    "hedged_fetch", node=self.url, task_id=t, producer=u,
                    outcome="won", reason="breaker_open",
                )
                return blobs
        result: dict = {}
        done = threading.Event()
        hedge_won = threading.Event()

        def _primary():
            try:
                result["blobs"] = _stream_fetch(
                    u, t, buffer_id, ack=ack, node=self.url,
                    consumer=self.url, health=lh, deadline_ts=deadline_ts,
                    headroom_s=headroom_s, max_transient=rotate,
                    abort=hedge_won.is_set, link_stats=link_stats,
                )
            except BaseException as e:
                result["err"] = e
            finally:
                done.set()

        threading.Thread(target=_primary, daemon=True).start()
        delay = lh.hedge_delay(u, quantile=quantile)
        hedged = False
        while not done.wait(timeout=delay):
            # the primary is in flight past the hedge delay: race the
            # spool.  An uncommitted producer returns None — keep waiting
            # and re-probe each interval (the producer commits its output
            # independently of the broken consumer-side link).
            hedged = True
            blobs = _read_spool()
            if blobs is not None:
                hedge_won.set()  # loser canceled at its next attempt
                HEDGED_FETCHES.labels("won").inc()
                _fr.record(
                    "hedged_fetch", node=self.url, task_id=t, producer=u,
                    outcome="won", reason="hedge_delay",
                )
                return blobs
        err = result.get("err")
        if err is None:
            if hedged:
                HEDGED_FETCHES.labels("lost").inc()
                _fr.record(
                    "hedged_fetch", node=self.url, task_id=t, producer=u,
                    outcome="lost",
                )
            return result["blobs"]
        # the primary failed — rotation budget spent, deadline exhausted,
        # or a permanent verdict: last-chance spool read before the typed
        # error escapes to drive the coordinator's reproduction path
        blobs = _read_spool()
        if blobs is not None:
            HEDGED_FETCHES.labels("won").inc()
            _fr.record(
                "hedged_fetch", node=self.url, task_id=t, producer=u,
                outcome="won", reason="primary_failed",
            )
            return blobs
        if hedged:
            HEDGED_FETCHES.labels("failed").inc()
        raise err

    # -------------------------------------------------------- buffer access
    def get_chunk(self, task_id: str, buffer_id: int, token: int, wait: float):
        """-> (code, body, headers).  Long-polls until the chunk exists, the
        buffer completes, or `wait` elapses."""
        with self._lock:
            task = self.tasks.get(task_id)
        if task is None:
            return 404, b"no such task", {}
        deadline = wait
        with task.cond:
            while True:
                if task.state == "FAILED":
                    return 500, (task.error or "task failed").encode(), {}
                chunks = task.buffers.get(buffer_id)
                if chunks is not None and token < len(chunks):
                    blob = chunks[token]
                    if blob is None:
                        return 410, b"chunk acknowledged and freed", {}
                    if isinstance(blob, str):  # spooled/spilled: read back
                        try:
                            with open(blob, "rb") as f:
                                blob = f.read()
                        except OSError:
                            return 410, b"spooled chunk removed", {}
                    last = task.complete and token == len(chunks) - 1
                    task.bytes_served += len(blob)
                    self._m_served_bytes.inc(len(blob))
                    self._m_exchange_bytes.labels("out").inc(len(blob))
                    self.exchange_bytes_out += len(blob)
                    return 200, blob, {"X-Complete": "1" if last else "0"}
                if task.complete:
                    # past the end: buffer exhausted
                    return 200, b"", {"X-Complete": "1", "X-No-Data": "1"}
                if deadline <= 0:
                    return 200, b"", {"X-Complete": "0", "X-No-Data": "1"}
                task.cond.wait(timeout=min(deadline, 1.0))
                deadline -= 1.0

    def acknowledge(self, task_id: str, buffer_id: int, token: int) -> None:
        with self._lock:
            task = self.tasks.get(task_id)
        if task is None:
            return
        with task.cond:
            chunks = task.buffers.get(buffer_id)
            if chunks is not None:
                for i in range(min(token, len(chunks))):
                    entry = chunks[i]
                    if isinstance(entry, str) and self._is_local_spill(entry):
                        # local spill files free with the ack; durable
                        # exchange files outlive the task (retry re-reads)
                        try:
                            os.unlink(entry)
                        except OSError:
                            pass
                    if entry is not None:
                        self._m_acks.inc()
                    chunks[i] = None

    def task_status(self, task_id: str, wait: float) -> dict:
        with self._lock:
            task = self.tasks.get(task_id)
        if task is None:
            return {"state": "UNKNOWN"}
        with task.cond:
            # BLOCKED (parked on node memory) is still pending — a status
            # long-poll keeps waiting through it just like RUNNING
            if task.state in ("RUNNING", "BLOCKED") and wait > 0:
                task.cond.wait(timeout=wait)
            st = {"state": task.state, "error": task.error}
            if task.stats:
                st["stats"] = dict(
                    task.stats, exchange_bytes_served=task.bytes_served
                )
            return st

    def flightrecorder_nodes(self) -> list[str]:
        """This worker's flight-recorder `node` aliases: its URL (task and
        exchange events) and its pool name (memory/disk lease events).  The
        /v1/flightrecorder endpoint filters on these so in-process test
        clusters sharing one ring still serve disjoint per-node lanes."""
        return [self.url, f"worker:{self.port}"]

    def metrics_text(self) -> str:
        """Prometheus exposition for this worker + the process-global
        registry (spill, caches, SPMD exchange planning)."""
        self._m_buffered.set(self.buffered_bytes())
        if self.memory_pool is not None:
            snap = self.memory_pool.snapshot()
            self._m_pool_capacity.set(snap["capacity"])
            self._m_pool_reserved.set(snap["reserved"])
            self._m_pool_blocked.set(snap["blocked"])
        if self.disk_pool is not None:
            # snapshot() refreshes the GLOBAL trino_tpu_disk_pool_* gauges
            # (labeled by this pool's name) rendered via `extra` below
            self.disk_pool.snapshot()
        return self.metrics.render(extra=_metrics.GLOBAL)

    def revoke_query_memory(self, query_id: str) -> int:
        """Execute a coordinator revocation request: force-spill every
        revocable lease of `query_id` on this node (POST /v1/memory/revoke).
        Returns bytes freed; 0 when nothing was revocable.

        The pool counts nominal bytes; the card holds real ones.  So a
        revocation also gives back the device memory this node caches: the
        scan cache's uploaded columns and pages leave the card (running
        tasks keep the pages they hold; the revoked tasks run sliced on a
        cache of their own), and the caching allocator returns its free
        blocks."""
        if self.memory_pool is None:
            return 0
        freed = self.memory_pool.revoke_query(
            query_id, spill_parts=REVOKE_SPILL_PARTS
        )
        if freed > 0:
            self._m_revocations.inc()
            self.revoked_device_bytes += self.scan_cache.drop_device()
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
        return freed

    def _is_local_spill(self, path: str) -> bool:
        return self._spill_dir is not None and path.startswith(self._spill_dir)

    def delete_task(self, task_id: str) -> None:
        with self._lock:
            task = self.tasks.pop(task_id, None)
        if task is not None:
            task.canceled = True
            # free the node-pool reservation NOW (not at thread exit): a
            # killed query's bytes must unblock parked peers immediately
            if task.mem_lease is not None:
                task.mem_lease.release()
            with task.cond:
                for chunks in task.buffers.values():
                    for entry in chunks:
                        if isinstance(entry, str) and self._is_local_spill(entry):
                            try:
                                os.unlink(entry)
                            except OSError:
                                pass
                task.buffers = {}


def _compile_inflight() -> int:
    """Kernel builds running or queued in the compile service (kernel 2's
    NVRTC recipes, exec/compilesvc.py) — the sampler's `compile_inflight`
    lane."""
    from ..exec.compilesvc import SERVICE

    return SERVICE.inflight()


def _execute_events(executor) -> dict[str, dict]:
    """The executor's per-signature run ledger joined with the
    process-global profiler's flops / bytes-accessed for each signature,
    where it holds any (the port measures none: its entries carry run
    counts and walls only, and the coordinator's roofline fold skips
    them).  The join happens in the process that ran the fragment."""
    from ..utils.profiler import PROFILER

    out: dict[str, dict] = {}
    for sig, ev in (getattr(executor, "execute_events", None) or {}).items():
        rec = dict(ev)
        prof = PROFILER.snapshot(sig) or {}
        if prof.get("flops") is not None:
            rec["flops"] = prof["flops"]
        if prof.get("bytes_accessed") is not None:
            rec["bytes_accessed"] = prof["bytes_accessed"]
        out[sig] = rec
    return out


def _count_reasons(fallback_events: list) -> dict[str, int]:
    """reason -> count over an executor's fallback ledger (task stats)."""
    out: dict[str, int] = {}
    for ev in fallback_events:
        r = ev.get("reason") or "compile_wait"
        out[r] = out.get(r, 0) + 1
    return out


def _page_rows(page: Page) -> int:
    if page.live is None:
        return page.capacity
    return int(page.live.sum())  # one scalar read


def _stream_fetch(
    worker_url: str,
    task_id: str,
    buffer_id: int,
    ack: bool = True,
    backoff: Optional[Backoff] = None,
    node: str = "",
    consumer: str = "",
    health=None,
    deadline_ts: float = 0.0,
    headroom_s: float = 0.5,
    max_transient: int = 0,
    abort=None,
    link_stats: Optional[dict] = None,
) -> list[bytes]:
    """Token-sequenced consumption of one producer buffer with acknowledge —
    the reference's HttpPageBufferClient loop (sendGetResults:355, token+ack
    :406-424).  Retries make delivery at-least-once; exact token addressing
    makes assembly exactly-once.

    Transient errors (connection failures, HTTP 502/503/504 — including
    injected EXCHANGE_DROP faults) retry through a jittered exponential
    Backoff and RESUME from the current token: already-fetched chunks are
    never re-appended, already-sent acks never un-free.  Only the backoff
    deadline escalates to a task-level failure.  Permanent errors (500 ==
    producer task failed, 404/410 == buffer gone) raise immediately.

    Partition tolerance (runtime/health.py): `consumer` rides the request
    (query param + X-Trino-Consumer) so the producer can attribute the
    link; `health` accrues per-link EWMA error/latency; `deadline_ts` is
    the query's epoch deadline — a fetch with less than `headroom_s` of
    budget left fails fast with the typed EXCHANGE_UNREACHABLE marker
    instead of burning whole-query wall on blind retries; after
    `max_transient` transient failures (or once the link breaker opens)
    the loop rotates out with the same typed marker so the caller's hedge
    path / the coordinator's reproduction takes over."""
    blobs: list[bytes] = []
    token = 0
    backoff = backoff or Backoff()
    transients = 0

    def _transient_verdict(detail: str) -> Optional[str]:
        """After a transient failure: None == retry; otherwise the typed
        message to raise (rotation / breaker / backoff exhaustion)."""
        nonlocal transients
        transients += 1
        if health is not None:
            health.record_failure(worker_url)
        if max_transient and transients >= max_transient:
            return (
                f"EXCHANGE_UNREACHABLE:{task_id}: rotating to the hedge "
                f"path after {transients} transient failures from "
                f"{worker_url}: {detail}"
            )
        if backoff.failure():
            return (
                f"fetch {task_id}/{buffer_id}/{token} from {worker_url}: "
                f"gave up after {backoff.failure_count} attempts: {detail}"
            )
        if health is not None and not health.is_usable(worker_url):
            # the link breaker opened mid-retry: stop hammering a dead
            # endpoint — the hedge path / reproduction takes over
            return (
                f"EXCHANGE_UNREACHABLE:{task_id}: link to {worker_url} "
                f"graded DEAD after {transients} failures: {detail}"
            )
        return None

    while True:
        if abort is not None and abort():
            raise RuntimeError(
                f"fetch {task_id}/{buffer_id}/{token} from {worker_url}: "
                f"canceled (hedge path won, or the producer is dead)"
            )
        wait_s = 30.0
        headers = {}
        if consumer:
            headers["X-Trino-Consumer"] = consumer
        if deadline_ts:
            remaining = deadline_ts - time.time()
            if remaining <= headroom_s:
                DEADLINE_ABORTS.inc()
                raise RuntimeError(
                    f"EXCHANGE_UNREACHABLE:{task_id}: exchange deadline "
                    f"budget exhausted fetching buffer {buffer_id} token "
                    f"{token} from {worker_url} ({remaining:.2f}s left)"
                )
            # each hop computes its remaining budget: the long-poll must
            # return early enough for the typed failure to still beat the
            # query deadline
            wait_s = max(1.0, min(wait_s, remaining - headroom_s))
            headers["X-Trino-Deadline"] = f"{deadline_ts:.3f}"
        url = (
            f"{worker_url}/v1/task/{task_id}/results/{buffer_id}/{token}"
            f"?wait={wait_s:g}"
        )
        if consumer:
            url += f"&consumer={quote(consumer, safe='')}"
        t_req = time.monotonic()
        try:
            with urllib.request.urlopen(
                urllib.request.Request(url, headers=headers),
                timeout=wait_s + 30.0,
            ) as r:
                body = r.read()
                complete = r.headers.get("X-Complete") == "1"
                no_data = r.headers.get("X-No-Data") == "1"
        except urllib.error.HTTPError as e:
            detail = e.read().decode(errors="replace")
            if e.code in (502, 503, 504):  # transient: retry same token
                _fr.record(
                    "exchange_retry", node=node, task_id=task_id,
                    producer=worker_url, token=token, http=e.code,
                )
                msg = _transient_verdict(f"HTTP {e.code}: {detail}")
                if msg is not None:
                    raise RuntimeError(msg)
                backoff.sleep()
                continue
            # 500 = producer task failed, 404/410 = buffer gone: permanent
            raise RuntimeError(
                f"fetch {task_id}/{buffer_id}/{token} from {worker_url}: "
                f"HTTP {e.code}: {detail}"
            )
        except Exception as e:
            _fr.record(
                "exchange_retry", node=node, task_id=task_id,
                producer=worker_url, token=token, error=str(e)[:120],
            )
            msg = _transient_verdict(str(e))
            if msg is not None:
                raise RuntimeError(msg)
            backoff.sleep()
            continue
        backoff.success()
        productive = complete or (body and not no_data)
        if health is not None and productive:
            # only PRODUCTIVE responses feed the latency EWMA/history: an
            # empty long-poll timeout measures the producer's compute
            # pace, not the link, and would poison the hedge quantile
            health.record_success(worker_url, time.monotonic() - t_req)
        if link_stats is not None and productive:
            # per-link throughput accounting (observatory plane): same
            # productive-only rule as the health EWMA — long-poll idle
            # time is the producer's pace, not link bandwidth
            ls = link_stats.setdefault(
                worker_url, {"bytes": 0, "wall_ms": 0.0, "fetches": 0}
            )
            ls["wall_ms"] += (time.monotonic() - t_req) * 1e3
            ls["fetches"] += 1
        if body and not no_data:
            # end-to-end page integrity: verify the crc32 frame BEFORE the
            # chunk is appended or acked.  A corrupted frame is transient —
            # re-fetch the SAME token through the normal resume path (the
            # producer still holds it: acks only advance past clean chunks).
            try:
                unframe_chunk(body)
            except PageTransportError as e:
                # corruption is a link-quality signal too: it feeds the
                # link EWMA and counts toward the rotation budget
                msg = _transient_verdict(str(e))
                if msg is not None:
                    raise RuntimeError(msg)
                backoff.sleep()
                continue
            blobs.append(body)
            if link_stats is not None:
                # entry exists: body-and-not-no_data implies productive
                link_stats[worker_url]["bytes"] += len(body)
            token += 1
            if ack:  # free everything below the next token on the producer
                _quiet_get(
                    f"{worker_url}/v1/task/{task_id}/results/{buffer_id}/{token}/acknowledge"
                )
            if complete:
                break
        elif complete:
            break
        # else: no data yet — long-poll again
    _fr.record(
        "exchange_fetch", node=node, task_id=task_id, producer=worker_url,
        buffer=buffer_id, chunks=len(blobs),
        bytes=sum(len(b) for b in blobs),
    )
    return blobs


def _quiet_get(url: str) -> None:
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            r.read()
    except Exception:
        pass


def _make_handler(worker: Worker):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _send(self, code: int, body: bytes, ctype="application/octet-stream", headers=None):
            if worker._killed:
                self.close_connection = True
                return
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path, _, query = self.path.partition("?")
            params = dict(
                kv.split("=", 1) for kv in query.split("&") if "=" in kv
            )
            parts = path.strip("/").split("/")
            if parts[:1] == ["metrics"]:
                return self._send(
                    200,
                    worker.metrics_text().encode(),
                    "text/plain; version=0.0.4; charset=utf-8",
                )
            # GET /v1/flightrecorder?query_id=&all= — this node's lane of
            # the process-global flight recorder (utils/flightrecorder.py);
            # the coordinator's post-mortem fan-out reads it per worker
            if parts == ["v1", "flightrecorder"]:
                nodes = (
                    None if params.get("all")
                    else worker.flightrecorder_nodes()
                )
                events = _fr.snapshot(
                    query_id=params.get("query_id") or None, nodes=nodes
                )
                body = json.dumps(
                    {
                        "node": worker.url,
                        "stats": _fr.stats(),
                        "events": events,
                    }
                ).encode()
                return self._send(200, body, "application/json")
            # GET /v1/timeseries?since=&series= — this node's lane of the
            # process-global ring TSDB (utils/timeseries.py); the
            # coordinator federates every worker's answer into the
            # cluster view
            if parts == ["v1", "timeseries"]:
                try:
                    since = float(params.get("since") or 0.0) or None
                except ValueError:
                    since = None
                series = params.get("series") or ""
                names = [s for s in series.split(",") if s] or None
                data = _ts.snapshot(
                    nodes=[worker.url], series=names, since=since
                )
                body = json.dumps(
                    {
                        "node": worker.url,
                        "stats": _ts.stats(),
                        "series": data.get(worker.url) or {},
                    }
                ).encode()
                return self._send(200, body, "application/json")
            if parts[:2] == ["v1", "info"]:
                by_query = worker.buffered_by_query()
                # cluster memory visibility (reference: MemoryInfo polled
                # by ClusterMemoryManager.java:92).  rss is CURRENT
                # residency (/proc/self/statm) so memory governance can
                # watch it fall after revocation; the lifetime high-water
                # mark ships separately.  ru_maxrss is maintained at
                # page-fault time and can lag statm by a few pages —
                # clamp so sampled <= peak always holds on the wire.
                rss = _ts.current_rss_bytes()
                body = json.dumps(
                    {
                        "state": worker.state,
                        "tasks": len(worker.tasks),
                        "rss_bytes": rss,
                        "peak_rss_bytes": max(rss, _ts.peak_rss_bytes()),
                        "buffered_bytes": sum(by_query.values()),
                        "buffered_by_query": by_query,
                        # node pool reservations ride the heartbeat
                        # (reference: MemoryInfo polled by
                        # ClusterMemoryManager.java:92)
                        "memory_pool": (
                            worker.memory_pool.snapshot()
                            if worker.memory_pool is not None
                            else None
                        ),
                        # disk-pool reservations ride the heartbeat too —
                        # the coordinator's pressure-based spool reclaim
                        # keys off these (runtime/disk.py)
                        "disk_pool": (
                            worker.disk_pool.snapshot()
                            if worker.disk_pool is not None
                            else None
                        ),
                        # consumer-side link grades (runtime/health.py):
                        # the coordinator folds every worker's view into
                        # the cluster link matrix — how an asymmetric
                        # partition becomes visible without any worker
                        # failing its heartbeat
                        "links": worker.link_health.snapshot(),
                    }
                ).encode()
                return self._send(200, body, "application/json")
            # GET /v1/task — task listing for the coordinator's post-restart
            # adopt-or-cancel sweep (reference: TaskResource's getAllTaskInfo
            # that a fresh coordinator reconciles membership against)
            if parts == ["v1", "task"]:
                with worker._lock:
                    listing = [
                        {
                            "task_id": t.task_id,
                            "query_id": t.query_id,
                            "state": t.state,
                        }
                        for t in worker.tasks.values()
                    ]
                return self._send(
                    200,
                    json.dumps({"tasks": listing}).encode(),
                    "application/json",
                )
            # /v1/task/{id}/status
            if len(parts) == 4 and parts[:2] == ["v1", "task"] and parts[3] == "status":
                wait = float(params.get("wait", "0"))
                st = worker.task_status(parts[2], wait)
                return self._send(200, json.dumps(st).encode(), "application/json")
            # /v1/task/{id}/results/{buffer}/{token}[/acknowledge]
            if len(parts) >= 5 and parts[:2] == ["v1", "task"] and parts[3] == "results":
                task_id = parts[2]
                buffer_id = int(parts[4])
                if len(parts) >= 7 and parts[6] == "acknowledge":
                    worker.acknowledge(task_id, buffer_id, int(parts[5]))
                    return self._send(200, b"{}", "application/json")
                # pairwise link faults (PARTITION/GRAY_SLOW/FLAKY_LINK):
                # the requester's identity scopes the rule, so A→B can
                # black-hole while coordinator→B and C→B serve normally
                consumer = unquote(params.get("consumer", "")) or (
                    self.headers.get("X-Trino-Consumer") or ""
                )
                if worker.fault_injector.link_fault(task_id, consumer) == "drop":
                    return self._send(503, b"injected link drop")
                if worker.fault_injector.drop_fetch(task_id):
                    # EXCHANGE_DROP: transient 503 — consumers must retry
                    # through Backoff and resume from their token
                    return self._send(503, b"injected exchange drop")
                token = int(parts[5]) if len(parts) >= 6 else 0
                wait = float(params.get("wait", "0"))
                dl = self.headers.get("X-Trino-Deadline")
                if dl:
                    # coherent deadline propagation: never long-poll past
                    # the query's remaining budget — the consumer must get
                    # its answer (or lack of one) while it can still act
                    try:
                        wait = max(0.0, min(wait, float(dl) - time.time()))
                    except ValueError:
                        pass
                code, body, headers = worker.get_chunk(task_id, buffer_id, token, wait)
                if (
                    code == 200
                    and body
                    and worker.fault_injector.corrupt_fetch(task_id)
                ):
                    # CORRUPT: flip one payload byte in the served frame.
                    # The consumer's crc32 check must reject it and re-fetch
                    # this token (which serves clean bytes — the rule's
                    # count is consumed); silence here would be wrong rows.
                    mut = bytearray(body)
                    mut[len(mut) // 2] ^= 0xFF
                    body = bytes(mut)
                return self._send(code, body, headers=headers)
            return self._send(404, b"not found")

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n)
            parts = self.path.strip("/").split("/")
            if parts[:2] == ["v1", "task"]:
                req = json.loads(body)
                # the query deadline rides every task POST as a header
                # (coherent deadline propagation) — fold it into the
                # payload so the fetch loop computes remaining budget
                # even when the dispatching coordinator predates the field
                dl = self.headers.get("X-Trino-Deadline")
                if dl and not req.get("deadline_ts"):
                    try:
                        req["deadline_ts"] = float(dl)
                    except ValueError:
                        pass
                try:
                    worker.submit_task(req)
                except DrainingError as e:
                    # reference: SERVER_SHUTTING_DOWN — the dispatcher must
                    # pick another node, not retry this one in a tight loop
                    return self._send(
                        503, str(e).encode(), headers={"Retry-After": "1"}
                    )
                return self._send(200, b'{"state": "RUNNING"}', "application/json")
            # POST /v1/memory/revoke {"query_id": ...} — coordinator-driven
            # revocation: force-spill the query's revocable leases
            if parts[:3] == ["v1", "memory", "revoke"]:
                req = json.loads(body)
                freed = worker.revoke_query_memory(str(req.get("query_id")))
                return self._send(
                    200, json.dumps({"freed": freed}).encode(),
                    "application/json",
                )
            if parts[:2] == ["v1", "inject_failure"]:
                req = json.loads(body)
                if str(req.get("mode", "")).upper() == "DISK_FULL":
                    # consumed at arm time (like MEMORY_PRESSURE): shrink
                    # the node disk pool NOW — new spool/spill writes see
                    # reclaim -> block -> typed EXCEEDED_SPILL_LIMIT, and
                    # task retry moves the attempt to a node with disk left
                    if worker.disk_pool is None:
                        return self._send(400, b"worker has no disk pool")
                    worker.disk_pool.set_capacity(
                        int(req.get("capacity_bytes") or 0)
                    )
                    worker.fault_injector.record_fired(
                        "DISK_FULL", req.get("task_id", "*")
                    )
                    return self._send(200, b"{}", "application/json")
                if str(req.get("mode", "")).upper() == "MEMORY_PRESSURE":
                    # consumed at arm time: shrink the node pool NOW; the
                    # deficit shows as reserved > capacity on the next
                    # heartbeat and the cluster memory manager escalates
                    if worker.memory_pool is None:
                        return self._send(400, b"worker has no memory pool")
                    worker.memory_pool.set_capacity(
                        int(req.get("capacity_bytes") or 0)
                    )
                    worker.fault_injector.record_fired(
                        "MEMORY_PRESSURE", req.get("task_id", "*")
                    )
                    return self._send(200, b"{}", "application/json")
                try:
                    worker.fault_injector.arm(
                        task_id=req.get("task_id", "*"),
                        mode=req.get("mode", "ERROR"),
                        delay_ms=req.get("delay_ms", 0),
                        count=req.get("count", 1),
                        probability=req.get("probability", 1.0),
                        seed=req.get("seed"),
                        consumer=req.get("consumer", "*"),
                    )
                except ValueError as e:
                    return self._send(400, str(e).encode())
                return self._send(200, b"{}", "application/json")
            return self._send(404, b"not found")

        def do_PUT(self):
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n)
            parts = self.path.strip("/").split("/")
            # PUT /v1/info/state "DRAINING" — graceful drain trigger
            # (reference: NodeStateChangeHandler; curl-able ops surface)
            if parts == ["v1", "info", "state"]:
                try:
                    want = json.loads(body)
                except (ValueError, UnicodeDecodeError):
                    want = body.decode(errors="replace")
                want = str(want).strip().strip('"').upper()
                if want in ("DRAINING", "SHUTTING_DOWN"):
                    worker.request_drain()
                    return self._send(
                        200,
                        json.dumps({"state": worker.state}).encode(),
                        "application/json",
                    )
                return self._send(400, f"unsupported state {want!r}".encode())
            return self._send(404, b"not found")

        def do_DELETE(self):
            parts = self.path.strip("/").split("/")
            if parts[:2] == ["v1", "task"]:
                worker.delete_task(parts[2])
                return self._send(200, b"{}")
            return self._send(404, b"not found")

    return Handler

