"""Coordinator: discovery, scheduling, client protocol.

Reference wiring this replaces (SURVEY §3.1-3.2):
  - discovery/membership + heartbeat failure detector
    (node/CoordinatorNodeManager, failuredetector/HeartbeatFailureDetector.java:76)
  - stage scheduling: ALL-AT-ONCE posts every stage up front (workers
    long-poll their sources, so stages pipeline); PHASED (retry_policy=
    TASK) runs dependency waves with independent sibling subtrees
    CONCURRENT (execution/scheduler/PipelinedQueryScheduler.java:164 +
    scheduler/policy/PhasedExecutionSchedule.java)
  - client protocol: POST /v1/statement, poll GET nextUri
    (dispatcher/QueuedStatementResource.java:109, server/protocol/
    ExecutingStatementResource.java), results paged from the root stage
  - query-level retry on worker failure (RetryPolicy QUERY)

The root (result) fragment executes in the coordinator process — the
reference's COORDINATOR_DISTRIBUTION output stage
(PipelinedQueryScheduler.java:535 CoordinatorStagesScheduler) — on the
coordinator's `device`: the CUDA card unless the caller asks for the CPU.
The pages it fetches from the last stage's tasks are uploaded there.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import tempfile
import threading
import time
import traceback
import urllib.request
import uuid
from urllib.parse import unquote
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .. import resolve_device
from ..connectors.spi import CatalogManager
from ..data.page import Page
from ..exec.compiler import LocalExecutor, ScanCache
from ..plan.distribute import distribute
from ..plan.fragmenter import Fragment, fragment_plan
from ..plan.optimizer import optimize
from ..plan.planner import Planner
from ..plan.serde import _encode, plan_to_json
from ..utils import flightrecorder as _fr
from ..utils import metrics as _metrics
from ..utils import roofline as _roofline
from ..utils import timeseries as _ts
from ..utils.tracing import Tracer, add_exporters_from_env, traceparent
from .events import EventListenerManager, QueryEvent
from .failure import (
    QUARANTINED, Backoff, FailureDetector, FaultInjector, InjectedCommitCrash,
)
# imported unconditionally: fleet.py registers the fleet metric families in
# the GLOBAL registry at import, so /metrics carries their HELP strings even
# on single-coordinator deployments (scripts/metrics_lint.py contract)
from .fleet import FLEET_ADOPTIONS, FleetMember
from .history import QueryHistoryStore
from .journal import QueryJournal
from .memory import ClusterMemoryManager
from .resultcache import (
    MEMO_PREFIX, FragmentMemo, ResultCache, has_nondeterministic,
    plan_version_vector,
)
from .session import PROPERTIES, SessionProperties
# imported unconditionally for the same reason as fleet: splits.py registers
# the split metric families in the GLOBAL registry at import
from .splits import SplitScheduler, current_backlog, scan_split_plan
from .spool import SPOOL_URL, SpooledExchange
from .statemachine import QueryStateMachine
from .wire import wire_to_page

__all__ = ["Coordinator"]

# typed markers a consuming worker raises for an unreadable producer
# (runtime/worker.py) — the captured group is the producer task id to
# reproduce.  SPOOL_LOST = the producer's COMMITTED spool partition went
# missing/corrupt at read time; EXCHANGE_UNREACHABLE = the link to the
# producer is partitioned or the propagated deadline left no budget for
# another fetch attempt.  Both recover the same way: re-run the producer
# so its output is reproduced into the spool for the hedge path to read.
_LOST_SOURCE_RE = re.compile(
    r"(?:SPOOL_LOST|EXCHANGE_UNREACHABLE):([A-Za-z0-9_.\-]+):"
)


def _json_default(o):
    """Result rows can hold decimal.Decimal (long-decimal Python surface,
    data/page.py to_pylist): the HTTP protocol and spooled segments send
    them as strings — exact digits, like the reference client protocol's
    text encoding of decimals."""
    from decimal import Decimal

    if isinstance(o, Decimal):
        return str(o)
    raise TypeError(
        f"Object of type {type(o).__name__} is not JSON serializable"
    )


def _svc_compile_inflight() -> int:
    """Kernel builds running or queued in the compile service (kernel 2's
    NVRTC recipes, exec/compilesvc.py) — the sampler's `compile_inflight`
    lane."""
    from ..exec.compilesvc import SERVICE

    return SERVICE.inflight()


class _WorkerInfo:
    def __init__(self, url: str):
        self.url = url
        self.alive = True
        self.last_seen = time.time()
        self.failures = 0
        # last node-memory-pool snapshot from /v1/info (None = worker runs
        # without a governed pool); feeds the cluster memory manager + /ui
        self.mem: Optional[dict] = None
        # last node-disk-pool snapshot (runtime/disk.py): feeds the spool
        # pressure-reclaim escalation in the coordinator GC tick
        self.disk: Optional[dict] = None
        # this worker's consumer-side view of its exchange links
        # (runtime/health.py snapshot() shipped on /v1/info) — one ROW of
        # the cluster link matrix: {producer_url: {state, error_ewma, ...}}
        self.links: dict = {}
        # residency from the last heartbeat (observatory plane): CURRENT
        # rss (can fall after revocation) and the lifetime high-water mark
        self.rss_bytes: Optional[int] = None
        self.peak_rss_bytes: Optional[int] = None


class Coordinator:
    def __init__(
        self,
        catalogs: CatalogManager,
        default_catalog: str = "tpch",
        port: int = 0,
        heartbeat_interval: float = 2.0,
        resource_groups=None,
        cluster_memory_limit_bytes: int = 0,  # 0 = no enforcement
        history_capacity: int = 200,
        history_path: Optional[str] = None,
        journal_path: Optional[str] = None,
        fleet_dir: Optional[str] = None,
        fleet_ttl_s: float = 10.0,
        coordinator_id: Optional[str] = None,
        device="cuda",
    ):
        from .resourcegroups import ResourceGroupManager

        # where the root fragment (and an out-of-core re-run) executes: the
        # card unless the caller asks for the CPU (raises without a card)
        self.device = resolve_device(device)
        # learned capacities of the root fragments, kept across queries
        self.scan_cache = ScanCache()
        self.catalogs = catalogs
        self.default_catalog = default_catalog
        self.planner = Planner(catalogs, default_catalog)
        self.session = SessionProperties()
        self.workers: dict[str, _WorkerInfo] = {}
        self.queries: dict[str, dict] = {}
        self.resource_groups = ResourceGroupManager(resource_groups)
        # reference: memory/ClusterMemoryManager.java:92 polls worker
        # MemoryInfo and OOM-kills the biggest reservation under pressure
        self.cluster_memory_limit_bytes = cluster_memory_limit_bytes
        self.memory_kills = 0  # observability
        self.memory_requeues = 0  # memory kills degraded to out-of-core
        # node-pool arbitration over worker heartbeat snapshots (reference:
        # ClusterMemoryManager.java:92 + TotalReservationLowMemoryKiller):
        # sustained node pressure first revokes the largest revocable
        # holder (forced spill), then kills the largest total reservation
        self.cluster_memory_manager = ClusterMemoryManager()
        self.oom_kills = 0  # queries killed with CLUSTER_OUT_OF_MEMORY
        # split-plane memory integration: workers whose lease was revoked
        # are parked out of split assignment until the revocation had time
        # to land (url -> park time; runtime/splits.py consults via
        # _split_parked)
        self._split_park: dict[str, float] = {}
        self.split_park_s = 5.0
        self._lock = threading.Lock()
        self.heartbeat_interval = heartbeat_interval
        # coordinator control-plane metrics, exposed at GET /metrics in
        # Prometheus text format (reference: the JMX->/v1/jmx/mbean surface
        # ClusterStatsResource reads; ours is the standard exposition)
        self.metrics = _metrics.MetricsRegistry()
        self._m_queries = self.metrics.counter(
            "trino_tpu_queries_total", "Queries reaching a terminal state",
            ("state",),
        )
        self._m_running = self.metrics.gauge(
            "trino_tpu_queries_running", "Tracked queries not yet terminal"
        )
        self._m_dispatched = self.metrics.counter(
            "trino_tpu_tasks_dispatched_total", "Task POSTs sent to workers"
        )
        self._m_retries = self.metrics.counter(
            "trino_tpu_task_retries_total",
            "Task re-schedules under retry_policy=TASK",
        )
        self._m_heals = self.metrics.counter(
            "trino_tpu_task_heals_total",
            "Dead-producer recoveries (spool re-point or recompute)",
        )
        self._m_spool_repro = self.metrics.counter(
            "trino_tpu_spool_reproductions_total",
            "Producer tasks re-run because their committed spool partition "
            "was missing or corrupt at read time (self-healing spool)",
        )
        self._m_breaker = self.metrics.counter(
            "trino_tpu_circuit_breaker_transitions_total",
            "Worker circuit-breaker state changes", ("to",),
        )
        self._m_query_seconds = self.metrics.histogram(
            "trino_tpu_query_seconds", "End-to-end query wall seconds"
        )
        self._m_speculative = self.metrics.counter(
            "trino_tpu_speculative_attempts_total",
            "Straggler backup attempts by outcome (launched/won/lost)",
            ("outcome",),
        )
        self._m_deadline = self.metrics.counter(
            "trino_tpu_deadline_kills_total",
            "Queries killed by the deadline watchdog", ("reason",),
        )
        self._m_shed = self.metrics.counter(
            "trino_tpu_queries_shed_total",
            "Statements answered 429 by dispatch-queue load shedding",
        )
        self._m_oom_kills = self.metrics.counter(
            "trino_tpu_oom_kills_total",
            "Queries killed by the low-memory killer (CLUSTER_OUT_OF_MEMORY)",
        )
        self._m_revocations_requested = self.metrics.counter(
            "trino_tpu_memory_revocations_requested_total",
            "Revocation (forced-spill) requests sent to workers",
        )
        self._m_resumed = self.metrics.counter(
            "trino_tpu_queries_resumed_total",
            "In-flight queries a restarted coordinator recovered from the "
            "journal, by outcome (completed/failed/refused)",
            ("outcome",),
        )
        self._m_orphans = self.metrics.counter(
            "trino_tpu_orphan_tasks_canceled_total",
            "Worker tasks canceled by the post-restart sweep because their "
            "query is not live in the journal",
        )
        # anomaly sentinel (runtime/history.py baselines): typed anomalies
        # attached to finished queries whose run regressed vs their
        # planhash's rolling baseline
        self._m_anomalies = self.metrics.counter(
            "trino_tpu_query_anomalies_total",
            "Typed anomalies the sentinel attached to finished queries, by "
            "anomaly kind (SLOW_VS_BASELINE / SPILL_REGRESSION / "
            "RETRY_STORM / COMPILE_STORM / BANDWIDTH_REGRESSION)",
            ("kind",),
        )
        self._m_postmortems = self.metrics.counter(
            "trino_tpu_postmortem_bundles_total",
            "Cross-node post-mortem bundles written, by trigger "
            "(failure / anomaly / on_demand)",
            ("trigger",),
        )
        # cluster link matrix (runtime/health.py): workers ship their
        # consumer-side link grades on /v1/info; the coordinator folds the
        # rows and steers task placement away from impaired links
        self._m_links_impaired = self.metrics.gauge(
            "trino_tpu_links_impaired",
            "Exchange links in the cluster link matrix currently graded "
            "worse than HEALTHY (summed over all consumer rows)",
        )
        self._m_link_avoided = self.metrics.counter(
            "trino_tpu_link_avoided_dispatch_total",
            "Task placements that skipped a candidate worker because the "
            "cluster link matrix showed an impaired link touching it",
        )
        # postmortem bundles are disk-pool leased (runtime/disk.py) against
        # a small coordinator-side budget — lazily built on first write
        self._postmortem_pool = None
        self._postmortem_lock = threading.Lock()
        # query lifecycle events (reference: EventListener SPI fired from
        # QueryMonitor on the coordinator, not the workers)
        self.events = EventListenerManager()
        self.tracer = Tracer()
        add_exporters_from_env(self.tracer)
        # per-worker circuit breaker fed by heartbeat outcomes (reference:
        # HeartbeatFailureDetector.java:76); quarantined workers receive no
        # new dispatches and are half-open probed for automatic recovery
        self.failure_detector = FailureDetector(
            probe_interval=heartbeat_interval * 2,
            on_transition=lambda url, old, new: self._m_breaker.labels(new).inc(),
        )
        # coordinator-side fault matrix for the WRITE plane (runtime/txn.py
        # consumes COMMIT_CRASH / WRITE_STALL rules at each phase boundary);
        # worker-side task faults keep their own injectors on the workers
        self.fault_injector = FaultInjector()
        # finished queries older than this are expired (record + spooled
        # segments GC'd) by the heartbeat sweep; 0 disables
        self.query_expiration_seconds = 900.0
        # coordinator fleet membership (runtime/fleet.py): a shared fleet
        # dir holds per-member epoch leases, per-member journal files, and
        # the shared history.  None = classic single-coordinator mode.
        self.fleet: Optional[FleetMember] = None
        fdir = fleet_dir or os.environ.get("TRINO_TPU_FLEET_DIR")
        if fdir:
            self.fleet = FleetMember(
                fdir, coordinator_id=coordinator_id, ttl_s=fleet_ttl_s
            )
            # fleet defaults: the journal is NAMESPACED per member (the
            # adopter replays a dead peer's file), the history is SHARED
            # (every member appends + tails it, replicating cache-admission
            # hints fleet-wide)
            if journal_path is None:
                journal_path = self.fleet.journal_path_for()
            if history_path is None:
                history_path = self.fleet.history_path()
        # bounded query history (reference: QueryResource's bounded history
        # behind GET /v1/query): completed QueryInfo+ledger records survive
        # _expire_old_queries — and, with a JSONL path, coordinator restarts
        self.history = QueryHistoryStore(
            capacity=history_capacity,
            path=history_path or os.environ.get("TRINO_TPU_HISTORY_FILE"),
        )
        # result & fragment cache plane (runtime/resultcache.py): in-memory
        # only, deliberately never journaled — a restarted coordinator comes
        # up cold, so a snapshot that advanced while it was down can never
        # be served stale.  Admission reads the history store above.
        self.result_cache = ResultCache(history=self.history)
        self.fragment_memo = FragmentMemo()
        # crash-simulation flag (kill()): scheduling threads bail between
        # steps WITHOUT cleanup/terminal transitions — exactly the state a
        # SIGKILLed process leaves behind
        self._killed = False
        # durable query journal (runtime/journal.py): admission, dispatch,
        # spool commits, terminal states.  A restarted coordinator replays
        # it here — synchronously, BEFORE the HTTP server opens, so client
        # polls for a pre-crash query id never see a 404 window — and the
        # resume thread (started in start()) takes over the in-flight ones.
        self.journal: Optional[QueryJournal] = None
        self.journal_replay_ms = 0.0
        jpath = journal_path or os.environ.get("TRINO_TPU_JOURNAL_FILE")
        if jpath:
            t0 = time.perf_counter()
            replayed = QueryJournal.replay(jpath)
            self.journal = QueryJournal(jpath)
            for qid, jq in replayed.items():
                if jq.state != "INFLIGHT":
                    # terminal: fold into history so GET /v1/query keeps
                    # answering for it (its live record died with the crash)
                    try:
                        self.history.record({
                            "query_id": qid, "state": jq.state,
                            "sql": (jq.sql or "")[:500], "error": jq.error,
                            "error_code": jq.error_code,
                            "created_ts": jq.created_ts,
                        })
                    except Exception:
                        traceback.print_exc()
                    continue
                sm = QueryStateMachine(qid)
                self.queries[qid] = {
                    "sm": sm, "sql": jq.sql, "result": None, "columns": None,
                    "done": threading.Event(), "spooled": jq.spooled,
                    "journaled": True, "resumed": True, "resume_state": jq,
                }
            self.journal_replay_ms = round(
                (time.perf_counter() - t0) * 1e3, 3
            )
        self._hb_stop = threading.Event()
        handler = _make_handler(self)
        self.httpd = ThreadingHTTPServer(("127.0.0.1", port), handler)
        self.port = self.httpd.server_port
        self.url = f"http://127.0.0.1:{self.port}"
        if self.fleet is not None:
            # the lease carries this member's URL: peers and the router
            # learn where adopted queries answer from the fleet dir alone
            self.fleet.url = self.url
            self.fleet.acquire()
        # coordinator lane of the per-node time-series plane
        # (utils/timeseries.py): same vocabulary as the workers, minus the
        # pools this role doesn't own
        self.sampler = _ts.Sampler(
            self.url,
            {
                "cpu_s": _ts.cpu_seconds,
                "rss_bytes": _ts.current_rss_bytes,
                "split_backlog": self._live_query_count,
                "compile_inflight": _svc_compile_inflight,
                "links_impaired": self._links_impaired_count,
            },
            deltas={"cpu_s"},
        )
        self._threads = [
            # a short poll: stop() waits one poll for the serve loop
            threading.Thread(
                target=self.httpd.serve_forever, kwargs={"poll_interval": 0.05}, daemon=True
            ),
            threading.Thread(target=self._heartbeat_loop, daemon=True),
        ]

    def _live_query_count(self) -> int:
        with self._lock:
            return sum(1 for r in self.queries.values() if not r["sm"].done)

    def _links_impaired_count(self) -> int:
        with self._lock:
            return sum(
                1
                for w in self.workers.values()
                for cell in (w.links or {}).values()
                if cell.get("state") != "HEALTHY"
            )

    def start(self) -> "Coordinator":
        for t in self._threads:
            t.start()
        self.sampler.start()  # no-op when the timeseries plane is disabled
        if any(
            rec.get("resume_state") is not None
            for rec in self.queries.values()
        ):
            threading.Thread(
                target=self._resume_replayed, daemon=True,
                name="journal-resume",
            ).start()
        # startup cache warming (runtime/warmup.py): replay the top-K
        # recurring FINISHED statements from the persisted history so their
        # kernels are built and their scans uploaded before the first client
        # query; daemon thread — the server accepts queries while it warms
        try:
            warm_k = int(os.environ.get("TRINO_TPU_WARM_SIGNATURES") or 0)
        except ValueError:
            warm_k = 0
        if warm_k > 0 and len(self.history):
            from .warmup import warm_from_history

            def _warm():
                # workers announce after the coordinator is up; replaying
                # into an empty cluster would just record failures
                deadline = time.monotonic() + 120.0
                while not self._hb_stop.is_set():
                    if self.alive_workers() or time.monotonic() > deadline:
                        break
                    time.sleep(0.2)
                if self.alive_workers():
                    warm_from_history(self.execute_query, self.history, warm_k)

            threading.Thread(
                target=_warm, daemon=True, name="compile-warmer"
            ).start()
        return self

    def add_event_listener(self, listener) -> None:
        """Reference: EventListener SPI (eventlistener/EventListenerManager)."""
        self.events.add(listener)

    def metrics_text(self) -> str:
        """Prometheus text exposition: coordinator instruments plus the
        process-global registry (spill/compile-cache counters)."""
        with self._lock:
            running = sum(1 for r in self.queries.values() if not r["sm"].done)
        self._m_running.set(running)
        return self.metrics.render(extra=_metrics.GLOBAL)

    def stop(self) -> None:
        self._hb_stop.set()
        self.sampler.stop()
        self.httpd.shutdown()
        # release the port: a replacement coordinator must be able to bind
        # the same address (clients re-attach to an unchanged nextUri)
        self.httpd.server_close()
        if self.journal is not None:
            self.journal.close()
        if self.fleet is not None:
            # graceful exit drops the lease NOW; kill() deliberately does
            # not — an expired lease is the adoption trigger
            self.fleet.release()

    def kill(self) -> None:
        """Crash analogue (in-process SIGKILL) for recovery tests: stop
        serving and abandon all in-flight work exactly as a dead process
        would — no task cleanup, no spool remove_query, no journal finish
        records, no terminal state transitions.  Everything a real crash
        leaves behind (running worker tasks, committed spool dirs, an
        unterminated journal) is left behind here too."""
        self._killed = True
        self._hb_stop.set()
        self.sampler.stop()
        try:
            self.httpd.shutdown()
            self.httpd.server_close()
        except Exception:
            pass
        if self.journal is not None:
            self.journal.close()

    # ---------------------------------------------------- journal recovery
    def _resume_replayed(self) -> None:
        """Take over the journal's in-flight queries (daemon thread from
        start()).  Waits for workers to re-announce first — they survive
        the coordinator and keep serving exchange fetches, so resuming
        into an empty membership would fail every recovered query."""
        deadline = time.monotonic() + 60.0
        while not self._hb_stop.is_set():
            if self.alive_workers() or time.monotonic() > deadline:
                break
            time.sleep(0.1)
        from .resourcegroups import QueryRejected

        with self._lock:
            pending = [
                rec for rec in self.queries.values()
                if rec.get("resume_state") is not None
            ]
        for record in pending:
            if self._hb_stop.is_set():
                return
            self._resume_one(record)

    def _resume_one(self, record: dict) -> None:
        """Take over ONE replayed in-flight query (the journal's RESUME path),
        shared between restart recovery (_resume_replayed) and fleet peer
        adoption (_fleet_tick): apply the journaled session, honor the
        resume policy, seed the resume commits so spool-COMMITTED stages
        are re-read instead of recomputed, and submit through admission."""
        from .resourcegroups import QueryRejected

        sm: QueryStateMachine = record["sm"]
        jq = record.pop("resume_state")
        policy = str(self.session.get("resume_policy") or "RESUME").upper()
        # re-apply the journaled session overrides the query ran with,
        # unless this coordinator was explicitly configured otherwise —
        # retry_policy and exchange_spool_dir are load-bearing: without
        # them the resumed query could not re-read its committed output
        for k, v in (jq.session or {}).items():
            if k in PROPERTIES and k not in self.session._values:
                self.session._values[k] = v
        self.events.fire(
            QueryEvent("resumed", sm.query_id, (jq.sql or "")[:500])
        )
        if jq.write_intents:
            # write-plane replay is exactly-once, never re-execute: the
            # commit marker decides no-op vs abort regardless of policy —
            # re-running the statement under either policy could double-
            # apply a write whose commit landed but whose ack did not
            self._resume_write_txn(record, jq)
            return
        if policy == "FAIL":
            reason = (
                "Query was abandoned by a coordinator restart "
                "(resume_policy=FAIL) [COORDINATOR_RESTART]"
            )
            record["resume_refused"] = True
            if self.journal is not None:
                self.journal.append(
                    "finish", sm.query_id, state="FAILED",
                    error=reason, error_code="COORDINATOR_RESTART",
                )
            sm.fail(reason, code="COORDINATOR_RESTART")
            record["done"].set()
            self._m_resumed.labels("refused").inc()
            return
        if policy == "RESUME":
            record["resume_commits"] = jq.commits
            record["resume_ntasks"] = jq.dispatches
        record["resume_attempt"] = jq.next_attempt
        record.setdefault("journal_replay_ms", self.journal_replay_ms)
        if self.journal is not None:
            self.journal.append(
                "resume", sm.query_id, policy=policy,
                attempt=jq.next_attempt,
            )

        def start(record=record):
            threading.Thread(
                target=self._run_admitted, args=(record,), daemon=True
            ).start()

        group = self.session.get("resource_group")
        mem = int(self.session.get("query_max_memory_bytes") or 0)
        try:
            self.resource_groups.submit(group, sm.query_id, mem, start)
        except QueryRejected as e:
            sm.fail(str(e))
            record["done"].set()

    def _resume_write_txn(self, record: dict, jq) -> None:
        """Exactly-once DML replay: a recovered query with journaled write
        intents never re-executes its statement.  Per intent the commit
        marker decides — the journal's write_commit record OR the
        connector's durable committed-marker (`txn_committed`; the
        coordinator may die between the connector commit and the journal
        ack, so connector state is truth) means the write landed and the
        query replays as a NO-OP reporting the committed row count; no
        marker means the intent aborts and its staging is reclaimed, the
        target left byte-identical to the pre-image."""
        from .txn import RECLAIMED_TOTAL, TXN_TOTAL

        sm: QueryStateMachine = record["sm"]
        surface = _statement_surface(self)
        committed_rows: Optional[int] = None
        for txn_id in sorted(jq.write_intents):
            intent = jq.write_intents[txn_id]
            catalog = intent.get("catalog") or self.default_catalog
            table = intent.get("table") or ""
            try:
                conn, tbl = surface._target_conn(f"{catalog}.{table}")
            except KeyError:
                conn, tbl = None, table
            rows = jq.write_commits.get(txn_id)
            if rows is None and conn is not None:
                try:
                    rows = conn.txn_committed(tbl, txn_id)
                except Exception:
                    rows = None
            if rows is not None:
                if txn_id not in jq.write_commits and self.journal is not None:
                    # journal repair: the connector committed but the marker
                    # never hit disk (death inside the ack window) — re-
                    # journal it so the NEXT replay short-circuits here
                    self.journal.append(
                        "write_commit", sm.query_id, txn_id=txn_id,
                        rows=int(rows),
                    )
                committed_rows = int(rows)
                TXN_TOTAL.labels("replayed_noop").inc()
                _fr.record(
                    "txn_replay_noop", txn_id=txn_id,
                    table=f"{catalog}.{table}", rows=int(rows),
                )
                # the write IS visible: fire the same invalidation the lost
                # ack would have (matters on adoption — the adopter's caches
                # can be warm with the pre-image)
                try:
                    surface.cache_invalidate(f"{catalog}.{table}")
                except Exception:
                    traceback.print_exc()
            elif txn_id in jq.write_aborts:
                continue  # cleanly aborted before the crash: nothing to do
            else:
                freed = 0
                if conn is not None:
                    try:
                        freed = int(conn.reclaim_staging(txn_id) or 0)
                    except Exception:
                        traceback.print_exc()
                if freed:
                    RECLAIMED_TOTAL.inc(freed)
                TXN_TOTAL.labels("aborted").inc()
                if self.journal is not None:
                    self.journal.append(
                        "write_abort", sm.query_id, txn_id=txn_id,
                        reason="coordinator restart", outcome="aborted",
                    )
                _fr.record(
                    "txn_replay_abort", txn_id=txn_id,
                    table=f"{catalog}.{table}", freed_bytes=freed,
                )
        if committed_rows is not None:
            sm.transition("PLANNING")
            sm.transition("RUNNING")
            record["result"] = [(committed_rows,)]
            record["columns"] = ["col0"]
            sm.transition("FINISHED")
            if self.journal is not None:
                self.journal.append(
                    "finish", sm.query_id, state="FINISHED",
                    error=None, error_code=None,
                )
            self._m_resumed.labels("completed").inc()
        else:
            reason = (
                "Write transaction aborted by coordinator restart: the "
                "intent was journaled but never committed; staged data "
                "reclaimed, table unchanged [WRITE_ABORTED]"
            )
            if self.journal is not None:
                self.journal.append(
                    "finish", sm.query_id, state="FAILED",
                    error=reason, error_code="WRITE_ABORTED",
                )
            sm.fail(reason, code="WRITE_ABORTED")
            self._m_resumed.labels("failed").inc()
        record["done"].set()
        self._m_queries.labels(sm.state).inc()
        try:  # history must never fail a replayed write
            self.history.record(self._history_record(record, 0.0))
        except Exception:
            traceback.print_exc()

    def _gc_write_staging(self) -> None:
        """Write-staging janitor (rides the heartbeat sweep like
        _gc_spool): a connector staging namespace whose txn's query is not
        live anywhere — locally or in any fleet peer's lease — past the
        grace window is an orphan from a crashed writer whose journal
        nobody replayed (e.g. journal-less deployments).  Reclaim it and
        account the bytes; replay-driven reclaim (_resume_write_txn) is
        the fast path and usually gets there first."""
        if self.fleet is not None and not self.fleet.is_gc_owner():
            return  # destructive sweeps are single-owner in a fleet
        try:
            grace = float(self.session.get("write_staging_grace_s") or 10.0)
        except Exception:
            grace = 10.0
        with self._lock:
            live = {
                qid for qid, rec in self.queries.items()
                if not rec["sm"].done
            }
        if self.fleet is not None:
            live |= self.fleet.fleet_live_queries()
        from .txn import RECLAIMED_TOTAL

        for cname in self.catalogs.names():
            try:
                conn = self.catalogs.get(cname)
                orphans = conn.orphaned_staging()
            except Exception:
                continue
            for txn_id, age_s in orphans.items():
                qid = txn_id.rsplit("-w", 1)[0]
                if qid in live or age_s < grace:
                    continue
                try:
                    freed = int(conn.reclaim_staging(txn_id) or 0)
                except Exception:
                    traceback.print_exc()
                    continue
                if freed:
                    RECLAIMED_TOTAL.inc(freed)
                _fr.record(
                    "txn_janitor", node=self.url, catalog=cname,
                    txn_id=txn_id, freed_bytes=freed,
                    age_s=round(age_s, 3),
                )

    # --------------------------------------------------- fleet membership
    def _fleet_tick(self) -> None:
        """Per-heartbeat fleet duties: renew the lease (embedding live
        query ids for the fleet-wide GC union), tail the shared history
        (replicated cache-admission hints), and adopt expired peers."""
        if self.fleet is None:
            return
        try:
            with self._lock:
                live = [
                    qid for qid, rec in self.queries.items()
                    if not rec["sm"].done
                ]
            self.fleet.renew(live)
            self.history.refresh()
            for lease in self.fleet.expired_peers():
                if self.fleet.try_adopt(lease):
                    self._adopt_peer(lease)
        except Exception:
            traceback.print_exc()

    def _adopt_peer(self, lease: dict) -> None:
        """Replay a dead peer's journal and take over its in-flight
        queries through the RESUME path: committed stages are re-read from
        the spool, never recomputed, and re-attaching clients land on this
        coordinator's copy of the query with zero visible failures."""
        peer_id = lease.get("coordinator_id")
        t0 = time.perf_counter()
        replayed = QueryJournal.replay(self.fleet.journal_path_for(peer_id))
        replay_ms = round((time.perf_counter() - t0) * 1e3, 3)
        adopted = []
        for qid, jq in replayed.items():
            if jq.state != "INFLIGHT":
                continue
            with self._lock:
                if qid in self.queries:
                    continue  # already here (router double-submit etc.)
                sm = QueryStateMachine(qid)
                record = self.queries[qid] = {
                    "sm": sm, "sql": jq.sql, "result": None, "columns": None,
                    "done": threading.Event(), "spooled": jq.spooled,
                    "journaled": True, "resumed": True, "resume_state": jq,
                    "adopted_from": peer_id, "journal_replay_ms": replay_ms,
                }
            if self.journal is not None:
                # re-journal the adopted query into OUR file — with the
                # peer's dispatch/commit progress — so a later crash of
                # THIS coordinator hands the chain on intact
                self.journal.append(
                    "admit", qid, sql=jq.sql, session=jq.session,
                    spooled=jq.spooled, adopted_from=peer_id,
                )
                for fid, ntasks in jq.dispatches.items():
                    self.journal.append(
                        "dispatch", qid, fragment=fid, ntasks=ntasks,
                        attempt=max(jq.next_attempt - 1, 0),
                    )
                for fid, parts in jq.commits.items():
                    for part, tid in parts.items():
                        self.journal.append(
                            "commit", qid, fragment=fid, part=part,
                            task_id=tid,
                        )
                # the write plane's exactly-once chain must survive a
                # second crash too: carry the peer's intents and markers
                # into OUR journal before replaying them
                for txn_id, intent in jq.write_intents.items():
                    self.journal.append(
                        "write_intent", qid, txn_id=txn_id, **intent
                    )
                for txn_id, rows in jq.write_commits.items():
                    self.journal.append(
                        "write_commit", qid, txn_id=txn_id, rows=rows
                    )
                for txn_id in jq.write_aborts:
                    self.journal.append(
                        "write_abort", qid, txn_id=txn_id,
                        reason="aborted before adoption", outcome="aborted",
                    )
            adopted.append(record)
        for record in adopted:
            FLEET_ADOPTIONS.inc()
            self._resume_one(record)

    # ------------------------------------------------------------ discovery
    def register_worker(self, url: str) -> None:
        with self._lock:
            known = url in self.workers
            if not known:
                self.workers[url] = _WorkerInfo(url)
        # a NEWLY announcing worker (first contact, or restart after a
        # goodbye) starts with a clean bill of health; the periodic
        # keep-alive announce from an already-registered worker must NOT
        # reset the breaker — that would wipe an earned quarantine
        if not known:
            self.failure_detector.reset(url)

    def deregister_worker(self, url: str) -> None:
        """Goodbye-announce from a drained worker (reference: the discovery
        server dropping a SHUTTING_DOWN node): forget it NOW, so post-drain
        probe failures never feed the circuit breaker — a graceful exit
        must produce zero QUARANTINED transitions."""
        with self._lock:
            self.workers.pop(url, None)
        self.failure_detector.forget(url)

    def alive_workers(self) -> list[str]:
        with self._lock:
            return [w.url for w in self.workers.values() if w.alive]

    def link_matrix(self) -> dict[str, dict[str, dict]]:
        """Cluster link matrix: consumer_url -> producer_url -> link cell
        (runtime/health.py snapshot shape).  Each worker contributes the
        row of links IT fetches over; the coordinator only relays.  Reading
        the matrix against the failure detector distinguishes the failure
        modes: every row to B DEAD + B's heartbeat failing = B is down;
        only A's row to B DEAD while B heartbeats fine = the A->B link is
        partitioned (B must NOT be quarantined for that)."""
        with self._lock:
            return {
                w.url: dict(w.links) for w in self.workers.values() if w.links
            }

    def _link_penalty(self, url: str) -> int:
        """Impaired-link count touching `url` (as producer or consumer) in
        the matrix — the placement tie-breaker: a worker behind a broken
        link can still run tasks, but an unimpaired peer is preferred."""
        bad = 0
        with self._lock:
            for w in self.workers.values():
                for prod, cell in (w.links or {}).items():
                    if cell.get("state") in ("SUSPECT", "DEAD") and (
                        prod == url or w.url == url
                    ):
                        bad += 1
        return bad

    def _steer_by_links(self, candidates: list[str]) -> list[str]:
        """Drop candidates touching SUSPECT/DEAD links when at least one
        clean candidate remains; never empties the pool (an impaired link
        beats no placement at all — the hedge path still works there)."""
        if len(candidates) < 2:
            return candidates
        good = [w for w in candidates if self._link_penalty(w) == 0]
        if good and len(good) < len(candidates):
            self._m_link_avoided.inc(len(candidates) - len(good))
            return good
        return candidates

    def _heartbeat_loop(self) -> None:
        """Heartbeat-driven failure detection (HeartbeatFailureDetector.
        java:76): each sweep probes workers, feeds latency/error outcomes
        into the EWMA circuit breaker, and derives dispatchability from its
        state.  QUARANTINED workers are skipped until their half-open
        window opens; one successful probe restores them.  The sweep also
        expires old finished queries (age-based spool GC)."""
        det = self.failure_detector
        while not self._hb_stop.wait(self.heartbeat_interval):
            with self._lock:
                infos = list(self.workers.values())
            cluster_by_query: dict[str, int] = {}
            mem_snapshots: dict[str, dict] = {}
            for w in infos:
                if not det.should_probe(w.url):
                    w.alive = False  # quarantined, half-open window closed
                    continue
                t0 = time.monotonic()
                try:
                    with urllib.request.urlopen(f"{w.url}/v1/info", timeout=2) as r:
                        info = json.loads(r.read())
                    det.record_success(w.url, time.monotonic() - t0)
                    # the worker announces its lifecycle state in /v1/info:
                    # DRAINING overlays the breaker (not dispatchable, but
                    # healthy and fetchable — nothing scheduled on it is
                    # retried, and no quarantine transition ever fires)
                    det.set_draining(
                        w.url, info.get("state") in ("draining", "drained")
                    )
                    w.failures = 0
                    w.last_seen = time.time()
                    for qid, b in (info.get("buffered_by_query") or {}).items():
                        cluster_by_query[qid] = cluster_by_query.get(qid, 0) + int(b)
                    w.mem = info.get("memory_pool")
                    if w.mem:
                        mem_snapshots[w.url] = w.mem
                    # residency rides the heartbeat (observatory plane):
                    # current rss can FALL after revocation; peak cannot
                    w.rss_bytes = info.get("rss_bytes")
                    w.peak_rss_bytes = info.get("peak_rss_bytes")
                    # disk-pool snapshots ride the same heartbeat: the GC
                    # tick below escalates spool reclaim under pressure
                    w.disk = info.get("disk_pool")
                    # link matrix fold: the worker's consumer-side view of
                    # every producer link it fetches over (runtime/health.py
                    # snapshot()).  A row going SUSPECT/DEAD while this
                    # heartbeat succeeds is the asymmetric-partition
                    # signature: the worker-to-worker data path is broken
                    # even though the coordinator's control path is fine.
                    new_links = info.get("links") or {}
                    for prod, cell in new_links.items():
                        old_cell = (w.links or {}).get(prod) or {}
                        if cell.get("state") != old_cell.get(
                            "state", "HEALTHY"
                        ):
                            _fr.record(
                                "link_state", node=self.url,
                                consumer=w.url, producer=prod,
                                old=old_cell.get("state", "HEALTHY"),
                                new=cell.get("state"),
                            )
                    w.links = new_links
                except Exception:
                    w.failures += 1
                    det.record_failure(w.url)
                was_alive = w.alive
                w.alive = det.is_dispatchable(w.url)
                if was_alive and not w.alive:
                    _fr.record(
                        "worker_dead", node=self.url, worker=w.url,
                        failures=w.failures,
                    )
            self._m_links_impaired.set(
                sum(
                    1
                    for w in infos
                    for cell in (w.links or {}).values()
                    if cell.get("state") not in (None, "HEALTHY")
                )
            )
            self._enforce_cluster_memory(cluster_by_query)
            self._enforce_node_memory(mem_snapshots)
            self._enforce_deadlines()
            self._expire_old_queries()
            self._fleet_tick()
            self._sweep_orphan_tasks(infos)
            self._gc_spool()
            self._gc_write_staging()

    def _sweep_orphan_tasks(self, workers) -> None:
        """Adopt-or-cancel sweep (journal-gated): list each worker's tasks
        and DELETE those whose query this coordinator does not know as
        live.  Pre-crash attempts of RESUMED queries stay adopted — their
        committed output wins via the spool's first-commit-wins rename —
        while tasks of terminal/unknown queries are orphans holding worker
        memory that no consumer will ever fetch."""
        if self.journal is None:
            return
        if self.fleet is not None and not self.fleet.is_gc_owner():
            # destructive sweeps are single-owner in a fleet: exactly one
            # elected member cancels, so two coordinators can never race a
            # delete against a peer's adoption
            return
        with self._lock:
            live = {
                qid for qid, rec in self.queries.items()
                if not rec["sm"].done
            }
        if self.fleet is not None:
            # a task is an orphan only if NO member claims its query live —
            # the fleet-wide union from the lease files, not just ours
            live |= self.fleet.fleet_live_queries()
        for w in workers:
            if not w.alive:
                continue
            try:
                with urllib.request.urlopen(
                    f"{w.url}/v1/task", timeout=2
                ) as r:
                    listing = json.loads(r.read())
            except Exception:
                continue  # old worker build or unreachable: skip
            for t in listing.get("tasks") or []:
                qid = t.get("query_id")
                if not qid or qid in live or self._query_live(qid):
                    # the second look: a query admitted after the live set
                    # was taken may have posted tasks before the listing
                    continue
                self._delete_task_quiet(w.url, t["task_id"])
                self._m_orphans.inc()

    def _query_live(self, qid: str) -> bool:
        with self._lock:
            rec = self.queries.get(qid)
            return rec is not None and not rec["sm"].done

    def _gc_spool(self) -> None:
        """Periodic spool GC: drop committed/staging dirs of queries that
        are neither live here nor younger than spool_gc_age_s (crashed
        coordinators never call remove_query — see SpooledExchange.gc)."""
        d = self.session.get("exchange_spool_dir") or ""
        if not d or not os.path.isdir(d):
            return
        if self.fleet is not None and not self.fleet.is_gc_owner():
            return  # GC is single-owner in a fleet (see _sweep_orphan_tasks)
        with self._lock:
            live = {
                qid for qid, rec in self.queries.items()
                if not rec["sm"].done
            }
        if self.fleet is not None:
            live |= self.fleet.fleet_live_queries()
        # memoized fragment dirs (memo_*) are owned by the fragment memo —
        # its eviction/invalidation deletes them; the age sweep must not
        live.add(MEMO_PREFIX)
        try:
            SpooledExchange(d).gc(
                live, age_s=float(self.session.get("spool_gc_age_s") or 0.0)
            )
        except Exception:
            traceback.print_exc()
        # pressure escalation (disk governance, runtime/disk.py): when a
        # node's disk-pool heartbeat shows the spool budget nearly full,
        # the age-based sweep above is not enough — reclaim NOW, memo
        # namespaces first, then non-live query dirs, before any commit on
        # that node has to shed.  The live set passed here is the
        # coordinator-local ∪ fleet-wide union, so a peer's running query
        # is never evicted (the fleet-liveness contract).
        try:
            for w in list(self.workers.values()):
                dp = getattr(w, "disk", None)
                if not dp or not dp.get("capacity"):
                    continue
                cap = int(dp["capacity"])
                used = int(dp.get("reserved") or 0)
                if used > 0.8 * cap:
                    SpooledExchange(d).reclaim(
                        used - int(0.5 * cap), live_query_ids=live
                    )
                    return  # one reclaim pass per tick is plenty
        except Exception:
            traceback.print_exc()

    def _split_parked(self, url: str) -> bool:
        """Is this worker parked out of split assignment?  A park expires
        split_park_s after the revocation that set it — by then the forced
        spill either landed (pressure gone) or the next sweep re-parks."""
        ts = self._split_park.get(url)
        if ts is None:
            return False
        if time.monotonic() - ts > self.split_park_s:
            self._split_park.pop(url, None)
            return False
        return True

    def _enforce_cluster_memory(self, by_query: dict[str, int]) -> None:
        """Kill the biggest reservation when the cluster exceeds its memory
        limit (reference: ClusterMemoryManager + TotalReservation
        LowMemoryKiller).  Workers report per-query RAM-resident output
        bytes; the query holding the most across the cluster dies first."""
        limit = self.cluster_memory_limit_bytes
        if not limit or sum(by_query.values()) <= limit:
            return
        for qid, _bytes in sorted(by_query.items(), key=lambda kv: -kv[1]):
            record = self.queries.get(qid)
            if record is None or record["sm"].state in ("FINISHED", "FAILED"):
                continue
            record["kill_reason"] = (
                f"Query killed: cluster memory limit {limit} bytes exceeded "
                f"(query held {_bytes} buffered bytes)"
            )
            # graceful degradation: instead of failing outright, the kill is
            # requeued through the out-of-core spill executor (exec/spill.py)
            # — sequential slices with disk exchanges need a fraction of the
            # distributed working set (the reference fails the query;
            # TASK-retried FTE queries get bigger nodes — our analogue is a
            # smaller-footprint execution mode)
            record["requeue_spill"] = True
            record["cancel"] = True
            self.memory_kills += 1
            return  # one victim per sweep; re-evaluate next heartbeat

    def _enforce_node_memory(self, snapshots: dict[str, dict]) -> None:
        """Node-pool memory governance (reference: ClusterMemoryManager.
        java:92 + LowMemoryKiller).  Workers attach their NodeMemoryPool
        snapshot (reserved/blocked/per-query leases) to /v1/info; a node
        whose pressure — reservations over capacity, or tasks parked
        blocked-on-memory — persists past low_memory_killer_delay_s gets
        ONE escalation per sweep: ask the largest revocable holder to
        force-spill (the worker's sliced out-of-core execution honors the
        shrunken lease), or, when nothing revocable remains (or revocation
        is disabled), kill the query with the largest cluster-wide total
        reservation with a typed CLUSTER_OUT_OF_MEMORY error."""
        if not snapshots:
            return
        # only ACTIVE queries are revocation/kill candidates: a killed
        # query's leases linger until its tasks are deleted — acting on
        # those ghost bytes would cascade one pressure event into many
        # victims
        with self._lock:
            active = {
                qid for qid, rec in self.queries.items() if not rec["sm"].done
            }
        filtered = {
            url: dict(
                snap,
                by_query={
                    q: v
                    for q, v in (snap.get("by_query") or {}).items()
                    if q in active
                },
            )
            for url, snap in snapshots.items()
        }
        actions = self.cluster_memory_manager.sweep(
            filtered,
            killer_delay_s=float(
                self.session.get("low_memory_killer_delay_s") or 5.0
            ),
            revocation_enabled=bool(
                self.session.get("memory_revocation_enabled")
            ),
        )
        for act in actions:
            if act["action"] == "revoke":
                self._m_revocations_requested.inc()
                # split-driven scans: a revoked lease PARKS the node in the
                # split scheduler — its queued splits wait (or drain to
                # peers) while the revocation lands, instead of the old
                # whole-task 4x re-slice (runtime/splits.py)
                self._split_park[act["node"]] = time.monotonic()
                try:
                    req = urllib.request.Request(
                        f"{act['node']}/v1/memory/revoke",
                        data=json.dumps(
                            {"query_id": act["query_id"]}
                        ).encode(),
                        headers={"Content-Type": "application/json"},
                    )
                    with urllib.request.urlopen(req, timeout=5) as r:
                        r.read()
                except Exception:
                    pass  # worker gone: the breaker path handles it
                continue
            record = self.queries.get(act["query_id"])
            if record is None or record["sm"].done:
                continue
            self._m_oom_kills.inc()
            self.oom_kills += 1
            reason = (
                f"Query killed: a worker node memory pool stayed over "
                f"budget past low_memory_killer_delay_s and nothing was "
                f"revocable; this query held the largest total reservation "
                f"({act['bytes']} bytes) [CLUSTER_OUT_OF_MEMORY]"
            )
            record["kill_reason"] = reason
            record["cancel"] = True  # running stages abort mid-flight
            record["sm"].fail(reason, code="CLUSTER_OUT_OF_MEMORY")
            record["done"].set()

    def _enforce_deadlines(self) -> None:
        """Deadline watchdog (reference: QueryTracker.enforceTimeLimits):
        each heartbeat sweep kills queries past query_max_run_time_s with a
        typed EXCEEDED_TIME_LIMIT reason, and queries stuck QUEUED in their
        resource group past query_max_queued_time_s with
        EXCEEDED_QUEUED_TIME_LIMIT — an overloaded group sheds its backlog
        instead of wedging clients for the full poll ceiling."""
        max_run = float(self.session.get("query_max_run_time_s") or 0)
        max_queued = float(self.session.get("query_max_queued_time_s") or 0)
        now = time.time()
        with self._lock:
            records = list(self.queries.values())
        for record in records:
            sm: QueryStateMachine = record["sm"]
            if sm.done:
                continue
            age = now - sm.created_at
            if sm.state == "QUEUED":
                # cancel_queued is atomic with admission: True only while
                # the query still sits in the group queue, so a concurrent
                # start can never be killed as "queued too long"
                if (
                    max_queued
                    and age > max_queued
                    and self.resource_groups.cancel_queued(sm.query_id)
                ):
                    self._m_deadline.labels("queued_time").inc()
                    sm.fail(
                        f"Query exceeded maximum queued time of "
                        f"{max_queued}s (queued {age:.1f}s) "
                        f"[EXCEEDED_QUEUED_TIME_LIMIT]",
                        code="EXCEEDED_QUEUED_TIME_LIMIT",
                    )
                    record["done"].set()
                continue
            if max_run and age > max_run:
                self._m_deadline.labels("run_time").inc()
                reason = (
                    f"Query exceeded maximum run time of {max_run}s "
                    f"(ran {age:.1f}s) [EXCEEDED_TIME_LIMIT]"
                )
                record["kill_reason"] = reason
                record["cancel"] = True  # running stages abort mid-flight
                # fail the state machine NOW — the client sees the typed
                # reason immediately; the background run's own late failure
                # is absorbed by the terminal state
                sm.fail(reason, code="EXCEEDED_TIME_LIMIT")
                record["done"].set()

    def _expire_old_queries(self) -> None:
        """Age-based expiry of finished queries (reference: QueryTracker.
        pruneExpiredQueries): the record and any spooled result segments
        are dropped once `query_expiration_seconds` passed since the query
        reached a terminal state.  Candidates are collected under the lock;
        expiry runs outside it (expire_query re-locks)."""
        max_age = self.query_expiration_seconds
        if not max_age:
            return
        now = time.time()
        with self._lock:
            expired = [
                qid
                for qid, rec in self.queries.items()
                if rec["sm"].done
                and rec["sm"].finished_at is not None
                and now - rec["sm"].finished_at >= max_age
            ]
        for qid in expired:
            self.expire_query(qid)

    # ------------------------------------------------------------ execution
    def execute_query(self, sql: str) -> list[tuple]:
        """Synchronous execution (the HTTP protocol wraps this async)."""
        qid = self.submit_query(sql)
        record = self.queries[qid]
        sm: QueryStateMachine = record["sm"]
        record["done"].wait()
        if sm.state == "FAILED":
            raise RuntimeError(sm.error)
        return record["result"]

    def submit_query(
        self, sql: str, spooled: bool = False,
        prepared: Optional[dict] = None,
        query_id: Optional[str] = None,
    ) -> str:
        """Admission-controlled submit (reference: DispatchManager.createQuery
        queueing through resource groups before SqlQueryExecution starts).
        The query's declared memory budget counts against its group while it
        runs; a full queue rejects immediately.

        `prepared` is the client's statement registry from its
        X-Trino-Prepared-Statement headers (name -> SQL text): EXECUTE
        resolves against it before falling back to server-side PREPAREs, so
        stateless clients can replay their registry on every request.

        `query_id` lets the FLEET ROUTER mint the id (runtime/fleet.py):
        the id-hash shard must be decided before the coordinator is picked,
        so the router generates it and forwards via X-Trino-Query-Id."""
        from .resourcegroups import QueryRejected

        qid = query_id or f"q_{uuid.uuid4().hex[:12]}"
        sm = QueryStateMachine(qid)
        record = {
            "sm": sm, "sql": sql, "result": None, "columns": None,
            "done": threading.Event(),
            "spooled": spooled and bool(self.session.get("client_spool_dir")),
            "prepared": prepared,
        }
        with self._lock:
            if qid in self.queries:
                # router retry of an already-admitted id: idempotent
                return qid
            self.queries[qid] = record
        _fr.record(
            "query_admit", node=self.url, query_id=qid,
            spooled=record["spooled"],
        )
        if self.journal is not None and isinstance(sql, str):
            # admission is the journal's birth record: a crash after this
            # point leaves enough (SQL + explicit session overrides) to
            # re-plan the query under the same id
            record["journaled"] = True
            self.journal.append(
                "admit", qid, sql=sql,
                session=dict(self.session._values),
                spooled=record["spooled"],
            )
        if self.fleet is not None:
            # publish the id into OUR lease before any task can dispatch:
            # the fleet GC owner treats worker tasks of queries absent from
            # every lease as orphans, and must never race a peer's
            # just-admitted query (the heartbeat renew alone leaves a gap)
            try:
                with self._lock:
                    live = [
                        q for q, rec in self.queries.items()
                        if not rec["sm"].done
                    ]
                self.fleet.renew(live)
            except Exception:
                pass

        def start():
            threading.Thread(
                target=self._run_admitted, args=(record,), daemon=True
            ).start()

        group = self.session.get("resource_group")
        mem = int(self.session.get("query_max_memory_bytes") or 0)
        try:
            self.resource_groups.submit(group, qid, mem, start)
        except QueryRejected as e:
            sm.fail(str(e))
            record["done"].set()
        return qid

    def _run_admitted(self, record: dict) -> None:
        try:
            self._run(record)
        finally:
            self.resource_groups.finish(record["sm"].query_id)
            record["done"].set()

    def _execute_query_unmanaged(self, sql) -> list[tuple]:
        """Run a query without resource-group admission — for SELECTs nested
        inside an already-admitted statement (CTAS / INSERT...SELECT), which
        would deadlock against their own group's concurrency slot."""
        return self._execute_unmanaged_record(sql)["result"]

    def _execute_unmanaged_record(self, sql, analyze: bool = False) -> dict:
        """Unmanaged run returning the full query record — EXPLAIN ANALYZE
        needs record["query_info"] (per-stage operator stats), not just the
        rows.  analyze=True makes every task time its operators eagerly."""
        qid = f"q_{uuid.uuid4().hex[:12]}"
        sm = QueryStateMachine(qid)
        record = {
            "sm": sm, "sql": sql, "result": None, "columns": None,
            "done": threading.Event(),
            "spooled": False,  # nested statements always return rows inline
            "analyze": analyze,
        }
        with self._lock:
            self.queries[qid] = record
        self._run(record)
        if sm.state == "FAILED":
            raise RuntimeError(sm.error)
        return record

    def expire_query(self, qid: str) -> None:
        """Forget a finished query and GC its spooled result segments."""
        self.remove_spooled_result(qid)
        with self._lock:
            self.queries.pop(qid, None)

    def cancel_query(self, qid: str) -> bool:
        """Cancel a queued or running query (reference: DELETE
        /v1/statement/{id} -> DispatchManager.cancelQuery).  Running stages
        observe the flag between scheduling steps; already-posted tasks are
        deleted by the run's cleanup path."""
        with self._lock:
            record = self.queries.get(qid)
        if record is None:
            return False
        record["cancel"] = True
        sm: QueryStateMachine = record["sm"]
        # atomic with admission: True only while the query is still in the
        # group queue, so a concurrent start can never lose its slot
        if self.resource_groups.cancel_queued(qid):
            sm.fail("Query was canceled")
            record["done"].set()
        return True

    def _run(self, record: dict) -> None:
        """Lifecycle shell around one query: opens the query trace span
        (whose traceparent every task POST carries), fires created/
        completed/failed events, and feeds the query metrics.  The actual
        scheduling lives in _run_inner."""
        sm: QueryStateMachine = record["sm"]
        sql_text = record["sql"] if isinstance(record["sql"], str) else "<planned>"
        self.events.fire(QueryEvent("created", sm.query_id, sql_text))
        t0 = time.perf_counter()
        try:
            with self.tracer.span("query", query_id=sm.query_id) as qspan:
                record["trace_id"] = qspan.trace_id
                record["traceparent"] = traceparent(qspan)
                self._run_inner(record)
                self.tracer.annotate(state=sm.state)
        finally:
            if self._killed:
                return  # crash simulation: the query ends mid-flight,
                # un-terminal and un-journaled — recovery's starting state
            wall = time.perf_counter() - t0
            self._m_query_seconds.observe(wall)
            self._m_queries.labels(sm.state).inc()
            if self.journal is not None and record.get("journaled"):
                self.journal.append(
                    "finish", sm.query_id, state=sm.state,
                    error=sm.error, error_code=sm.error_code,
                )
            if record.get("resumed"):
                self._m_resumed.labels(
                    "completed" if sm.state == "FINISHED" else "failed"
                ).inc()
            qi = record.get("query_info") or {}
            self.events.fire(
                QueryEvent(
                    "completed" if sm.state == "FINISHED" else "failed",
                    sm.query_id,
                    sql_text,
                    wall,
                    rows=len(record["result"] or []),
                    error=sm.error,
                    cpu_ms=float(qi.get("cpu_ms") or 0.0),
                    peak_memory_bytes=int(qi.get("peak_memory_bytes") or 0),
                    stage_count=int(qi.get("stage_count") or 0),
                )
            )
            try:  # history must never fail a finished query
                self.history.record(self._history_record(record, wall))
            except Exception:
                traceback.print_exc()
            _fr.record(
                "query_finish", node=self.url, query_id=sm.query_id,
                state=sm.state, wall_ms=round(wall * 1e3, 3),
                anomalies=[a["kind"] for a in record.get("anomalies") or []]
                or None,
            )
            # post-mortem bundle: typed failure or a sentinel-flagged run
            # fans out to every node that touched the query and writes one
            # correlated JSONL bundle under the spool dir — never fails
            # the query it documents
            try:
                if sm.state == "FAILED":
                    self._write_postmortem(record, trigger="failure")
                elif record.get("anomalies"):
                    self._write_postmortem(record, trigger="anomaly")
            except Exception:
                traceback.print_exc()

    def _history_record(self, record: dict, wall_s: float) -> dict:
        """JSON-able completed-query snapshot for the history store: the
        QueryInfo (minus the bulky per-stage plan text) plus the final
        phase ledger — everything /v1/query and profile_report.py need
        after the live record expires."""
        sm: QueryStateMachine = record["sm"]
        qi = dict(record.get("query_info") or {})
        qi.pop("workers", None)
        qi["stages"] = [
            {k: v for k, v in st.items() if k != "plan"}
            for st in qi.get("stages") or []
        ]
        qi["phase_ledger"] = self._phase_ledger(record)  # final state times
        qi.update({
            "query_id": sm.query_id,
            "state": sm.state,
            "error": sm.error,
            "error_code": sm.error_code,
            "sql": (record["sql"] if isinstance(record["sql"], str)
                    else "<planned>")[:500],
            "created_ts": sm.created_at,
            "finished_ts": sm.finished_at,
            "wall_s": round(wall_s, 4),
            "rows": len(record["result"] or []),
            # result-cache provenance: planhash feeds history-driven
            # admission (ResultCache.admissible counts recurrences of it);
            # cached marks hits — which still land here, by design.  With
            # the result cache disabled no plan was hashed — the anomaly
            # sentinel still needs a stable per-statement key, so the SQL
            # hash stands in (QueryHistoryStore.baseline matches on it)
            "planhash": self._baseline_key(record),
            "cached": bool(record.get("cached")),
            # plan-cache provenance: the EXECUTE's resolved template feeds
            # FastPath._recurring_templates fleet-wide (shared history)
            "template": record.get("template"),
        })
        return qi

    def _phase_ledger(self, record: dict) -> dict:
        """Per-query time breakdown in ms.  Lifecycle phases come from the
        state machine's per-state history; compiling / exchange-wait /
        spill / blocked-on-memory come from the task stats the workers
        reported (aggregated by _collect_query_info).  ``executing_ms`` is
        cluster cpu minus attributed compile — kernels + table IO."""
        sm: QueryStateMachine = record["sm"]
        phases = sm.phase_seconds()
        qi = record.get("query_info") or {}
        compile_ms = float(qi.get("compile_ms") or 0.0)
        ledger = {
            "queued_ms": round(phases.get("QUEUED", 0.0) * 1e3, 3),
            "planning_ms": round(phases.get("PLANNING", 0.0) * 1e3, 3),
            "starting_ms": round(phases.get("STARTING", 0.0) * 1e3, 3),
            "running_ms": round(phases.get("RUNNING", 0.0) * 1e3, 3),
            "finishing_ms": round(phases.get("FINISHING", 0.0) * 1e3, 3),
            "compiling_ms": round(compile_ms, 3),
            "executing_ms": round(
                max(0.0, float(qi.get("cpu_ms") or 0.0) - compile_ms), 3
            ),
            "exchange_wait_ms": round(
                float(qi.get("exchange_wait_ms") or 0.0), 3
            ),
            "spill_ms": round(float(qi.get("spill_ms") or 0.0), 3),
            "blocked_on_memory_ms": round(
                float(qi.get("memory_blocked_ms") or 0.0), 3
            ),
            # compile resilience: how many task executions ran the eager
            # fallback path instead of a compiled program (a count, not a
            # duration — their wall is inside executing_ms)
            "fallback_executions": int(qi.get("fallback_executions") or 0),
        }
        if record.get("journal_replay_ms") is not None:
            # resumed queries carry the restart's journal replay wall
            ledger["journal_replay_ms"] = round(
                float(record["journal_replay_ms"]), 3
            )
        if record.get("cached"):
            # result-cache hit: the ledger shows a real lifecycle (queued/
            # planning/running) but zero cluster execution
            ledger["cached"] = True
        return ledger

    # ----------------------------------------------------- anomaly sentinel
    def _baseline_key(self, record: dict) -> Optional[str]:
        """Stable per-statement baseline key: the optimizer plan hash when
        the result-cache hook computed one, else a hash of the SQL text —
        so the sentinel works even with result_cache_enabled=false (where
        repeated identical queries would otherwise have no key at all)."""
        ph = (record.get("cache") or {}).get("planhash")
        if ph:
            return ph
        sql = record.get("sql")
        if isinstance(sql, str) and sql:
            return "sql:" + hashlib.sha1(sql.encode()).hexdigest()[:16]
        # planned submissions (EXPLAIN ANALYZE hands the coordinator an
        # AST, not text): the static per-stage plan text is stable across
        # runs of the same statement and stands in as the plan hash
        qi = record.get("query_info") or {}
        parts: list[str] = []
        for st in qi.get("stages") or []:
            plan = st.get("plan") or ""
            parts.append(
                "\n".join(plan) if isinstance(plan, list) else str(plan)
            )
        # ANALYZE runs store plans with per-run [rows, ms] annotations —
        # strip them or identical statements never share a baseline key
        plans = re.sub(r"\s*\[rows: [^\]]*\]", "", "\n".join(parts))
        if plans.strip():
            return "plan:" + hashlib.sha1(plans.encode()).hexdigest()[:16]
        return None

    def _score_anomalies(self, record: dict) -> None:
        """Anomaly sentinel: score the finished run against its planhash's
        rolling baseline (QueryHistoryStore.baseline) and attach typed
        anomalies to QueryInfo.  Runs BEFORE the history record is written,
        so flagged runs are excluded from future baselines and a clean
        re-run after a flagged one is not dragged into a false positive.
        Below anomaly_min_samples the sentinel stays silent — a cold
        baseline must never flag."""
        qi = record.get("query_info")
        if qi is None or not bool(self.session.get("anomaly_detection_enabled")):
            return
        record["anomalies"] = qi["anomalies"] = []
        key = self._baseline_key(record)
        if not key or record.get("cached"):
            return  # cache hits did no cluster work — nothing to score
        base = self.history.baseline(
            key, min_samples=int(self.session.get("anomaly_min_samples") or 3)
        )
        qi["baseline"] = base
        if base is None:
            return
        anomalies: list[dict] = []
        factor = float(self.session.get("anomaly_slow_factor") or 2.0)
        wall = float(qi.get("wall_ms") or 0.0)
        p50, p95 = base["wall_ms_p50"], base["wall_ms_p95"]
        min_delta = float(self.session.get("anomaly_min_wall_delta_ms") or 0.0)
        if wall > max(p95, factor * p50) and wall - p50 >= min_delta:
            anomalies.append({
                "kind": "SLOW_VS_BASELINE", "wall_ms": wall,
                "baseline_p50_ms": p50, "baseline_p95_ms": p95,
                "factor": round(wall / p50, 2) if p50 else None,
            })
        spill = float(qi.get("spill_ms") or 0.0)
        spill_min = float(self.session.get("anomaly_spill_min_ms") or 0.0)
        if spill > spill_min and spill > factor * base["spill_ms_p50"]:
            anomalies.append({
                "kind": "SPILL_REGRESSION", "spill_ms": spill,
                "baseline_p50_ms": base["spill_ms_p50"],
            })
        retries = int(qi.get("task_retries") or 0)
        storm = int(self.session.get("anomaly_retry_storm_threshold") or 3)
        if retries >= storm and base["retries_p50"] < storm:
            anomalies.append({
                "kind": "RETRY_STORM", "task_retries": retries,
                "baseline_p50": base["retries_p50"],
            })
        compiles = sum(
            int(agg.get("compiles") or 0)
            for agg in (qi.get("compile_signatures") or {}).values()
        )
        qi["compile_count"] = compiles  # rides into history for baselines
        cmin = int(self.session.get("anomaly_compile_storm_min") or 2)
        cp50 = base["compiles_p50"]
        if compiles > max(2 * cp50, cp50 + cmin):
            anomalies.append({
                "kind": "COMPILE_STORM", "compile_count": compiles,
                "baseline_p50": cp50,
            })
        # bandwidth regression: INVERTED comparison — low achieved GB/s
        # is the failure.  The floor guard keeps noise-band signatures
        # (tiny programs where a scheduler hiccup halves "bandwidth")
        # from flagging; a run with no roofline figure stays silent.
        gbps = float(qi.get("device_gb_per_sec") or 0.0)
        bp50 = float(base.get("gb_per_sec_p50") or 0.0)
        bfac = float(self.session.get("anomaly_bandwidth_factor") or 2.0)
        bfloor = float(
            self.session.get("anomaly_bandwidth_min_gb_per_sec") or 0.0
        )
        if gbps > 0 and bp50 > 0 and bp50 >= bfloor and gbps < bp50 / bfac:
            anomalies.append({
                "kind": "BANDWIDTH_REGRESSION", "gb_per_sec": gbps,
                "baseline_p50": bp50,
                "factor": round(bp50 / gbps, 2),
            })
        record["anomalies"] = qi["anomalies"] = anomalies
        for a in anomalies:
            self._m_anomalies.labels(a["kind"]).inc()
            _fr.record(
                "anomaly", node=self.url, query_id=record["sm"].query_id,
                anomaly=a["kind"],
                **{k: v for k, v in a.items() if k != "kind"},
            )

    # ------------------------------------------------ federated time series
    def _federated_timeseries(
        self,
        since: Optional[float] = None,
        series: Optional[list[str]] = None,
    ) -> dict:
        """Cluster utilization view: ``{node: {series: [[ts, v], ...]}}``
        — this process's lanes plus every alive worker's own lane fetched
        over ``GET /v1/timeseries``.  In-process test clusters share one
        store, so a worker's lane is usually already local; the fetch
        covers the separate-process deployment and is skipped when the
        lane is present (the shared ring would answer identically)."""
        nodes = _ts.snapshot(since=since, series=series)
        q = []
        if since is not None:
            q.append(f"since={since}")
        if series:
            q.append("series=" + ",".join(series))
        qs = ("?" + "&".join(q)) if q else ""
        for wurl in self.alive_workers():
            if wurl in nodes:
                continue
            try:
                with urllib.request.urlopen(
                    f"{wurl}/v1/timeseries{qs}", timeout=3
                ) as r:
                    payload = json.loads(r.read())
            except Exception:
                continue  # a dead worker's lane is simply absent
            lanes = payload.get("series") or {}
            if lanes:
                nodes[payload.get("node") or wurl] = lanes
        return nodes

    # ---------------------------------------------------- post-mortem bundle
    def _postmortem_dir(self) -> str:
        """Bundle root: the spooled-exchange dir when configured (the
        postmortem_* namespace is age-GC'd by the same spool sweep as
        memo_*), else a stable tmp fallback so failures are still
        documented on spool-less deployments."""
        return self.session.get("exchange_spool_dir") or os.path.join(
            tempfile.gettempdir(), "trino_tpu_postmortem"
        )

    def postmortem_path(self, qid: str) -> str:
        return os.path.join(
            self._postmortem_dir(), f"postmortem_{qid}", "bundle.jsonl"
        )

    def _query_nodes(self, record: Optional[dict]) -> list[str]:
        """Every worker URL that touched the query (from the dispatch
        ledger), falling back to the whole membership when the record is
        gone (on-demand post-mortem of an expired query — each node's
        flight-recorder slice filters by query id anyway)."""
        urls: list[str] = []
        tu = (record or {}).get("task_urls") or {}
        for lst in tu.values():
            for u, _tid in lst:
                if u != SPOOL_URL and u not in urls:
                    urls.append(u)
        if not urls:
            with self._lock:
                urls = list(self.workers)
        return urls

    def _journal_lines(self, qid: str) -> list[dict]:
        """This query's raw journal records (admit/dispatch/commit/finish)
        for the bundle — read back from the JSONL file, best-effort."""
        if self.journal is None:
            return []
        out = []
        try:
            with open(self.journal.path, encoding="utf-8") as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    if rec.get("query_id") == qid:
                        out.append(rec)
        except OSError:
            pass
        return out

    def write_postmortem(self, qid: str, trigger: str) -> Optional[dict]:
        """On-demand bundle (POST /v1/query/{id}/postmortem): works from
        the live record when the query is still tracked, else from its
        history snapshot."""
        with self._lock:
            record = self.queries.get(qid)
        if record is not None:
            return self._write_postmortem(record, trigger=trigger)
        hist = self.history.get(qid)
        if hist is None:
            return None
        pseudo = {
            "sm": None, "query_id": qid, "sql": hist.get("sql"),
            "query_info": hist, "anomalies": hist.get("anomalies"),
            "trace_id": hist.get("trace_id"),
            "_state": hist.get("state"), "_error": hist.get("error"),
        }
        return self._write_postmortem(pseudo, trigger=trigger)

    def _write_postmortem(self, record: dict, trigger: str) -> Optional[dict]:
        """Fan out to every node that touched the query, collect each
        node's flight-recorder slice, and write ONE correlated JSONL
        bundle (header + QueryInfo/phase ledger + journal records + every
        node's events) under the spool dir.  The bundle dir is disk-pool
        leased and lives in the postmortem_* namespace the spool GC ages
        out like memo_*; GET /v1/query/{id}/postmortem serves the file —
        including after a coordinator restart."""
        if not bool(self.session.get("postmortem_enabled")):
            return None
        sm = record.get("sm")
        qid = sm.query_id if sm is not None else record["query_id"]
        state = sm.state if sm is not None else record.get("_state")
        error = sm.error if sm is not None else record.get("_error")
        # collect per-node lanes: each worker's endpoint serves only its
        # own aliases, the coordinator lane is everything minus what the
        # workers already claimed ((node, seq) dedup — in-process clusters
        # share one ring, separate processes have disjoint ones)
        events: list[dict] = []
        claimed: set[tuple] = set()
        nodes: list[str] = []
        dead_nodes: list[str] = []
        for wurl in self._query_nodes(record):
            try:
                with urllib.request.urlopen(
                    f"{wurl}/v1/flightrecorder?query_id={qid}", timeout=3
                ) as r:
                    slice_ = json.loads(r.read()).get("events") or []
            except Exception:
                # a killed worker cannot answer — its lane is absent and
                # noted in the header (in-process kills keep the shared
                # ring, so the coordinator lane below still has its events)
                dead_nodes.append(wurl)
                continue
            nodes.append(wurl)
            for ev in slice_:
                key = (ev.get("node"), ev.get("seq"))
                if key in claimed:
                    continue
                claimed.add(key)
                events.append(ev)
        for ev in _fr.snapshot(query_id=qid):
            key = (ev.get("node"), ev.get("seq"))
            if key not in claimed:
                claimed.add(key)
                events.append(ev)
        # cluster-scoped events carry no query id but are exactly what a
        # post-mortem reader needs: the worker death that caused the
        # retries belongs in this query's timeline
        for ev in _fr.snapshot(kinds=("worker_dead",)):
            key = (ev.get("node"), ev.get("seq"))
            if key not in claimed:
                claimed.add(key)
                events.append(ev)
        events.sort(key=lambda e: e.get("seq") or 0)
        qi = dict(record.get("query_info") or {})
        qi.pop("workers", None)
        sql = record.get("sql")
        header = {
            "type": "header",
            "query_id": qid,
            "written_ts": time.time(),
            "trigger": trigger,
            "state": state,
            "error": error,
            "anomalies": record.get("anomalies") or [],
            "sql": sql[:500] if isinstance(sql, str) else (
                "<planned>" if sql is not None else None
            ),
            "trace_id": record.get("trace_id") or "",
            "coordinator": self.url,
            "nodes": [self.url] + nodes,
            "unreachable_nodes": dead_nodes,
            "events": len(events),
        }
        lines = [json.dumps(header, default=str)]
        lines.append(json.dumps(dict(qi, type="query_info"), default=str))
        # observatory slice: every node's utilization lanes over the query
        # window (padded one sample either side so the reader sees the
        # before/after level, not just the spike) — one line, base budget
        try:
            t0 = (sm.created_at if sm is not None
                  else qi.get("created_ts")) or None
            t1 = (sm.finished_at if sm is not None
                  else qi.get("finished_ts")) or time.time()
            pad = _ts.STORE.sample_interval_s * 2
            lines.append(json.dumps({
                "type": "timeseries",
                "window": [t0, t1],
                "nodes": self._federated_timeseries(
                    since=(t0 - pad) if t0 else None
                ),
            }, default=str))
        except Exception:
            traceback.print_exc()
        for jrec in self._journal_lines(qid):
            lines.append(json.dumps(dict(jrec, type="journal"), default=str))
        ev_lines = [
            json.dumps(dict(ev, type="event"), default=str) for ev in events
        ]
        budget = int(self.session.get("postmortem_budget_bytes") or 16 << 20)
        base = sum(len(ln) + 1 for ln in lines)
        kept, total, dropped = [], base, 0
        for ln in reversed(ev_lines):  # keep the newest events under budget
            if total + len(ln) + 1 > budget:
                dropped += 1
                continue
            total += len(ln) + 1
            kept.append(ln)
        kept.reverse()
        if dropped:
            header["events_dropped"] = dropped
            lines[0] = json.dumps(header, default=str)
        lines.extend(kept)
        body = ("\n".join(lines) + "\n").encode()
        path = self.postmortem_path(qid)
        bdir = os.path.dirname(path)
        # disk-pool lease: bundle bytes count against a small coordinator
        # budget; the lease's path auto-harvests when the spool GC ages
        # the postmortem_* dir out (runtime/disk.py _refresh_locked)
        from .disk import DiskExceeded, NodeDiskPool

        with self._postmortem_lock:
            if self._postmortem_pool is None:
                self._postmortem_pool = NodeDiskPool(
                    capacity_bytes=max(
                        int(self.session.get("postmortem_budget_bytes")
                            or 16 << 20) * 8,
                        64 << 20,
                    ),
                    name=f"postmortem:{self.port}",
                )
        try:
            self._postmortem_pool.reserve(
                owner=f"postmortem_{qid}", nbytes=len(body),
                timeout_s=0.5, what="postmortem bundle", path=bdir,
            )
        except DiskExceeded:
            return None  # budget full: shed the bundle, never the query
        try:
            os.makedirs(bdir, exist_ok=True)
            with open(path, "wb") as f:
                f.write(body)
        except OSError:
            traceback.print_exc()
            return None
        if record.get("sm") is not None:
            record["postmortem_path"] = path
        self._m_postmortems.labels(trigger).inc()
        out = {
            "path": path, "nodes": header["nodes"],
            "unreachable_nodes": dead_nodes, "events": len(kept),
            "trigger": trigger,
        }
        _fr.record(
            "postmortem", node=self.url, query_id=qid, trigger=trigger,
            path=path, events=len(kept), nodes=len(header["nodes"]),
        )
        return out

    # ------------------------------------------------------- query progress
    def _progress_stage_begin(
        self, record: dict, fid: int, total: int, precommitted: int = 0
    ) -> None:
        with self._lock:
            prog = record.setdefault(
                "progress", {"stages": {}, "started_ts": time.time()}
            )
            prog["stages"][fid] = {
                "total": int(total),
                "completed": int(precommitted),
                "rows_out": 0,
                "output_bytes": 0,
            }

    def _progress_part_done(
        self, record: dict, fid: int, winner: tuple[str, str]
    ) -> None:
        """One split/task completed: bump the stage's completion count and
        fold the attempt's rows/bytes in from its final status (fields are
        ASSEMBLED under the lock, the status HTTP call runs outside it —
        the stats-fold discipline)."""
        url, task_id = winner
        st = {} if url == SPOOL_URL else (
            self._task_info(url, task_id).get("stats") or {}
        )
        with self._lock:
            stage = (record.get("progress") or {}).get("stages", {}).get(fid)
            if stage is None:
                return
            stage["completed"] += 1
            stage["rows_out"] += int(st.get("rows_out") or 0)
            stage["output_bytes"] += int(st.get("output_bytes") or 0)

    def query_progress(self, qid: str) -> Optional[dict]:
        """GET /v1/query/{id}/progress: split/task completion fraction,
        per-stage rows/bytes, and a naive rate-based ETA.  Assembled under
        the lock, serialized by the caller outside it."""
        with self._lock:
            record = self.queries.get(qid)
            if record is None:
                return None
            sm: QueryStateMachine = record["sm"]
            prog = record.get("progress") or {}
            stages = {
                str(fid): dict(st)
                for fid, st in (prog.get("stages") or {}).items()
            }
            out = {
                "query_id": qid,
                "state": sm.state,
                "started_ts": prog.get("started_ts"),
                "stages": stages,
                "anomalies": [
                    a["kind"] for a in record.get("anomalies") or []
                ],
            }
        total = sum(s["total"] for s in stages.values())
        done = sum(s["completed"] for s in stages.values())
        frac = (done / total) if total else (1.0 if sm.done else 0.0)
        out["splits_total"] = total
        out["splits_completed"] = done
        out["fraction"] = round(1.0 if sm.done else frac, 4)
        if sm.done:
            out["eta_s"] = 0.0
        elif prog.get("started_ts") and 0 < frac < 1:
            elapsed = time.time() - prog["started_ts"]
            out["eta_s"] = round(elapsed * (1 - frac) / frac, 2)
        else:
            out["eta_s"] = None  # no completions yet: no rate to project
        return out

    def _run_inner(self, record: dict) -> None:
        sm: QueryStateMachine = record["sm"]
        # full statement surface on the coordinator (reference: the
        # DataDefinitionTask family executes DDL coordinator-side while
        # embedded SELECTs run through the distributed scheduler)
        query_ast = record["sql"]
        if isinstance(record["sql"], str):
            from ..sql import statements as S

            try:
                stmt = S.parse_statement(record["sql"])
            except Exception:
                stmt = None  # let the query path report the syntax error
            if stmt is not None and not isinstance(stmt, S.QueryStmt):
                try:
                    sm.transition("PLANNING")
                    sm.transition("RUNNING")
                    if record.get("cancel"):
                        raise RuntimeError("Query was canceled")
                    surface = _statement_surface(self)
                    # txn ids derive from the query id (qid-w<seq>) so a
                    # journal replay can pair write intents with the query
                    surface._txn_local.query_id = sm.query_id
                    surface._txn_local.write_seq = 0
                    rows = surface.execute_stmt(
                        stmt, prepared=record.get("prepared")
                    )
                    record["result"] = rows
                    record["columns"] = (
                        [f"col{i}" for i in range(len(rows[0]))] if rows else ["result"]
                    )
                    if (
                        isinstance(stmt, S.Explain) and stmt.analyze
                        and record.get("adopted_from") and rows
                    ):
                        # an adopted EXPLAIN ANALYZE re-ran on THIS member:
                        # stamp the failover provenance into the rendered
                        # text (engine.py appends the same footer when the
                        # adopted query itself is the distributed one)
                        record["result"] = rows = rows + [(
                            f"-- fleet: adopted from "
                            f"{record['adopted_from']} by "
                            f"{self.fleet.coordinator_id if self.fleet else ''}"
                            f" (journal replay "
                            f"{record.get('journal_replay_ms', 0.0):.1f} ms)",
                        )]
                    if isinstance(stmt, S.ExecuteStmt):
                        # the fast path knows the plan's real output names;
                        # without it EXECUTE results degrade to col0..colN
                        fp = getattr(surface, "_fastpath", None)
                        if fp is not None and fp.last_columns:
                            record["columns"] = list(fp.last_columns)
                        if fp is not None and fp.last_template:
                            # resolved template rides into the history
                            # record: recurrence counts replicate through
                            # the fleet-shared history store and feed
                            # plan-cache eviction protection on every
                            # member (FastPath._recurring_templates)
                            record["template"] = fp.last_template
                    elif isinstance(stmt, S.Prepare):
                        # protocol echo (reference: Trino's added-prepare
                        # response header): the client mirrors this into its
                        # own registry and replays it on later requests
                        record["addedPrepare"] = {stmt.name: stmt.sql}
                    elif isinstance(stmt, S.Deallocate):
                        record["deallocatedPrepare"] = [stmt.name]
                    sm.transition("FINISHED")
                except InjectedCommitCrash:
                    # simulated hard death at a write-phase boundary: die
                    # exactly like kill() mid-statement — no abort, no
                    # terminal state, no journal finish record, server gone.
                    # Recovery is the restarted/adopting coordinator's
                    # journal replay (_resume_write_txn).
                    self.kill()
                    return
                except Exception as e:
                    traceback.print_exc()
                    sm.fail(str(e))
                return
            if stmt is not None:
                query_ast = stmt.query
        cs = self._result_cache_begin(record, query_ast)
        if cs is not None and cs.get("rows") is not None:
            # result-cache hit (a stored entry or an in-flight leader's
            # rows): no cluster execution, but the full query lifecycle —
            # state transitions, journal "finish", history record — still
            # runs, so hits are indistinguishable from executions to
            # clients and observability except for being instant
            try:
                sm.transition("PLANNING")
                sm.transition("RUNNING")
                if record.get("cancel"):
                    raise RuntimeError("Query was canceled")
                record["result"] = list(cs["rows"])
                record["columns"] = list(cs["columns"] or [])
                record["cached"] = True
                self._cache_hit_info(record)
                sm.transition("FINISHED")
            except Exception as e:
                sm.fail(str(e))
            return
        retries = 1 if self.session.get("retry_policy") == "QUERY" else 0
        try:
            for attempt in range(retries + 1):
                try:
                    sm.transition("PLANNING")
                    self._run_once(record, attempt)
                    self._result_cache_commit(record, cs)
                    sm.transition("FINISHED")
                    return
                except Exception as e:
                    if self._killed:
                        return  # crash simulation: no terminal transition
                    if attempt < retries:
                        continue  # query-level retry (RetryPolicy QUERY)
                    if record.pop("requeue_spill", None):
                        # graceful degradation on a cluster-memory kill:
                        # instead of failing, re-run through the out-of-core
                        # executor — sequential slices with disk exchanges
                        # bound the peak footprint, trading latency for
                        # completion
                        record["cancel"] = False
                        try:
                            self._requeue_out_of_core(record)
                            self._result_cache_commit(record, cs)
                            sm.transition("FINISHED")
                            return
                        except Exception as e2:
                            traceback.print_exc()
                            sm.fail(f"{e}; out-of-core requeue failed: {e2}")
                            return
                    traceback.print_exc()
                    sm.fail(str(e))
                    return
        finally:
            if cs is not None and cs.get("inflight") is not None:
                # leader hand-off: publish rows to followers (None on any
                # non-FINISHED exit so they execute themselves instead of
                # waiting forever)
                rows = record["result"] if sm.state == "FINISHED" else None
                self.result_cache.finish(
                    cs["key"], cs["inflight"], rows, record["columns"]
                )

    def _result_cache_begin(self, record: dict, query_ast):
        """Resolve this query against the result cache BEFORE execution.

        Returns None when caching is inapplicable (disabled, spooled-client
        protocol, unparseable), else a cache-state dict: ``rows`` set means
        serve from cache; otherwise the query executes and
        ``_result_cache_commit`` stores it when admitted.  Also stamps
        ``record["cache"]`` — the disposition that rides QueryInfo into the
        EXPLAIN ANALYZE ``-- cache:`` footer and /v1/query."""
        from ..utils.profiler import signature_of

        if not self.session.get("result_cache_enabled"):
            return None
        if record.get("spooled"):
            # spooled-protocol results live on disk as segments, not rows
            return None
        cache = self.result_cache
        if not isinstance(query_ast, str) and has_nondeterministic(query_ast):
            # checked on the AST: the planner folds now()/random() to
            # per-query constants, invisible after planning
            cache.count("bypass")
            record["cache"] = {
                "disposition": "bypass", "reason": "nondeterministic"
            }
            return None
        try:
            plan = optimize(
                self.planner.plan(record["sql"]), self.catalogs, self.session
            )
        except Exception:
            return None  # let the execution path raise the real error
        # _run_once reuses this plan for attempt 0 (pop: retries re-plan)
        record["_preplanned"] = plan
        planhash = signature_of(plan)
        record["cache"] = {"disposition": "bypass", "planhash": planhash}
        vvec = plan_version_vector(plan, self.catalogs)
        if vvec is None:
            cache.count("bypass")
            record["cache"]["reason"] = "time_travel"
            return None
        key = (planhash, vvec)
        key_text = cache.key_text(key)
        cs = {
            "key": key, "key_text": key_text, "planhash": planhash,
            "rows": None, "columns": None,
        }
        ttl = float(self.session.get("result_cache_ttl_s") or 0.0)
        hit = cache.lookup(key, ttl_s=ttl)
        analyze = bool(record.get("analyze"))
        if hit is not None and not analyze:
            cache.count("hit")
            record["cache"] = {
                "disposition": "hit", "key": key_text, "planhash": planhash,
            }
            cs["rows"], cs["columns"] = hit
            return cs
        record["cache"] = {
            "disposition": "hit" if hit is not None else "miss",
            "key": key_text, "planhash": planhash,
        }
        if analyze:
            # EXPLAIN ANALYZE always executes (the stats ARE the result);
            # it reports the disposition the plain query would have had,
            # and never leads/stores — its rows are a plan, not data
            cs["analyze"] = True
            return cs
        cs["store"] = cache.admissible(
            planhash, int(self.session.get("result_cache_min_recurrences"))
        )
        if not cs["store"]:
            # below the recurrence threshold nothing would be stored, so a
            # concurrent duplicate gains nothing from waiting — and tests /
            # workloads that rely on identical queries executing
            # independently (memory-pressure probes) keep that behavior
            cache.count("miss")
            return cs
        # in-flight dedup (the exec/compilesvc.py idiom): first identical
        # concurrent admissible query leads, the rest wait and reuse its rows
        leader, fl = cache.begin(key)
        if leader:
            cs["inflight"] = fl
        else:
            fl.event.wait(
                timeout=float(self.session.get("query_max_run_time_s"))
            )
            if fl.rows is not None:
                cache.count("hit")
                record["cache"] = {
                    "disposition": "hit", "key": key_text,
                    "planhash": planhash, "deduplicated": True,
                }
                cs["rows"], cs["columns"] = fl.rows, fl.columns
                return cs
            # leader failed or timed out: execute ourselves, lead nothing
        cache.count("miss")
        return cs

    def _result_cache_commit(self, record: dict, cs) -> None:
        """After a successful execution: attach the cache disposition (and
        fragment-memo counts) to QueryInfo, and store the result when the
        history-driven admission said yes."""
        qi = record.get("query_info")
        info = dict(record.get("cache") or {})
        for k in ("memo_hits", "memo_misses"):
            if record.get(k):
                info[k] = record[k]
        if qi is not None and info:
            qi["cache"] = info
        if cs is None or cs.get("analyze") or not cs.get("store"):
            return
        if cs.get("disposition") == "hit":
            return  # already stored; the entry stands
        rows = record.get("result")
        if rows is None:
            return
        cache = self.result_cache
        cache.max_bytes = int(
            self.session.get("result_cache_max_bytes") or cache.max_bytes
        )
        cache.store(cs["key"], list(rows), list(record.get("columns") or []))

    def _cache_hit_info(self, record: dict) -> None:
        """Minimal QueryInfo for a result served from the cache: no stages
        ran, so the interesting fields are the output and the cache key."""
        sm: QueryStateMachine = record["sm"]
        record["query_info"] = {
            "query_id": sm.query_id,
            "stages": [],
            "stage_count": 0,
            "cpu_ms": 0.0,
            "peak_memory_bytes": 0,
            "compile_ms": 0.0,
            "output_rows": len(record["result"] or []),
            "cached": True,
            "cache": dict(record.get("cache") or {}),
        }
        record["query_info"]["phase_ledger"] = self._phase_ledger(record)

    def _requeue_out_of_core(self, record: dict) -> None:
        """Re-run a memory-killed query coordinator-side with P sequential
        slices and disk exchanges (reference: memory-revoking spill — the
        cluster sheds load by degrading the biggest query, not killing it)."""
        from ..exec.spill import OutOfCoreExecutor

        plan = optimize(self.planner.plan(record["sql"]), self.catalogs, self.session)
        ex = OutOfCoreExecutor(
            self.catalogs,
            self.default_catalog,
            parts=4,
            session=self.session,
            device=self.device,
        )
        page = ex.execute(plan)
        record["columns"] = list(plan.output_names)
        record["result"] = page.to_pylist()
        self.memory_requeues += 1

    def _run_once(self, record: dict, attempt: int = 0) -> None:
        """One execution attempt.

        Scheduling modes (reference: execution/scheduler/policy/):
        - default: ALL-AT-ONCE — every stage's tasks are posted up front
          (task POST is non-blocking); workers long-poll their sources'
          token-sequenced buffers, so stages overlap like the reference's
          pipelined scheduler.  Task failures fail fast.
        - retry_policy=TASK: PHASED — stages run children-first with a
          barrier, and each task is individually re-scheduled on another
          alive worker on failure (the FTE scheduler's task-level retry,
          EventDrivenFaultTolerantQueryScheduler: possible here because
          completed stage outputs stay buffered on their workers).
        """
        sm: QueryStateMachine = record["sm"]
        workers = self.alive_workers()
        if not workers:
            raise RuntimeError("no alive workers")
        nw = len(workers)

        # the cache-begin hook already planned attempt 0 (for the plan hash
        # + version vector); retries re-plan from scratch
        plan = record.pop("_preplanned", None)
        if plan is None:
            plan = optimize(
                self.planner.plan(record["sql"]), self.catalogs, self.session
            )
        dplan = distribute(plan, self.catalogs, nw, self.session,
                           connector_buckets=True)
        fragments = fragment_plan(dplan)
        record["columns"] = list(plan.output_names)

        sm.transition("STARTING")
        frag_by_id = {f.id: f for f in fragments}

        def _task_count(f) -> int:
            # result fragment runs on the coordinator; a fragment whose
            # inputs are ALL replicated (gather/broadcast/single) and that
            # scans no table computes the same output in every task — run
            # ONE (reference: SystemPartitioningHandle SINGLE distribution;
            # fixes duplicated keyless-aggregate branches under UNION ALL)
            if f.output_kind == "result":
                return 1
            from ..plan.nodes import TableScan, walk

            has_scan = any(isinstance(n, TableScan) for n in walk(f.root))
            if (
                not has_scan
                and f.inputs
                and all(
                    frag_by_id[c].output_kind in ("gather", "broadcast", "single")
                    for c in f.inputs
                )
            ):
                return 1
            return nw

        ntasks = {f.id: _task_count(f) for f in fragments}
        consumer_of: dict[int, int] = {}
        for f in fragments:
            for child in f.inputs:
                consumer_of[child] = f.id

        phased = self.session.get("retry_policy") == "TASK"
        # split-driven scans (runtime/splits.py): a row-range scan fragment's
        # fan-out becomes its runtime split count — one task per
        # fixed-capacity morsel — instead of the worker count, and the
        # payload pins every morsel's scan-page capacity.  Phased-only: the
        # per-task retry/steal machinery IS the per-split machinery
        split_plans: dict[int, tuple[int, int]] = {}
        if phased and bool(self.session.get("split_driven_scans")):
            target = int(self.session.get("split_target_rows") or 65536)
            for f in fragments:
                if f.output_kind == "result":
                    continue
                sp = scan_split_plan(f.root, self.catalogs, target)
                if sp is not None:
                    split_plans[f.id] = sp
                    ntasks[f.id] = sp[0]
        # durable spooled exchange (reference: ExchangeManager SPI): finished
        # task output commits to this directory; a dead producer's committed
        # output is re-read instead of recomputed, and workers hold no
        # finished chunks in RAM
        spool_dir = self.session.get("exchange_spool_dir") or ""
        spool = SpooledExchange(spool_dir) if (spool_dir and phased) else None
        task_urls: dict[int, list[tuple[str, str]]] = {}  # frag -> [(url, task_id)]
        # the post-mortem fan-out reads this to learn which nodes touched
        # the query (the dict mutates in place as stages complete)
        record["task_urls"] = task_urls
        frag_meta: dict[int, tuple[dict, str]] = {}  # frag -> (payload_base, tag)
        all_tasks: list[tuple[str, str]] = []
        heal_seq = [0]

        def heal(fid: int) -> bool:
            """Recover fragment `fid`'s tasks whose workers died, children
            first.  With the spooled exchange configured, a dead producer
            whose output COMMITTED is simply re-pointed at the spool — its
            committed chunks are RE-READ, nothing recomputes (reference:
            FileSystemExchangeSource).  Only an uncommitted task (died
            mid-run) is recomputed on a live node.  Without a spool, phased
            mode keeps every completed stage's chunks un-acked on its
            worker, and a dead worker forces deterministic recompute.
            Returns True if any task moved."""
            f = frag_by_id[fid]
            moved = False
            for child in f.inputs:
                moved |= heal(child)
            urls_list = task_urls.get(fid)
            if urls_list is None:
                return moved
            dead = [
                i
                for i, (u, _) in enumerate(urls_list)
                if u != SPOOL_URL and not self._worker_alive(u)
            ]
            for i in dead:
                self._m_heals.inc()
                record["task_heals"] = record.get("task_heals", 0) + 1
                _fr.record(
                    "task_heal", node=self.url, query_id=sm.query_id,
                    task_id=urls_list[i][1], dead_worker=urls_list[i][0],
                    committed=bool(
                        spool is not None
                        and spool.is_committed(urls_list[i][1])
                    ),
                )
                if spool is not None and spool.is_committed(urls_list[i][1]):
                    urls_list[i] = (SPOOL_URL, urls_list[i][1])
                    moved = True
                    continue
                heal_seq[0] += 1
                alive = [
                    w for w in self.alive_workers() if w != urls_list[i][0]
                ] or self.alive_workers()
                if not alive:
                    raise RuntimeError("no alive workers to heal stage")
                payload_base_h, tag_h = frag_meta[fid]
                w = alive[(i + heal_seq[0]) % len(alive)]
                tid = f"{tag_h}_p{i}_h{heal_seq[0]}"
                payload = dict(
                    payload_base_h,
                    sources=self._sources_payload(f, frag_by_id, task_urls),
                    task_id=tid,
                    part=i,
                )
                all_tasks.append((w, tid))
                self._post_task(w, payload)
                state = self._wait_task(w, tid)
                if state != "FINISHED":
                    raise RuntimeError(f"healed task {tid} ended {state} on {w}")
                urls_list[i] = (w, tid)
                moved = True
            return moved

        # self-healing spool (the robustness plane): when a consumer
        # reads a producer partition the log says COMMITTED and finds it
        # missing or corrupt (disk died, an operator rm -rf'd the spool,
        # pressure GC raced), the consumer fails with the typed
        # "SPOOL_LOST:{producer_tid}:" marker — and instead of failing the
        # query we RE-RUN that producer under the same task id.  The spooled
        # exchange's first-commit-wins rename arbitrates exactly-once on
        # disk, so a reproduction is indistinguishable from the original to
        # every other consumer.  Bounded per query by spool_reproduce_limit.
        repro_lock = threading.Lock()
        repro_count = [0]

        def reproduce_lost(lost_tid: str, _depth: int = 0) -> bool:
            if spool is None or _depth > 4:
                return False
            hit = None
            for fid_r, (pb_r, tag_r) in frag_meta.items():
                if lost_tid.startswith(tag_r + "_p"):
                    hit = (fid_r, pb_r, tag_r)
                    break
            if hit is None:
                return False  # not ours (stale attempt namespace)
            fid_r, payload_base_r, tag_r = hit
            try:
                part = int(lost_tid[len(tag_r) + 2:].split("_", 1)[0])
            except ValueError:
                return False
            limit = int(self.session.get("spool_reproduce_limit") or 0)
            with repro_lock:
                if repro_count[0] >= limit:
                    return False
                repro_count[0] += 1
                n = repro_count[0]
            self._m_spool_repro.inc()
            record["spool_reproductions"] = (
                record.get("spool_reproductions", 0) + 1
            )
            _fr.record(
                "spool_reproduce", node=self.url, query_id=sm.query_id,
                task_id=lost_tid, count=n,
            )
            # clear the corrupt/partial partition so the reproduction's
            # commit rename lands (first-commit-wins would otherwise treat
            # the damaged dir as the winner)
            spool.discard(lost_tid)
            f_r = frag_by_id[fid_r]
            prev = (task_urls.get(fid_r) or [None] * (part + 1))[part]
            for k in range(2):
                alive = self.alive_workers()
                if prev is not None:  # not back onto the worker that ran it
                    alive = [w for w in alive if w != prev[0]] or alive
                if not alive:
                    return False
                w = alive[(part + n + k) % len(alive)]
                payload = dict(
                    payload_base_r,
                    sources=self._sources_payload(f_r, frag_by_id, task_urls),
                    task_id=lost_tid,
                    part=part,
                    attempt=f"r{n}",  # distinct spool staging dir
                )
                all_tasks.append((w, lost_tid))
                try:
                    self._post_task(w, payload)
                    state = self._wait_task(w, lost_tid)
                except Exception:
                    continue
                if state == "FINISHED":
                    lst = task_urls.get(fid_r)
                    if lst is not None and part < len(lst):
                        # consumers re-read the re-committed partition
                        # straight from the spool
                        lst[part] = (SPOOL_URL, lost_tid)
                    return True
                # nested loss: the reproduced producer's own spool source
                # vanished too — heal bottom-up, then retry this one
                try:
                    err = str(self._task_info(w, lost_tid).get("error") or "")
                except Exception:
                    err = ""
                mm = _LOST_SOURCE_RE.search(err)
                if not (mm and reproduce_lost(mm.group(1), _depth + 1)):
                    return False
            return False

        def on_task_failed(u: str, tid: str) -> None:
            # called by _run_stage_phased when every live attempt of a part
            # ended badly, BEFORE the consumer's retry is posted: if the
            # failure names a lost producer partition, reproduce it now so
            # the retry (whose refresh_sources re-reads task_urls) succeeds
            if spool is None or u == SPOOL_URL:
                return
            try:
                err = str(self._task_info(u, tid).get("error") or "")
            except Exception:
                return
            m = _LOST_SOURCE_RE.search(err)
            if m:
                reproduce_lost(m.group(1))

        sm.transition("RUNNING")
        # per-stage wall intervals (seconds since query start): EXPLAIN
        # ANALYZE / tests read these to see sibling stages overlapping
        stage_times: dict[int, tuple[float, float]] = {}
        record["stage_times"] = stage_times
        self.last_stage_times = stage_times
        t_query0 = time.perf_counter()
        heal_lock = threading.Lock()

        def build_payload(f) -> tuple[dict, str]:
            out_parts = ntasks[consumer_of[f.id]]
            sources = self._sources_payload(f, frag_by_id, task_urls)
            payload_base = {
                "query_id": sm.query_id,
                "fragment": plan_to_json(f.root),
                "output_kind": f.output_kind,
                "output_keys": [_encode(k) for k in f.output_keys],
                "out_parts": out_parts,
                "num_parts": ntasks[f.id],
                "sources": sources,
                # re-scheduled consumers must re-read sources from token
                # 0, so TASK retry keeps producer chunks un-acked
                "ack_sources": not phased,
                "exchange_dir": spool_dir if spool is not None else None,
                "memory_budget_bytes": int(
                    self.session.get("task_memory_budget_bytes") or 0
                ) or None,
                # workers join the query's trace and, under EXPLAIN ANALYZE,
                # time each operator eagerly
                "traceparent": record.get("traceparent"),
                "analyze": bool(record.get("analyze")),
                # worker-side no-progress watchdog arming (0 disables)
                "no_progress_timeout_s": float(
                    self.session.get("task_no_progress_timeout_s") or 0.0
                ),
                # node-pool reservation each task takes before executing
                # (0 = ungoverned); a full pool parks the task BLOCKED
                # until peers free bytes or the timeout escalates
                "memory_reserve_bytes": int(
                    self.session.get("task_memory_reserve_bytes") or 0
                ),
                "memory_blocked_timeout_s": float(
                    self.session.get("memory_blocked_timeout_s") or 0.0
                ),
                # compile resilience plane (exec/compilesvc.py): how long
                # each task waits for kernel 2's build, and its deadline
                "compile_wait_budget_ms": int(
                    self.session.get("compile_wait_budget_ms") or 0
                ),
                "compile_deadline_s": float(
                    self.session.get("compile_deadline_s") or 0.0
                ),
                # coherent deadline propagation: the query's absolute
                # deadline (epoch seconds) rides every task POST (and the
                # X-Trino-Deadline header, folded in worker do_POST) so
                # each exchange hop computes its own remaining budget
                # instead of burning the full per-fetch timeout against a
                # query the watchdog is about to kill anyway
                "deadline_ts": (
                    sm.created_at
                    + float(self.session.get("query_max_run_time_s") or 0)
                    if float(self.session.get("query_max_run_time_s") or 0)
                    > 0
                    else 0.0
                ),
                "exchange_deadline_headroom_ms": int(
                    self.session.get("exchange_deadline_headroom_ms") or 500
                ),
                "exchange_retry_rotate": int(
                    self.session.get("exchange_retry_rotate") or 0
                ),
                "hedge_delay_quantile": float(
                    self.session.get("hedge_delay_quantile") or 0.95
                ),
            }
            if f.id in split_plans:
                # split-driven stage: each task is one morsel whose scan
                # pages pad to this fixed capacity (one set of learned
                # capacities whatever the scale, exec/compiler.py)
                payload_base["split_pad_rows"] = split_plans[f.id][1]
            # resumed queries offset the attempt namespace past every
            # journaled pre-crash attempt, so new task ids (and spool
            # staging dirs) never collide with adopted pre-crash tasks
            tag_attempt = attempt + int(record.get("resume_attempt") or 0)
            tag = f"{sm.query_id}_a{tag_attempt}_f{f.id}"
            frag_meta[f.id] = (payload_base, tag)
            if self.journal is not None and record.get("journaled"):
                self.journal.append(
                    "dispatch", sm.query_id, fragment=f.id,
                    ntasks=ntasks[f.id], attempt=tag_attempt,
                )
            return payload_base, tag

        def run_fragment_phased(f) -> None:
            if record.get("cancel"):
                raise RuntimeError(
                    record.get("kill_reason") or "Query was canceled"
                )
            t0 = time.perf_counter() - t_query0
            payload_base, tag = build_payload(f)
            # resumed query: parts whose pre-crash attempt COMMITTED to the
            # spool are re-read, not recomputed — but only when the
            # re-planned fragment kept the journaled fan-out (the cluster
            # may have changed size across the restart)
            pre: dict[int, str] = {}
            rc = record.get("resume_commits")
            if (
                rc
                and spool is not None
                and (record.get("resume_ntasks") or {}).get(f.id)
                == ntasks[f.id]
            ):
                pre = {
                    p: tid
                    for p, tid in (rc.get(f.id) or {}).items()
                    if spool.is_committed(tid)  # trust the disk, not the log
                }
                if pre:
                    record["parts_resumed"] = (
                        record.get("parts_resumed", 0) + len(pre)
                    )
                    if len(pre) == ntasks[f.id]:
                        record["stages_resumed"] = (
                            record.get("stages_resumed", 0) + 1
                        )
            # fragment memoization (runtime/resultcache.py): a memoizable
            # leaf fragment whose hash+version-vector matches an adopted
            # memo_* spool dir seeds every part as a precommitted spool
            # source — the journal resume idiom, applied across queries
            memo_key = None
            if (
                spool is not None
                and not pre
                and self.fragment_memo is not None
                and self.session.get("result_cache_enabled")
            ):
                mk = FragmentMemo.fragment_key(f, payload_base, self.catalogs)
                if mk is not None:
                    key_m, vvec_m, tables_m = mk
                    seeded = self.fragment_memo.lookup(
                        key_m, vvec_m, ntasks[f.id], spool
                    )
                    if seeded is not None:
                        pre = seeded
                        FragmentMemo.count("hit")
                        record["memo_hits"] = record.get("memo_hits", 0) + 1
                    else:
                        FragmentMemo.count("miss")
                        record["memo_misses"] = (
                            record.get("memo_misses", 0) + 1
                        )
                        memo_key = mk  # adopt this stage's dirs at the end

            def on_commit(p: int, task_id: str, fid=f.id) -> None:
                # a FINISHED task under the spooled exchange has durably
                # committed its output (the worker commits before finish):
                # journal it so a restart can skip this part
                if self.journal is not None and record.get("journaled"):
                    self.journal.append(
                        "commit", sm.query_id, fragment=fid, part=p,
                        task_id=task_id,
                    )

            def refresh_sources(f=f):
                # a consumer task may have failed because a SOURCE
                # worker died mid-query: recompute the producers it
                # lost, then hand back the refreshed source URLs
                with heal_lock:
                    for child in f.inputs:
                        heal(child)
                    return self._sources_payload(f, frag_by_id, task_urls)

            sched = None
            max_att = int(self.session.get("task_retry_attempts"))
            if f.id in split_plans:
                sched = SplitScheduler(
                    ntasks[f.id],
                    queue_depth=int(
                        self.session.get("split_queue_depth") or 2
                    ),
                    is_parked=self._split_parked,
                    query_id=sm.query_id,
                    node=self.url,
                    link_penalty=self._link_penalty,
                )
                max_att = int(self.session.get("split_retry_limit") or 0) + 1
            self._progress_stage_begin(record, f.id, ntasks[f.id], len(pre))
            try:
                urls = self._run_stage_phased(
                    payload_base,
                    ntasks[f.id],
                    tag,
                    max_attempts=max_att,
                    posted=all_tasks,  # every posted task gets cleaned up
                    refresh_sources=refresh_sources,
                    should_abort=lambda: (
                        (record.get("kill_reason") or "Query was canceled")
                        if record.get("cancel")
                        else None
                    ),
                    on_retry=lambda: record.__setitem__(
                        "task_retries", record.get("task_retries", 0) + 1
                    ),
                    precommitted=pre or None,
                    on_part_done=on_commit if spool is not None else None,
                    split_sched=sched,
                    on_task_failed=on_task_failed if spool is not None else None,
                    on_progress=lambda p, winner, fid=f.id: (
                        self._progress_part_done(record, fid, winner)
                    ),
                )
            finally:
                if sched is not None:
                    sched.close()  # release queued splits from the backlog
                    with heal_lock:
                        agg = record.setdefault("split_stats", {})
                        for k, v in sched.stats.items():
                            agg[k] = agg.get(k, 0) + v
                        agg["stages"] = agg.get("stages", 0) + 1
            task_urls[f.id] = urls
            stage_times[f.id] = (t0, time.perf_counter() - t_query0)
            if memo_key is not None:
                record.setdefault("memo_adopt", []).append(
                    (memo_key, {p: tid for p, (_u, tid) in enumerate(urls)})
                )

        try:
            non_result = [f for f in fragments if f.output_kind != "result"]
            if phased:
                # PHASED with overlap (reference: scheduler/policy/
                # PhasedExecutionSchedule.java — stages whose dependencies
                # are satisfied run together): independent subtrees (sibling
                # build sides, union branches) run CONCURRENTLY; each wave
                # launches every fragment whose children have completed
                done_ids: set[int] = set()
                pending_f = {f.id: f for f in non_result}
                while pending_f:
                    ready = [
                        f for f in pending_f.values()
                        if all(c in done_ids for c in f.inputs)
                    ]
                    if not ready:
                        raise RuntimeError("cyclic fragment graph")
                    if len(ready) == 1:
                        run_fragment_phased(ready[0])
                    else:
                        with ThreadPoolExecutor(
                            max_workers=min(len(ready), 8)
                        ) as pool:
                            futs = [
                                pool.submit(run_fragment_phased, f)
                                for f in ready
                            ]
                            for fu in futs:
                                fu.result()
                    for f in ready:
                        done_ids.add(f.id)
                        del pending_f[f.id]
            else:
                # ALL-AT-ONCE: posting is non-blocking; workers long-poll
                # their sources, so stages already overlap like the
                # reference's pipelined scheduler
                for f in sorted(non_result, key=lambda f: -f.id):
                    if record.get("cancel"):
                        raise RuntimeError(
                            record.get("kill_reason") or "Query was canceled"
                        )
                    t0 = time.perf_counter() - t_query0
                    payload_base, tag = build_payload(f)
                    # all-at-once posts fire-and-forget: progress reports
                    # the dispatch totals; completion lands when the root
                    # fetch drains the stage (fraction forced to 1 on done)
                    self._progress_stage_begin(record, f.id, ntasks[f.id])
                    urls = []
                    for p in range(ntasks[f.id]):
                        w = workers[p % nw]
                        task_id = f"{tag}_p{p}"
                        all_tasks.append((w, task_id))  # before post: no leak
                        self._post_task(w, dict(payload_base, task_id=task_id, part=p))
                        urls.append((w, task_id))
                    task_urls[f.id] = urls
                    stage_times[f.id] = (t0, time.perf_counter() - t_query0)

            # result fragment on the coordinator (COORDINATOR_DISTRIBUTION)
            from .worker import _stream_fetch

            root = frag_by_id[0]
            executor = LocalExecutor(
                self.catalogs, self.default_catalog, device=self.device,
                scan_cache=self.scan_cache,
            )
            # the root stage reports operator stats like any worker task
            executor.collect_operator_stats = True
            # and waits for kernel 2's builds as the session says
            executor.compile_wait_budget_ms = int(
                self.session.get("compile_wait_budget_ms") or 0
            )
            executor.compile_deadline_s = float(
                self.session.get("compile_deadline_s") or 0.0
            )
            if record.get("cancel"):  # e.g. memory kill during the stages
                raise RuntimeError(
                    record.get("kill_reason") or "Query was canceled"
                )
            remote_pages: dict[int, Page] = {}
            for child_id in root.inputs:
                child = frag_by_id[child_id]
                blobs: list[bytes] = []
                def fetch_one(u: str, t: str) -> list[bytes]:
                    if u == SPOOL_URL:
                        return spool.read_chunks(t, 0)
                    # a producer the heartbeats quarantined is dead: stop
                    # retrying it and heal (the spool or a re-run), rather
                    # than retrying until the fetch backoff's deadline
                    return _stream_fetch(
                        u, t, 0, node=self.url,
                        abort=lambda: self.failure_detector.state(u) == QUARANTINED,
                    )

                for i in range(len(task_urls[child_id])):
                    u, t = task_urls[child_id][i]
                    try:
                        blobs.extend(fetch_one(u, t))
                    except Exception as e:
                        if not phased:
                            raise RuntimeError(self._failure_detail(all_tasks, e))
                        # producer died between finishing and our fetch:
                        # re-read from the spool (or recompute it and
                        # anything it lost when nothing committed) — and
                        # when the COMMITTED partition itself is lost or
                        # corrupt, self-heal by reproducing the producer
                        if spool is not None and (
                            u == SPOOL_URL
                            or "spooled chunk removed" in str(e)
                            or "EXCHANGE_UNREACHABLE:" in str(e)
                        ):
                            reproduce_lost(t)
                        heal(child_id)
                        u, t = task_urls[child_id][i]
                        try:
                            blobs.extend(fetch_one(u, t))
                        except Exception as e2:
                            raise RuntimeError(self._failure_detail(all_tasks, e2))
                remote_pages[child_id] = wire_to_page(
                    blobs, list(child.root.output_types), device=self.device
                )
            sm.transition("FINISHING")
            if record.get("analyze"):
                page, root_an = executor.explain_analyze(root.root, remote_pages)
                for nid, s in root_an.items():
                    if "ms" in s:
                        executor.last_operator_stats.setdefault(nid, {})["ms"] = (
                            round(s["ms"], 3)
                        )
            else:
                page = executor.execute(root.root, remote_pages)
            record["result"] = page.to_pylist()
            # stats are pulled from the workers BEFORE cleanup deletes the
            # tasks; a stats failure must never fail a finished query
            try:
                self._collect_query_info(
                    record, fragments, ntasks, task_urls, executor,
                    stage_times, t_query0,
                )
            except Exception:
                traceback.print_exc()
            # anomaly sentinel scores HERE — before the EXPLAIN ANALYZE
            # renderer reads query_info (the "-- anomaly:" footer) and
            # before the history record is cut (flagged runs must not
            # poison their own baseline)
            try:
                self._score_anomalies(record)
            except Exception:
                traceback.print_exc()
            if record.get("spooled"):
                self._spool_result(sm.query_id, record)
            # adopt memo-miss fragment outputs into the memo_* namespace
            # BEFORE the finally's remove_query sweeps this query's dirs;
            # a failure here must never fail a finished query
            if spool is not None and not self._killed:
                for (key_m, vvec_m, tables_m), parts in record.pop(
                    "memo_adopt", []
                ):
                    try:
                        self.fragment_memo.adopt(
                            key_m, vvec_m, tables_m, parts, spool
                        )
                    except Exception:
                        traceback.print_exc()
        finally:
            if not self._killed:
                self._cleanup_tasks(all_tasks)
                if spool is not None:  # committed output dies with the query
                    spool.remove_query(sm.query_id)
            # on kill: leave tasks and spool dirs exactly where the crash
            # found them — the restarted coordinator resumes from them

    # ------------------------------------------------------------ QueryInfo
    def _collect_query_info(
        self, record, fragments, ntasks, task_urls, root_executor,
        stage_times, t_query0,
    ) -> None:
        """Aggregate per-task operator stats into record["query_info"] — the
        coordinator's QueryInfo (reference: QueryStats + StageStats +
        OperatorStats assembled by QueryStateMachine.getQueryInfo).  Each
        stage carries its plan annotated with summed per-operator rows (and
        eager ms under EXPLAIN ANALYZE), its task list, and its wall
        interval; query-wide rollups (cpu_ms = sum of task wall,
        peak_memory_bytes = largest task output) feed the completion event."""
        from ..plan.nodes import format_plan

        sm: QueryStateMachine = record["sm"]
        stages = []
        cpu_ms = 0.0
        peak_mem = 0
        mem_blocked_ms = 0.0
        mem_revocations = 0
        compile_ms = 0.0
        exchange_wait_ms = 0.0
        spill_ms = 0.0
        # kernel builds merged across every task (utils/profiler.py):
        # sig -> {compiles, compile_s, cache, modes, fallbacks, timeouts}
        compile_sigs: dict[str, dict] = {}
        fallback_execs = 0
        fallback_reasons: dict[str, int] = {}
        # roofline plane: sig -> {executes, execute_s, flops,
        # bytes_accessed} merged across every task's dispatch ledger —
        # unlike compile_sigs this names warm (cache-hit) signatures too
        exec_sigs: dict[str, dict] = {}
        # exchange plane: stage_id -> {url: {bytes, wall_ms, fetches}}
        stage_links: dict[int, dict] = {}

        def merge_execute_events(evmap) -> None:
            for sig, ev in (evmap or {}).items():
                agg = exec_sigs.setdefault(
                    sig,
                    {"executes": 0, "execute_s": 0.0,
                     "flops": None, "bytes_accessed": None},
                )
                agg["executes"] += int(ev.get("executes") or 0)
                agg["execute_s"] = round(
                    agg["execute_s"] + float(ev.get("execute_s") or 0.0), 6
                )
                for k in ("flops", "bytes_accessed"):
                    if ev.get(k) is not None:
                        agg[k] = float(ev[k])

        def merge_compile_events(events) -> None:
            nonlocal fallback_execs
            for ev in events or []:
                sig = ev.get("signature") or "?"
                agg = compile_sigs.setdefault(
                    sig,
                    {"compiles": 0, "compile_s": 0.0,
                     "cache": {"hit": 0, "miss": 0, "uncached": 0},
                     "modes": {}, "fallbacks": {}, "timeouts": 0},
                )
                mode = ev.get("mode") or "sync"
                agg["modes"][mode] = agg["modes"].get(mode, 0) + 1
                if mode == "fallback":
                    # fallback execution, not a compile: attribute apart
                    reason = ev.get("reason") or "compile_wait"
                    agg["fallbacks"][reason] = (
                        agg["fallbacks"].get(reason, 0) + 1
                    )
                    fallback_execs += 1
                    fallback_reasons[reason] = (
                        fallback_reasons.get(reason, 0) + 1
                    )
                    if ev.get("error") == "COMPILE_TIMEOUT":
                        agg["timeouts"] += 1
                    continue
                if ev.get("compile_s") is None:
                    continue  # joined/swapped-in: the owner's event counts
                agg["compiles"] += 1
                agg["compile_s"] = round(
                    agg["compile_s"] + float(ev.get("compile_s") or 0.0), 4
                )
                cache = ev.get("cache")
                if cache in agg["cache"]:
                    agg["cache"][cache] += 1

        for f in sorted(fragments, key=lambda fr: fr.id):
            ops: dict[int, dict] = {}
            task_infos = []
            if f.output_kind == "result":
                for nid, s in root_executor.last_operator_stats.items():
                    ops[int(nid)] = dict(s)
                wall = root_executor.last_execute_wall_ms or 0.0
                root_compile = getattr(root_executor, "last_compile_ms", 0.0)
                task_infos.append(
                    {"worker": "coordinator", "task_id": f"{sm.query_id}_root",
                     "wall_ms": round(wall, 3),
                     "compile_ms": round(root_compile, 3)}
                )
                cpu_ms += wall
                compile_ms += root_compile
                merge_compile_events(
                    getattr(root_executor, "compile_events", None)
                )
                # the root fragment executes in THIS process: join its
                # dispatch ledger with the local profiler's cost figures
                from ..utils.profiler import PROFILER as _prof

                root_evs = {}
                for sig, ev in (
                    getattr(root_executor, "execute_events", None) or {}
                ).items():
                    rec = dict(ev)
                    p = _prof.snapshot(sig) or {}
                    for k in ("flops", "bytes_accessed"):
                        if p.get(k) is not None:
                            rec[k] = p[k]
                    root_evs[sig] = rec
                merge_execute_events(root_evs)
            else:
                for (url, task_id) in task_urls.get(f.id, []):
                    if url == SPOOL_URL:
                        task_infos.append(
                            {"worker": SPOOL_URL, "task_id": task_id}
                        )
                        continue
                    st = self._task_info(url, task_id).get("stats") or {}
                    ti = {
                        "worker": url,
                        "task_id": task_id,
                        "wall_ms": st.get("wall_ms"),
                        "rows_out": st.get("rows_out"),
                        "output_bytes": st.get("output_bytes"),
                        "exchange_bytes_fetched": st.get("exchange_bytes_fetched"),
                        "exchange_bytes_served": st.get("exchange_bytes_served"),
                        "rows_pruned": st.get("rows_pruned"),
                        "upload_ms": st.get("upload_ms"),
                        "compile_ms": st.get("compile_ms"),
                        "exchange_wait_ms": st.get("exchange_wait_ms"),
                        "fallback": bool(st.get("fallback")),
                    }
                    task_infos.append(ti)
                    cpu_ms += float(st.get("wall_ms") or 0.0)
                    compile_ms += float(st.get("compile_ms") or 0.0)
                    exchange_wait_ms += float(st.get("exchange_wait_ms") or 0.0)
                    spill_ms += float(st.get("spill_ms") or 0.0)
                    merge_compile_events(st.get("compile_events"))
                    merge_execute_events(st.get("execute_events"))
                    for u, ls in (st.get("exchange_links") or {}).items():
                        agg = stage_links.setdefault(f.id, {}).setdefault(
                            u, {"bytes": 0, "wall_ms": 0.0, "fetches": 0}
                        )
                        agg["bytes"] += int(ls.get("bytes") or 0)
                        agg["wall_ms"] = round(
                            agg["wall_ms"] + float(ls.get("wall_ms") or 0.0),
                            3,
                        )
                        agg["fetches"] += int(ls.get("fetches") or 0)
                    peak_mem = max(
                        peak_mem,
                        int(st.get("output_bytes") or 0),
                        int(st.get("memory_reserved_bytes") or 0),
                    )
                    mem_blocked_ms += float(st.get("memory_blocked_ms") or 0.0)
                    mem_revocations += int(bool(st.get("memory_revoked")))
                    for nid_s, s in (st.get("operators") or {}).items():
                        nid = int(nid_s)
                        agg = ops.get(nid)
                        if agg is None:
                            ops[nid] = dict(s)
                            continue
                        # tasks partition the stage's rows: counts SUM; eager
                        # per-operator ms also sums (cluster CPU, like the
                        # reference's driver-summed OperatorStats)
                        for k in ("rows", "rows_in", "output_bytes",
                                  "invocations"):
                            if k in s:
                                agg[k] = agg.get(k, 0) + s[k]
                        if "ms" in s:
                            agg["ms"] = round(agg.get("ms", 0.0) + s["ms"], 3)
            ann = {
                nid: (
                    f"   [rows: {s['rows']}"
                    + (f", {s['ms']:.1f} ms" if "ms" in s else "")
                    + "]"
                )
                for nid, s in ops.items()
                if "rows" in s
            }
            stages.append(
                {
                    "stage_id": f.id,
                    "output_kind": f.output_kind,
                    "tasks": task_infos,
                    "operators": {str(n): s for n, s in sorted(ops.items())},
                    "plan": format_plan(f.root, annotations=ann).splitlines(),
                    "wall_interval_s": stage_times.get(f.id),
                }
            )
        # roofline attribution: achieved GB/s / GFLOP/s per executed
        # signature (cost_analysis() figures are per execution; execute_s
        # sums every dispatch, so scale cost by the dispatch count), then
        # the query-wide achieved bandwidth that feeds history baselines
        # and the BANDWIDTH_REGRESSION sentinel
        roof = None
        roofline_sigs: list[dict] = []
        total_bytes = 0.0
        total_exec_s = 0.0
        try:
            for sig in sorted(exec_sigs):
                ev = exec_sigs[sig]
                n = int(ev.get("executes") or 0)
                ex_s = float(ev.get("execute_s") or 0.0)
                byts = float(ev.get("bytes_accessed") or 0.0) * n
                flops = float(ev.get("flops") or 0.0) * n
                if n <= 0 or ex_s <= 0.0 or not (byts or flops):
                    continue
                gbps = byts / ex_s / 1e9
                if roof is None:
                    roof = _roofline.device_roofline()
                roofline_sigs.append({
                    "signature": sig,
                    "executes": n,
                    "execute_ms": round(ex_s * 1e3, 3),
                    "gflop_per_sec": round(flops / ex_s / 1e9, 3),
                    "gb_per_sec": round(gbps, 3),
                    "pct_of_roofline": round(
                        _roofline.pct_of_roofline(gbps), 2
                    ),
                })
                _roofline.observe_signature_gbps(gbps)
                total_bytes += byts
                total_exec_s += ex_s
        except Exception:
            traceback.print_exc()  # telemetry must never fail the query
        device_gbps = (
            round(total_bytes / total_exec_s / 1e9, 3)
            if total_exec_s > 0 and total_bytes > 0 else None
        )
        # exchange-throughput accounting: per-stage link transfer rates
        # from the tasks' per-producer {bytes, wall_ms, fetches} ledgers
        exchange_stages: list[dict] = []
        for sid in sorted(stage_links):
            links = stage_links[sid]
            tb = sum(ls["bytes"] for ls in links.values())
            tw = sum(ls["wall_ms"] for ls in links.values())
            exchange_stages.append({
                "stage_id": sid,
                "bytes": tb,
                "wall_ms": round(tw, 3),
                "fetches": sum(ls["fetches"] for ls in links.values()),
                "gb_per_sec": (
                    round(tb / (tw / 1e3) / 1e9, 3) if tw > 0 and tb
                    else None
                ),
                "links": {u: dict(ls) for u, ls in sorted(links.items())},
            })
        record["query_info"] = {
            "query_id": sm.query_id,
            "stages": stages,
            "stage_count": len(stages),
            "cpu_ms": round(cpu_ms, 3),
            "peak_memory_bytes": peak_mem,
            "memory_blocked_ms": round(mem_blocked_ms, 3),
            "memory_revocations": mem_revocations,
            "compile_ms": round(compile_ms, 3),
            "exchange_wait_ms": round(exchange_wait_ms, 3),
            "spill_ms": round(spill_ms, 3),
            "compile_signatures": compile_sigs,
            "fallback_executions": fallback_execs,
            "fallback_reasons": fallback_reasons,
            # observatory plane: query-wide achieved device bandwidth
            # (rides into history for BANDWIDTH_REGRESSION baselines),
            # per-signature roofline attribution, per-stage exchange rates
            "device_gb_per_sec": device_gbps,
            "roofline": (
                {"device": roof, "signatures": roofline_sigs}
                if roofline_sigs else None
            ),
            "exchange": exchange_stages,
            "wall_ms": round((time.perf_counter() - t_query0) * 1e3, 3),
            "output_rows": len(record["result"] or []),
            "task_retries": record.get("task_retries", 0),
            "task_heals": record.get("task_heals", 0),
            "trace_id": record.get("trace_id", ""),
            "workers": self.failure_detector.snapshot(),
        }
        if record.get("split_stats"):
            # split-plane provenance: rides QueryInfo into history and the
            # EXPLAIN ANALYZE "-- splits:" footer (runtime/engine.py)
            ss = dict(record["split_stats"])
            ss["pad_rows"] = int(
                1
                << max(
                    0,
                    (int(self.session.get("split_target_rows") or 65536) - 1)
                    .bit_length(),
                )
            )
            record["query_info"]["splits"] = ss
        if record.get("resumed"):
            # crash-recovery provenance: rides QueryInfo into history and
            # the EXPLAIN ANALYZE "recovery" footer (runtime/engine.py)
            record["query_info"]["recovery"] = {
                "resumed": True,
                "stages_resumed": record.get("stages_resumed", 0),
                "parts_resumed": record.get("parts_resumed", 0),
                "journal_replay_ms": float(
                    record.get("journal_replay_ms") or 0.0
                ),
            }
        if record.get("adopted_from"):
            # fleet provenance: which dead peer this query was adopted
            # from — rides QueryInfo into history and the EXPLAIN ANALYZE
            # "-- fleet:" footer (runtime/engine.py)
            record["query_info"]["fleet"] = {
                "adopted": True,
                "adopted_from": record.get("adopted_from"),
                "coordinator_id": (
                    self.fleet.coordinator_id if self.fleet else ""
                ),
                "stages_resumed": record.get("stages_resumed", 0),
                "parts_resumed": record.get("parts_resumed", 0),
            }
        # the phase ledger rides QueryInfo (reference: QueryStats planning/
        # execution/queued durations on GET /v1/query/{id}) and the EXPLAIN
        # ANALYZE footer; final state durations are refreshed at history time
        record["query_info"]["phase_ledger"] = self._phase_ledger(record)

    def _task_info(self, worker_url: str, task_id: str) -> dict:
        """Full task-status JSON (state + stats); {} when unreachable."""
        try:
            with urllib.request.urlopen(
                f"{worker_url}/v1/task/{task_id}/status", timeout=5
            ) as r:
                return json.loads(r.read())
        except Exception:
            return {}

    # --------------------------------------------- spooled client protocol
    _SPOOL_SEGMENT_ROWS = 65536

    def _spool_result(self, qid: str, record: dict) -> None:
        """Write finished result rows as on-disk segments and drop them from
        coordinator RAM (reference: server/protocol/spooling — segments via
        the SpoolingManager SPI; clients fetch them out-of-band)."""
        import os

        d = self.session.get("client_spool_dir")
        os.makedirs(d, exist_ok=True)
        rows = record["result"] or []
        segs = []
        for i in range(0, max(len(rows), 1), self._SPOOL_SEGMENT_ROWS):
            chunk = rows[i: i + self._SPOOL_SEGMENT_ROWS]
            path = os.path.join(d, f"{qid}_seg{len(segs)}.json")
            with open(path, "w") as f:
                json.dump([list(r) for r in chunk], f, default=_json_default)
            segs.append({"path": path, "count": len(chunk)})
        record["segments"] = segs
        record["result"] = []  # rows live on disk, not in RAM

    def read_spooled_segment(self, qid: str, idx: int) -> Optional[bytes]:
        record = self.queries.get(qid)
        if record is None or not record.get("segments"):
            return None
        segs = record["segments"]
        if not 0 <= idx < len(segs):
            return None
        try:
            with open(segs[idx]["path"], "rb") as f:
                return f.read()
        except OSError:
            return None

    def remove_spooled_result(self, qid: str) -> None:
        """Server-side GC: drop any un-acked segment files for a query (a
        crashed client never sends the acks)."""
        import os

        record = self.queries.get(qid)
        for seg in (record or {}).get("segments") or []:
            try:
                os.unlink(seg["path"])
            except OSError:
                pass

    def ack_spooled_segment(self, qid: str, idx: int) -> bool:
        """Client acknowledges a fetched segment: its file is deleted
        (reference: spooling segment ack releasing storage)."""
        import os

        record = self.queries.get(qid)
        if record is None or not record.get("segments"):
            return False
        segs = record["segments"]
        if not 0 <= idx < len(segs):
            return False
        try:
            os.unlink(segs[idx]["path"])
        except OSError:
            pass
        return True

    def _run_stage_phased(
        self,
        payload_base: dict,
        nparts: int,
        tag: str,
        max_attempts: int = 3,
        posted: Optional[list] = None,
        refresh_sources=None,
        should_abort=None,
        on_retry=None,
        precommitted: Optional[dict[int, str]] = None,
        on_part_done=None,
        split_sched: Optional[SplitScheduler] = None,
        on_task_failed=None,
        on_progress=None,
    ) -> list[tuple[str, str]]:
        """Post one stage's tasks, poll statuses, and re-schedule individual
        failures onto other alive workers (task-level recovery).  Every
        posted (worker, task_id) is appended to `posted` so cleanup covers
        failed stages too.  refresh_sources() is called before each
        re-schedule: it heals dead SOURCE producers and returns the updated
        sources payload, so a retry doesn't re-fetch from a dead URL.
        should_abort() is checked between poll rounds: a non-None message
        aborts the stage mid-flight (cluster memory kill, client cancel) —
        without it a cancellation would only be seen at stage boundaries.

        Straggler speculation (session speculation_enabled; reference: the
        MapReduce backup-task idea, Dean & Ghemawat OSDI'04): once at least
        half the stage's parts completed, a part still running past
        speculation_quantile x the stage's median completed wall time gets
        ONE backup attempt on another dispatchable worker.  The backup
        reuses the SAME task id (consumers address whichever copy wins; the
        spooled exchange's first-commit-wins rename arbitrates exactly-once
        on disk) with a distinct `attempt` label for its staging dir.  The
        first FINISHED attempt wins; the loser is aborted via DELETE."""
        workers = self._steer_by_links(self.alive_workers())
        if not workers:
            raise RuntimeError("no alive workers")
        urls: list[Optional[tuple[str, str]]] = [None] * nparts
        attempts = [0] * nparts
        # live attempts per part — usually one; speculation adds a backup
        pending: dict[int, list[tuple[str, str]]] = {}
        started: dict[int, float] = {}
        durations: list[float] = []  # completed-part wall seconds
        speculated: set[int] = set()  # one backup per part, ever
        backup_worker: dict[int, str] = {}  # part -> backup attempt's worker
        spec_enabled = (
            bool(self.session.get("speculation_enabled"))
            and nparts > 1
            # split stages speculate via the scheduler's work-stealing
            # instead (same first-commit-wins arbitration, load-aware)
            and split_sched is None
        )
        spec_quantile = float(self.session.get("speculation_quantile") or 2.0)
        # shorter long-poll rounds when speculating or lazily assigning
        # splits: detection/assignment latency is one poll round
        poll_wait = 1.0 if (spec_enabled or split_sched is not None) else 5.0

        def try_post(p: int, w: str, task_id: str, payload=None) -> bool:
            if posted is not None:
                posted.append((w, task_id))
            try:
                self._post_task(
                    w, dict(payload or payload_base, task_id=task_id, part=p)
                )
                return True
            except Exception:
                return False  # dead/unreachable worker: reschedule below

        def _dispatchable() -> list[str]:
            alive = self.alive_workers()
            d = [w for w in alive if self.failure_detector.is_dispatchable(w)]
            # link matrix steering: among dispatchable workers, prefer the
            # ones no impaired (SUSPECT/DEAD) exchange link touches
            return self._steer_by_links(d or alive)

        def _assign_splits() -> None:
            # lazy split assignment: drain the scheduler's pool onto
            # workers with free queue slots (bounded per-worker queues);
            # splits past every queue wait coordinator-side — that backlog
            # is the admission-shedding input (runtime/splits.py)
            for p, w in split_sched.assign(_dispatchable()):
                task_id = f"{tag}_p{p}_t{attempts[p]}"
                try_post(p, w, task_id)
                pending[p] = [(w, task_id)]
                started[p] = time.monotonic()

        for p in range(nparts):
            if precommitted and p in precommitted:
                # crash recovery: a pre-crash attempt of this part already
                # COMMITTED its output to the spool — consumers re-read it
                # (SPOOL_URL source) and nothing is posted, the resume
                # contract's "committed work is never recomputed"
                urls[p] = (SPOOL_URL, precommitted[p])
                if split_sched is not None:
                    split_sched.precommitted(p)
                continue
            if split_sched is not None:
                split_sched.add(p)  # enumerated; posted when a slot frees
                continue
            w = workers[p % len(workers)]
            task_id = f"{tag}_p{p}_t0"
            try_post(p, w, task_id)
            pending[p] = [(w, task_id)]
            started[p] = time.monotonic()
        while pending or (split_sched is not None and split_sched.backlog()):
            if self._killed:
                raise RuntimeError("coordinator killed")
            if should_abort is not None:
                msg = should_abort()
                if msg:
                    raise RuntimeError(msg)
            if split_sched is not None:
                _assign_splits()
                if not pending:
                    # every candidate worker is parked or full and nothing
                    # is in flight: wait out the park instead of spinning
                    time.sleep(0.05)
                    continue
            polls = [
                (p, u, t) for p, atts in pending.items() for (u, t) in atts
            ]
            with ThreadPoolExecutor(max_workers=max(len(polls), 1)) as pool:
                futs = {
                    key: pool.submit(self._task_status, key[1], key[2], poll_wait)
                    for key in polls
                }
            states = {key: fut.result() for key, fut in futs.items()}
            for p in list(pending):
                atts = pending[p]
                finished = [
                    a for a in atts if states.get((p,) + a) == "FINISHED"
                ]
                if finished:
                    winner = finished[0]
                    urls[p] = winner
                    if on_part_done is not None:
                        on_part_done(p, winner[1])
                    if on_progress is not None:
                        on_progress(p, winner)
                    durations.append(time.monotonic() - started[p])
                    for a in atts:  # abort the speculation loser
                        if a != winner:
                            self._delete_task_quiet(*a)
                    bw = backup_worker.pop(p, None)
                    if bw is not None:
                        self._m_speculative.labels(
                            "won" if winner[0] == bw else "lost"
                        ).inc()
                    del pending[p]
                    if split_sched is not None:
                        split_sched.on_done(p)  # frees a queue slot
                    continue
                still = []
                for a in atts:
                    st = states.get((p,) + a)
                    if st in ("FAILED", "UNKNOWN", "UNREACHABLE"):
                        if st == "UNREACHABLE":
                            # feed the circuit breaker so repeated
                            # unreachability quarantines the worker out of
                            # the dispatch pool
                            self.failure_detector.record_failure(a[0])
                    else:
                        still.append(a)
                if still:
                    pending[p] = still
                    if (
                        spec_enabled
                        and len(still) == 1
                        and p not in speculated
                        and len(durations) >= max(1, nparts // 2)
                    ):
                        median = sorted(durations)[len(durations) // 2]
                        elapsed = time.monotonic() - started[p]
                        if elapsed > max(0.25, spec_quantile * median):
                            u0, tid = still[0]
                            cands = [
                                w
                                for w in self.alive_workers()
                                if w != u0
                                and self.failure_detector.is_dispatchable(w)
                            ]
                            if cands:
                                speculated.add(p)
                                w = cands[(p + 1) % len(cands)]
                                if try_post(
                                    p, w, tid,
                                    dict(
                                        payload_base,
                                        attempt=f"s{attempts[p] + 1}",
                                    ),
                                ):
                                    self._m_speculative.labels("launched").inc()
                                    _fr.record(
                                        "task_speculate", node=self.url,
                                        query_id=payload_base.get("query_id"),
                                        task_id=tid, backup_worker=w,
                                        original_worker=u0,
                                    )
                                    backup_worker[p] = w
                                    pending[p] = still + [(w, tid)]
                    continue
                # every live attempt of this part ended badly: task retry
                if on_task_failed is not None:
                    # self-healing spool hook: a failure naming a lost
                    # producer partition reproduces the producer BEFORE
                    # this part's retry posts (coordinator _run_once)
                    for a in atts:
                        try:
                            on_task_failed(*a)
                        except Exception:
                            traceback.print_exc()
                attempts[p] += 1
                backup_worker.pop(p, None)
                if attempts[p] >= max_attempts:
                    _fr.record(
                        "task_failed", node=self.url,
                        query_id=payload_base.get("query_id"),
                        task_id=atts[0][1], attempts=attempts[p],
                        worker=atts[-1][0],
                    )
                    raise RuntimeError(
                        f"task {atts[0][1]} failed {attempts[p]} times"
                    )
                self._m_retries.inc()
                _fr.record(
                    "task_retry", node=self.url,
                    query_id=payload_base.get("query_id"),
                    task_id=atts[0][1], attempt=attempts[p],
                    failed_worker=atts[-1][0],
                )
                if on_retry is not None:
                    on_retry()
                bad_url = atts[-1][0]
                alive = [
                    w
                    for w in self.alive_workers()
                    if w != bad_url and self.failure_detector.is_dispatchable(w)
                ]
                if not alive:
                    alive = [w for w in self.alive_workers() if w != bad_url]
                if not alive:
                    alive = self.alive_workers()
                if not alive:
                    raise RuntimeError("no alive workers for re-schedule")
                # a retry caused by a partitioned link must not land back
                # on a worker the matrix still shows behind a broken link
                alive = self._steer_by_links(alive)
                if refresh_sources is not None:
                    payload_base = dict(
                        payload_base, sources=refresh_sources()
                    )
                if split_sched is not None:
                    # per-split retry: ONLY this morsel re-runs, on the
                    # least-loaded unparked worker (committed siblings are
                    # never touched — the spool holds their output)
                    w = (
                        split_sched.retry(p, alive, exclude=bad_url)
                        or alive[(p + attempts[p]) % len(alive)]
                    )
                else:
                    w = alive[(p + attempts[p]) % len(alive)]
                task_id = f"{tag}_p{p}_t{attempts[p]}"
                payload_p = payload_base
                if payload_base.get("memory_budget_bytes"):
                    # the failure may have been a memory-budget refusal:
                    # THIS part re-runs with a 4x-per-attempt estimate,
                    # NOT identically (reference: ExponentialGrowth
                    # PartitionMemoryEstimator).  Scoped per part — a
                    # shared compounding budget would evaporate the
                    # limit after unrelated worker-death retries
                    payload_p = dict(
                        payload_base,
                        memory_budget_bytes=(
                            payload_base["memory_budget_bytes"]
                            * 4 ** attempts[p]
                        ),
                    )
                try_post(p, w, task_id, payload_p)
                pending[p] = [(w, task_id)]
                started[p] = time.monotonic()
            if split_sched is not None and pending and durations:
                # straggler work-stealing: once the pool is dry and a
                # worker sits idle, a single-attempt split lagging past the
                # speculation quantile is duplicated onto the idle worker —
                # same task id, so the spooled exchange's first-commit-wins
                # rename (or the winner pick above) arbitrates exactly-once
                median = sorted(durations)[len(durations) // 2]
                lagging = {
                    lp
                    for lp, atts2 in pending.items()
                    if len(atts2) == 1
                    and time.monotonic() - started[lp]
                    > max(0.25, spec_quantile * median)
                }
                if lagging:
                    st = split_sched.steal(_dispatchable(), lagging)
                    if st is not None:
                        p, w = st
                        tid = pending[p][0][1]
                        if try_post(
                            p, w, tid,
                            dict(
                                payload_base,
                                attempt=f"st{attempts[p] + 1}",
                            ),
                        ):
                            pending[p].append((w, tid))
                        else:
                            split_sched.steal_abort(p, w)
        return urls  # type: ignore[return-value]

    def _delete_task_quiet(self, url: str, task_id: str) -> None:
        """Abort one task attempt (speculation loser) — DELETE frees its
        buffers and flips its canceled flag; best-effort."""
        if url == SPOOL_URL:
            return
        try:
            req = urllib.request.Request(
                f"{url}/v1/task/{task_id}", method="DELETE"
            )
            with urllib.request.urlopen(req, timeout=5) as r:
                r.read()
        except Exception:
            pass

    def _worker_alive(self, url: str, timeout: float = 3.0) -> bool:
        try:
            with urllib.request.urlopen(f"{url}/v1/info", timeout=timeout) as r:
                r.read()
            return True
        except Exception:
            return False

    def _wait_task(self, worker_url: str, task_id: str, timeout: float = 600.0) -> str:
        """Poll a task to a terminal state (long-poll increments of 5s)."""
        import time as _time

        deadline = _time.monotonic() + timeout
        while _time.monotonic() < deadline:
            state = self._task_status(worker_url, task_id, 5.0)
            if state in ("FINISHED", "FAILED", "UNKNOWN", "UNREACHABLE"):
                return state
        return "TIMEOUT"

    def _task_status(self, worker_url: str, task_id: str, wait: float) -> str:
        # transient poll errors retry through a short Backoff before the
        # caller sees UNREACHABLE (reference: ContinuousTaskStatusFetcher
        # retries through Backoff before failRemotely)
        backoff = Backoff(min_delay=0.05, max_delay=0.5, max_elapsed=2.0)
        while True:
            try:
                with urllib.request.urlopen(
                    f"{worker_url}/v1/task/{task_id}/status?wait={wait}",
                    timeout=wait + 10,
                ) as r:
                    return json.loads(r.read()).get("state", "UNKNOWN")
            except Exception:
                if backoff.failure():
                    return "UNREACHABLE"
                backoff.sleep()

    def _failure_detail(self, all_tasks, base_exc: Exception) -> str:
        """Sweep task statuses for the root cause of a fetch failure."""
        for (u, t) in all_tasks:
            try:
                with urllib.request.urlopen(
                    f"{u}/v1/task/{t}/status", timeout=5
                ) as r:
                    st = json.loads(r.read())
                if st.get("state") == "FAILED":
                    return f"task {t} failed on {u}: {st.get('error')}"
            except Exception:
                continue
        return str(base_exc)

    def _cleanup_tasks(self, all_tasks) -> None:
        for (u, t) in all_tasks:
            if u == SPOOL_URL:
                continue
            try:
                req = urllib.request.Request(f"{u}/v1/task/{t}", method="DELETE")
                with urllib.request.urlopen(req, timeout=5) as r:
                    r.read()
            except Exception:
                pass

    def _sources_payload(self, f: Fragment, frag_by_id, task_urls) -> dict:
        out = {}
        for child_id in f.inputs:
            child = frag_by_id[child_id]
            out[str(child_id)] = {
                "kind": child.output_kind,
                "tasks": task_urls[child_id],
                "types": [t.name for t in child.root.output_types],
            }
        return out

    def _post_task(self, worker_url: str, payload: dict) -> None:
        self._m_dispatched.inc()
        _fr.record(
            "task_dispatch", node=self.url,
            query_id=payload.get("query_id"),
            task_id=payload.get("task_id"), worker=worker_url,
            part=payload.get("part"), attempt=payload.get("attempt"),
        )
        body = json.dumps(payload).encode()
        headers = {"Content-Type": "application/json"}
        if payload.get("deadline_ts"):
            # deadline coherence: the header mirrors the payload field so
            # every hop (including proxies that only see headers) can
            # compute remaining budget the same way
            headers["X-Trino-Deadline"] = f"{payload['deadline_ts']:.3f}"
        req = urllib.request.Request(
            f"{worker_url}/v1/task/{payload['task_id']}",
            data=body,
            headers=headers,
        )
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                r.read()
        except urllib.error.HTTPError as e:
            detail = e.read().decode(errors="replace")
            raise RuntimeError(
                f"task {payload['task_id']} rejected by {worker_url}: {detail}"
            )


# --------------------------------------------------- statement surface shim


def _statement_surface(coord: "Coordinator"):
    from .engine import Engine

    # one persistent surface per coordinator: prepared statements and
    # transaction snapshots must survive across statements (reference: the
    # session holds prepared statements / the TransactionManager holds txns).
    # Guarded by the coordinator lock: handler threads race on first use.

    class _StatementSurface(Engine):
        """The Engine statement executor with its two query primitives
        rebound to the multi-host scheduler: `query` runs the SELECT
        distributed, and `_query_columns` rebuilds host columns (with
        validity) from the distributed result rows for the write path.

        Engine.__init__ runs (every attribute the port's statement path
        reads exists: device, budget, fast path, spill state), then the
        coordinator's catalogs, planner and session replace the engine's
        own.  Its local executor, on the coordinator's device, serves only
        what the statement path runs in this process (EXECUTE's fast path);
        queries go to the workers."""

        def __init__(self):
            super().__init__(coord.default_catalog, device=coord.device)
            self._coord = coord
            self.catalogs = coord.catalogs
            self.planner = coord.planner
            self.session = coord.session
            self.executor.catalogs = self._local_fallback.catalogs = coord.catalogs
            self.distributed = False  # plans stay whole: the coordinator distributes
            from .events import EventListenerManager

            self.events = EventListenerManager()
            self._query_seq = 0
            from ..utils.tracing import Tracer

            self.access_control = getattr(
                coord, "access_control", None
            ) or self.access_control
            self.tracer = Tracer()
            # write statements through this surface invalidate the
            # COORDINATOR's caches (cache_invalidate below), not only a
            # local engine's — same typed hooks as runtime/dml.py
            self.result_cache = coord.result_cache
            self.fragment_memo = coord.fragment_memo
            # write-transaction plane (runtime/txn.py): DML through this
            # surface journals intents/commit markers into the COORDINATOR
            # journal and honors its armed write faults; _run_inner stamps
            # _txn_local.query_id per statement so txn ids chain to the
            # journaled query
            self.txn_journal = coord.journal
            self.write_fault_injector = coord.fault_injector

        def cache_invalidate(self, name: str) -> None:
            super().cache_invalidate(name)
            try:
                _, catalog, table = self._target_ref(name)
            except KeyError:
                return
            table = table.split(".")[-1]
            if self.result_cache is not None:
                self.result_cache.invalidate_table(catalog, table)
            if self.fragment_memo is not None:
                self.fragment_memo.invalidate_table(catalog, table)

        def plan(self, sql_or_query):
            return optimize(self.planner.plan(sql_or_query), self.catalogs, self.session)

        def query(self, sql_or_query) -> list[tuple]:
            # unmanaged: the enclosing statement already holds the group slot
            return self._coord._execute_query_unmanaged(sql_or_query)

        def _explain_analyze_distributed(self, query):
            """Distributed EXPLAIN ANALYZE: run through the scheduler with
            per-task operator timing and return the coordinator QueryInfo.
            Raises — never silently degrades to a stats-less plan — when a
            stage comes back without operator stats."""
            record = self._coord._execute_unmanaged_record(query, analyze=True)
            info = record.get("query_info")
            if info is None:
                raise RuntimeError(
                    "distributed EXPLAIN ANALYZE produced no operator stats"
                )
            for st in info["stages"]:
                if not st.get("operators"):
                    raise RuntimeError(
                        f"stage {st['stage_id']} returned no operator stats"
                    )
            return info

        def _query_columns(self, query):
            plan = self.plan(query)
            rows = self.query(query)
            types = list(plan.output_types)
            return list(plan.output_names), types, _rows_to_columns(rows, types)

    with coord._lock:
        if getattr(coord, "_stmt_surface", None) is None:
            coord._stmt_surface = _StatementSurface()
        return coord._stmt_surface


def _rows_to_columns(rows: list[tuple], types: list):
    """Client-protocol rows (python values, None == NULL) -> host column
    arrays in lane representation (decimals re-scale to int64, dates to day
    counts), MaskedArray where NULLs are present."""
    import numpy as np

    from ..data.types import date_to_days

    out = []
    for i, t in enumerate(types):
        vals = [r[i] for r in rows]
        nulls = np.array([v is None for v in vals], dtype=bool)

        def lane(v):
            if v is None:
                return "" if t.is_string else 0
            if t.is_decimal:
                return int(round(v * (10 ** t.scale)))
            if t.name == "date" and isinstance(v, str):
                return date_to_days(v)
            return v

        arr = np.asarray(
            [lane(v) for v in vals], dtype=object if t.is_string else t.np_dtype
        )
        out.append(np.ma.MaskedArray(arr, mask=nulls) if nulls.any() else arr)
    return out


# ------------------------------------------------------------ HTTP protocol


def _make_handler(coord: Coordinator):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _send_json(self, code: int, obj, headers=None) -> None:
            body = json.dumps(obj, default=_json_default).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n)
            parts = self.path.strip("/").split("/")
            if parts[:2] == ["v1", "statement"]:
                # load shedding BEFORE resource-group admission (reference:
                # DispatchManager's queue bound answering TOO_MANY_REQUESTS):
                # a saturated coordinator degrades to client backpressure
                # (429 + Retry-After) instead of an ever-growing queue of
                # timeouts
                limit = int(coord.session.get("dispatch_queue_limit") or 0)
                if limit:
                    with coord._lock:
                        active = sum(
                            1 for r in coord.queries.values()
                            if not r["sm"].done
                        )
                    if active >= limit:
                        coord._m_shed.inc()
                        return self._send_json(
                            429,
                            {
                                "error": (
                                    f"coordinator dispatch queue full "
                                    f"({active} active >= limit {limit}); "
                                    f"retry later"
                                )
                            },
                            headers={"Retry-After": "1"},
                        )
                # split-plane backpressure: bounded per-worker split queues
                # push back here — when the coordinator-held backlog runs a
                # full extra round past what the fleet can queue, new
                # statements shed instead of piling splits behind a stalled
                # cluster (runtime/splits.py current_backlog)
                if bool(coord.session.get("split_driven_scans")):
                    depth = int(coord.session.get("split_queue_depth") or 2)
                    bound = max(1, len(coord.workers)) * depth * 8
                    backlog = current_backlog()
                    if backlog > bound:
                        coord._m_shed.inc()
                        return self._send_json(
                            429,
                            {
                                "error": (
                                    f"split backlog {backlog} exceeds the "
                                    f"fleet's queue capacity ({bound}); "
                                    f"retry later"
                                )
                            },
                            headers={"Retry-After": "1"},
                        )
                sql = body.decode()
                spooled = self.headers.get("X-Trino-Spooled") == "1"
                # client-held prepared registry (reference: Trino's
                # X-Trino-Prepared-Statement request header): each value is
                # "name=<urlencoded sql>", comma-separated when several ride
                # one header line; the header itself may also repeat
                prepared = None
                for hv in self.headers.get_all("X-Trino-Prepared-Statement") or ():
                    for item in hv.split(","):
                        name, sep, enc = item.strip().partition("=")
                        if not sep or not name:
                            continue
                        if prepared is None:
                            prepared = {}
                        prepared[unquote(name)] = unquote(enc)
                qid = coord.submit_query(
                    sql, spooled=spooled, prepared=prepared,
                    # router-minted id (fleet sharding); absent on direct
                    # client submits
                    query_id=self.headers.get("X-Trino-Query-Id") or None,
                )
                return self._send_json(
                    200,
                    {"id": qid, "nextUri": f"{coord.url}/v1/statement/{qid}/0"},
                )
            if (
                parts[:2] == ["v1", "query"] and len(parts) >= 4
                and parts[3] == "postmortem"
            ):
                # on-demand bundle: fan out and write NOW (works for live
                # and history-expired queries)
                out = coord.write_postmortem(parts[2], trigger="on_demand")
                if out is None:
                    return self._send_json(
                        404,
                        {"error": "unknown query or postmortem disabled"},
                    )
                return self._send_json(200, out)
            if parts[:2] == ["v1", "announce"]:
                req = json.loads(body)
                if req.get("event") == "goodbye":
                    # drained worker deregistering (graceful exit)
                    coord.deregister_worker(req["url"])
                else:
                    coord.register_worker(req["url"])
                return self._send_json(200, {})
            return self._send_json(404, {"error": "not found"})

        def do_DELETE(self):
            parts = self.path.strip("/").split("/")
            if parts[:2] == ["v1", "spooled"] and len(parts) >= 4:
                if not parts[3].isdigit():
                    return self._send_json(404, {"error": "no such segment"})
                ok = coord.ack_spooled_segment(parts[2], int(parts[3]))
                return self._send_json(200 if ok else 404, {"acked": ok})
            if parts[:2] == ["v1", "statement"] and len(parts) >= 3:
                ok = coord.cancel_query(parts[2])
                return self._send_json(200 if ok else 404, {"canceled": ok})
            return self._send_json(404, {"error": "not found"})

        def do_GET(self):
            from urllib.parse import parse_qs

            path, _, qs = self.path.partition("?")
            parts = path.strip("/").split("/")
            params = parse_qs(qs)
            if path in ("/ui", "/ui/", "/"):
                # minimal cluster/query dashboard (reference: core/trino-web-ui
                # React app + server/ui/ClusterStatsResource; here one
                # self-refreshing page over the same coordinator state)
                import html as _html

                now = time.time()

                def _age(sm: QueryStateMachine) -> str:
                    wall = (sm.finished_at or now) - sm.created_at
                    in_state = now - sm.state_changed_at
                    return (
                        f"<td>{wall:.1f}</td><td>{in_state:.1f}</td>"
                    )

                # both tables snapshot under the lock: workers and queries
                # mutate from the heartbeat/announce threads, and iterating
                # a mutating dict here raced (RuntimeError mid-render)
                def _progress_cell(rec) -> str:
                    # split/task completion fraction from the live
                    # progress ledger (GET /v1/query/{id}/progress)
                    if rec["sm"].done:
                        return "<td>100%</td>"
                    stages = (rec.get("progress") or {}).get("stages") or {}
                    total = sum(s["total"] for s in stages.values())
                    done = sum(s["completed"] for s in stages.values())
                    if not total:
                        return "<td>-</td>"
                    return f"<td>{100.0 * done / total:.0f}%</td>"

                def _anomaly_cell(src) -> str:
                    kinds = [
                        a.get("kind") for a in src.get("anomalies") or []
                        if isinstance(a, dict)
                    ]
                    return (
                        f"<td>{_html.escape(','.join(kinds))}</td>"
                        if kinds else "<td>-</td>"
                    )

                with coord._lock:
                    qrows = "".join(
                        f"<tr><td>{_html.escape(str(qid))}</td>"
                        f"<td>{_html.escape(rec['sm'].state)}</td>"
                        f"{_age(rec['sm'])}"
                        f"{_progress_cell(rec)}"
                        f"<td>{'hit' if rec.get('cached') else '-'}</td>"
                        f"{_anomaly_cell(rec)}"
                        f"<td>{_html.escape(str(rec.get('adopted_from') or '-'))}</td>"
                        f"<td><code>{_html.escape(str(rec.get('sql'))[:120])}</code></td></tr>"
                        for qid, rec in list(coord.queries.items())[-50:]
                    )
                    def _mem_cells(w) -> str:
                        # reserved/revocable bytes from the worker's last
                        # node-pool heartbeat snapshot; "-" = ungoverned
                        if not w.mem:
                            return "<td>-</td><td>-</td><td>-</td>"
                        revocable = sum(
                            int(q.get("revocable") or 0)
                            for q in (w.mem.get("by_query") or {}).values()
                        )
                        blocked = int(w.mem.get("blocked") or 0)
                        return (
                            f"<td>{int(w.mem.get('reserved') or 0)}"
                            f"/{int(w.mem.get('capacity') or 0)}</td>"
                            f"<td>{revocable}</td>"
                            f"<td>{blocked}</td>"
                        )

                    def _util_cells(w) -> str:
                        # residency from the last heartbeat (/v1/info);
                        # cpu rate from the node's time-series lane when
                        # it is locally visible (in-process clusters
                        # share the store; separate processes show "-")
                        rss = (
                            f"{int(w.rss_bytes) >> 20}"
                            f"/{int(w.peak_rss_bytes or 0) >> 20}"
                            if w.rss_bytes else "-"
                        )
                        lane = (
                            _ts.snapshot(nodes=[w.url], series=["cpu_s"])
                            .get(w.url) or {}
                        ).get("cpu_s") or []
                        cpu = (
                            f"{lane[-1][1] / (_ts.STORE.sample_interval_s or 1.0):.2f}"
                            if lane else "-"
                        )
                        return f"<td>{rss}</td><td>{cpu}</td>"

                    wrows = "".join(
                        f"<tr><td>{_html.escape(w.url)}</td>"
                        f"<td>{'alive' if w.alive else 'dead'}</td>"
                        f"<td>{now - w.last_seen:.1f}</td>"
                        f"{_mem_cells(w)}{_util_cells(w)}</tr>"
                        for w in list(coord.workers.values())
                    )
                    # link matrix rows: only impaired links are rendered —
                    # a fully healthy cluster shows an empty table
                    lrows = "".join(
                        f"<tr><td>{_html.escape(w.url)}</td>"
                        f"<td>{_html.escape(prod)}</td>"
                        f"<td>{_html.escape(str(cell.get('state')))}</td>"
                        f"<td>{cell.get('error_ewma')}</td>"
                        f"<td>{cell.get('latency_ewma_ms')}</td>"
                        f"<td>{cell.get('consecutive_failures')}</td></tr>"
                        for w in list(coord.workers.values())
                        for prod, cell in sorted((w.links or {}).items())
                        if cell.get("state") != "HEALTHY"
                    )
                    nworkers = len(coord.workers)
                    nqueries = len(coord.queries)
                # fleet membership table (lease files — own locking; render
                # outside coord._lock)
                fleet_html = ""
                if coord.fleet is not None:
                    finfo = coord.fleet.info()
                    frows = "".join(
                        f"<tr><td>{_html.escape(str(m.get('coordinator_id')))}</td>"
                        f"<td>{_html.escape(str(m.get('url')))}</td>"
                        f"<td>{m.get('epoch')}</td>"
                        f"<td>{'alive' if m.get('alive') else 'expired'}</td>"
                        f"<td>{m.get('live_queries')}</td>"
                        f"<td>{_html.escape(str(m.get('adopted_by') or '-'))}</td></tr>"
                        for m in finfo["members"]
                    )
                    fleet_html = (
                        f"<h3>fleet (this: {_html.escape(finfo['coordinator_id'])}"
                        f", epoch {finfo['epoch']}"
                        f"{', gc owner' if finfo['gc_owner'] else ''})</h3>"
                        "<table><tr><th>member</th><th>url</th><th>epoch</th>"
                        "<th>lease</th><th>live queries</th><th>adopted by</th>"
                        f"</tr>{frows}</table>"
                    )
                # history has its own lock — render outside coord._lock
                hrows = "".join(
                    f"<tr><td>{_html.escape(str(h.get('query_id')))}</td>"
                    f"<td>{_html.escape(str(h.get('state')))}</td>"
                    f"<td>{float(h.get('wall_s') or 0.0):.2f}</td>"
                    f"<td>{float((h.get('phase_ledger') or {}).get('compiling_ms') or 0.0):.0f}</td>"
                    f"<td>{'hit' if h.get('cached') else '-'}</td>"
                    f"{_anomaly_cell(h)}"
                    f"<td><code>{_html.escape(str(h.get('sql'))[:120])}</code></td></tr>"
                    for h in coord.history.list(limit=20)
                )
                body = (
                    "<!doctype html><html><head><meta charset='utf-8'>"
                    "<meta http-equiv='refresh' content='3'>"
                    "<title>trino_tpu</title><style>body{font-family:monospace;"
                    "margin:2em}table{border-collapse:collapse}td,th{border:1px "
                    "solid #999;padding:4px 8px}</style></head><body>"
                    "<h2>trino_tpu coordinator</h2>"
                    f"<h3>workers ({nworkers})</h3>"
                    "<table><tr><th>url</th><th>state</th><th>seen (s)</th>"
                    "<th>mem reserved/cap (B)</th><th>revocable (B)</th>"
                    "<th>blocked</th><th>rss/peak (MiB)</th>"
                    "<th>cpu (cores)</th>"
                    f"</tr>{wrows}</table>"
                    "<h3>impaired links</h3>"
                    "<table><tr><th>consumer</th><th>producer</th>"
                    "<th>grade</th><th>err ewma</th><th>lat ewma (ms)</th>"
                    "<th>consec fail</th>"
                    f"</tr>{lrows}</table>"
                    f"{fleet_html}"
                    f"<h3>queries ({nqueries})</h3>"
                    "<table><tr><th>id</th><th>state</th><th>wall (s)</th>"
                    "<th>in state (s)</th><th>progress</th><th>cache</th>"
                    "<th>anomalies</th><th>origin</th>"
                    "<th>sql</th></tr>"
                    f"{qrows}</table>"
                    f"<h3>history ({len(coord.history)})</h3>"
                    "<table><tr><th>id</th><th>state</th><th>wall (s)</th>"
                    "<th>compile (ms)</th><th>cache</th><th>anomalies</th>"
                    "<th>sql</th></tr>"
                    f"{hrows}</table></body></html>"
                ).encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if parts[:1] == ["metrics"]:
                body = coord.metrics_text().encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if parts[:2] == ["v1", "info"]:
                info = {
                    "workers": [
                        {"url": w.url, "alive": w.alive}
                        for w in coord.workers.values()
                    ],
                    "queries": len(coord.queries),
                    "resource_groups": coord.resource_groups.stats(),
                    # cluster link matrix: consumer -> producer -> grade
                    # cell; read alongside workers[].alive to tell "B is
                    # down" from "only the A->B link is partitioned"
                    "links": coord.link_matrix(),
                }
                if coord.fleet is not None:
                    info["fleet"] = coord.fleet.info()
                return self._send_json(200, info)
            if parts[:2] == ["v1", "query"] and len(parts) == 2:
                # query listing, live table overlaid on the bounded history
                # (reference: server QueryResource GET /v1/query with its
                # state filter); ?state=FINISHED&limit=50
                state = (params.get("state") or [None])[0]
                try:
                    limit = int((params.get("limit") or ["50"])[0])
                except ValueError:
                    limit = 50
                with coord._lock:
                    live = [
                        {
                            "query_id": qid,
                            "state": rec["sm"].state,
                            "sql": str(rec.get("sql"))[:200],
                            "created_ts": rec["sm"].created_at,
                            "wall_s": round(
                                (rec["sm"].finished_at or time.time())
                                - rec["sm"].created_at, 3
                            ),
                            "error": rec["sm"].error,
                            "source": "live",
                        }
                        for qid, rec in coord.queries.items()
                    ]
                seen = {q["query_id"] for q in live}
                rows = [
                    dict(
                        {k: h.get(k) for k in (
                            "query_id", "state", "sql", "created_ts",
                            "wall_s", "error",
                        )},
                        source="history",
                    )
                    for h in coord.history.list(limit=coord.history.capacity)
                    if h.get("query_id") not in seen
                ] + live
                if state:
                    want = state.upper()
                    rows = [
                        q for q in rows
                        if str(q.get("state", "")).upper() == want
                    ]
                rows.sort(key=lambda q: q.get("created_ts") or 0.0,
                          reverse=True)
                return self._send_json(200, {"queries": rows[:max(0, limit)]})
            if parts[:2] == ["v1", "query"] and len(parts) == 3:
                # QueryInfo: stages, tasks, operator stats, retry counters
                # (reference: server QueryResource GET /v1/query/{queryId}).
                # The response dict is assembled UNDER the lock (cheap dict
                # copies) and serialized OUTSIDE it — a slow client reading
                # the body must never stall the heartbeat sweep.
                info = None
                with coord._lock:
                    record = coord.queries.get(parts[2])
                    if record is not None:
                        info = dict(record.get("query_info") or {})
                        info.update(
                            {
                                "query_id": parts[2],
                                "state": record["sm"].state,
                                "error": record["sm"].error,
                                "task_retries": record.get("task_retries", 0),
                                "task_heals": record.get("task_heals", 0),
                                "stage_times": dict(
                                    record.get("stage_times") or {}
                                ),
                                # sentinel verdict + live progress: deep-
                                # copied under the lock like every other
                                # mutable field here (the scheduler thread
                                # mutates progress stages mid-request)
                                "anomalies": [
                                    dict(a)
                                    for a in record.get("anomalies") or []
                                ],
                                "progress": {
                                    str(fid): dict(st)
                                    for fid, st in (
                                        (record.get("progress") or {})
                                        .get("stages") or {}
                                    ).items()
                                },
                            }
                        )
                        if record.get("postmortem_path"):
                            info["postmortem"] = (
                                f"{coord.url}/v1/query/{parts[2]}/postmortem"
                            )
                if info is None:
                    # expired from the live table: serve the history record
                    # instead of 404ing (reference: QueryResource keeps
                    # answering for min-expire-age after completion)
                    hist = coord.history.get(parts[2])
                    if hist is None:
                        return self._send_json(404, {"error": "unknown query"})
                    info = dict(hist, expired=True)
                return self._send_json(200, info)
            if parts == ["v1", "timeseries"]:
                # federated cluster view: this process's lanes plus every
                # alive worker's own lane (per-node attribution survives
                # both in-process and separate-process deployments)
                try:
                    since = float((params.get("since") or [None])[0])
                except (TypeError, ValueError):
                    since = None
                names = [
                    s for s in
                    ((params.get("series") or [""])[0]).split(",") if s
                ] or None
                return self._send_json(
                    200,
                    {"node": coord.url, "stats": _ts.stats(),
                     "nodes": coord._federated_timeseries(
                         since=since, series=names)},
                )
            if parts == ["v1", "flightrecorder"]:
                # the coordinator is the collector: serve EVERY lane in
                # this process's ring (in-process clusters share it; the
                # post-mortem fan-out dedups by (node, seq))
                events = _fr.snapshot(
                    query_id=(params.get("query_id") or [None])[0],
                )
                return self._send_json(
                    200,
                    {"node": coord.url, "stats": _fr.stats(),
                     "events": events},
                )
            if (
                parts[:2] == ["v1", "query"] and len(parts) >= 4
                and parts[3] == "progress"
            ):
                prog = coord.query_progress(parts[2])
                if prog is None:
                    return self._send_json(404, {"error": "unknown query"})
                return self._send_json(200, prog)
            if (
                parts[:2] == ["v1", "query"] and len(parts) >= 4
                and parts[3] == "postmortem"
            ):
                # serve the raw bundle JSONL — the path derives from the
                # configured spool dir, so a restarted coordinator keeps
                # answering for pre-crash bundles
                with coord._lock:
                    record = coord.queries.get(parts[2])
                    ppath = (record or {}).get("postmortem_path")
                ppath = ppath or coord.postmortem_path(parts[2])
                try:
                    with open(ppath, "rb") as f:
                        blob = f.read()
                except OSError:
                    return self._send_json(
                        404, {"error": "no postmortem bundle for this query"}
                    )
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Content-Length", str(len(blob)))
                self.end_headers()
                self.wfile.write(blob)
                return
            if parts[:2] == ["v1", "query"] and len(parts) >= 4 and parts[3] == "state":
                # cheap state probe: never serializes result rows
                with coord._lock:
                    record = coord.queries.get(parts[2])
                if record is None:
                    return self._send_json(404, {"error": "unknown query"})
                return self._send_json(
                    200, {"id": parts[2], "state": record["sm"].state}
                )
            if parts[:2] == ["v1", "statement"] and len(parts) >= 4:
                qid = parts[2]
                with coord._lock:
                    record = coord.queries.get(qid)
                if record is None:
                    return self._send_json(404, {"error": "unknown query"})
                sm: QueryStateMachine = record["sm"]
                if record.get("resume_refused"):
                    # resume_policy=FAIL: a poll for a pre-restart query id
                    # gets a typed 410 GONE instead of a silent 404, so a
                    # re-attaching client surfaces COORDINATOR_RESTART
                    # rather than retrying forever
                    return self._send_json(
                        410,
                        {"error": sm.error, "errorCode": sm.error_code},
                    )
                if not sm.done:
                    return self._send_json(
                        200,
                        {
                            "id": qid,
                            "stats": {"state": sm.state},
                            "nextUri": f"{coord.url}/v1/statement/{qid}/0",
                        },
                    )
                if sm.state == "FAILED":
                    return self._send_json(
                        200,
                        {
                            "id": qid,
                            "stats": {"state": "FAILED"},
                            "error": sm.error,
                            # typed reason (EXCEEDED_TIME_LIMIT, ...) for
                            # clients that branch on failure class
                            "errorCode": sm.error_code,
                        },
                    )
                if record.get("segments") is not None:
                    return self._send_json(
                        200,
                        {
                            "id": qid,
                            "stats": {"state": sm.state},
                            "columns": record["columns"],
                            "segments": [
                                {
                                    "uri": f"{coord.url}/v1/spooled/{qid}/{i}",
                                    "count": seg["count"],
                                }
                                for i, seg in enumerate(record["segments"])
                            ],
                        },
                    )
                final = {
                    "id": qid,
                    "stats": {"state": sm.state},
                    "columns": record["columns"],
                    "data": [list(r) for r in record["result"]],
                }
                # prepared-registry deltas ride the terminal response so the
                # client can mirror server-side PREPARE / DEALLOCATE into the
                # registry it replays on subsequent requests
                for k in ("addedPrepare", "deallocatedPrepare"):
                    if record.get(k):
                        final[k] = record[k]
                return self._send_json(200, final)
            if parts[:2] == ["v1", "spooled"] and len(parts) >= 4:
                if not parts[3].isdigit():
                    return self._send_json(404, {"error": "no such segment"})
                blob = coord.read_spooled_segment(parts[2], int(parts[3]))
                if blob is None:
                    return self._send_json(404, {"error": "no such segment"})
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(blob)))
                self.end_headers()
                self.wfile.write(blob)
                return
            return self._send_json(404, {"error": "not found"})

    return Handler
