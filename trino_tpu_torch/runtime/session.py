"""Session properties — the runtime flag system.

The reference exposes 157 session properties (SystemSessionProperties.java)
settable per-query via SET SESSION / wire headers, validated and typed, on
top of 396 static @Config settings.  This is the same shape: typed,
validated properties with defaults; engine components read them at plan /
execution time.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

__all__ = ["SessionProperties", "PROPERTIES"]


@dataclass(frozen=True)
class _Prop:
    name: str
    type: type
    default: Any
    description: str
    validate: Optional[Callable[[Any], bool]] = None


PROPERTIES: dict[str, _Prop] = {
    p.name: p
    for p in [
        _Prop(
            "join_distribution_type", str, "AUTOMATIC",
            "AUTOMATIC | PARTITIONED | BROADCAST (reference: "
            "DetermineJoinDistributionType.java:51)",
            lambda v: v in ("AUTOMATIC", "PARTITIONED", "BROADCAST"),
        ),
        _Prop(
            "broadcast_join_row_limit", int, 100_000,
            "estimated build rows at or below which AUTOMATIC picks broadcast",
            lambda v: v > 0,
        ),
        _Prop(
            "group_by_segment_limit", int, 65536,
            "initial capacity tier for group-by outputs",
            lambda v: v >= 1,
        ),
        _Prop(
            "query_max_run_time_s", float, 3600.0,
            "wall-clock limit from query creation; the coordinator's "
            "deadline watchdog kills the query with a typed "
            "EXCEEDED_TIME_LIMIT reason once exceeded (reference: "
            "QueryTracker.enforceTimeLimits + query_max_run_time)",
            lambda v: v > 0,
        ),
        _Prop(
            "query_max_queued_time_s", float, 600.0,
            "max time a query may sit QUEUED in its resource group before "
            "the deadline watchdog kills it with a typed "
            "EXCEEDED_QUEUED_TIME_LIMIT reason (reference: "
            "query_max_queued_time); load sheds before it cascades",
            lambda v: v > 0,
        ),
        _Prop(
            "task_no_progress_timeout_s", float, 300.0,
            "worker-side no-progress watchdog: a RUNNING task whose "
            "progress beats (source fetch, execution milestones) freeze "
            "for this long is failed — and, under retry_policy=TASK, "
            "re-scheduled — instead of wedging its consumer for the full "
            "status-poll ceiling; 0 disables",
            lambda v: v >= 0,
        ),
        _Prop(
            "speculation_enabled", bool, False,
            "straggler speculation under retry_policy=TASK: tasks running "
            "past speculation_quantile x the stage's median completed "
            "wall time get a backup attempt on another worker; first "
            "FINISHED attempt wins, the loser is aborted (reference: the "
            "MapReduce backup-task idea, Dean & Ghemawat OSDI'04)",
            None,
        ),
        _Prop(
            "speculation_quantile", float, 2.0,
            "straggler threshold: elapsed > quantile x stage-median wall "
            "of completed sibling tasks triggers a backup attempt",
            lambda v: v >= 1.0,
        ),
        _Prop(
            "write_conflict_retries", int, 2,
            "recompute-and-retry budget when a DML statement loses the "
            "commit-point snapshot CAS to a concurrent writer; past the "
            "budget the statement fails typed WRITE_CONFLICT "
            "(runtime/txn.py)",
            lambda v: v >= 0,
        ),
        _Prop(
            "write_staging_grace_s", float, 10.0,
            "janitor grace: staged write data older than this with no "
            "live owning query is aborted and its bytes reclaimed by the "
            "heartbeat sweep (orphaned staging from crashed writers)",
            lambda v: v > 0,
        ),
        _Prop(
            "dispatch_queue_limit", int, 0,
            "coordinator load shedding: POST /v1/statement answers 429 + "
            "Retry-After when this many queries are already queued or "
            "running (checked BEFORE resource-group admission, so "
            "overload degrades to backpressure instead of timeouts); "
            "0 = unbounded",
            lambda v: v >= 0,
        ),
        _Prop(
            "retry_policy", str, "NONE",
            "NONE | QUERY | TASK — QUERY retries the whole query once; TASK "
            "runs stages phased with per-task re-scheduling onto other "
            "alive workers (reference: RetryPolicy + the FTE scheduler)",
            lambda v: v in ("NONE", "QUERY", "TASK"),
        ),
        _Prop(
            "task_retry_attempts", int, 3,
            "max attempts per task under retry_policy=TASK",
            lambda v: v >= 1,
        ),
        _Prop(
            "task_memory_budget_bytes", int, 0,
            "per-task device-memory budget enforced by the worker executor "
            "(0 = unlimited); retried tasks get an exponentially GROWN "
            "budget (reference: ExponentialGrowthPartitionMemoryEstimator "
            "in the FTE scheduler — a task that died on memory re-runs "
            "with a bigger estimate, not identically)",
            lambda v: v >= 0,
        ),
        _Prop("explain_format", str, "text", "text | json", None),
        _Prop(
            "resource_group", str, "global",
            "resource group this session's queries are admitted through "
            "(reference: resource-group selectors on user/source)",
            None,
        ),
        _Prop(
            "join_reordering_strategy", str, "AUTOMATIC",
            "AUTOMATIC | NONE — cost-based join reordering over inner-equi "
            "regions (plan/reorder.py; reference: ReorderJoins.java + the "
            "benchto variable of the same name)",
            lambda v: v in ("AUTOMATIC", "NONE"),
        ),
        _Prop(
            "client_spool_dir", str, "",
            "directory for SPOOLED client results (reference: server/"
            "protocol/spooling + spi/spool/SpoolingManager): when set and "
            "the client advertises spooling (X-Trino-Spooled header), "
            "finished results are written as row segments on disk and the "
            "protocol returns segment URIs instead of inline data — the "
            "coordinator holds no result rows in RAM and the client "
            "fetches segments at its own pace",
            None,
        ),
        _Prop(
            "exchange_spool_dir", str, "",
            "directory for the durable spooled exchange (reference: "
            "spi/exchange/ExchangeManager SPI + trino-exchange-filesystem). "
            "When set with retry_policy=TASK, every finished task's output "
            "buffers are committed there; a dead producer's output is "
            "RE-READ from the spool instead of recomputed, and workers "
            "drop spooled chunks from RAM",
            None,
        ),
        _Prop(
            "task_memory_reserve_bytes", int, 0,
            "bytes each task reserves from its worker's NodeMemoryPool "
            "before execution (reference: MemoryPool.reserve via the "
            "per-operator LocalMemoryContext chain); 0 = no reservation. "
            "A full pool parks the task BLOCKED until a peer frees",
            lambda v: v >= 0,
        ),
        _Prop(
            "memory_blocked_timeout_s", float, 60.0,
            "how long a task may sit blocked-on-memory before the wait "
            "escalates to a typed MemoryExceeded failure (reference: the "
            "cluster memory manager's blocked-nodes accounting); 0 = wait "
            "forever",
            lambda v: v >= 0,
        ),
        _Prop(
            "low_memory_killer_delay_s", float, 5.0,
            "grace period a node may stay over budget (or hold blocked "
            "tasks) before the coordinator's low-memory killer acts "
            "(reference: low-memory-killer.delay + "
            "TotalReservationLowMemoryKiller)",
            lambda v: v >= 0,
        ),
        _Prop(
            "memory_revocation_enabled", bool, True,
            "try revoking revocable memory (forcing partitioned / spilled "
            "execution, exec/spill.py) on pressured nodes BEFORE killing "
            "the largest query (reference: revocable memory + "
            "spill-to-disk ahead of the OOM killer)",
            None,
        ),
        _Prop(
            "compile_wait_budget_ms", int, 0,
            "how long a query (each of its tasks) waits for kernel 2's NVRTC "
            "build of a recipe in the compile service (exec/compilesvc.py); "
            "past it the query runs the unfused operator path (kernel 1), "
            "counted and named in QueryInfo, and the built kernel swaps in "
            "on the next execution (0 = wait for the build)",
            lambda v: v >= 0,
        ),
        _Prop(
            "compile_deadline_s", float, 300.0,
            "hard deadline of a kernel 2 build, from its start: a build past "
            "it releases its waiters with a typed COMPILE_TIMEOUT and they "
            "run the unfused path (0 = no deadline)",
            lambda v: v >= 0,
        ),
        _Prop(
            "resume_policy", str, "RESUME",
            "what a restarted coordinator does with in-flight journaled "
            "queries (runtime/journal.py): RESUME re-plans and re-dispatches "
            "only the fragments whose outputs did not COMMIT to the spool "
            "(committed stages are re-read — the FTE re-read-not-recompute "
            "promise applied to coordinator death); RESTART re-runs from "
            "scratch under the same query id; FAIL refuses — polls for the "
            "query answer 410 with a typed COORDINATOR_RESTART error",
            lambda v: v in ("RESUME", "FAIL", "RESTART"),
        ),
        _Prop(
            "spool_gc_age_s", float, 900.0,
            "age threshold for the spooled-exchange GC sweep "
            "(runtime/spool.py gc): committed task dirs and *.tmp-* staging "
            "dirs whose query is neither live nor younger than this are "
            "removed by the heartbeat sweep — crashed coordinators never "
            "call remove_query, so their spool output leaks without it",
            lambda v: v >= 0,
        ),
        _Prop(
            "result_cache_enabled", bool, True,
            "coordinator result & fragment cache (runtime/resultcache.py): "
            "repeated queries over unchanged snapshots are served from the "
            "coordinator's result cache, and shared scan+filter fragment "
            "prefixes are memoized via the spooled exchange (reference: "
            "coordinator-side result reuse over immutable Iceberg "
            "snapshots); time-travel and non-deterministic queries always "
            "bypass",
            None,
        ),
        _Prop(
            "result_cache_min_recurrences", int, 2,
            "history-driven admission threshold: a plan signature must "
            "appear this many times in the query-history store "
            "(runtime/history.py) before its result is cached — cache what "
            "recurs, not what happens once; 0 admits everything",
            lambda v: v >= 0,
        ),
        _Prop(
            "result_cache_ttl_s", float, 300.0,
            "per-entry result-cache time-to-live: entries older than this "
            "are dropped at lookup even when no invalidation fired "
            "(a backstop for connectors without version tracking); "
            "0 = no TTL",
            lambda v: v >= 0,
        ),
        _Prop(
            "result_cache_max_bytes", int, 64 << 20,
            "bytes budget for cached result rows; past it the "
            "least-recently-hit entries are evicted",
            lambda v: v >= 0,
        ),
        _Prop(
            "query_max_memory_bytes", int, 0,
            "device-memory budget per query; 0 = auto (~80% of the "
            "accelerator's reported HBM), -1 = unlimited (never reroute). "
            "Queries whose estimated working set exceeds the budget — or "
            "that hit device OOM mid-run — run out-of-core: partitioned "
            "into sequential slices with disk-spilled exchanges "
            "(exec/spill.py; reference: spiller/ + revocable memory)",
            lambda v: v >= -1,
        ),
        _Prop(
            "data_plane_kernels", bool, True,
            "master switch for the fused data-plane pipelines (the "
            "scan->filter->project->aggregate kernel, ops/cuda/fused.py; "
            "the hash group-by and hash join, ops/cuda/hashagg.py and "
            "hashjoin.py). false runs the operator-at-a-time and sort paths",
            None,
        ),
        _Prop(
            "hash_agg_kernel_limit", int, 1 << 24,
            "group-count capacity above which group-by takes the sort "
            "path instead of the hash-table kernel",
            lambda v: v >= 1,
        ),
        _Prop(
            "hash_join_kernel_limit", int, 1 << 24,
            "build-side rows above which equi-joins take the sort path "
            "instead of the hash-table kernel",
            lambda v: v >= 1,
        ),
        _Prop(
            "prepared_fastpath_enabled", bool, True,
            "serve EXECUTE of a prepared SELECT through the parameterized "
            "fast path (runtime/fastpath.py): parameters bound as jit "
            "arguments into one canonical compiled plan instead of "
            "re-parsing/re-planning per literal (reference: EXECUTE with "
            "session-held prepared statements); off = the legacy "
            "substitute-and-replan path",
            None,
        ),
        _Prop(
            "plan_cache_enabled", bool, True,
            "kill switch for the ParameterizedPlanCache: off = every "
            "EXECUTE replans (still binding parameters as jit arguments); "
            "cache entries are pinned to the scanned tables' version "
            "vector and invalidated on DML/snapshot bumps like "
            "runtime/resultcache.py",
            None,
        ),
        _Prop(
            "plan_cache_max_entries", int, 64,
            "LRU capacity of the parameterized plan cache (per engine "
            "surface); evictions count in "
            "trino_tpu_plan_cache_events_total{event=\"evicted\"}",
            lambda v: v >= 1,
        ),
        _Prop(
            "split_driven_scans", bool, True,
            "enumerate scans as fixed-capacity connector splits "
            "(runtime/splits.py) and schedule them individually: one task "
            "per morsel (row-range morsels, or file/row-group units for "
            "file-backed connectors), per-split retry/steal under "
            "retry_policy=TASK, and scan shapes pinned to split_target_rows "
            "so jit signatures stop depending on data scale (reference: "
            "connector split sources lazily scheduled onto drivers).  ON "
            "by default for retry_policy=TASK phased runs since the sf10 "
            "storage chaos drill; set false to opt out",
            None,
        ),
        _Prop(
            "spool_reproduce_limit", int, 3,
            "self-healing spool bound: how many lost/corrupt committed "
            "spool partitions the coordinator re-runs producers for "
            "(per query) before the query fails — the re-run publishes "
            "under first-commit-wins, so consumers re-read a byte-identical "
            "partition (trino_tpu_spool_reproductions_total counts them)",
            lambda v: v >= 0,
        ),
        _Prop(
            "hedge_delay_quantile", float, 0.95,
            "hedged exchange fetches (runtime/health.py): a fetch still "
            "in flight past this quantile of its link's success-latency "
            "history races a direct read of the producer's spool-committed "
            "partition; first result wins, the loser is canceled "
            "(reference: the tail-at-scale hedged-request rule applied to "
            "the FTE exchange)",
            lambda v: 0.0 <= v <= 1.0,
        ),
        _Prop(
            "exchange_deadline_headroom_ms", int, 500,
            "coherent deadline propagation: every exchange fetch computes "
            "its remaining budget from the X-Trino-Deadline header and "
            "fails fast with typed EXCHANGE_UNREACHABLE when less than "
            "this headroom remains — a partitioned fetch reroutes through "
            "spool reproduction instead of burning whole-query wall",
            lambda v: v >= 0,
        ),
        _Prop(
            "link_suspect_threshold", float, 0.25,
            "link-health grading (runtime/health.py): error EWMA at or "
            "above this grades the (consumer→producer) link SUSPECT; the "
            "coordinator's link matrix steers placement away from it",
            lambda v: 0.0 < v <= 1.0,
        ),
        _Prop(
            "exchange_retry_rotate", int, 3,
            "transient exchange-fetch failures on one link before the "
            "consumer stops re-hitting the same endpoint and rotates to "
            "the hedge path (spool re-read / producer reproduction) with "
            "a typed EXCHANGE_UNREACHABLE — instead of spinning on a dead "
            "producer until the whole-query deadline; 0 = never rotate",
            lambda v: v >= 0,
        ),
        _Prop(
            "split_target_rows", int, 65536,
            "target rows per scan split; rounded up to a power of two and "
            "used as the fixed scan-page capacity every morsel pads to, "
            "making jit signatures scale-invariant",
            lambda v: v >= 1,
        ),
        _Prop(
            "split_queue_depth", int, 2,
            "bounded per-worker queue of assigned-but-unstarted splits; "
            "when every alive worker's queue is full the scheduler stops "
            "assigning (backpressure) until a slot frees",
            lambda v: v >= 1,
        ),
        _Prop(
            "split_retry_limit", int, 3,
            "per-split retry budget under split_driven_scans; a split "
            "failing more times than this fails the query",
            lambda v: v >= 0,
        ),
        _Prop(
            "anomaly_detection_enabled", bool, True,
            "anomaly sentinel (runtime/history.py baselines): on query "
            "finish the coordinator scores the run against its planhash's "
            "rolling baseline and attaches typed anomalies "
            "(SLOW_VS_BASELINE, SPILL_REGRESSION, RETRY_STORM, "
            "COMPILE_STORM, BANDWIDTH_REGRESSION) to QueryInfo / history "
            "/ the EXPLAIN ANALYZE footer; anomalous runs auto-trigger a "
            "post-mortem bundle",
            None,
        ),
        _Prop(
            "anomaly_min_samples", int, 3,
            "clean baseline runs required per planhash before the sentinel "
            "scores at all — below it the sentinel stays silent (cold "
            "start must not false-positive)",
            lambda v: v >= 1,
        ),
        _Prop(
            "anomaly_slow_factor", float, 2.0,
            "SLOW_VS_BASELINE fires when wall > max(baseline p95, "
            "factor x baseline p50) and the absolute delta clears "
            "anomaly_min_wall_delta_ms",
            lambda v: v >= 1.0,
        ),
        _Prop(
            "anomaly_min_wall_delta_ms", float, 50.0,
            "absolute wall-clock floor for SLOW_VS_BASELINE — sub-floor "
            "jitter on fast queries never flags",
            lambda v: v >= 0,
        ),
        _Prop(
            "anomaly_spill_min_ms", float, 100.0,
            "SPILL_REGRESSION floor: spill time must exceed this AND "
            "anomaly_slow_factor x the baseline's spill p50",
            lambda v: v >= 0,
        ),
        _Prop(
            "anomaly_retry_storm_threshold", int, 3,
            "RETRY_STORM fires at this many task retries in one run when "
            "the baseline's retry p50 is below it",
            lambda v: v >= 1,
        ),
        _Prop(
            "anomaly_compile_storm_min", int, 2,
            "COMPILE_STORM fires when a run's compile count exceeds "
            "max(2 x baseline p50, baseline p50 + this)",
            lambda v: v >= 1,
        ),
        _Prop(
            "anomaly_bandwidth_factor", float, 2.0,
            "BANDWIDTH_REGRESSION fires when a run's achieved device "
            "GB/s (QueryInfo device_gb_per_sec, roofline plane) drops "
            "below baseline p50 / this factor — an INVERTED comparison: "
            "low bandwidth is the failure",
            lambda v: v >= 1.0,
        ),
        _Prop(
            "anomaly_bandwidth_min_gb_per_sec", float, 0.05,
            "BANDWIDTH_REGRESSION baseline floor: plans whose baseline "
            "p50 bandwidth sits below this never flag (tiny programs "
            "live in scheduler-jitter noise, not the memory system)",
            lambda v: v >= 0,
        ),
        _Prop(
            "postmortem_enabled", bool, True,
            "write a cross-node post-mortem bundle (flight-recorder "
            "slices + phase ledger + journal records + final QueryInfo) "
            "under the spool dir on typed query failure or anomaly; "
            "served by GET /v1/query/{id}/postmortem and renderable via "
            "scripts/postmortem_report.py",
            None,
        ),
        _Prop(
            "postmortem_budget_bytes", int, 16 << 20,
            "disk-pool lease size cap for one post-mortem bundle; bundles "
            "larger than this are truncated (oldest events dropped)",
            lambda v: v >= 1 << 10,
        ),
        _Prop(
            "execute_batch_window_ms", float, 0.0,
            "shared small-query batching: concurrent EXECUTEs of the SAME "
            "prepared plan arriving within this window are stacked into "
            "one batched device dispatch (parameters become a leading "
            "batch axis when the plan supports vmap, per-query pipelined "
            "dispatch otherwise); 0 disables batching",
            lambda v: v >= 0,
        ),
    ]
}


class SessionProperties:
    def __init__(self) -> None:
        self._values: dict[str, Any] = {}

    def set(self, name: str, raw: str) -> None:
        if name not in PROPERTIES:
            raise KeyError(f"unknown session property: {name}")
        p = PROPERTIES[name]
        if p.type is int:
            value: Any = int(raw)
        elif p.type is float:
            value = float(raw)
        elif p.type is bool:
            value = raw.lower() in ("true", "1", "on")
        else:
            value = str(raw)
        if p.validate is not None and not p.validate(value):
            raise ValueError(f"invalid value for {name}: {raw!r}")
        self._values[name] = value

    def get(self, name: str) -> Any:
        if name in self._values:
            return self._values[name]
        return PROPERTIES[name].default

    def as_dict(self) -> dict[str, Any]:
        return {name: self.get(name) for name in PROPERTIES}
