"""Background compile service: kernel 2's NVRTC builds off the query's path.

The port compiles one thing at run time: kernel 2, the fused
scan->filter->project->aggregate pipeline, generated per recipe
(ops/cuda/fused_codegen.py) and compiled by NVRTC for sm_90a at the
recipe's first use.  A cold build costs seconds; this module keeps that
wall off the query's critical path, to the contract of the reference's
service (trino_tpu/exec/compilesvc.py):

  - CompileService.obtain() runs every build on a small worker pool and
    DEDUPLICATES per signature key: N concurrent queries with the same
    recipe on the same card trigger exactly ONE build; joiners wait on
    the same job.
  - A caller-supplied ``wait_budget_s`` bounds how long a query blocks;
    past it the outcome is ``pending`` and the caller runs its fallback
    (the unfused operator path, whose aggregates run on kernel 1) while
    the build finishes in the background.  The finished kernel lands in
    a bounded done-map and swaps in on the recipe's next execution.
  - A hard ``deadline_s`` (measured from job creation) turns a build that
    will not finish into a typed ``timeout`` outcome, never a hung query.
    The job thread itself cannot be killed, but every waiter is released
    and a late completion still populates the done-map.
  - A per-signature circuit breaker (exponential open window riding
    runtime/failure.py's Backoff schedule) stops retry churn on poisoned
    signatures: after ``threshold`` consecutive build failures the
    signature pins its fallback, with a single half-open probe once the
    window elapses.  It counts injected failures (an armed COMPILE_FAIL,
    runtime/failure.py `InjectedCompileFailure`) and deadline timeouts.
    Any other build error is a fault of the port: it comes back as an
    ``error`` outcome every time, the caller raises it, and it never
    opens the breaker, so no recipe is pinned to its fallback by a bug.

The executor (exec/compiler.py `LocalExecutor._kernel_ready`) names the
job, counts every fallback in FALLBACKS by reason and records it in its
`fallback_events`; the worker hands each task's FaultInjector to the job,
so COMPILE_SLOW / COMPILE_FAIL fire inside the build as in the reference.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from ..runtime.failure import Backoff, InjectedCompileFailure
from ..utils import flightrecorder as _fr
from ..utils.metrics import GLOBAL as _METRICS

__all__ = [
    "CompileService", "SignatureBreaker", "Outcome", "SERVICE",
    "FALLBACKS",
]

COMPILE_INFLIGHT = _METRICS.gauge(
    "trino_tpu_compile_inflight",
    "Background kernel builds (kernel 2's NVRTC recipes) currently running"
    " or queued in the compile service",
)
COMPILE_TIMEOUTS = _METRICS.counter(
    "trino_tpu_compile_timeouts_total",
    "Compiles that exceeded their hard compile_deadline_s (the query"
    " proceeded via fallback with a typed COMPILE_TIMEOUT entry)",
)
COMPILE_DEDUP = _METRICS.counter(
    "trino_tpu_compile_dedup_total",
    "obtain() calls that joined an already-in-flight compile for the"
    " same signature instead of starting their own (storm admission)",
)
# incremented by the EXECUTORS (exec/compiler.py) when they actually run
# the fallback path; lives here so service and executor share one child
FALLBACKS = _METRICS.counter(
    "trino_tpu_fallback_executions_total",
    "Query executions that ran the unfused operator path instead of"
    " kernel 2's built kernel, by reason (compile_wait: budget"
    " exhausted; compile_timeout: deadline exceeded; compile_error:"
    " an injected COMPILE_FAIL raised; breaker_open: poisoned signature pinned)",
    ("reason",),
)

# breaker states (per signature, not per worker)
CLOSED = "CLOSED"
OPEN = "OPEN"
HALF_OPEN = "HALF_OPEN"


class SignatureBreaker:
    """Per-signature compile circuit breaker.

    CLOSED --`threshold` consecutive failures--> OPEN (no new compile
    attempts; callers fall back immediately).  Once the open window —
    an exponential schedule that grows with every further failure —
    elapses, allow() grants exactly ONE half-open probe; its success
    fully closes the breaker, its failure re-opens with a longer
    window.  Deterministic (jitter=0): chaos tests replay exactly.
    """

    def __init__(
        self,
        threshold: int = 3,
        min_open_s: float = 0.5,
        max_open_s: float = 60.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.threshold = threshold
        self._clock = clock
        self._lock = threading.Lock()
        self._min_open_s = min_open_s
        self._max_open_s = max_open_s
        self._sigs: dict[str, dict] = {}

    def _get(self, sig: str) -> dict:
        e = self._sigs.get(sig)
        if e is None:
            e = self._sigs[sig] = {
                "state": CLOSED,
                "failures": 0,
                "opened_at": 0.0,
                "backoff": Backoff(
                    min_delay=self._min_open_s,
                    max_delay=self._max_open_s,
                    max_elapsed=float("inf"),
                    jitter=0.0,
                ),
            }
        return e

    def allow(self, sig: str) -> bool:
        """May a NEW compile attempt start for this signature?  CLOSED:
        yes.  OPEN: only once the open window elapsed, and then exactly
        one probe (state moves to HALF_OPEN so concurrent callers keep
        falling back until the probe resolves)."""
        with self._lock:
            e = self._get(sig)
            if e["state"] == CLOSED:
                return True
            if e["state"] == HALF_OPEN:
                return False  # probe outstanding
            window = e["backoff"].delay()
            if (self._clock() - e["opened_at"]) >= window:
                e["state"] = HALF_OPEN
                return True
            return False

    def record_failure(self, sig: str) -> None:
        with self._lock:
            e = self._get(sig)
            e["failures"] += 1
            e["backoff"].failure()
            if e["state"] == HALF_OPEN or e["failures"] >= self.threshold:
                e["state"] = OPEN
                e["opened_at"] = self._clock()

    def record_success(self, sig: str) -> None:
        with self._lock:
            e = self._get(sig)
            e["state"] = CLOSED
            e["failures"] = 0
            e["backoff"].success()

    def state(self, sig: str) -> str:
        with self._lock:
            return self._get(sig)["state"]

    def snapshot(self) -> dict[str, dict]:
        with self._lock:
            return {
                s: {"state": e["state"], "failures": e["failures"]}
                for s, e in self._sigs.items()
            }


@dataclass
class Outcome:
    """Result of CompileService.obtain().

    status: ready      — compiled program available (result holds it)
            pending    — wait budget exhausted; compile continues in the
                         background (fall back, swap in next execution)
            timeout    — hard deadline exceeded (typed COMPILE_TIMEOUT)
            error      — the build raised (error holds the exception;
                         only an InjectedCompileFailure may be fallen
                         back from, any other is the caller's to raise)
            breaker_open — poisoned signature, no attempt started
    reason: the fallback-reason label for every non-ready status
    fresh:  True when THIS call created the job and waited it to
            completion (the compile wall belongs to this query).
    """

    status: str
    reason: Optional[str] = None
    result: Any = None
    error: Optional[BaseException] = None
    waited_s: float = 0.0
    fresh: bool = False


@dataclass
class _Job:
    key: Any
    sig: str
    created_at: float
    done: threading.Event = field(default_factory=threading.Event)
    result: Any = None
    error: Optional[BaseException] = None
    timed_out: bool = False


class CompileService:
    """Worker-pool compile service with per-key in-flight dedup and a
    bounded done-map of finished programs awaiting swap-in.

    Keys must capture everything a built kernel is specialized on: the
    executor passes (recipe cache key, device, kernel policy) — the cache
    key digests the program's structure, the column dtypes, the key domain
    and the stream kinds (fused_codegen.cache_key), and a kernel loads on
    one card only.
    """

    _DONE_MAX = 256  # finished programs awaiting swap-in (LRU)

    def __init__(
        self,
        max_workers: Optional[int] = None,
        breaker: Optional[SignatureBreaker] = None,
    ):
        if max_workers is None:
            max_workers = min(8, max(2, (os.cpu_count() or 4) // 2))
        self._max_workers = max(1, max_workers)
        self._pool = None  # created lazily (import-time thread pools leak)
        self._lock = threading.Lock()
        self._inflight: dict[Any, _Job] = {}
        self._done: OrderedDict[Any, Any] = OrderedDict()
        self.breaker = breaker or SignatureBreaker()
        self.builds = 0  # total build() invocations (dedup observability)

    def _ensure_pool(self):
        from concurrent.futures import ThreadPoolExecutor

        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self._max_workers,
                thread_name_prefix="compile-svc",
            )
        return self._pool

    # ------------------------------------------------------------- obtain
    def obtain(
        self,
        key: Any,
        sig: str,
        build: Callable[[], Any],
        wait_budget_s: Optional[float] = None,
        deadline_s: float = 0.0,
        injector=None,
        fault_task_id: str = "local",
    ) -> Outcome:
        """Get the compiled program for `key`, compiling via `build` on
        the pool if needed.  wait_budget_s None == wait until done (or
        deadline); deadline_s 0 == no deadline.  `injector` is the
        worker's FaultInjector: COMPILE_SLOW / COMPILE_FAIL faults fire
        inside the build job (runtime/failure.py)."""
        t0 = time.monotonic()
        with self._lock:
            hit = self._done.get(key)
            if hit is not None:
                self._done.move_to_end(key)
                return Outcome("ready", result=hit)
            job = self._inflight.get(key)
            fresh = job is None
            if fresh:
                if not self.breaker.allow(sig):
                    _fr.record(
                        "compile_fallback", node="compilesvc",
                        task_id=fault_task_id, signature=sig,
                        reason="breaker_open",
                    )
                    return Outcome("breaker_open", reason="breaker_open")
                job = _Job(key=key, sig=sig, created_at=t0)
                self._inflight[key] = job
                COMPILE_INFLIGHT.set(len(self._inflight))
                _fr.record(
                    "compile_start", node="compilesvc",
                    task_id=fault_task_id, signature=sig,
                )
                self._ensure_pool().submit(
                    self._run_job, job, build, injector, fault_task_id
                )
            else:
                COMPILE_DEDUP.inc()

        budget_at = None if wait_budget_s is None else t0 + wait_budget_s
        deadline_at = (
            job.created_at + deadline_s if deadline_s and deadline_s > 0
            else None
        )
        while True:
            now = time.monotonic()
            waits = [w for w in (
                None if budget_at is None else budget_at - now,
                None if deadline_at is None else deadline_at - now,
            ) if w is not None]
            if waits:
                job.done.wait(timeout=max(min(waits), 0.0))
            else:
                job.done.wait()
            waited = time.monotonic() - t0
            if job.done.is_set():
                if job.error is not None:
                    return Outcome(
                        "error", reason="compile_error", error=job.error,
                        waited_s=waited, fresh=fresh,
                    )
                return Outcome(
                    "ready", result=job.result, waited_s=waited, fresh=fresh
                )
            now = time.monotonic()
            if deadline_at is not None and now >= deadline_at:
                self._mark_timeout(job)
                _fr.record(
                    "compile_fallback", node="compilesvc",
                    task_id=fault_task_id, signature=sig,
                    reason="compile_timeout", waited_s=round(waited, 3),
                )
                return Outcome(
                    "timeout", reason="compile_timeout", waited_s=waited
                )
            if budget_at is not None and now >= budget_at:
                _fr.record(
                    "compile_fallback", node="compilesvc",
                    task_id=fault_task_id, signature=sig,
                    reason="compile_wait", waited_s=round(waited, 3),
                )
                return Outcome(
                    "pending", reason="compile_wait", waited_s=waited
                )

    def forget(self, key: Any) -> None:
        """Drop a finished result from the done-map (its kernel was
        unloaded: ops/cuda/fused_codegen.clear_cache), so the next obtain()
        builds it again."""
        with self._lock:
            self._done.pop(key, None)

    def inflight(self) -> int:
        """Builds running or queued now (the `compile_inflight` lanes)."""
        with self._lock:
            return len(self._inflight)

    # ------------------------------------------------------------ internals
    def _mark_timeout(self, job: _Job) -> None:
        """First waiter past the deadline records the timeout exactly once
        (metric + profiler ledger + breaker failure); later waiters and a
        late job completion see `timed_out` and skip re-recording."""
        from ..utils.profiler import PROFILER

        with self._lock:
            if job.timed_out or job.done.is_set():
                return
            job.timed_out = True
        COMPILE_TIMEOUTS.inc()
        PROFILER.record_compile_timeout(job.sig)
        self.breaker.record_failure(job.sig)

    def _run_job(self, job: _Job, build, injector, fault_task_id) -> None:
        try:
            with self._lock:
                self.builds += 1
            if injector is not None:
                injector.compile_fault(fault_task_id)
            job.result = build()
        except BaseException as exc:
            job.error = exc
            if not job.timed_out and isinstance(exc, InjectedCompileFailure):
                self.breaker.record_failure(job.sig)
            _fr.record(
                "compile_error", node="compilesvc", task_id=fault_task_id,
                signature=job.sig, error=str(exc)[:200],
            )
        else:
            with self._lock:
                self._done[job.key] = job.result
                self._done.move_to_end(job.key)
                while len(self._done) > self._DONE_MAX:
                    self._done.popitem(last=False)
            if not job.timed_out:
                self.breaker.record_success(job.sig)
            _fr.record(
                "compile_done", node="compilesvc", task_id=fault_task_id,
                signature=job.sig,
                compile_s=round(time.monotonic() - job.created_at, 3),
            )
        finally:
            with self._lock:
                self._inflight.pop(job.key, None)
                COMPILE_INFLIGHT.set(len(self._inflight))
            job.done.set()

    def drain(self, timeout_s: float = 30.0) -> None:
        """Wait for every in-flight compile to settle (tests, shutdown)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                jobs = list(self._inflight.values())
            if not jobs:
                return
            jobs[0].done.wait(timeout=max(deadline - time.monotonic(), 0.0))

    def reset(self) -> None:
        """Forget done programs and breaker history (tests)."""
        with self._lock:
            self._done.clear()
            self.builds = 0
        self.breaker = SignatureBreaker(
            threshold=self.breaker.threshold,
            min_open_s=self.breaker._min_open_s,
            max_open_s=self.breaker._max_open_s,
            clock=self.breaker._clock,
        )

# process-global service: every LocalExecutor in the process shares one
# pool and one dedup map, so concurrent worker tasks with the same recipe
# on the same card storm-collapse onto a single build
SERVICE = CompileService()
