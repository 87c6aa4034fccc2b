"""Failure-handling primitives for the multi-host data plane.

Reference wiring this replaces (SURVEY §3.2):
  - Backoff: jittered exponential retry schedule with a failure deadline
    (airlift Backoff.java, driven by HttpPageBufferClient.java:355 and
    ContinuousTaskStatusFetcher) — transient fetch errors retry with
    growing delays; only a deadline's worth of consecutive failures
    escalates to task failure.
  - FailureDetector: per-worker health from heartbeat observations
    (failuredetector/HeartbeatFailureDetector.java:76 keeps an
    exponentially-decayed failure rate per node and gates scheduling).
    Modeled as a circuit breaker: OK -> SUSPECT (elevated error EWMA) ->
    QUARANTINED (no new dispatches), with automatic half-open probes —
    a quarantined worker is re-probed after `probe_interval` and one
    successful probe restores it.
  - FaultInjector: the test-only fault matrix
    (execution/FailureInjector.java:33): ERROR, TIMEOUT, SLOW(delay_ms)
    and EXCHANGE_DROP(count) faults, one-shot / counted / probabilistic,
    targeted at a task id, a task-id prefix, or every task ("*").

A copy of the JAX package's module (plain Python).  The port's engine
consumes the write faults (`write_fault`, `InjectedCommitCrash`) in
runtime/txn.py; workers (runtime/worker.py) consume the task and exchange
faults.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

__all__ = [
    "Backoff", "FailureDetector", "FaultInjector", "WorkerHealth", "DRAINING",
]


class Backoff:
    """Jittered exponential backoff with a failure deadline.

    `failure()` records one failed attempt and returns True once the time
    since the FIRST failure of the current streak exceeds `max_elapsed` —
    the caller escalates (fails the task) instead of retrying forever.
    `success()` resets the streak.  Delays grow min_delay * factor^k up to
    max_delay, each multiplied by a random jitter in [1-jitter, 1+jitter]
    (decorrelates retry storms across consumers hitting one producer).

    `decorrelated=True` switches to decorrelated jitter ("Exponential
    Backoff And Jitter", AWS Architecture Blog):
    delay = min(max_delay, uniform(min_delay, 3 * previous_delay)).  The
    multiplicative-jitter schedule keeps a cohort's k-th retries within
    ±jitter of the SAME center, so a mass client re-attach after a
    coordinator death arrives at the survivor in synchronized waves; the
    decorrelated walk spreads each client's k-th retry over the whole
    [min_delay, max_delay] range instead.
    """

    def __init__(
        self,
        min_delay: float = 0.05,
        max_delay: float = 2.0,
        max_elapsed: float = 30.0,
        factor: float = 2.0,
        jitter: float = 0.25,
        decorrelated: bool = False,
        rng: Optional[random.Random] = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ):
        assert min_delay > 0 and max_delay >= min_delay and factor >= 1.0
        assert 0.0 <= jitter < 1.0
        self.min_delay = min_delay
        self.max_delay = max_delay
        self.max_elapsed = max_elapsed
        self.factor = factor
        self.jitter = jitter
        self.decorrelated = decorrelated
        self._rng = rng or random.Random()
        self._clock = clock
        self._sleep = sleep
        self.failure_count = 0
        self.first_failure_at: Optional[float] = None
        self._prev_delay: Optional[float] = None

    def failure(self) -> bool:
        """Record a failed attempt; True == deadline exceeded, give up."""
        now = self._clock()
        if self.first_failure_at is None:
            self.first_failure_at = now
        self.failure_count += 1
        return (now - self.first_failure_at) >= self.max_elapsed

    def success(self) -> None:
        self.failure_count = 0
        self.first_failure_at = None
        self._prev_delay = None

    def delay(self) -> float:
        """Delay before the next attempt, for the current failure count."""
        if self.decorrelated:
            prev = self._prev_delay
            if prev is None:
                d = self._rng.uniform(self.min_delay, self.min_delay * 3)
            else:
                d = self._rng.uniform(self.min_delay, prev * 3)
            d = min(d, self.max_delay)
            self._prev_delay = d
            return d
        k = max(self.failure_count - 1, 0)
        base = min(self.min_delay * (self.factor ** k), self.max_delay)
        if self.jitter:
            base *= 1.0 + self._rng.uniform(-self.jitter, self.jitter)
        return base

    def sleep(self) -> None:
        self._sleep(self.delay())


# circuit-breaker states
OK = "OK"
SUSPECT = "SUSPECT"
QUARANTINED = "QUARANTINED"
# third dispatchability state (reference: GracefulShutdownHandler flipping
# ServerInfo to SHUTTING_DOWN): the worker is HEALTHY — it answers
# heartbeats and serves exchange fetches — but must receive no new task
# dispatches while it finishes running tasks and empties its buffers.
# Distinct from QUARANTINED: no failure is recorded, no retry storm, and
# the half-open probe machinery never engages.
DRAINING = "DRAINING"


@dataclass
class WorkerHealth:
    """Per-worker view the detector maintains from heartbeat outcomes."""

    state: str = OK
    error_ewma: float = 0.0  # decayed failure rate in [0, 1]
    latency_ewma: float = 0.0  # decayed heartbeat latency (seconds)
    consecutive_failures: int = 0
    last_probe_at: float = field(default=0.0)
    quarantined_at: Optional[float] = None
    # worker announced DRAINING: overlays the breaker state (which keeps
    # tracking health underneath) everywhere except QUARANTINED
    draining: bool = False


class FailureDetector:
    """EWMA heartbeat health + circuit breaker per worker.

    Transitions (evaluated on every recorded observation):
      OK         --failure-->                      SUSPECT
      SUSPECT    --2nd consecutive failure or
                   error_ewma >= quarantine_threshold--> QUARANTINED
      SUSPECT    --success w/ error_ewma < suspect_threshold--> OK
      QUARANTINED --successful half-open probe-->  OK

    A QUARANTINED worker is not dispatchable; `should_probe` turns True
    again `probe_interval` seconds after quarantine (half-open), letting
    the heartbeat loop send one probe whose success restores the worker.
    """

    def __init__(
        self,
        alpha: float = 0.3,
        suspect_threshold: float = 0.25,
        quarantine_threshold: float = 0.75,
        quarantine_failures: int = 2,
        probe_interval: float = 4.0,
        clock: Callable[[], float] = time.monotonic,
        on_transition: Optional[Callable[[str, str, str], None]] = None,
    ):
        self.alpha = alpha
        self.suspect_threshold = suspect_threshold
        self.quarantine_threshold = quarantine_threshold
        self.quarantine_failures = quarantine_failures
        self.probe_interval = probe_interval
        self._clock = clock
        self._lock = threading.Lock()
        self._workers: dict[str, WorkerHealth] = {}
        # (url, old_state, new_state) observer, fired OUTSIDE the lock so a
        # callback may re-enter the detector (metrics, logging)
        self._on_transition = on_transition

    def _notify(self, url: str, old: str, new: str) -> None:
        if old != new and self._on_transition is not None:
            try:
                self._on_transition(url, old, new)
            except Exception:
                pass  # an observer must never break health accounting

    def _get(self, url: str) -> WorkerHealth:
        h = self._workers.get(url)
        if h is None:
            h = self._workers[url] = WorkerHealth()
        return h

    @staticmethod
    def _effective(h: WorkerHealth) -> str:
        """The dispatchability state the scheduler sees.  QUARANTINED wins
        (a draining worker that stops answering is still a dead worker);
        otherwise an announced drain overlays OK/SUSPECT."""
        if h.state == QUARANTINED:
            return h.state
        return DRAINING if h.draining else h.state

    def reset(self, url: str) -> None:
        """Forget a worker's history (re-announce after restart)."""
        with self._lock:
            self._workers[url] = WorkerHealth()

    def forget(self, url: str) -> None:
        """Drop a worker entirely (graceful deregistration after drain):
        unlike reset, the worker stops appearing in snapshots."""
        with self._lock:
            self._workers.pop(url, None)

    def set_draining(self, url: str, draining: bool = True) -> None:
        """Mark a worker DRAINING (announced via its /v1/info state or a
        shutdown PUT).  Not a failure: health tracking continues underneath
        and no breaker transition to QUARANTINED is implied."""
        with self._lock:
            h = self._get(url)
            old = self._effective(h)
            h.draining = draining
            new = self._effective(h)
        self._notify(url, old, new)

    def record_success(self, url: str, latency: float = 0.0) -> None:
        with self._lock:
            h = self._get(url)
            old = self._effective(h)
            h.consecutive_failures = 0
            h.error_ewma *= 1.0 - self.alpha
            h.latency_ewma = (
                latency
                if h.latency_ewma == 0.0
                else (1.0 - self.alpha) * h.latency_ewma + self.alpha * latency
            )
            h.last_probe_at = self._clock()
            if h.state == QUARANTINED:
                # half-open probe succeeded: full restore
                h.state = OK
                h.error_ewma = 0.0
                h.quarantined_at = None
            elif h.state == SUSPECT and h.error_ewma < self.suspect_threshold:
                h.state = OK
            new = self._effective(h)
        self._notify(url, old, new)

    def record_failure(self, url: str) -> None:
        with self._lock:
            h = self._get(url)
            old = self._effective(h)
            h.consecutive_failures += 1
            h.error_ewma = (1.0 - self.alpha) * h.error_ewma + self.alpha
            h.last_probe_at = self._clock()
            if h.state == QUARANTINED:
                # failed half-open probe: restart the quarantine clock
                h.quarantined_at = self._clock()
            elif (
                h.consecutive_failures >= self.quarantine_failures
                or h.error_ewma >= self.quarantine_threshold
            ):
                h.state = QUARANTINED
                h.quarantined_at = self._clock()
            elif h.state == OK:
                h.state = SUSPECT
            new = self._effective(h)
        self._notify(url, old, new)

    def state(self, url: str) -> str:
        with self._lock:
            return self._effective(self._get(url))

    def is_dispatchable(self, url: str) -> bool:
        """May this worker receive NEW task dispatches?  SUSPECT still may
        (degraded but serving); QUARANTINED may not until a probe succeeds;
        DRAINING may not at all — but unlike QUARANTINED it stays healthy
        and fetchable, so nothing already scheduled on it is retried."""
        with self._lock:
            return self._effective(self._get(url)) not in (QUARANTINED, DRAINING)

    def should_probe(self, url: str) -> bool:
        """Should the heartbeat loop contact this worker this sweep?
        Healthy workers: always.  Quarantined: only once the half-open
        window opened (probe_interval since quarantine / last probe)."""
        with self._lock:
            h = self._get(url)
            if h.state != QUARANTINED:
                return True
            anchor = max(h.quarantined_at or 0.0, h.last_probe_at)
            return (self._clock() - anchor) >= self.probe_interval

    def snapshot(self) -> dict[str, dict]:
        with self._lock:
            return {
                url: {
                    "state": self._effective(h),
                    "error_ewma": round(h.error_ewma, 4),
                    "latency_ewma": round(h.latency_ewma, 6),
                    "consecutive_failures": h.consecutive_failures,
                }
                for url, h in self._workers.items()
            }


# ------------------------------------------------------------ fault matrix


@dataclass
class _FaultRule:
    task_id: str  # "*" == any; otherwise exact id or prefix
    mode: str  # one of FaultInjector.MODES
    delay_ms: int = 0
    count: int = 1  # firings remaining; < 0 == persistent (never exhausts)
    probability: float = 1.0
    rng: Optional[random.Random] = None
    # pairwise link scoping for the PARTITION/GRAY_SLOW/FLAKY_LINK modes:
    # "*" == any consumer; otherwise the rule only fires for fetch requests
    # whose X-Trino-Consumer / ?consumer= identity carries this prefix —
    # that is what makes an ASYMMETRIC partition expressible (A→B drops
    # while coordinator→B and C→B stay clean)
    consumer: str = "*"

    def matches(self, task_id: str) -> bool:
        return self.task_id == "*" or task_id.startswith(self.task_id)

    def matches_consumer(self, consumer: str) -> bool:
        return self.consumer == "*" or (consumer or "").startswith(
            self.consumer
        )


class FaultInjector:
    """The worker-side fault matrix (FailureInjector.java:33 analogue).

    Rules are armed via POST /v1/inject_failure and consumed at two
    hook points:
      - task_fault(task_id): ERROR raises immediately, TIMEOUT sleeps
        then raises (a slow failure that exercises status-deadline
        escalation), SLOW sleeps then lets the task run normally.
      - compile_fault(task_id): COMPILE_SLOW sleeps inside the compile
        service's build job (the query must complete via fallback within
        its wait budget), COMPILE_FAIL raises there (the per-signature
        circuit breaker must absorb the churn).
      - drop_fetch(task_id): EXCHANGE_DROP answers the next `count`
        matching page-fetch requests with HTTP 503 — the consumer's
        Backoff retries and resumes from its token, so recovery must be
        idempotent.
      - corrupt_fetch(task_id): CORRUPT flips a byte in the next `count`
        matching served exchange frames — the consumer's crc32 check must
        reject the chunk (PAGE_TRANSPORT_ERROR) and re-fetch the same
        token; a silent wrong-rows result is the failure being tested.

    MEMORY_PRESSURE and DISK_FULL are consumed at arm time by the worker's
    /v1/inject_failure handler (they shrink the node memory pool / node
    disk pool to the request's `capacity_bytes` immediately), not at a
    hook point here.  SPOOL_LOST is consumed by spool_lost() at a
    consuming worker's source read: the committed partition is deleted
    before the read, and the coordinator's self-healing path must re-run
    the producer.

    Link faults (link_fault(task_id, consumer)) model the gray/asymmetric
    failures of the exchange plane (runtime/health.py):
      - PARTITION answers matching page fetches with 503 ONLY when the
        requesting consumer matches the rule's `consumer` scope — a
        pairwise drop matrix (A→B dead while coordinator→B is fine).
      - GRAY_SLOW sleeps delay_ms then serves NORMALLY — a latency-only
        gray failure with zero errors; only hedged fetches save the query.
      - FLAKY_LINK drops probabilistically (probability + seed).
    These are typically armed with count=-1 (persistent until clear()):
    a partition does not heal after N requests.

    `probability` < 1 arms a probabilistic variant: each match fires with
    that probability using a per-rule seeded rng (deterministic chaos).
    """

    MODES = (
        "ERROR", "TIMEOUT", "SLOW", "EXCHANGE_DROP", "CORRUPT",
        "MEMORY_PRESSURE", "COMPILE_SLOW", "COMPILE_FAIL", "SPLIT_LOST",
        "SPOOL_LOST", "DISK_FULL", "COMMIT_CRASH", "WRITE_STALL",
        "PARTITION", "GRAY_SLOW", "FLAKY_LINK",
    )

    def __init__(self):
        self._lock = threading.Lock()
        self._rules: list[_FaultRule] = []
        self.fired: list[tuple[str, str]] = []  # (mode, task_id) observability

    def arm(
        self,
        task_id: str = "*",
        mode: str = "ERROR",
        delay_ms: int = 0,
        count: int = 1,
        probability: float = 1.0,
        seed: Optional[int] = None,
        consumer: str = "*",
    ) -> None:
        mode = mode.upper()
        if mode not in self.MODES:
            raise ValueError(f"unknown fault mode: {mode}")
        rule = _FaultRule(
            task_id=task_id,
            mode=mode,
            delay_ms=int(delay_ms),
            count=int(count),
            probability=float(probability),
            rng=random.Random(seed) if probability < 1.0 else None,
            consumer=consumer or "*",
        )
        with self._lock:
            self._rules.append(rule)

    def clear(self) -> None:
        with self._lock:
            self._rules = []

    def _take(
        self,
        task_id: str,
        modes: tuple[str, ...],
        consumer: Optional[str] = None,
    ) -> Optional[_FaultRule]:
        with self._lock:
            for rule in self._rules:
                if rule.mode not in modes or not rule.matches(task_id):
                    continue
                if consumer is not None and not rule.matches_consumer(
                    consumer
                ):
                    continue
                if rule.rng is not None and rule.rng.random() >= rule.probability:
                    continue
                if rule.count > 0:  # count < 0 == persistent, never exhausts
                    rule.count -= 1
                    if rule.count <= 0:
                        self._rules.remove(rule)
                self.fired.append((rule.mode, task_id))
                return rule
        return None

    def task_fault(self, task_id: str, sleep: Callable[[float], None] = time.sleep) -> None:
        """Apply any armed ERROR/TIMEOUT/SLOW/SPLIT_LOST fault for this
        task.  Raises RuntimeError for ERROR/TIMEOUT/SPLIT_LOST; returns
        after the delay for SLOW; no-op when nothing matches.  SPLIT_LOST
        models a split assignment evaporating mid-scan (the connector's
        row range went away under the reader): under split-driven scans
        exactly ONE morsel fails and is re-assigned alone — a whole-task
        blast radius here is the regression being tested."""
        rule = self._take(task_id, ("ERROR", "TIMEOUT", "SLOW", "SPLIT_LOST"))
        if rule is None:
            return
        if rule.mode == "ERROR":
            raise RuntimeError(f"injected failure for task {task_id}")
        if rule.mode == "SPLIT_LOST":
            raise RuntimeError(f"split lost for task {task_id} [SPLIT_LOST]")
        if rule.delay_ms:
            sleep(rule.delay_ms / 1000.0)
        if rule.mode == "TIMEOUT":
            raise RuntimeError(f"injected timeout for task {task_id}")

    def drop_fetch(self, task_id: str) -> bool:
        """True == answer this page-fetch request with a transient 503."""
        return self._take(task_id, ("EXCHANGE_DROP",)) is not None

    def link_fault(
        self,
        task_id: str,
        consumer: str = "",
        sleep: Callable[[float], None] = time.sleep,
    ) -> Optional[str]:
        """Apply any armed pairwise link fault to this page-fetch request.
        `consumer` is the requester's identity (X-Trino-Consumer / the
        ?consumer= query param); rules scoped to a specific consumer only
        fire for it — the asymmetric-partition lever.  Returns "drop" when
        the caller must answer 503 (PARTITION, or a FLAKY_LINK roll that
        hit), None to serve normally; GRAY_SLOW sleeps delay_ms here and
        returns None — latency injected, zero errors."""
        rule = self._take(
            task_id, ("PARTITION", "GRAY_SLOW", "FLAKY_LINK"), consumer=consumer
        )
        if rule is None:
            return None
        if rule.mode == "GRAY_SLOW":
            if rule.delay_ms:
                sleep(rule.delay_ms / 1000.0)
            return None
        return "drop"

    def spool_lost(self, producer_task_id: str) -> bool:
        """True == the caller (a consuming worker about to read a spooled
        source) should DELETE the producer's committed spool partition
        first — modeling durable-exchange storage loss.  The read then
        fails typed (SPOOL_LOST), and the coordinator must re-run the
        producer under first-commit-wins instead of failing the query
        (the self-healing-spool path this mode exists to exercise)."""
        return self._take(producer_task_id, ("SPOOL_LOST",)) is not None

    def compile_fault(
        self, task_id: str, sleep: Callable[[float], None] = time.sleep
    ) -> None:
        """Apply any armed COMPILE_SLOW / COMPILE_FAIL fault.  Runs inside
        the compile service's build job (exec/compilesvc.py), so SLOW
        exercises the wait-budget fallback and deadline paths while FAIL
        exercises the per-signature circuit breaker — the query itself
        must survive either via fallback execution."""
        rule = self._take(task_id, ("COMPILE_SLOW", "COMPILE_FAIL"))
        if rule is None:
            return
        if rule.mode == "COMPILE_FAIL":
            raise InjectedCompileFailure(f"injected compile failure for task {task_id}")
        if rule.delay_ms:
            sleep(rule.delay_ms / 1000.0)

    def corrupt_fetch(self, task_id: str) -> bool:
        """True == flip a byte in the exchange frame served for this
        page-fetch request (end-to-end integrity check exercise)."""
        return self._take(task_id, ("CORRUPT",)) is not None

    def write_fault(
        self, key: str, sleep: Callable[[float], None] = time.sleep
    ) -> None:
        """Apply any armed COMMIT_CRASH / WRITE_STALL fault inside the
        write-transaction phase machinery (runtime/txn.py).  `key` is
        "<phase>:<txn_id>" with phase in intent|commit|ack, so a rule armed
        with task_id "commit:" crashes every txn exactly at the
        staged-but-uncommitted boundary (prefix match).  COMMIT_CRASH
        raises InjectedCommitCrash — the txn layer re-raises WITHOUT
        aborting, and the coordinator treats it as a hard kill, leaving
        exactly the journal/connector state a real crash would.
        WRITE_STALL sleeps delay_ms, widening the commit race window so
        two-writer CAS conflicts are deterministic to provoke."""
        rule = self._take(key, ("COMMIT_CRASH", "WRITE_STALL"))
        if rule is None:
            return
        if rule.mode == "COMMIT_CRASH":
            raise InjectedCommitCrash(f"injected commit crash at {key}")
        if rule.delay_ms:
            sleep(rule.delay_ms / 1000.0)

    def record_fired(self, mode: str, task_id: str) -> None:
        """Observability entry for faults applied outside _take (e.g.
        MEMORY_PRESSURE, consumed at arm time by the worker handler)."""
        with self._lock:
            self.fired.append((mode, task_id))


class InjectedCompileFailure(RuntimeError):
    """An armed COMPILE_FAIL fault, raised inside a compile-service build.

    The only build failure a query may survive by falling back: any other
    error from a kernel build is a fault of the port and goes to the query
    (exec/compilesvc.py, exec/compiler.py `_kernel_ready`)."""


class InjectedCommitCrash(RuntimeError):
    """A simulated hard coordinator death at a write-txn phase boundary.

    Distinct from ordinary statement failures on purpose: the txn layer
    must NOT abort (a real crash cleans nothing up), and the coordinator
    must swallow it like kill() — no terminal journal record, no done
    event — so restart/adoption replay is exercised for real."""
