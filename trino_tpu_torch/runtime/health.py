"""Link-health scoring for the exchange plane.

The circuit breaker in runtime/failure.py sees the cluster from the
coordinator's vantage: one EWMA per worker, fed by heartbeat probes, with
a binary dispatchable verdict.  The failure modes that dominate at
multi-host scale are *gray* and *directional*: a producer that answers
the coordinator's heartbeats yet serves exchange pages at 1% speed
(GRAY_SLOW), or an asymmetric partition where coordinator→B is fine while
A→B exchange fetches black-hole (PARTITION).  Reference analogue: the
dispatcher-side failure detection + the FTE exchange treating the data
path, not the control path, as the availability-critical surface.

`LinkHealth` lives on each CONSUMER and scores every (consumer→producer)
link it fetches over — EWMA error rate, EWMA latency against the link's
own observed baseline, consecutive-failure ratchet — graded into

    HEALTHY   nominal: errors rare, latency near baseline
    DEGRADED  elevated error rate or latency drift; watch, keep using
    SUSPECT   sustained errors or an order-of-magnitude latency blow-up
              (the gray-failure grade: no hard errors required)
    DEAD      consecutive failures / error EWMA past the dead threshold;
              the link breaker is OPEN — fetches reroute to the hedge
              path and only half-open probes touch the link again

Workers ship `snapshot()` on /v1/info; the coordinator folds every
worker's view into a cluster LINK MATRIX (runtime/coordinator.py) — which
is what distinguishes "worker B died" (every row to B is DEAD *and* the
coordinator's own breaker fires) from "the A→B link is partitioned"
(A's row to B is DEAD while B answers heartbeats and every other row to
B stays HEALTHY).

`hedge_delay()` turns the link's success-latency history into the
launch-the-hedge threshold: a fetch still in flight past the history
quantile races a spool re-read of the producer's committed partition
(runtime/worker.py _fetch_source), first result wins via the existing
token idempotency.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional

from ..utils import metrics as _metrics

__all__ = [
    "LinkHealth", "HEALTHY", "DEGRADED", "SUSPECT", "DEAD",
    "LINK_TRANSITIONS", "HEDGED_FETCHES", "DEADLINE_ABORTS",
]

HEALTHY = "HEALTHY"
DEGRADED = "DEGRADED"
SUSPECT = "SUSPECT"
DEAD = "DEAD"

# registered in the GLOBAL registry at import so every node's /metrics
# exposition carries the HELP text (scripts/metrics_lint.py contract)
LINK_TRANSITIONS = _metrics.GLOBAL.counter(
    "trino_tpu_link_state_transitions_total",
    "Exchange link grade changes scored by the consumer-side EWMA "
    "LinkHealth tracker (runtime/health.py), by destination grade",
    ("to",),
)
HEDGED_FETCHES = _metrics.GLOBAL.counter(
    "trino_tpu_hedged_fetches_total",
    "Hedged exchange fetches by outcome: won = the spool hedge path "
    "produced the result first, lost = the primary HTTP fetch finished "
    "before the hedge, failed = both paths failed",
    ("outcome",),
)
DEADLINE_ABORTS = _metrics.GLOBAL.counter(
    "trino_tpu_link_deadline_aborts_total",
    "Exchange fetches aborted typed (EXCHANGE_UNREACHABLE) because the "
    "propagated query deadline left no remaining budget for another "
    "attempt on the link",
)

# floor for the latency baseline: loopback sub-millisecond samples must
# not make a few milliseconds of jitter look like a 10x blow-up
_BASELINE_FLOOR_S = 1e-3


class _Link:
    __slots__ = (
        "state", "error_ewma", "latency_ewma", "baseline",
        "consecutive_failures", "last_failure_at", "last_probe_at",
        "successes", "failures", "history",
    )

    def __init__(self, history_size: int):
        self.state = HEALTHY
        self.error_ewma = 0.0
        self.latency_ewma: Optional[float] = None
        self.baseline: Optional[float] = None
        self.consecutive_failures = 0
        self.last_failure_at = 0.0
        self.last_probe_at = 0.0
        self.successes = 0
        self.failures = 0
        # success latencies only — the hedge-delay quantile source
        self.history: deque = deque(maxlen=history_size)


class LinkHealth:
    """Per-(consumer→producer) exchange link scorer.  Thread-safe; the
    transition callback fires OUTSIDE the lock (it may take other locks —
    flight recorder, metrics)."""

    def __init__(
        self,
        alpha: float = 0.3,
        suspect_threshold: float = 0.25,
        dead_threshold: float = 0.75,
        dead_failures: int = 3,
        degraded_threshold: float = 0.05,
        latency_degraded_factor: float = 4.0,
        latency_suspect_factor: float = 16.0,
        probe_interval: float = 2.0,
        history_size: int = 64,
        clock: Callable[[], float] = time.monotonic,
        on_transition: Optional[Callable[[str, str, str], None]] = None,
    ):
        self.alpha = alpha
        self.suspect_threshold = suspect_threshold
        self.dead_threshold = dead_threshold
        self.dead_failures = dead_failures
        self.degraded_threshold = degraded_threshold
        self.latency_degraded_factor = latency_degraded_factor
        self.latency_suspect_factor = latency_suspect_factor
        self.probe_interval = probe_interval
        self.history_size = history_size
        self.clock = clock
        self.on_transition = on_transition
        self._links: dict[str, _Link] = {}
        self._lock = threading.Lock()

    # ---------------------------------------------------------------- record
    def record_success(self, producer: str, latency_s: float) -> None:
        with self._lock:
            ln = self._links.setdefault(producer, _Link(self.history_size))
            ln.successes += 1
            ln.consecutive_failures = 0
            ln.error_ewma *= 1.0 - self.alpha
            if ln.latency_ewma is None:
                ln.latency_ewma = latency_s
            else:
                ln.latency_ewma = (
                    (1.0 - self.alpha) * ln.latency_ewma
                    + self.alpha * latency_s
                )
            # baseline = best latency this link ever showed (floored):
            # grading compares the EWMA against it, so a gray-slow link is
            # judged by its OWN healthy history, not an absolute constant
            b = max(latency_s, _BASELINE_FLOOR_S)
            if ln.baseline is None or b < ln.baseline:
                ln.baseline = b
            ln.history.append(latency_s)
            ln.last_probe_at = self.clock()
            if ln.state == DEAD:
                # a successful half-open probe fully restores the link —
                # same contract as the worker breaker (failure.py)
                ln.error_ewma = 0.0
            trans = self._regrade(ln)
        self._fire(producer, trans)

    def record_failure(self, producer: str) -> None:
        with self._lock:
            ln = self._links.setdefault(producer, _Link(self.history_size))
            ln.failures += 1
            ln.consecutive_failures += 1
            ln.error_ewma = (1.0 - self.alpha) * ln.error_ewma + self.alpha
            now = self.clock()
            ln.last_failure_at = now
            ln.last_probe_at = now
            trans = self._regrade(ln)
        self._fire(producer, trans)

    def _regrade(self, ln: _Link) -> Optional[tuple[str, str]]:
        """Recompute the grade from the accrued signals (lock held)."""
        lat_ratio = 1.0
        if ln.baseline is not None and ln.latency_ewma is not None:
            lat_ratio = ln.latency_ewma / ln.baseline
        if (
            ln.consecutive_failures >= self.dead_failures
            or ln.error_ewma >= self.dead_threshold
        ):
            new = DEAD
        elif (
            ln.error_ewma >= self.suspect_threshold
            or lat_ratio >= self.latency_suspect_factor
        ):
            new = SUSPECT
        elif (
            ln.error_ewma >= self.degraded_threshold
            or lat_ratio >= self.latency_degraded_factor
        ):
            new = DEGRADED
        else:
            new = HEALTHY
        if new == ln.state:
            return None
        old, ln.state = ln.state, new
        return (old, new)

    def _fire(self, producer: str, trans: Optional[tuple[str, str]]) -> None:
        if trans is None:
            return
        old, new = trans
        LINK_TRANSITIONS.labels(new).inc()
        if self.on_transition is not None:
            self.on_transition(producer, old, new)

    # ----------------------------------------------------------------- query
    def state(self, producer: str) -> str:
        with self._lock:
            ln = self._links.get(producer)
            return ln.state if ln is not None else HEALTHY

    def is_usable(self, producer: str) -> bool:
        """Should a retry hit this producer again right now?  DEAD links
        are only usable inside their half-open probe window."""
        with self._lock:
            ln = self._links.get(producer)
            if ln is None or ln.state != DEAD:
                return True
            return self._probe_open(ln)

    def should_probe(self, producer: str) -> bool:
        """Half-open window: a DEAD link may take ONE probe fetch once
        probe_interval elapsed since the last attempt on it."""
        with self._lock:
            ln = self._links.get(producer)
            if ln is None or ln.state != DEAD:
                return True
            if not self._probe_open(ln):
                return False
            # stamp so concurrent fetch loops don't all probe at once
            ln.last_probe_at = self.clock()
            return True

    def _probe_open(self, ln: _Link) -> bool:
        anchor = max(ln.last_failure_at, ln.last_probe_at)
        return self.clock() - anchor >= self.probe_interval

    def hedge_delay(
        self,
        producer: str,
        quantile: float = 0.95,
        default: float = 0.25,
        multiplier: float = 3.0,
        floor: float = 0.05,
    ) -> float:
        """Seconds a fetch may stay in flight before the consumer launches
        the spool hedge: `multiplier` x the `quantile` of this link's
        success-latency history (the hedged-request literature's "defer to
        the tail" rule — Dean & Barroso, The Tail at Scale).  `default`
        until the link has enough history to know its tail."""
        with self._lock:
            ln = self._links.get(producer)
            if ln is None or len(ln.history) < 4:
                return default
            hist = sorted(ln.history)
        q = min(max(quantile, 0.0), 1.0)
        idx = min(len(hist) - 1, int(q * len(hist)))
        return max(floor, multiplier * hist[idx])

    # ------------------------------------------------------------- lifecycle
    def forget(self, producer: str) -> None:
        with self._lock:
            self._links.pop(producer, None)

    def reset(self) -> None:
        with self._lock:
            self._links.clear()

    def impaired(self) -> dict[str, str]:
        """producer -> grade, for every link not currently HEALTHY."""
        with self._lock:
            return {
                p: ln.state
                for p, ln in self._links.items()
                if ln.state != HEALTHY
            }

    def snapshot(self) -> dict[str, dict]:
        """Wire-shape view, shipped on the worker's /v1/info heartbeat and
        folded into the coordinator's cluster link matrix."""
        with self._lock:
            return {
                p: {
                    "state": ln.state,
                    "error_ewma": round(ln.error_ewma, 4),
                    "latency_ewma_ms": round(
                        (ln.latency_ewma or 0.0) * 1000.0, 3
                    ),
                    "baseline_ms": round((ln.baseline or 0.0) * 1000.0, 3),
                    "consecutive_failures": ln.consecutive_failures,
                    "samples": ln.successes + ln.failures,
                }
                for p, ln in self._links.items()
            }
