"""Flight recorder: a process-global, lock-cheap, bounded ring buffer of
structured runtime events — the always-on black box the post-mortem plane
(coordinator postmortem bundles, scripts/postmortem_report.py) reads back
after a failure or anomaly.

Reference analogue: the engine's enriched QueryEvents / EventListener
machinery (PAPER.md) records what happened per query; production clusters
additionally keep low-level scheduler/exchange traces for post-incident
forensics.  Here one ring serves both: every actor in the process — the
coordinator's dispatch/retry/steal paths, worker task lifecycles, memory
and disk lease transitions, the compile service, the spooled exchange —
emits small dict events stamped with query id, task id, trace id, wall
AND monotonic time, plus a `node` label attributing the event to the
emitting actor (a worker URL, `worker:{port}` pool name, the coordinator
URL, or a subsystem label like `compilesvc`).

Design constraints:

- **Lock-cheap.** One short critical section per event: bump a sequence,
  overwrite one preallocated slot, advance the cursor.  No allocation
  proportional to ring size on the hot path; metric increments happen
  outside the lock.
- **Bounded + overflow-visible.** The ring holds `ring_size` events;
  older events are overwritten, counted in `dropped` and the
  `trino_tpu_flightrecorder_dropped_total` counter so a too-small ring is
  a visible operational signal, never silent amnesia.
- **Process-global.** In-process test clusters (testing/runner.py) share
  one ring across the coordinator and every worker; the `node` field is
  what keeps per-node attribution honest, and the HTTP endpoints
  (`GET /v1/flightrecorder` on coordinator and workers) filter on it so
  each node serves only its own lane.

Config: `flightrecorder.ring-size` / `flightrecorder.enabled`
(runtime/config.py) feed `configure()`; `enabled=false` turns `record()`
into a near-no-op (one attribute read).

Partition-tolerance events (runtime/health.py, runtime/worker.py):
`link_state` marks a (consumer, producer) exchange link changing grade —
emitted by the consumer when its LinkHealth scorer regrades, and by the
coordinator when a heartbeat-folded matrix row changes, so a post-mortem
can line the two vantages up; `hedged_fetch` records each hedge race's
outcome (won / lost / failed) with the reason the hedge launched
(hedge_delay, breaker_open, primary_failed).
"""

from __future__ import annotations

import threading
import time
from typing import Iterable, Optional

from . import metrics as _metrics

__all__ = [
    "FlightRecorder",
    "RECORDER",
    "record",
    "snapshot",
    "configure",
    "stats",
    "DEFAULT_RING_SIZE",
]

# registered in the GLOBAL registry at import so every node's /metrics
# exposition carries the HELP text (scripts/metrics_lint.py contract)
EVENTS_TOTAL = _metrics.GLOBAL.counter(
    "trino_tpu_flightrecorder_events_total",
    "Flight-recorder events recorded, by event kind",
    ("kind",),
)
DROPPED_TOTAL = _metrics.GLOBAL.counter(
    "trino_tpu_flightrecorder_dropped_total",
    "Flight-recorder events overwritten by ring overflow (grow "
    "flightrecorder.ring-size if this moves in steady state)",
)

DEFAULT_RING_SIZE = 4096


class FlightRecorder:
    """Bounded ring of event dicts.  All methods are thread-safe."""

    def __init__(
        self, ring_size: int = DEFAULT_RING_SIZE, enabled: bool = True
    ):
        self._lock = threading.Lock()
        self._enabled = bool(enabled)
        self._size = 0
        self.configure(ring_size=ring_size)

    # --------------------------------------------------------------- config
    def configure(
        self,
        ring_size: Optional[int] = None,
        enabled: Optional[bool] = None,
    ) -> None:
        """Resize (drops history) and/or flip recording on or off."""
        with self._lock:
            if ring_size is not None and int(ring_size) != self._size:
                self._size = max(16, int(ring_size))
                self._ring: list = [None] * self._size
                self._next = 0
                self._seq = 0
                self._dropped = 0
            if enabled is not None:
                self._enabled = bool(enabled)

    @property
    def enabled(self) -> bool:
        return self._enabled

    # --------------------------------------------------------------- record
    def record(
        self,
        kind: str,
        node: str = "",
        query_id: Optional[str] = None,
        task_id: Optional[str] = None,
        trace_id: Optional[str] = None,
        **detail,
    ) -> None:
        """Emit one event.  `detail` kwargs land under the event's
        ``detail`` key — keep them small and JSON-serializable."""
        if not self._enabled:
            return
        ev = {
            "seq": 0,  # assigned under the lock
            "kind": kind,
            "node": node,
            "query_id": query_id,
            "task_id": task_id,
            "trace_id": trace_id,
            "ts": time.time(),
            "mono": time.monotonic(),
        }
        if detail:
            ev["detail"] = detail
        dropped = False
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            if self._ring[self._next] is not None:
                self._dropped += 1
                dropped = True
            self._ring[self._next] = ev
            self._next = (self._next + 1) % self._size
        EVENTS_TOTAL.labels(kind).inc()
        if dropped:
            DROPPED_TOTAL.inc()

    # ------------------------------------------------------------- snapshot
    def snapshot(
        self,
        query_id: Optional[str] = None,
        kinds: Optional[Iterable[str]] = None,
        nodes: Optional[Iterable[str]] = None,
        limit: Optional[int] = None,
    ) -> list[dict]:
        """Events in emission (seq) order, oldest first, optionally
        filtered.  `query_id` matches the event's own query id OR a task
        id carrying the `{query_id}_...` prefix — worker-side events often
        know only their task."""
        with self._lock:
            buf = [e for e in self._ring if e is not None]
        buf.sort(key=lambda e: e["seq"])
        if query_id:
            pfx = query_id + "_"

            def _match(e: dict) -> bool:
                return e.get("query_id") == query_id or (
                    e.get("task_id") or ""
                ).startswith(pfx)

            buf = [e for e in buf if _match(e)]
        if kinds is not None:
            ks = set(kinds)
            buf = [e for e in buf if e["kind"] in ks]
        if nodes is not None:
            ns = set(nodes)
            buf = [e for e in buf if e.get("node") in ns]
        if limit is not None and limit >= 0:
            buf = buf[-limit:]
        return buf

    def stats(self) -> dict:
        with self._lock:
            held = sum(1 for e in self._ring if e is not None)
            return {
                "enabled": self._enabled,
                "ring_size": self._size,
                "events": self._seq,
                "held": held,
                "dropped": self._dropped,
            }


# the process-global ring every actor shares (see module docstring)
RECORDER = FlightRecorder()


def record(kind: str, **kw) -> None:
    RECORDER.record(kind, **kw)


def snapshot(**kw) -> list[dict]:
    return RECORDER.snapshot(**kw)


def configure(**kw) -> None:
    RECORDER.configure(**kw)


def stats() -> dict:
    return RECORDER.stats()
