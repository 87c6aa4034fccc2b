"""Per-node time-series plane: a bounded in-process ring TSDB plus the
~1 s sampler thread that feeds it — the always-on utilization telemetry
the observatory endpoints (`GET /v1/timeseries` on both roles), the
coordinator's federated cluster view, and the post-mortem bundles read.

Reference analogue: the engine's worker stats heartbeats + the Web UI's
cluster memory/CPU charts (PAPER.md) — every node continuously reports
its own resource counters over time, and the coordinator folds them into
one cluster picture.  Here the storage is deliberately tiny: one
fixed-capacity ring of ``(ts, value)`` pairs per ``(node, series)`` lane,
zero dependencies, drop-oldest.

Design constraints (mirrors utils/flightrecorder.py):

- **Lock-cheap.** One short critical section per point: append to a
  preallocated-capacity deque.  Metric increments happen outside the
  lock.
- **Bounded + overflow-visible.** Each lane holds ``ring_size`` points;
  older points fall off the back, counted in ``dropped`` and
  ``trino_tpu_timeseries_points_dropped_total`` — a too-small ring is a
  visible operational signal, never silent amnesia.
- **Process-global.** In-process test clusters (testing/runner.py) share
  one store across the coordinator and every worker; the ``node`` lane
  key keeps attribution honest, and each node's ``/v1/timeseries``
  serves only its own lanes (the coordinator's federated view re-merges
  every node).

Sampled series (names are shared vocabulary across roles; a role only
records the ones it can observe):

  cpu_s                  process CPU seconds consumed this tick (delta)
  rss_bytes              current resident set size (``/proc/self/statm``)
  mem_reserved_bytes     memory-pool reserved bytes
  mem_capacity_bytes     memory-pool capacity bytes
  disk_reserved_bytes    disk-pool reserved bytes
  split_backlog          splits queued but not yet completed
  compile_inflight       compiles currently running
  exchange_in_bytes      exchange bytes fetched this tick (delta)
  exchange_out_bytes     exchange bytes served this tick (delta)
  links_impaired         exchange links graded DEGRADED/QUARANTINED

Config: ``timeseries.ring-size`` / ``timeseries.sample-interval-s`` /
``timeseries.enabled`` (runtime/config.py) feed ``configure()``;
``enabled=false`` turns ``record()`` into a near-no-op and keeps
samplers from starting.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Callable, Iterable, Optional

from . import metrics as _metrics

__all__ = [
    "TimeSeriesStore",
    "Sampler",
    "STORE",
    "record",
    "snapshot",
    "configure",
    "stats",
    "cpu_seconds",
    "current_rss_bytes",
    "peak_rss_bytes",
    "DEFAULT_RING_SIZE",
    "DEFAULT_SAMPLE_INTERVAL_S",
]

# registered in the GLOBAL registry at import so every node's /metrics
# exposition carries the HELP text (scripts/metrics_lint.py contract)
POINTS_TOTAL = _metrics.GLOBAL.counter(
    "trino_tpu_timeseries_points_total",
    "Time-series points recorded, by series name",
    ("series",),
)
POINTS_DROPPED_TOTAL = _metrics.GLOBAL.counter(
    "trino_tpu_timeseries_points_dropped_total",
    "Time-series points dropped off the back of a full ring (grow "
    "timeseries.ring-size if this moves in steady state)",
)

DEFAULT_RING_SIZE = 512
DEFAULT_SAMPLE_INTERVAL_S = 1.0


def cpu_seconds() -> float:
    """Cumulative process CPU seconds (user + system)."""
    t = os.times()
    return float(t.user + t.system)


def current_rss_bytes() -> int:
    """CURRENT resident set size — reads ``/proc/self/statm`` so the
    value can go DOWN after memory is released (unlike ``ru_maxrss``,
    a lifetime high-water mark).  Falls back to the peak where /proc is
    absent (macOS), so callers always get a usable number."""
    try:
        with open("/proc/self/statm", "rb") as f:
            fields = f.read().split()
        return int(fields[1]) * (os.sysconf("SC_PAGE_SIZE") or 4096)
    except (OSError, IndexError, ValueError):
        return peak_rss_bytes()


def peak_rss_bytes() -> int:
    """Lifetime RSS high-water mark (``ru_maxrss``; KiB on Linux)."""
    try:
        import resource

        return int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * 1024
    except Exception:
        return 0


class TimeSeriesStore:
    """Bounded per-(node, series) rings of (ts, value).  Thread-safe."""

    def __init__(
        self,
        ring_size: int = DEFAULT_RING_SIZE,
        enabled: bool = True,
        sample_interval_s: float = DEFAULT_SAMPLE_INTERVAL_S,
    ):
        self._lock = threading.Lock()
        self._enabled = bool(enabled)
        self._size = max(16, int(ring_size))
        self._interval = max(0.05, float(sample_interval_s))
        self._lanes: dict[tuple[str, str], deque] = {}
        self._points = 0
        self._dropped = 0

    # --------------------------------------------------------------- config
    def configure(
        self,
        ring_size: Optional[int] = None,
        enabled: Optional[bool] = None,
        sample_interval_s: Optional[float] = None,
    ) -> None:
        """Resize (drops history) and/or flip recording on or off."""
        with self._lock:
            if ring_size is not None and int(ring_size) != self._size:
                self._size = max(16, int(ring_size))
                self._lanes = {}
                self._points = 0
                self._dropped = 0
            if enabled is not None:
                self._enabled = bool(enabled)
            if sample_interval_s is not None:
                self._interval = max(0.05, float(sample_interval_s))

    @property
    def enabled(self) -> bool:
        return self._enabled

    @property
    def sample_interval_s(self) -> float:
        return self._interval

    @property
    def ring_size(self) -> int:
        return self._size

    # --------------------------------------------------------------- record
    def record(
        self, node: str, series: str, value: float, ts: Optional[float] = None
    ) -> None:
        """Append one point to the (node, series) lane."""
        if not self._enabled:
            return
        if ts is None:
            ts = time.time()
        dropped = False
        with self._lock:
            lane = self._lanes.get((node, series))
            if lane is None:
                lane = self._lanes[(node, series)] = deque(maxlen=self._size)
            if len(lane) == self._size:
                self._dropped += 1
                dropped = True
            lane.append((float(ts), float(value)))
            self._points += 1
        POINTS_TOTAL.labels(series).inc()
        if dropped:
            POINTS_DROPPED_TOTAL.inc()

    # ------------------------------------------------------------- snapshot
    def snapshot(
        self,
        nodes: Optional[Iterable[str]] = None,
        series: Optional[Iterable[str]] = None,
        since: Optional[float] = None,
        limit: Optional[int] = None,
    ) -> dict:
        """``{node: {series: [[ts, value], ...]}}``, points oldest-first,
        optionally filtered to nodes / series names / ``ts > since`` /
        the newest ``limit`` points per lane."""
        ns = set(nodes) if nodes is not None else None
        ss = set(series) if series is not None else None
        with self._lock:
            lanes = {
                k: list(v)
                for k, v in self._lanes.items()
                if (ns is None or k[0] in ns)
                and (ss is None or k[1] in ss)
            }
        out: dict[str, dict[str, list]] = {}
        for (node, name), pts in sorted(lanes.items()):
            if since is not None:
                pts = [p for p in pts if p[0] > since]
            if limit is not None and limit >= 0:
                pts = pts[-limit:]
            out.setdefault(node, {})[name] = [[t, v] for t, v in pts]
        return out

    def stats(self) -> dict:
        with self._lock:
            return {
                "enabled": self._enabled,
                "ring_size": self._size,
                "sample_interval_s": self._interval,
                "lanes": len(self._lanes),
                "points": self._points,
                "dropped": self._dropped,
            }


class Sampler:
    """Daemon thread sampling a dict of named sources into the store
    every ``interval_s`` under one ``node`` lane key.

    ``sources`` maps series name -> zero-arg callable returning a number
    (or None to skip this tick).  Names listed in ``deltas`` are treated
    as cumulative counters: the sampler records ``max(0, cur - prev)``
    per tick, so the lane reads as per-interval throughput."""

    def __init__(
        self,
        node: str,
        sources: dict[str, Callable[[], Optional[float]]],
        deltas: Iterable[str] = (),
        store: Optional[TimeSeriesStore] = None,
        interval_s: Optional[float] = None,
    ):
        self.node = node
        self.sources = dict(sources)
        self.deltas = set(deltas)
        self.store = store if store is not None else STORE
        self._interval = interval_s
        self._prev: dict[str, float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.ticks = 0

    def sample_once(self, ts: Optional[float] = None) -> None:
        """One sampling pass — also the unit tests' synchronous entry."""
        if ts is None:
            ts = time.time()
        for name, fn in self.sources.items():
            try:
                v = fn()
            except Exception:
                continue  # a dying subsystem must not kill the sampler
            if v is None:
                continue
            v = float(v)
            if name in self.deltas:
                prev = self._prev.get(name)
                self._prev[name] = v
                if prev is None:
                    continue  # first tick establishes the baseline
                v = max(0.0, v - prev)
            self.store.record(self.node, name, v, ts=ts)
        self.ticks += 1

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.sample_once()
            iv = (
                self._interval
                if self._interval is not None
                else self.store.sample_interval_s
            )
            if self._stop.wait(iv):
                break

    def start(self) -> None:
        if not self.store.enabled or self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name=f"ts-sampler-{self.node}", daemon=True
        )
        self._thread.start()

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=timeout)


# the process-global store every node's sampler and endpoint shares
STORE = TimeSeriesStore()


def record(node: str, series: str, value: float, **kw) -> None:
    STORE.record(node, series, value, **kw)


def snapshot(**kw) -> dict:
    return STORE.snapshot(**kw)


def configure(**kw) -> None:
    STORE.configure(**kw)


def stats() -> dict:
    return STORE.stats()
