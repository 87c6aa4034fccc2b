"""Compile/execute attribution ledger.

The port runs every plan eagerly (exec/compiler.py): the only programs it
compiles at run time are kernel 2's per-recipe CUDA sources, which NVRTC
builds at a recipe's first use on a card (ops/cuda/fused_codegen.py; the
static kernels 1 and 3-5 are built once by nvcc before any query).  So a
"compile" here is one NVRTC build, named by its generated kernel, and an
"execute" is one run of a plan fragment, named by `signature_of(plan)`.
Nothing measures flops or bytes per signature (the reference reads them
from XLA's cost analysis, which has no counterpart here), so the roofline
fold of the coordinator has nothing to divide and the EXPLAIN ANALYZE
`-- compile:` footer lists NVRTC builds only.

This module is the process-global ledger behind that attribution:

  - record_compile(sig, ...) for every NVRTC build (cache "miss") or cubin
    read from the disk cache (cache "hit"); disk_cache() for that cache's
    footprint (utils/compilecache.py);
  - record_execute(sig, seconds) per fragment run;
  - GLOBAL histograms ``trino_tpu_compile_seconds`` /
    ``trino_tpu_execute_seconds`` and the
    ``trino_tpu_persistent_cache_events_total{result}`` counter ride the
    same /metrics expositions as every other metric family.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Optional

from .metrics import GLOBAL as _METRICS

__all__ = [
    "CompileProfiler", "PROFILER", "signature_of",
]

# NVRTC builds of one recipe take tens of milliseconds to seconds
_COMPILE_SECONDS = _METRICS.histogram(
    "trino_tpu_compile_seconds",
    "NVRTC compile wall seconds per generated kernel (kernel 2 recipes)",
    buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 15.0, 60.0, 120.0, 300.0),
)
_EXECUTE_SECONDS = _METRICS.histogram(
    "trino_tpu_execute_seconds",
    "Execute wall seconds per run of a plan fragment",
    buckets=(0.001, 0.005, 0.025, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0),
)
_PCACHE_EVENTS = _METRICS.counter(
    "trino_tpu_persistent_cache_events_total",
    "Kernel compile-cache outcomes (hit: cubin read from the NVRTC disk"
    " cache; miss: NVRTC compiled the recipe and wrote its cubin;"
    " uncached: compiled without the disk cache)",
    ("result",),
)


def signature_of(plan, caps: Optional[dict] = None) -> str:
    """Stable human-readable name for a plan fragment (its "signature").

    ``Join+41n#1f2ab3@c9`` reads as: root operator, node count, plan
    structure hash, capacity-tier hash.  The structure hash uses the plan's
    JSON serde (stable across processes — ``hash()`` is salted per run),
    and the ``@caps`` suffix distinguishes the capacity tiers one plan ran
    at."""
    try:
        from ..plan.nodes import walk

        nodes = list(walk(plan))
        root = type(plan).__name__
        n = len(nodes)
    except Exception:
        root, n = type(plan).__name__, 0
    try:
        from ..plan.serde import plan_to_json

        structure = hashlib.sha1(plan_to_json(plan).encode()).hexdigest()[:6]
    except Exception:
        structure = hashlib.sha1(repr(plan).encode()).hexdigest()[:6]
    sig = f"{root}+{n}n#{structure}"
    if caps:
        tiers = repr(tuple(sorted((int(k), int(v)) for k, v in caps.items())))
        sig += "@" + hashlib.sha1(tiers.encode()).hexdigest()[:4]
    return sig


class CompileProfiler:
    """Thread-safe per-signature compile/execute ledger.

    One process-global instance (``PROFILER``) serves every LocalExecutor
    in the process — worker task threads record concurrently.  snapshot()
    returns plain JSON-able dicts for /v1/query records and reports."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._sigs: dict[str, dict] = {}

    def _entry(self, sig: str) -> dict:
        e = self._sigs.get(sig)
        if e is None:
            e = self._sigs[sig] = {
                "compiles": 0, "compile_s": 0.0,
                "executes": 0, "execute_s": 0.0,
                "cache": {"hit": 0, "miss": 0, "uncached": 0},
                "flops": None, "bytes_accessed": None,
                # compile resilience plane (exec/compilesvc.py): fallback
                # executions attributed apart from compiled ones, so the
                # perf gate can tell "slow because degraded" from "slow
                # because regressed"
                "fallbacks": {}, "fallback_executes": 0,
                "fallback_execute_s": 0.0, "timeouts": 0,
            }
        return e

    def record_compile(
        self,
        sig: str,
        seconds: float,
        cache_result: str = "uncached",
        cost: Optional[dict] = None,
    ) -> None:
        _COMPILE_SECONDS.observe(seconds)
        if cache_result not in ("hit", "miss", "uncached"):
            cache_result = "uncached"
        _PCACHE_EVENTS.labels(cache_result).inc()
        with self._lock:
            e = self._entry(sig)
            e["compiles"] += 1
            e["compile_s"] += float(seconds)
            e["cache"][cache_result] += 1
            if cost:
                if cost.get("flops") is not None:
                    e["flops"] = cost["flops"]
                if cost.get("bytes_accessed") is not None:
                    e["bytes_accessed"] = cost["bytes_accessed"]

    def record_execute(
        self, sig: str, seconds: float, fallback: bool = False
    ) -> None:
        _EXECUTE_SECONDS.observe(seconds)
        with self._lock:
            e = self._entry(sig)
            if fallback:
                e["fallback_executes"] += 1
                e["fallback_execute_s"] += float(seconds)
            else:
                e["executes"] += 1
                e["execute_s"] += float(seconds)

    def record_fallback(self, sig: str, reason: str) -> None:
        """A query executed this signature via the eager fallback path
        instead of a compiled program (reason: compile_wait /
        compile_timeout / compile_error / breaker_open)."""
        with self._lock:
            e = self._entry(sig)
            e["fallbacks"][reason] = e["fallbacks"].get(reason, 0) + 1

    def record_compile_timeout(self, sig: str) -> None:
        """A compile for this signature blew past compile_deadline_s."""
        with self._lock:
            self._entry(sig)["timeouts"] += 1

    def record_warm(self) -> None:
        """A startup-warming replay compiled (or re-validated) a
        signature ahead of traffic; counted on the persistent-cache
        event surface so restarts' pre-paid compiles are visible."""
        _PCACHE_EVENTS.labels("warm").inc()

    def snapshot(self, sig: Optional[str] = None):
        """Deep copy: one signature's record, or {sig: record} for all."""
        with self._lock:
            if sig is not None:
                e = self._sigs.get(sig)
                return None if e is None else _copy(e)
            return {s: _copy(e) for s, e in self._sigs.items()}

    def disk_cache(self) -> dict:
        """Footprint of kernel 2's cubin cache on disk (utils/compilecache.py):
        {"dir", "entries", "bytes"}, walked when asked (the EXPLAIN ANALYZE
        `-- compile cache:` line)."""
        from .compilecache import cache_stats

        return cache_stats()

    def cache_counts(self) -> dict:
        """Aggregate persistent-cache outcomes across all signatures."""
        with self._lock:
            total = {"hit": 0, "miss": 0, "uncached": 0}
            for e in self._sigs.values():
                for k in total:
                    total[k] += e["cache"][k]
            return total

    def reset(self) -> None:
        with self._lock:
            self._sigs.clear()


def _copy(e: dict) -> dict:
    out = dict(e)
    out["cache"] = dict(e["cache"])
    out["fallbacks"] = dict(e.get("fallbacks") or {})
    return out


# process-global ledger: every LocalExecutor run and NVRTC build records here
PROFILER = CompileProfiler()
