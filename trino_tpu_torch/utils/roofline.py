"""Device roofline registry: what memory bandwidth is this node's device
capable of, so achieved GB/s (bytes over execute wall) can be expressed as
a percentage of the roofline.

Two sources, chosen by platform:

- **CUDA: a static table by card name.**  Datasheet peak memory bandwidth
  per card, matched by substring against ``torch.cuda.get_device_name()``.
- **CPU: calibrated once at boot** via a small STREAM-triad probe
  (``a = b + s*c`` over arrays sized well past L3), cached on disk so
  repeated processes on the same host skip the probe.  Cache path:
  ``$TRINO_TPU_ROOFLINE_CACHE`` or ``<tmpdir>/trino_tpu_roofline.json``.

Everything is lazy — nothing touches the card or runs the probe at import —
and every path degrades to a conservative default rather than raising:
the roofline is telemetry, never a query dependency.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from typing import Optional

from . import metrics as _metrics

__all__ = [
    "GPU_HBM_GBPS",
    "DEFAULT_CPU_GBPS",
    "calibrate_cpu_gbps",
    "device_roofline",
    "pct_of_roofline",
    "observe_signature_gbps",
    "reset_cache",
]

# achieved memory bandwidth per executed fragment signature — the live
# histogram behind the EXPLAIN ANALYZE %-of-roofline footer
SIGNATURE_GBPS = _metrics.GLOBAL.histogram(
    "trino_tpu_signature_gb_per_sec",
    "Achieved memory bandwidth (GB/s) per executed plan fragment "
    "signature: bytes accessed over execute wall",
    buckets=(0.1, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
             250.0, 500.0, 1000.0, 2500.0),
)

# datasheet peak memory bandwidth (GB/s) per card, keyed by a substring of
# torch.cuda.get_device_name(); first match wins.  The H100 SXM5 80GB
# (nvidia-smi: "NVIDIA H100 80GB HBM3", power limit 700.00 W) has 3.35 TB/s
# of HBM3.
GPU_HBM_GBPS: tuple[tuple[str, float], ...] = (
    ("H100 80GB HBM3", 3350.0),
)
# a CUDA card the table does not name: the H100's figure, flagged by
# `source` = "default"
DEFAULT_GPU_GBPS = 3350.0

# conservative DDR fallback when the probe fails
DEFAULT_CPU_GBPS = 10.0

_lock = threading.Lock()
_cached: Optional[dict] = None


def _cache_path() -> str:
    return os.environ.get(
        "TRINO_TPU_ROOFLINE_CACHE",
        os.path.join(tempfile.gettempdir(), "trino_tpu_roofline.json"),
    )


def calibrate_cpu_gbps(
    cache_path: Optional[str] = None, force: bool = False
) -> float:
    """STREAM-triad sustained bandwidth in GB/s, cached on disk.

    The probe is deliberately small (3 x 2M float64 = 48 MB working set,
    best of 3 reps, well under 100 ms on anything modern) — it measures
    the memory system, not the scheduler, and boot must not stall."""
    path = cache_path or _cache_path()
    if not force:
        try:
            with open(path) as f:
                saved = json.load(f)
            v = float(saved["cpu_gbps"])
            if v > 0:
                return v
        except (OSError, KeyError, ValueError, TypeError):
            pass
    gbps = _stream_triad_gbps()
    try:
        with open(path, "w") as f:
            json.dump({"cpu_gbps": round(gbps, 3), "ts": time.time()}, f)
    except OSError:
        pass  # read-only tmpdir: recalibrate next boot
    return gbps


def _stream_triad_gbps() -> float:
    try:
        import numpy as np
    except Exception:
        return DEFAULT_CPU_GBPS
    n = 2_000_000
    try:
        b = np.random.default_rng(0).random(n)
        c = np.random.default_rng(1).random(n)
        a = np.empty(n)
        best = 0.0
        for _ in range(3):
            t0 = time.perf_counter()
            np.add(b, 0.42 * c, out=a)
            dt = time.perf_counter() - t0
            if dt > 0:
                # STREAM triad convention: 24 bytes per element
                # (read b, read c, write a)
                best = max(best, 24.0 * n / dt / 1e9)
        return best or DEFAULT_CPU_GBPS
    except Exception:
        return DEFAULT_CPU_GBPS


def device_roofline(cache_path: Optional[str] = None) -> dict:
    """``{platform, device_kind, hbm_gbps, source}`` for this process's
    default device: the first CUDA card when there is one, else the CPU.
    Computed once per process (first caller pays the CPU probe unless the
    disk cache answers)."""
    global _cached
    with _lock:
        if _cached is not None:
            return dict(_cached)
    platform, kind = "cpu", "cpu"
    try:
        import torch

        if torch.cuda.is_available():
            platform, kind = "gpu", str(torch.cuda.get_device_name(0))
    except Exception:
        pass
    if platform == "gpu":
        match = next((v for frag, v in GPU_HBM_GBPS if frag in kind), None)
        info = {
            "platform": platform,
            "device_kind": kind,
            "hbm_gbps": match if match is not None else DEFAULT_GPU_GBPS,
            "source": "table" if match is not None else "default",
        }
    else:
        gbps = calibrate_cpu_gbps(cache_path=cache_path)
        info = {
            "platform": platform,
            "device_kind": kind,
            "hbm_gbps": round(gbps, 3),
            "source": "calibrated" if gbps != DEFAULT_CPU_GBPS else "default",
        }
    with _lock:
        _cached = info
    return dict(info)


def pct_of_roofline(gbps: float) -> float:
    """Achieved GB/s as a percentage of this device's roofline."""
    peak = device_roofline().get("hbm_gbps") or 0.0
    if peak <= 0:
        return 0.0
    return 100.0 * float(gbps) / peak


def observe_signature_gbps(gbps: float) -> None:
    SIGNATURE_GBPS.observe(float(gbps))


def reset_cache() -> None:
    """Forget the per-process memo (tests exercising the disk cache)."""
    global _cached
    with _lock:
        _cached = None
