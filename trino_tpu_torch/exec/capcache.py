"""Persistent learned-capacity cache.

The executor's capacity protocol (exec/compiler.py) sizes every stateful
node (join expansion, group-by, TopN candidates, Compact points) and re-runs
at the next power-of-two tier on overflow, sending a hash join whose table
overflowed to the sort path.  In-process, `LocalExecutor._learned_caps`
remembers the converged tiers per plan; this module persists them to disk,
keyed by a stable text fingerprint of the plan (plan/serde.py) and the input
pages' capacities, so a FRESH process starts at the converged tiers and its
first run re-runs nothing (the reference's exec/capcache.py, read and written
at the same two points of its executor).

What is stored per key: the capacity of every sized node and the joins sent
to the sort path.  The executor's write generations are process-local and
are not stored: a write that changes a table's size changes its input
capacity, and so the key.  A stale entry is harmless (a tier too small
re-enters the overflow-retry path, which stores the corrected tiers); a
partial one — fewer sized nodes than the plan has now, or a malformed value —
is never trusted.

Where: `TRINO_TPU_TORCH_CAPS_CACHE` names the file (any device; `off` turns
the cache off).  Unset, executors on a card use
`trino_tpu_torch/build/caps_cache.json` (`build/` is in .gitignore; delete
the file to clear the cache) and executors on the CPU keep their tiers in
memory only, so a test run writes nothing into the checkout and no test's
first run depends on an earlier run's tiers.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from pathlib import Path
from typing import Optional

from ..utils.metrics import GLOBAL as _METRICS

__all__ = ["cache_path", "load_caps", "store_caps", "DEFAULT_PATH"]

_CAPS_LOOKUPS = _METRICS.counter(
    "trino_tpu_caps_cache_lookups_total",
    "Persistent learned-capacity cache lookups",
    ("result",),
)

ENV = "TRINO_TPU_TORCH_CAPS_CACHE"
DEFAULT_PATH = Path(__file__).resolve().parents[1] / "build" / "caps_cache.json"
_MAX_ENTRIES = 1024
_LOCK = threading.Lock()
_mem: dict[str, dict] = {}  # file path -> its contents, loaded once per process


def cache_path(device) -> Optional[str]:
    """The cache file an executor on `device` uses, or None (no cache)."""
    env = os.environ.get(ENV)
    if env == "off":
        return None
    if env:
        return env
    return str(DEFAULT_PATH) if getattr(device, "type", str(device)) == "cuda" else None


def _key(plan, inputs: dict) -> str:
    from ..plan.serde import plan_to_json

    shapes = sorted((k, int(p.capacity)) for k, p in inputs.items())
    text = plan_to_json(plan) + "|" + repr(shapes)
    return hashlib.sha1(text.encode()).hexdigest()[:24]


def _load_file(path: str) -> dict:
    mem = _mem.get(path)
    if mem is None:
        try:
            with open(path) as f:
                mem = json.load(f)
            if not isinstance(mem, dict):
                mem = {}
        except (OSError, ValueError):
            mem = {}
        _mem[path] = mem
    return mem


def _decode(entry) -> Optional[tuple[dict[int, int], frozenset]]:
    try:
        caps = {int(k): int(v) for k, v in entry["caps"].items()}
        joins = frozenset(int(j) for j in entry["sort_joins"])
    except (KeyError, TypeError, ValueError, AttributeError):
        return None
    if any(v < 1 for v in caps.values()):
        return None
    return caps, joins


def load_caps(plan, inputs: dict, device, sized) -> Optional[tuple[dict[int, int], frozenset]]:
    """(caps, sort_joins) stored for (plan, input capacities), or None.
    `sized` are the node ids the executor sizes today: an entry that does
    not cover every one of them is not trusted."""
    path = cache_path(device)
    if path is None:
        return None
    try:
        key = _key(plan, inputs)
    except Exception:  # a plan the serde cannot write: no persistence, no failure
        return None
    with _LOCK:
        entry = _load_file(path).get(key)
    got = None if entry is None else _decode(entry)
    if got is not None and not set(got[0]) >= set(sized):
        got = None
    _CAPS_LOOKUPS.labels("miss" if got is None else "hit").inc()
    return got


def store_caps(plan, inputs: dict, device, caps: dict[int, int], sort_joins) -> None:
    path = cache_path(device)
    if path is None:
        return
    try:
        key = _key(plan, inputs)
    except Exception:
        return
    entry = {"caps": {str(k): int(v) for k, v in caps.items()},
             "sort_joins": sorted(int(j) for j in sort_joins)}
    with _LOCK:
        mem = _load_file(path)
        if mem.get(key) == entry:
            return
        mem[key] = entry
        if len(mem) > _MAX_ENTRIES:  # drop the oldest half (insertion order)
            for k in list(mem)[: len(mem) - _MAX_ENTRIES // 2]:
                del mem[k]
        try:
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
            with open(tmp, "w") as f:
                json.dump(mem, f, indent=0, sort_keys=True)
            os.replace(tmp, path)
        except OSError:
            pass  # a read-only checkout: the in-memory copy still serves
