"""Data-plane kernel policy and dispatch accounting.

The CUDA data-plane kernels (ops/cuda/segreduce.py, ops/cuda/fused.py,
ops/cuda/hashagg.py, ops/cuda/hashjoin.py, ops/cuda/topk.py) replace
operator-at-a-time hot paths (ops/relops.py) when a static gate says the
shape fits.  This module is the one place that decision is configured
and observed:

  * KernelPolicy — per-statement knobs (runtime/session.py properties
    `data_plane_kernels`, `hash_agg_kernel_limit`, `hash_join_kernel_limit`),
    re-applied by the engine before each statement.
  * record_dispatch() — increments
    trino_tpu_torch_kernel_dispatch_total{op,impl} and,
    while a plan trace is active, appends the event to that trace's capture.
    The port runs eagerly, so every execution of a plan records its
    dispatches.
  * events_for(plan) — the captured events of the last trace of `plan`
    (plans are frozen dataclasses, so they key a bounded dict directly).

op values: segment_reduce | fused_pipeline | group_by | join | topn, and
host_pass: one pass of a nested-value function (ops/expr.py) over distinct
values or array elements on the host, its detail the number of values.

impl values: "cuda" = the hand-written CUDA kernel was launched; "torch" =
the kernel's plain PyTorch version ran, which happens only for tensors that
live on the CPU; "sort" = a static gate chose the sort-based path (kernels
off, keys the hash table cannot carry, a TopN too small or too long for
radix select); "fallback" = the hash table's capacity tier is past the
session limit (hash_agg_kernel_limit / hash_join_kernel_limit), so the
sort path runs; "host" = a host_pass.

The hash limits default to the card's, not the reference's VMEM table
(2048): 2^24 keys is a 2^25-slot table, under 1 GiB for 6-word keys.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

from ..utils import metrics as _metrics

__all__ = [
    "HASH_KERNEL_LIMIT", "KernelPolicy", "get_policy", "set_policy", "policy_key", "impl_for",
    "record_dispatch", "begin_capture", "end_capture", "remember",
    "events_for",
]


HASH_KERNEL_LIMIT = 1 << 24


@dataclass(frozen=True)
class KernelPolicy:
    enabled: bool = True  # master kill switch (data_plane_kernels)
    hash_agg_max_groups: int = HASH_KERNEL_LIMIT  # group cap above which group-by sorts
    hash_join_max_build: int = HASH_KERNEL_LIMIT  # build rows above which joins sort


_DEFAULT = KernelPolicy()
_POLICY = _DEFAULT

_DISPATCH = _metrics.GLOBAL.counter(
    "trino_tpu_torch_kernel_dispatch_total",
    "Data-plane kernel selections at plan-trace time, by relational op "
    "(segment_reduce | fused_pipeline | group_by | join | topn) and "
    "implementation (cuda = CUDA kernel launched, torch = plain PyTorch "
    "version on CPU tensors, sort = sort-based path, fallback = sort path "
    "because the hash capacity is past the session limit)",
    ("op", "impl"),
)


def get_policy() -> KernelPolicy:
    return _POLICY


def set_policy(policy: KernelPolicy) -> None:
    global _POLICY
    _POLICY = policy


def policy_key() -> tuple:
    """Fingerprint of the kernel choice, for caches of plans: the
    prepared-statement plan cache (runtime/fastpath.py) keys its entries
    with it, so a plan cached under one policy is never served under
    another.  topk.FORCE rides along: it too changes which path a TopN
    takes."""
    from .cuda import topk

    p = _POLICY
    return (p.enabled, p.hash_agg_max_groups, p.hash_join_max_build, topk.FORCE)


def impl_for(device) -> str:
    """Dispatch label for tensors on `device`: the CUDA kernel on the card,
    its plain PyTorch version on the CPU."""
    import torch

    return "cuda" if torch.device(device).type == "cuda" else "torch"


# --------------------------------------------------------- event capture

_TLS = threading.local()
_EVENTS_LOCK = threading.Lock()
_EVENTS: dict = {}  # plan -> tuple[(op, impl, detail)]
_EVENTS_MAX = 256


def record_dispatch(op: str, impl: str, detail: str = "") -> None:
    _DISPATCH.labels(op=op, impl=impl).inc()
    cap = getattr(_TLS, "capture", None)
    if cap is not None:
        cap.append((op, impl, detail))


def begin_capture() -> list:
    cap: list = []
    _TLS.capture = cap
    return cap


def end_capture() -> None:
    _TLS.capture = None


def remember(plan, events) -> None:
    """Associate a trace's dispatch events with its plan (last trace wins —
    the retry loop's final capacities decide the kernels that actually ran)."""
    try:
        hash(plan)
    except TypeError:
        return
    with _EVENTS_LOCK:
        if len(_EVENTS) >= _EVENTS_MAX:
            _EVENTS.clear()
        _EVENTS[plan] = tuple(events)


def events_for(plan) -> tuple:
    try:
        hash(plan)
    except TypeError:
        return ()
    with _EVENTS_LOCK:
        return _EVENTS.get(plan, ())
