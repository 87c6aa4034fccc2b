"""Segmented reduction: every aggregate of a GROUP BY in one pass.

Port of trino_tpu/ops/pallas/segreduce.py (`fused_segment_reduce`, kernel
`_make_kernel`).  Given a segment id per row (from the dictionary-code fast
path in ops/relops.py), it computes EVERY requested SUM / COUNT / MIN / MAX
in one pass over the rows.

On CUDA tensors `fused_segment_reduce` launches the hand-written kernel in
csrc/segreduce.cu (or raises); on CPU tensors it runs `plain_segment_reduce`,
the plain PyTorch version of the same function.  The host decodes a call
once (`plan_launch`): the reductions sorted by kind, their validity masks
de-duplicated, the block table laid out and the grid sized so that no
block's 32-bit accumulator words can wrap; the kernel's output comes back
in the caller's order.  The plain version is used by
the CPU tests, by `device="cpu"` execution and by comparisons on the card —
never as a fallback for a CUDA tensor.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from .build import check_launch, load_library

__all__ = [
    "SegRed", "LaunchPlan", "plan_launch", "fused_segment_reduce",
    "plain_segment_reduce", "launches", "reset_launches",
]

# limits and kinds of csrc/segreduce.cu (SR_* and the kind enum there)
_MAX_REDS = 32
_THREADS = 256
_BLOCK_ROWS = 65536          # rows one block may reduce in its shared table
_SHARED_BYTES = 48 * 1024    # block tables above this take the global route
_BLOCKS_PER_SM = 8
_MAX_REPLICAS = 32
_ROWS_PER_THREAD = 4         # SR_ROWS: rows a thread takes per step
_KINDS = (
    "count",
    "sum_i64", "sum_i32", "sum_u8", "sum_f64",
    "min_i64", "min_i32", "min_u8", "min_f64",
    "max_i64", "max_i32", "max_u8", "max_f64",
)
_BASE = {torch.int64: "i64", torch.int32: "i32", torch.uint8: "u8", torch.bool: "u8",
         torch.float64: "f64"}
# 32-bit words of a kind's block-table entry per group: a count; an integer
# sum's 16-, 16- and 32-bit limb sums; one 64-bit word; one 32-bit word
_WORDS = {"count": 1, "i64": 2, "i32": 1, "u8": 1, "f64": 2}

# number of kernel launches made by the wrapper (one per _launch call)
_launches = 0


def launches() -> int:
    return _launches


def reset_launches() -> None:
    global _launches
    _launches = 0


@dataclass(frozen=True)
class SegRed:
    """One requested reduction over the segmented rows.

    op: 'sum' | 'min' | 'max' | 'count'  ('count' == sum of valid 0/1)
    values: [n] tensor (ignored for 'count')
    valid: optional [n] bool — rows where the argument is non-NULL and live.
    """

    op: str
    values: Optional[torch.Tensor]
    valid: Optional[torch.Tensor]


def _extreme(dtype: torch.dtype, is_min: bool):
    """Identity of min (is_min) / max over `dtype`."""
    if dtype.is_floating_point:
        return float("inf") if is_min else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if is_min else info.min


def _result_dtype(r: SegRed) -> torch.dtype:
    if r.op == "count":
        return torch.int64
    if r.op == "sum":
        return torch.float64 if r.values.dtype.is_floating_point else torch.int64
    return r.values.dtype


def fused_segment_reduce(
    seg: torch.Tensor,
    reds: Sequence[SegRed],
    num_segments: int,
    *,
    sorted_segments: bool = False,
    boundaries: Optional[tuple] = None,
) -> list[torch.Tensor]:
    """Compute every requested reduction in one fused pass.

    seg: [n] int32 segment ids in [0, num_segments); rows with seg >=
    num_segments (the caller's dead-lane convention) are skipped.

    Returns one tensor [num_segments] per red:
      sum of floats  -> float64
      sum of ints    -> int64, bit-exact (two's-complement wrap)
      count          -> int64
      min/max        -> the input dtype
    Empty groups yield 0 for sum/count and +inf/-inf (or dtype extrema)
    for min/max; the caller masks them with its count column.

    `sorted_segments` / `boundaries` are accepted for signature parity with
    the reference; ordered input needs no separate path here.
    """
    if seg.device.type == "cuda":
        return _cuda_segment_reduce(seg, reds, num_segments)
    return plain_segment_reduce(seg, reds, num_segments)


# --------------------------------------------------------------------------
# plain PyTorch version (CPU tests, device="cpu", comparisons on the card)
# --------------------------------------------------------------------------


def plain_segment_reduce(seg, reds, num_segments) -> list[torch.Tensor]:
    G = num_segments
    n = seg.shape[0]
    dev = seg.device
    num = G + 1  # overflow bucket for dead lanes
    seg_c = torch.clamp(seg.to(torch.int64), max=G)
    seg_c = torch.where(seg_c < 0, torch.full_like(seg_c, G), seg_c)
    out = []
    for r in reds:
        if r.op == "count":
            v = (
                r.valid.to(torch.int64) if r.valid is not None
                else torch.ones((n,), dtype=torch.int64, device=dev)
            )
            acc = torch.zeros((num,), dtype=torch.int64, device=dev)
            out.append(acc.index_add_(0, seg_c, v)[:G])
        elif r.op == "sum":
            vals = r.values
            acc_t = torch.float64 if vals.dtype.is_floating_point else torch.int64
            v = vals.to(acc_t)
            if r.valid is not None:
                v = torch.where(r.valid, v, torch.zeros_like(v))
            acc = torch.zeros((num,), dtype=acc_t, device=dev)
            out.append(acc.index_add_(0, seg_c, v)[:G])
        elif r.op in ("min", "max"):
            sel = r.values
            if sel.dtype == torch.bool:
                sel = sel.to(torch.uint8)
            sent = _extreme(sel.dtype, r.op == "min")
            if r.valid is not None:
                sel = torch.where(r.valid, sel, torch.full_like(sel, sent))
            acc = torch.full((num,), sent, dtype=sel.dtype, device=dev)
            acc.scatter_reduce_(
                0, seg_c, sel, "amin" if r.op == "min" else "amax", include_self=True
            )
            out.append(acc[:G].to(r.values.dtype))
        else:
            raise ValueError(f"unknown reduction {r.op}")
    return out


# --------------------------------------------------------------------------
# CUDA kernel wrapper
# --------------------------------------------------------------------------


def _kind(r: SegRed) -> int:
    if r.op == "count":
        return 0
    base = _BASE.get(r.values.dtype)
    if base is None:
        raise TypeError(f"segment_reduce: unsupported value dtype {r.values.dtype}")
    return _KINDS.index(f"{r.op}_{base}")


def _entry_words(kind: int) -> int:
    name = _KINDS[kind]
    if name.startswith("sum_") and name != "sum_f64":
        return 3
    return _WORDS["count" if kind == 0 else name.split("_")[1]]


@dataclass(frozen=True)
class LaunchPlan:
    """One launch of kernel 1, decoded on the host."""

    order: tuple       # caller's index of each reduction, in kernel order
    kinds: tuple       # kind (index into _KINDS) of each, in kernel order
    kind_end: tuple    # kind k spans kernel positions [kind_end[k-1], kind_end[k])
    mask_of: tuple     # index into `masks` of each, -1 for none
    masks: tuple       # the distinct validity tensors
    words: tuple       # first 32-bit word of each reduction's block table
    shared_words: int  # block table size in words; 0 = too large: global atomics
    replicas: int      # copies of the block table (lane l uses copy l % replicas)
    rep_stride: int    # 32-bit words between copies
    blocks: int
    rows_per_block: int  # most rows one block reduces

    def unsort(self, rows: list) -> list:
        """Kernel-ordered results -> the caller's order."""
        out = [None] * len(rows)
        for pos, caller in enumerate(self.order):
            out[caller] = rows[pos]
        return out


def _mask_key(t: torch.Tensor):
    return (t.data_ptr(), t.numel(), t.stride()) if t.numel() else id(t)


def plan_launch(n: int, G: int, reds: Sequence[SegRed], sms: int) -> LaunchPlan:
    """Decode one launch's reductions: sort them by kind (stable), share one
    entry per distinct validity tensor, lay out the shared block table, and
    size the grid: one wave of resident blocks, but never so few that a
    block reduces more than _BLOCK_ROWS rows into its 32-bit words."""
    if len(reds) > _MAX_REDS:
        raise ValueError(f"segment_reduce: {len(reds)} reductions in one launch (max {_MAX_REDS})")
    kinds = [_kind(r) for r in reds]
    order = tuple(sorted(range(len(reds)), key=lambda i: kinds[i]))
    mask_ix: dict = {}
    masks: list = []
    mask_of = []
    for i in order:
        v = reds[i].valid
        if v is None:
            mask_of.append(-1)
            continue
        key = _mask_key(v)
        if key not in mask_ix:
            mask_ix[key] = len(masks)
            masks.append(v)
        mask_of.append(mask_ix[key])
    words, at = [], 0
    for i in order:
        size = _entry_words(kinds[i])
        if size == 2:
            at += at & 1  # 64-bit entries start on an even word
        words.append(at)
        at += size * G
    shared = at if at * 4 <= _SHARED_BYTES else 0
    # copies of the table: strides of 2 mod 4 words keep 64-bit entries
    # aligned and spread the lanes' copies over the banks
    rep_stride = at + (2 - at % 4) % 4
    replicas = _MAX_REPLICAS
    while replicas > 1 and replicas * rep_stride * 4 > _SHARED_BYTES:
        replicas //= 2
    if replicas == 1:
        rep_stride = at
    sorted_kinds = tuple(kinds[i] for i in order)
    kind_end = tuple(sum(1 for k in sorted_kinds if k <= kk) for kk in range(len(_KINDS)))
    step = _THREADS * _ROWS_PER_THREAD  # rows a block takes per step of its grid-stride loop
    blocks = min(-(-n // step), sms * _BLOCKS_PER_SM) if n > 0 else 0
    if shared and n > 0:
        blocks = max(blocks, -(-n // _BLOCK_ROWS))
    rows_per_block = -(-n // (blocks * step)) * step if blocks else 0
    return LaunchPlan(order, sorted_kinds, kind_end, tuple(mask_of), tuple(masks),
                      tuple(words), shared, replicas, rep_stride, blocks, rows_per_block)


class _SrRed(ctypes.Structure):
    _fields_ = [
        ("values", ctypes.c_void_p),
        ("mask", ctypes.c_int32),
        ("word", ctypes.c_int32),
    ]


class _SrPlan(ctypes.Structure):
    _fields_ = [
        ("n_reds", ctypes.c_int32),
        ("n_masks", ctypes.c_int32),
        ("shared", ctypes.c_int32),
        ("replicas", ctypes.c_int32),
        ("rep_stride", ctypes.c_int32),
        ("blocks", ctypes.c_int32),
        ("kind_end", ctypes.c_int32 * len(_KINDS)),
        ("masks", ctypes.c_void_p * _MAX_REDS),
        ("reds", _SrRed * _MAX_REDS),
    ]


def _c_plan(plan: LaunchPlan, reds) -> _SrPlan:
    c = _SrPlan()
    c.n_reds = len(reds)
    c.n_masks = len(plan.masks)
    c.shared = 1 if plan.shared_words else 0
    c.replicas = plan.replicas
    c.rep_stride = plan.rep_stride
    c.blocks = plan.blocks
    for k, end in enumerate(plan.kind_end):
        c.kind_end[k] = end
    for m, t in enumerate(plan.masks):
        c.masks[m] = t.data_ptr()
    for pos, caller in enumerate(plan.order):
        r = reds[caller]
        d = c.reds[pos]
        d.values = None if r.op == "count" else r.values.data_ptr()
        d.mask = plan.mask_of[pos]
        d.word = plan.words[pos]
    return c


def _check_rows(t: torch.Tensor, n: int, dev, what: str) -> None:
    if t.device != dev:
        raise ValueError(f"segment_reduce: {what} lives on {t.device}, seg on {dev}")
    if t.dim() != 1 or t.shape[0] != n:
        raise ValueError(f"segment_reduce: {what} has shape {tuple(t.shape)}, want ({n},)")
    if not t.is_contiguous():
        raise ValueError(f"segment_reduce: {what} is not contiguous")


def _cuda_segment_reduce(seg, reds, G) -> list[torch.Tensor]:
    n = seg.shape[0]
    dev = seg.device
    if seg.dtype != torch.int32:
        raise TypeError(f"segment_reduce: seg must be int32, got {seg.dtype}")
    _check_rows(seg, n, dev, "seg")
    if G < 1:
        raise ValueError(f"segment_reduce: num_segments must be >= 1, got {G}")
    for r in reds:
        if r.op not in ("sum", "count", "min", "max"):
            raise ValueError(f"unknown reduction {r.op}")
        if r.op != "count":
            if r.values is None:
                raise ValueError(f"segment_reduce: {r.op} needs values")
            if r.values.dtype not in _BASE:
                raise TypeError(
                    f"segment_reduce: unsupported value dtype {r.values.dtype}"
                )
            _check_rows(r.values, n, dev, f"{r.op} values")
        if r.valid is not None:
            if r.valid.dtype != torch.bool:
                raise TypeError(f"segment_reduce: valid must be bool, got {r.valid.dtype}")
            _check_rows(r.valid, n, dev, f"{r.op} valid")
    results: list[torch.Tensor] = []
    for start in range(0, len(reds), _MAX_REDS):
        results.extend(_launch(seg, reds[start:start + _MAX_REDS], G))
    return results


def _launch(seg, reds, G) -> list[torch.Tensor]:
    global _launches
    lib = load_library()
    fn = lib.trino_segment_reduce
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.POINTER(_SrPlan), ctypes.c_void_p, ctypes.c_void_p,
    ]
    n = seg.shape[0]
    sms = torch.cuda.get_device_properties(seg.device).multi_processor_count
    plan = plan_launch(n, G, reds, sms)
    c = _c_plan(plan, reds)
    out = torch.empty((len(reds), G), dtype=torch.int64, device=seg.device)
    with torch.cuda.device(seg.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(seg.data_ptr(), n, G, ctypes.byref(c), out.data_ptr(), stream)
    check_launch(lib, code, "segment_reduce")
    _launches += 1
    results = []
    for r, row in zip(reds, plan.unsort(list(out.unbind(0)))):
        want = _result_dtype(r)
        if want == torch.float64:
            results.append(row.view(torch.float64))
        elif want == torch.int64:
            results.append(row)
        else:
            # narrow integer min/max: an empty group holds the int64 extreme,
            # which maps to the narrow type's extreme
            info = torch.iinfo(torch.uint8 if want == torch.bool else want)
            results.append(row.clamp(info.min, info.max).to(want))
    return results
