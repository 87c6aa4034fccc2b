"""Radix-select TopN: K-selection without sorting the relation.

Port of trino_tpu/ops/pallas/topk.py (`sortable_u32`,
`radix_topk_threshold`, `radix_topk_supported`).

1. The leading sort key maps to a monotone u32 (`sortable_u32`: sign-flipped
   float bits, offset integers, dictionary ranks); the caller inverts the
   bits for ascending order and folds NULL ordering in as an extreme.
2. Three radix passes find the exact K-th largest key digit by digit (11, 11
   and 10 bits: `DIGITS`): each pass counts the digit of the live rows whose
   higher digits equal the prefix resolved so far, and picks the bin that
   holds the K-th row.  On the card all of it is one call of
   csrc/topk.cu: the bin is chosen by the pass's last block, the prefix
   stays on the device, and once the rows at or above the first digit's bin
   fit a buffer (`buffer_entries`) the later passes read only that buffer.
3. With `cap`, the same call lists the candidates — the live rows with
   key >= threshold, every true top-K row plus its ties — as `cap` row ids
   in row order, and counts them all (`required`, the executor's capacity
   retry); ops/relops.py top_n gathers and sorts only those.

u32 keys are carried in int32 tensors (the same bits; torch's uint32
supports few operations).  On CUDA tensors `radix_select` launches the
kernels (or raises); on CPU tensors it runs `plain_radix_select`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from .build import check_launch, load_library

__all__ = [
    "FORCE", "DIGITS", "RadixSelection", "sortable_u32", "radix_topk_threshold",
    "radix_topk_supported", "radix_select", "plain_radix_select", "plain_radix_histogram",
    "plain_radix_candidates", "buffer_entries", "launches", "reset_launches",
]

_RADIX_MIN_ROWS = 65_536  # below this the plain sort is cheaper
_M32 = 0xFFFFFFFF
# (shift, bits) of each pass's digit, most significant first
DIGITS = ((21, 11), (10, 11), (0, 10))
# the scratch's head (csrc/topk.cu `State`, then the three histograms), in
# int32 words: threshold at int64 word 0, required at int64 word 3
_STATE_WORDS = 16
_HEAD_BYTES = 4 * (_STATE_WORDS + 2048 + 2048 + 1024)
_HIST_AT = (_STATE_WORDS, _STATE_WORDS + 2048, _STATE_WORDS + 4096)

# Test hook: route TopN through the radix path regardless of size.
FORCE = False

_launches = 0


def launches() -> int:
    return _launches


def reset_launches() -> None:
    global _launches
    _launches = 0


class RadixSelection(NamedTuple):
    """threshold: 0-dim int64 holding a u32 — the K-th largest live key (the
    smallest live key when K exceeds the live rows, 0 when none is live);
    hists: each pass's counts (int32 [2048], [2048], [1024]) at the prefix
    the selection had reached; ids: with `cap`, int64 [cap] — the first
    min(required, cap) lanes are the candidates' row ids in row order, the
    rest unspecified valid row ids; required: 0-dim int64, the candidates."""

    threshold: torch.Tensor
    hists: list
    ids: Optional[torch.Tensor] = None
    required: Optional[torch.Tensor] = None


def radix_topk_supported(n_rows: int, count: int) -> bool:
    if FORCE:
        return True
    return n_rows >= _RADIX_MIN_ROWS and count <= 4096


def buffer_entries(n: int) -> int:
    """Rows the candidate buffer holds: one in sixteen."""
    return (n + 15) // 16


def sortable_u32(
    data: torch.Tensor, descending: bool, narrow: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Monotone map of a numeric key into u32 bits (an int32 tensor; ties
    allowed, the caller resolves them exactly on the candidate set).  Floats
    go through float32; int64 keys collapse to their top 32 bits — unless
    `narrow` (a device bool) says every counted value fits int32, when they
    map as int32 keys do, which is how the reference sees such a lane (it
    narrows it at upload)."""
    if data.dtype.is_floating_point:
        b = data.to(torch.float32).view(torch.int32).to(torch.int64) & _M32
        neg = (b & 0x80000000) != 0
        u = torch.where(neg, b ^ _M32, b | 0x80000000)
    elif data.dtype == torch.bool:
        u = data.to(torch.int64)
    elif data.dtype == torch.int64:
        u = ((data >> 32) + (1 << 31)) & _M32
        if narrow is not None:
            u = torch.where(narrow, (data + (1 << 31)) & _M32, u)
    else:
        u = (data.to(torch.int64) + (1 << 31)) & _M32
    if descending:
        u = u ^ _M32
    return u.to(torch.int32)


def radix_topk_threshold(u: torch.Tensor, live: torch.Tensor, k: int) -> torch.Tensor:
    """Exact K-th-largest threshold (a 0-dim int64 tensor holding a u32)
    over the u32 keys of live rows: every live row with u >= threshold is a
    candidate (the true top K plus any 32-bit ties at the boundary)."""
    return radix_select(u, live, k).threshold


def radix_select(u: torch.Tensor, live: torch.Tensor, k: int,
                 cap: Optional[int] = None) -> RadixSelection:
    """The threshold, each pass's histogram and, with `cap`, the candidates
    (see RadixSelection)."""
    if u.dtype != torch.int32 or live.dtype != torch.bool or u.shape != live.shape or u.dim() != 1:
        raise TypeError("radix_select: u must be int32 [n] and live bool [n]")
    if u.device.type == "cuda":
        return _cuda_select(u, live, k, cap)
    return plain_radix_select(u, live, k, cap)


def _digit_and_match(u, live, prefix, shift):
    bits = dict(DIGITS)[shift]
    v = u.to(torch.int64) & _M32
    mask = (_M32 << (shift + bits)) & _M32
    in_prefix = live & ((v & mask) == (prefix & mask))
    return (v >> shift) & ((1 << bits) - 1), in_prefix


def plain_radix_histogram(u, live, prefix, shift) -> torch.Tensor:
    """int64 [2^bits]: per value of the digit at `shift` (21, 10 or 0), the
    live rows whose higher digits equal `prefix`'s (a 0-dim int64 holding a
    u32; none are compared at shift 21)."""
    if shift not in dict(DIGITS):
        raise ValueError(f"plain_radix_histogram: shift {shift} is not a digit boundary")
    digit, in_prefix = _digit_and_match(u, live, prefix, shift)
    bins = 1 << dict(DIGITS)[shift]
    # rows outside the prefix count into one more bin that is dropped
    return torch.bincount(torch.where(in_prefix, digit, bins), minlength=bins + 1)[:bins]


def plain_radix_select(u, live, k: int, cap: Optional[int] = None) -> RadixSelection:
    dev = u.device
    prefix = torch.zeros((), dtype=torch.int64, device=dev)
    above = torch.zeros((), dtype=torch.int64, device=dev)  # rows strictly above the prefix
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    hists = []
    for shift, _ in DIGITS:
        hist = plain_radix_histogram(u, live, prefix, shift)
        hists.append(hist.to(torch.int32))
        # descending scan: rows above bin b = above + sum(hist[b+1:])
        rev = hist.flip(0).cumsum(0).flip(0)  # rev[b] = sum(hist[b:])
        above_b = above + rev - hist  # strictly above each bin
        sel = (above_b < k) & (above_b + hist >= k)
        any_sel = sel.any()
        bin_ = torch.argmax(sel.to(torch.int32))
        # k exceeds the live rows (only possible on the first pass): take
        # the smallest non-empty bin, so every live row qualifies.  (The
        # reference's 255 - argmax(reversed) picks the LARGEST one and drops
        # rows; ROADMAP queue C.)
        nonempty = hist > 0
        low_bin = torch.where(nonempty.any(), torch.argmax(nonempty.to(torch.int32)), zero)
        bin_ = torch.where(any_sel, bin_, low_bin)
        above = torch.where(any_sel, above_b[bin_], above)
        prefix = prefix | (bin_ << shift)
    if cap is None:
        return RadixSelection(prefix, hists)
    ids, required = plain_radix_candidates(u, live, prefix, cap)
    return RadixSelection(prefix, hists, ids, required)


def plain_radix_candidates(u, live, threshold, cap: int):
    """(ids int64 [cap], required): the live rows with u >= threshold, the
    first `cap` of them in row order (later lanes 0), and their count."""
    n = u.shape[0]
    dev = u.device
    cand = live & ((u.to(torch.int64) & _M32) >= threshold)
    required = cand.sum(dtype=torch.int64)
    # compact candidate row ids into the static buffer (slot `cap` takes the
    # non-candidates and is dropped)
    pos = torch.cumsum(cand.to(torch.int64), 0) - 1
    scatter_to = torch.where(cand, pos, torch.full_like(pos, cap)).clamp(max=cap)
    ids = torch.zeros((cap + 1,), dtype=torch.int64, device=dev).scatter_(
        0, scatter_to, torch.arange(n, dtype=torch.int64, device=dev)
    )[:cap]
    return ids, required


_ENTRY = None


def _entry():
    """The C entry, bound once per process."""
    global _ENTRY
    if _ENTRY is None:
        lib = load_library()
        fn = lib.trino_radix_select
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_void_p,
        ]
        _ENTRY = (lib, fn)
    return _ENTRY


def _cuda_select(u, live, k: int, cap: Optional[int]) -> RadixSelection:
    global _launches
    dev = u.device
    if not (u.is_contiguous() and live.is_contiguous()):
        raise ValueError("radix_select: u and live must be contiguous")
    if live.device != dev:
        raise ValueError("radix_select: u and live must be on one device")
    n = u.shape[0]
    if n >= 1 << 31:
        raise ValueError(f"radix_select: {n} rows; row ids are 32-bit")
    buf = buffer_entries(n)
    # one allocation: the state, the three histograms, the buffer (8 B an
    # entry), the candidates' ids (4 B each)
    id_words = 0 if cap is None else (cap + 1) // 2
    scratch = torch.empty(((_HEAD_BYTES + 8 * buf) // 8 + id_words,), dtype=torch.int64,
                          device=dev)
    words = scratch.view(torch.int32)
    ids = None if cap is None else words[(_HEAD_BYTES + 8 * buf) // 4:][:cap]
    lib, fn = _entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(u.data_ptr(), live.data_ptr(), n, k, scratch.data_ptr(), buf,
                  0 if ids is None else ids.data_ptr(), 0 if cap is None else cap, stream)
    check_launch(lib, code, "radix_select")
    if n > 0:
        _launches += 3 if cap is None else 4
    hists = [words[at:at + (1 << bits)] for at, (_, bits) in zip(_HIST_AT, DIGITS)]
    if cap is None:
        return RadixSelection(scratch[0], hists)
    # appends came in atomic order; unused lanes hold 0x7F7F7F7F and sort last
    ids = torch.sort(ids).values.clamp_(0, max(n - 1, 0)).to(torch.int64)
    return RadixSelection(scratch[0], hists, ids, scratch[3])
