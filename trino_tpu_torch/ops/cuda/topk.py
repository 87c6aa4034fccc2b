"""Radix-select TopN: K-selection without sorting the relation.

Port of trino_tpu/ops/pallas/topk.py (`sortable_u32`,
`radix_topk_threshold`, `radix_topk_supported`).

1. The leading sort key maps to a monotone u32 (`sortable_u32`: sign-flipped
   float bits, offset integers, dictionary ranks); the caller inverts the
   bits for ascending order and folds NULL ordering in as an extreme.
2. Four radix passes find the exact K-th largest key byte by byte: each pass
   is one launch of the histogram kernel in csrc/topk.cu (256 bins of one
   byte over the live rows that match the prefix resolved so far).  The bin
   holding the K-th row is chosen with a reverse cumsum and an argmax on the
   device, and the prefix stays in device memory: no host sync per pass.
3. The caller (ops/relops.py top_n) compacts the rows at or above the
   threshold and sorts only those.

u32 keys are carried in int32 tensors (the same bits; torch's uint32
supports few operations).  On CUDA tensors `radix_histogram` launches the
kernel (or raises); on CPU tensors it runs `plain_radix_histogram`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .build import check_launch, load_library

__all__ = [
    "FORCE", "sortable_u32", "radix_topk_threshold", "radix_topk_supported",
    "radix_histogram", "plain_radix_histogram", "launches", "reset_launches",
]

_RADIX_MIN_ROWS = 65_536  # below this the plain sort is cheaper
_M32 = 0xFFFFFFFF

# Test hook: route TopN through the radix path regardless of size.
FORCE = False

_launches = 0


def launches() -> int:
    return _launches


def reset_launches() -> None:
    global _launches
    _launches = 0


def radix_topk_supported(n_rows: int, count: int) -> bool:
    if FORCE:
        return True
    return n_rows >= _RADIX_MIN_ROWS and count <= 4096


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


def radix_histogram(
    u: torch.Tensor, live: torch.Tensor, prefix: torch.Tensor, shift: int
) -> torch.Tensor:
    """hist [256] int64: per value of byte (u >> shift) & 0xFF, the live
    rows whose bits above that byte equal `prefix`'s (a 0-dim int64 device
    tensor holding a u32; no bits are compared on the first pass,
    shift = 24)."""
    if u.dtype != torch.int32 or live.dtype != torch.bool or u.shape != live.shape:
        raise TypeError("radix_histogram: u must be int32 [n] and live bool [n]")
    if shift not in (0, 8, 16, 24):
        raise ValueError(f"radix_histogram: shift {shift} is not a byte boundary")
    if u.device.type == "cuda":
        return _cuda_histogram(u, live, prefix, shift)
    return plain_radix_histogram(u, live, prefix, shift)


def _byte_and_match(u, live, prefix, shift):
    v = u.to(torch.int64) & _M32
    mask = 0 if shift == 24 else (_M32 << (shift + 8)) & _M32
    in_prefix = live & ((v & mask) == (prefix & mask))
    return (v >> shift) & 0xFF, in_prefix


def plain_radix_histogram(u, live, prefix, shift) -> torch.Tensor:
    byte, in_prefix = _byte_and_match(u, live, prefix, shift)
    # rows outside the prefix count into a 257th bin that is dropped
    return torch.bincount(torch.where(in_prefix, byte, 256), minlength=257)[:256]


def radix_topk_threshold(u: torch.Tensor, live: torch.Tensor, k: int) -> torch.Tensor:
    """Exact K-th-largest threshold (a 0-dim int64 tensor holding a u32)
    over the u32 keys of live rows: every live row with u >= threshold is a
    candidate (the true top K plus any 32-bit ties at the boundary)."""
    dev = u.device
    prefix = torch.zeros((), dtype=torch.int64, device=dev)
    above = torch.zeros((), dtype=torch.int64, device=dev)  # rows strictly above the prefix
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    for p in range(4):
        shift = 8 * (3 - p)
        hist = radix_histogram(u, live, prefix, shift)
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
    return prefix


def _cuda_histogram(u, live, prefix, shift) -> torch.Tensor:
    global _launches
    dev = u.device
    if not (u.is_contiguous() and live.is_contiguous()):
        raise ValueError("radix_histogram: u and live must be contiguous")
    if prefix.dtype != torch.int64 or prefix.numel() != 1 or prefix.device != dev:
        raise TypeError("radix_histogram: prefix must be one int64 on the rows' device")
    prefix = prefix.reshape(1).contiguous()
    hist = torch.zeros((256,), dtype=torch.int64, device=dev)
    n = u.shape[0]
    if n > 0:
        lib = load_library()
        fn = lib.trino_radix_histogram
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            code = fn(u.data_ptr(), live.data_ptr(), n, prefix.data_ptr(), shift,
                      hist.data_ptr(), stream)
        check_launch(lib, code, "radix_histogram")
        _launches += 1
    return hist
