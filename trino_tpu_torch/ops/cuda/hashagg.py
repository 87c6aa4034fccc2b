"""Hash-table build: a dense group id per row — the group-by and join build pass.

Port of trino_tpu/ops/pallas/hashagg.py (`build_hash_table`, kernel
`_build_kernel`).  Every live row's key (up to MAX_WORDS int32 words)
is inserted into an open-addressing, linear-probing table: a row either
finds its key already published (and takes that entry's group id) or claims
an empty slot (and allocates the next id).  Equality is decided on the full
words; a 64-bit splitmix hash of the words (`hash_words`, bit-identical to
the reference) picks only the start slot.

Layout, in device memory: T = 2 * pow2(cap) slots (load factor <= 0.5),
one record of R = record_words(W) int32 per slot, `slots[T, R]`: word 0 is
the state — EMPTY (-1), BUSY (-2, claimed, key being written) or the
published group id — and words 1..W the key (8, 16 or 32 bytes a record, so
a walk reads a slot with one vector load from one sector).  The reference
kept a [16, T] f32 table in VMEM (16-bit key halves, one-hot matmuls, at
most 8192 slots); none of that carries over — the card's table is as large
as its memory and its slots are read and written directly.

On CUDA tensors `build_hash_table` launches the kernel in csrc/hashagg.cu
(or raises); on CPU tensors it runs `plain_build_hash_table`, vectorised
rounds in torch over the same table layout.  The card checks the two both
ways: each version's table is probed by the other version's probe
(ops/cuda/hashjoin.py).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from .build import check_launch, load_library

__all__ = [
    "MAX_WORDS", "HashTable", "table_size", "record_words", "shape_supported", "hash_words",
    "build_hash_table", "plain_build_hash_table", "launches", "reset_launches",
]

MAX_WORDS = 6  # the layout of _hash_key_words plus the validity word
EMPTY = -1
BUSY = -2
# slots a walk may step past before it gives up and raises the overflow
# flag.  At load <= 0.5 the longest linear-probing run of a 2^25-slot table
# is ~100 slots; the budget only bites when the table is nearly full
# (more distinct keys than the capacity tier).
PROBE_LIMIT = 4096

_launches = 0


def launches() -> int:
    return _launches


def reset_launches() -> None:
    global _launches
    _launches = 0


@dataclass
class HashTable:
    # [T, record_words(W)] int32: per slot its state (EMPTY, BUSY or the
    # group id), then the words of its key
    slots: torch.Tensor
    n_words: int  # W
    # [W, cap] int32: the words of group g at column g (g < cap), written by
    # the claiming row; None when the caller did not ask for them
    group_keys: Optional[torch.Tensor]

    @property
    def size(self) -> int:
        return int(self.slots.shape[0])


def _pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def table_size(cap: int) -> int:
    """Slots for `cap` distinct keys: load factor <= 0.5."""
    return 2 * _pow2(max(int(cap), 1))


def record_words(n_words: int) -> int:
    """int32 words of one slot record: the state and W key words, rounded up
    to 8, 16 or 32 bytes (csrc/hashtable.cuh trino_record_words)."""
    return 2 if n_words == 1 else 4 if n_words <= 3 else 8


def shape_supported(n: int, n_words: int, cap: int) -> bool:
    """Row ids, slots and group ids are int32 on the card."""
    return 1 <= n_words <= MAX_WORDS and n < (1 << 31) and table_size(cap) <= (1 << 30)


def hash_words(words: Sequence[torch.Tensor], live: torch.Tensor) -> torch.Tensor:
    """64-bit start-slot hash of each row's words (the reference's splitmix
    chain over zero-extended u32 words), as int64 lanes with the same bits."""
    from ..relops import _mix64

    h = torch.zeros(live.shape, dtype=torch.int64, device=live.device)
    for w in words:
        h = _mix64(h ^ _mix64(w.to(torch.int64) & 0xFFFFFFFF))
    return h


def _check(words, live, what: str) -> None:
    if not 1 <= len(words) <= MAX_WORDS:
        raise ValueError(f"{what}: {len(words)} key words, want 1..{MAX_WORDS}")
    if live.dtype != torch.bool or live.dim() != 1:
        raise TypeError(f"{what}: live must be a 1-d bool tensor")
    n = live.shape[0]
    for w in words:
        if w.dtype != torch.int32 or w.shape != (n,) or w.device != live.device:
            raise TypeError(
                f"{what}: key words must be int32 [{n}] on {live.device}, got "
                f"{w.dtype}{tuple(w.shape)} on {w.device}"
            )


def build_hash_table(
    words: Sequence[torch.Tensor], live: torch.Tensor, cap: int, *, keep_keys: bool = True
):
    """Insert every live row's key into a fresh table.

    words: 1..MAX_WORDS int32 tensors [n]; live: bool [n]; cap: the group
    capacity tier.  Returns (gid [n] int32 — dense group id in claim order,
    -1 for dead rows and rows whose walk ran past its budget; table
    (HashTable, for a probe pass; `group_keys` when keep_keys); n_groups
    int32 device scalar — distinct keys inserted; overflow bool device
    scalar — a walk ran past its budget or n_groups > cap, so the caller
    must take its larger tier or sort exit).  Nothing syncs with the host.
    """
    _check(words, live, "build_hash_table")
    if live.device.type == "cuda":
        return _cuda_build(words, live, cap, keep_keys)
    return plain_build_hash_table(words, live, cap, keep_keys=keep_keys)


# --------------------------------------------------------------------------
# plain PyTorch version (CPU tests, device="cpu", comparisons on the card)
# --------------------------------------------------------------------------


def plain_build_hash_table(words, live, cap: int, *, keep_keys: bool = True):
    """Vectorised rounds over the kernel's table layout.  Each round, every
    walking row reads its slot's record (state and words): a published equal
    key resolves it; claimants of an EMPTY slot pick one winner per slot
    (the smallest row index, by scatter_reduce amin); winners take
    n_groups + rank in row order and publish their slot; losers retry the
    same slot (an equal key must converge on one entry); rows that met a
    different key step to the next slot."""
    dev = live.device
    n = live.shape[0]
    W = len(words)
    T = table_size(cap)
    mask = T - 1
    wmat = torch.stack(list(words), 1)  # [n, W] int32
    slots = torch.full((T, record_words(W)), EMPTY, dtype=torch.int32, device=dev)
    gk = torch.zeros((W, cap), dtype=torch.int32, device=dev) if keep_keys else None
    gid = torch.full((n,), -1, dtype=torch.int32, device=dev)

    rows = torch.nonzero(live).flatten()
    slot = hash_words(words, live).index_select(0, rows) & mask
    steps = torch.zeros_like(rows)
    n_groups = 0
    overflow = False
    while rows.numel():
        rec = slots.index_select(0, slot)
        st = rec[:, 0].to(torch.int64)
        eq = (st >= 0) & (rec[:, 1:1 + W] == wmat.index_select(0, rows)).all(1)
        gid[rows[eq]] = st[eq].to(torch.int32)

        empty = st == EMPTY
        cs, cr = slot[empty], rows[empty]
        best = torch.full((T,), n, dtype=torch.int64, device=dev).scatter_reduce_(
            0, cs, cr, "amin", include_self=True
        )
        won = best.index_select(0, cs) == cr
        ws, wr = cs[won], cr[won]  # one row per slot, rows ascending
        new = n_groups + torch.arange(wr.numel(), dtype=torch.int64, device=dev)
        slots[ws, 0] = new.to(torch.int32)
        slots[ws, 1:1 + W] = wmat.index_select(0, wr)
        if gk is not None:
            fit = new < cap
            gk[:, new[fit]] = wmat.index_select(0, wr[fit]).T
        gid[wr] = new.to(torch.int32)
        n_groups += int(wr.numel())

        winner = torch.zeros_like(empty)
        winner[torch.nonzero(empty).flatten()[won]] = True
        step = ~eq & ~empty  # a different key is published here: next slot
        slot = torch.where(step, (slot + 1) & mask, slot)
        steps = steps + step.to(steps.dtype)
        lost = steps > PROBE_LIMIT
        overflow = overflow or bool(lost.any())
        walking = ~eq & ~winner & ~lost
        rows, slot, steps = rows[walking], slot[walking], steps[walking]
    overflow = overflow or n_groups > cap
    table = HashTable(slots, W, gk)
    return (
        gid, table, torch.tensor(n_groups, dtype=torch.int32, device=dev),
        torch.tensor(overflow, dtype=torch.bool, device=dev),
    )


# --------------------------------------------------------------------------
# CUDA kernel wrapper
# --------------------------------------------------------------------------


class _Words(ctypes.Structure):
    _fields_ = [("w", ctypes.c_void_p * MAX_WORDS)]


def word_table(words) -> _Words:
    """The key-word pointers as the kernels' by-value struct."""
    t = _Words()
    for i, w in enumerate(words):
        if not w.is_contiguous():
            raise ValueError("hash kernels: key words must be contiguous")
        t.w[i] = w.data_ptr()
    return t


def _cuda_build(words, live, cap: int, keep_keys: bool):
    global _launches
    dev = live.device
    n = live.shape[0]
    W = len(words)
    T = table_size(cap)
    if not shape_supported(n, W, cap):
        raise ValueError(f"build_hash_table: unsupported shape n={n} words={W} cap={cap}")
    if not live.is_contiguous():
        raise ValueError("build_hash_table: live must be contiguous")
    slots = torch.full((T, record_words(W)), EMPTY, dtype=torch.int32, device=dev)
    gk = torch.zeros((W, cap), dtype=torch.int32, device=dev) if keep_keys else None
    gid = torch.empty((n,), dtype=torch.int32, device=dev)
    counters = torch.zeros((2,), dtype=torch.int32, device=dev)  # n_groups, overflow
    if n > 0:
        lib = load_library()
        fn = lib.trino_hash_build
        fn.restype = ctypes.c_int
        fn.argtypes = [
            _Words, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ]
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            code = fn(
                word_table(words), W, live.data_ptr(), n, T, cap, slots.data_ptr(),
                None if gk is None else gk.data_ptr(), gid.data_ptr(),
                counters.data_ptr(), PROBE_LIMIT, stream,
            )
        check_launch(lib, code, "hash_build")
        _launches += 1
    n_groups = counters[0]
    overflow = (counters[1] != 0) | (n_groups > cap)
    return gid, HashTable(slots, W, gk), n_groups, overflow
