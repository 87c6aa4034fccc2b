"""Hash-join probe pass.

Port of trino_tpu/ops/pallas/hashjoin.py (`probe_hash_table`, kernel
`_probe_kernel`).  The build side of a hash equi-join reuses the group-by
build (ops/cuda/hashagg.build_hash_table): build rows insert their key
words and get dense ids per DISTINCT build key.  This module is the probe
side: every probe row walks the same linear-probing sequence over the (now
read-only) table and either matches a published slot — returning its id —
or reaches an EMPTY slot, which proves the key absent (-1).  One pass over
the probe side, no sort of either side.

A walk past the budget sets `unresolved`; with the build's overflow flag it
sends the whole join to the sort path (ops/relops.py equi_join).

On CUDA tensors `probe_hash_table` launches the kernel in csrc/hashjoin.cu
(or raises); on CPU tensors it runs `plain_probe_hash_table`.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from .build import check_launch, load_library
from .hashagg import EMPTY, PROBE_LIMIT, HashTable, _Words, _check, hash_words, word_table

__all__ = ["probe_hash_table", "plain_probe_hash_table", "launches", "reset_launches"]

_launches = 0


def launches() -> int:
    return _launches


def reset_launches() -> None:
    global _launches
    _launches = 0


def probe_hash_table(words: Sequence[torch.Tensor], live: torch.Tensor, table: HashTable):
    """Look up every live row's key in `table` (from build_hash_table).

    Returns (gid [n] int32 — the matched slot's group id, -1 for a proven
    miss or a dead row; unresolved — device bool, some walk ran past its
    budget and the result must not be used)."""
    _check(words, live, "probe_hash_table")
    if table.n_words != len(words):
        raise ValueError(
            f"probe_hash_table: {len(words)} key words against a {table.n_words}-word table"
        )
    if live.device.type == "cuda":
        return _cuda_probe(words, live, table)
    return plain_probe_hash_table(words, live, table)


def plain_probe_hash_table(words, live, table: HashTable):
    """Vectorised rounds: each walking row reads its slot's record; equal words
    resolve it to the slot's id, EMPTY to a miss, anything else steps on."""
    dev = live.device
    n = live.shape[0]
    T = table.size
    mask = T - 1
    wmat = torch.stack(list(words), 1)  # [n, W] int32
    gid = torch.full((n,), -1, dtype=torch.int32, device=dev)
    rows = torch.nonzero(live).flatten()
    slot = hash_words(words, live).index_select(0, rows) & mask
    steps = torch.zeros_like(rows)
    unresolved = False
    while rows.numel():
        rec = table.slots.index_select(0, slot)
        st = rec[:, 0]
        eq = (st >= 0) & (rec[:, 1:1 + len(words)] == wmat.index_select(0, rows)).all(1)
        gid[rows[eq]] = st[eq]
        step = ~eq & (st != EMPTY)
        slot = torch.where(step, (slot + 1) & mask, slot)
        steps = steps + step.to(steps.dtype)
        lost = steps > PROBE_LIMIT
        unresolved = unresolved or bool(lost.any())
        walking = step & ~lost
        rows, slot, steps = rows[walking], slot[walking], steps[walking]
    return gid, torch.tensor(unresolved, dtype=torch.bool, device=dev)


def _cuda_probe(words, live, table: HashTable):
    global _launches
    dev = live.device
    n = live.shape[0]
    if not live.is_contiguous():
        raise ValueError("probe_hash_table: live must be contiguous")
    if table.slots.device != dev or not table.slots.is_contiguous():
        raise ValueError("probe_hash_table: the table must be contiguous and on the rows' device")
    gid = torch.empty((n,), dtype=torch.int32, device=dev)
    unresolved = torch.zeros((1,), dtype=torch.int32, device=dev)
    if n > 0:
        lib = load_library()
        fn = lib.trino_hash_probe
        fn.restype = ctypes.c_int
        fn.argtypes = [
            _Words, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ]
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            code = fn(
                word_table(words), len(words), live.data_ptr(), n, table.size,
                table.slots.data_ptr(), gid.data_ptr(), unresolved.data_ptr(), PROBE_LIMIT,
                stream,
            )
        check_launch(lib, code, "hash_probe")
        _launches += 1
    return gid, unresolved[0] != 0
