"""Exchanges between the tasks of a distributed plan: the device data plane.

The reference moves pages between tasks over HTTP long-polls
(operator/output/PagePartitioner.java:135 -> PartitionedOutputBuffer ->
HttpPageBufferClient.java:355 -> ExchangeOperator.java:234).  The JAX
package traces them into one SPMD program as XLA collectives (an
all_to_all for a repartition, an all_gather for a broadcast or gather).
The port runs each fragment as D tasks (exec/spmd.py), so an exchange is a
function over the D output pages of the producer's tasks:

  repartition : part = the 62-bit key hash (ops/relops.py _combined_hash)
                mod D, on each source's device; a live row with a NULL key
                goes to part 0, dead rows are dropped.  Destination d
                receives, for each source s in order 0..D-1, the live rows
                of s with part d in their original order — what the JAX
                package's stable bucket sort plus all_to_all gives.
  gather_all  : every destination receives the live rows of every source,
                in source order (broadcast and gather).

Every destination page is padded to one pow2 capacity with a dead tail, so
the consumer fragment's tasks share one set of learned capacities.

Rows never pass through the host: each source is gathered once into part
order on its own device, and each destination concatenates slices of those
(torch.cat), after `Tensor.to(dest, non_blocking=True)` where the source
lies on another card.  The one device->host transfer of an exchange is its
count matrix (D x D for a repartition, D for a gather), which sizes the
outputs.  Destinations on one device share a gather's one output page.

The part ids are not runtime/wire.py `partition_ids`': that function reads
the full 64-bit hash as unsigned (the out-of-core path's spill files), this
one masks it to 62 bits first, as the JAX package's exchange does.  The two
agree only when D is a power of two.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..data.page import Column, Dictionary, Page
from ..ops.expr import ColumnVal, column_val, eval_expr, translate_codes
from ..ops.relops import _combined_hash
from ..utils.metrics import GLOBAL as _METRICS

__all__ = ["repartition", "gather_all", "empty_like"]

_EXCHANGE_BYTES = _METRICS.counter(
    "trino_tpu_spmd_exchange_planned_bytes_total",
    "Bytes of rows an exchange copied into its destination pages",
    ("kind",),
)


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _gather_sorted(page: Page, order: torch.Tensor, n: int) -> list[ColumnVal]:
    """The first `n` rows of `page` in `order`, on the page's device."""
    idx = order[:n]
    out = []
    for c in page.columns:
        out.append(ColumnVal(
            c.data.index_select(0, idx),
            None if c.valid is None else c.valid.index_select(0, idx),
            c.dictionary, c.type,
            None if c.data2 is None else c.data2.index_select(0, idx),
        ))
    return out


def _slice(cols: list[ColumnVal], lo: int, hi: int) -> list[ColumnVal]:
    return [
        ColumnVal(cv.data[lo:hi], None if cv.valid is None else cv.valid[lo:hi],
                  cv.dict, cv.type, None if cv.data2 is None else cv.data2[lo:hi])
        for cv in cols
    ]


def _moved(t: Optional[torch.Tensor], dev: torch.device) -> Optional[torch.Tensor]:
    if t is None or t.device == dev:
        return t
    return t.to(dev, non_blocking=True)


def _nbytes(cv: ColumnVal) -> int:
    n = cv.data.numel() * cv.data.element_size()
    if cv.valid is not None:
        n += cv.valid.numel()
    if cv.data2 is not None:
        n += cv.data2.numel() * cv.data2.element_size()
    return n


def _merged_dictionary(dicts: list[Dictionary]) -> Dictionary:
    """One dictionary holding every value of `dicts`, in first-seen order
    (tasks that derive a VARCHAR column each build their own dictionary)."""
    import numpy as np

    seen: dict = {}
    for d in dicts:
        for v in d.values:
            seen.setdefault(v, None)
    vals = np.empty((len(seen),), dtype=object)
    vals[:] = list(seen)
    return Dictionary(vals)


def _assemble(pieces: list[list[ColumnVal]], types: list, n: int, cap: int,
              dev: torch.device) -> tuple[Page, int]:
    """Concatenate the sources' pieces (each a list of column slices) on
    `dev`, then a dead tail up to `cap` rows.  Returns (page, bytes copied)."""
    copied = 0
    cols = []
    pad = cap - n
    for ci, t in enumerate(types):
        parts = [p[ci] for p in pieces]
        dicts = [cv.dict for cv in parts if cv.dict is not None]
        out_dict = dicts[0] if dicts else None
        datas = [_moved(cv.data, dev) for cv in parts]
        if any(d is not out_dict for d in dicts):
            out_dict = _merged_dictionary(dicts)
            datas = [
                translate_codes(ColumnVal(d, None, cv.dict, cv.type), out_dict)
                if cv.dict is not None else torch.zeros_like(d, dtype=torch.int32)
                for d, cv in zip(datas, parts)
            ]
        dtype = datas[0].dtype
        data = torch.cat(datas + [torch.zeros((pad,), dtype=dtype, device=dev)])
        valid = None
        if any(cv.valid is not None for cv in parts):
            valid = torch.cat([
                _moved(cv.valid, dev) if cv.valid is not None
                else torch.ones(cv.data.shape, dtype=torch.bool, device=dev)
                for cv in parts
            ] + [torch.zeros((pad,), dtype=torch.bool, device=dev)])
        data2 = None
        if any(cv.data2 is not None for cv in parts):
            # a piece without a high limb holds values that fit int64: its
            # limb is the sign extension of the low lane
            data2 = torch.cat([
                _moved(cv.data2, dev) if cv.data2 is not None else d.to(torch.int64) >> 63
                for cv, d in zip(parts, datas)
            ] + [torch.zeros((pad,), dtype=torch.int64, device=dev)])
        copied += sum(_nbytes(cv) for cv in parts)
        cols.append(Column(t, data, valid, out_dict, data2))
    live = torch.arange(cap, device=dev) < n
    return Page(tuple(cols), live), copied + n


def _devices_of(shards: Sequence[Page], num: int, devices) -> list[torch.device]:
    if devices is not None:
        return [torch.device(d) for d in devices]
    return [shards[d % len(shards)].device for d in range(num)]


def _host_counts(counts: list[torch.Tensor]) -> list[list[int]]:
    """The sources' count vectors in ONE device->host transfer."""
    dev = counts[0].device
    return torch.stack([_moved(c, dev) for c in counts]).tolist()


def repartition(
    shards: Sequence[Page],
    keys: Sequence,
    num_devices: int,
    devices: Optional[Sequence] = None,
) -> tuple[list[Page], int]:
    """Hash-route the live rows of the sources `shards` (the producer's task
    pages) to `num_devices` destinations by the IR expressions `keys` over
    their columns.  `devices`: each destination's device (default: the
    device of source d).  Returns (destination pages, required): `required`
    is the largest bucket fill, one source's rows for one destination."""
    D = int(num_devices)
    types = [c.type for c in shards[0].columns]
    orders, counts = [], []
    for page in shards:
        cap = page.capacity
        dev = page.device
        live = page.live_mask()
        cols = [column_val(c) for c in page.columns]
        kv = [eval_expr(k, cols, cap, dev) for k in keys]
        h = _combined_hash(kv, live, cap, sentinel=0)
        part = torch.where(live, h % D, torch.full_like(h, D))  # dead -> dropped
        orders.append(torch.argsort(part, stable=True))
        counts.append(torch.bincount(part, minlength=D + 1)[:D])
    matrix = _host_counts(counts)  # [source][destination]
    required = max((c for row in matrix for c in row), default=0)
    fills = [sum(row[d] for row in matrix) for d in range(D)]
    cap_out = _pow2(max(max(fills, default=0), 1))
    sorted_cols = [
        _gather_sorted(page, order, sum(row))
        for page, order, row in zip(shards, orders, matrix)
    ]
    dests = _devices_of(shards, D, devices)
    out, moved = [], 0
    for d in range(D):
        pieces = []
        for cols, row in zip(sorted_cols, matrix):
            lo = sum(row[:d])
            pieces.append(_slice(cols, lo, lo + row[d]))
        page, nbytes = _assemble(pieces, types, fills[d], cap_out, dests[d])
        out.append(page)
        moved += nbytes
    _EXCHANGE_BYTES.labels("repartition").inc(moved)
    return out, required


def gather_all(
    shards: Sequence[Page], devices: Optional[Sequence] = None, kind: str = "gather",
) -> list[Page]:
    """Every destination gets the live rows of every source, in source
    order.  `devices`: the destinations' devices (default: one per source,
    on its device); destinations on one device share one page.  `kind`
    labels the byte counter (gather or broadcast)."""
    types = [c.type for c in shards[0].columns]
    orders, counts = [], []
    for page in shards:
        live = page.live_mask()
        orders.append(torch.argsort((~live).to(torch.uint8), stable=True))
        counts.append(live.sum(dtype=torch.int64).reshape(1))
    n_live = [row[0] for row in _host_counts(counts)]
    total = sum(n_live)
    cap_out = _pow2(max(total, 1))
    pieces = [_gather_sorted(page, order, n) for page, order, n in zip(shards, orders, n_live)]
    dests = _devices_of(shards, len(shards), devices)
    by_device: dict = {}
    moved = 0
    for dev in dests:
        if dev not in by_device:
            by_device[dev], nbytes = _assemble(pieces, types, total, cap_out, dev)
            moved += nbytes
    _EXCHANGE_BYTES.labels(kind).inc(moved)
    return [by_device[dev] for dev in dests]


def empty_like(page: Page, device=None) -> Page:
    """A page of `page`'s columns holding one dead row (what a task that
    receives nothing from an exchange scans)."""
    dev = torch.device(device) if device is not None else page.device
    cols = tuple(
        Column(c.type, torch.zeros((1,), dtype=c.data.dtype, device=dev),
               None, c.dictionary,
               None if c.data2 is None else torch.zeros((1,), dtype=torch.int64, device=dev))
        for c in page.columns
    )
    return Page(cols, torch.zeros((1,), dtype=torch.bool, device=dev))
