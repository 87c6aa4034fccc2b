"""Host-side page wire helpers: pages as framed, compressed column batches.

A page that leaves the card (a spill file of the out-of-core executor,
exec/spill.py; the exchange between worker processes, runtime/worker.py)
is compacted to its live rows on the host, framed and compressed by the C++
serde (trino_tpu_torch/native, built from the repo's native/pageserde.cpp)
and rebuilt into a device page by its consumer — the reference's
PagesSerdes + PositionsAppender path
(execution/buffer/, operator/output/PagePartitioner.java:135).  The bytes
are the JAX package's wire format: a blob written by either package decodes
in the other.

Device to host: every tensor of a page (its live mask, each column's data,
validity and high limb, and the partition ids when routing) is packed into
one byte buffer on the device and copied with ONE transfer — one
synchronization per page, not one per tensor.  The partition hash runs on
the device in int64 lanes and takes its part id as an UNSIGNED remainder,
so every row lands in the part the reference's uint64 hash picks.
"""

from __future__ import annotations

import datetime
import json
import struct
import zlib
from decimal import Decimal
from typing import Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..data.page import Column, Page
from ..data.types import Type
from ..native import page_serde
from ..ops.expr import column_val, eval_expr
from ..plan.ir import IrExpr
from ..utils.metrics import GLOBAL as _METRICS

__all__ = [
    "page_to_wire", "page_to_wire_chunks", "wire_to_page", "partition_page",
    "bucket_assignments", "partition_ids", "frame_chunk", "unframe_chunk",
    "PageTransportError", "FRAME_MAGIC",
]

# Target rows per wire chunk: bounds single transfers and lets a consumer
# acknowledge-and-free incrementally (the reference bounds transfers by
# bytes via exchange.max-response-size; rows are the natural unit here).
CHUNK_ROWS = 262_144

# Every wire chunk carries an end-to-end integrity frame: 4-byte magic +
# little-endian crc32 of the payload (reference: PagesSerde XXH64 page
# checksums), so a flipped bit in a spill file surfaces as a typed
# PAGE_TRANSPORT_ERROR instead of wrong rows.
FRAME_MAGIC = b"TPG1"
_FRAME_HEADER = len(FRAME_MAGIC) + 4

_TRANSPORT_ERRORS = _METRICS.counter(
    "trino_tpu_page_transport_errors_total",
    "Exchange frames rejected by crc32 verification",
)


class PageTransportError(RuntimeError):
    """A wire chunk failed integrity verification (bad magic or crc32
    mismatch).  The message carries the [PAGE_TRANSPORT_ERROR] code."""

    def __init__(self, detail: str):
        super().__init__(f"{detail} [PAGE_TRANSPORT_ERROR]")


def frame_chunk(blob: bytes) -> bytes:
    """magic + crc32(payload) + payload."""
    return FRAME_MAGIC + struct.pack("<I", zlib.crc32(blob) & 0xFFFFFFFF) + blob


def unframe_chunk(framed: bytes) -> bytes:
    """Verify and strip the integrity frame; raises PageTransportError on a
    bad magic, a truncated header or a checksum mismatch."""
    if len(framed) < _FRAME_HEADER or framed[:4] != FRAME_MAGIC:
        _TRANSPORT_ERRORS.inc()
        raise PageTransportError(
            f"wire chunk missing integrity frame (len={len(framed)}, head={framed[:4]!r})"
        )
    (want,) = struct.unpack_from("<I", framed, 4)
    payload = framed[_FRAME_HEADER:]
    got = zlib.crc32(payload) & 0xFFFFFFFF
    if got != want:
        _TRANSPORT_ERRORS.inc()
        raise PageTransportError(
            f"wire chunk crc32 mismatch: expected {want:#010x}, got {got:#010x}"
        )
    return payload


# ------------------------------------------------------------ device -> host


def _to_host(tensors: Sequence[Optional[torch.Tensor]]) -> list[Optional[np.ndarray]]:
    """Tensors of one device as numpy arrays through ONE packed copy: every
    tensor is viewed as bytes and concatenated on the device, the buffer
    crosses once, and the host splits it again."""
    present = [t for t in tensors if t is not None]
    if not present or present[0].device.type == "cpu":
        return [None if t is None else t.detach().numpy() for t in tensors]
    flat = [t.detach().contiguous().reshape(-1) for t in present]
    raw = torch.cat([f.view(torch.uint8) for f in flat]).cpu().numpy()
    out, off, it = [], 0, iter(flat)
    for t in tensors:
        if t is None:
            out.append(None)
            continue
        f = next(it)
        dt = torch.empty((0,), dtype=f.dtype).numpy().dtype
        nbytes = f.numel() * dt.itemsize
        out.append(raw[off: off + nbytes].view(dt))
        off += nbytes
    return out


def _to_json(v):
    """A dictionary value of an array, map or row column as JSON data:
    tuples (array elements, a map's key-sorted (key, value) pairs, a row's
    fields) as lists, decimals and dates tagged so they come back typed."""
    if isinstance(v, (tuple, list)):
        return [_to_json(x) for x in v]
    if isinstance(v, Decimal):
        return {"$dec": str(v)}
    if isinstance(v, datetime.date):
        return {"$date": v.isoformat()}
    if isinstance(v, np.generic):
        return v.item()
    return v


def _from_json(o):
    """Inverse of _to_json: lists come back as tuples, the canonical form
    of a dictionary value (data/page.py Dictionary.encode_objects)."""
    if isinstance(o, list):
        return tuple(_from_json(x) for x in o)
    if isinstance(o, dict):
        if "$dec" in o:
            return Decimal(o["$dec"])
        if "$date" in o:
            return datetime.date.fromisoformat(o["$date"])
    return o


def _host_columns(page: Page, extra: Sequence[torch.Tensor] = ()):
    """(datas, valids, datas2, idx, extras): the live rows of every column
    on the host, strings as their values, arrays, maps and rows as JSON
    text (codes are process-local; wire_to_page re-encodes into the
    receiver's dictionary), plus `extra` device tensors of the page's
    capacity brought along in the same transfer (full length, not
    compacted)."""
    flat: list = [page.live_mask()]
    for c in page.columns:
        flat.extend((c.data, c.valid, c.data2))
    flat.extend(extra)
    host = _to_host(flat)
    live = np.asarray(host[0], dtype=np.bool_)
    idx = np.nonzero(live)[0]
    datas, valids, datas2 = [], [], []
    for i, col in enumerate(page.columns):
        hdata, hvalid, hdata2 = host[1 + 3 * i: 4 + 3 * i]
        data = hdata[idx]
        if col.type.is_dict_object:
            data_obj = np.empty(len(idx), dtype=object)
            if len(idx):
                # one JSON text per distinct value, gathered by code
                uniq, inv = np.unique(
                    np.clip(data, 0, max(len(col.dictionary) - 1, 0)), return_inverse=True
                )
                text = np.empty(len(uniq), dtype=object)
                text[:] = [json.dumps(_to_json(v)) for v in col.dictionary.values[uniq]]
                data_obj[:] = text[inv]
            data = data_obj
        elif col.type.is_string:
            data = (
                col.dictionary.values[np.clip(data, 0, max(len(col.dictionary) - 1, 0))]
                if len(idx)
                else np.array([], dtype=object)
            )
        datas.append(data)
        valids.append(None if hvalid is None else np.asarray(hvalid, np.bool_)[idx])
        datas2.append(None if hdata2 is None else np.asarray(hdata2, np.int64)[idx])
    return datas, valids, datas2, idx, host[1 + 3 * len(page.columns):]


def _wire_columns(datas, valids, datas2, keep) -> dict[str, np.ndarray]:
    cols: dict[str, np.ndarray] = {}
    for i, (d, v, d2) in enumerate(zip(datas, valids, datas2)):
        cols[f"c{i:04d}"] = d[keep]
        if v is not None:
            cols[f"v{i:04d}"] = v[keep]
        if d2 is not None:
            cols[f"d{i:04d}"] = d2[keep]
    return cols


def page_to_wire(page: Page) -> bytes:
    """Serialize a page's live rows as one wire chunk."""
    datas, valids, datas2, _, _ = _host_columns(page)
    return frame_chunk(
        page_serde().serialize_columns(_wire_columns(datas, valids, datas2, slice(None)))
    )


def _chunk_blob_columns(cols_p: dict, n: int, chunk_rows: int) -> list[bytes]:
    nchunks = max(1, -(-n // chunk_rows))
    out = []
    for c in range(nchunks):
        sl = slice(c * chunk_rows, min((c + 1) * chunk_rows, n))
        out.append(frame_chunk(
            page_serde().serialize_columns({k: v[sl] for k, v in cols_p.items()})
        ))
    return out


def page_to_wire_chunks(page: Page, chunk_rows: int = 0) -> list[bytes]:
    """Serialize a page as independently decodable wire chunks of at most
    `chunk_rows` live rows each (reference: PartitionedOutputBuffer pages)."""
    chunk_rows = chunk_rows or CHUNK_ROWS  # late-bound so tests can shrink it
    datas, valids, datas2, idx, _ = _host_columns(page)
    cols = _wire_columns(datas, valids, datas2, slice(None))
    return _chunk_blob_columns(cols, len(idx), chunk_rows)


# ------------------------------------------------------------ host -> device


def wire_to_page(
    blobs: Sequence[bytes], types: Sequence[Type], pad_pow2: bool = False, device="cuda",
) -> Page:
    """Concatenate wire chunks from several producers into one page on
    `device`.  No rows give a 1-row all-dead page (kernels need a capacity
    of at least 1).  `pad_pow2` pads the capacity to the next power of two
    with dead rows, so slices of varying sizes share O(log n) shapes and
    one set of learned capacities."""
    dev = resolve_device(device)
    serde = page_serde()
    # unframe_chunk verifies each crc32; blobs without a frame (raw serde
    # output) pass through untouched
    parts = [
        serde.deserialize_columns(unframe_chunk(b) if b[:4] == FRAME_MAGIC else b)
        for b in blobs
    ]
    total = sum(len(p["c0000"]) for p in parts if "c0000" in p) if types else 0
    if total == 0:
        cols = []
        for t in types:
            data = np.zeros((1,), dtype=object if t.is_string or t.is_dict_object else t.np_dtype)
            if t.is_string:
                data[0] = ""
            elif t.is_dict_object:
                data[0] = ()
            cols.append(Column.from_numpy(t, data, device=dev))
        return Page(tuple(cols), torch.zeros((1,), dtype=torch.bool, device=dev))
    cap = 1 << max(0, (total - 1).bit_length()) if pad_pow2 else total
    columns: list[Column] = []
    for i, t in enumerate(types):
        ck, vk, dk = f"c{i:04d}", f"v{i:04d}", f"d{i:04d}"
        wire_obj = t.is_string or t.is_dict_object  # object lanes on the wire
        datas = [p[ck] for p in parts if ck in p]
        data = (np.concatenate(datas) if datas
                else np.empty((0,), dtype=object if wire_obj else t.np_dtype))
        n = len(data)
        valid = None
        if any(vk in p for p in parts):
            vparts = []
            for p in parts:
                if vk in p:
                    vparts.append(p[vk].astype(np.bool_))
                elif ck in p:
                    vparts.append(np.ones(len(p[ck]), dtype=np.bool_))
            valid = np.concatenate(vparts) if vparts else None
        if t.is_string and valid is not None and len(data):
            # re-home NULL slots to a real value before dictionary encoding
            data = data.copy()
            data[~valid] = ""
        if t.is_dict_object:
            # JSON text -> canonical tuples, one parse per distinct text;
            # Column.from_numpy re-encodes them into this side's dictionary
            decoded = np.empty(len(data), dtype=object)
            parsed: dict = {}
            for j, s in enumerate(data):
                if not (isinstance(s, str) and s):
                    decoded[j] = ()
                    continue
                v = parsed.get(s)
                if v is None:
                    v = parsed[s] = _from_json(json.loads(s))
                decoded[j] = v
            data = decoded
        hi = None
        if any(dk in p for p in parts):
            # decimal128 high limb: producers that stayed single-lane send no
            # "d" key — their high limb is the sign extension of the lane
            hparts = []
            for p in parts:
                if dk in p:
                    hparts.append(np.asarray(p[dk], np.int64))
                elif ck in p:
                    hparts.append(np.asarray(p[ck], np.int64) >> 63)
            hi = np.concatenate(hparts) if hparts else np.empty((0,), np.int64)
        if cap > n:
            fill = np.zeros((cap - n,), dtype=object if wire_obj else t.np_dtype)
            if t.is_string:
                fill[:] = ""
            elif t.is_dict_object:
                for j in range(len(fill)):
                    fill[j] = ()
            data = np.concatenate([data, fill])
            if valid is not None:
                valid = np.concatenate([valid, np.zeros(cap - n, np.bool_)])
            if hi is not None:
                hi = np.concatenate([hi, np.zeros(cap - n, np.int64)])
        if hi is not None:
            columns.append(Column(
                t,
                torch.from_numpy(np.array(data, dtype=np.int64)).to(dev),
                None if valid is None else torch.from_numpy(np.array(valid, np.bool_)).to(dev),
                None,
                torch.from_numpy(np.array(hi, dtype=np.int64)).to(dev),
            ))
        else:
            columns.append(Column.from_numpy(t, data, valid, device=dev))
    live = None
    if cap > total:
        live = torch.arange(cap, device=dev) < total
    return Page(tuple(columns), live)


# ------------------------------------------------------------ partitioning


def _mix64_np(x: np.ndarray) -> np.ndarray:
    x = x + np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def bucket_assignments(arrays: dict, key_cols: Sequence[str], nbuckets: int) -> np.ndarray:
    """Row -> bucket id by THE engine partition hash (the same chain as
    partition_page below), so connector-bucketed tables line up with the
    engine's hash partitioning (reference: ConnectorNodePartitioningProvider
    + BucketNodeMap).  NULL keys go to bucket 0, as in the exchanges."""
    import hashlib

    n = len(next(iter(arrays.values()))) if arrays else 0
    h = np.zeros(n, dtype=np.uint64)
    ok = np.ones(n, dtype=bool)
    for c in key_cols:
        vals = arrays[c]
        if isinstance(vals, np.ma.MaskedArray):
            ok &= ~np.ma.getmaskarray(vals)
            vals = np.ma.getdata(vals)
        if vals.dtype == object:
            # string value hash: the blake2b-8 of Dictionary.hash64()
            bits = np.asarray(
                [
                    int.from_bytes(
                        hashlib.blake2b(str(v).encode(), digest_size=8).digest(), "little"
                    )
                    for v in vals
                ],
                dtype=np.uint64,
            )
        elif np.issubdtype(vals.dtype, np.floating):
            bits = vals.astype(np.float64).view(np.uint64)
        else:
            bits = vals.astype(np.int64).view(np.uint64)
        h = _mix64_np(h ^ _mix64_np(bits))
    b = (h % np.uint64(max(nbuckets, 1))).astype(np.int64)
    return np.where(ok, b, 0)


def partition_ids(page: Page, keys: Sequence[IrExpr], nparts: int) -> torch.Tensor:
    """Part id per row (int64, on the page's device) by the engine
    partition hash: h = mix64(h ^ mix64(bits)) over the keys, part =
    h mod nparts with h read as UNSIGNED.  VARCHAR keys hash by dictionary
    VALUE (Dictionary.hash64, stable across dictionaries), doubles by their
    f64 bits, decimal128 keys mix the high limb in where it adds to the sign
    extension of the low lane (ops/relops.py _combined_hash); a row with a
    NULL key goes to part 0."""
    from ..ops.relops import _mix64

    cap = page.capacity
    dev = page.device
    cols = [column_val(c) for c in page.columns]
    h = torch.zeros((cap,), dtype=torch.int64, device=dev)
    keys_ok = torch.ones((cap,), dtype=torch.bool, device=dev)
    for k in keys:
        kv = eval_expr(k, cols, cap, dev)
        if kv.valid is not None:
            keys_ok = keys_ok & kv.valid
        if kv.dict is not None:
            table = torch.from_numpy(kv.dict.hash64().view(np.int64)).to(dev)
            bits = table.index_select(0, kv.data.to(torch.int64).clamp(0, table.shape[0] - 1))
        elif kv.data.dtype.is_floating_point:
            bits = kv.data.to(torch.float64).view(torch.int64)
        else:
            bits = kv.data.to(torch.int64)
            if kv.data2 is not None:
                hi = kv.data2.to(torch.int64)
                extra = torch.where(hi == (bits >> 63), torch.zeros_like(hi), _mix64(hi))
                bits = bits ^ extra
        h = _mix64(h ^ _mix64(bits))
    n = max(int(nparts), 1)
    # unsigned remainder of int64 lanes: u = h + 2^64 for h < 0, so
    # u mod n = (h mod n + 2^64 mod n) mod n (torch.remainder is >= 0 for n > 0)
    r = torch.remainder(h, n)
    part = torch.where(h < 0, torch.remainder(r + (1 << 64) % n, n), r)
    return torch.where(keys_ok, part, torch.zeros_like(part))


def partition_page(
    page: Page, keys: Sequence[IrExpr], nparts: int, chunk_rows: int = 0
) -> list[list[bytes]]:
    """Hash-route the live rows into `nparts` lists of wire chunks
    (reference: PagePartitioner.partitionPage:135 feeding
    PartitionedOutputBuffer).  The part ids ride the page's one transfer."""
    chunk_rows = chunk_rows or CHUNK_ROWS  # late-bound so tests can shrink it
    part = partition_ids(page, keys, nparts)
    datas, valids, datas2, idx, (part_host,) = _host_columns(page, (part,))
    part_live = np.asarray(part_host, np.int64)[idx]
    # one stable sort by part: each part is then a slice, its rows in page
    # order (as a mask per part would give them, at one pass per part)
    order = np.argsort(part_live, kind="stable")
    bounds = np.concatenate([[0], np.cumsum(np.bincount(part_live, minlength=nparts))])
    cols = _wire_columns(datas, valids, datas2, order)
    out = []
    for p in range(nparts):
        lo, hi = int(bounds[p]), int(bounds[p + 1])
        out.append(_chunk_blob_columns({k: v[lo:hi] for k, v in cols.items()}, hi - lo, chunk_rows))
    return out
