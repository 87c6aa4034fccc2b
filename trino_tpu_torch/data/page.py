"""Columnar data plane: device-resident pages.

The reference's unit of data flow is the Page -- an immutable list of columnar
Blocks plus a position count (spi/Page.java:31, spi/block/Block.java:21).
The port keeps the page as a struct-of-arrays of torch tensors with static
capacity:

- every column is one fixed-width dtype tensor on the page's device:
  decimals int64 (plus the `data2` high limb for decimal128), dates int32,
  doubles float64, booleans bool.  64-bit lanes stay 64-bit: the card has
  native int64, so nothing is narrowed at upload.
- NULLs are a per-column bool validity mask (the reference's isNull bitmap)
- a page-level `live` bool mask marks which of the `capacity` rows logically
  exist.  Filters set the mask instead of compacting, so operator outputs
  keep the capacities the capacity-retry protocol fixed for them.
- VARCHAR columns are int32 codes on the device plus a host-side Dictionary
  (the reference's DictionaryBlock made mandatory; see data/types.py).

Constructors take an explicit `device` (default CUDA; the CPU only when the
caller asks for it).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from .types import BOOLEAN, DATE, Type, days_to_date

__all__ = ["Dictionary", "Column", "Page"]

# content-keyed Dictionary intern table (Dictionary.intern): tuple(values)
# -> the one shared instance.  Bounded LRU; very large dictionaries bypass
# it so the key tuples never dominate memory.
import threading as _threading
from collections import OrderedDict as _OrderedDict

_INTERN: "_OrderedDict[tuple, Dictionary]" = _OrderedDict()
_INTERN_LOCK = _threading.Lock()
_INTERN_MAX_ENTRIES = 4096
_INTERN_MAX_VALUES = 65536


class Dictionary:
    """Host-side string dictionary for a VARCHAR column.

    Identity-hashed: dictionaries are built once at ingest and shared by
    reference.
    """

    __slots__ = ("values", "_index", "_hash64")

    def __init__(self, values: np.ndarray):
        self.values = np.asarray(values, dtype=object)
        self._index: Optional[dict] = None
        self._hash64: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.values)

    def code_of(self, value: str) -> int:
        """Return the code for ``value``, or -1 if absent."""
        if self._index is None:
            self._index = {v: i for i, v in enumerate(self.values)}
        return self._index.get(value, -1)

    def mask_where(self, predicate) -> np.ndarray:
        """Evaluate a host predicate over dictionary values -> bool[len].

        This is how string predicates (LIKE, comparisons) run: evaluate once
        on the (small) dictionary on host, then gather the mask by code on
        device.  The reference evaluates per row; per-distinct-value is the
        dictionary-aware fast path (DictionaryAwarePageProjection.java).
        """
        return np.array([bool(predicate(v)) for v in self.values], dtype=np.bool_)

    def hash64(self) -> np.ndarray:
        """uint64 hash per dictionary VALUE (blake2b-8), computed once.

        This is THE value-hash for strings: hash-partitioning (runtime/
        wire.py), device repartition, and string-keyed joins (ops/relops.py
        _combined_hash) must all route equal strings identically even when
        their columns' code spaces differ — sharing this one table is what
        guarantees it.  Always at least one entry (kernels gather from it)."""
        if self._hash64 is None:
            import hashlib

            table = np.asarray(
                [
                    int.from_bytes(
                        hashlib.blake2b(str(v).encode(), digest_size=8).digest(),
                        "little",
                    )
                    for v in self.values
                ],
                dtype=np.uint64,
            )
            if len(table) == 0:
                table = np.zeros((1,), dtype=np.uint64)
            self._hash64 = table
        return self._hash64

    def sorted_rank(self) -> np.ndarray:
        """rank[code] = rank of the value in sorted order, for ORDER BY."""
        try:
            order = np.argsort(self.values, kind="stable")
        except TypeError:
            # structured values with None fields are not < -comparable;
            # a deterministic surrogate order keeps grouping/distinct sound
            # (ORDER BY on such values has no defined order anyway)
            order = np.asarray(
                sorted(range(len(self.values)), key=lambda i: repr(self.values[i])),
                dtype=np.int64,
            )
        rank = np.empty(len(self.values), dtype=np.int32)
        rank[order] = np.arange(len(self.values), dtype=np.int32)
        return rank

    @staticmethod
    def intern(values: np.ndarray) -> "Dictionary":
        """Content-interned construction: equal value-sets share ONE
        Dictionary object.  Operators compare dictionaries by IDENTITY
        (a same-dictionary string compare is a code compare), so a fresh
        object per scan would lose that fast path on every query.
        Sharing is safe exactly because content is equal — decoding through
        either object yields the same strings.  Oversized or unhashable
        value-sets skip the table (bounded memory, graceful fallback)."""
        if len(values) > _INTERN_MAX_VALUES:
            return Dictionary(values)
        try:
            key = tuple(values)
            hash(key)
        except TypeError:
            return Dictionary(values)
        with _INTERN_LOCK:
            d = _INTERN.get(key)
            if d is not None:
                _INTERN.move_to_end(key)
                return d
            d = Dictionary(values)
            _INTERN[key] = d
            while len(_INTERN) > _INTERN_MAX_ENTRIES:
                _INTERN.popitem(last=False)
            return d

    @staticmethod
    def encode(values: Sequence[str]) -> tuple[np.ndarray, "Dictionary"]:
        arr = np.asarray(values, dtype=object)
        uniq, codes = np.unique(arr, return_inverse=True)
        return codes.astype(np.int32), Dictionary.intern(uniq)

    @staticmethod
    def encode_arrays(values: Sequence) -> tuple[np.ndarray, "Dictionary"]:
        """Encode a column of arrays (lists/tuples) as codes into a dictionary
        of distinct tuples (ARRAY columns use the same codes+dict lowering as
        VARCHAR — data/types.py ArrayType)."""
        return Dictionary.encode_objects(
            values,
            lambda v: tuple(v) if isinstance(v, (list, tuple, np.ndarray)) else (),
        )

    @staticmethod
    def encode_objects(values: Sequence, canon) -> tuple[np.ndarray, "Dictionary"]:
        """Encode a column of structured objects (arrays/maps/rows) as codes
        into a dictionary of canonical hashable forms (maps: key-sorted tuple
        of pairs; rows: field tuples) — equal values share one code, so
        equality, grouping and joins work on codes like every dict column.
        Interned with a hash map, NOT np.unique: canonical tuples may hold
        None (null fields/values), which sorting would crash on."""
        index: dict = {}
        interned: list = []
        codes = np.empty(len(values), dtype=np.int32)
        for i, v in enumerate(values):
            c = canon(v)
            code = index.get(c)
            if code is None:
                code = len(interned)
                index[c] = code
                interned.append(c)
            codes[i] = code
        uniq = np.empty(len(interned), dtype=object)
        uniq[:] = interned
        return codes, Dictionary.intern(uniq)

    def __repr__(self) -> str:
        return f"Dictionary({len(self.values)} values)"


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:
        arr = arr.copy()  # torch tensors cannot wrap read-only memory
    return torch.from_numpy(arr).to(device)


@dataclass
class Column:
    """One column of a page: device data + optional validity + optional dict.
    data2: decimal128 high limb (data/dec128.py) — value = data2*2^64 +
    u64(data); None everywhere else."""

    type: Type
    data: torch.Tensor
    valid: Optional[torch.Tensor] = None  # bool mask; None == all valid
    dictionary: Optional[Dictionary] = None
    data2: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    @property
    def device(self) -> torch.device:
        return self.data.device

    @staticmethod
    def from_numpy(
        type_: Type,
        values: np.ndarray,
        valid: Optional[np.ndarray] = None,
        device="cuda",
    ) -> "Column":
        dev = resolve_device(device)
        if isinstance(values, np.ma.MaskedArray):
            mask = np.ma.getmaskarray(values)
            fill = "" if type_.is_string else 0
            values = values.filled(fill)
            if mask.any():
                ok = ~mask
                valid = ok if valid is None else (np.asarray(valid) & ok)
        dvalid = None if valid is None else _to_device(np.asarray(valid, np.bool_), dev)
        if type_.is_array:
            codes, dictionary = Dictionary.encode_arrays(values)
            return Column(type_, _to_device(codes, dev), dvalid, dictionary)
        if type_.is_map:
            codes, dictionary = Dictionary.encode_objects(values, _canon_map)
            return Column(type_, _to_device(codes, dev), dvalid, dictionary)
        if type_.is_row:
            codes, dictionary = Dictionary.encode_objects(values, _canon_row)
            return Column(type_, _to_device(codes, dev), dvalid, dictionary)
        if type_.is_string:
            codes, dictionary = Dictionary.encode(values)
            return Column(type_, _to_device(codes, dev), dvalid, dictionary)
        if (
            type_.is_decimal
            and type_.precision > 18
            and np.asarray(values).dtype == object
        ):
            # object lanes can hold beyond-int64 magnitudes; numeric-dtype
            # inputs by construction already fit the single lane
            vo = np.asarray(values, dtype=object)
            from .dec128 import needs_limbs, to_limbs

            flat = [None if (valid is not None and not valid[i]) else vo[i]
                    for i in range(len(vo))]
            if needs_limbs(flat):
                lo, hi = to_limbs(flat)
                return Column(
                    type_, _to_device(lo, dev), dvalid, None, _to_device(hi, dev)
                )
            values = np.asarray([0 if v is None else int(v) for v in flat],
                                dtype=np.int64)
        arr = np.asarray(values, dtype=type_.np_dtype)
        return Column(type_, _to_device(arr, dev), dvalid)


@dataclass
class Page:
    """A fixed-capacity horizontal slice of a relation (spi/Page.java:31)."""

    columns: tuple[Column, ...]
    live: Optional[torch.Tensor] = None  # bool[capacity]; None == all rows live

    @property
    def capacity(self) -> int:
        if self.columns:
            return self.columns[0].capacity
        return 0 if self.live is None else int(self.live.shape[0])

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    @property
    def device(self) -> torch.device:
        if self.columns:
            return self.columns[0].device
        if self.live is not None:
            return self.live.device
        raise ValueError("empty page has no device")

    def live_mask(self) -> torch.Tensor:
        if self.live is None:
            return torch.ones((self.capacity,), dtype=torch.bool, device=self.device)
        return self.live

    def row_count(self) -> torch.Tensor:
        """Number of live rows (device scalar)."""
        if self.live is None:
            return torch.tensor(self.capacity, dtype=torch.int32, device=self.device)
        return self.live.sum(dtype=torch.int32)

    def with_live(self, live: Optional[torch.Tensor]) -> "Page":
        return Page(self.columns, live)

    def select_columns(self, indices: Sequence[int]) -> "Page":
        return Page(tuple(self.columns[i] for i in indices), self.live)

    def _fetch_host(self):
        """(live, [(data, valid, data2), ...]) as numpy arrays."""

        def host(t):
            return None if t is None else t.detach().cpu().numpy()

        live = (
            np.ones((self.capacity,), np.bool_) if self.live is None
            else host(self.live)
        )
        return live, [(host(c.data), host(c.valid), host(c.data2)) for c in self.columns]

    # -- host-side materialization (result sets, test assertions) -----------
    def to_pylist(self) -> list[tuple]:
        """Compact live rows to host as Python tuples (None for NULL)."""
        live, host_cols = self._fetch_host()
        idx = np.nonzero(live)[0]
        cols: list[np.ndarray] = []
        valids: list[Optional[np.ndarray]] = []
        pys: list[Any] = []
        for col, (hdata, hvalid, hdata2) in zip(self.columns, host_cols):
            data = np.asarray(hdata)[idx]
            valid = None if hvalid is None else np.asarray(hvalid)[idx]
            data2 = None if hdata2 is None else np.asarray(hdata2)[idx]
            if col.type.is_map:
                vals = (
                    col.dictionary.values[np.clip(data, 0, max(len(col.dictionary) - 1, 0))]
                    if len(idx)
                    else np.array([], dtype=object)
                )
                out_arr = np.empty(len(vals), dtype=object)
                for i, v in enumerate(vals):
                    out_arr[i] = dict(v)
                pys.append(out_arr)
            elif col.type.is_row:
                vals = (
                    col.dictionary.values[np.clip(data, 0, max(len(col.dictionary) - 1, 0))]
                    if len(idx)
                    else np.array([], dtype=object)
                )
                pys.append(vals)
            elif col.type.is_array:
                vals = (
                    col.dictionary.values[np.clip(data, 0, max(len(col.dictionary) - 1, 0))]
                    if len(idx)
                    else np.array([], dtype=object)
                )
                out_arr = np.empty(len(vals), dtype=object)
                for i, v in enumerate(vals):
                    out_arr[i] = list(v)
                pys.append(out_arr)
            elif col.type.is_string:
                vals = col.dictionary.values[np.clip(data, 0, max(len(col.dictionary) - 1, 0))] if len(idx) else np.array([], dtype=object)
                pys.append(vals)
            elif col.type == DATE:
                # only valid rows decode: a NULL's lane may hold an empty
                # group's min/max sentinel, which is no date
                pys.append(np.array(
                    [days_to_date(d).isoformat() if valid is None or valid[i] else None
                     for i, d in enumerate(data)],
                    dtype=object,
                ))
            elif col.type == BOOLEAN:
                pys.append(data.astype(bool))
            elif col.type.is_floating:
                pys.append(data.astype(float))
            elif col.type.is_decimal:
                if col.type.precision > 18:
                    # long decimal: exact python Decimal surface whether or
                    # not the magnitude forced a second limb — one client
                    # type per SQL type, not per runtime representation
                    from decimal import Decimal

                    from .dec128 import combine_py

                    vals = np.empty(len(data), dtype=object)
                    for i in range(len(data)):
                        unscaled = (
                            combine_py(int(data2[i]), int(data[i]))
                            if data2 is not None
                            else int(data[i])
                        )
                        vals[i] = (
                            Decimal(unscaled).scaleb(-col.type.scale)
                            if col.type.scale else Decimal(unscaled)
                        )
                    pys.append(vals)
                else:
                    # scaled int64 -> float (result-set surface; int64/10^s
                    # is exact in f64 for short decimals)
                    pys.append(data.astype(np.int64) / (10.0 ** col.type.scale))
            else:
                pys.append(data)
            valids.append(valid)
        rows = []
        for r in range(len(idx)):
            rows.append(
                tuple(
                    None if (valids[c] is not None and not valids[c][r]) else _pyval(pys[c][r])
                    for c in range(len(self.columns))
                )
            )
        return rows

    def to_numpy_columns(self) -> list[np.ndarray]:
        """Compact live rows to host column arrays (connector write path:
        VARCHAR decodes to object strings, DATE stays as day counts).

        Columns containing NULLs come back as ``np.ma.MaskedArray`` (mask ==
        isNull) so CREATE TABLE AS / INSERT...SELECT persist validity instead
        of the garbage lane values (the reference's Block keeps its isNull
        bitmap through the ConnectorPageSink write path)."""
        live, host_cols = self._fetch_host()
        idx = np.nonzero(live)[0]
        out: list[np.ndarray] = []
        for col, (hdata, hvalid, hdata2) in zip(self.columns, host_cols):
            data = np.asarray(hdata)[idx]
            if hdata2 is not None:
                # limbed decimal128: persist exact unscaled ints (object
                # lanes) so a write+re-read round-trips through from_numpy
                from .dec128 import combine_py

                hi = np.asarray(hdata2)[idx]
                vals = np.empty(len(data), dtype=object)
                for i in range(len(data)):
                    vals[i] = combine_py(int(hi[i]), int(data[i]))
                data = vals
            if col.type.is_dict_object or col.type.is_string:
                if len(idx):
                    data = col.dictionary.values[
                        np.clip(data, 0, max(len(col.dictionary) - 1, 0))
                    ]
                else:
                    data = np.array([], dtype=object)
            if hvalid is not None:
                invalid = ~np.asarray(hvalid)[idx]
                if invalid.any():
                    data = np.ma.MaskedArray(data, mask=invalid)
            out.append(data)
        return out

    @staticmethod
    def from_numpy(
        types: Sequence[Type], arrays: Sequence[np.ndarray], device="cuda"
    ) -> "Page":
        assert len(types) == len(arrays)
        lengths = {len(a) for a in arrays}
        assert len(lengths) <= 1, f"ragged page: column lengths {sorted(lengths)}"
        return Page(
            tuple(
                Column.from_numpy(t, a, device=device) for t, a in zip(types, arrays)
            )
        )


def _pyval(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (np.bool_,)):
        return bool(v)
    return v


def _canon_map(v) -> tuple:
    """Canonical hashable map form: (key, value) pairs sorted by key."""
    if isinstance(v, dict):
        return tuple(sorted(v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(sorted(tuple(p) for p in v))
    return ()


def _canon_row(v) -> tuple:
    if isinstance(v, dict):  # pyarrow structs come back as dicts
        return tuple(v.values())
    if isinstance(v, (list, tuple)):
        return tuple(v)
    return ()
