"""State carried across from the JAX package.

The reference hands its state out as numpy: `Page.to_numpy_columns()` for
whole result pages, and per column the raw `data` / `valid` / `data2`
arrays plus `Dictionary.values`.  These helpers turn either form into the
port's `Page` / `Column` without importing the reference: a caller that
holds both packages (a test, a migration script) passes plain arrays.

With them, any intermediate page of the reference (a scan page, a
post-filter stage, an aggregate's input) can be pushed through the port's
counterpart of the next operator.  `memory_catalog_from_numpy` carries
whole tables: the same numpy columns the reference's MemoryConnector holds
become a port MemoryConnector.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from . import resolve_device
from .data.page import Column, Dictionary, Page, _to_device
from .data.types import Type

__all__ = [
    "column_from_numpy", "page_from_reference", "page_from_lanes",
    "memory_catalog_from_numpy",
]


def _lane_dtype(type_: Type, arr: np.ndarray) -> np.dtype:
    """The port's lane dtype for a column of `type_`.  The reference narrows
    64-bit lanes whose values fit 32 bits at upload; the port keeps every
    lane at its type's width, so narrowed lanes widen back here."""
    if type_.is_string or type_.is_array or type_.is_map or type_.is_row:
        return np.dtype(np.int32)
    if type_.name == "boolean":
        return np.dtype(np.bool_)
    return np.dtype(type_.np_dtype)


def column_from_numpy(
    type_: Type,
    data: np.ndarray,
    valid: Optional[np.ndarray] = None,
    dictionary_values: Optional[np.ndarray] = None,
    data2: Optional[np.ndarray] = None,
    device="cuda",
) -> Column:
    """One column from the reference's raw lanes.

    data: the `Column.data` lanes (dictionary codes for VARCHAR);
    valid: the bool validity mask or None; dictionary_values: the
    `Dictionary.values` object array for dictionary-coded columns;
    data2: the decimal128 high limb or None."""
    dev = resolve_device(device)

    def up(a, dtype=None):
        a = np.asarray(a)
        if dtype is not None:
            a = a.astype(dtype, copy=False)
        return _to_device(a, dev)

    dictionary = None
    if dictionary_values is not None:
        dictionary = Dictionary.intern(np.asarray(dictionary_values, dtype=object))
    return Column(
        type_,
        up(data, _lane_dtype(type_, data)),
        None if valid is None else up(valid, np.bool_),
        dictionary,
        None if data2 is None else up(data2, np.int64),
    )


def page_from_lanes(
    types: Sequence[Type],
    lanes: Sequence[tuple],
    live: Optional[np.ndarray] = None,
    device="cuda",
) -> Page:
    """A page from per-column raw lanes: each entry of `lanes` is
    (data, valid, dictionary_values, data2) as `column_from_numpy` takes
    them; `live` is the page's bool row mask or None."""
    dev = resolve_device(device)
    cols = tuple(
        column_from_numpy(t, d, v, dv, d2, device=dev)
        for t, (d, v, dv, d2) in zip(types, lanes)
    )
    dlive = None
    if live is not None:
        dlive = _to_device(np.asarray(live, np.bool_), dev)
    return Page(cols, dlive)


def page_from_reference(
    names: Sequence[str],
    types: Sequence[Type],
    numpy_columns: Sequence[np.ndarray],
    dictionaries: Optional[Sequence[Optional[np.ndarray]]] = None,
    device="cuda",
) -> Page:
    """A page from what the reference's `Page.to_numpy_columns()` returns:
    compacted live rows, VARCHAR decoded to object strings, NULLs as
    `np.ma.MaskedArray`, limbed decimal128 as python ints in object lanes.

    `dictionaries[i]`, when given, is the reference column's
    `Dictionary.values`: the port's column then keeps the SAME code space
    (codes are looked up in it) instead of re-encoding the strings, so
    dictionary-code group keys line up across the two packages.
    `names` documents the columns and must match `types` in length."""
    if not (len(names) == len(types) == len(numpy_columns)):
        raise ValueError("names, types and numpy_columns differ in length")
    dev = resolve_device(device)
    cols = []
    for i, (t, arr) in enumerate(zip(types, numpy_columns)):
        values = None if dictionaries is None else dictionaries[i]
        if values is None or not t.is_string:
            cols.append(Column.from_numpy(t, arr, device=dev))
            continue
        d = Dictionary.intern(np.asarray(values, dtype=object))
        mask = np.ma.getmaskarray(arr) if isinstance(arr, np.ma.MaskedArray) else None
        raw = np.ma.getdata(arr) if mask is not None else np.asarray(arr, dtype=object)
        codes = np.asarray(
            [0 if (mask is not None and mask[j]) else d.code_of(v)
             for j, v in enumerate(raw)],
            dtype=np.int32,
        )
        if (codes < 0).any():
            raise ValueError(f"column {names[i]}: value outside its dictionary")
        valid = None if mask is None or not mask.any() else ~mask
        cols.append(column_from_numpy(t, codes, valid, d.values, device=dev))
    return Page(tuple(cols))


def memory_catalog_from_numpy(tables: dict):
    """A port `MemoryConnector` holding `tables`: {name: (schema, {column:
    ndarray})}, where schema lists (column name, SQL type name) pairs such as
    ("l_quantity", "decimal(12,2)").  The arrays take the connector's host
    layout: object arrays of str for VARCHAR, day counts for DATE, scaled
    int64 lanes for short decimals, `np.ma.MaskedArray` where a column holds
    NULLs.  A column of the schema missing from the dict, or a dict entry
    outside the schema, raises KeyError."""
    from .connectors.memory import MemoryConnector
    from .connectors.spi import ColumnSchema
    from .data.types import parse_type

    conn = MemoryConnector()
    for name, (schema, data) in tables.items():
        extra = set(data) - {c for c, _ in schema}
        if extra:
            raise KeyError(f"table {name}: columns {sorted(extra)} are not in its schema")
        conn.create_table(name, [ColumnSchema(c, parse_type(t)) for c, t in schema])
        conn.insert(name, {c: data[c] for c, _ in schema})
    return conn
