"""Faker connector: deterministic synthetic rows for any declared schema.

Reference: plugin/trino-faker (3.7k LoC) — create a table with a schema and
the connector materializes plausible random data for it, for load tests and
demos.  Here generation is split-stable and fully deterministic: a value
depends only on (table, column, row index), so distributed scans over any
split layout return identical relations — the same property the TPC-H
generator guarantees and the differential tests rely on.

    conn = FakerConnector(default_rows=10_000)
    conn.create_table("users", [ColumnSchema("id", BIGINT), ...], rows=500)

A copy of the JAX package's module.
"""

from __future__ import annotations

import zlib
from typing import Sequence

import numpy as np

from ..data.types import DATE, Type, date_to_days
from .spi import ColumnSchema, Connector, Split, TableSchema, TableStats

__all__ = ["FakerConnector"]

_WORDS = np.asarray(
    "alpha bravo charlie delta echo foxtrot golf hotel india juliet kilo lima "
    "mike november oscar papa quebec romeo sierra tango uniform victor whiskey "
    "xray yankee zulu amber cobalt crimson jade onyx pearl".split(),
    dtype=object,
)


def _rng(table: str, column: str) -> np.random.Generator:
    seed = zlib.crc32(f"{table}.{column}".encode())
    return np.random.default_rng(seed)


class FakerConnector(Connector):
    name = "faker"

    def __init__(self, default_rows: int = 1000):
        self.default_rows = default_rows
        self._tables: dict[str, TableSchema] = {}
        self._rows: dict[str, int] = {}
        self.generation = 0

    # ---- metadata ----------------------------------------------------------
    def list_tables(self) -> list[str]:
        return sorted(self._tables)

    def table_schema(self, table: str) -> TableSchema:
        if table not in self._tables:
            raise KeyError(f"faker table not found: {table}")
        return self._tables[table]

    def create_table(
        self, name: str, columns: Sequence[ColumnSchema], rows: int = 0
    ) -> None:
        if name in self._tables:
            raise ValueError(f"table already exists: {name}")
        self._tables[name] = TableSchema(name, tuple(columns))
        self._rows[name] = rows or self.default_rows
        self.generation += 1

    def drop_table(self, name: str) -> None:
        self._tables.pop(name)
        self._rows.pop(name)
        self.generation += 1

    def estimated_row_count(self, table: str) -> int:
        return self._rows[table]

    def table_stats(self, table: str):
        return TableStats(self._rows[table], {})

    # ---- reads -------------------------------------------------------------
    def get_splits(self, table: str, desired_parts: int) -> list[Split]:
        return [Split("faker", table, p, desired_parts) for p in range(desired_parts)]

    def read_split(self, split: Split, columns: Sequence[str]) -> dict[str, np.ndarray]:
        n = self._rows[split.table]
        lo = split.part * n // split.num_parts
        hi = (split.part + 1) * n // split.num_parts
        schema = self._tables[split.table]
        out: dict[str, np.ndarray] = {}
        for c in columns:
            t = schema.type_of(c)
            # split-stability: generate the WHOLE column (same seed), slice
            # the split's range — values never depend on the split layout
            out[c] = self._gen_column(split.table, c, t, n)[lo:hi]
        return out

    def _gen_column(self, table: str, column: str, t: Type, n: int) -> np.ndarray:
        r = _rng(table, column)
        if t.is_string:
            return _WORDS[r.integers(0, len(_WORDS), size=n)]
        if t == DATE:
            base = date_to_days("2020-01-01")
            return (base + r.integers(0, 1461, size=n)).astype(np.int32)
        if t.is_decimal:
            return r.integers(0, 10 ** min(t.precision, 9), size=n).astype(np.int64)
        if t.is_floating:
            return r.normal(0.0, 100.0, size=n)
        if t.name == "boolean":
            return r.integers(0, 2, size=n).astype(np.bool_)
        return r.integers(0, max(n, 100), size=n).astype(t.np_dtype)

    # ---- writes (INSERT appends are meaningless for generated data) -------
    def insert(self, table: str, columns: dict) -> int:
        raise NotImplementedError("faker tables are generated, not written")

    def begin_write(self, table: str, txn_id: str, operation: str):
        # reject before the txn layer journals an intent: there is nothing
        # to stage, abort, or janitor-sweep for generated data
        raise NotImplementedError("faker tables are generated, not written")
