"""TPC-DS connector (reference: plugin/trino-tpcds — TpcdsMetadata,
TpcdsSplitManager over generated data).  Deterministic numpy generation,
full 24-table standard schema (generator.py).

Note on NULL foreign keys: dsdgen emits NULL FKs in fact tables; this
generator encodes them as -1 sentinel keys (they equally never match a
dimension SK in equi-joins, and the sqlite oracle sees the identical data,
so differential results agree).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..spi import ColumnSchema, Connector, Split, TableSchema
from .generator import SCALE_TINY, TPCDS_SCHEMAS, generate_table

__all__ = ["TpcdsConnector", "TPCDS_SCHEMAS", "tpcds_data", "SCALE_TINY"]

_CACHE: dict[tuple[str, float], dict[str, np.ndarray]] = {}


def tpcds_data(table: str, scale: float) -> dict[str, np.ndarray]:
    key = (table, scale)
    if key not in _CACHE:
        _CACHE[key] = generate_table(table, scale)
    return _CACHE[key]


class TpcdsConnector(Connector):
    name = "tpcds"

    def __init__(self, scale: float = SCALE_TINY):
        self.scale = scale

    def list_tables(self) -> list[str]:
        return sorted(TPCDS_SCHEMAS)

    def table_schema(self, table: str) -> TableSchema:
        if table not in TPCDS_SCHEMAS:
            raise KeyError(f"tpcds table not found: {table}")
        return TableSchema(
            table, tuple(ColumnSchema(n, t) for n, t in TPCDS_SCHEMAS[table])
        )

    def get_splits(self, table: str, desired_parts: int) -> list[Split]:
        return [Split("tpcds", table, p, desired_parts) for p in range(desired_parts)]

    def read_split(self, split: Split, columns: Sequence[str]) -> dict[str, np.ndarray]:
        data = tpcds_data(split.table, self.scale)
        n = len(next(iter(data.values())))
        lo = split.part * n // split.num_parts
        hi = (split.part + 1) * n // split.num_parts
        return {c: data[c][lo:hi] for c in columns}

    def estimated_row_count(self, table: str) -> Optional[int]:
        data = _CACHE.get((table, self.scale))
        if data is not None:
            return len(next(iter(data.values())))
        from .generator import _date_dim_size, _rows

        if table == "date_dim":
            return _date_dim_size()
        return _rows(table, self.scale)
