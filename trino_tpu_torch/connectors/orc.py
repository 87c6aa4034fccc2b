"""ORC filesystem connector: stripe-split file ingestion → HBM pages.

Reference: lib/trino-orc (29.8k LoC — OrcReader.java:67,
createRecordReader:252, OrcRecordReader.nextPage:432) read by the Hive
connector with one split per stripe range.

Same TPU-native shape as the Parquet connector (connectors/parquet.py):
host-side columnar decode (pyarrow.orc) straight into numpy SoA arrays;
splits are STRIPES (ORC's parallelism unit); strings dictionary-encode at
ingest.  A directory is a table (all *.orc files), a single file is a
table; CTAS/INSERT write one ORC file per batch.

A copy of the JAX package's module.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from .parquet import (
    _FileWriteTxnMixin, _arrow_to_type, _column_to_numpy, _numpy_to_arrow,
)
from .spi import ColumnSchema, Connector, Split, TableSchema

__all__ = ["OrcConnector"]


def _orc():
    import pyarrow.orc as orc

    return orc


@dataclass(frozen=True)
class _StripeGroup:
    path: str
    stripes: tuple[int, ...]


class OrcConnector(_FileWriteTxnMixin, Connector):
    name = "orc"
    _EXT = ".orc"

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.generation = 0
        self._schema_cache: dict[str, TableSchema] = {}
        self._split_plan: dict = {}
        self._declared: dict[str, TableSchema] = {}

    # ----------------------------------------------------------- metadata
    def _table_files(self, table: str) -> list[str]:
        cand_dir = os.path.join(self.root, table)
        if os.path.isdir(cand_dir):
            files = sorted(
                os.path.join(cand_dir, f)
                for f in os.listdir(cand_dir)
                if f.endswith(".orc")
            )
            if not files:
                raise FileNotFoundError(f"no orc files in {cand_dir}")
            return files
        cand_file = os.path.join(self.root, table + ".orc")
        if os.path.isfile(cand_file):
            return [cand_file]
        raise FileNotFoundError(f"no such orc table: {table}")

    def list_tables(self) -> list[str]:
        out = set(self._declared)
        for name in sorted(os.listdir(self.root)):
            p = os.path.join(self.root, name)
            if name.endswith(".orc") and os.path.isfile(p):
                out.add(name[: -len(".orc")])
            elif os.path.isdir(p) and any(f.endswith(".orc") for f in os.listdir(p)):
                out.add(name)
        return sorted(out)

    def table_schema(self, table: str) -> TableSchema:
        if table not in self._schema_cache:
            orc = _orc()
            f = orc.ORCFile(self._table_files(table)[0])
            arrow_schema = f.schema
            cols = tuple(
                ColumnSchema(n, _arrow_to_type(t))
                for n, t in zip(arrow_schema.names, arrow_schema.types)
            )
            self._schema_cache[table] = TableSchema(table, cols)
        return self._schema_cache[table]

    def estimated_row_count(self, table: str) -> Optional[int]:
        orc = _orc()
        return sum(orc.ORCFile(p).nrows for p in self._table_files(table))

    # -------------------------------------------------------------- scans
    def get_splits(self, table: str, desired_parts: int) -> list[Split]:
        orc = _orc()
        key = (table, desired_parts)
        if key not in self._split_plan:
            units: list[tuple[str, int]] = []
            try:
                files = self._table_files(table)
            except FileNotFoundError:
                files = []
            for path in files:
                for s in range(_orc().ORCFile(path).nstripes):
                    units.append((path, s))
            parts: list[list[tuple[str, int]]] = [
                [] for _ in range(max(1, desired_parts))
            ]
            for i, u in enumerate(units):
                parts[i % len(parts)].append(u)
            self._split_plan[key] = parts
        return [
            Split(self.name, table, i, max(1, desired_parts))
            for i in range(len(self._split_plan[key]))
        ]

    def read_split(self, split: Split, columns: Sequence[str]) -> dict[str, np.ndarray]:
        import pyarrow as pa

        orc = _orc()
        schema = self.table_schema(split.table)
        units = self._split_plan[(split.table, split.num_parts)][split.part]
        batches = []
        open_files: dict[str, object] = {}
        for path, stripe in units:
            if path not in open_files:
                open_files[path] = orc.ORCFile(path)
            batches.append(open_files[path].read_stripe(stripe, columns=list(columns)))
        out: dict[str, np.ndarray] = {}
        if not batches:
            for c in columns:
                t = schema.type_of(c)
                out[c] = np.empty((0,), dtype=object if t.is_string else t.np_dtype)
            return out
        tbl = pa.Table.from_batches(
            [b if isinstance(b, pa.RecordBatch) else b.to_batch() for b in batches]
        )
        for c in columns:
            out[c] = _column_to_numpy(tbl.column(c), schema.type_of(c))
        return out

    # ------------------------------------------------------------- writes
    def create_table(self, table: str, columns: Sequence[ColumnSchema]) -> None:
        dirp = os.path.join(self.root, table)
        os.makedirs(dirp, exist_ok=True)
        self._declared[table] = TableSchema(table, tuple(columns))
        self._schema_cache[table] = self._declared[table]
        self._invalidate(table)

    def insert(self, table: str, columns: dict[str, np.ndarray]) -> int:
        import pyarrow as pa

        orc = _orc()
        schema = self._schema_cache.get(table) or self.table_schema(table)
        cols = {
            cs.name: _numpy_to_arrow(columns[cs.name], cs.type)
            for cs in schema.columns
        }
        t = pa.table(cols)
        dirp = os.path.join(self.root, table)
        os.makedirs(dirp, exist_ok=True)
        part = len([f for f in os.listdir(dirp) if f.endswith(".orc")])
        orc.write_table(t, os.path.join(dirp, f"part-{part}.orc"))
        self._invalidate(table)
        return t.num_rows

    def _write_part_file(self, path: str, schema: TableSchema, cols: dict) -> int:
        import pyarrow as pa

        orc = _orc()
        arrays = {
            cs.name: _numpy_to_arrow(cols[cs.name], cs.type)
            for cs in schema.columns
        }
        t = pa.table(arrays)
        orc.write_table(t, path)
        return t.num_rows

    def truncate(self, table: str) -> None:
        schema = self._schema_cache.get(table) or self.table_schema(table)
        dirp = os.path.join(self.root, table)
        if os.path.isdir(dirp):
            for f in os.listdir(dirp):
                if f.endswith(self._EXT):
                    os.remove(os.path.join(dirp, f))
        self._declared[table] = schema
        self._schema_cache[table] = schema
        self._invalidate(table)

    def _invalidate(self, table: str) -> None:
        self.generation += 1
        self._split_plan = {k: v for k, v in self._split_plan.items() if k[0] != table}
