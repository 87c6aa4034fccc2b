"""In-memory writable connector (reference: plugin/trino-memory — the test
fixture connector) and the /dev/null blackhole connector (reference:
plugin/trino-blackhole — write benchmarks, scheduling tests).

A copy of the JAX package's module.  A bucketed table (`bucketed_by`,
`bucket_count`) reads one split per bucket, its rows assigned by the wire
format's partition hash (runtime/wire.py `bucket_assignments`), so that
`distribute(..., connector_buckets=True)` can take its scans as born
hash-partitioned.  Only a worker runtime that routes splits to tasks by
bucket honours that (the coordinator, ROADMAP A.11); the distributed and
out-of-core executors split scans by row range and plan without it."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..data.types import Type
from .spi import ColumnSchema, Connector, Split, TableSchema

__all__ = ["MemoryConnector", "BlackholeConnector"]


class MemoryConnector(Connector):
    name = "memory"

    def __init__(self) -> None:
        self._tables: dict[str, TableSchema] = {}
        self._data: dict[str, dict[str, np.ndarray]] = {}
        self.generation = 0  # bumped on every write; invalidates scan caches
        # table -> the generation of its last change: scan caches of the
        # other tables survive a write (the connector-wide counter stays
        # the write-conflict token)
        self._table_gen: dict[str, int] = {}
        # table -> (bucket columns, bucket count) for bucketed tables
        self._bucketing: dict[str, tuple[tuple[str, ...], int]] = {}
        # (table, generation) -> per-bucket row-index arrays
        self._bucket_rows: dict = {}

    def _bump(self, *tables: str) -> None:
        self.generation += 1
        for t in tables:
            self._table_gen[t] = self.generation

    def table_generation(self, table: str) -> int:
        """Generation of `table`'s last change.  Values come from the one
        connector-wide counter, so a table dropped and created again never
        repeats an earlier generation."""
        return self._table_gen.get(table, self.generation)

    # ---- metadata ----------------------------------------------------------
    def list_tables(self) -> list[str]:
        return sorted(self._tables)

    def table_schema(self, table: str) -> TableSchema:
        if table not in self._tables:
            raise KeyError(f"memory table not found: {table}")
        return self._tables[table]

    def create_table(
        self,
        name: str,
        columns: Sequence[ColumnSchema],
        bucketed_by: Optional[Sequence[str]] = None,
        bucket_count: int = 0,
    ) -> None:
        if name in self._tables:
            raise ValueError(f"table already exists: {name}")
        self._tables[name] = TableSchema(name, tuple(columns))
        self._data[name] = {
            c.name: np.empty((0,), dtype=object if c.type.is_string else c.type.np_dtype)
            for c in columns
        }
        if bucketed_by:
            # bucketing by the ENGINE's partition hash: scans of this table
            # are born hash-partitioned, so joins/aggs on the bucket keys
            # skip the repartition exchange (reference: trino-hive bucketed
            # tables via ConnectorNodePartitioningProvider)
            self._bucketing[name] = (tuple(bucketed_by), int(bucket_count) or 8)
        self._bump(name)

    def table_partitioning(self, table: str):
        return self._bucketing.get(table)

    def drop_table(self, name: str) -> None:
        self._tables.pop(name)
        self._data.pop(name)
        self._table_gen.pop(name, None)
        self._bucketing.pop(name, None)
        self._bucket_rows = {k: v for k, v in self._bucket_rows.items() if k[0] != name}
        self._bump()

    def truncate(self, name: str) -> None:
        """Drop all rows, keep the schema (DML rewrite-and-swap write path)."""
        schema = self.table_schema(name)
        self._data[name] = {
            c.name: np.empty((0,), dtype=object if c.type.is_string else c.type.np_dtype)
            for c in schema.columns
        }
        self._bump(name)

    # ---- transactions (reference: connector transaction handles) -----------
    def snapshot(self):
        """Copy-on-write state capture: writes replace whole column arrays
        (insert/truncate build new arrays), so shallow dict copies suffice."""
        return (
            dict(self._tables),
            {t: dict(cols) for t, cols in self._data.items()},
        )

    def restore(self, snap) -> None:
        self._tables, self._data = dict(snap[0]), {
            t: dict(cols) for t, cols in snap[1].items()
        }
        self._table_gen = {}
        self._bump(*self._tables)

    # ---- reads -------------------------------------------------------------
    def get_splits(self, table: str, desired_parts: int) -> list[Split]:
        bp = self._bucketing.get(table)
        if bp is not None:
            # one split per bucket, regardless of desired parallelism: the
            # scheduler's round-robin (split i -> task i mod W) keeps the
            # hash alignment whenever bucket_count % W == 0
            return [Split("memory", table, b, bp[1]) for b in range(bp[1])]
        return [Split("memory", table, p, desired_parts) for p in range(desired_parts)]

    def _bucket_index(self, table: str) -> list:
        """Row indices of each bucket of `table`, cached per write generation
        of the table."""
        key = (table, self.table_generation(table))
        rows = self._bucket_rows.get(key)
        if rows is None:
            from ..runtime.wire import bucket_assignments

            cols, nb = self._bucketing[table]
            data = self._data[table]
            b = bucket_assignments({c: data[c] for c in cols}, cols, nb)
            rows = [np.nonzero(b == i)[0] for i in range(nb)]
            # only this table's stale generations go
            self._bucket_rows = {k: v for k, v in self._bucket_rows.items() if k[0] != table}
            self._bucket_rows[key] = rows
        return rows

    def read_split(self, split: Split, columns: Sequence[str]) -> dict[str, np.ndarray]:
        data = self._data[split.table]
        if split.table in self._bucketing:
            ix = self._bucket_index(split.table)[split.part]
            return {c: data[c][ix] for c in columns}
        n = len(next(iter(data.values()))) if data else 0
        lo = split.part * n // split.num_parts
        hi = (split.part + 1) * n // split.num_parts
        return {c: data[c][lo:hi] for c in columns}

    # ---- writes (reference: ConnectorPageSink) ------------------------------
    def insert(self, table: str, columns: dict[str, np.ndarray]) -> int:
        schema = self.table_schema(table)
        data = self._data[table]
        n = len(next(iter(columns.values()))) if columns else 0
        for c in schema.columns:
            arr = columns[c.name]
            old = data[c.name]
            if isinstance(arr, np.ma.MaskedArray) or isinstance(old, np.ma.MaskedArray):
                data[c.name] = np.ma.concatenate([old, arr])
            else:
                data[c.name] = np.concatenate([old, arr])
        self._bump(table)
        return n

    def _apply_staged(self, handle) -> int:
        """Staged-swap commit: the post-image is assembled off to the side
        and swapped into `_data[table]` in ONE dict assignment, so a
        concurrent read_split never observes the empty window the default
        truncate-then-insert sequence would expose."""
        rows = 0
        for name, columns in handle.creates:
            self.create_table(name, columns)
        table = handle.table
        schema = self.table_schema(table)
        if handle.replace:
            new = {
                c.name: np.empty((0,), dtype=object if c.type.is_string
                                 else c.type.np_dtype)
                for c in schema.columns
            }
        else:
            new = dict(self._data[table])
        for batch in handle.inserts:
            rows += len(next(iter(batch.values()))) if batch else 0
            for c in schema.columns:
                arr = batch[c.name]
                old = new[c.name]
                if isinstance(arr, np.ma.MaskedArray) or isinstance(
                    old, np.ma.MaskedArray
                ):
                    new[c.name] = np.ma.concatenate([old, arr])
                else:
                    new[c.name] = np.concatenate([old, arr])
        self._data[table] = new  # the atomic point for readers
        self._bump(table)
        if handle.replace and not handle.inserts:
            rows = 0
        return rows

    def estimated_row_count(self, table: str) -> Optional[int]:
        data = self._data.get(table)
        if not data:
            return 0
        return len(next(iter(data.values())))

    def table_stats(self, table: str):
        """NDV/min-max column stats for the cost-based optimizer (reference:
        MemoryMetadata.getTableStatistics); computed lazily, cached per write
        generation."""
        data = self._data.get(table)
        if data is None:
            return None
        if not hasattr(self, "_stats_cache"):
            self._stats_cache = {}
        cached = self._stats_cache.get(table)
        gen = self.table_generation(table)
        if cached is None or cached[0] != gen:
            from .spi import compute_table_stats

            self._stats_cache[table] = (gen, compute_table_stats(data))
        return self._stats_cache[table][1]


class BlackholeConnector(Connector):
    """Accepts any write, returns empty scans — sink for write benchmarks."""

    name = "blackhole"

    def __init__(self) -> None:
        self._tables: dict[str, TableSchema] = {}
        self.rows_swallowed = 0
        self.generation = 0

    def list_tables(self) -> list[str]:
        return sorted(self._tables)

    def table_schema(self, table: str) -> TableSchema:
        return self._tables[table]

    def create_table(self, name: str, columns: Sequence[ColumnSchema]) -> None:
        self._tables[name] = TableSchema(name, tuple(columns))

    def drop_table(self, name: str) -> None:
        self._tables.pop(name)

    def get_splits(self, table: str, desired_parts: int) -> list[Split]:
        return [Split("blackhole", table, 0, 1)]

    def read_split(self, split: Split, columns: Sequence[str]) -> dict[str, np.ndarray]:
        schema = self.table_schema(split.table)
        return {
            c: np.empty((0,), dtype=object if schema.type_of(c).is_string else schema.type_of(c).np_dtype)
            for c in columns
        }

    def insert(self, table: str, columns: dict[str, np.ndarray]) -> int:
        n = len(next(iter(columns.values()))) if columns else 0
        self.rows_swallowed += n
        return n

    def estimated_row_count(self, table: str) -> Optional[int]:
        return 0
