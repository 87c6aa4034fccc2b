"""DB-API connector framework — the base-jdbc analogue.

Reference: plugin/trino-base-jdbc (21.5k LoC) is the shared framework the
mysql/postgres/oracle/... connectors build on: schema discovery through the
driver, per-column type mapping, split generation, and pushdown of
projections into the remote SQL.  Python's DB-API 2.0 plays the role of
JDBC here: `DbApiConnector` implements the engine SPI over any DB-API
`connect()` factory, and `SqliteConnector` is the first concrete plugin
(the reference ships trino-sqlite via base-jdbc the same way).

Pushdown: column projection always (only referenced columns are SELECTed);
row-range splits via LIMIT/OFFSET over a stable ordering when the backend
supports rowid (sqlite) so scans parallelize across workers.

A copy of the JAX package's module.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, Sequence

import numpy as np

from ..data.types import (
    BIGINT, BOOLEAN, DOUBLE, Type, VARCHAR, parse_type,
)
from .spi import ColumnSchema, Connector, Split, TableSchema

__all__ = ["DbApiConnector", "SqliteConnector"]


class DbApiConnector(Connector):
    """Engine SPI over a DB-API 2.0 connection factory.

    Subclasses (or callers) provide:
      connect_fn  -> new DB-API connection
      type_map    -> backend declared-type text -> engine Type
    """

    name = "dbapi"

    def __init__(self, connect_fn: Callable, splits_per_table: int = 1):
        self._connect_fn = connect_fn
        self._local = threading.local()
        self.splits_per_table = splits_per_table
        self.generation = 0

    # every thread gets its own connection (DB-API conns are rarely
    # thread-safe; the reference pools JDBC connections per task)
    def _conn(self):
        if not hasattr(self._local, "conn"):
            self._local.conn = self._connect_fn()
        return self._local.conn

    # ------------------------------------------------------------- metadata
    def list_tables(self) -> list[str]:
        cur = self._conn().cursor()
        cur.execute(
            "select name from sqlite_master where type in ('table', 'view') "
            "order by name"
        )
        return [r[0] for r in cur.fetchall()]

    def _map_type(self, decl: Optional[str]) -> Type:
        t = (decl or "").strip().lower()
        if not t:
            return VARCHAR  # sqlite dynamic typing: safest surface
        if "int" in t:
            return BIGINT
        if any(x in t for x in ("char", "clob", "text")):
            return VARCHAR
        if any(x in t for x in ("real", "floa", "doub")):
            return DOUBLE
        if "bool" in t:
            return BOOLEAN
        if t.startswith(("decimal", "numeric")):
            try:
                return parse_type(t)
            except Exception:
                return DOUBLE
        if "date" in t:
            from ..data.types import DATE

            return DATE
        return VARCHAR

    def table_schema(self, table: str) -> TableSchema:
        cur = self._conn().cursor()
        cur.execute(f'pragma table_info("{table}")')
        rows = cur.fetchall()
        if not rows:
            raise KeyError(f"table not found: {table}")
        cols = tuple(ColumnSchema(r[1], self._map_type(r[2])) for r in rows)
        return TableSchema(table, cols)

    def estimated_row_count(self, table: str) -> Optional[int]:
        cur = self._conn().cursor()
        cur.execute(f'select count(*) from "{table}"')
        return int(cur.fetchone()[0])

    # ---------------------------------------------------------------- scans
    def get_splits(self, table: str, desired_parts: int) -> list[Split]:
        n = min(max(1, self.splits_per_table), max(1, desired_parts))
        return [Split(self.name, table, p, n) for p in range(n)]

    def read_split(self, split: Split, columns: Sequence[str]) -> dict[str, np.ndarray]:
        schema = self.table_schema(split.table)
        col_sql = ", ".join(f'"{c}"' for c in columns) or "1"
        sql = f'select {col_sql} from "{split.table}"'
        if split.num_parts > 1:
            # rowid-range pushdown: disjoint ranges per split (reference:
            # base-jdbc JdbcSplit with predicate ranges)
            total = self.estimated_row_count(split.table) or 0
            lo = split.part * total // split.num_parts
            hi = (split.part + 1) * total // split.num_parts
            sql += f" order by rowid limit {hi - lo} offset {lo}"
        cur = self._conn().cursor()
        cur.execute(sql)
        rows = cur.fetchall()
        out: dict[str, np.ndarray] = {}
        for i, c in enumerate(columns):
            t = schema.type_of(c)
            vals = [r[i] for r in rows]
            nulls = np.asarray([v is None for v in vals], dtype=bool)
            if t.is_string:
                arr = np.asarray(
                    ["" if v is None else str(v) for v in vals], dtype=object
                )
            elif t.name == "date":
                from ..data.types import date_to_days

                arr = np.asarray(
                    [0 if v is None else date_to_days(str(v)) for v in vals],
                    dtype=t.np_dtype,
                )
            elif t.is_decimal:
                # backend returns plain numerics; engine lanes are scaled ints
                arr = np.asarray(
                    [
                        0 if v is None else int(round(float(v) * (10.0**t.scale)))
                        for v in vals
                    ],
                    dtype=np.int64,
                )
            else:
                arr = np.asarray(
                    [0 if v is None else v for v in vals], dtype=t.np_dtype
                )
            out[c] = np.ma.MaskedArray(arr, mask=nulls) if nulls.any() else arr
        return out

    # --------------------------------------------------------------- writes
    def create_table(self, table: str, columns: Sequence[ColumnSchema]) -> None:
        ddl_types = {
            "bigint": "integer", "integer": "integer", "smallint": "integer",
            "tinyint": "integer", "double": "real", "real": "real",
            "boolean": "integer", "varchar": "text", "date": "text",
        }
        cols = ", ".join(
            f'"{c.name}" {ddl_types.get(c.type.name, c.type.name)}' for c in columns
        )
        conn = self._conn()
        conn.execute(f'create table "{table}" ({cols})')
        conn.commit()
        self.generation += 1

    def drop_table(self, table: str) -> None:
        conn = self._conn()
        conn.execute(f'drop table "{table}"')
        conn.commit()
        self.generation += 1

    def insert(self, table: str, columns: dict[str, np.ndarray]) -> int:
        schema = self.table_schema(table)
        names = [c.name for c in schema.columns]
        n = len(next(iter(columns.values()))) if columns else 0
        rows = []
        for i in range(n):
            row = []
            for c in names:
                arr = columns[c]
                if isinstance(arr, np.ma.MaskedArray) and np.ma.getmaskarray(arr)[i]:
                    row.append(None)
                else:
                    v = np.ma.getdata(arr)[i] if isinstance(arr, np.ma.MaskedArray) else arr[i]
                    row.append(v.item() if isinstance(v, np.generic) else v)
            rows.append(tuple(row))
        ph = ", ".join("?" for _ in names)
        conn = self._conn()
        conn.executemany(
            f'insert into "{table}" values ({ph})', rows
        )
        conn.commit()
        self.generation += 1
        return n


class SqliteConnector(DbApiConnector):
    """Concrete DB-API plugin: sqlite file or :memory: database
    (reference: any base-jdbc-derived plugin, e.g. trino-sqlite)."""

    name = "sqlite"

    def __init__(self, database: str = ":memory:", splits_per_table: int = 1):
        import sqlite3

        super().__init__(
            lambda: sqlite3.connect(database), splits_per_table=splits_per_table
        )
        self.database = database
