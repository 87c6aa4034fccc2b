"""Iceberg-style lakehouse connector: snapshot-versioned parquet tables.

Reference: plugin/trino-iceberg (39.5k LoC) over lib/trino-parquet and
lib/trino-filesystem.  This build keeps Iceberg's core table format ideas —
an immutable chain of snapshot metadata files naming immutable data files,
committed by atomically advancing a version hint — with a compact JSON
metadata layout:

    <warehouse>/<table>/metadata/v<N>.metadata.json   (full table metadata)
    <warehouse>/<table>/metadata/version-hint.text    (current version N)
    <warehouse>/<table>/data/<uuid>.parquet           (immutable data files)

Each metadata version embeds the full snapshot list; every snapshot carries
its manifest inline (data file paths + per-column min/max/row-count stats,
the pruning stats Iceberg keeps in manifest files).  Readers resolve the
version hint ONCE per query (generation tracking), so scans see a
consistent snapshot while writers commit new versions — Iceberg's snapshot
isolation.

Time travel: query `"t@<snapshot_id>"` (quoted, Trino's `t FOR VERSION AS
OF` analogue), list history via the `"t$snapshots"` metadata table
(plugin/trino-iceberg SnapshotsTable), and `rollback_to_snapshot()`.

Scan pruning: file-level min/max stats filter data files before any IO —
the same role as Iceberg's manifest-entry bounds — wired into the dynamic-
filter ScanFilter machinery host-side.

A copy of the JAX package's module.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from typing import Optional, Sequence

import numpy as np

from ..data.types import Type, parse_type
from .spi import (
    ColumnSchema, ColumnStats, Connector, Split, StagedWrite, TableSchema,
    TableStats, staged_nbytes,
)

__all__ = ["IcebergConnector"]


def _pa():
    import pyarrow
    import pyarrow.parquet  # noqa: F401

    return pyarrow


class _IcebergStagedWrite(StagedWrite):
    """Stages immutable data files as data/stg-<txn>-<uuid>.parquet: on disk
    immediately (so a crashed writer's staging is durable for the janitor to
    find and reclaim) but invisible to every reader until a committed
    snapshot's manifest names them — Iceberg's core trick."""

    def __init__(self, conn, table, txn_id, operation, expected_version):
        super().__init__(conn, table, txn_id, operation, expected_version)
        self.staged_files: list[dict] = []  # manifest entries (stg- paths)

    def stage_insert(self, data: dict) -> None:
        nbytes = staged_nbytes(data)
        pool = getattr(self.conn, "disk_pool", None)
        if pool is not None and nbytes:
            self.leases.append(pool.reserve(
                owner=f"txn:{self.txn_id}", nbytes=nbytes,
                timeout_s=getattr(self.conn, "write_stage_timeout_s", 10.0),
                what="write-stage"))
        self.staged_files.append(self.conn._write_staged_file(self, data))
        self.staged_bytes += nbytes


class IcebergConnector(Connector):
    name = "iceberg"

    def __init__(self, warehouse: str):
        self.warehouse = os.path.abspath(warehouse)
        os.makedirs(self.warehouse, exist_ok=True)
        self.generation = 0  # bumped on commit; executor scan-cache key
        self._split_plan: dict = {}

    # ------------------------------------------------------------- metadata IO
    def _meta_dir(self, table: str) -> str:
        return os.path.join(self.warehouse, table, "metadata")

    def _data_dir(self, table: str) -> str:
        return os.path.join(self.warehouse, table, "data")

    def _current_version(self, table: str) -> int:
        hint = os.path.join(self._meta_dir(table), "version-hint.text")
        try:
            with open(hint) as fh:
                return int(fh.read().strip())
        except FileNotFoundError:
            raise KeyError(f"iceberg table not found: {table}")

    def _load_meta(self, table: str, version: Optional[int] = None) -> dict:
        v = version if version is not None else self._current_version(table)
        path = os.path.join(self._meta_dir(table), f"v{v}.metadata.json")
        with open(path) as fh:
            return json.load(fh)

    def _commit(self, table: str, meta: dict) -> None:
        """Write v<N+1>.metadata.json then advance the hint — the atomic
        commit point (Iceberg's swap of the metadata pointer)."""
        v = meta["version"]
        md = self._meta_dir(table)
        os.makedirs(md, exist_ok=True)
        path = os.path.join(md, f"v{v}.metadata.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(meta, fh, indent=1)
        os.replace(tmp, path)
        hint = os.path.join(md, "version-hint.text")
        tmp = hint + ".tmp"
        with open(tmp, "w") as fh:
            fh.write(str(v))
        os.replace(tmp, hint)
        self.generation += 1
        self._split_plan = {k: v2 for k, v2 in self._split_plan.items() if k[0] != table}

    @staticmethod
    def _parse_ref(table: str) -> tuple[str, Optional[int], Optional[str]]:
        """'t' | 't@<snapshot_id>' (time travel) | 't$snapshots' (metadata
        table) -> (base table, snapshot_id, meta_table)."""
        if "$" in table:
            base, meta = table.split("$", 1)
            return base, None, meta
        if "@" in table:
            base, snap = table.split("@", 1)
            return base, int(snap), None
        return table, None, None

    def _snapshot(self, table: str, snapshot_id: Optional[int]) -> dict:
        meta = self._load_meta(table)
        snaps = meta["snapshots"]
        if snapshot_id is None:
            wanted = meta["current_snapshot_id"]
        else:
            wanted = snapshot_id
        for s in snaps:
            if s["snapshot_id"] == wanted:
                return s
        raise KeyError(f"snapshot {wanted} not found for table {table}")

    # ------------------------------------------------------------ SPI: metadata
    def list_tables(self) -> list[str]:
        out = []
        for name in sorted(os.listdir(self.warehouse)):
            if os.path.isfile(
                os.path.join(self.warehouse, name, "metadata", "version-hint.text")
            ):
                out.append(name)
        return out

    def table_schema(self, table: str) -> TableSchema:
        base, _snap, meta_table = self._parse_ref(table)
        if meta_table == "snapshots":
            from ..data.types import BIGINT

            return TableSchema(
                table,
                (
                    ColumnSchema("snapshot_id", BIGINT),
                    ColumnSchema("committed_at_ms", BIGINT),
                    ColumnSchema("file_count", BIGINT),
                    ColumnSchema("row_count", BIGINT),
                ),
            )
        meta = self._load_meta(base)
        cols = tuple(
            ColumnSchema(n, parse_type(t)) for n, t in meta["schema"]
        )
        return TableSchema(table, cols)

    def estimated_row_count(self, table: str) -> Optional[int]:
        base, snap, meta_table = self._parse_ref(table)
        if meta_table == "snapshots":
            return len(self._load_meta(base)["snapshots"])
        s = self._snapshot(base, snap)
        return sum(f["rows"] for f in s["manifest"])

    def table_stats(self, table: str) -> Optional[TableStats]:
        base, snap, meta_table = self._parse_ref(table)
        if meta_table is not None:
            return None
        s = self._snapshot(base, snap)
        rows = sum(f["rows"] for f in s["manifest"])
        cols: dict[str, ColumnStats] = {}
        mins: dict[str, float] = {}
        maxs: dict[str, float] = {}
        for f in s["manifest"]:
            for c, (mn, mx) in f.get("stats", {}).items():
                if mn is None or mx is None:
                    continue
                mins[c] = mn if c not in mins else min(mins[c], mn)
                maxs[c] = mx if c not in maxs else max(maxs[c], mx)
        for c in mins:
            cols[c] = ColumnStats(None, mins[c], maxs[c], 0.0)
        return TableStats(float(rows), cols)

    def snapshots(self, table: str) -> list[dict]:
        return self._load_meta(table)["snapshots"]

    # engine transaction/DML-guard hooks: a "snapshot" is just the current
    # snapshot id per table (data files are immutable; restore == rollback)
    def snapshot(self):
        return {t: self._load_meta(t)["current_snapshot_id"] for t in self.list_tables()}

    def restore(self, snap: dict) -> None:
        for t in self.list_tables():
            if t in snap:
                if self._load_meta(t)["current_snapshot_id"] != snap[t]:
                    self.rollback_to_snapshot(t, snap[t])
            else:  # table created after the snapshot
                self.drop_table(t)
        # resurrect tables dropped after the snapshot (latest trash entry)
        trash = os.path.join(self.warehouse, ".dropped")
        live = set(self.list_tables())
        for t in snap:
            if t in live or not os.path.isdir(trash):
                continue
            cands = sorted(
                (
                    os.path.join(trash, d)
                    for d in os.listdir(trash)
                    if d.rsplit("-", 1)[0] == t
                ),
                key=os.path.getmtime,
            )
            if cands:
                os.replace(cands[-1], os.path.join(self.warehouse, t))
                self.generation += 1
                if self._load_meta(t)["current_snapshot_id"] != snap[t]:
                    self.rollback_to_snapshot(t, snap[t])

    def rollback_to_snapshot(self, table: str, snapshot_id: int) -> None:
        """Make an older snapshot current again by committing a new metadata
        version pointing at it (Iceberg rollback: history is never erased)."""
        meta = self._load_meta(table)
        if not any(s["snapshot_id"] == snapshot_id for s in meta["snapshots"]):
            raise KeyError(f"snapshot {snapshot_id} not found")
        meta["version"] += 1
        meta["current_snapshot_id"] = snapshot_id
        self._commit(table, meta)

    # --------------------------------------------------------------- SPI: scan
    def get_splits(self, table: str, desired_parts: int) -> list[Split]:
        base, snap, meta_table = self._parse_ref(table)
        key = (table, desired_parts)
        if key not in self._split_plan:
            if meta_table == "snapshots":
                parts = [[None]] + [[] for _ in range(max(0, desired_parts - 1))]
            else:
                s = self._snapshot(base, snap)
                files = [f["path"] for f in s["manifest"]]
                parts = [[] for _ in range(max(1, desired_parts))]
                for i, f in enumerate(files):
                    parts[i % len(parts)].append(f)
            self._split_plan[key] = parts
        return [
            Split(self.name, table, i, max(1, desired_parts))
            for i in range(len(self._split_plan[key]))
        ]

    def read_split(self, split: Split, columns: Sequence[str]) -> dict[str, np.ndarray]:
        base, _snap, meta_table = self._parse_ref(split.table)
        schema = self.table_schema(split.table)
        plan = self._split_plan[(split.table, split.num_parts)][split.part]
        if meta_table == "snapshots":
            if not plan:  # non-first split of the tiny metadata table
                return {c: np.empty((0,), dtype=np.int64) for c in columns}
            snaps = self._load_meta(base)["snapshots"]
            rows = {
                "snapshot_id": [s["snapshot_id"] for s in snaps],
                "committed_at_ms": [s["timestamp_ms"] for s in snaps],
                "file_count": [len(s["manifest"]) for s in snaps],
                "row_count": [sum(f["rows"] for f in s["manifest"]) for s in snaps],
            }
            return {c: np.asarray(rows[c], dtype=np.int64) for c in columns}
        pa = _pa()
        from .parquet import _column_to_numpy

        tables = []
        for rel in plan:
            path = os.path.join(self.warehouse, base, rel)
            tables.append(pa.parquet.read_table(path, columns=list(columns)))
        out: dict[str, np.ndarray] = {}
        if not tables:
            for c in columns:
                t = schema.type_of(c)
                out[c] = np.empty((0,), dtype=object if t.is_string else t.np_dtype)
            return out
        tbl = pa.concat_tables(tables) if len(tables) > 1 else tables[0]
        for c in columns:
            out[c] = _column_to_numpy(tbl.column(c), schema.type_of(c))
        return out

    # -------------------------------------------------------------- SPI: write
    def create_table(self, table: str, columns: Sequence[ColumnSchema]) -> None:
        if table in self.list_tables():
            raise ValueError(f"table already exists: {table}")
        os.makedirs(self._data_dir(table), exist_ok=True)
        sid = 1
        meta = {
            "format": "trino-tpu-iceberg/1",
            "table": table,
            "version": 1,
            "schema": [[c.name, c.type.name] for c in columns],
            "current_snapshot_id": sid,
            "snapshots": [
                {
                    "snapshot_id": sid,
                    "timestamp_ms": int(time.time() * 1000),
                    "operation": "create",
                    "manifest": [],
                }
            ],
        }
        self._commit(table, meta)

    def drop_table(self, table: str) -> None:
        if table not in self.list_tables():
            raise KeyError(table)
        # move to trash instead of deleting: data/metadata files are the
        # durable history (Iceberg never erases it), and a transaction
        # rollback must be able to resurrect a dropped table
        trash = os.path.join(self.warehouse, ".dropped")
        os.makedirs(trash, exist_ok=True)
        os.replace(
            os.path.join(self.warehouse, table),
            os.path.join(trash, f"{table}-{uuid.uuid4().hex}"),
        )
        self.generation += 1
        self._split_plan = {k: v for k, v in self._split_plan.items() if k[0] != table}

    def insert(self, table: str, columns: dict[str, np.ndarray]) -> int:
        """Append commit: write one immutable data file, add a snapshot whose
        manifest = previous manifest + the new file (Iceberg 'append')."""
        return self._commit_files(table, [columns], operation="append", base="current")

    def truncate(self, table: str) -> None:
        """Commit an empty snapshot (engine DML rewrite path; Iceberg
        'delete' replacing all files)."""
        self._commit_files(table, [], operation="delete", base="empty")

    def _commit_files(self, table: str, batches, operation: str, base: str) -> int:
        pa = _pa()
        import pyarrow.parquet as pq

        from .parquet import _numpy_to_arrow

        meta = self._load_meta(table)
        schema = self.table_schema(table)
        cur = self._snapshot(table, None)
        manifest = [] if base == "empty" else list(cur["manifest"])
        written = 0
        for cols in batches:
            arrays = {
                cs.name: _numpy_to_arrow(cols[cs.name], cs.type)
                for cs in schema.columns
            }
            t = pa.table(arrays)
            rel = os.path.join("data", f"{uuid.uuid4().hex}.parquet")
            pq.write_table(t, os.path.join(self.warehouse, table, rel))
            stats = self._file_stats(schema, cols)
            manifest.append({"path": rel, "rows": t.num_rows, "stats": stats})
            written += t.num_rows
        sid = max(s["snapshot_id"] for s in meta["snapshots"]) + 1
        meta["version"] += 1
        meta["current_snapshot_id"] = sid
        meta["snapshots"].append(
            {
                "snapshot_id": sid,
                "timestamp_ms": int(time.time() * 1000),
                "operation": operation,
                "manifest": manifest,
            }
        )
        self._commit(table, meta)
        return written

    @staticmethod
    def _file_stats(schema: TableSchema, cols: dict) -> dict:
        """Per-column min/max manifest stats (the Iceberg pruning bounds)."""
        stats = {}
        for cs in schema.columns:
            arr = cols[cs.name]
            base_arr = (
                np.ma.getdata(arr)[~np.ma.getmaskarray(arr)]
                if isinstance(arr, np.ma.MaskedArray)
                else np.asarray(arr)
            )
            if (
                len(base_arr)
                and base_arr.dtype != object
                and np.issubdtype(base_arr.dtype, np.number)
            ):
                stats[cs.name] = [float(base_arr.min()), float(base_arr.max())]
        return stats

    # ----------------------------------------------- transactional write SPI
    # The staged-file suffix is a fixed-width uuid4 hex + ".parquet", so the
    # owning txn id parses back out of any stg- filename unambiguously even
    # though txn ids themselves contain dashes.
    _STG_TAIL = 32 + 1 + len(".parquet")

    def _staged_schema(self, handle) -> TableSchema:
        if handle.creates:
            _, columns = handle.creates[-1]
            return TableSchema(handle.table, tuple(columns))
        return self.table_schema(handle.table)

    def _write_staged_file(self, handle, cols: dict) -> dict:
        pa = _pa()
        import pyarrow.parquet as pq

        from .parquet import _numpy_to_arrow

        schema = self._staged_schema(handle)
        os.makedirs(self._data_dir(handle.table), exist_ok=True)
        arrays = {
            cs.name: _numpy_to_arrow(cols[cs.name], cs.type)
            for cs in schema.columns
        }
        t = pa.table(arrays)
        rel = os.path.join(
            "data", f"stg-{handle.txn_id}-{uuid.uuid4().hex}.parquet"
        )
        pq.write_table(t, os.path.join(self.warehouse, handle.table, rel))
        return {
            "path": rel,
            "rows": t.num_rows,
            "stats": self._file_stats(schema, cols),
        }

    def write_version(self, table: str):
        """CAS token = the table's current snapshot id (None for a table
        that doesn't exist yet, i.e. CTAS) — per-table, so writers to
        different tables never conflict."""
        try:
            return self._load_meta(table)["current_snapshot_id"]
        except (KeyError, OSError, ValueError):
            return None

    def begin_write(self, table: str, txn_id: str, operation: str):
        state = self._write_state()
        handle = _IcebergStagedWrite(
            self, table, txn_id, operation, self.write_version(table)
        )
        with state["lock"]:
            state["staged"][txn_id] = handle
        return handle

    def _apply_staged(self, handle) -> int:
        """Commit = promote staged files into a new snapshot's manifest and
        advance the metadata pointer — one `_commit` (tmp+rename of the
        version hint) is the atomic point, exactly like any other Iceberg
        commit.  The snapshot is stamped with the txn id: that stamp IS the
        durable commit marker `txn_committed` probes during replay."""
        for name, columns in handle.creates:
            self.create_table(name, columns)
        meta = self._load_meta(handle.table)
        cur = self._snapshot(handle.table, None)
        manifest = (
            [] if (handle.replace or handle.creates) else list(cur["manifest"])
        )
        rows = 0
        for entry in handle.staged_files:
            # promote: rename out of the stg- namespace so the janitor's
            # orphan sweep can never match a committed data file
            final_rel = os.path.join("data", f"{uuid.uuid4().hex}.parquet")
            os.replace(
                os.path.join(self.warehouse, handle.table, entry["path"]),
                os.path.join(self.warehouse, handle.table, final_rel),
            )
            manifest.append(
                {"path": final_rel, "rows": entry["rows"],
                 "stats": entry["stats"]}
            )
            rows += entry["rows"]
        sid = max(s["snapshot_id"] for s in meta["snapshots"]) + 1
        meta["version"] += 1
        meta["current_snapshot_id"] = sid
        meta["snapshots"].append(
            {
                "snapshot_id": sid,
                "timestamp_ms": int(time.time() * 1000),
                "operation": handle.operation,
                "manifest": manifest,
                "txn_id": handle.txn_id,
                "txn_rows": rows,
            }
        )
        self._commit(handle.table, meta)
        handle.staged_files = []
        return rows

    def _discard_staged(self, handle) -> None:
        for entry in getattr(handle, "staged_files", []):
            try:
                os.remove(
                    os.path.join(self.warehouse, handle.table, entry["path"])
                )
            except OSError:
                pass
        handle.staged_files = []
        super()._discard_staged(handle)

    def txn_committed(self, table: str, txn_id: str):
        rows = super().txn_committed(table, txn_id)
        if rows is not None:
            return rows
        # durable probe: the committing snapshot carries its txn id, so the
        # marker survives process death (unlike the in-memory registry)
        try:
            meta = self._load_meta(table)
        except (KeyError, OSError, ValueError):
            return None
        for s in meta["snapshots"]:
            if s.get("txn_id") == txn_id:
                return int(s.get("txn_rows") or 0)
        return None

    def _staged_data_dirs(self):
        """Data dirs of every table dir in the warehouse — including half-
        born CTAS targets that have staged files but no metadata yet."""
        try:
            names = os.listdir(self.warehouse)
        except OSError:
            return
        for name in names:
            if name == ".dropped":
                continue
            dd = os.path.join(self.warehouse, name, "data")
            if os.path.isdir(dd):
                yield dd

    def orphaned_staging(self) -> dict:
        out = super().orphaned_staging()
        now = time.time()
        for dd in self._staged_data_dirs():
            try:
                names = os.listdir(dd)
            except OSError:
                continue
            for n in names:
                if not n.startswith("stg-") or len(n) <= 4 + self._STG_TAIL:
                    continue
                txn = n[4:-self._STG_TAIL]
                if txn in out:
                    continue
                try:
                    out[txn] = now - os.path.getmtime(os.path.join(dd, n))
                except OSError:
                    continue
        return out

    def reclaim_staging(self, txn_id: str) -> int:
        freed = super().reclaim_staging(txn_id)
        for dd in self._staged_data_dirs():
            try:
                names = os.listdir(dd)
            except OSError:
                continue
            for n in names:
                if not n.startswith(f"stg-{txn_id}-"):
                    continue
                p = os.path.join(dd, n)
                try:
                    freed += os.path.getsize(p)
                    os.remove(p)
                except OSError:
                    pass
        return freed
