"""Write-transaction manager: staged commits with exactly-once replay.

Reference: Trino's connector write protocol (ConnectorMetadata.beginInsert →
finishInsert, io/trino/plugin/iceberg/IcebergMetadata.commitTransaction) —
every DML statement becomes a three-phase transaction:

    1. INTENT   journal a durable write intent (txn id, target, expected
                version, staging namespace) before any mutation
    2. STAGE    accumulate new data invisibly via the connector's
                begin_write handle (bytes leased against the disk pool)
    3. COMMIT   one atomic point: connector CAS-swap, then journal the
                commit marker, then (and only then) cache invalidation

Idempotence falls out of the marker: replay after a crash consults the
connector's committed-marker (`txn_committed`) — present means the write
landed and replays as a no-op; absent means the intent aborts and its
staging is reclaimed.  Concurrent writers are arbitrated by the CAS into a
typed WRITE_CONFLICT with bounded recompute-and-retry.

A copy of the JAX package's module.  The engine's `write_fault_injector`
(runtime/failure.py FaultInjector) fires COMMIT_CRASH / WRITE_STALL at the
phase boundaries, and an injected crash leaves staging and table as a real
kill would.  `txn_journal` is None on an engine; a coordinator's statement
surface sets its query journal (runtime/journal.py).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from ..connectors.spi import Connector, StagedWrite, WriteConflictError
from ..utils import flightrecorder as _fr
from ..utils.metrics import GLOBAL as _METRICS

__all__ = ["WriteConflict", "WriteTransaction", "run_write", "TXN_TOTAL"]

TXN_TOTAL = _METRICS.counter(
    "trino_tpu_write_txn_total",
    "Write transactions by outcome (committed|aborted|conflict|replayed_noop)",
    ("outcome",),
)
STAGING_BYTES = _METRICS.gauge(
    "trino_tpu_write_txn_staging_bytes",
    "Bytes currently staged by in-flight write transactions",
)
RECLAIMED_TOTAL = _METRICS.counter(
    "trino_tpu_write_staging_reclaimed_bytes_total",
    "Staged bytes reclaimed from aborted or orphaned write transactions",
)

_staging_lock = threading.Lock()


def _staging_delta(nbytes: int) -> None:
    with _staging_lock:
        STAGING_BYTES.set(max(0.0, STAGING_BYTES.value() + nbytes))


class WriteConflict(RuntimeError):
    """Typed arbitration outcome: the snapshot CAS lost to a concurrent
    writer and the bounded recompute-and-retry budget is exhausted."""

    ERROR_CODE = "WRITE_CONFLICT"

    def __init__(self, table: str, attempts: int, last: WriteConflictError):
        self.table = table
        self.attempts = attempts
        super().__init__(
            f"[WRITE_CONFLICT] {table}: lost the commit race {attempts} "
            f"time(s) ({last})"
        )


class WriteTransaction:
    """One DML statement's write transaction against a single table."""

    def __init__(self, engine, conn: Connector, catalog: str, table: str,
                 operation: str, txn_id: str) -> None:
        self.engine = engine
        self.conn = conn
        self.catalog = catalog
        self.table = table
        self.operation = operation
        self.txn_id = txn_id
        self.handle: Optional[StagedWrite] = None
        self.outcome = "open"
        self.commit_ms = 0.0
        self._journal = getattr(engine, "txn_journal", None)
        self._injector = getattr(engine, "write_fault_injector", None)
        self._accounted = 0

    # -- fault hooks ----------------------------------------------------
    def _fault(self, phase: str) -> None:
        if self._injector is not None:
            self._injector.write_fault(f"{phase}:{self.txn_id}")

    def _journal_kind(self, kind: str, **fields) -> None:
        if self._journal is not None:
            qid = self.txn_id.rsplit("-w", 1)[0]
            self._journal.append(kind, qid, txn_id=self.txn_id, **fields)

    # -- phases ---------------------------------------------------------
    def begin(self) -> StagedWrite:
        # connector handle first so the journaled intent always refers to a
        # registered staging namespace the janitor can find
        self.handle = self.conn.begin_write(self.table, self.txn_id,
                                            self.operation)
        self._journal_kind(
            "write_intent",
            catalog=self.catalog,
            table=self.table,
            operation=self.operation,
            expected=self.handle.expected_version,
        )
        _fr.record("txn_begin", txn_id=self.txn_id,
                   table=f"{self.catalog}.{self.table}",
                   operation=self.operation,
                   expected=self.handle.expected_version)
        self._fault("intent")
        return self.handle

    def stage_create(self, schema) -> None:
        self.handle.stage_create(schema)

    def stage_truncate(self) -> None:
        self.handle.stage_truncate()

    def stage_insert(self, data: dict) -> None:
        before = self.handle.staged_bytes
        self.handle.stage_insert(data)
        delta = self.handle.staged_bytes - before
        self._accounted += delta
        _staging_delta(delta)

    def commit(self) -> int:
        """The atomic point.  The connector swap IS the commit; the journal
        marker after it makes replay a no-op; cache invalidation fires last
        (satellite: exactly once, never on abort)."""
        self._fault("commit")
        t0 = time.perf_counter()
        rows = self.conn.commit_write(self.handle)
        self.commit_ms = (time.perf_counter() - t0) * 1e3
        self._journal_kind("write_commit", rows=rows)
        self._settle("committed")
        _fr.record("txn_commit", txn_id=self.txn_id,
                   table=f"{self.catalog}.{self.table}", rows=rows,
                   commit_ms=round(self.commit_ms, 3))
        # COMMIT_CRASH at "ack": connector committed + marker journaled, but
        # the statement never acks — replay must detect the marker and no-op
        self._fault("ack")
        self.engine.cache_invalidate(f"{self.catalog}.{self.table}")
        return rows

    def abort(self, reason: str = "", outcome: str = "aborted") -> None:
        if self.handle is not None and not self.handle.done:
            try:
                freed = self.conn.abort_write(self.handle)
            except Exception:
                freed = 0
            if freed:
                RECLAIMED_TOTAL.inc(freed)
        self._journal_kind("write_abort", reason=reason, outcome=outcome)
        self._settle(outcome)
        _fr.record("txn_abort", txn_id=self.txn_id,
                   table=f"{self.catalog}.{self.table}", reason=reason,
                   outcome=outcome)

    def _settle(self, outcome: str) -> None:
        self.outcome = outcome
        TXN_TOTAL.labels(outcome).inc()
        if self._accounted:
            _staging_delta(-self._accounted)
            self._accounted = 0

    def info(self) -> dict:
        """EXPLAIN ANALYZE `-- txn:` footer payload."""
        return {
            "txn_id": self.txn_id,
            "table": f"{self.catalog}.{self.table}",
            "operation": self.operation,
            "expected": self.handle.expected_version if self.handle else None,
            "staged_bytes": self.handle.staged_bytes if self.handle else 0,
            "outcome": self.outcome,
            "commit_ms": round(self.commit_ms, 3),
        }


def run_write(engine, catalog: str, table: str, operation: str,
              attempt: Callable[[WriteTransaction], int]) -> int:
    """Run one DML statement transactionally with conflict retry.

    `attempt` receives a fresh WriteTransaction (already begun — intent
    journaled, staging open), stages everything, and returns the statement's
    row count; run_write commits.  On WRITE_CONFLICT the whole attempt is
    recomputed against the new snapshot, bounded by the
    `write_conflict_retries` session property.
    """
    from .failure import InjectedCommitCrash

    retries = 2
    session = getattr(engine, "session", None)
    if session is not None:
        try:
            retries = int(session.get("write_conflict_retries"))
        except Exception:
            pass
    conn, table = engine._target_conn(f"{catalog}.{table}")
    query_id = getattr(getattr(engine, "_txn_local", None), "query_id", None) \
        or f"local-{id(engine) & 0xFFFF:x}-{int(time.time() * 1e3)}"
    seq = getattr(getattr(engine, "_txn_local", None), "write_seq", 0)
    last_conflict: Optional[WriteConflictError] = None
    attempts = 0
    for i in range(retries + 1):
        attempts = i + 1
        txn = WriteTransaction(engine, conn, catalog, table, operation,
                               f"{query_id}-w{seq + i}")
        if getattr(engine, "_txn_local", None) is not None:
            engine._txn_local.write_seq = seq + i + 1
        engine._last_txn_info = None
        txn.begin()
        try:
            rows = attempt(txn)
            committed = txn.commit()
            info = txn.info()
            info["retries"] = i
            info["rows"] = rows if operation in ("delete", "update", "merge") \
                else committed
            engine._last_txn_info = info
            return info["rows"]
        except WriteConflictError as e:
            last_conflict = e
            txn.abort(reason=str(e), outcome="conflict")
            _fr.record("txn_conflict", txn_id=txn.txn_id, table=table,
                       attempt=attempts)
            continue
        except InjectedCommitCrash:
            # simulated hard crash: no abort, no cleanup — the journaled
            # intent (and possibly the connector commit marker) is all a
            # restarted coordinator gets, exactly like a real kill
            engine._last_txn_info = txn.info()
            raise
        except BaseException:
            txn.abort(reason="statement failed")
            engine._last_txn_info = txn.info()
            raise
    raise WriteConflict(f"{catalog}.{table}", attempts, last_conflict)
