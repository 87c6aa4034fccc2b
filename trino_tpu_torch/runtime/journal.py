"""Durable query journal — the coordinator's crash-recovery log.

Append-only JSONL beside the history store (runtime/history.py), recording
enough of each query's life to resume it after a coordinator crash:

  admit         query id, SQL text, explicit session overrides
  dispatch      one fragment's task fan-out (fragment id, ntasks, attempt)
  commit        one task's output COMMITTED to the spooled exchange
                (fragment id, part, task id — the spool dir name)
  resume        a restarted coordinator took over the query (policy, attempt)
  finish        terminal state (FINISHED / FAILED / CANCELED)
  write_intent  a DML statement is about to stage data (txn id, catalog,
                table, operation, expected version) — runtime/txn.py
  write_commit  the txn's connector swap landed; replay treats the query's
                write as done (exactly-once marker, keyed by txn id)
  write_abort   the txn was rolled back; staging reclaimed

Reference shape: the FTE promise that committed stage output is RE-READ,
not recomputed (spi/exchange/ExchangeManager + trino-exchange-filesystem)
— the journal is what tells a fresh coordinator WHICH task dirs in the
spool belong to which fragment of which in-flight query, so only the
uncommitted remainder is re-planned and re-dispatched.

Durability contract: state transitions (admit / resume / finish) fsync;
high-rate progress records (dispatch / commit) only flush — losing the
tail of those costs recomputation, never correctness (the spool's
COMMITTED markers are re-verified at resume time anyway).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

from ..utils import metrics as _metrics

__all__ = ["QueryJournal", "JournalQuery"]

_JOURNAL_RECORDS = _metrics.GLOBAL.counter(
    "trino_tpu_journal_records_total",
    "Records appended to the durable query journal, by kind",
    ("kind",),
)

# record kinds that mark a state transition and therefore fsync; the rest
# (dispatch/commit progress) only flush.  All three write-txn kinds fsync:
# the intent must be durable before staging mutates anything, and the
# commit marker is the exactly-once guarantee — losing it would replay a
# committed write as an abort.
_FSYNC_KINDS = frozenset(
    {"admit", "resume", "finish", "write_intent", "write_commit", "write_abort"}
)


class JournalQuery:
    """One query's state folded out of the journal by replay()."""

    def __init__(self, query_id: str):
        self.query_id = query_id
        self.sql: str = ""
        self.session: dict = {}
        self.created_ts: float = 0.0
        self.state: str = "INFLIGHT"  # INFLIGHT | FINISHED | FAILED | CANCELED
        self.error: Optional[str] = None
        self.error_code: Optional[str] = None
        self.spooled: bool = False
        # fragment id -> task fan-out of the (latest) pre-crash dispatch
        self.dispatches: dict[int, int] = {}
        # fragment id -> {part -> task_id} of spool-committed outputs
        self.commits: dict[int, dict[int, str]] = {}
        # first attempt number a resuming coordinator may use without
        # colliding with pre-crash task ids (max seen attempt + 1)
        self.next_attempt: int = 1
        # write-transaction state (runtime/txn.py): txn id -> intent fields
        self.write_intents: dict[str, dict] = {}
        # txn id -> rows applied (the exactly-once commit marker)
        self.write_commits: dict[str, int] = {}
        self.write_aborts: set[str] = set()


class QueryJournal:
    """Thread-safe append-only JSONL writer + static replay."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._lock = threading.Lock()
        self._f = open(path, "a", encoding="utf-8")

    def append(self, kind: str, query_id: str, **fields) -> None:
        """Write one record; never raises (a journaling hiccup must not
        fail a running query — at worst the crash-recovery window shrinks)."""
        rec = {"kind": kind, "query_id": query_id, "ts": time.time()}
        rec.update(fields)
        line = json.dumps(rec, default=str) + "\n"
        try:
            with self._lock:
                self._f.write(line)
                self._f.flush()
                if kind in _FSYNC_KINDS:
                    os.fsync(self._f.fileno())
        except (ValueError, OSError):
            return  # closed (coordinator stopping) or disk trouble
        _JOURNAL_RECORDS.labels(kind).inc()

    def close(self) -> None:
        with self._lock:
            try:
                self._f.close()
            except OSError:
                pass

    @staticmethod
    def replay(path: str) -> dict[str, JournalQuery]:
        """Fold the journal into per-query states.

        Snapshot-read: the size is stat'd once and exactly that many bytes
        are read, so replaying a FOREIGN journal with a live writer (a
        fleet peer adopting a dead coordinator's file, or mis-detecting a
        live one) sees a consistent prefix — records appended after the
        stat are invisible instead of interleaving with the parse.  A
        trailing chunk without a terminating newline is an in-progress (or
        crash-torn) write and is dropped; everything before it is intact
        because records are single lines flushed in order.  Torn lines that
        DID get their newline (crash mid-fsync) still fail json parsing
        and are skipped like the history store's loader.
        """
        states: dict[str, JournalQuery] = {}
        try:
            with open(path, "rb") as f:
                size = os.fstat(f.fileno()).st_size
                blob = f.read(size)
        except OSError:
            return states
        # drop the torn/in-progress tail: only complete lines are replayed
        complete, sep, _tail = blob.rpartition(b"\n")
        if not sep:
            return states
        for raw in complete.split(b"\n"):
            try:
                line = raw.decode("utf-8")
            except UnicodeDecodeError:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # torn write at crash
            qid = rec.get("query_id")
            kind = rec.get("kind")
            if not qid or not kind:
                continue
            st = states.get(qid)
            if st is None:
                st = states[qid] = JournalQuery(qid)
            if kind == "admit":
                st.sql = rec.get("sql") or ""
                st.session = rec.get("session") or {}
                st.created_ts = float(rec.get("ts") or 0.0)
                st.spooled = bool(rec.get("spooled"))
            elif kind == "dispatch":
                try:
                    fid = int(rec["fragment"])
                    st.dispatches[fid] = int(rec["ntasks"])
                    attempt = int(rec.get("attempt") or 0)
                except (KeyError, TypeError, ValueError):
                    continue
                st.next_attempt = max(st.next_attempt, attempt + 1)
            elif kind == "commit":
                try:
                    fid = int(rec["fragment"])
                    part = int(rec["part"])
                    tid = str(rec["task_id"])
                except (KeyError, TypeError, ValueError):
                    continue
                st.commits.setdefault(fid, {})[part] = tid
            elif kind == "resume":
                st.next_attempt = max(
                    st.next_attempt, int(rec.get("attempt") or 0) + 1
                )
                st.state = "INFLIGHT"  # taken over; not terminal
            elif kind == "finish":
                st.state = rec.get("state") or "FINISHED"
                st.error = rec.get("error")
                st.error_code = rec.get("error_code")
            elif kind == "write_intent":
                tid = rec.get("txn_id")
                if tid:
                    st.write_intents[str(tid)] = {
                        "catalog": rec.get("catalog"),
                        "table": rec.get("table"),
                        "operation": rec.get("operation"),
                        "expected": rec.get("expected"),
                    }
            elif kind == "write_commit":
                tid = rec.get("txn_id")
                if tid:
                    try:
                        st.write_commits[str(tid)] = int(rec.get("rows") or 0)
                    except (TypeError, ValueError):
                        st.write_commits[str(tid)] = 0
            elif kind == "write_abort":
                tid = rec.get("txn_id")
                if tid:
                    st.write_aborts.add(str(tid))
        return states
