"""Bounded, persistent query history.

Reference: the engine keeps every recent query's QueryInfo in a bounded
in-memory history behind ``GET /v1/query`` (server QueryResource over
DispatchManager; ``query.max-history`` / ``query.min-expire-age`` bound
it) — the Web UI's query list and "why was last night's run slow" both
read from it.  Our coordinator's live table drops a query entirely at
``_expire_old_queries`` (+15 min), which is exactly when somebody starts
asking questions about it.

``QueryHistoryStore`` is the answer: an insertion-ordered ring of
completed query records (dict snapshots of QueryInfo + the phase ledger)
capped at ``capacity``, optionally mirrored to a JSONL file so history
survives a coordinator restart — the constructor replays the tail of the
file back into the ring.  Records merge by query_id (a later, richer
record updates the earlier one in place), so the store can also serve as
an EventListener (``store(event)``): Engine users get a minimal history
for free, and the coordinator overlays its full QueryInfo snapshot.

Thread-safety: one lock around the ring; JSONL writes append a single
line under the same lock (O_APPEND semantics keep concurrent processes
from interleaving partial lines).
"""

from __future__ import annotations

import json
import threading
from collections import OrderedDict
from typing import Optional

__all__ = ["QueryHistoryStore"]


class QueryHistoryStore:
    def __init__(self, capacity: int = 200, path: Optional[str] = None):
        self.capacity = max(1, int(capacity))
        self.path = path
        self._lock = threading.Lock()
        self._ring: OrderedDict[str, dict] = OrderedDict()
        # byte offset of the last complete line consumed from `path` —
        # refresh() tails from here, so a SHARED history file (coordinator
        # fleet: every member appends, every member tails) replicates
        # records without re-reading the whole file each heartbeat
        self._offset = 0
        if path:
            self._load(path)

    # ------------------------------------------------------------------ io
    def _load(self, path: str) -> None:
        """Replay the JSONL tail into the ring (restart survival).  Records
        merge by query_id, so an interrupted run's duplicate lines coalesce
        instead of double-counting."""
        with self._lock:
            self._consume_from_offset()

    def _consume_from_offset(self) -> int:
        """Read complete lines beyond self._offset and merge them (no
        re-persist: they are already on disk).  Concurrent-writer safe the
        same way journal replay is: a trailing chunk without its newline is
        an in-progress foreign append — left for the next call.  Caller
        holds the lock.  Returns the number of records merged."""
        try:
            with open(self.path, "rb") as f:
                f.seek(self._offset)
                blob = f.read()
        except OSError:
            return 0
        complete, sep, _tail = blob.rpartition(b"\n")
        if not sep:
            return 0
        merged = 0
        for raw in complete.split(b"\n"):
            try:
                line = raw.decode("utf-8").strip()
            except UnicodeDecodeError:
                continue
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn write at crash: skip, don't die
            qid = rec.get("query_id")
            if qid:
                self._merge(qid, rec, persist=False)
                merged += 1
        self._offset += len(complete) + 1
        return merged

    def refresh(self) -> int:
        """Tail records other PROCESSES appended to the shared file since
        the last load/refresh — how fleet peers replicate each other's
        cache-admission hints (planhash recurrences, warm signatures).
        Returns the number of records merged."""
        if not self.path:
            return 0
        with self._lock:
            return self._consume_from_offset()

    def _append_line(self, rec: dict) -> None:
        if not self.path:
            return
        try:
            line = json.dumps(rec, default=str)
        except (TypeError, ValueError):
            return
        try:
            with open(self.path, "a") as f:
                f.write(line + "\n")
        except OSError:
            pass  # read-only disk: in-memory history still works

    # -------------------------------------------------------------- record
    def _merge(self, qid: str, rec: dict, persist: bool) -> None:
        existing = self._ring.pop(qid, None)
        if existing is not None:
            existing.update(rec)
            rec = existing
        self._ring[qid] = rec  # (re-)insert at the fresh end
        while len(self._ring) > self.capacity:
            self._ring.popitem(last=False)  # evict oldest
        if persist:
            self._append_line(rec)

    def record(self, rec: dict) -> None:
        """Insert/merge a completed-query record (must be JSON-able and
        carry ``query_id``)."""
        qid = rec.get("query_id")
        if not qid:
            return
        with self._lock:
            self._merge(qid, dict(rec), persist=True)

    def __call__(self, event) -> None:
        """EventListener duty (runtime/events.py): completed/failed events
        become minimal history records — richer coordinator snapshots merge
        over them by query_id."""
        if getattr(event, "kind", None) not in ("completed", "failed"):
            return
        self.record({
            "query_id": event.query_id,
            "state": "FINISHED" if event.kind == "completed" else "FAILED",
            "sql": event.sql,
            "wall_s": event.wall_s,
            "rows": event.rows,
            "error": event.error,
            "cpu_ms": event.cpu_ms,
            "peak_memory_bytes": event.peak_memory_bytes,
            "stage_count": event.stage_count,
            "finished_ts": event.ts,
        })

    # ----------------------------------------------------------- baselines
    def baseline(self, planhash: str, min_samples: int = 3) -> Optional[dict]:
        """Rolling per-planhash baseline for the anomaly sentinel
        (coordinator._score_anomalies): percentile stats over this plan's
        clean FINISHED runs in the ring.

        Sample selection is deliberately conservative: cache-served runs
        (no execution happened) and runs already flagged anomalous are
        excluded, so one slow outlier cannot drag the baseline up and mask
        the next regression.  Returns None below `min_samples` — a cold
        sentinel must stay silent rather than false-positive."""
        if not planhash:
            return None
        with self._lock:
            recs = [
                r
                for r in self._ring.values()
                if r.get("planhash") == planhash
                and str(r.get("state", "")).upper() == "FINISHED"
                and not r.get("cached")
                and not r.get("anomalies")
            ]
        if len(recs) < max(1, int(min_samples)):
            return None

        def _vals(key: str) -> list[float]:
            out = []
            for r in recs:
                v = r.get(key)
                if isinstance(v, (int, float)):
                    out.append(float(v))
            return sorted(out)

        def _pct(vals: list[float], q: float) -> float:
            if not vals:
                return 0.0
            i = min(len(vals) - 1, int(round(q * (len(vals) - 1))))
            return vals[i]

        walls = _vals("wall_ms")
        return {
            "planhash": planhash,
            "samples": len(recs),
            "wall_ms_p50": round(_pct(walls, 0.5), 3),
            "wall_ms_p95": round(_pct(walls, 0.95), 3),
            "spill_ms_p50": round(_pct(_vals("spill_ms"), 0.5), 3),
            "retries_p50": _pct(_vals("task_retries"), 0.5),
            "compiles_p50": _pct(_vals("compile_count"), 0.5),
            "peak_bytes_p50": _pct(_vals("peak_memory_bytes"), 0.5),
            "rows_p50": _pct(_vals("rows"), 0.5),
            # achieved device bandwidth (roofline plane): _vals skips runs
            # with no figure, so eager-only plans never zero the baseline
            "gb_per_sec_p50": round(_pct(_vals("device_gb_per_sec"), 0.5), 3),
        }

    # ---------------------------------------------------------------- read
    def get(self, qid: str) -> Optional[dict]:
        with self._lock:
            rec = self._ring.get(qid)
            return dict(rec) if rec is not None else None

    def list(self, state: Optional[str] = None, limit: int = 50) -> list[dict]:
        """Newest-first records, optionally filtered by terminal state."""
        with self._lock:
            recs = [dict(r) for r in reversed(self._ring.values())]
        if state:
            want = state.upper()
            recs = [r for r in recs if str(r.get("state", "")).upper() == want]
        return recs[: max(0, int(limit))]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)
