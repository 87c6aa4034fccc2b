"""Spooled durable exchange + output-buffer spill (the FTE foundation).

Reference mechanisms this replaces:

- `spi/exchange/ExchangeManager.java:39` and
  `plugin/trino-exchange-filesystem/FileSystemExchangeManager.java` — under
  fault-tolerant (TASK-retry) execution every stage's output is written to
  durable storage, so a failed/killed producer's committed output is
  RE-READ by consumers instead of recursively recomputed, and repeated
  attempts of a deterministic task commit byte-identical output (the
  exactly-once attempt selection collapses to "first COMMIT wins").
- `execution/buffer/OutputBufferMemoryManager` — un-acknowledged output
  chunks parked on a worker are bounded: past the byte budget they live on
  disk (the chunks are already zstd-framed by the C++ serde,
  native/pageserde.cpp, so spooling is a plain byte write) and are served
  back by file read on fetch.

Commit protocol: chunks are staged under
    {dir}/{task_id}.tmp-{attempt}/buf{buffer}/{token:06d}.bin
with an empty `COMMITTED` marker written last inside the staging dir, then
the whole dir is `os.rename`d to {dir}/{task_id}.  Readers treat a task
dir without the marker as absent — a crashed producer can never expose a
partial buffer (the reference's sink commit handshake,
FileSystemExchangeSink.finish) — and the rename makes commit FIRST-
ATTEMPT-WINS: a second attempt of the same task id (task retry, straggler
speculation) finds the target already present, removes its staging dir,
and no-ops — it can never rewrite chunk files a consumer is mid-read on.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
from typing import Iterable, Optional

from ..utils import flightrecorder as _fr
from ..utils import metrics as _metrics
from .disk import guarded_write

__all__ = ["SpooledExchange", "SPOOL_URL"]

# registered at import so the family (with HELP) is present in every
# /metrics scrape even before the first sweep removes anything
_SPOOL_GC = _metrics.GLOBAL.counter(
    "trino_tpu_spool_gc_total",
    "Spool directories removed by the GC sweep (committed task dirs vs "
    "*.tmp-* staging dirs left by crashed coordinators)",
    ("kind",),
)
_SPOOL_RECLAIM = _metrics.GLOBAL.counter(
    "trino_tpu_spool_reclaim_total",
    "Spool directories evicted by PRESSURE reclaim, in escalation order "
    "(memo = fragment-memo namespaces, nonlive = dirs of non-live queries)",
    ("kind",),
)

# sentinel "worker url" marking a source served from the spool, not HTTP
SPOOL_URL = "spool"

_MARKER = "COMMITTED"

# adoption pins, keyed by spool directory: a dir name listed here is
# mid-rename between `adopt` start and commit (fragment memoization) and
# must not be evicted by GC or pressure reclaim.  Module-level because
# every actor constructs its own SpooledExchange over the shared directory
# — instance state would not be seen by a concurrent GC sweep.
_PIN_LOCK = threading.Lock()
_PINS: dict[str, set[str]] = {}


def _pin(directory: str, *names: str) -> None:
    with _PIN_LOCK:
        _PINS.setdefault(directory, set()).update(names)


def _unpin(directory: str, *names: str) -> None:
    with _PIN_LOCK:
        pins = _PINS.get(directory)
        if pins is not None:
            pins.difference_update(names)
            if not pins:
                _PINS.pop(directory, None)


def _pinned(directory: str) -> set[str]:
    with _PIN_LOCK:
        return set(_PINS.get(directory) or ())


def _dir_bytes(path: str) -> int:
    total = 0
    for root, _dirs, files in os.walk(path, onerror=lambda e: None):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(root, f))
            except OSError:
                pass
    return total


def _verify_spool_frame(task_id: str, buffer_id: int, name: str, blob: bytes) -> None:
    """Spooled chunks carry the wire integrity frame (runtime/wire.py) —
    verify the crc32 at read time so silent disk corruption surfaces as a
    typed PAGE_TRANSPORT_ERROR instead of wrong rows.  The framed bytes are
    returned as-is: downstream wire_to_page unframes.  Unframed blobs
    (legacy spool dirs, unit tests writing raw serde bytes) pass through."""
    from .wire import FRAME_MAGIC, PageTransportError, unframe_chunk

    if blob[:4] == FRAME_MAGIC:
        try:
            unframe_chunk(blob)
        except PageTransportError as e:
            e.args = (
                f"spool chunk {task_id}/buf{buffer_id}/{name}: {e.args[0]}",
            )
            raise


class SpooledExchange:
    def __init__(self, directory: str, disk_pool=None):
        self.dir = directory
        # optional runtime/disk.py NodeDiskPool: commit_task leases its
        # staged bytes against the node budget (block -> reclaim -> shed
        # with typed EXCEEDED_SPILL_LIMIT) before any file is written
        self.disk_pool = disk_pool
        self.disk_blocked_timeout_s: Optional[float] = 10.0
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- producer
    def commit_task(
        self,
        task_id: str,
        buffers: dict[int, list[bytes]],
        attempt: str = "0",
    ) -> bool:
        """Stage every buffer's chunks in a per-attempt tmp dir, then rename
        into place — crash-atomic AND first-attempt-wins.  Returns True if
        THIS attempt's output became the committed one, False if another
        attempt already won (the staged bytes are discarded; the winner's
        chunks, which consumers may be mid-read on, are never touched).

        This rename is also the exactly-once arbiter for split-driven scans
        (runtime/splits.py): a stolen morsel re-posts under the SAME task
        id as the straggler it duplicates, so however many attempts race,
        exactly one morsel output publishes and the losers vanish here."""
        tdir = os.path.join(self.dir, task_id)
        if self.is_committed(task_id):
            return False
        tmp = os.path.join(self.dir, f"{task_id}.tmp-{attempt}")
        shutil.rmtree(tmp, ignore_errors=True)  # stale crashed stage
        # disk governance: lease the staged bytes BEFORE writing.  A full
        # pool refreshes deleted-path leases, runs pressure reclaim (this
        # spool's memo-first eviction), blocks, and only then sheds with
        # the typed EXCEEDED_SPILL_LIMIT — never a raw ENOSPC.
        lease = None
        if self.disk_pool is not None:
            nbytes = sum(
                len(blob) for chunks in buffers.values() for blob in chunks
            )
            lease = self.disk_pool.reserve(
                task_id,
                nbytes,
                timeout_s=self.disk_blocked_timeout_s,
                what=f"spool commit {task_id}",
                path=tdir,
                reclaim=lambda need: self.reclaim(need),
            )
        try:
            for buffer_id, chunks in buffers.items():
                bdir = os.path.join(tmp, f"buf{buffer_id}")
                os.makedirs(bdir, exist_ok=True)
                for token, blob in enumerate(chunks):
                    guarded_write(
                        os.path.join(bdir, f"{token:06d}.bin"), blob
                    )
            os.makedirs(tmp, exist_ok=True)  # zero-buffer tasks still commit
            with open(os.path.join(tmp, _MARKER), "wb"):
                pass
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            if lease is not None:
                lease.release()
            raise
        try:
            os.rename(tmp, tdir)  # atomic publish; fails if the target exists
            _fr.record(
                "spool_commit", node=SPOOL_URL, task_id=task_id,
                attempt=attempt, won=True,
            )
            return True
        except OSError:
            shutil.rmtree(tmp, ignore_errors=True)
            if lease is not None:
                lease.release()  # the winning attempt holds the bytes
            _fr.record(
                "spool_commit", node=SPOOL_URL, task_id=task_id,
                attempt=attempt, won=False,
            )
            return False

    # ------------------------------------------------------------- consumer
    def is_committed(self, task_id: str) -> bool:
        return os.path.exists(os.path.join(self.dir, task_id, _MARKER))

    def chunk_path(self, task_id: str, buffer_id: int, token: int) -> str:
        return os.path.join(
            self.dir, task_id, f"buf{buffer_id}", f"{token:06d}.bin"
        )

    def read_chunks(self, task_id: str, buffer_id: int) -> list[bytes]:
        """All chunks of one committed buffer, token order."""
        if not self.is_committed(task_id):
            raise FileNotFoundError(f"task {task_id} not committed in spool")
        bdir = os.path.join(self.dir, task_id, f"buf{buffer_id}")
        if not os.path.isdir(bdir):
            return []
        out = []
        for name in sorted(os.listdir(bdir)):
            if name.endswith(".bin"):
                with open(os.path.join(bdir, name), "rb") as f:
                    blob = f.read()
                _verify_spool_frame(task_id, buffer_id, name, blob)
                out.append(blob)
        return out

    def try_read_chunks(
        self, task_id: str, buffer_id: int
    ) -> Optional[list[bytes]]:
        """Hedge-path read (runtime/worker.py _fetch_source): the chunks
        when the producer COMMITTED, None when it has not yet — a hedged
        consumer polls this while its primary HTTP fetch is in flight, so
        "not committed" is an expected answer, not an error."""
        if not self.is_committed(task_id):
            return None
        return self.read_chunks(task_id, buffer_id)

    def discard(self, task_id: str) -> None:
        """Drop one task's committed dir AND any leftover staging dirs —
        the self-healing path clears a lost/corrupt partition so the
        reproduced producer's first-commit-wins rename can land."""
        try:
            names = os.listdir(self.dir)
        except FileNotFoundError:
            return
        for name in names:
            if name == task_id or name.startswith(task_id + ".tmp-"):
                shutil.rmtree(os.path.join(self.dir, name), ignore_errors=True)

    def adopt(self, task_id: str, new_task_id: str) -> bool:
        """Rename a COMMITTED task dir to a new id — fragment memoization
        (runtime/resultcache.py) moves a finished query's fragment output
        into the ``memo_…`` namespace so it survives that query's
        remove_query.  First-wins like commit_task: renaming onto an
        existing target fails and the source is left for its owner's
        cleanup.  Returns True when THIS call published the new id.

        Both names are PINNED for the duration: a concurrent GC or
        pressure-reclaim sweep must not evict the dir mid-rename (the
        source looks non-live — its query just finished — and the target
        looks like a freshly evictable memo namespace)."""
        if not self.is_committed(task_id):
            return False
        _pin(self.dir, task_id, new_task_id)
        try:
            os.rename(
                os.path.join(self.dir, task_id),
                os.path.join(self.dir, new_task_id),
            )
            return True
        except OSError:
            return False
        finally:
            _unpin(self.dir, task_id, new_task_id)

    # -------------------------------------------------------------- cleanup
    def remove_query(self, query_prefix: str) -> None:
        """Drop every committed task dir (and leftover staging dir) of one
        query — the coordinator calls this when the query reaches a terminal
        state.  Task ids are `{query_id}_...`-prefixed: matching on the
        separator-qualified prefix keeps `q1` from also deleting `q10_*`."""
        try:
            names = os.listdir(self.dir)
        except FileNotFoundError:
            return
        for name in names:
            if name.startswith(query_prefix + "_"):
                shutil.rmtree(os.path.join(self.dir, name), ignore_errors=True)

    def gc(
        self,
        live_query_ids: Iterable[str],
        age_s: float = 0.0,
        now: Optional[float] = None,
    ) -> dict[str, int]:
        """Sweep dirs whose query is NOT live and whose mtime is older than
        `age_s` — a crashed coordinator never called remove_query, so its
        committed task dirs and *.tmp-* staging dirs leak forever without
        this.  The age threshold protects queries owned by OTHER
        coordinators sharing the directory (tests, multi-coordinator dev
        setups): anything actively written is young.  Returns removal
        counts by kind."""
        removed = {"committed": 0, "staging": 0}
        live = list(live_query_ids)
        pinned = _pinned(self.dir)
        try:
            names = os.listdir(self.dir)
        except FileNotFoundError:
            return removed
        now = time.time() if now is None else now
        for name in names:
            if name in pinned:
                continue  # mid-adopt rename (memoization): not evictable
            if any(name.startswith(q + "_") for q in live):
                continue
            path = os.path.join(self.dir, name)
            # only task/staging DIRS are spool-owned; stray files (e.g.
            # out-of-core spill chunks sharing the directory) are not ours
            if not os.path.isdir(path):
                continue
            try:
                if age_s and now - os.path.getmtime(path) < age_s:
                    continue
            except OSError:
                continue  # removed concurrently
            kind = "staging" if ".tmp-" in name else "committed"
            shutil.rmtree(path, ignore_errors=True)
            removed[kind] += 1
            _SPOOL_GC.labels(kind).inc()
        return removed

    def reclaim(
        self,
        needed_bytes: int,
        live_query_ids: Optional[Iterable[str]] = None,
    ) -> int:
        """PRESSURE-based reclaim — the escalation past the age-based gc()
        sweep, invoked by a full NodeDiskPool before any writer blocks or
        any query fails.  Eviction order:

        1. fragment-memo namespaces (``memo_*``) — a cache, re-computable,
           oldest mtime first;
        2. non-live query dirs — only when the caller KNOWS liveness
           (``live_query_ids`` must be the coordinator's live set unioned
           with the fleet lease ``live_queries``; a worker, which cannot
           know fleet-wide liveness, passes None and stops after memo).

        Dirs pinned by an in-flight ``adopt`` rename are never evicted.
        Stops once `needed_bytes` have been freed; returns bytes freed."""
        freed = 0
        pinned = _pinned(self.dir)
        try:
            names = os.listdir(self.dir)
        except FileNotFoundError:
            return 0
        cands: list[tuple[int, str, str]] = []  # (pass#, mtime-key, name)
        live = None if live_query_ids is None else list(live_query_ids)
        for name in names:
            if name in pinned:
                continue
            path = os.path.join(self.dir, name)
            if not os.path.isdir(path):
                continue  # stray files are not spool-owned (see gc)
            if name.startswith("memo_"):
                cands.append((0, name, path))
            elif live is not None and not any(
                name.startswith(q + "_") for q in live
            ):
                cands.append((1, name, path))
        for rank, name, path in sorted(
            cands,
            key=lambda c: (
                c[0],
                _mtime_or_zero(c[2]),
            ),
        ):
            if freed >= needed_bytes:
                break
            nbytes = _dir_bytes(path)
            shutil.rmtree(path, ignore_errors=True)
            freed += nbytes
            _SPOOL_RECLAIM.labels("memo" if rank == 0 else "nonlive").inc()
            _fr.record(
                "spool_reclaim", node=SPOOL_URL, task_id=name,
                category="memo" if rank == 0 else "nonlive",
                freed_bytes=nbytes,
            )
        return freed


def _mtime_or_zero(path: str) -> float:
    try:
        return os.path.getmtime(path)
    except OSError:
        return 0.0
