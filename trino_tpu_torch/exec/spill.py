"""Out-of-core execution: working sets larger than the card's memory.

Reference: the revocable-memory + spill complex —
spiller/FileSingleStreamSpiller.java:59 (serialized pages to local disk),
SpillableHashAggregationBuilder.java:55 (aggregation partitions spill and
merge), HashBuilderOperator.java:167 (join build spill states, partition-
at-a-time unspilling).

Shape: out-of-core is TIME-MULTIPLEXED DISTRIBUTED EXECUTION.  The
distributed planner (plan/distribute.py) rewrites any plan into P
hash-partitioned fragments whose exchanges are disjoint by key; this
executor runs those fragments on ONE card, one slice after another, parking
every exchange on disk as framed, compressed wire pages (runtime/wire.py,
the C++ serde of trino_tpu_torch/native) between stages.  The card holds
only 1/P of each stage's working set at a time:

    parallel across cards  ==  sequential across time slices
    an all-to-all          ==  a spill-file shuffle on local disk

Every slice of a fragment runs through ONE LocalExecutor on the engine's
device, with its scans split and padded to one common size, so the slices
share one set of learned capacities; between slices the executor drops its
scan columns, pages and live counts (`LocalExecutor.drop_scans`).  A join
whose build side arrived from a spill file narrows its probe scan first
(exec/dynfilter.py).  The part count P comes from the plan's byte estimate
against the query's budget (runtime/engine.py).
"""

from __future__ import annotations

import os
import shutil
import tempfile

from ..connectors.spi import CatalogManager
from ..data.page import Page
from ..plan.distribute import distribute
from ..plan.nodes import PlanNode, TableScan
from ..runtime.disk import guarded_write
from ..runtime.wire import page_to_wire_chunks, partition_page, wire_to_page
from ..utils.metrics import GLOBAL as _METRICS
from .compiler import LocalExecutor, _node_ids
from .dynfilter import collect_dynamic_filters
from .stages import StagedExecutor

__all__ = ["OutOfCoreExecutor", "estimate_plan_bytes"]

_SPILL_BYTES = _METRICS.counter("trino_tpu_spill_bytes_total", "Bytes written to spill files")
_SPILL_FILES = _METRICS.counter("trino_tpu_spill_files_total", "Spill chunk files written")


def estimate_plan_bytes(plan: PlanNode, catalogs: CatalogManager) -> int:
    """Upper-bound estimate of device bytes for single-shot execution:
    scanned column bytes plus the same again for operator state (join
    expansion frames and group-by capacities are bounded by the input size
    for TPC-class plans; the factor 2 covers gathered intermediates)."""
    total = 0
    for _, n in _node_ids(plan).items():
        if isinstance(n, TableScan):
            conn = catalogs.get(n.catalog)
            rows = conn.estimated_row_count(n.table) or 0
            width = 0
            for t in n.output_types:
                width += 4 if t.is_string else t.np_dtype.itemsize
            total += rows * width
    return total * 2


class OutOfCoreExecutor(StagedExecutor):
    """Executes a logical plan in P sequential hash-partitioned slices with
    disk-backed exchanges, on `device`.  Call-compatible with
    LocalExecutor.execute for the engine's read path.  The fragment loop is
    exec/stages.py's; this class is its transport (spill files)."""

    def __init__(
        self,
        catalogs: CatalogManager,
        default_catalog: str,
        parts: int,
        session=None,
        device="cuda",
    ):
        self.catalogs = catalogs
        self.default_catalog = default_catalog
        self.parts = max(2, parts)
        self.session = session
        self.device = device
        self.spilled_bytes = 0
        self.spill_files = 0
        self.rows_pruned = 0
        # per slice run: {"fragment", "part", "retries"} where the executor
        # re-ran for capacities (slices 2..P should reuse slice 1's)
        self.slice_retries: list[dict] = []
        self.fragments = 0

    def _executor(self) -> LocalExecutor:
        return LocalExecutor(self.catalogs, self.default_catalog, device=self.device)

    def execute(self, plan: PlanNode, params: tuple = ()) -> Page:
        """Run `plan` slice by slice; `params` are a prepared statement's
        bound values, handed to every slice's run."""
        dplan = distribute(plan, self.catalogs, self.parts, self.session)
        self._tmp = tempfile.mkdtemp(prefix="trino_tpu_torch_spill_")
        # (fragment id, producer part, output partition) -> chunk files
        self._spill: dict[tuple[int, int, int], list[str]] = {}
        self._seq = 0
        try:
            return self.run_fragments(dplan, params)
        finally:
            shutil.rmtree(self._tmp, ignore_errors=True)
            self._spill = {}

    def _write_chunks(self, key, chunks: list[bytes]) -> None:
        paths = []
        for blob in chunks:
            path = os.path.join(self._tmp, f"s{self._seq}.page")
            self._seq += 1
            guarded_write(path, blob)
            self.spilled_bytes += len(blob)
            self.spill_files += 1
            _SPILL_BYTES.inc(len(blob))
            _SPILL_FILES.inc()
            paths.append(path)
        self._spill[key] = paths

    def _run_fragment(self, f, params: tuple) -> None:
        out_parts = self.consumer_tasks(f)
        ntasks = self._ntasks[f.id]
        # ONE executor per fragment, every slice padded alike: the slices
        # share learned capacities; the scan cache is dropped between slices
        # so the card holds one slice's working set
        ex = self._executor()
        ex.pad_splits = True
        for p in range(ntasks):
            ex.split = (p, ntasks)
            ex.drop_scans()
            remote = self._sources(f, p)
            ex.scan_filters = collect_dynamic_filters(f.root, remote)
            page = ex.execute(f.root, remote, params)
            if ex.last_retries:
                self.slice_retries.append(
                    {"fragment": f.id, "part": p, "retries": list(ex.last_retries)}
                )
            self.rows_pruned += ex.rows_pruned
            ex.rows_pruned = 0
            if f.output_kind == "repartition":
                chunk_lists = partition_page(page, list(f.output_keys), out_parts)
                for op, chunks in enumerate(chunk_lists):
                    self._write_chunks((f.id, p, op), chunks)
            else:
                self._write_chunks((f.id, p, 0), page_to_wire_chunks(page))
            del page, remote
        ex.drop_scans()

    def _run_root(self, root, params: tuple) -> Page:
        ex = self._executor()
        return ex.execute(root.root, self._sources(root, 0), params)

    def _receive(self, child, reads: list, part: int) -> Page:
        blobs = []
        for p, slot in reads:
            for path in self._spill.get((child.id, p, slot), []):
                with open(path, "rb") as fh:
                    blobs.append(fh.read())
        return wire_to_page(
            blobs, list(child.root.output_types), pad_pow2=True, device=self.device
        )
