"""Dynamic filtering: build-side key domains narrow probe-side scans.

Reference: server/DynamicFilterService.java:103 collects per-driver build
domains (DynamicFilterSourceOperator), the coordinator narrows probe scans
(createDynamicFilter:272) before and during execution.

Placement: a fragment whose join reads its build side from a RemoteSource
has that page in hand before its probe-side scan uploads (the out-of-core
executor, exec/spill.py, decodes it from the spill files first) — so the
filter point is on the host, between the read and the upload: take
[min, max] of the live build keys, or their distinct values for a string
key, and drop the probe scan's rows outside that domain before they cost
transfer bandwidth or kernel lanes (LocalExecutor.table_page, counted in
`rows_pruned`).  No extra protocol, no round trip.

Applies to inner and semi joins (an outer probe row must survive even when
unmatched, so left joins never prune).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..data.page import Page
from ..plan.ir import FieldRef
from ..plan.nodes import Filter, Join, PlanNode, RemoteSource, TableScan

__all__ = ["ScanFilter", "collect_dynamic_filters", "keep_mask"]


@dataclass(frozen=True)
class ScanFilter:
    """Domain filter on one scan column (reference: TupleDomain of a
    dynamic filter): a numeric [min, max] range, or — for dictionary-coded
    string keys — an explicit sorted value set (the reference's discrete
    TupleDomain; star joins keyed on strings stay unpruned by ranges)."""

    column: str
    min: float = 0.0
    max: float = 0.0
    values: Optional[tuple] = None  # sorted distinct values; None == range


# build sides with more distinct strings than this skip the set domain (the
# reference's dynamic-filtering max-distinct limit); membership tests on the
# host scale with the set
_MAX_SET_VALUES = 100_000


def _scan_under(node: PlanNode) -> Optional[TableScan]:
    """The probe-side TableScan when the path keeps column indexes (a Filter
    keeps its child's layout; anything else breaks the mapping)."""
    while isinstance(node, Filter):
        node = node.child
    return node if isinstance(node, TableScan) else None


def collect_dynamic_filters(
    root: PlanNode, remote_pages: dict[int, Page]
) -> dict[int, tuple[ScanFilter, ...]]:
    """-> {scan node id: (ScanFilter, ...)} for this fragment, keyed by the
    executor's preorder node numbering — a filter applies ONLY to the scan
    site under its join, never to other scans of the same table elsewhere
    in the fragment.

    Finds inner / semi joins whose build side is a RemoteSource with a page
    in `remote_pages` and whose probe key maps straight to a scan column,
    and takes the domain of the live, valid build keys.  The build page may
    live on any device: its mask and key columns come to the host in one
    transfer per key."""
    from ..runtime.wire import _to_host
    from .compiler import _node_ids

    ids = {id(n): nid for nid, n in _node_ids(root).items()}
    out: dict[int, list[ScanFilter]] = {}

    def visit(node: PlanNode) -> None:
        for c in node.children:
            visit(c)
        if not isinstance(node, Join) or node.kind not in ("inner", "semi"):
            return
        if not isinstance(node.right, RemoteSource):
            return
        page = remote_pages.get(node.right.fragment_id)
        if page is None:
            return
        scan = _scan_under(node.left)
        if scan is None or id(scan) not in ids:
            return
        for lk, rk in zip(node.left_keys, node.right_keys):
            if not (isinstance(lk, FieldRef) and isinstance(rk, FieldRef)):
                continue
            if lk.index >= len(scan.column_names):
                continue
            col = page.columns[rk.index]
            if col.type.np_dtype == np.dtype(np.bool_) or col.data2 is not None:
                continue
            live, data, valid = _to_host([page.live_mask(), col.data, col.valid])
            keep = np.asarray(live, np.bool_).copy()
            if valid is not None:
                keep &= np.asarray(valid, np.bool_)
            data = np.asarray(data)[keep]
            if len(data) == 0:
                continue
            if col.type.is_string:
                # dictionary-set domain: live build codes -> distinct values
                if col.dictionary is None or len(col.dictionary) > _MAX_SET_VALUES:
                    continue
                codes = np.unique(data)
                codes = codes[(codes >= 0) & (codes < len(col.dictionary))]
                values = tuple(sorted(col.dictionary.values[codes]))
                out.setdefault(ids[id(scan)], []).append(
                    ScanFilter(scan.column_names[lk.index], values=values)
                )
            else:
                out.setdefault(ids[id(scan)], []).append(
                    ScanFilter(scan.column_names[lk.index], float(data.min()), float(data.max()))
                )

    visit(root)
    visit = None  # the recursive closure holds the build pages: cut the cycle
    return {nid: tuple(fs) for nid, fs in out.items()}


def keep_mask(data: dict, filters, nrows: int) -> np.ndarray:
    """Rows of the host columns `data` inside every filter's domain (a NULL
    probe key never equi-matches, so it is dropped too)."""
    keep = np.ones((nrows,), dtype=bool)
    for f in filters:
        vals = data[f.column]
        if f.values is not None:
            base = np.ma.getdata(vals) if isinstance(vals, np.ma.MaskedArray) else vals
            ok = np.isin(base, np.asarray(f.values, dtype=object))
            if isinstance(vals, np.ma.MaskedArray):
                ok &= ~np.ma.getmaskarray(vals)
            keep &= ok
        elif isinstance(vals, np.ma.MaskedArray):
            keep &= np.asarray(((vals >= f.min) & (vals <= f.max)).filled(False))
        else:
            keep &= (vals >= f.min) & (vals <= f.max)
    return keep
