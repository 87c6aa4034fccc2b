"""Distributed executor: a distributed plan's fragments as tasks over a list
of devices, with every exchange kept in device memory.

The reference's distributed runtime is coordinator-driven task
orchestration: PlanFragmenter cuts the plan at exchanges, the scheduler
posts fragments to workers and pages stream between tasks
(execution/scheduler/PipelinedQueryScheduler.java:164, server/remotetask/
HttpRemoteTask.java:135).  The JAX package inverts that into ONE SPMD
program under shard_map, the exchanges traced in as XLA collectives.  The
port's executor is eager (there is no program to trace collectives into),
so it keeps the reference's stages and tasks and the JAX package's
contract: the same distributed plan (plan/distribute.py), the same shards,
the same exchange placement, the same rows, the same EXPLAIN ANALYZE row
counts.

- `devices` may repeat a card: ["cuda:0"] * 4 is four workers on one card,
  the counterpart of the reference tests' virtual CPU devices.  Task d of
  every fragment runs on devices[d]; the root (result) fragment runs one
  task, on devices[0].
- Scans are split by row range, as in the JAX package's
  `sharded_table_page`: task d owns rows [d*cap_local, (d+1)*cap_local) of
  every scan, cap_local = ceil(rows / D).  Each column is uploaded once per
  card and write generation (that card's LocalExecutor scan cache); a task's
  shard is a slice of it on the device, sharing the column's Dictionary,
  and the last shard's pad rows are dead.
- Fragments run children first (exec/stages.py, the loop the out-of-core
  executor shares); a fragment's D tasks share one capacity-retry loop
  (LocalExecutor.run_tasks: `required` sizes max-reduced over the tasks,
  the counterpart of the JAX package's pmax), and its learned capacities
  are kept per fragment.  EnforceSingleRow's multi-row error is raised
  from the max-reduced count, as there.
- Exchanges: parallel/exchange.py for repartition, gather and broadcast;
  `single` hands producer 0's output to consumer task 0 and a dead page to
  the others.

EXPLAIN ANALYZE returns each node's live rows summed over its tasks, keyed
by the distributed plan's node ids (an Exchange by its consumer's
RemoteSource).  The root fragment is replicated — every device of the SPMD
program computes it — so its counts are those of one task times D, as the
JAX package's psum over devices reports them.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

import torch

from .. import resolve_device
from ..connectors.spi import CatalogManager
from ..data.page import Column, Page
from ..ops import kernels as _kernels
from ..parallel.exchange import _EXCHANGE_BYTES, empty_like, gather_all, repartition
from ..plan.nodes import Exchange, PlanNode, RemoteSource, TableScan
from .compiler import LocalExecutor, _generation, _node_ids
from .stages import StagedExecutor

__all__ = ["SpmdExecutor", "default_devices"]

_EXCHANGE_KINDS = ("repartition", "gather", "broadcast")


def default_devices() -> list[torch.device]:
    """Every visible card; raises as resolve_device does when there is none."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _normal(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class SpmdExecutor(LocalExecutor, StagedExecutor):
    def __init__(
        self,
        catalogs: CatalogManager,
        default_catalog: str = "tpch",
        devices: Optional[Sequence] = None,
    ):
        devices = [_normal(d) for d in (default_devices() if devices is None else devices)]
        if not devices:
            raise ValueError("a distributed executor needs at least one device")
        # the LocalExecutor base holds the fragments' learned capacities and
        # their retry loop; scans go through one LocalExecutor per card
        super().__init__(catalogs, default_catalog, device=devices[0])
        self.devices = devices
        self.parts = len(devices)
        self._cards: dict[torch.device, LocalExecutor] = {}
        # (device, catalog, table, columns, generation) -> {task: shard page}
        self._shards: dict[tuple, dict[int, Page]] = {}
        # fragment id -> its exchange's pages, one per consumer task (for
        # `single`, the producer's pages)
        self._outputs: dict[int, list[Page]] = {}
        self._events: list = []
        # set by explain_analyze: fragment id -> {local node id: live rows}
        self._node_rows: Optional[dict[int, dict[int, int]]] = None
        self.fragments = 0
        self._lock = threading.RLock()
        # bytes of rows each exchange kind copied in the last execute()
        self.last_exchange_bytes: dict[str, int] = {}

    @property
    def num_devices(self) -> int:
        return len(self.devices)

    # ----------------------------------------------------------- input shards
    def _card(self, dev: torch.device) -> LocalExecutor:
        ex = self._cards.get(dev)
        if ex is None:
            ex = self._cards[dev] = LocalExecutor(self.catalogs, self.default_catalog, device=dev)
        return ex

    def sharded_table_page(self, node: TableScan, task: int) -> Page:
        """Task `task`'s rows of the scan: [task*cap_local, (task+1)*cap_local)
        of the table's device columns on devices[task] (a view, or for a
        shard that runs past the table's end a copy with a dead tail)."""
        dev = self.devices[task]
        full = self._card(dev).table_page(
            node.catalog, node.table, node.column_names, node.output_types
        )
        gen = _generation(self.catalogs.get(node.catalog), node.table)
        key = (dev, node.catalog, node.table, tuple(node.column_names), gen)
        shards = self._shards.get(key)
        if shards is None:
            for k in [k for k in self._shards
                      if k[1:3] == (node.catalog, node.table) and k[4] != gen]:
                del self._shards[k]
            shards = self._shards[key] = {}
        page = shards.get(task)
        if page is None:
            cap_local = max(1, -(-full.capacity // self.num_devices))
            page = shards[task] = _shard(full, task * cap_local, cap_local)
        return page

    def drop_scans(self) -> None:
        for ex in self._cards.values():
            ex.drop_scans()
        self._shards.clear()

    def drop_table_cache(self, catalog: str, table: str) -> None:
        for ex in self._cards.values():
            ex.drop_table_cache(catalog, table)
        for k in [k for k in self._shards if k[1:3] == (catalog, table)]:
            del self._shards[k]

    def _leaf_inputs(self, nodes: dict, remote: dict, task: Optional[int]) -> dict:
        """Input pages of a fragment's leaves for `task` (None: the root's one
        task, which scans whole tables)."""
        inputs: dict[str, Page] = {}
        for i, n in nodes.items():
            if isinstance(n, TableScan):
                inputs[str(i)] = (
                    self._card(self.devices[0]).table_page(
                        n.catalog, n.table, n.column_names, n.output_types)
                    if task is None else self.sharded_table_page(n, task)
                )
            elif isinstance(n, RemoteSource):
                inputs[str(i)] = remote[n.fragment_id]
        return inputs

    # -------------------------------------------------------------- execution
    def execute(
        self, plan: PlanNode, remote_pages: Optional[dict] = None, params: tuple = (),
    ) -> Page:
        """Run the distributed plan `plan` (plan/distribute.py's output);
        `params` are a prepared statement's bound values, handed to every
        task."""
        if remote_pages:
            raise ValueError("a distributed plan reads no remote pages")
        with self._lock:  # the fragment loop's state is the executor's: one run at a time
            for ex in self._cards.values():
                ex.last_upload_ms = 0.0
            before = {k: _EXCHANGE_BYTES.value(k) for k in _EXCHANGE_KINDS}
            self._events = []
            try:
                page = self.run_fragments(plan, params)
            finally:
                self._outputs.clear()
            self.last_upload_ms = sum(ex.last_upload_ms for ex in self._cards.values())
            self.last_exchange_bytes = {
                k: int(_EXCHANGE_BYTES.value(k) - before[k]) for k in _EXCHANGE_KINDS
            }
            _kernels.remember(plan, self._events)
            return page

    def _run(self, f, tasks: list, params: tuple) -> list[Page]:
        rows = None if self._node_rows is None else self._node_rows.setdefault(f.id, {})
        outs = self.run_tasks(f.root, tasks, params, node_rows=rows)
        self._events.extend(_kernels.events_for(f.root))
        return outs

    def _run_fragment(self, f, params: tuple) -> None:
        nodes = _node_ids(f.root)
        tasks = [
            (self._leaf_inputs(nodes, self._sources(f, d), d), self.devices[d])
            for d in range(self._ntasks[f.id])
        ]
        for child in f.inputs:  # the tasks hold what they read
            self._outputs.pop(child, None)
        outs = self._run(f, tasks, params)
        del tasks
        consumers = self.consumer_tasks(f)
        dests = self.devices[:consumers]
        kind = f.output_kind
        if kind == "repartition":
            self._outputs[f.id], _ = repartition(outs, f.output_keys, consumers, dests)
        elif kind in ("gather", "broadcast"):
            self._outputs[f.id] = gather_all(outs, dests, kind)
        else:  # single
            self._outputs[f.id] = outs

    def _receive(self, child, reads: list, part: int) -> Page:
        pages = self._outputs[child.id]
        if child.output_kind != "single":
            return pages[part]
        # a replicated input counted once: producer 0's rows, in task 0 only
        return pages[0] if reads else empty_like(pages[0], self.devices[part])

    def _run_root(self, root, params: tuple) -> Page:
        nodes = _node_ids(root.root)
        inputs = self._leaf_inputs(nodes, self._sources(root, 0), None)
        return self._run(root, [(inputs, self.devices[0])], params)[0]

    def explain_analyze(self, plan: PlanNode) -> tuple[Page, dict]:
        """Returns (page, stats) with stats[nid] = {"rows": n}: each node's
        live rows summed over its tasks, keyed by the distributed plan's node
        ids.  The plan runs once to learn capacities, then once more with
        every node's rows counted (fused aggregate chains unfused, so each
        node of the chain has its count)."""
        with self._lock:
            self.execute(plan)
            self._node_rows = {}
            try:
                page = self.execute(plan)
                rows = self._node_rows
            finally:
                self._node_rows = None
        stats: dict[int, dict] = {}
        for (fid, local), nid in _fragment_node_ids(plan).items():
            n = rows.get(fid, {}).get(local)
            if n is not None:
                stats[nid] = {"rows": n * (self.num_devices if fid == 0 else 1)}
        return page, stats


def _shard(full: Page, lo: int, cap: int) -> Page:
    """Rows [lo, lo + cap) of `full`; rows past its end are dead pad rows."""
    n = full.capacity
    lo = min(lo, n)
    m = min(cap, n - lo)
    pad = cap - m

    def part(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        if t is None:
            return None
        view = t[lo:lo + m]
        if not pad:
            return view
        return torch.cat([view, torch.zeros((pad,), dtype=t.dtype, device=t.device)])

    cols = tuple(
        Column(c.type, part(c.data), part(c.valid), c.dictionary, part(c.data2))
        for c in full.columns
    )
    if full.live is None and not pad:
        return Page(cols, None)
    dev = full.device
    live = full.live[lo:lo + m] if full.live is not None else torch.ones(
        (m,), dtype=torch.bool, device=dev)
    if pad:
        live = torch.cat([live, torch.zeros((pad,), dtype=torch.bool, device=dev)])
    return Page(cols, live)


def _fragment_node_ids(dplan: PlanNode) -> dict[tuple[int, int], int]:
    """(fragment id, node id within the fragment) -> node id in `dplan`.
    plan/fragmenter.py numbers fragments by the preorder of their
    exchanges, and an Exchange becomes a RemoteSource leaf of the fragment
    above it, so one preorder walk of `dplan` numbers both."""
    out: dict[tuple[int, int], int] = {}
    local: dict[int, int] = {}
    counters = {"node": 0, "fragment": 0}

    def walk(node: PlanNode, fid: int) -> None:
        nid = counters["node"]
        counters["node"] += 1
        out[(fid, local.setdefault(fid, 0))] = nid
        local[fid] += 1
        if isinstance(node, Exchange):
            counters["fragment"] += 1
            walk(node.child, counters["fragment"])
            return
        for c in node.children:
            walk(c, fid)

    walk(dplan, 0)
    return out
