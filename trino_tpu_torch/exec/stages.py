"""Stage scheduling of a distributed plan: the fragment loop shared by the
two executors that run one.

Reference: PlanFragmenter cuts the plan at remote exchanges and the
scheduler starts the stages children first (execution/scheduler/
PipelinedQueryScheduler.java:164), each stage as tasks that read their
inputs from the exchanges below.  Both of the port's distributed executors
keep that contract and differ only in transport:

- exec/spmd.py runs every fragment as D tasks over D devices (several may
  share one card) and moves each exchange in device memory
  (parallel/exchange.py);
- exec/spill.py runs every fragment as P slices one after another on one
  card and parks each exchange on disk as wire pages.

Every fragment but the root runs `parts` tasks; the root (result) fragment
runs one.  What a consumer task reads from an exchange depends only on the
exchange's kind (`exchange_reads`).
"""

from __future__ import annotations

from ..data.page import Page
from ..plan.fragmenter import Fragment, fragment_plan
from ..plan.nodes import PlanNode

__all__ = ["StagedExecutor", "exchange_reads"]


def exchange_reads(kind: str, producers: int, part: int) -> list[tuple[int, int]]:
    """The (producer task, output partition) pairs that consumer task `part`
    reads from an exchange of `kind` over `producers` tasks: partition
    `part` of every producer for a repartition; every producer's whole
    output for a gather or broadcast; for `single` (a replicated input that
    must count once, the JAX package's `live & (axis_index == 0)`), producer
    0's output in task 0 and nothing elsewhere."""
    if kind == "single":
        return [(0, 0)] if part == 0 else []
    if kind == "repartition":
        return [(p, part) for p in range(producers)]
    return [(p, 0) for p in range(producers)]


class StagedExecutor:
    """Runs a distributed plan's fragments children first.  Subclasses set
    `parts` and give the transport:

    - `_run_fragment(f, params)` runs fragment `f` over its tasks (each
      reading `_sources(f, task)`) and keeps its output for the consumer;
    - `_receive(child, reads, part)` hands consumer task `part` its input
      page from the exchange above fragment `child`, `reads` being
      `exchange_reads` of that exchange;
    - `_run_root(root, params)` runs the result fragment and returns its
      page."""

    parts: int = 1

    def run_fragments(self, dplan: PlanNode, params: tuple = ()) -> Page:
        fragments = fragment_plan(dplan)
        self.fragments = len(fragments)
        self._frag_by_id = {f.id: f for f in fragments}
        self._ntasks = {
            f.id: (1 if f.output_kind == "result" else self.parts) for f in fragments
        }
        self._consumer_of = {c: f.id for f in fragments for c in f.inputs}
        # fragment ids grow in preorder: reverse id order runs children first
        for f in sorted(fragments, key=lambda fr: -fr.id):
            if f.output_kind != "result":
                self._run_fragment(f, params)
        return self._run_root(self._frag_by_id[0], params)

    def consumer_tasks(self, f: Fragment) -> int:
        """Tasks of the fragment that reads `f`'s output."""
        return self._ntasks[self._consumer_of[f.id]]

    def _sources(self, f: Fragment, part: int) -> dict[int, Page]:
        """Task `part` of `f`: fragment id -> its RemoteSource input page."""
        remote: dict[int, Page] = {}
        for child_id in f.inputs:
            child = self._frag_by_id[child_id]
            reads = exchange_reads(child.output_kind, self._ntasks[child_id], part)
            remote[child_id] = self._receive(child, reads, part)
        return remote

    def _run_fragment(self, f: Fragment, params: tuple) -> None:
        raise NotImplementedError

    def _receive(self, child: Fragment, reads: list, part: int) -> Page:
        raise NotImplementedError

    def _run_root(self, root: Fragment, params: tuple) -> Page:
        raise NotImplementedError
