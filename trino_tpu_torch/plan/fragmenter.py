"""Plan fragmenter: cut the distributed plan at Exchange nodes.

Reference: sql/planner/PlanFragmenter.java:96 — createSubPlans cuts the
plan at remote exchanges into PlanFragments shipped to workers; each
fragment's output partitioning comes from the exchange that consumed it
(PartitioningScheme).  Identical here: every Exchange boundary becomes a
producer fragment (output partitioned per the exchange kind/keys) and a
RemoteSource leaf in the consumer fragment.

In the port two executors run the fragments (exec/stages.py): the
distributed one (exec/spmd.py) as D tasks each over a list of devices,
the exchanges kept in device memory (parallel/exchange.py), and the
out-of-core one (exec/spill.py) slice after slice on one card, parking
every exchange on disk as wire pages (runtime/wire.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .ir import IrExpr
from .nodes import Exchange, PlanNode, RemoteSource

__all__ = ["Fragment", "fragment_plan"]


@dataclass
class Fragment:
    """One stage of a distributed query (reference: PlanFragment)."""

    id: int
    root: PlanNode
    # how this fragment's output is routed to its consumer:
    output_kind: str  # repartition | broadcast | gather | single | result
    output_keys: tuple[IrExpr, ...] = ()
    # fragment ids this fragment reads via RemoteSource
    inputs: list[int] = field(default_factory=list)


def fragment_plan(plan: PlanNode) -> list[Fragment]:
    """-> fragments in id order; fragment 0 is the root (result) stage.
    Fragments must execute children-first (the scheduler runs them in
    reverse id order, which is a valid topological order)."""
    fragments: list[Fragment] = []

    def cut(node: PlanNode, frag: Fragment) -> PlanNode:
        if isinstance(node, Exchange):
            child_frag = Fragment(len(fragments), None, node.kind, node.keys)  # type: ignore[arg-type]
            fragments.append(child_frag)
            child_frag.root = cut(node.child, child_frag)
            frag.inputs.append(child_frag.id)
            return RemoteSource(
                child_frag.id, node.child.output_names, node.child.output_types
            )
        # rebuild with cut children
        kids = node.children
        if not kids:
            return node
        new_kids = tuple(cut(c, frag) for c in kids)
        if new_kids == kids:
            return node
        return _replace_children(node, new_kids)

    root = Fragment(0, None, "result")  # type: ignore[arg-type]
    fragments.append(root)
    root.root = cut(plan, root)
    return fragments


def _replace_children(node: PlanNode, kids: tuple[PlanNode, ...]) -> PlanNode:
    import dataclasses

    from .nodes import Concat, Join

    if isinstance(node, Join):
        return dataclasses.replace(node, left=kids[0], right=kids[1])
    if isinstance(node, Concat):
        return dataclasses.replace(node, inputs=kids)
    return dataclasses.replace(node, child=kids[0])
