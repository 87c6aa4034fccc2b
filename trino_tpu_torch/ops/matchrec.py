"""Row-pattern recognition: the MATCH_RECOGNIZE operator.

Trino runs this as an NFA-program interpreter over one row at a time
(operator/window/matcher/Matcher.java + IrRowPatternToProgramRewriter).
Here everything that is per row and independent runs on the device over the
whole page — the sort by partition and order keys, the partition runs, the
PREV / NEXT shifted columns and one DEFINE mask per label — and only the
pattern walk, which is sequential under AFTER MATCH SKIP semantics, runs on
the host as a compact backtracking VM over those masks, fetched once.  The
measures are then gathered on the device from the matched rows.

Pattern compilation (Thompson construction with greedy / reluctant
priority):

    instructions:
      ("row", label_idx)   consume one row that satisfies the label's mask
      ("split", a, b)      try a first, then b (priority = preferment order)
      ("jmp", a)
      ("match",)

SQL preferment (greedy quantifiers prefer longer, alternation prefers the
left branch) maps exactly to the split priority of a backtracking walk.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..data.page import Dictionary
from .expr import ColumnVal, _torch_dtype, eval_expr, eval_predicate
from .relops import SortSpec, _gather_cols, sort_rows

__all__ = ["compile_pattern", "find_matches", "execute_match"]

_MAX_REPEAT_UNROLL = 64  # {n,m} unroll guard
_STEP_BUDGET_FACTOR = 512  # backtracking step cap per start row (VM safety)


def compile_pattern(pattern) -> tuple[tuple[tuple, ...], tuple[str, ...]]:
    """Pattern AST (sql/ast.py Pat*) -> (program, labels)."""
    from ..sql.ast import PatAlt, PatConcat, PatLabel, PatQuant

    labels: list[str] = []
    label_ix: dict[str, int] = {}
    prog: list = []

    def lab(name: str) -> int:
        if name not in label_ix:
            label_ix[name] = len(labels)
            labels.append(name)
        return label_ix[name]

    def emit(node) -> None:
        if isinstance(node, PatLabel):
            prog.append(("row", lab(node.label)))
            return
        if isinstance(node, PatConcat):
            for p in node.parts:
                emit(p)
            return
        if isinstance(node, PatAlt):
            # a chain of splits preferring the leftmost branch
            jumps: list[int] = []
            for i, p in enumerate(node.parts):
                if i < len(node.parts) - 1:
                    split_at = len(prog)
                    prog.append(None)  # the split, patched below
                    emit(p)
                    jumps.append(len(prog))
                    prog.append(None)  # the jump to the end, patched below
                    prog[split_at] = ("split", split_at + 1, len(prog))
                else:
                    emit(p)
            end = len(prog)
            for j in jumps:
                prog[j] = ("jmp", end)
            return
        if isinstance(node, PatQuant):
            lo, hi = node.lo, node.hi
            if hi is not None and hi - lo > _MAX_REPEAT_UNROLL:
                raise ValueError(f"pattern repetition too large: {{{lo},{hi}}}")
            for _ in range(lo):
                emit(node.child)
            if hi is None:
                # (child)* loop: split(body, exit) greedy, split(exit, body)
                # reluctant
                loop_at = len(prog)
                prog.append(None)
                emit(node.child)
                prog.append(("jmp", loop_at))
                exit_at = len(prog)
                prog[loop_at] = (
                    ("split", loop_at + 1, exit_at) if node.greedy
                    else ("split", exit_at, loop_at + 1)
                )
            else:
                # (child){0, hi-lo}: nested optional copies
                exits: list[int] = []
                for _ in range(hi - lo):
                    exits.append(len(prog))
                    prog.append(None)
                    emit(node.child)
                end = len(prog)
                for split_at in exits:
                    prog[split_at] = (
                        ("split", split_at + 1, end) if node.greedy
                        else ("split", end, split_at + 1)
                    )
            return
        raise TypeError(f"unknown pattern node {node!r}")

    emit(pattern)
    prog.append(("match",))
    return tuple(prog), tuple(labels)


def _run_vm(
    program: Sequence[tuple], masks: Sequence[Sequence[bool]], start: int, end: int
) -> Optional[list[tuple[int, int]]]:
    """The PREFERRED match starting exactly at `start` (and ending before
    `end`), as a list of (row, label_idx) assignments, or None when no
    non-empty match starts there.  Iterative backtracking: the trail of
    split decisions is the stack, and the priority order of `split`
    encodes SQL preferment.  `masks[label][row]` is a python list lookup."""
    assigned: list[tuple[int, int]] = []
    stack: list[tuple[int, int, int]] = []  # (alternative pc, pos, n assigned)
    pc, pos = 0, start
    budget = _STEP_BUDGET_FACTOR * max(end - start, 1)
    while True:
        budget -= 1
        if budget <= 0:
            raise RuntimeError(
                "row pattern exceeded step budget (catastrophic backtracking"
                " or empty-loop pattern)"
            )
        op = program[pc]
        kind = op[0]
        if kind == "row":
            if pos < end and masks[op[1]][pos]:
                assigned.append((pos, op[1]))
                pos += 1
                pc += 1
                continue
        elif kind == "jmp":
            pc = op[1]
            continue
        elif kind == "split":
            stack.append((op[2], pos, len(assigned)))
            pc = op[1]
            continue
        elif assigned:  # match
            return assigned
        # an empty match counts as no match; backtrack
        if not stack:
            return None
        pc, pos, keep = stack.pop()
        del assigned[keep:]


def find_matches(
    program: Sequence[tuple],
    masks: np.ndarray,  # [L, n] bool over SORTED rows
    part_start: np.ndarray,  # [n] partition start index per row
    after_skip: str,
) -> list[tuple[int, list[tuple[int, int]]]]:
    """Walk every partition; returns [(match_number, [(sorted_row,
    label_idx), ...]), ...] in output order.  match_number is 1-based and
    counts per partition (SQL MATCH_NUMBER()).  Under AFTER MATCH SKIP TO
    NEXT ROW matches may overlap, so a row can be in several matches."""
    n = masks.shape[1] if masks.ndim == 2 else 0
    rows = [m.tolist() for m in masks]
    part_start = np.asarray(part_start)
    bounds = np.flatnonzero(part_start[1:] != part_start[:-1]) + 1 if n else []
    edges = [0, *(int(b) for b in bounds), n] if n else [0]
    out: list[tuple[int, list[tuple[int, int]]]] = []
    for p0, p_end in zip(edges[:-1], edges[1:]):
        start, mno = p0, 0
        while start < p_end:
            found = _run_vm(program, rows, start, p_end)
            if found is None:
                start += 1
                continue
            mno += 1
            out.append((mno, found))
            start = start + 1 if after_skip == "next_row" else found[-1][0] + 1
    return out


def execute_match(node, cols, live):
    """Execute a MatchRecognize plan node over a stage's columns.

    cols: list[ColumnVal] (the child's schema), live: bool tensor.
    Returns (out_cols: list[ColumnVal], out_live: bool tensor)."""
    dev = live.device
    n = int(live.sum())  # one sync: the live row count

    # ---- 1. one stable sort: live rows first, then the partition keys
    # (NULLs first), then the ORDER BY keys; the first n lanes are the rows
    cap = int(live.shape[0])
    pkeys = [eval_expr(k, cols, cap, dev) for k in node.partition_keys]
    okeys = [eval_expr(sk.expr, cols, cap, dev) for sk in node.order_keys]
    specs = [SortSpec(True, True)] * len(pkeys) + [
        SortSpec(sk.ascending, sk.nulls_first) for sk in node.order_keys
    ]
    ordered, _ = sort_rows(list(cols) + pkeys, live, pkeys + okeys, specs)
    if n == 0:  # no rows, no matches: one dead output lane
        out_cols = [ColumnVal(c.data[:1], torch.zeros((1,), dtype=torch.bool, device=dev),
                              c.dict, c.type, None if c.data2 is None else c.data2[:1])
                    for c in (ordered[: len(cols)] if node.all_rows else ordered[len(cols):])]
        out_cols += [eval_expr(ir, [_null_lane(t, dev) for t in node.prim_types], 1, dev)
                     for ir in node.measures]
        return out_cols, torch.zeros((1,), dtype=torch.bool, device=dev)
    ordered = _gather_cols(ordered, torch.arange(n, device=dev))
    scols, spkeys = ordered[: len(cols)], ordered[len(cols):]

    # ---- 2. partition runs: part_start[i] = the first row of i's partition
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    if spkeys:
        same = torch.ones((n,), dtype=torch.bool, device=dev)
        for kv in spkeys:
            eq = kv.data[1:] == kv.data[:-1]
            if kv.data2 is not None:
                eq = eq & (kv.data2[1:] == kv.data2[:-1])
            if kv.valid is not None:
                # NULL keys group together: both NULL, or both valid and equal
                v = kv.valid
                eq = torch.where(~v[1:] & ~v[:-1], torch.ones_like(eq), eq & v[1:] & v[:-1])
            same[1:] &= eq
        same[0] = False
        part_start = torch.cummax(torch.where(same, torch.zeros_like(idx), idx), 0).values
    else:
        part_start = torch.zeros((n,), dtype=torch.int64, device=dev)

    # ---- 3. PREV / NEXT shifted columns, within the partition only
    nav_cols: list = []
    for inner, k in node.prev_exprs:
        # nested navigation (PREV(x - PREV(x))): the planner lowers inner
        # calls first, so expression j may read FieldRef(C + i) for i < j
        v = eval_expr(inner, scols + nav_cols, n, dev)
        j = idx - k  # k > 0: PREV, k < 0: NEXT
        jc = j.clamp(0, max(n - 1, 0))
        inb = (j >= 0) & (j < n) & (part_start.index_select(0, jc) == part_start)
        valid = inb if v.valid is None else inb & v.valid.index_select(0, jc)
        nav_cols.append(ColumnVal(v.data.index_select(0, jc), valid, v.dict, v.type))

    # ---- 4. one DEFINE mask per label, to the host in one transfer
    define_input = scols + nav_cols
    masks = torch.stack(
        [eval_predicate(ir, define_input, n, dev) for ir in node.defines]
    ).cpu().numpy()

    # ---- 5. the walk
    matches = find_matches(node.program, masks, part_start.cpu().numpy(), node.after_skip)

    # ---- 6. per output row ("view"): its match number and the rows of
    # the match it sees — the whole match (ONE ROW PER MATCH, FINAL) or the
    # prefix up to its own row (ALL ROWS PER MATCH, RUNNING) — flattened
    # into (view, row, label) arrays so the measures' rows come out of a
    # few numpy passes
    if node.all_rows:
        views = [(mno, assigned, p + 1) for mno, assigned in matches
                 for p in range(len(assigned))]
    else:
        views = [(mno, assigned, len(assigned)) for mno, assigned in matches]
    m_out = len(views)
    out_cap = max(m_out, 1)
    sizes = np.fromiter((u for _, _, u in views), dtype=np.int64, count=m_out)
    ends = np.cumsum(sizes)
    total = int(ends[-1]) if m_out else 0
    seen = [pair for _, assigned, upto in views for pair in assigned[:upto]]
    flat_rows = np.fromiter((r for r, _ in seen), dtype=np.int64, count=total)
    flat_labels = np.fromiter((l for _, l in seen), dtype=np.int64, count=total)
    flat_view = np.repeat(np.arange(m_out), sizes)
    del seen

    def pick(kind: str, lab_ix: int) -> np.ndarray:
        """Per view, the first / last row with label `lab_ix` (any label
        when negative), -1 where there is none."""
        sel = slice(None) if lab_ix < 0 else flat_labels == lab_ix
        v, r = flat_view[sel], flat_rows[sel]
        out = np.full((m_out,), -1, dtype=np.int64)
        if len(v):
            edge = (np.flatnonzero(np.diff(v, prepend=-1)) if kind == "first"
                    else np.flatnonzero(np.diff(v, append=m_out)))
            out[v[edge]] = r[edge]
        return out

    def on_device(values: np.ndarray, fill: int = 0) -> torch.Tensor:
        """Host values of each output row, padded to the output capacity."""
        padded = np.full((out_cap,), fill, dtype=np.int64)
        padded[:m_out] = values
        return torch.from_numpy(padded).to(dev)

    def gather_rows(cv, rows: np.ndarray) -> ColumnVal:
        """cv at the sorted rows `rows` (-1: NULL), padded to out_cap."""
        at = on_device(rows, -1)
        (g,) = _gather_cols([cv], at.clamp(min=0))
        ok = at >= 0
        return ColumnVal(g.data, ok if g.valid is None else g.valid & ok, g.dict, g.type,
                         g.data2)

    label_dict = Dictionary(np.asarray([l.upper() for l in node.labels], dtype=object))
    dead = torch.arange(out_cap, device=dev) >= m_out
    last_of_view = ends - 1
    prim_cols = []
    for (kind, lab_ix, f_ix), tt in zip(node.prims, node.prim_types):
        if kind == "match_number":
            mnos = np.fromiter((mno for mno, _, _ in views), dtype=np.int64, count=m_out)
            prim_cols.append(ColumnVal(on_device(mnos), ~dead, None, tt))
        elif kind == "classifier":
            # the label of the current row (ALL ROWS, RUNNING) or of the
            # match's last row (ONE ROW, FINAL)
            labels = on_device(flat_labels[last_of_view]).to(torch.int32)
            prim_cols.append(ColumnVal(labels, ~dead, label_dict, tt))
        else:
            prim_cols.append(gather_rows(scols[f_ix], pick(kind, lab_ix)))
    measures = [eval_expr(ir, prim_cols, out_cap, dev) for ir in node.measures]

    if node.all_rows:
        at_rows, keep = flat_rows[last_of_view], scols
    else:
        at_rows, keep = flat_rows[ends - sizes], spkeys
    out_cols = [gather_rows(cv, at_rows) for cv in keep] + measures
    return out_cols, ~dead

def _null_lane(t, dev):
    """One NULL lane of type `t` (the measures' inputs when nothing
    matched)."""
    dtype = torch.int32 if t.is_string or t.is_dict_object else _torch_dtype(t)
    return ColumnVal(torch.zeros((1,), dtype=dtype, device=dev),
                     torch.zeros((1,), dtype=torch.bool, device=dev), None, t)
