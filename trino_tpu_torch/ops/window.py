"""Window functions.

The reference's WindowOperator (operator/WindowOperator.java, window/
framework 6.9k LoC) indexes each partition in a PagesIndex and walks frames
row by row.  Here, as in the JAX package, a window is one sort plus
segmented scans over whole columns:

  sort rows by (dead-last, partition keys, order keys)
  -> partition / peer boundary flags
  -> log-step scans that restart at a boundary for running sum / count /
     min / max and ranks
  -> reversed scans give partition / peer END indices for RANGE frames
     (peers), whole-partition values and last_value; gathers fetch frame
     results.

Frames: 'rows' (UNBOUNDED PRECEDING .. CURRENT ROW), 'range' (the same,
peers included — the SQL default), 'whole' (the full partition),
'rows:<lo>:<hi>' and 'range:<lo>:<hi>' (offset edges, 'u' = unbounded).

Dead rows sort last and form partitions of their own (the live flag is a
partition operand), so a live partition's size, end and last row never
reach a dead row.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..data.page import Dictionary
from ..plan.ir import Const
from .expr import ColumnVal
from .relops import SortSpec, _lexsort, _sortable_key, _take, _valid_of

__all__ = ["window_eval"]


def _seg_scan(op: str, x: torch.Tensor, boundary: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented scan (op: add / max / min) that restarts at rows
    where `boundary` is True (boundary[0] must be True).

    A log-step scan: step d combines each row with the row d before it
    unless a boundary lies between, so a float sum is a tree within its
    segment (no running total spans two segments, as a cumsum minus a
    gathered prefix would)."""
    n = x.shape[0]
    val, flag = x, boundary
    d = 1
    while d < n:
        prev, cur = val[:-d], val[d:]
        if op == "add":
            comb = prev + cur
        elif op == "max":
            comb = torch.maximum(prev, cur)
        else:
            comb = torch.minimum(prev, cur)
        cf = flag[d:]
        val = torch.cat([val[:d], torch.where(cf, cur, comb)])
        flag = torch.cat([flag[:d], flag[:-d] | cf])
        d <<= 1
    return val


def _end_indices(is_end: torch.Tensor) -> torch.Tensor:
    """For each row, the index of the next row (inclusive) where is_end."""
    n = is_end.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=is_end.device)
    ends = _seg_scan("max", torch.flip(idx, (0,)), torch.flip(is_end, (0,)))
    return torch.flip(ends, (0,))


def _shift_flags(new: torch.Tensor) -> torch.Tensor:
    """is_end[i] = new[i + 1]; the last row always ends its run."""
    return torch.cat([new[1:], torch.ones((1,), dtype=torch.bool, device=new.device)])


def window_eval(
    cols: Sequence[ColumnVal],
    live: torch.Tensor,
    part_keys: Sequence[ColumnVal],
    order_keys: Sequence[ColumnVal],
    order_specs: Sequence[SortSpec],
    calls,  # Sequence[WindowCall]
    arg_vals: Sequence[tuple[ColumnVal, ...]],
):
    """Returns (cols ++ one ColumnVal per call, live) in window-sorted order."""
    n = live.shape[0]
    dev = live.device

    # ---- sort by (dead-last, partition keys, order keys) -------------------
    operands: list[torch.Tensor] = [(~live).to(torch.int8)]
    for kv in part_keys:
        operands.append((~_valid_of(kv, n)).to(torch.int8))
        operands.append(_sortable_key(kv))
    n_part_ops = len(operands)
    for kv, spec in zip(order_keys, order_specs):
        valid = _valid_of(kv, n)
        null_flag = valid if spec.nulls_first else ~valid
        operands.append(null_flag.to(torch.int8))
        operands.append(_sortable_key(kv, descending=not spec.ascending))
    perm = _lexsort(operands)
    sorted_ops = [op.index_select(0, perm) for op in operands]
    live_s = live.index_select(0, perm)

    def gather(cv: ColumnVal) -> ColumnVal:
        return ColumnVal(
            cv.data.index_select(0, perm),
            None if cv.valid is None else cv.valid.index_select(0, perm),
            cv.dict,
            cv.type,
        )

    out_cols = [gather(cv) for cv in cols]

    # ---- boundaries (the live flag is a partition operand) -----------------
    first = torch.zeros((n,), dtype=torch.bool, device=dev)
    first[:1] = True

    def runs(ops_, start):
        new = start
        for op_arr in ops_:
            prev = torch.cat([op_arr[:1], op_arr[:-1]])
            new = new | (op_arr != prev)
        return new

    new_part = runs(sorted_ops[:n_part_ops], first)
    new_peer = runs(sorted_ops[n_part_ops:], new_part)
    part_end = _end_indices(_shift_flags(new_part))
    peer_end = _end_indices(_shift_flags(new_peer))
    row_number = _seg_scan("add", torch.ones((n,), dtype=torch.int64, device=dev), new_part)
    idx32 = torch.arange(n, dtype=torch.int32, device=dev)
    minus1 = torch.full_like(idx32, -1)
    part_start = _seg_scan("max", torch.where(new_part, idx32, minus1), new_part)

    # first ORDER BY key in sorted (transformed) space — RANGE offset frames
    # resolve their bounds against it
    okey_sorted = None
    if order_keys:
        ok = order_keys[0]
        okey_sorted = (
            _sortable_key(ok, descending=not order_specs[0].ascending).index_select(0, perm),
            _valid_of(ok, n).index_select(0, perm),
            ok.type,
            bool(order_specs[0].nulls_first),
        )

    # ---- evaluate calls ----------------------------------------------------
    for call, argv in zip(calls, arg_vals):
        argv = [gather(a) for a in argv]
        out_cols.append(
            _eval_call(
                call, argv, n, new_part, new_peer, part_end, peer_end,
                row_number, live_s, part_start, okey_sorted,
            )
        )
    return out_cols, live_s


def _bounded_searchsorted(vals, target, lo0, hi0_excl, side, n):
    """Per-row binary search restricted to [lo0, hi0_excl): first index whose
    value >= target ('left') / > target ('right').  34 halving steps cover
    any n; each step is one gather — the partition-local searchsorted RANGE
    frames need (a global searchsorted cannot see partition bounds)."""
    lo = lo0.to(torch.int64)
    hi = hi0_excl.to(torch.int64)
    for _ in range(34):
        active = lo < hi
        mid = (lo + hi) >> 1
        vm = vals.index_select(0, torch.clamp(mid, 0, max(n - 1, 0)))
        pred = (vm < target) if side == "left" else (vm <= target)
        lo = torch.where(active & pred, mid + 1, lo)
        hi = torch.where(active & ~pred, mid, hi)
    return lo


def _literal_arg(call, i: int, argv, default=None) -> int:
    """Literal int parameter (lag/lead offset, ntile buckets, nth_value n),
    read from the Const IR on the call."""
    if len(call.args) <= i:
        return default
    e = call.args[i]
    if isinstance(e, Const) and e.value is not None:
        return int(e.value)
    return int(argv[i].data[0])


def _frame_bounds(frame: str):
    """'rows:<lo>:<hi>' -> (lo, hi) with 'u' or signed int offsets."""
    _, lo, hi = frame.split(":")
    return (lo if lo == "u" else int(lo)), (hi if hi == "u" else int(hi))


def _roll(t: torch.Tensor, shift: int) -> torch.Tensor:
    """jnp.roll(t, shift): element i moves to i + shift (wrapping)."""
    return torch.roll(t, shifts=shift, dims=0)


def _rank(row_number, new_peer, new_part):
    """rank = row_number at the start of the peer group."""
    start_rn = torch.where(new_peer, row_number, torch.zeros_like(row_number))
    return _seg_scan("max", start_rn, new_part)


def _eval_call(
    call, argv, n, new_part, new_peer, part_end, peer_end, row_number, live_s,
    part_start, okey_sorted=None,
):
    fn = call.fn
    dev = live_s.device
    if fn == "row_number":
        return ColumnVal(row_number, None, None, call.type)
    if fn == "rank":
        return ColumnVal(_rank(row_number, new_peer, new_part), None, None, call.type)
    if fn == "dense_rank":
        dr = _seg_scan("add", new_peer.to(torch.int64), new_part)
        return ColumnVal(dr, None, None, call.type)
    if fn in ("lag", "lead"):
        a = argv[0]
        k = _literal_arg(call, 1, argv, default=1)
        shift = -k if fn == "lag" else k
        data = _roll(a.data, -shift)
        valid = _roll(_valid_of(a, n), -shift)
        # the source row must exist in the same partition; a NULL value AT an
        # existing source row stays NULL (the default only covers rows where
        # the offset leaves the partition — reference: LagFunction semantics)
        pid = torch.cumsum(new_part.to(torch.int32), 0)
        src_pid = _roll(pid, -shift)
        idx = torch.arange(n, device=dev)
        exists = (pid == src_pid) & (idx + shift >= 0) & (idx + shift < n)
        ok = valid & exists
        if len(argv) > 2:  # lag(x, k, default)
            dflt = argv[2]
            if a.dict is not None:
                # merge dictionaries so the default's code lands in the same
                # code space as the value column
                union = np.unique(np.concatenate([
                    np.asarray(a.dict.values, dtype=object),
                    np.asarray(dflt.dict.values, dtype=object),
                ]))
                ra = np.searchsorted(union, np.asarray(a.dict.values, dtype=object))
                rd = np.searchsorted(union, np.asarray(dflt.dict.values, dtype=object))
                data = _take(torch.from_numpy(ra.astype(np.int32)).to(dev), data)
                ddata = _take(torch.from_numpy(rd.astype(np.int32)).to(dev), dflt.data)
                data = torch.where(exists, data, ddata)
                ok = torch.where(exists, ok, _valid_of(dflt, n))
                return ColumnVal(data, ok, Dictionary(union), call.type)
            data = torch.where(exists, data, dflt.data.to(data.dtype))
            ok = torch.where(exists, ok, _valid_of(dflt, n))
        return ColumnVal(data, ok, a.dict, call.type)
    if fn == "first_value":
        a = argv[0]
        data = _take(a.data, part_start)
        valid = None if a.valid is None else _take(a.valid, part_start)
        return ColumnVal(data, valid, a.dict, call.type)
    if fn == "nth_value":
        a = argv[0]
        k = _literal_arg(call, 1, argv)
        pos = part_start.to(torch.int64) + (k - 1)
        # the k-th row must be INSIDE the row's frame: for the default RANGE
        # frame that ends at the current peer group, for ROWS at the current
        # row, for 'whole' at the partition end
        if call.frame == "whole":
            frame_end = part_end
        elif call.frame == "rows":
            frame_end = torch.arange(n, dtype=torch.int32, device=dev)
        else:  # range (peers included)
            frame_end = peer_end
        ok = (pos <= frame_end) & (pos <= part_end)
        pos_c = torch.clamp(pos, 0, n - 1)
        data = _take(a.data, pos_c)
        valid = ok if a.valid is None else (ok & _take(a.valid, pos_c))
        return ColumnVal(data, valid, a.dict, call.type)
    if fn == "ntile":
        k = _literal_arg(call, 0, argv)
        size = _take(row_number, part_end)
        tile = torch.div((row_number - 1) * k, torch.clamp(size, min=1), rounding_mode="floor") + 1
        return ColumnVal(tile, None, None, call.type)
    if fn == "percent_rank":
        size = _take(row_number, part_end)
        rank = _rank(row_number, new_peer, new_part)
        denom = torch.clamp(size - 1, min=1).to(torch.float64)
        pr = torch.where(
            size > 1, (rank - 1).to(torch.float64) / denom,
            torch.zeros((n,), dtype=torch.float64, device=dev),
        )
        return ColumnVal(pr, None, None, call.type)
    if fn == "cume_dist":
        size = _take(row_number, part_end)
        peers_through = _take(row_number, peer_end)
        return ColumnVal(
            peers_through.to(torch.float64) / torch.clamp(size, min=1).to(torch.float64),
            None, None, call.type,
        )
    if fn == "last_value":
        a = argv[0]
        end = part_end if call.frame == "whole" else peer_end
        data = _take(a.data, end)
        valid = None if a.valid is None else _take(a.valid, end)
        return ColumnVal(data, valid, a.dict, call.type)

    # aggregates over a frame -----------------------------------------------
    # prefix frames use running scans + peer/partition-end gathers; offset
    # frames use prefix DIFFERENCES for sum/count/avg and shifted-lane or
    # directional scans for min/max (reference: window/FrameInfo + the
    # per-row frame walk in WindowPartition)
    offset_frame = call.frame.startswith(("rows:", "range:"))
    range_bounded_lo = False
    i64 = torch.arange(n, dtype=torch.int64, device=dev)
    if call.frame.startswith("rows:"):
        lo, hi = _frame_bounds(call.frame)
        pe64, ps64 = part_end.to(torch.int64), part_start.to(torch.int64)
        hi_idx = pe64 if hi == "u" else torch.minimum(i64 + hi, pe64)
        lo_idx = ps64 if lo == "u" else torch.maximum(i64 + lo, ps64)
        empty = lo_idx > hi_idx
    elif call.frame.startswith("range:"):
        # RANGE <k> PRECEDING/FOLLOWING: bounds by ORDER BY VALUE distance.
        # In _sortable_key-transformed space (descending already negated),
        # both directions reduce to [v - k_pre, v + k_fol]; rows with a NULL
        # key frame their null peer group (Trino RANGE semantics)
        if okey_sorted is None:
            raise NotImplementedError("RANGE offset frame requires ORDER BY")
        lo, hi = _frame_bounds(call.frame)
        kvals, kvalid, ktype, nulls_first = okey_sorted
        scale = 10 ** getattr(ktype, "scale", 0) if ktype.is_decimal else 1
        # NULL-key rows' lanes hold garbage: substitute the extreme that
        # matches their sort position so the searched array stays sorted AND
        # finite offsets never reach them.  Integer keys stay in int64.
        if not torch.is_floating_point(kvals):
            kv = kvals.to(torch.int64)
            info = torch.iinfo(torch.int64)
            sent_k = info.min if nulls_first else info.max
            step = lambda off: int(off) * scale
        else:
            kv = kvals.to(torch.float64)
            sent_k = -float("inf") if nulls_first else float("inf")
            step = lambda off: float(off) * scale
        kv = torch.where(kvalid, kv, torch.full_like(kv, sent_k))
        idx32 = torch.arange(n, dtype=torch.int32, device=dev)
        peer_start = _seg_scan(
            "max", torch.where(new_peer, idx32, torch.full_like(idx32, -1)), new_peer
        )
        if lo == "u":
            lo_idx = part_start.to(torch.int64)
        else:
            lo_idx = _bounded_searchsorted(
                kv, kv + step(lo), part_start, part_end.to(torch.int64) + 1, "left", n,
            )
            # NULL-key rows frame their null peer group on offset bounds
            lo_idx = torch.where(kvalid, lo_idx, peer_start.to(torch.int64))
        if hi == "u":
            hi_idx = part_end.to(torch.int64)
        else:
            hi_idx = _bounded_searchsorted(
                kv, kv + step(hi), part_start, part_end.to(torch.int64) + 1, "right", n,
            ) - 1
            hi_idx = torch.where(kvalid, hi_idx, peer_end.to(torch.int64))
        range_bounded_lo = lo != "u"
        lo, hi = "u", "u"  # min/max below must route scans, never the roll
        empty = lo_idx > hi_idx

    def frame_sum(contrib):
        running = _seg_scan("add", contrib, new_part)
        s_hi = _take(running, torch.clamp(hi_idx, 0, n - 1))
        s_lo = torch.where(
            lo_idx > part_start,
            _take(running, torch.clamp(lo_idx - 1, 0, n - 1)),
            torch.zeros_like(running),
        )
        return torch.where(empty, torch.zeros_like(running), s_hi - s_lo)

    def framed(contrib):
        if offset_frame:
            return frame_sum(contrib)
        return _frame_value(_seg_scan("add", contrib, new_part), call.frame, part_end, peer_end)

    if fn == "count_star":
        return ColumnVal(framed(live_s.to(torch.int64)), None, None, call.type)

    a = argv[0]
    valid = _valid_of(a, n) & live_s
    if fn == "count":
        return ColumnVal(framed(valid.to(torch.int64)), None, None, call.type)
    if fn in ("sum", "avg"):
        acc_t = (
            torch.float64
            if (fn == "avg" or torch.is_floating_point(a.data))
            else torch.int64
        )
        contrib = torch.where(valid, a.data.to(acc_t), torch.zeros((n,), dtype=acc_t, device=dev))
        s = framed(contrib)
        c = framed(valid.to(torch.int64))
        if fn == "sum":
            return ColumnVal(s, c > 0, None, call.type)
        return ColumnVal(
            s.to(torch.float64) / torch.clamp(c, min=1).to(torch.float64),
            c > 0, None, call.type,
        )
    if fn in ("min", "max"):
        if a.dict is not None:
            raise NotImplementedError("window min/max over varchar")
        if torch.is_floating_point(a.data):
            sent = float("inf") if fn == "min" else -float("inf")
        elif a.data.dtype == torch.bool:
            sent = fn == "min"
        else:
            info = torch.iinfo(a.data.dtype)
            sent = info.max if fn == "min" else info.min
        x = torch.where(valid, a.data, torch.full_like(a.data, sent))
        red = "min" if fn == "min" else "max"
        if offset_frame:
            if range_bounded_lo:
                raise NotImplementedError(
                    "min/max over a RANGE frame with a bounded PRECEDING edge"
                )
            c = frame_sum(valid.to(torch.int64))
            if lo != "u" and hi != "u":
                width = hi - lo + 1
                if width > 128:
                    raise NotImplementedError("ROWS frame wider than 128 for min/max")
                pid = torch.cumsum(new_part.to(torch.int32), 0)
                acc = torch.full_like(x, sent)
                for s_off in range(lo, hi + 1):
                    shifted = _roll(x, -s_off)
                    src_pid = _roll(pid, -s_off)
                    in_rng = (i64 + s_off >= 0) & (i64 + s_off < n) & (src_pid == pid)
                    cand = torch.where(in_rng, shifted, torch.full_like(x, sent))
                    acc = torch.minimum(acc, cand) if fn == "min" else torch.maximum(acc, cand)
                return ColumnVal(acc, c > 0, None, call.type)
            if lo == "u":  # [part_start, i+hi]: forward scan gathered at hi
                r = _seg_scan(red, x, new_part)
                v = _take(r, torch.clamp(hi_idx, 0, n - 1))
                return ColumnVal(v, c > 0, None, call.type)
            # hi == 'u': [i+lo, part_end]: suffix scan gathered at lo
            rsuf = torch.flip(
                _seg_scan(red, torch.flip(x, (0,)), torch.flip(_shift_flags(new_part), (0,))),
                (0,),
            )
            v = _take(rsuf, torch.clamp(lo_idx, 0, n - 1))
            return ColumnVal(v, c > 0, None, call.type)
        r = _seg_scan(red, x, new_part)
        rc = _seg_scan("add", valid.to(torch.int64), new_part)
        v = _frame_value(r, call.frame, part_end, peer_end)
        c = _frame_value(rc, call.frame, part_end, peer_end)
        return ColumnVal(v, c > 0, None, call.type)
    raise NotImplementedError(f"window function {fn}")


def _frame_value(running: torch.Tensor, frame: str, part_end, peer_end):
    if frame == "rows":
        return running
    end = part_end if frame == "whole" else peer_end
    return _take(running, end)
