"""Relational operators: static-capacity, mask-based, whole-column torch ops.

These replace the reference's virtual-call operator chain (operator/*.java)
with whole-page device operators.  Every operator takes and returns columns
plus a `live` mask; dead lanes carry garbage and are never branched on.

- aggregation: without keys (`_global_aggregate`), over small dictionary
  keys (`_direct_code_aggregate`: the segment id IS the fused key code), over
  any word-encodable keys through the hash table (`_hash_aggregate`: kernel
  3 builds, ops/cuda/hashagg.py), and the sort-based exit for the rest (and
  for overflow past the session's limit) — all through `_fused_aggs` and the
  segmented-reduce kernel (ops/cuda/segreduce.py);
- equi-joins of every kind (`equi_join`): the hash path builds over the
  right side (kernel 3) and probes with the left (kernel 4,
  ops/cuda/hashjoin.py); the sort path (combined hash, sort, searchsorted)
  is its exit; both feed one match-expansion tail;
- `top_n` by radix select (kernel 5, ops/cuda/topk.py) or a sort;
- `sort_rows`, `limit_mask`, `compact_rows`, `broadcast_single_row`;
- `unnest_expand`: rows expanded by their arrays' lengths.

Value-sorted aggregates (count DISTINCT, approx_percentile) take the sort
path: the rows sort by the group keys and then by the argument, so first
occurrences and ranks are adjacency facts.  Their per-group counts, the
HyperLogLog register sums of approx_distinct, and the moment sums of the
variance and correlation family ride the same one segmented reduction as
every other aggregate of the node.  array_agg / map_agg / listagg are
collected on the host over the sorted grouping.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..data.types import BIGINT
from .expr import ColumnVal, _codes, array_elements

__all__ = [
    "group_aggregate", "equi_join", "broadcast_single_row", "sort_rows",
    "compact_rows", "top_n", "limit_mask", "unnest_expand", "AggSpec", "SortSpec",
]


@dataclass(frozen=True)
class AggSpec:
    fn: str  # sum | count | count_star | min | max | avg | bool_and |
    #          bool_or | stddev_samp | stddev_pop | var_samp | var_pop |
    #          percentile | approx_distinct | corr | covar_samp | covar_pop |
    #          regr_slope | regr_intercept | array_agg | map_agg | listagg
    distinct: bool = False
    param: Optional[float] = None  # percentile's p
    sep: Optional[str] = None  # listagg separator
    type: Optional[object] = None  # result SqlType (decimal SUMs with
    #          precision > 18 accumulate in two-limb int128 even when the
    #          input column is single-lane; without it int64 wraps silently)


# aggregates computed on the HOST over the sorted grouping
HOST_AGGS = frozenset({"array_agg", "map_agg", "listagg"})

# two-argument moment aggregates (pairwise sums in the fused reduction)
MOMENT_AGGS = frozenset(
    {"corr", "covar_samp", "covar_pop", "regr_slope", "regr_intercept"}
)


@dataclass(frozen=True)
class SortSpec:
    ascending: bool = True
    nulls_first: bool = False


def _valid_of(v: ColumnVal, n: int) -> torch.Tensor:
    if v.valid is None:
        return torch.ones((n,), dtype=torch.bool, device=v.data.device)
    return v.valid


def _take(t: Optional[torch.Tensor], idx: torch.Tensor) -> Optional[torch.Tensor]:
    return None if t is None else t.index_select(0, idx)


def _sortable_operands(v: ColumnVal, descending: bool = False) -> list:
    """Sort operand list for one key: one tensor for single-lane columns,
    TWO for decimal128 (lexicographic (hi signed, lo unsigned) == 128-bit
    numeric order; descending negates at 128-bit width first).  The unsigned
    low limb is sign-bit-flipped so a signed sort orders it correctly."""
    if v.data2 is not None:
        from ..data.dec128 import neg128

        lo = v.data.to(torch.int64)
        hi = v.data2.to(torch.int64)
        if descending:
            lo, hi = neg128(lo, hi)
        return [hi, lo ^ -(2**63)]
    return [_sortable_key(v, descending)]


def _sortable_key(v: ColumnVal, descending: bool = False) -> torch.Tensor:
    """Lower a column to a sortable numeric tensor (varchar -> dictionary
    rank, bool -> int8); negated for descending order."""
    if v.data2 is not None:
        raise NotImplementedError(
            "decimal128 lanes in this operation (two-limb keys)"
        )
    data = v.data
    if v.dict is not None:
        rank = torch.from_numpy(v.dict.sorted_rank()).to(data.device)
        data = rank.index_select(0, v.data.to(torch.int64))
    if data.dtype == torch.bool:
        data = data.to(torch.int8)
    if descending:
        data = -data
    return data


def _lexsort(operands: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable lexicographic sort permutation, first operand most
    significant: stable argsorts from the last key to the first."""
    n = operands[0].shape[0]
    perm = torch.arange(n, dtype=torch.int64, device=operands[0].device)
    for key in reversed(operands):
        order = torch.argsort(key.index_select(0, perm), stable=True)
        perm = perm.index_select(0, order)
    return perm


_M32 = 0xFFFFFFFF


def searchsorted_tpu(a: torch.Tensor, v: torch.Tensor, side: str = "left") -> torch.Tensor:
    """Sorted-array lookup (the reference's searchsorted_tpu).  The TPU
    needed a choice of method — its binary search lowers to log2(n)
    sequential gather rounds — while the card's torch.searchsorted runs one
    thread per query, so no choice is left; the queries take the array's
    dtype."""
    return torch.searchsorted(a, v.to(a.dtype), side=side)


# ----------------------------------------------- hash-kernel key encoding
#
# The hash kernels (ops/cuda/hashagg.py, hashjoin.py) compare keys as fixed
# lists of int32 words.  Equality over the words must coincide with the sort
# path's grouping / the join's verified match semantics:
#
#   group-by: the sort path's run boundary fires on (~valid, raw operand)
#     per key, so NULL rows group by validity AND payload — encoding the raw
#     words plus one packed validity word reproduces that exactly.  DOUBLE
#     keys are rejected: the sort path gives every NaN row its own group
#     (raw-compare diff), which no bitwise word equality can express.
#   join: matches are re-verified exactly downstream, so extra candidates
#     are harmless but MISSED ones are not — -0.0 is canonicalized to +0.0
#     (they compare equal), NULL keys are simply excluded from the build
#     and probe live sets (they never match).
#
# Dictionary-coded columns encode their CODES (the sort path's sorted_rank
# is a bijection of codes, and the join verifies by code equality), other
# integers sign-extend to two words, decimal128 to four.  The words equal
# the reference's bit for bit for the same lane types; the port keeps 64-bit
# lanes where the reference narrows them to int32 at upload, so a BIGINT
# key is two words here (ROADMAP queue C, lane widths).


def _words64(bits: torch.Tensor) -> list:
    """int64 lanes -> [low word, high word] as int32 (two's-complement
    truncation keeps the bits)."""
    bits = bits.to(torch.int64)
    return [bits.to(torch.int32), (bits >> 32).to(torch.int32)]


def _combine64(lo32: torch.Tensor, hi32: torch.Tensor) -> torch.Tensor:
    return (lo32.to(torch.int64) & _M32) | (hi32.to(torch.int64) << 32)


def _hash_key_words(keys: Sequence[ColumnVal], n: int, for_join: bool):
    """Encode key columns as int32 word lists for the hash kernels, or
    (None, None) when a column's equality semantics cannot be carried by
    words (see above).  Returns (words, layout) where layout[k] is the
    per-key word kind: 'dict' | 'i32' | 'i64' | 'f64' | 'dec128'."""
    words: list = []
    layout: list[str] = []
    for kv in keys:
        if kv.dict is not None:
            words.append(kv.data.to(torch.int32))
            layout.append("dict")
        elif kv.data2 is not None:
            words.extend(_words64(kv.data))
            words.extend(_words64(kv.data2))
            layout.append("dec128")
        elif kv.data.dtype.is_floating_point:
            if not for_join:
                return None, None  # per-NaN-row groups are not word-equatable
            d = kv.data.to(torch.float64)
            d = torch.where(d == 0.0, torch.zeros_like(d), d)  # -0.0 matches +0.0
            words.extend(_words64(d.view(torch.int64)))
            layout.append("f64")
        elif kv.data.element_size() > 4:
            words.extend(_words64(kv.data))
            layout.append("i64")
        else:  # bool and the narrower integers
            words.append(kv.data.to(torch.int32))
            layout.append("i32")
    return [w.contiguous() for w in words], layout


def _value_sorted(specs) -> bool:
    return any(
        s.distinct or s.fn in ("percentile", "approx_distinct") or s.fn in HOST_AGGS
        for s in specs
    )


def _hash_aggregate(key_vals, agg_args, specs, live, G, agg_args2):
    """Hash-table grouped aggregation: one build pass assigns every row a
    dense group id (kernel 3, ops/cuda/hashagg.py), the fused segment
    reductions run over those ids unsorted, and the output key columns come
    from the words the build wrote per group id — no sort anywhere.
    Returns the group_aggregate result tuple, or None when the static gate
    picks the sort path.

    Overflow (more distinct groups than the capacity tier, or a walk past
    its budget) reports an inflated n_groups through the normal required
    channel: the executor retries at a doubled tier, and once the tier
    exceeds hash_agg_max_groups this gate flips to the sort path — the
    deterministic overflow-to-sort exit.  Group ids come in claim order,
    which on the card changes from run to run: nothing downstream depends
    on group order."""
    from .cuda import hashagg
    from .kernels import get_policy, impl_for, record_dispatch

    if _value_sorted(specs):
        record_dispatch("group_by", "sort", "value-sorted aggregate")
        return None
    policy = get_policy()
    if not policy.enabled:
        record_dispatch("group_by", "sort", "kernels disabled")
        return None
    n = live.shape[0]
    if G > policy.hash_agg_max_groups:
        record_dispatch("group_by", "fallback", f"cap {G} > hash_agg_limit")
        return None
    enc, layout = _hash_key_words(key_vals, n, for_join=False)
    if enc is None:
        record_dispatch("group_by", "sort", "keys not word-encodable")
        return None
    dev = live.device
    validity = torch.zeros((n,), dtype=torch.int32, device=dev)
    for k, kv in enumerate(key_vals):
        validity = validity | (_valid_of(kv, n).to(torch.int32) << k)
    words = enc + [validity]
    if not hashagg.shape_supported(n, len(words), G):
        record_dispatch("group_by", "sort", "shape unsupported")
        return None
    record_dispatch(
        "group_by", impl_for(dev),
        f"{len(words)}w cap {G} table {hashagg.table_size(G)}",
    )

    gid, table, n_true, overflow = hashagg.build_hash_table(words, live, G)
    seg = torch.where(
        live & (gid >= 0) & (gid < G), gid, torch.full_like(gid, G)
    ).to(torch.int32)
    out_aggs = _fused_aggs(agg_args, specs, seg, live, G, n, agg_args2=agg_args2)

    gk = table.group_keys  # [W, G]: the words of group g at column g
    vword = gk[len(enc)]
    out_keys = []
    wpos = 0
    for k, (kv, kind) in enumerate(zip(key_vals, layout)):
        valid = ((vword >> k) & 1) != 0
        if kind in ("dict", "i32"):
            out_keys.append((gk[wpos].to(kv.data.dtype), valid, None))
            wpos += 1
        elif kind == "i64":
            data = _combine64(gk[wpos], gk[wpos + 1]).to(kv.data.dtype)
            out_keys.append((data, valid, None))
            wpos += 2
        else:  # dec128
            lo = _combine64(gk[wpos], gk[wpos + 1])
            hi = _combine64(gk[wpos + 2], gk[wpos + 3])
            out_keys.append((lo, valid, hi))
            wpos += 4

    n_true = n_true.to(torch.int64)
    out_live = torch.arange(G, dtype=torch.int64, device=dev) < torch.clamp(n_true, max=G)
    n_report = torch.where(overflow, torch.clamp(n_true, min=G + 1), n_true)
    return out_keys, out_aggs, out_live, n_report


# ------------------------------------------------------------ aggregation


def group_aggregate(
    key_vals: Sequence[ColumnVal],
    agg_args: Sequence[Optional[ColumnVal]],
    specs: Sequence[AggSpec],
    live: torch.Tensor,
    num_groups_cap: int,
    agg_args2: Optional[Sequence[Optional[ColumnVal]]] = None,
    agg_order: Optional[Sequence[tuple]] = None,
):
    """Grouped aggregation.

    Returns (out_keys: list[(data, valid, data2-or-None)], out_aggs:
    list[(data, valid)], the decimal128 4-tuple (lo, valid, None, hi) or,
    for a host-collected aggregate, (codes, valid, Dictionary)], out_live,
    n_groups) where outputs have capacity `num_groups_cap` and
    n_groups is the true group count (> cap == overflow, the executor
    retries).  Paths, first that applies: no keys; small dictionary keys;
    the hash table; the sort.
    """
    n = live.shape[0]
    G = num_groups_cap
    if agg_args2 is None:
        agg_args2 = [None] * len(specs)
    if agg_order is None:
        agg_order = [()] * len(specs)

    if not key_vals:
        return _global_aggregate(agg_args, specs, live, agg_args2, agg_order)

    fast = _direct_code_aggregate(key_vals, agg_args, specs, live, agg_args2)
    if fast is not None:
        return fast

    hashed = _hash_aggregate(key_vals, agg_args, specs, live, G, agg_args2)
    if hashed is not None:
        return hashed

    # ---- sort rows by (dead-last, keys..., [the first value-sorted agg's
    # argument]); a run boundary of the keys opens a group
    dev = live.device
    grouping = _SortedGrouping(key_vals, live, G, _first_value_sorted_arg(agg_args, specs))
    perm, live_s, seg_s, _new_group, n_groups = grouping.main()

    # ---- output keys: the first row of each group (seg_s is nondecreasing)
    gids = torch.arange(G, dtype=torch.int64, device=dev)
    starts = searchsorted_tpu(seg_s, gids, side="left")
    first_row = perm.index_select(0, starts.clamp(0, max(n - 1, 0)))
    out_keys: list[tuple] = []
    for kv in key_vals:
        out_keys.append((
            kv.data.index_select(0, first_row),
            _valid_of(kv, n).index_select(0, first_row),
            None if kv.data2 is None else kv.data2.index_select(0, first_row),
        ))

    # ---- aggregates: the segment reduce takes rows in any order, so the
    # group ids go back to the rows' own positions instead of gathering
    # every argument into sorted order
    seg = torch.empty_like(seg_s).scatter_(0, perm, seg_s).to(torch.int32)
    out_aggs = _fused_aggs(
        agg_args, specs, seg, live, G, n, agg_args2=agg_args2,
        grouping=grouping, agg_order=agg_order,
    )
    out_live = gids < torch.clamp(n_groups, max=G)
    return out_keys, out_aggs, out_live, n_groups


def _first_value_sorted_arg(agg_args, specs) -> Optional[ColumnVal]:
    """The argument the main grouping sort carries: the first DISTINCT or
    percentile aggregate's (None when there is none)."""
    for arg, spec in zip(agg_args, specs):
        if (spec.distinct or spec.fn == "percentile") and arg is not None:
            return arg
    return None


class _SortedGrouping:
    """The sort-based grouping of one aggregation: rows ordered by (dead
    last, then per key its validity and value), optionally followed by the
    (validity, value) of one value-sorted argument.  The validity of that
    argument sorts BEFORE its value, so a NULL lane whose payload equals a
    live value can never be a group's first occurrence of it.  Group order
    is fixed by the keys alone, so every sort of one grouping numbers its
    groups alike and segment ids line up across sorts.  The main sort
    carries `main_extra`; each further value-sorted argument gets its own."""

    def __init__(self, key_vals, live: torch.Tensor, G: int, main_extra=None):
        self.live = live
        self.G = G
        self.n = live.shape[0]
        self.main_extra = main_extra
        self.key_ops: list[torch.Tensor] = []
        for kv in key_vals:
            self.key_ops.append((~_valid_of(kv, self.n)).to(torch.int8))  # nulls last
            self.key_ops.extend(_sortable_operands(kv))  # 2 operands for decimal128
        self._memo: dict = {}

    def main(self):
        return self.sort(self.main_extra)

    def sort(self, extra: Optional[ColumnVal]):
        """-> (perm, live_s, seg_s, new_group, n_groups): seg_s is the
        sorted rows' group id (G for dead rows), nondecreasing."""
        hit = self._memo.get(id(extra))
        if hit is not None:
            return hit[1]
        n, G, dev = self.n, self.G, self.live.device
        operands = [(~self.live).to(torch.int8)] + self.key_ops
        if extra is not None:
            operands = operands + [(~_valid_of(extra, n)).to(torch.int8)]
            operands.extend(_sortable_operands(extra))
        perm = _lexsort(operands)
        live_s = self.live.index_select(0, perm)
        diff = torch.zeros((n,), dtype=torch.bool, device=dev)
        for op in self.key_ops:
            op_s = op.index_select(0, perm)
            diff = diff | (op_s != torch.cat([op_s[:1], op_s[:-1]]))
        first = torch.zeros((n,), dtype=torch.bool, device=dev)
        first[:1] = True
        new_group = live_s & (first | diff)
        seg_s = torch.cumsum(new_group.to(torch.int64), 0) - 1
        seg_s = torch.where(live_s, seg_s, torch.full_like(seg_s, G)).clamp(max=G)
        n_groups = new_group.sum(dtype=torch.int64)
        out = (perm, live_s, seg_s, new_group, n_groups)
        self._memo[id(extra)] = (extra, out)  # holding extra keeps its id unique
        return out


_DIRECT_DOMAIN_LIMIT = 4096


def _direct_code_aggregate(key_vals, agg_args, specs, live, agg_args2=None):
    """Fast path: every group key is a dictionary-coded column with no nulls
    and the key-domain product is small -> segment id IS the fused code; no
    sort, no hash table, just segment reductions (TPC-H Q1: returnflag x
    linestatus = 6 groups).  Group-by becomes a bandwidth-bound reduction."""
    if agg_args2 is None:
        agg_args2 = [None] * len(specs)
    if _value_sorted(specs):
        return None
    domains = []
    for kv in key_vals:
        if kv.dict is None or kv.valid is not None:
            return None
        domains.append(len(kv.dict))
    total = 1
    for d in domains:
        total *= max(d, 1)
    if not (0 < total <= _DIRECT_DOMAIN_LIMIT):
        return None
    domains = [max(d, 1) for d in domains]  # empty dicts (all-dead pages)
    n = live.shape[0]
    G = total
    dev = live.device
    seg = torch.zeros((n,), dtype=torch.int32, device=dev)
    for kv, d in zip(key_vals, domains):
        seg = seg * d + torch.clamp(kv.data.to(torch.int32), 0, d - 1)
    seg = torch.where(live, seg, torch.full_like(seg, G))  # dead lanes: seg >= G

    # decode segment index -> key codes (host-side iota tables; no device
    # sync), first key most significant
    out_keys = []
    rem = np.arange(G, dtype=np.int64)
    codes_per_key = []
    for d in reversed(domains):
        codes_per_key.append(rem % d)
        rem = rem // d
    codes_per_key.reverse()
    for codes in codes_per_key:
        out_keys.append((torch.from_numpy(codes.astype(np.int32)).to(dev), None, None))

    out_aggs, cnt_any = _fused_aggs(
        agg_args, specs, seg, live, G, n, agg_args2=agg_args2, want_rows=True
    )
    out_live = cnt_any > 0
    n_groups = out_live.sum(dtype=torch.int32)
    return out_keys, out_aggs, out_live, n_groups


def _fused_aggs(
    agg_args, specs, seg, live_s, G, n, agg_args2=None, want_rows=False,
    grouping=None, agg_order=None,
):
    """Every aggregate of a GROUP BY in one fused segmented reduction
    (ops/cuda/segreduce.py): one pass over the rows computes every
    SUM/COUNT/AVG/MIN/MAX, the {0,1} min/max of bool_and/bool_or, the sums
    of x and x² of the variance family, the five pairwise sums of the
    moment aggregates, the first-occurrence counts of count(DISTINCT), the
    valid counts of approx_percentile and the register sums of
    approx_distinct.  This replaces the reference's per-function Accumulator
    loop (operator/aggregation/) with one bandwidth-bound kernel.  `seg`
    holds each row's group id at the row's own position.

    `grouping` (a _SortedGrouping) is required by the value-sorted and
    host-collected aggregates, which only the sort path serves.  Returns a
    list aligned with specs.  With `want_rows` it returns (list, live rows
    per segment): the per-group row count rides the same pass instead of
    costing a second one.
    """
    from . import kernels as _kernels
    from .cuda.segreduce import SegRed, fused_segment_reduce

    reds: list = []
    count_memo: dict = {}

    def add(red) -> int:
        reds.append(red)
        return len(reds) - 1

    def add_count(valid) -> int:
        key = id(valid)
        if key not in count_memo:
            count_memo[key] = add(SegRed("count", None, valid))
        return count_memo[key]

    def in_rows(perm, sorted_vals):
        """Values of the sorted rows back at the rows' own positions."""
        return torch.empty_like(sorted_vals).scatter_(0, perm, sorted_vals)

    if agg_args2 is None:
        agg_args2 = [None] * len(specs)
    if agg_order is None:
        agg_order = [()] * len(specs)
    rows_ix = add_count(live_s) if want_rows else None
    recipe: list = []
    for arg, arg2, spec, order in zip(agg_args, agg_args2, specs, agg_order):
        if any(v is not None and v.data2 is not None for v in (arg, arg2)) and not (
            spec.fn in ("sum", "count", "min", "max") and not spec.distinct
        ):
            raise NotImplementedError(
                f"aggregate {spec.fn} over decimal128 lanes (sum/count/min/max only)"
            )
        if _value_sorted([spec]) and grouping is None:
            raise ValueError(f"aggregate {spec.fn} needs the sort-based grouping")
        if spec.fn in HOST_AGGS:
            recipe.append(("host", spec, arg, arg2, order))
            continue
        if spec.fn == "approx_distinct":
            recipe.append(("hll",) + _hll_reds(arg, seg, live_s, G, n, add))
            continue
        if spec.distinct or spec.fn == "percentile":
            perm, ls, seg_s, new_group, _ = grouping.sort(arg)
            data_s = arg.data.index_select(0, perm)
            valid_s = _valid_of(arg, n).index_select(0, perm) & ls
            if spec.fn == "percentile":
                recipe.append(
                    ("percentile", spec.param, data_s, seg_s,
                     add_count(_valid_of(arg, n) & live_s))
                )
                continue
            if spec.fn not in ("count", "sum", "avg"):
                raise NotImplementedError(f"DISTINCT {spec.fn}")
            # a value's first occurrence in its group, found by adjacency;
            # count(DISTINCT) counts those rows, sum / avg(DISTINCT) reduce
            # over them as the plain forms below reduce over valid rows
            prev = torch.cat([data_s[:1], data_s[:-1]])
            first = (new_group | (data_s != prev)) & valid_s
            distinct_rows = in_rows(perm, first)
            if spec.fn == "count":
                recipe.append(("count", add(SegRed("count", None, distinct_rows))))
                continue
        else:
            distinct_rows = None
        if spec.fn in MOMENT_AGGS:
            # pairwise moments over the rows where BOTH arguments are
            # non-NULL (reference: CorrelationAggregation and friends)
            pv = _valid_of(arg, n) & _valid_of(arg2, n) & live_s
            y = arg.data.to(torch.float64)
            x = arg2.data.to(torch.float64)
            recipe.append((
                "moment", spec.fn,
                add(SegRed("sum", y, pv)), add(SegRed("sum", x, pv)),
                add(SegRed("sum", x * y, pv)), add(SegRed("sum", x * x, pv)),
                add(SegRed("sum", y * y, pv)), add_count(pv),
            ))
            continue
        if spec.fn == "count_star":
            recipe.append(("count", add_count(live_s)))
            continue
        data = arg.data
        # a no-NULL argument shares the live mask itself, so its count and
        # validity reads are deduplicated across the aggregates of the pass
        if distinct_rows is not None:
            valid = distinct_rows
        else:
            valid = live_s if arg.valid is None else arg.valid & live_s
        res_t = spec.type
        is_int = not data.dtype.is_floating_point
        wide_sum = (
            spec.fn == "sum"
            and res_t is not None
            and getattr(res_t, "is_decimal", False)
            and res_t.precision > 18
            and is_int
        )
        if spec.fn == "count":
            recipe.append(("count", add_count(valid)))
        elif spec.fn == "sum" and (arg.data2 is not None or wide_sum):
            # decimal128 sum: four 32-bit limb sums (each exact in int64 for
            # n < 2^31 rows) recombined into two-limb outputs (the analogue
            # of Int128Math.addWithOverflow accumulation).  Also taken when
            # the RESULT precision > 18 over a single-lane input: the int64
            # inputs fit, but their sum can overflow int64.
            from ..data.dec128 import limbs32

            lo64 = data.to(torch.int64)
            hi = arg.data2 if arg.data2 is not None else lo64 >> 63
            l0, l1, l2, l3 = limbs32(lo64, hi)
            recipe.append(
                ("sum128", add(SegRed("sum", l0, valid)),
                 add(SegRed("sum", l1, valid)), add(SegRed("sum", l2, valid)),
                 add(SegRed("sum", l3, valid)), add_count(valid))
            )
        elif arg.data2 is not None:
            # decimal128 min/max: lexicographic two-pass — the fused pass
            # reduces the SIGNED hi limb; a follow-up segmented pass picks
            # the best UNSIGNED lo limb among rows whose hi limb equals the
            # group winner (Int128 compare order = (hi, unsigned lo)).  The
            # lo limb is XOR-biased so unsigned order matches signed order.
            hi = arg.data2.to(torch.int64)
            lo_b = data.to(torch.int64) ^ -(2**63)
            recipe.append(
                ("minmax128", spec.fn, add(SegRed(spec.fn, hi, valid)),
                 add_count(valid), lo_b, valid, hi)
            )
        elif spec.fn in ("sum", "avg"):
            as_int = spec.fn == "sum" and is_int
            vals = data if as_int else data.to(torch.float64)
            recipe.append((spec.fn, add(SegRed("sum", vals, valid)), add_count(valid)))
        elif spec.fn in ("min", "max"):
            if arg.dict is not None:
                rank = torch.from_numpy(arg.dict.sorted_rank()).to(data.device)
                rdata = rank.index_select(0, arg.data.to(torch.int64))
                recipe.append(
                    ("dictmm", spec.fn, arg, add(SegRed(spec.fn, rdata, valid)),
                     add_count(valid))
                )
            else:
                recipe.append(("minmax", add(SegRed(spec.fn, data, valid)), add_count(valid)))
        elif spec.fn in ("bool_and", "bool_or"):
            # AND == min over {0,1}, OR == max (reference: aggregation/
            # BooleanAndAggregation / BooleanOrAggregation)
            red = "min" if spec.fn == "bool_and" else "max"
            recipe.append(("bool", add(SegRed(red, data.to(torch.int32), valid)), add_count(valid)))
        elif spec.fn in ("stddev_samp", "stddev_pop", "var_samp", "var_pop"):
            x = data.to(torch.float64)
            recipe.append((
                "var", spec.fn, add(SegRed("sum", x, valid)),
                add(SegRed("sum", x * x, valid)), add_count(valid),
            ))
        else:
            raise NotImplementedError(f"aggregate {spec.fn} (the reference has none either)")

    def reduce(rs):
        _kernels.record_dispatch(
            "segment_reduce", _kernels.impl_for(seg.device),
            f"{len(rs)} reductions {G} groups",
        )
        return fused_segment_reduce(seg, rs, G)

    results = reduce(reds) if reds else []

    out: list = []
    for r in recipe:
        kind = r[0]
        if kind == "count":
            out.append((results[r[1]], None))
        elif kind == "sum128":
            from ..data.dec128 import recombine32

            s0, s1, s2, s3, cnt = (results[r[i]] for i in range(1, 6))
            lo, hi = recombine32(s0, s1, s2, s3)
            out.append((lo, cnt > 0, None, hi))
        elif kind in ("sum", "avg"):
            s, cnt = results[r[1]], results[r[2]]
            nonempty = cnt > 0
            if kind == "sum":
                out.append((s, nonempty))
            else:
                ones = torch.ones_like(cnt)
                out.append((s / torch.where(nonempty, cnt, ones).to(torch.float64), nonempty))
        elif kind == "minmax":
            s, cnt = results[r[1]], results[r[2]]
            out.append((s, cnt > 0))
        elif kind == "minmax128":
            _, fn, hi_i, ci, lo_b, valid_m, hi_rows = r
            hi_g, cnt = results[hi_i], results[ci]
            # second pass: best biased lo limb restricted to the rows whose
            # hi limb equals their group's winning hi limb (dead lanes gather
            # a padding slot and are masked by valid_m)
            hi_pad = torch.cat([hi_g, hi_g.new_zeros((1,))])
            at_best = valid_m & (
                hi_rows == hi_pad.index_select(0, seg.to(torch.int64).clamp(0, G))
            )
            lo_best = reduce([SegRed(fn, lo_b, at_best)])[0]
            out.append((lo_best ^ -(2**63), cnt > 0, None, hi_g))
        elif kind == "dictmm":  # map best rank back to a dictionary code
            _, fn, arg, si, ci = r
            best_rank, cnt = results[si], results[ci]
            inv = np.argsort(arg.dict.sorted_rank()).astype(np.int32)
            code = torch.from_numpy(inv).to(seg.device).index_select(
                0, best_rank.to(torch.int64).clamp(0, len(inv) - 1)
            )
            out.append((code, cnt > 0))
        elif kind == "bool":
            s, cnt = results[r[1]], results[r[2]]
            out.append((s > 0, cnt > 0))
        elif kind == "var":
            _, fn, si, qi, ci = r
            out.append(_variance(fn, results[si], results[qi], results[ci]))
        elif kind == "moment":
            _, fn, *ix = r
            out.append(_moment(fn, *(results[i] for i in ix)))
        elif kind == "percentile":
            _, p, data_s, seg_s, ci = r
            out.append(_segment_percentile(p, data_s, seg_s, results[ci], G))
        elif kind == "hll":
            _, hi_i, lo_i, e_i = r
            out.append((_hll_estimate(results[hi_i], results[lo_i], results[e_i]), None))
        else:  # host: collected over the main sort's grouping
            _, spec, arg, arg2, order = r
            perm, ls, seg_s, _, _ = grouping.main()
            out.append(_host_collect_agg(spec, arg, arg2, perm, seg_s, ls, G, n, order))
    if want_rows:
        return out, results[rows_ix]
    return out


def _variance(fn: str, s, ss, cnt):
    """var / stddev from the sums of x and x² (reference: VarianceAggregation
    semantics): the population variance floored at 0 against cancellation
    on near-constant data; the sample forms are NULL for n <= 1."""
    cf = cnt.to(torch.float64)
    safe_n = torch.where(cnt > 0, cf, torch.ones_like(cf))
    mean = s / safe_n
    var_pop = torch.clamp(ss / safe_n - mean * mean, min=0.0)
    if fn.endswith("_pop"):
        var, ok = var_pop, cnt > 0
    else:
        var = var_pop * safe_n / torch.where(cnt > 1, cf - 1.0, torch.ones_like(cf))
        ok = cnt > 1
    if fn.startswith("stddev"):
        var = torch.sqrt(var)
    return var, ok


def _moment(fn: str, sy, sx, sxy, sxx, syy, cnt):
    """corr / covar / regr from the five pairwise sums, as the reference
    assembles them (n·var floored at 0; NULL for n <= 1 or zero variance)."""
    nf = torch.where(cnt > 0, cnt, torch.ones_like(cnt)).to(torch.float64)
    one = torch.ones_like(nf)
    cov_n = sxy - sx * sy / nf  # n * cov
    varx_n = torch.clamp(sxx - sx * sx / nf, min=0.0)  # n * var(x)
    vary_n = torch.clamp(syy - sy * sy / nf, min=0.0)
    if fn == "covar_pop":
        return cov_n / nf, cnt > 0
    if fn == "covar_samp":
        return cov_n / torch.where(cnt > 1, nf - 1.0, one), cnt > 1
    if fn == "corr":
        denom = torch.sqrt(varx_n * vary_n)
        ok = (cnt > 1) & (denom > 0)
        return cov_n / torch.where(ok, denom, one), ok
    ok = (cnt > 1) & (varx_n > 0)
    slope = cov_n / torch.where(ok, varx_n, one)
    if fn == "regr_slope":
        return slope, ok
    return (sy - slope * sx) / nf, ok  # regr_intercept = mean(y) - slope * mean(x)


def _segment_percentile(p: float, data_s, seg_s, vcnt, G: int):
    """approx_percentile as exact nearest-rank selection on the grouped sort:
    each group's valid values are a contiguous ascending run at its start
    (validity sorts before value), so the answer is a gather at the group's
    start plus round(p·(count − 1)).  The reference is exact here too."""
    n = data_s.shape[0]
    gids = torch.arange(G, dtype=seg_s.dtype, device=seg_s.device)
    starts = searchsorted_tpu(seg_s, gids, side="left")
    off = torch.floor(p * torch.clamp(vcnt - 1, min=0).to(torch.float64) + 0.5)
    idx = torch.clamp(starts + off.to(torch.int64), 0, max(n - 1, 0))
    return data_s.index_select(0, idx), vcnt > 0


# ------------------------------------------------ approx_distinct (HLL)

_HLL_P = 12  # m = 4096 registers: ~1.04/sqrt(m) = 1.6% standard error


def _hll_alpha(m: int) -> float:
    if m >= 128:
        return 0.7213 / (1.0 + 1.079 / m)
    return {16: 0.673, 32: 0.697, 64: 0.709}.get(m, 0.7)


def _hash64(data: torch.Tensor) -> torch.Tensor:
    """splitmix64 of the value bits, masked to 63 bits (int64, sign clear).
    Floats hash their full f64 bit pattern."""
    if data.dtype.is_floating_point:
        data = data.to(torch.float64).view(torch.int64)
    return _mix64(data.to(torch.int64)) & 0x7FFF_FFFF_FFFF_FFFF


def _bitlen64(v: torch.Tensor) -> torch.Tensor:
    """Bit length of non-negative int64 lanes by six halving steps — exact
    over the whole 63-bit range, where a float log2 is not."""
    v = v.to(torch.int64)
    bl = torch.zeros(v.shape, dtype=torch.int32, device=v.device)
    for s in (32, 16, 8, 4, 2, 1):
        big = (v >> s) > 0
        bl = bl + big.to(torch.int32) * s
        v = torch.where(big, v >> s, v)
    return bl + (v > 0).to(torch.int32)


def _hll_reds(arg: ColumnVal, seg, live, G: int, n: int, add):
    """The reductions of a grouped HyperLogLog (the reference's
    `_segment_hll`, same hash, buckets and registers).  One sort by
    (group, bucket, rho) puts each register's maximum rho at its run end;
    a run end contributes 2^-rho and one non-empty register to its group.
    2^-rho = 2^(bitlen − 52) is summed exactly as the integer 2^bitlen,
    split into two int64 parts so no sum can wrap, and both sums ride the
    fused pass at the rows' own positions.  Returns the three indices of
    (high part, low part, non-empty registers)."""
    from .cuda.segreduce import SegRed

    m = 1 << _HLL_P
    rest_bits = 63 - _HLL_P
    valid = _valid_of(arg, n) & live
    h = _hash64(arg.data)
    bucket = h >> rest_bits
    bitlen = _bitlen64(h & ((1 << rest_bits) - 1))
    rho = rest_bits + 1 - bitlen.to(torch.int64)  # [1, 52]
    dead = G * m
    combined = torch.where(valid, seg.to(torch.int64) * m + bucket, torch.full_like(bucket, dead))
    key_s, hperm = torch.sort(combined * 64 + rho)
    c_s = key_s >> 6
    is_end = torch.cat([c_s[1:] != c_s[:-1], torch.ones((1,), dtype=torch.bool, device=c_s.device)])
    live_end = is_end & (c_s < dead)
    power = torch.ones_like(c_s) << (52 - (key_s & 63))  # 2^bitlen of the run end
    end_rows = torch.empty_like(live_end).scatter_(0, hperm, live_end)
    power_rows = torch.empty_like(power).scatter_(0, hperm, power)
    return (
        add(SegRed("sum", power_rows >> 11, end_rows)),
        add(SegRed("sum", power_rows & 2047, end_rows)),
        add(SegRed("count", None, end_rows)),
    )


def _hll_estimate(hi_sum, lo_sum, e_cnt) -> torch.Tensor:
    """HyperLogLog estimate per group from its register sums, with the
    small-range (linear counting) correction; 0 for a group without
    values."""
    m = 1 << _HLL_P
    z_part = hi_sum.to(torch.float64) * 2.0**-41 + lo_sum.to(torch.float64) * 2.0**-52
    e = e_cnt.to(torch.float64)
    z = (m - e) + z_part  # an empty register contributes 2^0
    estimate = _hll_alpha(m) * m * m / torch.clamp(z, min=1e-12)
    v_empty = m - e
    small = m * torch.log(m / torch.clamp(v_empty, min=1.0))
    estimate = torch.where((estimate < 2.5 * m) & (v_empty > 0), small, estimate)
    counts = torch.round(estimate).to(torch.int64)
    return torch.where(e_cnt > 0, counts, torch.zeros_like(counts))


# ------------------------------------------- host-collected aggregates


def _host_sort_rank(data: np.ndarray, valid, dictionary, ascending: bool, nulls_first: bool):
    """(null_rank, value_rank) int arrays for np.lexsort, encoding NULL
    placement and direction (string keys rank through their values)."""
    n = len(data)
    if dictionary is not None:
        decoded = dictionary.values[np.clip(data, 0, max(len(dictionary) - 1, 0))]
        _, rank = np.unique(decoded, return_inverse=True)
    else:
        try:
            _, rank = np.unique(data, return_inverse=True)
        except TypeError:  # mixed-type object lanes: rank by repr
            _, rank = np.unique(
                np.asarray([repr(v) for v in data], dtype=object), return_inverse=True
            )
    rank = rank.reshape(-1).astype(np.int64)
    if not ascending:
        rank = -rank
    if valid is None:
        null_rank = np.zeros(n, dtype=np.int8)
    else:
        is_null = ~np.asarray(valid)
        null_rank = np.where(is_null, -1 if nulls_first else 1, 0).astype(np.int8)
        rank = np.where(is_null, 0, rank)
    return null_rank, rank


def _py(v):
    return v.item() if isinstance(v, np.generic) else v


def _host_collect_agg(spec, arg, arg2, perm, seg_s, live_s, G: int, n: int, order=()):
    """array_agg / map_agg / listagg: per-group collection on the HOST over
    the sorted grouping (reference: aggregation/ArrayAggregationFunction,
    MapAggAggregationFunction, ListaggAggregationFunction).  The results
    are interned into a dictionary of structured values; returns (codes,
    valid, Dictionary) on the grouping's device."""
    from ..data.page import Dictionary

    dev = live_s.device
    perm_h = perm.cpu().numpy()
    seg_h = seg_s.cpu().numpy()
    live_h = live_s.cpu().numpy()

    def decode(cv: ColumnVal):
        d = cv.data.cpu().numpy()[perm_h]
        ok = _valid_of(cv, n).cpu().numpy()[perm_h] & live_h
        if cv.dict is not None:
            table = np.asarray(cv.dict.values, dtype=object)
            d = table[np.clip(d, 0, max(len(table) - 1, 0))]
        return d, ok

    vals, vok = decode(arg)
    keep = live_h & (seg_h < G)
    gs = seg_h[keep]
    v_k, ok_k = vals[keep], vok[keep]
    bounds = np.flatnonzero(np.diff(gs)) + 1
    group_ids = gs[np.concatenate([[0], bounds])] if len(gs) else np.zeros(0, np.int64)
    runs = np.split(np.arange(len(gs)), bounds)
    if order:
        # ordered collection: each group's run sorted by the aggregate's
        # ORDER BY keys
        lex: list[np.ndarray] = []
        for cv, asc, nulls_first in reversed(order):
            d, ok = decode(cv)
            null_rank, rank = _host_sort_rank(d[keep], ok[keep], None, asc, nulls_first)
            lex.append(rank)
            lex.append(null_rank)
        runs = [r[np.lexsort([k[r] for k in lex])] if len(r) > 1 else r for r in runs]

    def dedup_first(seq):
        seen: set = set()
        return [v for v in seq if not (v in seen or seen.add(v))]

    results: list = []
    res_ok: list[bool] = []
    if spec.fn == "listagg":
        sep = spec.sep if spec.sep is not None else ","
        for r in runs:
            parts = [str(v_k[i]) for i in r if ok_k[i]]
            if spec.distinct:
                parts = dedup_first(parts)
            results.append(sep.join(parts))
            res_ok.append(bool(parts))
    elif spec.fn == "array_agg":
        for r in runs:
            vals_r = [_py(v_k[i]) for i in r if ok_k[i]]
            if spec.distinct:
                vals_r = dedup_first(vals_r)
            results.append(tuple(vals_r))
            res_ok.append(True)
    else:  # map_agg(key, value): NULL keys skipped, the last value wins
        kv, kok = decode(arg2)
        kv_k, kok_k = kv[keep], kok[keep]
        for r in runs:
            mp: dict = {}
            for i in r:
                if ok_k[i]:
                    mp[_py(v_k[i])] = _py(kv_k[i]) if kok_k[i] else None
            try:  # canonical map form: pairs sorted by key (data/types.py)
                items = sorted(mp.items())
            except TypeError:
                items = sorted(mp.items(), key=lambda it: repr(it[0]))
            results.append(tuple(items))
            res_ok.append(bool(mp))

    # intern without sorting (tuples may mix None with values) and scatter
    # into the [G] output frame
    table: dict = {}
    codes = np.zeros((G,), np.int32)
    valid = np.zeros((G,), bool)
    for gid, res, ok in zip(group_ids, results, res_ok):
        codes[gid] = table.setdefault(res, len(table))
        valid[gid] = ok
    uniq = np.empty(max(len(table), 1), dtype=object)
    uniq[0] = "" if spec.fn == "listagg" else ()
    for val, code in table.items():
        uniq[code] = val
    return (
        torch.from_numpy(codes).to(dev), torch.from_numpy(valid).to(dev), Dictionary(uniq),
    )


def _global_aggregate(agg_args, specs, live, agg_args2=None, agg_order=None):
    """No GROUP BY: one output row even over empty input (SQL semantics).
    The aggregates run through the fused segmented reduction with a single
    segment; value-sorted ones sort the rows by their argument alone."""
    n = live.shape[0]
    dev = live.device
    # dead rows carry segment id 1 == num_segments: the dead-lane convention
    seg = (~live).to(torch.int32)
    grouping = _SortedGrouping([], live, 1) if _value_sorted(specs) else None
    out_aggs = _fused_aggs(
        agg_args, specs, seg, live, 1, n, agg_args2=agg_args2,
        grouping=grouping, agg_order=agg_order,
    )
    out_live = torch.ones((1,), dtype=torch.bool, device=dev)
    return [], out_aggs, out_live, torch.ones((), dtype=torch.int32, device=dev)


# ------------------------------------------------------------------- joins


_MIX_CONST = 0x9E3779B97F4A7C15


def _i64(c: int) -> int:
    """A 64-bit constant as the signed int64 with the same bits."""
    return c - (1 << 64) if c >= (1 << 63) else c


def _lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 lanes (torch's >> is arithmetic)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer over the bits of int64 lanes.  torch's uint64
    supports few operations, so it runs in int64: add, xor and multiply
    wrap to the same bits as the reference's uint64 arithmetic."""
    x = x.to(torch.int64) + _i64(_MIX_CONST)
    x = (x ^ _lsr(x, 30)) * _i64(0xBF58476D1CE4E5B9)
    x = (x ^ _lsr(x, 27)) * _i64(0x94D049BB133111EB)
    return x ^ _lsr(x, 31)


def _combined_hash(keys: Sequence[ColumnVal], live: torch.Tensor, n: int, sentinel: int):
    """Hash-combine key columns to int63; rows that are dead or have a null
    key get `sentinel` (never matches).  Exact key equality is re-verified
    after candidate expansion, so collisions only cost, never corrupt.
    VARCHAR columns hash by dictionary VALUE (Dictionary.hash64), so two
    columns with different code spaces route equal strings alike."""
    dev = live.device
    h = torch.zeros((n,), dtype=torch.int64, device=dev)
    ok = live
    for kv in keys:
        if kv.dict is not None:
            table = torch.from_numpy(kv.dict.hash64().view(np.int64)).to(dev)
            bits = table.index_select(
                0, kv.data.to(torch.int64).clamp(0, table.shape[0] - 1)
            )
        elif kv.data.dtype.is_floating_point:
            bits = kv.data.to(torch.float64).view(torch.int64)
        else:
            bits = kv.data.to(torch.int64)
            if kv.data2 is not None:
                # values that fit int64 carry a sign-extension high limb; mix
                # hi only when it adds information, so limbed and single-lane
                # forms of one value hash alike
                hi = kv.data2.to(torch.int64)
                extra = torch.where(
                    hi == (bits >> 63), torch.zeros_like(hi), _mix64(hi)
                )
                bits = bits ^ extra
        h = _mix64(h ^ _mix64(bits))
        ok = ok & _valid_of(kv, n)
    h = h & 0x3FFF_FFFF_FFFF_FFFF
    return torch.where(ok, h, torch.full_like(h, sentinel))


_SENT_BUILD = (1 << 62) + 2  # sorts after every real hash
_SENT_PROBE = (1 << 62) + 1  # != build sentinel -> dead probes match nothing


def _in_null_facts(left_keys, right_keys, left_live, right_live, nl, nr):
    """The three facts SQL IN's three-valued logic turns on: does the build
    side have any live row, does it hold a NULL key, is the probe key
    non-NULL.  Shared by null_anti (NOT IN filter) and mark_in (IN column)."""
    build_any = right_live.any()
    build_has_null = torch.zeros((), dtype=torch.bool, device=right_live.device)
    probe_ok = torch.ones((nl,), dtype=torch.bool, device=left_live.device)
    for rk in right_keys:
        build_has_null = build_has_null | (right_live & ~_valid_of(rk, nr)).any()
    for lk in left_keys:
        probe_ok = probe_ok & _valid_of(lk, nl)
    return build_any, build_has_null, probe_ok


def _hash_join_gids(left_keys, right_keys, left_live, right_live, nl, nr):
    """Hash-join front end: build a table over the right (build) side
    (kernel 3), probe it with the left side (kernel 4), and turn each probe
    row's dense build-group id into the (lo, hi) row range over perm_b that
    the sort path's expansion tail consumes — so every join kind shares the
    verified-match machinery below.

    Returns None when the static gate picks the sort path, else
    (ok, lo, hi, perm_b): `ok` is the runtime guard (table overflow or a
    probe walk past its budget).  equi_join hands ~ok to the executor, which
    re-runs the plan with this join on the sort path when it is set."""
    from .cuda import hashagg, hashjoin
    from .kernels import get_policy, impl_for, record_dispatch

    policy = get_policy()
    if not policy.enabled:
        record_dispatch("join", "sort", "kernels disabled")
        return None
    wl, llay = _hash_key_words(left_keys, nl, for_join=True)
    wr, rlay = _hash_key_words(right_keys, nr, for_join=True)
    if wl is None or wr is None or llay != rlay or len(wl) != len(wr):
        record_dispatch("join", "sort", "keys not word-encodable")
        return None
    if nr > policy.hash_join_max_build:
        record_dispatch("join", "fallback", f"build {nr} > hash_join_limit")
        return None
    if not hashagg.shape_supported(max(nl, nr, 1), len(wr), nr):
        record_dispatch("join", "sort", "shape unsupported")
        return None
    dev = right_live.device
    record_dispatch("join", impl_for(dev), f"build {nr} table {hashagg.table_size(nr)}")

    blive = right_live
    for rk in right_keys:
        blive = blive & _valid_of(rk, nr)  # NULL keys never match
    plive = left_live
    for lk in left_keys:
        plive = plive & _valid_of(lk, nl)

    gid_b, table, _n_true, ovb = hashagg.build_hash_table(wr, blive, nr, keep_keys=False)
    gid_p, unres = hashjoin.probe_hash_table(wl, plive, table)
    ok = ~ovb & ~unres

    # build rows sorted by group id (dead/null rows last) give contiguous
    # per-group ranges; group starts come from a searchsorted over the build
    # side only
    segb = torch.where(
        blive & (gid_b >= 0), gid_b.clamp(max=nr - 1), torch.full_like(gid_b, nr)
    )
    segb_sorted, perm_b = torch.sort(segb, stable=True)
    gids = torch.arange(nr, dtype=torch.int32, device=dev)
    gstart = searchsorted_tpu(segb_sorted, gids, side="left")
    gend = searchsorted_tpu(segb_sorted, gids, side="right")
    matched = gid_p >= 0
    gidx = gid_p.clamp(0, nr - 1).to(torch.int64)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    lo = torch.where(matched, gstart.index_select(0, gidx), zero)
    cnt = torch.where(matched, gend.index_select(0, gidx) - gstart.index_select(0, gidx), zero)
    return ok, lo, lo + cnt, perm_b


def _gather_join_col(cv: ColumnVal, idx: torch.Tensor) -> ColumnVal:
    return ColumnVal(
        cv.data.index_select(0, idx), _take(cv.valid, idx), cv.dict, cv.type,
        _take(cv.data2, idx),
    )


def equi_join(
    kind: str,
    left_cols: Sequence[ColumnVal],
    left_live: torch.Tensor,
    right_cols: Sequence[ColumnVal],
    right_live: torch.Tensor,
    left_keys: Sequence[ColumnVal],
    right_keys: Sequence[ColumnVal],
    residual,
    out_capacity: int,
    force_sort: bool = False,
):
    """Equi-join.  kind: inner | left | full | semi | anti | null_anti |
    mark | mark_in.

    inner/left/full -> (out_cols, out_live, ...) with capacity out_capacity
      (+ n_left lanes for unmatched left rows, + n_right for full).
    semi/anti  -> (left_cols, new_live, ...): filters the left page.
    null_anti is the NOT IN lowering: with a non-empty build side, probe
      rows whose key is NULL — or any probe row when the build side holds a
      NULL key — evaluate NOT IN to NULL and are filtered; an empty build
      side keeps every probe row.
    mark / mark_in -> (left_cols + [match BOOLEAN column], left_live, ...):
      the membership test as a COLUMN (EXISTS / IN in general expression
      positions).  mark is two-valued; mark_in is SQL three-valued: NULL
      when the probe key is NULL or the build side holds a NULL key and
      there is no match (an empty build is FALSE).

    Returns (cols, live, required, hash_failed): `required` is the true
    expansion size for the executor's capacity retry; `hash_failed` is a
    device bool, set when the hash path's table overflowed or a probe walk
    ran past its budget — the rows are then unusable and the executor
    re-runs the plan with `force_sort` for this join (the eager form of the
    reference's lax.cond over the same flag).
    """
    nl = left_live.shape[0]
    nr = right_live.shape[0]
    C = out_capacity
    dev = left_live.device

    if force_sort:
        from .kernels import record_dispatch

        record_dispatch("join", "sort", "hash table failed its guard")
        hashed = None
    else:
        hashed = _hash_join_gids(left_keys, right_keys, left_live, right_live, nl, nr)
    if hashed is not None:
        ok, lo, hi, perm_b = hashed
        hash_failed = ~ok
    else:
        bh = _combined_hash(right_keys, right_live, nr, _SENT_BUILD)
        ph = _combined_hash(left_keys, left_live, nl, _SENT_PROBE)
        bh_sorted, perm_b = torch.sort(bh, stable=True)
        lo = searchsorted_tpu(bh_sorted, ph, side="left")
        hi = searchsorted_tpu(bh_sorted, ph, side="right")
        hash_failed = torch.zeros((), dtype=torch.bool, device=dev)
    counts = (hi - lo).to(torch.int64)
    cum = torch.cumsum(counts, 0)
    total = cum[-1]

    j = torch.arange(C, dtype=torch.int64, device=dev)
    pidx = searchsorted_tpu(cum, j, side="right")
    pidx_c = pidx.clamp(max=nl - 1)
    start = cum.index_select(0, pidx_c) - counts.index_select(0, pidx_c)
    bpos = lo.index_select(0, pidx_c).to(torch.int64) + (j - start)
    bidx = perm_b.index_select(0, bpos.clamp(0, nr - 1))
    in_range = j < total

    # exact key verification (hash collisions + sentinel lanes); decimal128
    # keys verify BOTH limbs (a single-lane side sign-extends into limb space)
    eq = in_range
    for lk, rk in zip(left_keys, right_keys):
        lv = lk.data.index_select(0, pidx_c)
        rv = rk.data.index_select(0, bidx)
        eq = eq & (lv == rv) & _valid_of(lk, nl).index_select(0, pidx_c)
        eq = eq & _valid_of(rk, nr).index_select(0, bidx)
        if lk.data2 is not None or rk.data2 is not None:
            lhi = (lk.data2.index_select(0, pidx_c) if lk.data2 is not None
                   else lv.to(torch.int64) >> 63)
            rhi = (rk.data2.index_select(0, bidx) if rk.data2 is not None
                   else rv.to(torch.int64) >> 63)
            eq = eq & (lhi == rhi)

    # gather both sides into the expansion frame (decimal128 columns carry
    # their high limb through the gather)
    gathered = [_gather_join_col(cv, pidx_c) for cv in left_cols]
    gathered += [_gather_join_col(cv, bidx) for cv in right_cols]
    match = eq
    if residual is not None:
        match = match & residual(gathered, C)
    required = total

    def hit_of(idx, size):
        return torch.zeros((size,), dtype=torch.int32, device=dev).index_add_(
            0, idx, match.to(torch.int32)
        ) > 0

    if kind in ("mark", "mark_in"):
        from ..data.types import BOOLEAN

        hit = hit_of(pidx_c, nl)
        if kind == "mark":
            mark = ColumnVal(hit, None, None, BOOLEAN)
        else:
            build_any, build_has_null, probe_ok = _in_null_facts(
                left_keys, right_keys, left_live, right_live, nl, nr
            )
            # TRUE on match; else FALSE when definitively absent (non-null
            # probe, no build NULLs, or empty build); else NULL (unknown)
            definite = hit | ~build_any | (probe_ok & ~build_has_null)
            mark = ColumnVal(hit, definite, None, BOOLEAN)
        return list(left_cols) + [mark], left_live, required, hash_failed

    if kind in ("semi", "anti", "null_anti"):
        hit = hit_of(pidx_c, nl)
        if kind == "semi":
            new_live = left_live & hit
        elif kind == "anti":
            new_live = left_live & ~hit
        else:  # null_anti: SQL three-valued NOT IN
            build_any, build_has_null, probe_ok = _in_null_facts(
                left_keys, right_keys, left_live, right_live, nl, nr
            )
            keep = torch.where(build_any, ~hit & probe_ok & ~build_has_null,
                               torch.ones_like(hit))
            new_live = left_live & keep
        return list(left_cols), new_live, required, hash_failed

    if kind == "inner":
        return gathered, match, required, hash_failed

    if kind in ("left", "full"):
        # expansion lanes ++ unmatched left lanes with null right columns
        # (full: ++ unmatched RIGHT lanes with null left columns too)
        hit = hit_of(pidx_c, nl)
        unmatched = left_live & ~hit
        full = kind == "full"
        if full:
            unmatched_r = right_live & ~hit_of(bidx, nr)

        def ones(k):
            return torch.ones((k,), dtype=torch.bool, device=dev)

        def zeros_like_lanes(t, k):
            return torch.zeros((k,), dtype=t.dtype, device=dev)

        out: list[ColumnVal] = []
        for i, cv in enumerate(left_cols):
            g = gathered[i]
            data = torch.cat([g.data, cv.data])
            data2 = None if cv.data2 is None else torch.cat([g.data2, cv.data2])
            valid = None
            if cv.valid is not None or full:
                valid = torch.cat([
                    g.valid if g.valid is not None else ones(C),
                    cv.valid if cv.valid is not None else ones(nl),
                ])
            if full:
                data = torch.cat([data, zeros_like_lanes(cv.data, nr)])
                valid = torch.cat([valid, torch.zeros((nr,), dtype=torch.bool, device=dev)])
                if data2 is not None:
                    data2 = torch.cat([data2, zeros_like_lanes(data2, nr)])
            out.append(ColumnVal(data, valid, cv.dict, cv.type, data2))
        off = len(left_cols)
        for i, cv in enumerate(right_cols):
            g = gathered[off + i]
            data = torch.cat([g.data, zeros_like_lanes(cv.data, nl)])
            valid = torch.cat([
                g.valid if g.valid is not None else ones(C),
                torch.zeros((nl,), dtype=torch.bool, device=dev),
            ])
            data2 = None if cv.data2 is None else torch.cat(
                [g.data2, zeros_like_lanes(cv.data2, nl)]
            )
            if full:
                data = torch.cat([data, cv.data])
                valid = torch.cat([valid, cv.valid if cv.valid is not None else ones(nr)])
                if data2 is not None:
                    data2 = torch.cat([data2, cv.data2])
            out.append(ColumnVal(data, valid, cv.dict, cv.type, data2))
        out_live = torch.cat([match, unmatched])
        if full:
            out_live = torch.cat([out_live, unmatched_r])
        return out, out_live, required, hash_failed

    raise NotImplementedError(f"join kind {kind}")


def broadcast_single_row(
    left_cols: Sequence[ColumnVal],
    left_live: torch.Tensor,
    right_cols: Sequence[ColumnVal],
    right_live: torch.Tensor,
):
    """Cross join against a single-row relation (scalar-subquery shape):
    broadcast the one live right row across the left page."""
    nl = left_live.shape[0]
    ridx = torch.argmax(right_live.to(torch.int8)).reshape(1)  # the single live row
    any_right = right_live.any()
    out = list(left_cols)

    def spread(t: torch.Tensor) -> torch.Tensor:
        return t.index_select(0, ridx).expand(nl).clone()

    for cv in right_cols:
        valid = any_right.expand(nl).clone()
        if cv.valid is not None:
            valid = spread(cv.valid) & any_right
        out.append(ColumnVal(
            spread(cv.data), valid, cv.dict, cv.type,
            None if cv.data2 is None else spread(cv.data2),
        ))
    return out, left_live


# ------------------------------------------------------ sort/limit/compact


def _gather_cols(cols, idx):
    return [
        ColumnVal(
            cv.data.index_select(0, idx), _take(cv.valid, idx), cv.dict, cv.type,
            _take(cv.data2, idx),
        )
        for cv in cols
    ]


def compact_rows(cols, live, cap: int):
    """Gather live rows into `cap` lanes (dead lanes drop), original order
    kept.  Returns (cols, live, required) with required = true live count
    for the capacity-retry protocol."""
    perm = torch.argsort((~live).to(torch.int8), stable=True)
    take = perm[:cap]
    required = live.sum(dtype=torch.int64)
    out = _gather_cols(cols, take)
    out_live = torch.arange(cap, dtype=torch.int64, device=live.device) < torch.clamp(
        required, max=cap
    )
    return out, out_live, required


def sort_rows(
    cols: Sequence[ColumnVal],
    live: torch.Tensor,
    keys: Sequence[ColumnVal],
    specs: Sequence[SortSpec],
):
    """Stable multi-key sort; dead rows sink to the end."""
    n = live.shape[0]
    operands: list[torch.Tensor] = [(~live).to(torch.int8)]
    for kv, spec in zip(keys, specs):
        valid = _valid_of(kv, n)
        # smaller flag sorts first: nulls-first -> nulls get 0, else nulls get 1
        null_flag = valid if spec.nulls_first else ~valid
        operands.append(null_flag.to(torch.int8))
        operands.extend(_sortable_operands(kv, descending=not spec.ascending))
    perm = _lexsort(operands)
    return _gather_cols(cols, perm), live.index_select(0, perm)


def _head(cols: Sequence[ColumnVal], k: int) -> list[ColumnVal]:
    return [
        ColumnVal(cv.data[:k], None if cv.valid is None else cv.valid[:k], cv.dict,
                  cv.type, None if cv.data2 is None else cv.data2[:k])
        for cv in cols
    ]


def _fits_int32(data: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Device bool: every counted int64 value fits the int32 lane the
    reference would have narrowed it to at upload (its rule: -2^31 < v <
    2^31).  One launch of the segmented reduce, no host sync."""
    from .cuda.segreduce import SegRed, fused_segment_reduce
    from .kernels import impl_for, record_dispatch

    seg = torch.zeros(data.shape, dtype=torch.int32, device=data.device)
    record_dispatch("segment_reduce", impl_for(data.device), "2 reductions 1 groups")
    mn, mx = fused_segment_reduce(
        seg, [SegRed("min", data, valid), SegRed("max", data, valid)], 1
    )
    return ((mn > -(1 << 31)) & (mx < (1 << 31)))[0]


def top_n(cols, live, keys, specs, count: int, cap: Optional[int] = None):
    """TopN.  Returns (cols, live, required).

    Radix-select path (large inputs): find the exact K-th threshold of the
    leading key in three digit passes and list the <= `cap` candidate rows
    (kernel 5, ops/cuda/topk.py `radix_select`), then sort only those — no
    sort of the relation.  `required` is the candidate count for the
    executor's capacity retry; the sort path reports 0 (never retries).

    The leading key maps to a monotone u32.  An int64 key whose live values
    fit int32 maps as int32 would (the reference narrows such a lane at
    upload; the port keeps 64-bit lanes, and their top 32 bits would put
    every row into one bin)."""
    from .cuda.topk import radix_select, radix_topk_supported, sortable_u32
    from .kernels import impl_for, record_dispatch

    n = live.shape[0]
    k = min(count, n)
    if not (
        cap is not None and cap >= count and keys and n > 0
        and keys[0].data2 is None  # radix threshold is 32-bit single-lane
        and radix_topk_supported(n, count)
    ):
        record_dispatch("topn", "sort", f"{n} rows k {count}")
        sorted_cols, sorted_live = sort_rows(cols, live, keys, specs)
        return _head(sorted_cols, k), sorted_live[:k], torch.zeros(
            (), dtype=torch.int64, device=live.device
        )

    dev = live.device
    record_dispatch("topn", impl_for(dev), f"radix {n} rows k {count} cap {cap}")
    kv, spec = keys[0], specs[0]
    valid = _valid_of(kv, n)
    key = _sortable_key(kv)
    narrow = _fits_int32(key, live & valid) if key.dtype == torch.int64 else None
    u = sortable_u32(key, descending=spec.ascending, narrow=narrow)  # first rows == largest u
    null_u = -1 if spec.nulls_first else 0  # the u32 bits 0xFFFFFFFF or 0
    u = torch.where(valid, u, torch.full_like(u, null_u))
    sel = radix_select(u, live, count, cap)
    idx_buf, required = sel.ids, sel.required
    lane_live = torch.arange(cap, dtype=torch.int64, device=dev) < torch.clamp(required, max=cap)
    sub_cols = _gather_cols(cols, idx_buf)
    sub_keys = _gather_cols(keys, idx_buf)
    sorted_cols, sorted_live = sort_rows(sub_cols, lane_live, sub_keys, specs)
    return _head(sorted_cols, k), sorted_live[:k], required


def limit_mask(live: torch.Tensor, count: int) -> torch.Tensor:
    return live & (torch.cumsum(live.to(torch.int64), 0) <= count)


def unnest_expand(
    cols: Sequence[ColumnVal],
    live: torch.Tensor,
    arrays: Sequence[ColumnVal],
    elem_types,
    with_ordinality: bool,
    outer: bool,
    C: int,
):
    """Expand rows by array length (reference: operator/unnest/
    UnnestOperator).  Returns (columns, live, required): the child's columns
    gathered per output row, one element column per array, the ordinality
    when asked, and the true output size for the capacity-retry loop.

    Arrays are dictionary-coded; each distinct array's elements go to the
    device once, flat, with their start offsets (ops/expr.py
    array_elements), and element `pos` of a row is read at
    starts[code] + pos — so one long array does not widen every row, as
    the reference's padded [distinct, longest] element matrix does.  The
    expansion: an inclusive scan of the row lengths, then a sorted lookup of
    each output lane's source row.  Several arrays zip (Trino semantics):
    a row extends to its longest array, the shorter ones NULL-pad.  `outer`
    keeps an empty or NULL array's row with NULL elements and a NULL
    ordinality (LEFT JOIN UNNEST ... ON TRUE)."""
    n = int(live.shape[0])
    dev = live.device
    row_lens = torch.zeros((n,), dtype=torch.int64, device=dev)
    flats = []
    for arr, et in zip(arrays, elem_types):
        starts, flat, ed = array_elements(arr.dict.values, et, dev)
        code = _codes(arr)
        lo = starts.index_select(0, code)
        ln = starts.index_select(0, code + 1) - lo
        if arr.valid is not None:
            ln = torch.where(arr.valid, ln, torch.zeros_like(ln))
        row_lens = torch.maximum(row_lens, ln)
        flats.append((arr, et, lo, ln, flat, ed))
    row_lens = torch.where(live, row_lens, torch.zeros_like(row_lens))
    pre_outer = row_lens
    if outer:
        row_lens = torch.where(live & (row_lens == 0), torch.ones_like(row_lens), row_lens)

    ends = torch.cumsum(row_lens, 0)
    total = ends[-1] if n else torch.zeros((), dtype=torch.int64, device=dev)
    j = torch.arange(C, dtype=torch.int64, device=dev)
    src = searchsorted_tpu(ends, j, side="right").clamp(0, max(n - 1, 0))
    pos = j - (ends - row_lens).index_select(0, src)
    out_live = j < total

    out_cols = [
        ColumnVal(cv.data.index_select(0, src), _take(cv.valid, src), cv.dict, cv.type)
        for cv in cols
    ]
    for arr, et, lo, ln, flat, ed in flats:
        at = (lo.index_select(0, src) + pos).clamp(0, flat.shape[0] - 1)
        valid = out_live & (pos < ln.index_select(0, src))
        if arr.valid is not None:
            valid = valid & arr.valid.index_select(0, src)
        out_cols.append(ColumnVal(flat.index_select(0, at), valid, ed, et))
    if with_ordinality:
        ord_valid = out_live & (pos < pre_outer.index_select(0, src)) if outer else None
        out_cols.append(ColumnVal(pos + 1, ord_valid, None, BIGINT))
    return out_cols, out_live, total
