#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card and nvcc

It builds the port's CUDA kernels from trino_tpu_torch/csrc/, holds each of
the five against its plain PyTorch version on the card (edge cases, then
timed inputs at the main path's largest shapes: a 64 Mi-row TPC-H
Q1-shaped column set, an 8 Mi-row hash build and probe, four radix passes
over 64 Mi keys), and drives the port's main path — `Engine.query` on TPC-H
scale factor 1: Q1, Q6 and a min/max group-by through the segmented reduce
and the fused pipeline, Q3 through the hash build and probe (and through
the sort paths with kernels off), and the ten most expensive line items
through radix select — checking every result against an independent numpy
reference and against the same query on `Engine(device="cpu")`.  Each phase prints one JSON line; the last line of
standard output is `{"ok": true, "device": {...}}`.  Any failed build,
launch or comparison ends the run with a non-zero exit code.  Without a CUDA
device it prints a message on stderr and exits 2.

Options: `--scale F` (TPC-H scale factor of the main path, default 1.0),
`--rows N` (rows of the timed kernel inputs, default 64 Mi; the hash build
and probe take N/8), `--ptxas`
(print nvcc's per-kernel register / shared-memory report to stderr).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from decimal import Decimal

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device-memory rate (data sheet)
FP64_OPS_PER_S = 33.5e12    # H100 SXM float64 / 64-bit ALU rate outside the tensor cores

Q03 = """
select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue,
  o_orderdate, o_shippriority
from customer, orders, lineitem
where c_mktsegment = 'BUILDING' and c_custkey = o_custkey and l_orderkey = o_orderkey
  and o_orderdate < date '1995-03-15' and l_shipdate > date '1995-03-15'
group by l_orderkey, o_orderdate, o_shippriority
order by revenue desc, o_orderdate
limit 10
"""
TOPN = (
    "select l_orderkey, l_linenumber, l_extendedprice from lineitem "
    "order by l_extendedprice desc, l_orderkey, l_linenumber limit 10"
)
Q01 = """
select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty,
  sum(l_extendedprice) as sum_base_price,
  sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
  sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
  avg(l_quantity) as avg_qty, avg(l_extendedprice) as avg_price,
  avg(l_discount) as avg_disc, count(*) as count_order
from lineitem
where l_shipdate <= date '1998-12-01' - interval '90' day
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus
"""
Q06 = """
select sum(l_extendedprice * l_discount) as revenue
from lineitem
where l_shipdate >= date '1994-01-01'
  and l_shipdate < date '1994-01-01' + interval '1' year
  and l_discount between 0.06 - 0.01 and 0.06 + 0.01
  and l_quantity < 24
"""
QMM = (
    "select l_returnflag, min(l_shipdate), max(l_extendedprice), count(*) "
    "from lineitem group by l_returnflag order by 1"
)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ------------------------------------------------------------------ timing


def time_ms(fn, warmup: int, iters: int) -> float:
    """Median device time of fn() in ms (CUDA events around each call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# largest double-sum error relative to sum|x| seen per kernel (the integer
# kernels are compared exactly and stay at 0)
REL_ERR = {"segment_reduce": 0.0, "fused_pipeline": 0.0, "hash_build": 0.0,
           "hash_probe": 0.0, "radix_histogram": 0.0}
L2_BYTES = 50 * 1024 * 1024  # H100 L2
SECTOR = 32  # bytes of device memory behind one random table-slot read


def note_rel(kernel: str, err: float, scale: float) -> None:
    if scale > 0.0:
        REL_ERR[kernel] = max(REL_ERR[kernel], err / scale)


def distinct_bytes(tensors) -> int:
    seen = {}
    for t in tensors:
        if t is not None:
            seen[t.data_ptr()] = t.numel() * t.element_size()
    return sum(seen.values())


# -------------------------------------------------- kernel 1: segment_reduce


def sum_tolerance(n: int) -> float:
    """Allowed |kernel - plain| of a float64 sum over n rows, as a fraction
    of sum|x|.  Both sides add in an order set by atomics, and recursive
    summation in ANY order is within (n-1) * 2^-53 * sum|x| of the exact sum,
    so two orders differ by at most twice that; 1e-12 is the floor for
    short inputs."""
    return max(1e-12, 2.0 * n * 2.0**-53)


def compare_outputs(got, want, scales, what: str, n: int) -> float:
    """Integers bit-exact; doubles within sum_tolerance(n) * sum|x| (atomic
    order varies).  Returns the largest absolute error seen; the largest
    error relative to sum|x| goes to REL_ERR."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype != w.dtype or g.shape != w.shape:
            fail(f"{what}[{i}]: {g.dtype}{tuple(g.shape)} vs {w.dtype}{tuple(w.shape)}")
        if g.dtype.is_floating_point:
            both_inf = torch.isinf(g) & torch.isinf(w) & (g == w)
            err = torch.where(both_inf, torch.zeros_like(g), (g - w).abs())
            tol = sum_tolerance(n) * scales[i] + 1e-300
            if not bool((err <= tol).all()):
                fail(f"{what}[{i}]: max err {float(err.max())} > {tol}")
            top = float(err.max()) if err.numel() else 0.0
            worst = max(worst, top)
            note_rel("segment_reduce", top, scales[i])
        elif not torch.equal(g, w):
            fail(f"{what}[{i}]: integer results differ")
    return worst


def segreduce_case(seg, reds, G, what: str, got=None) -> float:
    """Kernel 1 against its plain version on the same inputs (`got`: the
    kernel's result when the caller already has it)."""
    from trino_tpu_torch.ops.cuda import segreduce as sr

    if got is None:
        got = sr.fused_segment_reduce(seg, reds, G)
    torch.cuda.synchronize()
    want = sr.plain_segment_reduce(seg, reds, G)
    scales = []
    for r in reds:
        if r.values is not None and r.values.dtype.is_floating_point and r.op == "sum":
            scales.append(float(r.values.abs().sum()) if r.values.numel() else 0.0)
        else:
            scales.append(0.0)
    return compare_outputs(got, want, scales, f"segment_reduce {what}", seg.shape[0])


def segreduce_edges(dev) -> float:
    from trino_tpu_torch.ops.cuda.segreduce import SegRed

    rng = np.random.default_rng(7)
    worst = 0.0

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    i64 = np.iinfo(np.int64)
    for n, G in ((0, 4), (1, 1), (1, 8192), (100003, 1), (100003, 6), (65537, 8192), (300001, 700)):
        seg = rng.integers(0, G + 3, size=n).astype(np.int32)  # ids >= G: dead lanes
        if n > 2:
            seg[:2] = (-1, G)  # negative and == G are dead too
        vi = rng.integers(-10**12, 10**12, size=n).astype(np.int64)
        if n > 8:
            vi[:8] = (i64.max, i64.max, i64.min, i64.min, 0, -1, i64.max, 1)
            seg[2:8] = 0  # the extremes wrap inside one group
        v32 = rng.integers(-2**31, 2**31 - 1, size=n).astype(np.int32)
        vf = rng.normal(0, 1e6, size=n)
        vb = rng.random(n) < 0.5
        valid = rng.random(n) < 0.7
        none = np.zeros(n, np.bool_)  # an all-NULL column
        reds = [
            SegRed("count", None, None), SegRed("count", None, t(valid)),
            SegRed("sum", t(vi), None), SegRed("sum", t(vi), t(valid)),
            SegRed("sum", t(v32), t(valid)), SegRed("sum", t(vf), t(valid)),
            SegRed("sum", t(vb), None),
            SegRed("min", t(vi), t(valid)), SegRed("max", t(vi), t(valid)),
            SegRed("min", t(v32), None), SegRed("max", t(v32), t(valid)),
            SegRed("min", t(vf), t(valid)), SegRed("max", t(vf), None),
            SegRed("sum", t(vi), t(none)), SegRed("min", t(vf), t(none)),
            SegRed("max", t(v32), t(none)), SegRed("count", None, t(none)),
        ]
        worst = max(worst, segreduce_case(t(seg), reds, G, f"n={n} G={G}"))
    # more reductions than one launch's table holds
    n, G = 5000, 5
    seg = t(rng.integers(0, G, size=n).astype(np.int32))
    many = [SegRed("sum", t(rng.integers(-99, 99, size=n).astype(np.int64)), None)
            for _ in range(40)]
    worst = max(worst, segreduce_case(seg, many, G, "40 reductions"))
    return worst


# -------------------------------------------------- kernel 2: fused_pipeline


def fused_case(recipe, cols, live, what: str, got=None) -> float:
    """Kernel 2 against its plain version on the same inputs (`got`: the
    kernel's result when the caller already has it)."""
    from trino_tpu_torch.ops.cuda import fused

    if got is None:
        got = fused.run(recipe, cols, live)
    torch.cuda.synchronize()
    want = fused.run_plain(recipe, cols, live)
    worst = 0.0
    n = cols[0].data.shape[0]
    for si, (tag, _) in enumerate(recipe.streams):
        if tag == "fsum":
            g = got[si, 0].view(torch.float64)
            w = want[si, 0].view(torch.float64)
            # tolerance scale: sum |x| over the rows is bounded by the plain
            # version's total of absolute values; use the larger total
            scale = max(float(g.abs().sum()), float(w.abs().sum()))
            scale = max(scale, fused_abs_scale(recipe, cols, live, si))
            err = float((g - w).abs().max()) if g.numel() else 0.0
            if err > sum_tolerance(n) * scale + 1e-300:
                fail(f"fused_pipeline {what}: stream {si} err {err} > "
                     f"{sum_tolerance(n)}*{scale}")
            worst = max(worst, err)
            note_rel("fused_pipeline", err, scale)
        elif not torch.equal(got[si], want[si]):
            fail(f"fused_pipeline {what}: integer stream {si} ({tag}) differs")
    return worst


def fused_abs_scale(recipe, cols, live, si) -> float:
    """sum |x| of a double stream's argument over all rows (an upper bound of
    what any group's additions saw)."""
    from trino_tpu_torch.ops.expr import eval_expr

    e = recipe.streams[si][1]
    n = cols[0].data.shape[0]
    if n == 0:
        return 0.0
    v = eval_expr(e, cols, n)
    return float(v.data.abs().sum())


def fused_edges(dev) -> float:
    from trino_tpu_torch.data.page import Dictionary
    from trino_tpu_torch.data.types import BOOLEAN, DATE, DOUBLE, DecimalType
    from trino_tpu_torch.ops.cuda import fused
    from trino_tpu_torch.ops.expr import ColumnVal
    from trino_tpu_torch.plan.ir import Call, Const, FieldRef

    rng = np.random.default_rng(11)
    worst = 0.0
    d18 = DecimalType(18, 2)
    d38_4 = DecimalType(38, 4)
    d38_2 = DecimalType(38, 2)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def dictionary(k):
        return Dictionary(np.asarray([f"v{i:04d}" for i in range(k)], dtype=object))

    for n, doms in ((0, (3, 2)), (1, (3, 2)), (100003, (3, 2)), (70001, (32, 16)), (50001, ())):
        big = rng.integers(-(2**62), 2**62, size=n).astype(np.int64)
        if n > 6:
            big[:6] = (2**63 - 1, 2**63 - 1, -(2**63), -(2**63), 0, -1)
        a = ColumnVal(t(big), None, None, d18)
        b = ColumnVal(t(rng.integers(-10**17, 10**17, size=n).astype(np.int64)),
                      t(rng.random(n) < 0.8), None, d18)
        nul = ColumnVal(t(rng.integers(0, 100, size=n).astype(np.int64)),
                        t(np.zeros(n, np.bool_)), None, d18)  # all-NULL column
        dt = ColumnVal(t(rng.integers(8000, 10600, size=n).astype(np.int32)), None, None, DATE)
        x = ColumnVal(t(rng.normal(0, 1e3, size=n)), t(rng.random(n) < 0.9), None, DOUBLE)
        flag = ColumnVal(t(rng.random(n) < 0.5), t(rng.random(n) < 0.9), None, BOOLEAN)
        cols = [a, b, nul, dt, x, flag]
        keys = []
        for k in doms:
            cols.append(ColumnVal(t(rng.integers(0, k, size=n).astype(np.int32)), None,
                                  dictionary(k), None))
            keys.append(FieldRef(len(cols) - 1, None))
        A, B, N_, DT, X, FL = (FieldRef(i, c.type) for i, c in enumerate(cols[:6]))
        filters = [
            Call("le", (DT, Const(10400, DATE)), BOOLEAN),
            Call("or", (
                Call("and", (FL, Call("not", (Call("is_null", (B,), BOOLEAN),), BOOLEAN)), BOOLEAN),
                Call("gt", (X, Const(-500.0, DOUBLE)), BOOLEAN)), BOOLEAN),
        ]
        prod = Call("mul", (A, B), d38_4)  # needs the high limb
        args = [A, prod, B, N_, N_, X, Call("cast", (B,), DOUBLE),
                Call("neg", (Call("sub", (A, B), d18),), d18), None]
        fns = ["sum", "sum", "count", "sum", "count", "sum", "avg", "sum", "count_star"]
        types = [d38_2, d38_4, None, d38_2, None, DOUBLE, DOUBLE, d38_2, None]
        from trino_tpu_torch.data.types import BIGINT
        types = [BIGINT if ty is None else ty for ty in types]
        recipe, why = fused.plan_pipeline(cols, filters, keys, fns, args, types)
        if recipe is None:
            fail(f"fused edge recipe declined: {why}")
        live = None if n % 2 else t(rng.random(n) < 0.95)
        worst = max(worst, fused_case(recipe, cols, live, f"n={n} D={recipe.domain}"))
    return worst


# ------------------------------------------- kernels 3 and 4: build / probe


def same_partition(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Two group-id vectors name the same groups: -1 in the same rows and a
    one-to-one map between the other ids (ids come in claim order, which
    changes from run to run on the card)."""
    a, b = a.to(torch.int64), b.to(torch.int64)
    if not torch.equal(a < 0, b < 0):
        return False
    m = a >= 0
    if not bool(m.any()):
        return True
    pairs = torch.unique(a[m] * (1 << 32) + b[m])
    return pairs.numel() == torch.unique(a[m]).numel() == torch.unique(b[m]).numel()


def hash_case(words, live, cap, what: str, got=None, keep_keys=True, probe=None) -> None:
    """Kernel 3 against its plain version on the same rows (integer outputs
    exact, ids as the same partition), then each version's table probed by
    kernel 4 (`probe`: its wrapper) and by the plain probe with the build's
    own rows: the two probes agree exactly, and every live row finds its own
    build id."""
    from trino_tpu_torch.ops.cuda import hashagg, hashjoin

    probe = probe or hashjoin.probe_hash_table
    if got is None:
        got = hashagg.build_hash_table(words, live, cap, keep_keys=keep_keys)
    gid, table, n_groups, overflow = got
    torch.cuda.synchronize()
    pgid, ptable, pn, pover = hashagg.plain_build_hash_table(words, live, cap, keep_keys=keep_keys)
    if bool(overflow) != bool(pover):
        fail(f"hash_build {what}: overflow {bool(overflow)} vs plain {bool(pover)}")
    if bool(overflow):
        return  # ids are unusable past the tier; both versions raised the flag
    if int(n_groups) != int(pn):
        fail(f"hash_build {what}: {int(n_groups)} groups vs plain {int(pn)}")
    if not same_partition(gid, pgid):
        fail(f"hash_build {what}: group ids are not the plain version's partition")
    rows = live.nonzero().flatten()
    for tab, ids, who in ((table, gid, "kernel"), (ptable, pgid, "plain")):
        if keep_keys:
            g = ids.index_select(0, rows).to(torch.int64)
            for i, w in enumerate(words):
                if not torch.equal(tab.group_keys[i].index_select(0, g), w.index_select(0, rows)):
                    fail(f"hash_build {what}: {who} group_keys word {i} differs")
        k, ku = probe(words, live, tab)
        p, pu = hashjoin.plain_probe_hash_table(words, live, tab)
        torch.cuda.synchronize()
        if bool(ku) or bool(pu) or not torch.equal(k, p):
            fail(f"hash_probe {what}: kernel and plain probe of the {who} table differ")
        if not torch.equal(k, ids):
            fail(f"hash_probe {what}: probing the {who} table with its own rows "
                 "does not return their build ids")


def probe_case(words, live, table, what: str, got=None) -> float:
    """Kernel 4 against its plain version on the same table: exact."""
    from trino_tpu_torch.ops.cuda import hashjoin

    if got is None:
        got = hashjoin.probe_hash_table(words, live, table)
    gid, unres = got
    torch.cuda.synchronize()
    pgid, punres = hashjoin.plain_probe_hash_table(words, live, table)
    if bool(unres) != bool(punres) or not torch.equal(gid, pgid):
        fail(f"hash_probe {what}: kernel and plain version differ")
    return float((gid >= 0).sum()) / max(1, int(live.sum()))


def hash_edges(dev) -> None:
    from trino_tpu_torch.ops.cuda import hashagg

    g = torch.Generator(device=dev)
    g.manual_seed(31)

    def ints(shape, lo=-2**31, hi=2**31 - 1):
        return torch.randint(lo, hi, shape, generator=g, device=dev, dtype=torch.int32)

    def keyed(base, n, live_frac=0.9):
        pick = torch.randint(0, base.shape[0], (n,), generator=g, device=dev)
        live = torch.rand(n, generator=g, device=dev) < live_frac
        return [base[pick, i].contiguous() for i in range(base.shape[1])], live

    hash_case([torch.empty(0, dtype=torch.int32, device=dev)],
              torch.zeros(0, dtype=torch.bool, device=dev), 8, "empty")
    words, _ = keyed(ints((100, 2)), 1000)
    hash_case(words, torch.zeros(1000, dtype=torch.bool, device=dev), 128, "all dead")
    words, live = keyed(ints((1, 2)), 100003)
    hash_case(words, live, 16, "all keys equal")
    # start slots at T - 1: the walk of every key after the first wraps to 0
    cap = 4096
    T = hashagg.table_size(cap)
    cand = ints((1 << 20,))
    slot = hashagg.hash_words([cand], torch.ones_like(cand, dtype=torch.bool)) & (T - 1)
    last = cand[slot >= T - 2][:24].reshape(-1, 1)
    if last.shape[0] < 8:
        fail("hash edge: found too few keys whose start slot is T-1 or T-2")
    words, live = keyed(last, 50000)
    hash_case(words, live, cap, "start slots at T-1")
    # NULL keys through the validity word: equal payloads, different validity
    payload = ints((500, 2))
    words, live = keyed(payload, 200000)
    validity = (torch.rand(200000, generator=g, device=dev) < 0.3).to(torch.int32)
    hash_case(words + [validity], live, 1024, "validity word")
    words, live = keyed(ints((20000, 6)), 300000)
    hash_case(words, live, 32768, "6-word keys")
    words, live = keyed(ints((3000, 2)), 50000, 1.0)
    got = hashagg.build_hash_table(words, live, 1024)
    if not bool(got[3]):
        fail("hash_build: 3000 keys under cap 1024 did not raise overflow")
    hash_case(words, live, 1024, "n_groups > cap", got=got)


def hash_timed(dev, n: int) -> list:
    """Q3's largest hash shapes (n = 8 Mi by default): a build of n rows
    (n/8 distinct 2-word keys) into a join-sized table (cap = rows: 2^24
    slots, 192 MB, at 8 Mi), and a probe of n rows into it, half of them
    hits."""
    from trino_tpu_torch.ops.cuda import hashagg, hashjoin

    distinct, W = max(1, n // 8), 2
    g = torch.Generator(device=dev)
    g.manual_seed(37)
    base = torch.randint(-2**31, 2**31 - 1, (2 * distinct, W), generator=g, device=dev,
                         dtype=torch.int32)
    pick = torch.randint(0, distinct, (n,), generator=g, device=dev)
    words = [base[pick, i].contiguous() for i in range(W)]
    live = torch.ones(n, dtype=torch.bool, device=dev)
    cap = n
    T = hashagg.table_size(cap)
    got = hashagg.build_hash_table(words, live, cap, keep_keys=False)
    hash_case(words, live, cap, f"timed n={n}", got=got, keep_keys=False)
    table = got[1]
    b_ms = time_ms(lambda: hashagg.build_hash_table(words, live, cap, keep_keys=False), 2, 10)
    b_plain = time_ms(lambda: hashagg.plain_build_hash_table(words, live, cap, keep_keys=False), 1, 3)
    stacked = torch.stack(words, 1)
    b_lib = time_ms(lambda: torch.unique(stacked, dim=0, return_inverse=True), 1, 5)

    # probe rows: half from the built keys, half from keys never built
    hit = torch.rand(n, generator=g, device=dev) < 0.5
    q = torch.where(hit, torch.randint(0, distinct, (n,), generator=g, device=dev),
                    torch.randint(distinct, 2 * distinct, (n,), generator=g, device=dev))
    pwords = [base[q, i].contiguous() for i in range(W)]
    hit_share = probe_case(pwords, live, table, f"timed n={n}")
    if abs(hit_share - 0.5) > max(0.01, 3.0 / n ** 0.5):
        fail(f"hash_probe timed: hit share {hit_share}, expected ~0.5")
    p_ms = time_ms(lambda: hashjoin.probe_hash_table(pwords, live, table), 2, 10)
    p_plain = time_ms(lambda: hashjoin.plain_probe_hash_table(pwords, live, table), 1, 3)

    def packed(ws):
        return (ws[0].to(torch.int64) & 0xFFFFFFFF) | (ws[1].to(torch.int64) << 32)

    sorted_build = torch.unique(packed(words))  # sorted
    probe_keys = packed(pwords)
    p_lib = time_ms(lambda: torch.searchsorted(sorted_build, probe_keys), 2, 10)

    def bound(ws, lv):
        # stream: the words and the live byte in, the id out; past L2, one
        # random sector per distinct start slot the rows touch
        stream = n * (4 * W + 1) + 4 * n
        touched = torch.unique(hashagg.hash_words(ws, lv) & (T - 1)).numel()
        extra = SECTOR * touched if T * 4 * (1 + W) > L2_BYTES else 0
        return (stream + extra) / HBM_BYTES_PER_S * 1e3, stream + extra

    b_bound, b_bytes = bound(words, live)
    p_bound, p_bytes = bound(pwords, live)
    return [
        {"name": "hash_build", "ms": b_ms, "plain": b_plain, "lib": b_lib, "bound": b_bound,
         "bytes": b_bytes, "rows": n, "table_slots": T},
        {"name": "hash_probe", "ms": p_ms, "plain": p_plain, "lib": p_lib, "bound": p_bound,
         "bytes": p_bytes, "rows": n, "table_slots": T},
    ]


# -------------------------------------------- kernel 5: radix_histogram


def hist_case(u, live, prefix, shift, what: str, got=None) -> torch.Tensor:
    from trino_tpu_torch.ops.cuda import topk

    if got is None:
        got = topk.radix_histogram(u, live, prefix, shift)
    torch.cuda.synchronize()
    want = topk.plain_radix_histogram(u, live, prefix, shift)
    if not torch.equal(got, want):
        fail(f"radix_histogram {what} shift {shift}: kernel and plain version differ")
    return got


def radix_case(u, live, k: int, what: str):
    """Four passes of kernel 5, each held against its plain version at the
    prefix the selection reached; the threshold against an independent sort:
    the K-th largest live key (the smallest live key when K exceeds them)."""
    from trino_tpu_torch.ops.cuda import topk

    real = topk.radix_histogram
    passes = []

    def checked(uu, lv, prefix, shift):
        passes.append((prefix.clone(), shift))
        return hist_case(uu, lv, prefix, shift, what, got=real(uu, lv, prefix, shift))

    topk.radix_histogram = checked
    try:
        thr = int(topk.radix_topk_threshold(u, live, k))
    finally:
        topk.radix_histogram = real
    keys = (u.to(torch.int64) & 0xFFFFFFFF)[live]
    if keys.numel():
        want = int(torch.sort(keys, descending=True).values[min(k, keys.numel()) - 1])
        if thr != want:
            fail(f"radix select {what}: threshold {thr}, the {k}-th largest key is {want}")
    return passes


def radix_edges(dev) -> None:
    g = torch.Generator(device=dev)
    g.manual_seed(41)
    n = 100003

    def u32(x):
        return x.to(torch.int32)

    live = torch.rand(n, generator=g, device=dev) < 0.9
    rnd = u32(torch.randint(0, 2**32, (n,), generator=g, device=dev, dtype=torch.int64))
    prices = u32(torch.randint(90000, 10500000, (n,), generator=g, device=dev) + 2**31)
    radix_case(torch.empty(0, dtype=torch.int32, device=dev),
               torch.zeros(0, dtype=torch.bool, device=dev), 10, "empty")
    radix_case(rnd, torch.zeros(n, dtype=torch.bool, device=dev), 10, "all dead")
    radix_case(torch.full((n,), -7, dtype=torch.int32, device=dev), live, 10, "all keys equal")
    for k in (1, 10, 4096):
        radix_case(rnd, live, k, f"random keys k={k}")
        radix_case(prices, live, k, f"int32-mapped prices k={k}")
    few = torch.rand(n, generator=g, device=dev) < 0.00005
    radix_case(rnd, few, 10, "fewer live rows than K")


def radix_timed(dev, n: int) -> dict:
    """Four passes over n keys (64 Mi by default) shaped like the topn
    statement's: int32-mapped prices, so the first byte is one bin for every
    row."""
    from trino_tpu_torch.ops.cuda import topk

    g = torch.Generator(device=dev)
    g.manual_seed(43)
    u = (torch.randint(90000, 10500000, (n,), generator=g, device=dev) + 2**31).to(torch.int32)
    live = torch.rand(n, generator=g, device=dev) < 0.9
    passes = radix_case(u, live, 10, f"timed n={n}")
    k_ms = time_ms(lambda: [topk.radix_histogram(u, live, p, s) for p, s in passes], 2, 10)
    plain_ms = time_ms(lambda: [topk.plain_radix_histogram(u, live, p, s) for p, s in passes], 1, 3)
    masked = []
    for p, s in passes:
        byte, in_prefix = topk._byte_and_match(u, live, p, s)
        masked.append(torch.where(in_prefix, byte, 256))
    lib_ms = time_ms(lambda: [torch.bincount(m, minlength=257) for m in masked], 2, 10)
    in_bytes = n * 4 + n  # the keys and the live bytes, each read once
    return {"name": "radix_histogram", "ms": k_ms, "plain": plain_ms, "lib": lib_ms,
            "bound": (in_bytes + 256 * 8) / HBM_BYTES_PER_S * 1e3, "bytes": in_bytes,
            "rows": n, "passes": len(passes)}


# ----------------------------------------------- timed Q1-shaped 64 M rows


def q1_shaped_inputs(engine, n, dev):
    """Q1's seven scan columns at n rows, made on the device from a seed,
    plus the recipe of Q1's fused fragment over them."""
    from trino_tpu_torch.data.page import Dictionary
    from trino_tpu_torch.exec.compiler import fused_fragment
    from trino_tpu_torch.ops.cuda import fused
    from trino_tpu_torch.ops.expr import ColumnVal
    from trino_tpu_torch.plan.nodes import Aggregate, walk

    plan = engine.plan(Q01)
    agg = next(nd for nd in walk(plan) if isinstance(nd, Aggregate))
    scan, filters, keys, args, _ = fused_fragment(agg)
    g = torch.Generator(device=dev)
    g.manual_seed(20240601)

    def ints(lo, hi, dtype):
        return torch.randint(lo, hi, (n,), generator=g, device=dev, dtype=dtype)

    by_name = {
        "l_quantity": ints(100, 5001, torch.int64),
        "l_extendedprice": ints(90000, 10500000, torch.int64),
        "l_discount": ints(0, 11, torch.int64),
        "l_tax": ints(0, 9, torch.int64),
        "l_returnflag": ints(0, 3, torch.int32),
        "l_linestatus": ints(0, 2, torch.int32),
        "l_shipdate": ints(8036, 10562, torch.int32),
    }
    dicts = {
        "l_returnflag": Dictionary(np.asarray(["A", "N", "R"], dtype=object)),
        "l_linestatus": Dictionary(np.asarray(["F", "O"], dtype=object)),
    }
    cols = [
        ColumnVal(by_name[name], None, dicts.get(name), ty)
        for name, ty in zip(scan.column_names, scan.output_types)
    ]
    recipe, why = fused.plan_pipeline(
        cols, filters, keys, [a.fn for a in agg.aggs], args, [a.type for a in agg.aggs]
    )
    if recipe is None:
        fail(f"Q1 fragment declined by plan_pipeline: {why}")
    return recipe, cols, by_name


def kernels_phase(engine, dev, n_rows):
    from trino_tpu_torch.ops.cuda import fused
    from trino_tpu_torch.ops.cuda import segreduce as sr

    err1 = segreduce_edges(dev)
    err2 = fused_edges(dev)

    recipe, cols, by_name = q1_shaped_inputs(engine, n_rows, dev)
    n = n_rows

    # ---- kernel 2 at Q1's shape
    err2 = max(err2, fused_case(recipe, cols, None, f"Q1 shape n={n}"))
    k2_ms = time_ms(lambda: fused.run(recipe, cols, None), 2, 10)
    k2_plain = time_ms(lambda: fused.run_plain(recipe, cols, None), 1, 3)
    k2_in = distinct_bytes([cols[c].data if w == "data" else cols[c].valid
                            for w, c, _ in recipe.table])
    k2_out = len(recipe.streams) * 2 * recipe.domain * 8
    k2_bytes_ms = (k2_in + k2_out) / HBM_BYTES_PER_S * 1e3
    k2_ops = n * len(recipe.program)  # one 64-bit-class operation per instruction and row
    k2_ops_ms = k2_ops / FP64_OPS_PER_S * 1e3

    # ---- kernel 1: the reductions of a dictionary-key GROUP BY at the same
    # rows (6 groups): counts, int64 sums, a double sum, min/max
    seg = (by_name["l_returnflag"] * 2 + by_name["l_linestatus"]).to(torch.int32)
    live = by_name["l_shipdate"] <= 10471
    price_f = by_name["l_extendedprice"].to(torch.float64) / 100.0
    reds = [
        sr.SegRed("count", None, live),
        sr.SegRed("sum", by_name["l_quantity"], live),
        sr.SegRed("sum", by_name["l_extendedprice"], live),
        sr.SegRed("sum", price_f, live),
        sr.SegRed("min", by_name["l_shipdate"], live),
        sr.SegRed("max", by_name["l_extendedprice"], live),
    ]
    err1 = max(err1, segreduce_case(seg, reds, 6, f"Q1 shape n={n}"))
    k1_ms = time_ms(lambda: sr.fused_segment_reduce(seg, reds, 6), 2, 10)
    k1_plain = time_ms(lambda: sr.plain_segment_reduce(seg, reds, 6), 1, 3)
    seg64 = seg.to(torch.int64)
    acc = torch.zeros((7,), dtype=torch.int64, device=dev)
    qty = by_name["l_quantity"]
    k1_lib = time_ms(lambda: acc.zero_().index_add_(0, seg64, qty), 2, 10)
    k1_in = distinct_bytes([seg] + [r.values for r in reds] + [r.valid for r in reds])
    k1_out = len(reds) * 6 * 8
    k1_bytes_ms = (k1_in + k1_out) / HBM_BYTES_PER_S * 1e3
    k1_ops_ms = n * len(reds) / FP64_OPS_PER_S * 1e3
    def row(name, source, replaces, err, ms, plain, b_ms, o_ms, lib, in_bytes, rows=n, **extra):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": None, "max_abs_err": err,
            "max_err_over_sum_abs": REL_ERR[name], "ms": ms, "kernel_ms": ms,
            "plain_ms": plain, "bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "library_ms": lib, "rows": rows, "input_bytes": in_bytes, **extra,
        }

    # ---- kernels 3-5: edge cases, then Q3's largest shapes (integer
    # outputs, compared exactly: max_abs_err 0)
    hash_edges(dev)
    radix_edges(dev)
    build, probe = hash_timed(dev, n_rows // 8)
    radix = radix_timed(dev, n_rows)
    # the hash kernels do a few integer operations per slot visited and the
    # histogram a few per row: far under the card's rate, so bytes bound them
    return [
        row("segment_reduce", "trino_tpu_torch/csrc/segreduce.cu",
            "trino_tpu/ops/pallas/segreduce.py:107", err1, k1_ms, k1_plain,
            k1_bytes_ms, k1_ops_ms, k1_lib, k1_in),
        row("fused_pipeline", "trino_tpu_torch/csrc/fused_pipeline.cu",
            "trino_tpu/ops/pallas/fused.py:572", err2, k2_ms, k2_plain,
            k2_bytes_ms, k2_ops_ms, None, k2_in),
        row("hash_build", "trino_tpu_torch/csrc/hashagg.cu",
            "trino_tpu/ops/pallas/hashagg.py:167", 0.0, build["ms"], build["plain"],
            build["bound"], 0.0, build["lib"], build["bytes"], rows=build["rows"],
            table_slots=build["table_slots"]),
        row("hash_probe", "trino_tpu_torch/csrc/hashjoin.cu",
            "trino_tpu/ops/pallas/hashjoin.py:48", 0.0, probe["ms"], probe["plain"],
            probe["bound"], 0.0, probe["lib"], probe["bytes"], rows=probe["rows"],
            table_slots=probe["table_slots"]),
        row("radix_histogram", "trino_tpu_torch/csrc/topk.cu",
            "trino_tpu/ops/pallas/topk.py:80", 0.0, radix["ms"], radix["plain"],
            radix["bound"], 0.0, radix["lib"], radix["bytes"], rows=radix["rows"],
            passes=radix["passes"]),
    ]


# ------------------------------------------------ main path: numpy reference


def exact_sum(a: np.ndarray) -> int:
    """Sum of an integer array in python ints (no 64-bit wrap)."""
    return sum(int(c.sum(dtype=np.int64)) for c in np.array_split(a, max(1, len(a) // 65536)))


def dec(unscaled: int, scale: int) -> Decimal:
    return Decimal(unscaled).scaleb(-scale)


def reference_rows(li: dict, orders: dict, customer: dict) -> dict:
    """Q1, Q6, the min/max query, Q3 and the topn statement over the
    generated columns, in numpy and python ints — independent of the
    engine's code.  Sums are int64 (np.add.at), never float weights."""
    import datetime

    qty, price = li["l_quantity"].astype(np.int64), li["l_extendedprice"].astype(np.int64)
    disc, tax = li["l_discount"].astype(np.int64), li["l_tax"].astype(np.int64)
    ship = li["l_shipdate"].astype(np.int64)
    rf = np.asarray(li["l_returnflag"]).astype("U1")
    ls = np.asarray(li["l_linestatus"]).astype("U1")
    epoch = datetime.date(1970, 1, 1)
    day = lambda y, m, d: (datetime.date(y, m, d) - epoch).days

    keep = ship <= day(1998, 12, 1) - 90
    disc_price = price * (100 - disc)
    charge = disc_price * (100 + tax)
    q1 = []
    for f in np.unique(rf):
        for s in np.unique(ls):
            m = keep & (rf == f) & (ls == s)
            c = int(m.sum())
            if c == 0:
                continue
            q1.append((
                str(f), str(s), dec(exact_sum(qty[m]), 2), dec(exact_sum(price[m]), 2),
                dec(exact_sum(disc_price[m]), 4), dec(exact_sum(charge[m]), 6),
                exact_sum(qty[m]) / 100.0 / c, exact_sum(price[m]) / 100.0 / c,
                exact_sum(disc[m]) / 100.0 / c, c,
            ))
    m6 = (ship >= day(1994, 1, 1)) & (ship < day(1995, 1, 1)) & (disc >= 5) & (disc <= 7) & (qty < 2400)
    q6 = [(dec(exact_sum((price * disc)[m6]), 4) if m6.any() else None,)]
    qmm = []
    for f in np.unique(rf):
        m = rf == f
        qmm.append((
            str(f), (epoch + datetime.timedelta(days=int(ship[m].min()))).isoformat(),
            int(price[m].max()) / 100.0, int(m.sum()),
        ))

    # Q3: BUILDING customers' orders before the cut, their lines shipped after
    cut = day(1995, 3, 15)
    building = customer["c_custkey"][np.asarray(customer["c_mktsegment"]) == "BUILDING"]
    om = np.isin(orders["o_custkey"], building) & (orders["o_orderdate"] < cut)
    okey = orders["o_orderkey"][om]
    by_key = np.argsort(okey)
    okey_s = okey[by_key]
    odate_s = orders["o_orderdate"][om][by_key]
    oprio_s = orders["o_shippriority"][om][by_key]
    lm = (ship > cut) & np.isin(li["l_orderkey"], okey)
    keys, inv = np.unique(li["l_orderkey"][lm], return_inverse=True)
    revenue = np.zeros(len(keys), dtype=np.int64)
    np.add.at(revenue, inv, price[lm] * (100 - disc[lm]))  # scale 4
    at = np.searchsorted(okey_s, keys)
    date_k, prio_k = odate_s[at], oprio_s[at]
    top = np.lexsort((date_k, -revenue))[:10]
    q3 = [
        (int(keys[i]), dec(int(revenue[i]), 4),
         (epoch + datetime.timedelta(days=int(date_k[i]))).isoformat(), int(prio_k[i]))
        for i in top
    ]
    # the ten most expensive line items
    lk, ln = li["l_orderkey"].astype(np.int64), li["l_linenumber"].astype(np.int64)
    top = np.lexsort((ln, lk, -price))[:10]
    topn = [(int(lk[i]), int(ln[i]), int(price[i]) / 100.0) for i in top]
    return {"q01": q1, "q06": q6, "minmax": qmm, "q03": q3, "topn": topn}


def rows_match(got, want, what: str) -> None:
    if len(got) != len(want):
        fail(f"{what}: {len(got)} rows, expected {len(want)}")
    for r, (g, w) in enumerate(zip(got, want)):
        if len(g) != len(w):
            fail(f"{what}: row {r} has {len(g)} columns, expected {len(w)}")
        for c, (x, y) in enumerate(zip(g, w)):
            if isinstance(y, float) or isinstance(x, float):
                if x is None or y is None or abs(float(x) - float(y)) > 1e-9 * max(1.0, abs(float(y))):
                    fail(f"{what}: row {r} col {c}: {x!r} != {y!r} (rel 1e-9)")
            elif x != y:
                fail(f"{what}: row {r} col {c}: {x!r} != {y!r}")


def check_main_path_calls(engine, lines) -> list:
    """Run the main path's statements once more with every kernel wrapper
    shadowed: each call the engine makes is held against the kernel's plain
    version on the very tensors the engine passed, and timed there.  (These
    launches come after the main path's counts were read.)"""
    from trino_tpu_torch.ops.cuda import fused, hashagg, hashjoin, topk
    from trino_tpu_torch.ops.cuda import segreduce as sr

    real = {
        "reduce": sr.fused_segment_reduce, "run": fused.run,
        "build": hashagg.build_hash_table, "probe": hashjoin.probe_hash_table,
        "hist": topk.radix_histogram,
    }
    calls = []
    current = [""]

    def checked_reduce(seg, reds, G, **kw):
        got = real["reduce"](seg, reds, G, **kw)
        err = segreduce_case(seg, reds, G, f"main path {current[0]}", got=got)
        calls.append({
            "kernel": "segment_reduce", "statement": current[0], "rows": int(seg.shape[0]),
            "groups": int(G), "reductions": len(reds), "max_abs_err": err,
            "ms": time_ms(lambda: real["reduce"](seg, reds, G, **kw), 1, 5),
            "plain_ms": time_ms(lambda: sr.plain_segment_reduce(seg, reds, G), 1, 3),
        })
        return got

    def checked_run(recipe, cols, live):
        got = real["run"](recipe, cols, live)
        err = fused_case(recipe, cols, live, f"main path {current[0]}", got=got)
        calls.append({
            "kernel": "fused_pipeline", "statement": current[0],
            "rows": int(cols[recipe.table[0][1]].data.shape[0]),
            "groups": int(recipe.domain), "instructions": len(recipe.program),
            "streams": len(recipe.streams), "max_abs_err": err,
            "ms": time_ms(lambda: real["run"](recipe, cols, live), 1, 5),
            "plain_ms": time_ms(lambda: fused.run_plain(recipe, cols, live), 1, 3),
        })
        return got

    def checked_build(words, live, cap, **kw):
        got = real["build"](words, live, cap, **kw)
        hash_case(words, live, cap, f"main path {current[0]}", got=got,
                  keep_keys=kw.get("keep_keys", True), probe=real["probe"])
        calls.append({
            "kernel": "hash_build", "statement": current[0], "rows": int(live.shape[0]),
            "live_rows": int(live.sum()), "words": len(words), "cap": int(cap),
            "table_slots": got[1].size, "groups": int(got[2]), "max_abs_err": 0.0,
            "ms": time_ms(lambda: real["build"](words, live, cap, **kw), 1, 5),
            "plain_ms": time_ms(lambda: hashagg.plain_build_hash_table(words, live, cap, **kw), 1, 3),
        })
        return got

    def checked_probe(words, live, table):
        got = real["probe"](words, live, table)
        hits = probe_case(words, live, table, f"main path {current[0]}", got=got)
        calls.append({
            "kernel": "hash_probe", "statement": current[0], "rows": int(live.shape[0]),
            "live_rows": int(live.sum()), "words": len(words), "table_slots": table.size,
            "hit_share": hits, "max_abs_err": 0.0,
            "ms": time_ms(lambda: real["probe"](words, live, table), 1, 5),
            "plain_ms": time_ms(lambda: hashjoin.plain_probe_hash_table(words, live, table), 1, 3),
        })
        return got

    def checked_hist(u, live, prefix, shift):
        got = hist_case(u, live, prefix, shift, f"main path {current[0]}",
                        got=real["hist"](u, live, prefix, shift))
        calls.append({
            "kernel": "radix_histogram", "statement": current[0], "rows": int(u.shape[0]),
            "shift": shift, "counted": int(got.sum()), "max_abs_err": 0.0,
            "ms": time_ms(lambda: real["hist"](u, live, prefix, shift), 1, 5),
            "plain_ms": time_ms(lambda: topk.plain_radix_histogram(u, live, prefix, shift), 1, 3),
        })
        return got

    sr.fused_segment_reduce, fused.run = checked_reduce, checked_run
    hashagg.build_hash_table, hashjoin.probe_hash_table = checked_build, checked_probe
    topk.radix_histogram = checked_hist
    try:
        for variant, flag, name, sql, _, _ in lines:
            engine.execute(f"set session data_plane_kernels = {flag}")
            current[0] = f"{name}/{variant}"
            engine.query(sql)
    finally:
        sr.fused_segment_reduce, fused.run = real["reduce"], real["run"]
        hashagg.build_hash_table, hashjoin.probe_hash_table = real["build"], real["probe"]
        topk.radix_histogram = real["hist"]
    seen = {c["kernel"] for c in calls}
    if seen != set(KERNEL_NAMES):
        fail(f"main path calls reached {sorted(seen)}, not every kernel")
    return calls


def device_busy(engine, sql, runs: int = 5) -> dict:
    """Device time per statement from a torch.profiler trace of `runs` warm
    executions: busy ms (kernels and copies, summed) and the heaviest
    kernels.  A profiler that cannot trace the card yields nulls — the trace
    is a measurement, not a check."""
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                engine.query(sql)
            torch.cuda.synchronize()
        per_kernel = {}
        for ev in prof.key_averages():
            # device-side entries only: a host op's entry repeats the time of
            # the kernels it launched
            if ev.device_type != DeviceType.CUDA:
                continue
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = getattr(ev, "self_cuda_time_total", 0.0)
            if us:
                per_kernel[ev.key] = per_kernel.get(ev.key, 0.0) + us / 1e3 / runs
    except Exception as ex:  # noqa: BLE001 - any profiler fault means "not measured"
        return {"device_busy_ms": None, "top_kernels": [], "profiler": repr(ex)[:200]}
    if not per_kernel:
        return {"device_busy_ms": None, "top_kernels": [], "profiler": "no device time traced"}
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:4]
    return {"device_busy_ms": sum(per_kernel.values()),
            "top_kernels": [[k[:60], round(v, 4)] for k, v in top]}


KERNEL_NAMES = ("segment_reduce", "fused_pipeline", "hash_build", "hash_probe",
                "radix_histogram")


def kernel_counts() -> dict:
    from trino_tpu_torch.ops.cuda import fused, hashagg, hashjoin, topk
    from trino_tpu_torch.ops.cuda import segreduce as sr

    return dict(zip(KERNEL_NAMES, (sr.launches(), fused.launches(), hashagg.launches(),
                                   hashjoin.launches(), topk.launches())))


def reset_kernel_counts() -> None:
    from trino_tpu_torch.ops.cuda import fused, hashagg, hashjoin, topk
    from trino_tpu_torch.ops.cuda import segreduce as sr

    for mod in (sr, fused, hashagg, hashjoin, topk):
        mod.reset_launches()


def main_path_phase(engine, cpu_engine, scale):
    from trino_tpu_torch.connectors.tpch import tpch_data
    from trino_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    li = tpch_data("lineitem", scale)
    orders, customer = tpch_data("orders", scale), tpch_data("customer", scale)
    gen_s = time.perf_counter() - t0
    want = reference_rows(li, orders, customer)
    emit({"phase": "main_path", "step": "data", "scale": scale,
          "lineitem_rows": int(len(li["l_quantity"])), "orders_rows": int(len(orders["o_orderkey"])),
          "customer_rows": int(len(customer["c_custkey"])), "generate_s": round(gen_s, 3)})

    queries = {"q01": Q01, "q06": Q06, "minmax": QMM, "q03": Q03, "topn": TOPN}
    # (variant, data_plane_kernels, statements, dispatch the run must show:
    # (op, impl, at least this many times))
    variants = [
        ("fused", "true", ("q01", "q06"), [("fused_pipeline", "cuda", 1)]),
        ("operators", "false", ("q01", "q06"), [("segment_reduce", "cuda", 1)]),
        ("minmax", "true", ("minmax",), [("segment_reduce", "cuda", 1)]),
        ("hash", "true", ("q03",),
         [("join", "cuda", 2), ("group_by", "cuda", 1), ("segment_reduce", "cuda", 1)]),
        ("sort", "false", ("q03",),
         [("join", "sort", 2), ("group_by", "sort", 1), ("segment_reduce", "cuda", 1)]),
        ("radix", "true", ("topn",), [("topn", "cuda", 1)]),
    ]
    # every count to 0 just before the main path, read just after
    reset_kernel_counts()
    launches = {}
    lines = []
    for variant, flag, names, must in variants:
        engine.execute(f"set session data_plane_kernels = {flag}")
        for name in names:
            sql = queries[name]
            before = kernel_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rows = engine.query(sql)
            torch.cuda.synchronize()
            cold_ms = (time.perf_counter() - t0) * 1e3
            retries = list(engine.executor.last_retries)
            after = kernel_counts()
            rows_match(rows, want[name], f"{name}/{variant} on cuda vs numpy reference")
            events = kernels.events_for(engine.plan(sql))
            for op, impl, times in must:
                seen = sum(1 for e in events if e[0] == op and e[1] == impl)
                if seen < times:
                    fail(f"{name}/{variant}: dispatch events {events} show {op}/{impl} "
                         f"{seen} times, expected {times}")
            if name == "topn" and retries:
                fail(f"topn/{variant}: the first run re-ran for {retries}")
            launches[f"{name}/{variant}"] = {k: after[k] - before[k] for k in KERNEL_NAMES}
            lines.append((variant, flag, name, sql, cold_ms, events, retries))
    main_counts = kernel_counts()
    for k in KERNEL_NAMES:
        if main_counts[k] < 1:
            fail(f"main path never launched {k}: {main_counts}")

    # launches made from here on are not part of the main path's count
    emit({"phase": "main_path", "step": "kernel_calls",
          "calls": check_main_path_calls(engine, [ln[:6] for ln in lines])})

    # the same statements on the CPU engine, and warm timings
    for variant, flag, name, sql, cold_ms, events, retries in lines:
        cpu_engine.execute(f"set session data_plane_kernels = {flag}")
        engine.execute(f"set session data_plane_kernels = {flag}")
        t0 = time.perf_counter()
        cpu_rows = cpu_engine.query(sql)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        rows_match(cpu_rows, want[name], f"{name}/{variant} on cpu vs numpy reference")
        rows_match(engine.query(sql), cpu_rows, f"{name}/{variant} cuda vs cpu engine")
        warm, plan_ms, exec_ms, fetch_ms = [], [], [], []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.query(sql)
            torch.cuda.synchronize()
            warm.append((time.perf_counter() - t0) * 1e3)
        for _ in range(5):  # the same statement, layer by layer
            t0 = time.perf_counter()
            plan = engine.plan(sql)
            t1 = time.perf_counter()
            page = engine.executor.execute(plan)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            page.to_pylist()
            t3 = time.perf_counter()
            plan_ms.append((t1 - t0) * 1e3)
            exec_ms.append((t2 - t1) * 1e3)
            fetch_ms.append((t3 - t2) * 1e3)
        busy = device_busy(engine, sql)
        warm_ms = statistics.median(warm)
        idle = None if busy["device_busy_ms"] is None else 1.0 - busy["device_busy_ms"] / warm_ms
        emit({
            "phase": "main_path", "query": name, "variant": variant,
            "data_plane_kernels": flag, "rows": len(cpu_rows), "correct": True,
            "cold_ms": cold_ms, "warm_ms": warm_ms, "device_idle_share": idle, **busy,
            "plan_ms": statistics.median(plan_ms), "execute_ms": statistics.median(exec_ms),
            "fetch_ms": statistics.median(fetch_ms), "cpu_engine_ms": cpu_ms,
            "first_run_retries": retries,
            "launches": launches[f"{name}/{variant}"],
            "dispatch": [[op, impl] for op, impl, _ in events],
        })
    return main_counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--rows", type=int, default=64 * 1024 * 1024)
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false); "
              "this script drives the port on an NVIDIA GPU", file=sys.stderr)
        return 2

    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.ops.cuda import build
    from trino_tpu_torch.runtime.engine import Engine

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    smi_line = smi[0].strip() if smi else "unknown"
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi_line, "torch": torch.__version__, "cuda": torch.version.cuda})

    build.load_library(verbose=args.ptxas)
    info = build.last_build()
    if args.ptxas:
        print(info.get("log", ""), file=sys.stderr)
    emit({"phase": "build", "seconds": round(info["seconds"], 3), "cached": info["cached"],
          "library": "trino_tpu_torch/build/libtrino_kernels.so"})

    engine = Engine(device="cuda")
    engine.register_catalog("tpch", TpchConnector(args.scale))
    cpu_engine = Engine(device="cpu")
    cpu_engine.register_catalog("tpch", TpchConnector(args.scale))

    rows = kernels_phase(engine, dev, args.rows)
    torch.cuda.empty_cache()
    counts = main_path_phase(engine, cpu_engine, args.scale)
    for r in rows:
        r["launches"] = counts[r["name"]]
        if r["launches"] < 1:
            fail(f"kernel {r['name']} was never launched on the main path")

    print(smi_line, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
