#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card, nvcc and NVRTC

It builds the port's static CUDA kernels from trino_tpu_torch/csrc/ with
nvcc, generates and compiles (NVRTC) the fused-pipeline kernel of each recipe
it meets, holds each of the five kernels against its plain PyTorch version
on the card (edge cases, warp-level cases, then timed inputs at the main
path's largest shapes: a 64 Mi-row TPC-H lineitem column set through the
fused recipes of Q1 and Q6 and through 6- and 20-reduction GROUP BYs, an
8 Mi-row hash build and probe, the radix selection over 64 Mi keys — prices
at K = 10 and random keys at K = 4096), and drives the port's main path —
`Engine.query` on TPC-H scale factor 1: Q1, Q6 and a min/max group-by
through the segmented reduce and the fused pipeline, Q3 through the hash
build and probe (and through the sort paths with kernels off), the ten most
expensive line items through radix select, and three statements whose DATE
min/max is NULL (both kernel settings) — checking every result against an
independent numpy reference and against the same query on
`Engine(device="cpu")`.  The `tpch` phase then runs all 22 TPC-H queries
(their SQL read as text from tests/tpch_queries.py) and one GROUP BY over
lineitem with the variance / correlation family, bool_and, a percentile, two
count(DISTINCT) and approx_distinct, in the default setting and (Q18, the ten
queries that need CASE / IN / LIKE / substring / DISTINCT, and that GROUP BY)
with data_plane_kernels = false; Q18, q12, q14, q16, q22 and the GROUP BY
against numpy references, every other statement (and the GROUP BY) against
the CPU engine.  The
`tpcds` phase runs every statement of tests/tpcds_queries.py at TPC-DS scale
factor 1 (24 tables, generated from the seed by the copied generator) through
a second card engine, in the default setting and (the window, round and
concatenation statements) with data_plane_kernels = false, plus two window
checksums over TPC-H; each statement against itself in the other kernel
setting and, at SF 0.01, against `Engine(device="cpu")`; the checksums
against numpy.  The `statements` phase writes through `Engine.execute` into a
`memory` catalog on the TPC-H engine (CTAS of lineitem and orders, DELETE,
UPDATE, INSERT … SELECT, MERGE through the hash join, a rolled-back and a
committed transaction, PREPARE / EXECUTE, a view, an empty table, EXPLAIN
[ANALYZE] of a write), holds every step against numpy, checks that device
memory keeps one generation of each written table, and runs the sequence
again at SF 0.01 on the card and on `Engine(device="cpu")`, every result and
final table compared.  The `nested` phase runs arrays, JSON, lambdas, UNNEST
and MATCH_RECOGNIZE on the TPC-H engine (the words of `part.p_name` and
`orders.o_comment` through CROSS JOIN UNNEST(split(...)), lambdas per brand,
JSON paths over 500,000 payloads made from a seed in a `nested` memory
catalog, rising price runs per customer, a TopN over unnested words), each
against a python / numpy reference, then every statement of the port's
nested-value test files at SF 0.01 on the card and on `Engine(device="cpu")`.
The `spill` phase runs Q1, Q3, Q5, Q18 and a join narrowed by dynamic
filtering out of core (each budget set from the statement's own byte
estimate for 8 parts: fragments run slice by slice, exchanges parked on disk
as wire pages), against the same engine in memory (rows, warm_ms, peak
device bytes from a cold scan cache: the out-of-core peak of Q1 and Q18 must
be the lower) and Q1 / Q18 against numpy; then a reactive re-run after a
real device out-of-memory error under a memory cap (the run fails if the
re-run runs out too; only where the cap forces no error is one raised
through the executor), and the statements at
SF 0.01 card vs `Engine(device="cpu")`, both out of core.  The `fastpath`
phase prepares four templates (Q6-, Q1-, Q3- and TopN-shaped) and EXECUTEs
20 seeded bindings of each, every one against `Engine.query` with the
literals; a binding that hits the plan cache must add no NVRTC compile and
no learned-capacity entry, and the Q6 and Q1 shapes must run the fused
pipeline (kernel 2) with their bound values; then one batch window of 8 threads and the
fast-path test file's templates at SF 0.01, card vs CPU.  The `lake` phase
writes TPC-H into a temporary directory as Parquet (lineitem and orders in
row groups of 262,144 rows), ORC (lineitem, orders) and SQLite (customer,
nation), runs the 22 queries from Parquet through a fresh card engine (rows
equal the `tpch` phase's; each cold run split into file read, conversion,
encode, upload and execute), Q1 / Q6 over ORC, a join across the three
formats, Q1 and Q18 out of core over uneven row groups, Iceberg writes with
time travel, rollback and an EXECUTE across a commit, and GROUP BYs over an
8,388,608-row Faker table, each against its reference; then the same at SF
0.005, card vs CPU.  The `distributed` phase runs the 22 queries and the TopN
through `Engine(distributed=True, devices=["cuda:0"] * 4)` — every fragment
of the distributed plan as four tasks on the card, the exchanges in device
memory — each against the `tpch` phase's rows (Q3 and Q18 also with
data_plane_kernels = false), checks that a warm run uploads nothing and
reads no exchanged column to the host, holds the kernels' calls of Q18 and
the TopN against their plain versions, and at SF 0.01 holds EXPLAIN
ANALYZE row counts and the distributed test files' statements, card
against `Engine(device="cpu", distributed=True)`; on a machine with more
cards, Q3 and Q18 once more over every card.  The `cluster` phase boots the
multi-host runtime in this process — a coordinator and three workers over
loopback HTTP, `DistributedQueryRunner(devices=["cuda:0"] * 3)`, every task
on the card, pages exchanged as wire chunks — and runs Q1, Q3, Q6, Q13, Q18
and the TopN cold then warm (rows equal the `tpch` phase's), count(*)
through the client protocol, Q6 through the DB-API driver, a CTAS into a
memory catalog (against numpy), Q3 under task retry with a failure
injected, the kernels' calls of Q18 inside the workers' tasks against their
plain versions, then the cluster test file's statements and the EXPLAIN
ANALYZE row counts of Q3 at SF 0.01, card cluster against CPU cluster.  The
`resilience` phase drives the compile plane around kernel 2's NVRTC builds
(exec/compilesvc.py) through a second such cluster and through the TPC-H
engine: a cold Q1 build held pending past a 50 ms wait budget runs the
unfused path (kernel 1, no kernel-2 launch) and is named in QueryInfo, the
finished build swaps in on the next run (built on the service's pool,
launched from the query's threads, its totals against `fused.run_plain`),
COMPILE_FAIL three times opens the breaker, a 0.2 s deadline gives a typed
COMPILE_TIMEOUT; then a fresh engine starts Q18 at the capacity tiers a
first one stored (exec/capcache.py) and re-runs nothing; then, under
retry_policy=TASK, a gray slow producer outrun by hedged fetches (Q3), a
speculated straggler (Q6), a seeded chaos round (Q1, Q3, Q6, Q18; ERROR,
TIMEOUT, SLOW, EXCHANGE_DROP, CORRUPT), a worker drained mid-query with zero
retries (Q3) and a worker killed after its stage output finished (Q18).
Every result equals the `tpch` phase's, and no fallback may happen before
the phase or outside its armed faults.  The `governance` phase drives the
cluster's control plane on the card (three workers on `cuda:0` again, the
script holding tasks at the workers' fault hook, `TaskGate`): Q18 over node
pools of one and a half nominal reservations answers by revocation and
sliced re-execution with no kill (the revoke gives back the workers' cached
columns: `memory_allocated` must fall, and the run must peak under the
unrevoked run), the low-memory killer fails Q3 with CLUSTER_OUT_OF_MEMORY
while Q6 answers, corrupt frames of Q3 are refetched; Q18 over disk
budgets full of fragment memo commits by reclaim, a lost spool partition
drives a reproduction; a resource group of concurrency 1 queues Q1 behind
Q6 and cancels a queued Q3 without a trace, and the cluster memory limit
kills the query that buffers most, which answers out of core; the
coordinator killed mid-Q18 resumes from its journal (RESUME re-runs no
committed stage, RESTART re-runs them), a CTAS crashed at its intent
aborts and one crashed after its commit replays as a no-op; Q1, Q6 and
TOPN under split-driven scans at SF 1 and 0.1 (more morsels, the same
count of executed signatures, kernel-2 recipes and capacity tiers), a
worker killed mid-scan (one morsel retried, no committed morsel read
again); and two coordinators behind FleetRouter, one killed mid-Q18, the
other adopting it with no stage recomputed.  The `caches` phase runs a third
such cluster with the coordinator's result cache ON: Q1, Q3, Q6, Q18 and TOPN
executed warm and then served (a hit schedules no task, launches no kernel
and allocates nothing on the card), Q6 in another text hitting Q6's entry,
admission after the default number of recurrences, a cached aggregate over
the 600,108-row CTAS through DELETE, UPDATE, INSERT and MERGE (each next read
executes and equals numpy), an external Iceberg commit and a time-travel
read, the fragment memo seeding both leaves of a join (no scan) and missing
after a write, two Q18 in flight executing once, a coordinator restart
coming up cold, and PREPARE / EXECUTE (20 bindings against `Engine.query`) /
DEALLOCATE, a header-only client, DB-API binding and the EXPLAIN ANALYZE
EXECUTE footer through the protocol; then the result-cache test file's
statements at SF 0.01, card cluster against CPU cluster.
Each phase prints JSON lines; the last line of standard output is `{"ok":
true, "device": {...}}`.  Any failed build, launch or comparison ends the run with a
non-zero exit code.  Without a CUDA device it prints a message on stderr and
exits 2.

Options: `--scale F` (TPC-H scale factor of the main path, default 1.0),
`--rows N` (rows of the timed kernel inputs, default 64 Mi; the hash build
and probe take N/8), `--ptxas`
(print nvcc's per-kernel register / shared-memory report to stderr).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from decimal import Decimal
from pathlib import Path

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
# DATE min/max over no rows: NULL, not the empty group's sentinel
NULL_DATES = {
    "null_min": "select min(l_shipdate) from lineitem where l_quantity < 0",
    "null_max": "select max(o_orderdate) from orders where o_orderkey < 0",
    "null_left": "select c_custkey, min(o_orderdate) from customer left join orders "
                 "on c_custkey = o_custkey group by c_custkey order by c_custkey limit 10",
}


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
           "hash_probe": 0.0, "radix_select": 0.0}
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
            same = (torch.isinf(g) & torch.isinf(w) & (g == w)) | (torch.isnan(g) & torch.isnan(w))
            err = torch.where(same, torch.zeros_like(g), (g - w).abs())
            tol = sum_tolerance(n) * scales[i] + 1e-300
            if not bool((err <= tol).all()):
                fail(f"{what}[{i}]: max err {float(err.max())} > {tol}")
            top = float(err.max()) if err.numel() else 0.0
            worst = max(worst, top)
            note_rel("segment_reduce", top, scales[i])
        elif not torch.equal(g, w):
            fail(f"{what}[{i}]: integer results differ")
    return worst


def segreduce_case(seg, reds, G, what: str, got=None, plain_on_cpu=False) -> float:
    """Kernel 1 against its plain version on the same inputs (`got`: the
    kernel's result when the caller already has it).  `plain_on_cpu` runs
    the plain version on CPU copies: torch's CUDA scatter_reduce lets a
    later non-NaN overwrite a NaN, its CPU version (like the kernel) keeps
    the NaN."""
    from trino_tpu_torch.ops.cuda import segreduce as sr

    if got is None:
        got = sr.fused_segment_reduce(seg, reds, G)
    torch.cuda.synchronize()
    if plain_on_cpu:
        cpu = lambda t: None if t is None else t.cpu()  # noqa: E731
        want = sr.plain_segment_reduce(
            seg.cpu(), [sr.SegRed(r.op, cpu(r.values), cpu(r.valid)) for r in reds], G)
        got = [g.cpu() for g in got]
    else:
        want = sr.plain_segment_reduce(seg, reds, G)
    scales = []
    for r in reds:
        if r.values is not None and r.values.dtype.is_floating_point and r.op == "sum":
            finite = torch.nan_to_num(r.values.abs(), nan=0.0, posinf=0.0)  # NaN/inf: same slot
            scales.append(float(finite.sum()) if r.values.numel() else 0.0)
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

    # warp-level cases of the shared route, and the global route at q03's size
    n = 1_000_003
    vi = np.full(n, 2**32 - 1, np.int64)  # every limb sum carries past 2^32
    vi[::7] = -(2**62) - 12345
    vf = rng.normal(0, 1e3, size=n)
    vf[[3, 70_001]] = np.nan
    vf[[5, 9]] = (np.inf, -np.inf)
    valid = rng.random(n) < 0.8
    reds = [
        SegRed("count", None, None), SegRed("count", None, t(valid)),
        SegRed("sum", t(vi), t(valid)), SegRed("sum", t(vi.astype(np.int32)), None),
        SegRed("sum", t(vf), None), SegRed("min", t(vf), None), SegRed("max", t(vf), t(valid)),
        SegRed("min", t(vi), t(valid)), SegRed("max", t(vi), None),
    ]
    for G, seg, what in (
        (1, np.zeros(n, np.int32), "G=1"),
        (6, np.full(n, 3, np.int32), "G=6, every lane in one group"),
        (6, rng.integers(0, 6, size=n).astype(np.int32), "G=6, NaN and +-inf"),
        (1 << 20, rng.integers(0, 1 << 20, size=n).astype(np.int32), "G=2^20 global route"),
    ):
        worst = max(worst, segreduce_case(t(seg), reds, G, what, plain_on_cpu=True))
    return worst


# -------------------------------------------------- kernel 2: fused_pipeline


def fused_case(recipe, cols, live, what: str, got=None) -> float:
    """Kernel 2 against its plain version on the same inputs (`got`: the
    kernel's result when the caller already has it)."""
    from trino_tpu_torch.ops.cuda import fused, fused_codegen

    if got is None:
        fused_codegen.build(recipe, cols[0].data.device.index)
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


def fused_warp_edges(dev) -> float:
    """Kernel 2's warp-level cases: all-dead warps, a single live lane, all
    32 lanes of a warp in one group, 32 distinct codes in a warp, D = 512
    (the global route) and 128-bit carries inside one warp."""
    from trino_tpu_torch.data.page import Dictionary
    from trino_tpu_torch.data.types import BIGINT, BOOLEAN, DOUBLE, DecimalType
    from trino_tpu_torch.ops.cuda import fused
    from trino_tpu_torch.ops.expr import ColumnVal
    from trino_tpu_torch.plan.ir import Call, Const, FieldRef

    rng = np.random.default_rng(13)
    n = 8192
    d18, d38_2, d38_4 = DecimalType(18, 2), DecimalType(38, 2), DecimalType(38, 4)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def case(values, codes, domains, live, what, bounds=()):
        cols = [ColumnVal(t(values), None, None, d18)]
        for c, k in zip(codes, domains):
            cols.append(ColumnVal(t(c.astype(np.int32)), None,
                                  Dictionary(np.asarray([f"v{i:04d}" for i in range(k)], dtype=object)),
                                  None))
        A = FieldRef(0, d18)
        keys = [FieldRef(i + 1, None) for i in range(len(codes))]
        # filters on the cast to double at a literal that only a correctly
        # rounded x / 100 meets exactly
        as_f = Call("cast", (A,), DOUBLE)
        filters = [Call(op, (as_f, Const(c, DOUBLE)), BOOLEAN) for op, c in bounds]
        recipe, why = fused.plan_pipeline(
            cols, filters, keys, ["sum", "sum", "count_star", "sum"],
            [A, Call("mul", (A, A), d38_4), None, Call("cast", (A,), DOUBLE)],
            [d38_2, d38_4, BIGINT, DOUBLE])
        if recipe is None:
            fail(f"fused warp edge {what}: recipe declined: {why}")
        return fused_case(recipe, cols, None if live is None else t(live), what)

    big = np.full(n, 2**63 - 1, np.int64)
    big[1::2] = -(2**63)  # 128-bit sums and products that carry inside a warp
    vals = rng.integers(-10**15, 10**15, size=n).astype(np.int64)
    code6 = rng.integers(0, 6, size=n)
    worst = 0.0
    dead_warps = (np.arange(n) // 32) % 3 == 0
    one_lane = np.zeros(n, np.bool_)
    one_lane[37] = True
    for values, codes, domains, live, what in (
        (vals, [code6], [6], dead_warps, "two of three warps dead"),
        (vals, [code6], [6], one_lane, "a single live lane"),
        (vals, [np.zeros(n)], [6], None, "32 lanes in one group"),
        (vals, [], [], None, "D = 1"),
        (vals, [np.arange(n) % 32], [32], None, "32 distinct codes in a warp"),
        (vals, [np.arange(n) % 32, (np.arange(n) // 32) % 16], [32, 16], None, "D = 512"),
        (big, [np.zeros(n)], [6], None, "128-bit carries in one warp"),
        (big, [], [], None, "128-bit carries, D = 1"),
    ):
        worst = max(worst, case(values, codes, domains, live, what))
    cents = np.arange(-n // 2, n // 2, dtype=np.int64)
    worst = max(worst, case(cents, [code6], [6], None, "casts at a literal's rounding",
                            bounds=(("le", 0.07), ("ge", -12.34))))
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


def keys_in_runs(dev, n: int, W: int, seed: int, live_share: float, pool: int = 0,
                 orderkeys: bool = False):
    """n rows whose keys come in runs of equal keys, run lengths uniform in
    1..7 (lineitem's lines of one order are adjacent), live or dead a run at
    a time with `live_share`.  Each run takes a new random W-word key, or one
    of `pool` random keys (so equal keys also meet across warps), or with
    `orderkeys` TPC-H's sparse order key as its two int32 words.  Returns
    (words, live)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    lens = torch.randint(1, 8, (n // 3 + 8,), generator=g, device=dev)
    n_runs = int((torch.cumsum(lens, 0) < n).sum()) + 1
    run = torch.repeat_interleave(torch.arange(n_runs, device=dev), lens[:n_runs])[:n]
    if orderkeys:  # keys 1..7, 32..39, 64..71, ... as lo and hi words
        key = (run // 8) * 32 + run % 8 + 1
        words = [(key & 0xFFFFFFFF).to(torch.int32), (key >> 32).to(torch.int32)]
    else:
        keys = torch.randint(-2**31, 2**31 - 1, (pool or n_runs, W), generator=g, device=dev,
                             dtype=torch.int32)
        if pool:
            keys = keys[torch.randint(0, pool, (n_runs,), generator=g, device=dev)]
        words = [keys[run, i].contiguous() for i in range(W)]
    live = (torch.rand(n_runs, generator=g, device=dev) < live_share)[run]
    return words, live


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
    # keys in runs, as a join's build side over lineitem brings them: every
    # record size (8, 16 and 32 bytes), half the runs live; then runs drawing
    # from 1000 keys, so equal keys also race across warps
    for W in (1, 2, 3, 6):
        words, live = keys_in_runs(dev, 200003, W, 50 + W, 0.5)
        hash_case(words, live, 200003, f"runs W={W}")
    words, live = keys_in_runs(dev, 200003, 2, 57, 0.5, pool=1000)
    hash_case(words, live, 4096, "runs over 1000 keys")
    words, live = keyed(ints((3000, 2)), 50000, 1.0)
    got = hashagg.build_hash_table(words, live, 1024)
    if not bool(got[3]):
        fail("hash_build: 3000 keys under cap 1024 did not raise overflow")
    hash_case(words, live, 1024, "n_groups > cap", got=got)


def hash_timed_inputs(dev, n: int):
    """The timed hash shape: n build rows drawing n/8 distinct 2-word keys at
    random, all live, cap = n; n probe rows, half of them keys that were
    built and half keys that were not.  Returns (words, live, cap, pwords)."""
    distinct, W = max(1, n // 8), 2
    g = torch.Generator(device=dev)
    g.manual_seed(37)
    base = torch.randint(-2**31, 2**31 - 1, (2 * distinct, W), generator=g, device=dev,
                         dtype=torch.int32)
    pick = torch.randint(0, distinct, (n,), generator=g, device=dev)
    words = [base[pick, i].contiguous() for i in range(W)]
    live = torch.ones(n, dtype=torch.bool, device=dev)
    hit = torch.rand(n, generator=g, device=dev) < 0.5
    q = torch.where(hit, torch.randint(0, distinct, (n,), generator=g, device=dev),
                    torch.randint(distinct, 2 * distinct, (n,), generator=g, device=dev))
    pwords = [base[q, i].contiguous() for i in range(W)]
    return words, live, n, pwords


def hash_timed(dev, n: int) -> list:
    """Q3's largest hash shapes (n = 8 Mi by default): a build of n rows
    (n/8 distinct 2-word keys) into a join-sized table (cap = rows: 2^24
    slots, 256 MB of 16-byte records, at 8 Mi), and a probe of n rows into
    it, half of them hits."""
    from trino_tpu_torch.ops.cuda import hashagg, hashjoin

    words, live, cap, pwords = hash_timed_inputs(dev, n)
    W = len(words)
    T = hashagg.table_size(cap)
    got = hashagg.build_hash_table(words, live, cap, keep_keys=False)
    hash_case(words, live, cap, f"timed n={n}", got=got, keep_keys=False)
    table = got[1]
    b_ms = time_ms(lambda: hashagg.build_hash_table(words, live, cap, keep_keys=False), 2, 10)
    b_plain = time_ms(lambda: hashagg.plain_build_hash_table(words, live, cap, keep_keys=False), 1, 3)
    stacked = torch.stack(words, 1)
    b_lib = time_ms(lambda: torch.unique(stacked, dim=0, return_inverse=True), 1, 5)

    # probe rows: half from the built keys, half from keys never built
    hit_share = probe_case(pwords, live, table, f"timed n={n}")
    if abs(hit_share - 0.5) > max(0.01, 3.0 / n ** 0.5):
        fail(f"hash_probe timed: hit share {hit_share}, expected ~0.5")
    p_ms = time_ms(lambda: hashjoin.probe_hash_table(pwords, live, table), 2, 20)
    p_plain = time_ms(lambda: hashjoin.plain_probe_hash_table(pwords, live, table), 1, 3)

    def packed(ws):
        return (ws[0].to(torch.int64) & 0xFFFFFFFF) | (ws[1].to(torch.int64) << 32)

    sorted_build = torch.unique(packed(words))  # sorted
    probe_keys = packed(pwords)
    p_lib = time_ms(lambda: torch.searchsorted(sorted_build, probe_keys), 2, 20)

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


# ----------------------------------------------- kernel 5: radix_select


def radix_check(u, live, k: int, cap, got, what: str) -> None:
    """Kernel 5's selection `got` against its plain version on the same
    inputs: each pass's histogram at the prefix the selection reached, the
    threshold, and with `cap` the candidates' ids and `required` (past the
    cap, the kernel keeps some `cap` candidates: they are checked to be
    candidates, ascending)."""
    from trino_tpu_torch.ops.cuda import topk

    torch.cuda.synchronize()
    want = topk.plain_radix_select(u, live, k, cap)
    if int(got.threshold) != int(want.threshold):
        fail(f"radix_select {what}: threshold {int(got.threshold)}, plain {int(want.threshold)}")
    for p, (g, w) in enumerate(zip(got.hists, want.hists)):
        if not torch.equal(g, w):
            fail(f"radix_select {what}: pass {p + 1}'s histogram differs from the plain version's")
    if cap is None:
        return
    req = int(want.required)
    if int(got.required) != req:
        fail(f"radix_select {what}: required {int(got.required)}, plain {req}")
    m = min(req, cap)
    ids = got.ids[:m]
    if req <= cap:
        if not torch.equal(ids, want.ids[:m]):
            fail(f"radix_select {what}: candidate ids differ from the plain version's")
    elif not (bool((ids[1:] > ids[:-1]).all()) and bool(live[ids].all())
              and bool(((u[ids].to(torch.int64) & 0xFFFFFFFF) >= int(got.threshold)).all())):
        fail(f"radix_select {what}: the {cap} ids past the cap are not ascending candidates")


def radix_case(u, live, k: int, what: str, cap=None):
    """One call of kernel 5 held against its plain version, and the
    threshold against an independent sort: the K-th largest live key (the
    smallest live key when K exceeds them)."""
    from trino_tpu_torch.ops.cuda import topk

    got = topk.radix_select(u, live, k, cap)
    radix_check(u, live, k, cap, got, what)
    keys = (u.to(torch.int64) & 0xFFFFFFFF)[live]
    if keys.numel():
        want = int(torch.sort(keys, descending=True).values[min(k, keys.numel()) - 1])
        if int(got.threshold) != want:
            fail(f"radix select {what}: threshold {int(got.threshold)}, "
                 f"the {k}-th largest key is {want}")
    return got


def radix_edges(dev) -> None:
    g = torch.Generator(device=dev)
    g.manual_seed(41)
    n = 100003

    def u32(x):
        return x.to(torch.int32)

    live = torch.rand(n, generator=g, device=dev) < 0.9
    rnd = u32(torch.randint(0, 2**32, (n,), generator=g, device=dev, dtype=torch.int64))
    prices = u32(torch.randint(90000, 10500000, (n,), generator=g, device=dev) + 2**31)
    cap = 16384
    radix_case(torch.empty(0, dtype=torch.int32, device=dev),
               torch.zeros(0, dtype=torch.bool, device=dev), 10, "empty")
    radix_case(rnd, torch.zeros(n, dtype=torch.bool, device=dev), 10, "all dead", cap)
    # every key equal: the buffer cannot hold the chosen bin, and the
    # candidates overflow the cap
    radix_case(torch.full((n,), -7, dtype=torch.int32, device=dev), live, 10, "all keys equal", cap)
    for k in (1, 10, 4096):
        radix_case(rnd, live, k, f"random keys k={k}", cap)
        radix_case(prices, live, k, f"int32-mapped prices k={k}", cap)  # k=4096: past the buffer
    few = torch.rand(n, generator=g, device=dev) < 0.00005
    radix_case(rnd, few, 10, "fewer live rows than K", cap)
    # views that start inside their storage: unaligned head rows and live bytes
    for a, b in ((1, 3), (3, 2), (2, 0)):
        m = n - 3
        radix_case(rnd[a:a + m], live[b:b + m], 10, f"offset view {a}/{b}", cap)
        radix_case(prices[a:a + m], live[b:b + m], 4096, f"offset view {a}/{b} prices", cap)


def radix_timed_inputs(dev, n: int, kind: str):
    """(u, live, k) of a timed shape, made on the card from a seed: "prices"
    — n int32-mapped cent values, 90 % live, K = 10 (the topn statement's
    key); "random" — n random u32 keys, 90 % live, K = 4096."""
    g = torch.Generator(device=dev)
    if kind == "prices":
        g.manual_seed(43)
        u = (torch.randint(90000, 10500000, (n,), generator=g, device=dev) + 2**31).to(torch.int32)
        k = 10
    else:
        g.manual_seed(47)
        u = torch.randint(0, 2**32, (n,), generator=g, device=dev, dtype=torch.int64).to(torch.int32)
        k = 4096
    live = torch.rand(n, generator=g, device=dev) < 0.9
    return u, live, k


def radix_bound_ms(n: int) -> float:
    """The selection's bound: the keys and live bytes read once."""
    return (n * 5 + 256 * 8) / HBM_BYTES_PER_S * 1e3


def radix_timed(dev, n: int) -> dict:
    """The whole selection, `radix_topk_threshold(u, live, k)`, over n keys
    (64 Mi by default) at both timed shapes; beside it the plain selection,
    `torch.topk` (the one PyTorch call that yields the K-th largest; the
    dead rows are masked to -1 outside the timed window) and three
    `torch.bincount`s over the passes' masked digits."""
    from trino_tpu_torch.ops.cuda import topk

    out = {}
    for kind in ("prices", "random"):
        u, live, k = radix_timed_inputs(dev, n, kind)
        got = radix_case(u, live, k, f"timed {kind} n={n}")
        k_ms = time_ms(lambda: topk.radix_topk_threshold(u, live, k), 2, 20)
        plain_ms = time_ms(lambda: topk.plain_radix_select(u, live, k), 1, 3)
        keys = torch.where(live, u.to(torch.int64) & 0xFFFFFFFF, torch.full_like(u, -1, dtype=torch.int64))
        if int(torch.topk(keys, k).values[-1]) != int(got.threshold):
            fail(f"radix select timed {kind}: torch.topk disagrees")
        lib_ms = time_ms(lambda: torch.topk(keys, k).values[-1], 2, 10)
        del keys
        masked = []
        thr = int(got.threshold)
        for shift, bits in topk.DIGITS:
            prefix = torch.tensor(thr & ((0xFFFFFFFF << (shift + bits)) & 0xFFFFFFFF), device=dev)
            digit, in_prefix = topk._digit_and_match(u, live, prefix, shift)
            masked.append((torch.where(in_prefix, digit, 1 << bits), (1 << bits) + 1))
        bincount_ms = time_ms(lambda: [torch.bincount(m, minlength=b) for m, b in masked], 2, 10)
        del masked
        out[kind] = {"ms": k_ms, "plain": plain_ms, "lib": lib_ms, "bincount_ms": bincount_ms,
                     "bound": radix_bound_ms(n), "bytes": n * 5, "rows": n, "k": k,
                     "live_rows": int(live.sum())}
    return out


# --------------------------------------- timed shapes of kernels 1 and 2


def kernels_phase(engine, dev, n_rows):
    from trino_tpu_torch.ops.cuda import fused, fused_codegen
    from trino_tpu_torch.ops.cuda import segreduce as sr
    from trino_tpu_torch.tools import time_kernels as tk

    err1 = segreduce_edges(dev)
    err2 = max(fused_edges(dev), fused_warp_edges(dev))
    n = n_rows
    by_name = tk.lineitem_columns(n, dev)

    # ---- kernel 2 at Q1's and Q6's recipes: the first call compiles the
    # recipe's kernel (the cache was cleared at start-up)
    k2 = {}
    for qname, sql in (("q1", tk.Q01), ("q6", tk.Q06)):
        recipe, cols = tk.fused_inputs(engine, sql, by_name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fused_codegen.build(recipe, cols[0].data.device.index)
        got = fused.run(recipe, cols, None)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        info = fused_codegen.compile_info(recipe)
        if info.get("from") != "nvrtc":
            fail(f"kernel 2 {qname}: the first call did not compile its kernel ({info})")
        err2 = max(err2, fused_case(recipe, cols, None, f"{qname} shape n={n}", got=got))
        in_bytes = tk.fused_bytes(recipe, cols)
        k2[qname] = {
            "ms": time_ms(lambda: fused.run(recipe, cols, None), 2, 20),
            "plain": time_ms(lambda: fused.run_plain(recipe, cols, None), 1, 3),
            "bytes": in_bytes, "bytes_ms": in_bytes / HBM_BYTES_PER_S * 1e3,
            "ops_ms": n * len(recipe.program) / FP64_OPS_PER_S * 1e3,
            "compile_ms": info["compile_ms"], "first_call_ms": first_ms,
            "instructions": len(recipe.program), "streams": len(recipe.streams),
            "D": recipe.domain, "accumulation": fused_codegen.route_for(recipe)[0],
            "rows_per_thread": fused_codegen.generate(recipe).rows_per_thread,
            "ptxas": [ln.strip() for ln in info["log"].splitlines() if "registers" in ln or "spill" in ln],
        }
        del got

    # ---- kernel 1: the 6-reduction GROUP BY and q01's 20-reduction call
    k1 = {}
    for name, (seg, reds, G) in tk.segreduce_shapes(by_name).items():
        err1 = max(err1, segreduce_case(seg, reds, G, f"{name} n={n}"))
        in_bytes = tk.segreduce_bytes(seg, reds, G)
        k1[name] = {
            "ms": time_ms(lambda: sr.fused_segment_reduce(seg, reds, G), 2, 20),
            "plain": time_ms(lambda: sr.plain_segment_reduce(seg, reds, G), 1, 3),
            "bytes": in_bytes, "bytes_ms": in_bytes / HBM_BYTES_PER_S * 1e3,
            "ops_ms": n * len(reds) / FP64_OPS_PER_S * 1e3, "reductions": len(reds),
        }
    seg64 = (by_name["l_returnflag"] * 2 + by_name["l_linestatus"]).to(torch.int64)
    acc = torch.zeros((7,), dtype=torch.int64, device=dev)
    qty = by_name["l_quantity"]
    k1_lib = time_ms(lambda: acc.zero_().index_add_(0, seg64, qty), 2, 20)
    del by_name, seg64

    def row(name, source, replaces, err, ms, plain, b_ms, o_ms, lib, in_bytes, rows=n, **extra):
        return {
            **extra, "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": None, "max_abs_err": err,
            "max_err_over_sum_abs": REL_ERR[name], "ms": ms, "kernel_ms": ms,
            "plain_ms": plain, "bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "library_ms": lib, "rows": rows, "input_bytes": in_bytes,
        }

    # ---- kernels 3-5: edge cases, then Q3's largest shapes (integer
    # outputs, compared exactly: max_abs_err 0)
    hash_edges(dev)
    radix_edges(dev)
    build, probe = hash_timed(dev, n_rows // 8)
    radix = radix_timed(dev, n_rows)
    prices = radix["prices"]
    six, twenty = k1["segment_reduce_6"], k1["segment_reduce_20"]
    q1, q6 = k2["q1"], k2["q6"]
    # the hash kernels do a few integer operations per slot visited and the
    # selection a few per row: far under the card's rate, so bytes bound them
    return [
        row("segment_reduce", "trino_tpu_torch/csrc/segreduce.cu",
            "trino_tpu/ops/pallas/segreduce.py:107", err1, six["ms"], six["plain"],
            six["bytes_ms"], six["ops_ms"], k1_lib, six["bytes"], reductions=6,
            twenty_reductions={"ms": twenty["ms"], "plain_ms": twenty["plain"],
                               "bound_ms": max(twenty["bytes_ms"], twenty["ops_ms"]),
                               "input_bytes": twenty["bytes"]}),
        row("fused_pipeline", "trino_tpu_torch/csrc/fused_pipeline.cuh",
            "trino_tpu/ops/pallas/fused.py:572", err2, q1["ms"], q1["plain"],
            q1["bytes_ms"], q1["ops_ms"], None, q1["bytes"],
            generator="trino_tpu_torch/ops/cuda/fused_codegen.py",
            **{k: q1[k] for k in ("compile_ms", "first_call_ms", "instructions", "streams",
                                  "D", "accumulation", "rows_per_thread", "ptxas")},
            q6={"ms": q6["ms"], "plain_ms": q6["plain"],
                "bound_ms": max(q6["bytes_ms"], q6["ops_ms"]), "input_bytes": q6["bytes"],
                **{k: q6[k] for k in ("compile_ms", "first_call_ms", "instructions", "streams",
                                      "D", "accumulation", "ptxas")}}),
        row("hash_build", "trino_tpu_torch/csrc/hashagg.cu",
            "trino_tpu/ops/pallas/hashagg.py:167", 0.0, build["ms"], build["plain"],
            build["bound"], 0.0, build["lib"], build["bytes"], rows=build["rows"],
            table_slots=build["table_slots"]),
        row("hash_probe", "trino_tpu_torch/csrc/hashjoin.cu",
            "trino_tpu/ops/pallas/hashjoin.py:48", 0.0, probe["ms"], probe["plain"],
            probe["bound"], 0.0, probe["lib"], probe["bytes"], rows=probe["rows"],
            table_slots=probe["table_slots"], iterations=20),
        row("radix_select", "trino_tpu_torch/csrc/topk.cu",
            "trino_tpu/ops/pallas/topk.py:80", 0.0, prices["ms"], prices["plain"],
            prices["bound"], 0.0, prices["lib"], prices["bytes"], rows=prices["rows"],
            k=prices["k"], library="torch.topk", bincount_ms=prices["bincount_ms"],
            random_keys={key: radix["random"][key] for key in
                         ("ms", "plain", "lib", "bincount_ms", "bound", "rows", "k")}),
    ]


# ------------------------------------------------ main path: numpy reference


def exact_sum(a: np.ndarray) -> int:
    """Sum of an integer array in python ints (no 64-bit wrap)."""
    return sum(int(c.sum(dtype=np.int64)) for c in np.array_split(a, max(1, len(a) // 65536)))


def dec(unscaled: int, scale: int) -> Decimal:
    return Decimal(unscaled).scaleb(-scale)


def q1_reference(li: dict, keep=None, disc=None) -> list:
    """Q1 over the generated lineitem columns in python ints: over the rows
    of `keep` (default: Q1's own date predicate), with `disc` (scaled by
    100) in place of l_discount when given — the statements phase's table
    after its DELETE and UPDATE."""
    qty, price = li["l_quantity"].astype(np.int64), li["l_extendedprice"].astype(np.int64)
    disc = (li["l_discount"] if disc is None else disc).astype(np.int64)
    tax = li["l_tax"].astype(np.int64)
    ship = li["l_shipdate"].astype(np.int64)
    rf = np.asarray(li["l_returnflag"]).astype("U1")
    ls = np.asarray(li["l_linestatus"]).astype("U1")
    if keep is None:
        keep = ship <= _days(1998, 12, 1) - 90
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
    return q1


def reference_rows(li: dict, orders: dict, customer: dict) -> dict:
    """Q1, Q6, the min/max query, Q3 and the topn statement over the
    generated columns, in numpy and python ints — independent of the
    engine's code.  Sums are int64 (np.add.at), never float weights."""
    import datetime

    price = li["l_extendedprice"].astype(np.int64)
    qty, disc = li["l_quantity"].astype(np.int64), li["l_discount"].astype(np.int64)
    ship = li["l_shipdate"].astype(np.int64)
    rf = np.asarray(li["l_returnflag"]).astype("U1")
    epoch = datetime.date(1970, 1, 1)
    day = lambda y, m, d: (datetime.date(y, m, d) - epoch).days

    q1 = q1_reference(li)
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
    # the NULL-date statements: no rows match the first two; the first ten
    # customers' first order dates, NULL for a customer without orders
    null_left = []
    for c in np.sort(customer["c_custkey"])[:10]:
        d = orders["o_orderdate"][orders["o_custkey"] == c]
        null_left.append((int(c), (epoch + datetime.timedelta(days=int(d.min()))).isoformat()
                          if len(d) else None))
    return {"q01": q1, "q06": q6, "minmax": qmm, "q03": q3, "topn": topn,
            "null_min": [(None,)], "null_max": [(None,)], "null_left": null_left}


# ------------------------------------ the 22 TPC-H queries: numpy references

TPCH_FILE = Path(__file__).resolve().parent / "tests" / "tpch_queries.py"
# the ten queries that need CASE, IN, LIKE, substring or count(DISTINCT)
NEW_QUERIES = ("q02", "q08", "q09", "q12", "q13", "q14", "q16", "q19", "q20", "q22")
# the queries with a numpy reference: at full size the card's rows are held
# against it alone, not against the CPU engine too (the CPU engine's SF 1
# runs cost the script most of its time; tests run it at SF 0.01)
TPCH_NUMPY_ONLY = ("q12", "q14", "q16", "q18", "q22")
# timed warm runs per statement of the tpcds, nested and spill phases: one
# keeps the script inside its time limit on a slow host (after the CPU
# engine, those phases' repeated runs cost it most)
SHORT_RUNS = 1
# the variance and correlation family, bool_and, a percentile, two DISTINCT
# counts (two sorts) and a HyperLogLog in one grouped node.  bool_and's
# predicate is true in every row of the N groups and mixed in the A and R
# groups, so a bool_and built as max (or as a constant) gives other rows.
AGG = (
    "select l_returnflag, l_linestatus, stddev(l_quantity), var_pop(l_extendedprice), "
    "corr(l_quantity, l_extendedprice), bool_and(l_shipdate > date '1995-05-01'), "
    "approx_percentile(l_extendedprice, 0.5), count(distinct l_partkey), "
    "count(distinct l_suppkey), approx_distinct(l_orderkey) "
    "from lineitem group by l_returnflag, l_linestatus order by 1, 2"
)
AGG_MOMENTS = (2, 3, 4)  # the AGG columns whose tolerance is the moment bound
HLL_ERROR = 1.04 / 4096 ** 0.5  # the sketch's standard error (2^12 registers)


def tpch_queries() -> tuple:
    """(QUERIES, ORDERED) of tests/tpch_queries.py, read without importing
    the tests package."""
    ns: dict = {}
    exec(compile(TPCH_FILE.read_text(), str(TPCH_FILE), "exec"), ns)
    return ns["QUERIES"], ns["ORDERED"]


def _days(y: int, m: int, d: int) -> int:
    import datetime

    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


def _iso(days: int) -> str:
    import datetime

    return (datetime.date(1970, 1, 1) + datetime.timedelta(days=int(days))).isoformat()


def _strs(a) -> np.ndarray:
    return np.asarray(a, dtype=object).astype(str)


def q18_reference(li: dict, orders: dict, customer: dict, threshold: int = 300) -> list:
    """Orders whose lines hold more than `threshold` units, with their
    customer; sorted by (totalprice desc, orderdate), at most 100."""
    lk = li["l_orderkey"].astype(np.int64)
    keys, inv = np.unique(lk, return_inverse=True)
    qty = np.zeros(len(keys), dtype=np.int64)
    np.add.at(qty, inv, li["l_quantity"].astype(np.int64))
    big = qty > threshold * 100
    big_keys, big_qty = keys[big], qty[big]
    at = np.searchsorted(orders["o_orderkey"], big_keys)
    cust = orders["o_custkey"][at]
    cat = np.searchsorted(customer["c_custkey"], cust)
    price = orders["o_totalprice"][at].astype(np.int64)
    date = orders["o_orderdate"][at].astype(np.int64)
    order = np.lexsort((date, -price))[:100]
    names = _strs(customer["c_name"])
    return [
        (str(names[cat[i]]), int(cust[i]), int(big_keys[i]), _iso(date[i]),
         int(price[i]) / 100.0, dec(int(big_qty[i]), 2))
        for i in order
    ]


def q12_reference(li: dict, orders: dict) -> list:
    mode = _strs(li["l_shipmode"])
    ship, commit, receipt = (li[c].astype(np.int64) for c in
                             ("l_shipdate", "l_commitdate", "l_receiptdate"))
    m = (np.isin(mode, ["MAIL", "SHIP"]) & (commit < receipt) & (ship < commit)
         & (receipt >= _days(1994, 1, 1)) & (receipt < _days(1995, 1, 1)))
    at = np.searchsorted(orders["o_orderkey"], li["l_orderkey"][m])
    high = np.isin(_strs(orders["o_orderpriority"])[at], ["1-URGENT", "2-HIGH"])
    out = []
    for sm in sorted(set(mode[m])):
        k = mode[m] == sm
        out.append((sm, int((high & k).sum()), int((~high & k).sum())))
    return out


def q14_reference(li: dict, part: dict) -> list:
    """Exact in python ints until the final division."""
    ship = li["l_shipdate"].astype(np.int64)
    m = (ship >= _days(1995, 9, 1)) & (ship < _days(1995, 10, 1))
    rev = li["l_extendedprice"][m].astype(np.int64) * (100 - li["l_discount"][m].astype(np.int64))
    at = np.searchsorted(part["p_partkey"], li["l_partkey"][m])
    promo = np.char.startswith(_strs(part["p_type"])[at], "PROMO")
    return [(100 * exact_sum(rev[promo]) / exact_sum(rev),)]


def q16_reference(partsupp: dict, part: dict, supplier: dict) -> list:
    import re

    rx = re.compile("Customer.*Complaints", re.DOTALL)
    bad = supplier["s_suppkey"][[rx.search(c) is not None for c in _strs(supplier["s_comment"])]]
    at = np.searchsorted(part["p_partkey"], partsupp["ps_partkey"])
    brand = _strs(part["p_brand"])[at]
    ptype = _strs(part["p_type"])[at]
    size = part["p_size"][at].astype(np.int64)
    m = ((brand != "Brand#45") & ~np.char.startswith(ptype, "MEDIUM POLISHED")
         & np.isin(size, [49, 14, 23, 45, 19, 3, 36, 9])
         & ~np.isin(partsupp["ps_suppkey"], bad))
    groups: dict = {}
    for b, t, z, sk in zip(brand[m], ptype[m], size[m], partsupp["ps_suppkey"][m]):
        groups.setdefault((str(b), str(t), int(z)), set()).add(int(sk))
    rows = [(b, t, z, len(v)) for (b, t, z), v in groups.items()]
    return sorted(rows, key=lambda r: (-r[3], r[0], r[1], r[2]))


def q22_reference(customer: dict, orders: dict) -> list:
    code = np.asarray([p[:2] for p in _strs(customer["c_phone"])])
    bal = customer["c_acctbal"].astype(np.int64)
    in_set = np.isin(code, ["13", "31", "23", "29", "30", "18", "17"])
    pos = in_set & (bal > 0)
    total, count = exact_sum(bal[pos]), int(pos.sum())
    m = in_set & (bal * count > total) & ~np.isin(customer["c_custkey"], orders["o_custkey"])
    return [(c, int((code[m] == c).sum()), dec(exact_sum(bal[m][code[m] == c]), 2))
            for c in sorted(set(code[m]))]


def moment_tolerance(*cols) -> float:
    """Relative tolerance of a variance or correlation assembled from sums
    (ss/n - mean²): each sum of n terms may differ by 2·n·2^-53 of its own
    size between two addition orders, and the subtraction magnifies that by
    sum(x²)/(n·var(x)).  The bound is that product for the worst column."""
    worst = 0.0
    for x in cols:
        n, var = len(x), float(np.var(x))
        if n and var > 0:
            worst = max(worst, float(np.dot(x, x)) / (n * var) * 2 * n * 2.0**-53)
    return 4 * worst + 1e-12


def agg_reference(li: dict) -> tuple:
    """(rows, tolerance per row) of the AGG statement; approx_distinct's
    column holds the EXACT distinct count (the sketch is held within 4
    standard errors of it)."""
    rf, ls = _strs(li["l_returnflag"]), _strs(li["l_linestatus"])
    qty = li["l_quantity"].astype(np.int64) / 100.0
    price_c = li["l_extendedprice"].astype(np.int64)
    price = price_c / 100.0
    rows, tols = [], []
    for f in sorted(set(rf)):
        for s in sorted(set(ls[rf == f])):
            m = (rf == f) & (ls == s)
            x, p = qty[m], price[m]
            c = int(m.sum())
            srt = np.sort(price_c[m])
            rows.append((
                str(f), str(s), float(np.std(x, ddof=1)), float(np.var(p)),
                float(np.corrcoef(x, p)[0, 1]),
                bool(np.all(li["l_shipdate"][m] > _days(1995, 5, 1))),
                int(srt[int(np.floor(0.5 * (c - 1) + 0.5))]) / 100.0,
                len(np.unique(li["l_partkey"][m])), len(np.unique(li["l_suppkey"][m])),
                len(np.unique(li["l_orderkey"][m])),
            ))
            tols.append(moment_tolerance(x, p))
    return rows, tols


def tpch_reference_rows(t: dict) -> dict:
    li, orders, customer = t["lineitem"], t["orders"], t["customer"]
    return {
        "q18": q18_reference(li, orders, customer),
        "q12": q12_reference(li, orders),
        "q14": q14_reference(li, t["part"]),
        "q16": q16_reference(t["partsupp"], t["part"], t["supplier"]),
        "q22": q22_reference(customer, orders),
    }


def agg_rows_match(got, want, tols, what: str, hll_ref=None) -> None:
    """AGG rows: the moment columns within their derived tolerance; the
    HyperLogLog column within 4 standard errors of the exact count (and, with
    `hll_ref`, equal to that engine's estimate); every other column exact."""
    if len(got) != len(want):
        fail(f"{what}: {len(got)} rows, expected {len(want)}")
    for r, (g, w, tol) in enumerate(zip(got, want, tols)):
        for c, (x, y) in enumerate(zip(g, w)):
            if c in AGG_MOMENTS:
                if x is None or abs(x - y) > tol * max(abs(y), 1e-300):
                    fail(f"{what}: row {r} col {c}: {x!r} vs {y!r} (rel tolerance {tol:.3g})")
            elif c == len(g) - 1 and hll_ref is None:
                if abs(x - y) > 4 * HLL_ERROR * y:
                    fail(f"{what}: row {r}: approx_distinct {x} vs exact {y}: past 4 errors")
            elif c == len(g) - 1:
                if x != hll_ref[r][c]:
                    fail(f"{what}: row {r}: approx_distinct {x} != {hll_ref[r][c]}")
            elif x != y:
                fail(f"{what}: row {r} col {c}: {x!r} != {y!r}")


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


def check_main_path_calls(engine, lines, require_all: bool = True, select=None) -> list:
    """Run the main path's statements once more with every kernel wrapper
    shadowed: each call the engine makes is held against the kernel's plain
    version on the very tensors the engine passed, and timed there.  (These
    launches come after the main path's counts were read.)  `select`, where
    given, picks the calls to hold (it is asked on the calling thread); the
    others only run."""
    from trino_tpu_torch.ops.cuda import fused, hashagg, hashjoin, topk
    from trino_tpu_torch.ops.cuda import segreduce as sr
    from trino_tpu_torch.tools import time_kernels as tk

    def bound_ms(n_bytes: int) -> float:
        return n_bytes / HBM_BYTES_PER_S * 1e3

    def hash_bytes(words, live, table_slots: int) -> int:
        # words and live bytes in, one id out, and one 32-byte sector per
        # distinct start slot the live rows touch
        n = live.shape[0]
        touched = torch.unique(hashagg.hash_words(words, live)[live] & (table_slots - 1)).numel()
        return n * (4 * len(words) + 1) + 4 * n + SECTOR * touched

    real = {
        "reduce": sr.fused_segment_reduce, "run": fused.run,
        "build": hashagg.build_hash_table, "probe": hashjoin.probe_hash_table,
        "select": topk.radix_select,
    }
    calls = []
    current = [""]

    def skip() -> bool:
        return select is not None and not select()

    def checked_reduce(seg, reds, G, **kw):
        if skip():
            return real["reduce"](seg, reds, G, **kw)
        got = real["reduce"](seg, reds, G, **kw)
        err = segreduce_case(seg, reds, G, f"main path {current[0]}", got=got)
        calls.append({
            "kernel": "segment_reduce", "statement": current[0], "rows": int(seg.shape[0]),
            "groups": int(G), "reductions": len(reds), "max_abs_err": err,
            "bound_ms": bound_ms(tk.segreduce_bytes(seg, reds, G)),
            "ms": time_ms(lambda: real["reduce"](seg, reds, G, **kw), 1, 5),
            "plain_ms": time_ms(lambda: sr.plain_segment_reduce(seg, reds, G), 1, 3),
        })
        return got

    def checked_run(recipe, cols, live):
        if skip():
            return real["run"](recipe, cols, live)
        got = real["run"](recipe, cols, live)
        err = fused_case(recipe, cols, live, f"main path {current[0]}", got=got)
        calls.append({
            "kernel": "fused_pipeline", "statement": current[0],
            "rows": int(cols[recipe.table[0][1]].data.shape[0]),
            "groups": int(recipe.domain), "instructions": len(recipe.program),
            "streams": len(recipe.streams), "max_abs_err": err,
            "bound_ms": bound_ms(tk.fused_bytes(recipe, cols)
                                 + (0 if live is None else live.numel())),
            "ms": time_ms(lambda: real["run"](recipe, cols, live), 1, 5),
            "plain_ms": time_ms(lambda: fused.run_plain(recipe, cols, live), 1, 3),
        })
        return got

    def checked_build(words, live, cap, **kw):
        if skip():
            return real["build"](words, live, cap, **kw)
        got = real["build"](words, live, cap, **kw)
        hash_case(words, live, cap, f"main path {current[0]}", got=got,
                  keep_keys=kw.get("keep_keys", True), probe=real["probe"])
        calls.append({
            "kernel": "hash_build", "statement": current[0], "rows": int(live.shape[0]),
            "live_rows": int(live.sum()), "words": len(words), "cap": int(cap),
            "table_slots": got[1].size, "groups": int(got[2]), "max_abs_err": 0.0,
            "bound_ms": bound_ms(hash_bytes(words, live, got[1].size)),
            "ms": time_ms(lambda: real["build"](words, live, cap, **kw), 1, 5),
            "plain_ms": time_ms(lambda: hashagg.plain_build_hash_table(words, live, cap, **kw), 1, 3),
        })
        return got

    def checked_probe(words, live, table):
        if skip():
            return real["probe"](words, live, table)
        got = real["probe"](words, live, table)
        hits = probe_case(words, live, table, f"main path {current[0]}", got=got)
        calls.append({
            "kernel": "hash_probe", "statement": current[0], "rows": int(live.shape[0]),
            "live_rows": int(live.sum()), "words": len(words), "table_slots": table.size,
            "hit_share": hits, "max_abs_err": 0.0,
            "bound_ms": bound_ms(hash_bytes(words, live, table.size)),
            "ms": time_ms(lambda: real["probe"](words, live, table), 1, 5),
            "plain_ms": time_ms(lambda: hashjoin.plain_probe_hash_table(words, live, table), 1, 3),
        })
        return got

    def checked_select(u, live, k, cap=None):
        if skip():
            return real["select"](u, live, k, cap)
        got = real["select"](u, live, k, cap)
        radix_check(u, live, k, cap, got, f"main path {current[0]}")
        calls.append({
            "kernel": "radix_select", "statement": current[0], "rows": int(u.shape[0]),
            "live_rows": int(live.sum()), "k": k, "cap": cap, "required": int(got.required),
            # the live rows at or above the first digit's bin fit the buffer:
            # the later passes read only it
            "buffered": int(got.hists[0][int(got.threshold) >> 21:].sum())
            <= topk.buffer_entries(u.shape[0]),
            "max_abs_err": 0.0, "bound_ms": radix_bound_ms(u.numel()),
            "ms": time_ms(lambda: real["select"](u, live, k, cap), 1, 5),
            "plain_ms": time_ms(lambda: topk.plain_radix_select(u, live, k, cap), 1, 3),
        })
        return got

    sr.fused_segment_reduce, fused.run = checked_reduce, checked_run
    hashagg.build_hash_table, hashjoin.probe_hash_table = checked_build, checked_probe
    topk.radix_select = checked_select
    try:
        for variant, flag, name, sql, _, _ in lines:
            engine.execute(f"set session data_plane_kernels = {flag}")
            current[0] = f"{name}/{variant}"
            if sql.lstrip().lower().startswith("execute "):
                engine.execute(sql)  # a prepared statement's binding (fast path)
            else:
                engine.query(sql)
    finally:
        sr.fused_segment_reduce, fused.run = real["reduce"], real["run"]
        hashagg.build_hash_table, hashjoin.probe_hash_table = real["build"], real["probe"]
        topk.radix_select = real["select"]
    seen = {c["kernel"] for c in calls}
    if require_all and seen != set(KERNEL_NAMES):
        fail(f"main path calls reached {sorted(seen)}, not every kernel")
    return calls


def device_busy(engine, sql, runs: int = 5) -> dict:
    """Device time per statement from a torch.profiler trace of `runs` warm
    executions: busy ms (kernels and copies, summed) and the heaviest
    kernels."""
    return traced_busy(lambda: engine.query(sql), runs)


def traced_busy(fn, runs: int) -> dict:
    """Device time per call of fn() from a torch.profiler trace of `runs`
    calls.  Only the card's activity is traced, and its events are read
    raw: the host-op tree that key_averages() builds costs seconds per
    statement and adds nothing to a device-side sum.  A profiler that cannot
    trace the card yields nulls — the trace is a measurement, not a check;
    a fault of fn() itself is raised."""
    errors = []

    def guarded():
        try:
            fn()
        except BaseException as ex:
            errors.append(ex)
            raise

    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                guarded()
            torch.cuda.synchronize()
        per_kernel = {}
        for ev in prof.profiler.kineto_results.events():
            if ev.device_type() != DeviceType.CUDA:
                continue
            ms = ev.duration_ns() / 1e6 / runs
            if ms:
                per_kernel[ev.name()] = per_kernel.get(ev.name(), 0.0) + ms
    except Exception as ex:  # noqa: BLE001 - any profiler fault means "not measured"
        if errors:
            raise errors[0]
        return {"device_busy_ms": None, "top_kernels": [], "profiler": repr(ex)[:200]}
    if not per_kernel:
        return {"device_busy_ms": None, "top_kernels": [], "profiler": "no device time traced"}
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:4]
    return {"device_busy_ms": sum(per_kernel.values()),
            "top_kernels": [[k[:60], round(v, 4)] for k, v in top]}


KERNEL_NAMES = ("segment_reduce", "fused_pipeline", "hash_build", "hash_probe",
                "radix_select")


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


def unordered(rows) -> list:
    """Rows in a canonical order for statements without a total order (floats
    rounded in the key only, so two engines' last bits cannot reorder ties)."""
    def key(r):
        return tuple((0, round(v, 6)) if isinstance(v, float) else (1, repr(v)) for v in r)
    return sorted(rows, key=key)


def rows_agree(got, want, name, what, ordered=None, agg_tols=None, hll_ref=None) -> None:
    """`got` against `want` as the statement requires: AGG by agg_rows_match,
    a statement without a total order in canonical order, the rest row by
    row."""
    if name == "agg":
        agg_rows_match(got, want, agg_tols, what, hll_ref=hll_ref)
    elif ordered is not None and not ordered.get(name, True):
        rows_match(unordered(got), unordered(want), what)
    else:
        rows_match(got, want, what)


def measure_lines(engine, cpu_engine, lines, want, launches, phase, runs,
                  ordered=None, agg_tols=None) -> None:
    """For each statement the main path ran: the same statement on the CPU
    engine (held against the numpy reference where there is one, and the
    card's rows against it), `runs` warm runs, `runs` runs layer by layer, a
    profiled set of `runs`; one JSON line each.  The CPU engine runs each
    distinct statement once, in the first variant that has it: a later
    variant (the card with kernels off) is held against those rows — but
    AGG's, whose approx_distinct the card must match exactly, in each
    setting."""
    cpu_seen: dict = {}  # statement -> (rows, the variant whose CPU run made them)
    for variant, flag, name, sql, cold_ms, events, retries in lines:
        engine.execute(f"set session data_plane_kernels = {flag}")
        cpu_ms = None
        key = (sql, flag) if name == "agg" else sql
        if key in cpu_seen:
            cpu_rows, cpu_variant = cpu_seen[key]
        elif phase == "tpch" and name in TPCH_NUMPY_ONLY:
            cpu_rows, cpu_variant = want[name], "numpy"
            cpu_seen[key] = (cpu_rows, cpu_variant)
        else:
            cpu_engine.execute(f"set session data_plane_kernels = {flag}")
            t0 = time.perf_counter()
            cpu_rows = cpu_engine.query(sql)
            cpu_ms = (time.perf_counter() - t0) * 1e3
            cpu_variant = variant
            cpu_seen[key] = (cpu_rows, variant)
        rows = engine.query(sql)
        what = f"{name}/{variant}"
        if name in want and cpu_ms is not None:
            rows_agree(cpu_rows, want[name], name, f"{what} on cpu vs numpy reference",
                       ordered, agg_tols)
        rows_agree(rows, cpu_rows, name, f"{what} cuda vs cpu engine", ordered, agg_tols,
                   hll_ref=cpu_rows)
        timing = statement_timing(engine, sql, runs)
        if phase == "tpch" and variant == "tpch":
            TPCH_WARM_MS[name] = timing["warm_ms"]  # the distributed phase's baseline
        emit({
            "phase": phase, "query": name, "variant": variant,
            "data_plane_kernels": flag, "rows": len(cpu_rows), "correct": True,
            "cold_ms": cold_ms, **timing, "cpu_engine_ms": cpu_ms,
            "cpu_rows_of": cpu_variant,
            "first_run_retries": retries,
            "launches": launches[what],
            "dispatch": [[op, impl] for op, impl, _ in events],
        })


def statement_timing(engine, sql, runs) -> dict:
    """`runs` warm runs, one run layer by layer and one profiled run of one
    statement on the card (`warm_ms` the median of the warm runs)."""
    warm, plan_ms, exec_ms, fetch_ms = [], [], [], []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.query(sql)
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t0) * 1e3)
    for _ in range(1):  # the same statement, layer by layer
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
    busy = device_busy(engine, sql, 1)
    warm_ms = statistics.median(warm)
    idle = None if busy["device_busy_ms"] is None else 1.0 - busy["device_busy_ms"] / warm_ms
    return {
        "warm_ms": warm_ms, "device_idle_share": idle, **busy,
        "plan_ms": statistics.median(plan_ms), "execute_ms": statistics.median(exec_ms),
        "fetch_ms": statistics.median(fetch_ms),
    }


def run_lines(engine, queries, variants, want, ordered=None, agg_tols=None, keep=None):
    """Run each variant's statements once on the card (the path whose
    launches are counted): rows against the numpy reference where there is
    one, the dispatch events each run must show, launches per statement.
    `keep`, where given, takes each run's rows by "name/variant".  Returns
    (lines, launches)."""
    from trino_tpu_torch.ops import kernels

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
            what = f"{name}/{variant}"
            if name in want:
                rows_agree(rows, want[name], name, f"{what} on cuda vs numpy reference",
                           ordered, agg_tols)
            events = kernels.events_for(engine.plan(sql))
            for op, impl, times in must:
                seen = sum(1 for e in events if e[0] == op and e[1] == impl)
                if seen < times:
                    fail(f"{what}: dispatch events {events} show {op}/{impl} "
                         f"{seen} times, expected {times}")
            if name == "topn" and retries:
                fail(f"topn/{variant}: the first run re-ran for {retries}")
            launches[what] = {k: after[k] - before[k] for k in KERNEL_NAMES}
            if keep is not None:
                keep[what] = rows
            lines.append((variant, flag, name, sql, cold_ms, events, retries))
    return lines, launches


def main_path_phase(engine, cpu_engine, scale):
    from trino_tpu_torch.connectors.tpch import tpch_data

    t0 = time.perf_counter()
    li = tpch_data("lineitem", scale)
    orders, customer = tpch_data("orders", scale), tpch_data("customer", scale)
    gen_s = time.perf_counter() - t0
    want = reference_rows(li, orders, customer)
    emit({"phase": "main_path", "step": "data", "scale": scale,
          "lineitem_rows": int(len(li["l_quantity"])), "orders_rows": int(len(orders["o_orderkey"])),
          "customer_rows": int(len(customer["c_custkey"])), "generate_s": round(gen_s, 3)})

    queries = {"q01": Q01, "q06": Q06, "minmax": QMM, "q03": Q03, "topn": TOPN, **NULL_DATES}
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
        ("nulls", "true", tuple(NULL_DATES), []),
        ("nulls_operators", "false", tuple(NULL_DATES), []),
    ]
    # every count to 0 just before the main path, read just after
    reset_kernel_counts()
    lines, launches = run_lines(engine, queries, variants, want)
    main_counts = kernel_counts()
    for k in KERNEL_NAMES:
        if main_counts[k] < 1:
            fail(f"main path never launched {k}: {main_counts}")

    # launches made from here on are not part of the main path's count
    emit({"phase": "main_path", "step": "kernel_calls",
          "calls": check_main_path_calls(engine, [ln[:6] for ln in lines])})

    # the same statements on the CPU engine, and warm timings
    measure_lines(engine, cpu_engine, lines, want, launches, "main_path", 5)
    return main_counts


def tpch_phase(engine, cpu_engine, scale):
    """The 22 TPC-H queries and the AGG statement through `Engine.query` in
    the default kernel setting (`tpch`), and Q18, NEW_QUERIES and AGG with
    data_plane_kernels = false
    (`tpch_operators`); Q18, q12, q14, q16, q22 and AGG against numpy, every
    other statement (and AGG) against the CPU engine.  Returns (the path's launch counts,
    the card's rows of each query in the default setting)."""
    from trino_tpu_torch.connectors.tpch import tpch_data

    queries, ordered = tpch_queries()
    t0 = time.perf_counter()
    tables = {n: tpch_data(n, scale) for n in
              ("lineitem", "orders", "customer", "part", "partsupp", "supplier")}
    gen_s = time.perf_counter() - t0
    want = tpch_reference_rows(tables)
    want["agg"], agg_tols = agg_reference(tables["lineitem"])
    emit({"phase": "tpch", "step": "data", "scale": scale, "generate_s": round(gen_s, 3),
          "rows": {n: int(len(next(iter(t.values())))) for n, t in tables.items()}})
    del tables
    all22 = tuple(sorted(queries))
    queries = dict(queries, agg=AGG)
    q16 = [("segment_reduce", "cuda", 1)]
    agg = [("group_by", "sort", 1), ("segment_reduce", "cuda", 1)]
    paths = (
        # Q18: the 1.5 M-group GROUP BY l_orderkey through the hash table,
        # the IN semi-join through the probe
        ("tpch", "true", all22 + ("agg",),
         {"q18": [("group_by", "cuda", 1), ("join", "cuda", 1)], "q16": q16, "agg": agg}),
        ("tpch_operators", "false", ("q18",) + NEW_QUERIES + ("agg",), {"q16": q16, "agg": agg}),
    )
    # one variant entry per statement: the dispatch each must show differs
    variants = [(variant, flag, (name,), must.get(name, []))
                for variant, flag, names, must in paths for name in names]
    # every count to 0 just before the path, read just after
    reset_kernel_counts()
    kept = {}
    lines, launches = run_lines(engine, queries, variants, want, ordered, agg_tols, kept)
    counts = kernel_counts()
    for k in ("segment_reduce", "hash_build", "hash_probe"):
        if counts[k] < 1:
            fail(f"tpch path never launched {k}: {counts}")
    # Q18's hash build (6 M rows into ~1.5 M groups) and the kernel-1 call of
    # AGG that carries the DISTINCT counts and the moment sums, held against
    # their plain versions on the engine's own tensors
    emit({"phase": "tpch", "step": "kernel_calls", "calls": check_main_path_calls(
        engine, [ln[:6] for ln in lines if ln[0] == "tpch" and ln[2] in ("q18", "agg")],
        require_all=False)})
    measure_lines(engine, cpu_engine, lines, want, launches, "tpch", 3, ordered, agg_tols)
    return counts, {name: kept[f"{name}/tpch"] for name in all22}


# ------------------------------------------------ TPC-DS and window checksums

TPCDS_FILE = Path(__file__).resolve().parent / "tests" / "tpcds_queries.py"
# the 15 window statements and the four that need round / concat
TPCDS_OPERATOR_QUERIES = (
    "q12", "q20", "q36", "q44", "q47", "q49", "q51", "q53", "q57", "q63", "q67", "q70",
    "q86", "q89", "q98", "q02", "q78", "q05", "q84",
)
TPCDS_CROSS_SCALE = 0.01  # the card engine against Engine(device="cpu") at this scale
# statements left out at the phase's scale, each for a fault the JAX package
# shares (the same plan from `Engine.explain`, the same generated data); they
# run at their cross-check scale only
TPCDS_SKIPPED = {
    "q04": "the generator's c_customer_id keeps 15 of 16 digits, so ten customers share "
           "an id and q04's six-way join on customer_id grows by ~10x per join "
           "(out of the card's 80 GB at SF 1)",
    "q72": "the join order joins catalog_sales to inventory on the item alone "
           "(~1e9 rows at SF 1) before the week equality",
    "q85": "the join order joins customer_demographics to itself on education and "
           "marital status first: a near-cross product (~1e11 rows at SF 1)",
}
# q85's near-cross product is 2.6e8 rows at SF 0.01 (40 GB on the host engine)
TPCDS_CROSS = {"q85": 0.002}
# ORDER BY ... LIMIT that is not total (stores and items share names and ids
# in the generated data): only the first k columns — the sort keys — are
# determined, so only they are compared
TPCDS_TIED = {"q59": 3, "q65": 2}
# window checksums over TPC-H SF 1, held against the numpy references below
W1 = (
    "select count(*), sum(rn), sum(rk), sum(run), sum(rn * rk) from ("
    "select row_number() over (partition by o_custkey order by o_orderdate, o_orderkey) as rn, "
    "rank() over (partition by o_custkey order by o_orderdate) as rk, "
    "sum(o_totalprice) over (partition by o_custkey order by o_orderdate, o_orderkey "
    "rows unbounded preceding) as run from orders)"
)
W2 = (
    "select count(*), sum(rk), sum(lag_pk), count(lag_pk), sum(aq) from ("
    "select rank() over (partition by l_orderkey order by l_extendedprice desc) as rk, "
    "lag(l_partkey) over (partition by l_orderkey order by l_linenumber) as lag_pk, "
    "avg(l_quantity) over (partition by l_suppkey) as aq from lineitem)"
)


def tpcds_queries() -> tuple:
    """(QUERIES, ORDERED) of tests/tpcds_queries.py, read without importing
    the tests package."""
    ns: dict = {}
    exec(compile(TPCDS_FILE.read_text(), str(TPCDS_FILE), "exec"), ns)
    return ns["QUERIES"], ns["ORDERED"]


def _run_starts(*keys) -> np.ndarray:
    """For rows sorted by `keys`, the index of the first row of each row's
    run of equal keys."""
    n = len(keys[0])
    new = np.zeros(n, dtype=bool)
    new[:1] = True
    for k in keys:
        new[1:] |= k[1:] != k[:-1]
    return np.maximum.accumulate(np.where(new, np.arange(n), 0))


def w1_reference(orders: dict) -> list:
    """W1 in numpy: row_number, rank and the running sum per customer, the
    sums exact in python ints until the running sums' total."""
    cust = orders["o_custkey"].astype(np.int64)
    date = orders["o_orderdate"].astype(np.int64)
    key = orders["o_orderkey"].astype(np.int64)
    price = orders["o_totalprice"].astype(np.int64)
    order = np.lexsort((key, date, cust))
    cust, date, price = cust[order], date[order], price[order]
    i = np.arange(len(cust))
    rn = i - _run_starts(cust) + 1
    rk = _run_starts(cust, date) - _run_starts(cust) + 1
    running = np.cumsum(price)  # cents; the total stays far below 2^63
    start = _run_starts(cust)
    run = running - np.where(start > 0, running[start - 1], 0)
    return [(len(cust), exact_sum(rn), exact_sum(rk), exact_sum(run) / 100.0,
             exact_sum(rn * rk))]


def w2_reference(li: dict) -> list:
    """W2 in numpy: rank by price within an order, the previous line's part
    and the supplier's mean quantity on every line, folded into sums."""
    ok = li["l_orderkey"].astype(np.int64)
    price = li["l_extendedprice"].astype(np.int64)
    order = np.lexsort((-price, ok))
    oks, prs = ok[order], price[order]
    rk = _run_starts(oks, prs) - _run_starts(oks) + 1
    order = np.lexsort((li["l_linenumber"].astype(np.int64), ok))
    oks, pk = ok[order], li["l_partkey"].astype(np.int64)[order]
    has_prev = np.zeros(len(oks), dtype=bool)
    has_prev[1:] = oks[1:] == oks[:-1]
    lag = pk[:-1][has_prev[1:]]
    # every line carries its supplier's mean: the sum over lines is the sum
    # over suppliers of count * mean, i.e. the total quantity
    qty = li["l_quantity"].astype(np.int64)
    return [(len(ok), exact_sum(rk), exact_sum(lag), int(has_prev.sum()),
             exact_sum(qty) / 100.0)]


def tied_rows_agree(got, want, name, what, ordered) -> None:
    """rows_agree, except for a statement of TPCDS_TIED: there only its
    sort-key columns are held."""
    if name in TPCDS_TIED:
        k = TPCDS_TIED[name]
        got, want = [r[:k] for r in got], [r[:k] for r in want]
    rows_agree(got, want, name, what, ordered)


def tpcds_phase(engine, scale):
    """Every statement of tests/tpcds_queries.py through `Engine.query` on
    the card at `scale` in the default setting (`tpcds`), the window /
    round / concat statements with data_plane_kernels = false
    (`tpcds_operators`), and the window checksums W1 and W2 over the TPC-H
    engine.  Each statement is held against the same statement in the other
    kernel setting on the card, and against Engine(device="cpu") (kernels
    off: sort joins and GROUP BYs) with a card engine at TPCDS_CROSS_SCALE;
    W1 and W2 against numpy.  Returns the path's launch counts."""
    from trino_tpu_torch.connectors.tpch import tpch_data
    from trino_tpu_torch.connectors.tpcds import TPCDS_SCHEMAS, TpcdsConnector, tpcds_data
    from trino_tpu_torch.runtime.engine import Engine

    queries, ordered = tpcds_queries()
    t0 = time.perf_counter()
    rows = {t: int(len(next(iter(tpcds_data(t, scale).values())))) for t in sorted(TPCDS_SCHEMAS)}
    gen_s = time.perf_counter() - t0
    want = {"w1": w1_reference(tpch_data("orders", scale)),
            "w2": w2_reference(tpch_data("lineitem", scale))}
    emit({"phase": "tpcds", "step": "data", "scale": scale, "generate_s": round(gen_s, 3),
          "tables": len(rows), "rows": rows, "cross_scale": TPCDS_CROSS_SCALE,
          "cross_scale_of": TPCDS_CROSS, "skipped_at_scale": TPCDS_SKIPPED,
          "sort_keys_only": TPCDS_TIED})

    def ds_engine(device, sf):
        e = Engine(device=device, default_catalog="tpcds")
        e.register_catalog("tpcds", TpcdsConnector(sf))
        return e

    ds = ds_engine("cuda", scale)
    # (card engine, host engine with kernels off) per cross-check scale
    cross = {}
    for sf in {TPCDS_CROSS_SCALE, *TPCDS_CROSS.values()}:
        card, host = ds_engine("cuda", sf), ds_engine("cpu", sf)
        host.execute("set session data_plane_kernels = false")
        cross[sf] = (card, host)

    def against_host(name, sql, flag) -> dict:
        sf = TPCDS_CROSS.get(name, TPCDS_CROSS_SCALE)
        card, host = cross[sf]
        card.execute(f"set session data_plane_kernels = {flag}")
        small = card.query(sql)
        t0 = time.perf_counter()
        host_rows = host.query(sql)
        host_ms = (time.perf_counter() - t0) * 1e3
        tied_rows_agree(small, host_rows, name,
                        f"{name} at SF {sf}: cuda (kernels {flag}) vs cpu engine", ordered)
        return {"cross_scale": sf, "cross_rows": len(host_rows), "cpu_engine_ms": host_ms}

    names = tuple(n for n in sorted(queries) if n not in TPCDS_SKIPPED)
    ds_variants = [("tpcds", "true", names, []),
                   ("tpcds_operators", "false", TPCDS_OPERATOR_QUERIES, [])]
    w_queries = {"w1": W1, "w2": W2}
    # every count to 0 just before the path, read just after
    reset_kernel_counts()
    t_path = time.perf_counter()
    kept: dict = {}  # each counted run's rows: the comparisons below reuse them
    ds_lines, launches = run_lines(ds, queries, ds_variants, {}, ordered, keep=kept)
    w_lines, w_launches = run_lines(engine, w_queries, [("tpcds", "true", tuple(w_queries), [])],
                                    want, keep=kept)
    counts = kernel_counts()
    path_s = time.perf_counter() - t_path
    for k in ("segment_reduce", "hash_build", "hash_probe"):
        if counts[k] < 1:
            fail(f"tpcds path never launched {k}: {counts}")

    for (variant, flag, name, sql, cold_ms, events, retries), eng, runs in (
        [(ln, ds, SHORT_RUNS) for ln in ds_lines] + [(ln, engine, 3) for ln in w_lines]
    ):
        what = f"{name}/{variant}"
        got = kept[what]
        other = "false" if flag == "true" else "true"
        eng.execute(f"set session data_plane_kernels = {other}")
        t0 = time.perf_counter()
        other_rows = eng.query(sql)
        other_ms = (time.perf_counter() - t0) * 1e3
        eng.execute(f"set session data_plane_kernels = {flag}")
        tied_rows_agree(got, other_rows, name, f"{what} vs data_plane_kernels = {other}",
                        ordered)
        if name in want:
            rows_agree(got, want[name], name, f"{what} vs numpy reference")
            checks = {"numpy_reference": True}
        else:
            checks = against_host(name, sql, flag)
        emit({
            "phase": "tpcds", "query": name, "variant": variant, "data_plane_kernels": flag,
            "rows": len(got), "correct": True, "cold_ms": cold_ms,
            **statement_timing(eng, sql, runs), f"kernels_{other}_ms": other_ms, **checks,
            "first_run_retries": retries,
            "launches": (launches if eng is ds else w_launches)[what],
            "dispatch": [[op, impl] for op, impl, _ in events],
        })
    # the statements left out at `scale` run at their cross-check scale only
    for name, reason in TPCDS_SKIPPED.items():
        emit({"phase": "tpcds", "query": name, "variant": "cross_scale_only",
              "data_plane_kernels": "true", "skipped_at_scale": reason, "correct": True,
              **against_host(name, queries[name], "true")})
    del ds, cross
    torch.cuda.empty_cache()
    return counts, path_s


# --------------------------------- the statement surface over a memory catalog

LI_COPY = ("l_orderkey, l_linenumber, l_quantity, l_extendedprice, l_discount, l_tax, "
           "l_returnflag, l_linestatus, l_shipdate")
ORD_COPY = "o_orderkey, o_custkey, o_totalprice, o_orderdate"
SHIP_CUT = "1998-09-02"  # Q1's bound: date '1998-12-01' - interval '90' day
FRESH_KEYS = 10_000  # MERGE's new order keys, past the largest one of the scale


def on_copy(sql: str) -> str:
    return sql.replace("from lineitem", "from memory.li")


Q01_NO_DATE = Q01.replace("where l_shipdate <= date '1998-12-01' - interval '90' day\n", "")
LI_TOTALS = "select count(*), sum(l_quantity), sum(l_discount) from memory.li"
ORD_TOTALS = "select count(*), sum(o_totalprice) from memory.ord"
ORD_TOP = "select o_orderkey from memory.ord order by o_orderkey desc limit 10"
PREPARED = "select count(*), sum(l_extendedprice) from memory.li where l_quantity < ?"
MERGE = """
merge into memory.ord t using (
  select o_orderkey as k, cast(o_totalprice + 1.00 as decimal(12,2)) as p
  from tpch.orders where o_orderkey % 7 = 0
  union all select k, p from memory.fresh) s
on t.o_orderkey = s.k
when matched then update set o_totalprice = s.p
when not matched then insert (o_orderkey, o_custkey, o_totalprice, o_orderdate)
  values (s.k, 0, s.p, date '1998-12-31')
"""
EXPLAIN_WRITE = "insert into memory.e select l_orderkey from memory.li where l_orderkey < 8"
# (step, statements run once in order, reads run after them)
STATEMENT_STEPS = (
    ("ctas_lineitem", (f"create table memory.li as select {LI_COPY} from lineitem",),
     {"q01": on_copy(Q01), "q06": on_copy(Q06), "topn": on_copy(TOPN)}),
    ("delete", (f"delete from memory.li where l_shipdate > date '{SHIP_CUT}'",),
     {"q01_no_date": on_copy(Q01_NO_DATE)}),
    ("update", ("update memory.li set l_discount = l_discount + 0.01 where l_returnflag = 'R'",),
     {"q01": on_copy(Q01)}),
    ("insert", (f"insert into memory.li select {LI_COPY} from tpch.lineitem "
                "where l_orderkey < 60000",), {"totals": LI_TOTALS}),
    ("ctas_orders", (f"create table memory.ord as select {ORD_COPY} from orders",),
     {"orders": ORD_TOTALS}),
    ("merge", (MERGE,), {"orders": ORD_TOTALS, "top_keys": ORD_TOP}),
    ("rollback", ("start transaction",
                  "delete from memory.ord where o_orderdate < date '1995-01-01'", "rollback"),
     {"orders": ORD_TOTALS}),
    ("commit", ("start transaction", "delete from memory.ord where o_custkey = 0", "commit"),
     {"orders": ORD_TOTALS, "top_keys": ORD_TOP}),
    ("prepare", (f"prepare cheap from {PREPARED}",),
     {"execute": "execute cheap using 24", "literal": PREPARED.replace("?", "24")}),
    ("view", ("create view memory.q1v as " + on_copy(Q01),), {"view": "select * from memory.q1v"}),
    ("empty", ("create table memory.e (x bigint)",), {"empty": "select count(*), sum(x) from memory.e"}),
    ("explain", ("explain " + EXPLAIN_WRITE, "explain analyze " + EXPLAIN_WRITE),
     {"e": "select count(*), sum(x) from memory.e"}),
)
WRITTEN_TABLES = ("li", "ord", "e", "fresh")


def fresh_source(max_key: int) -> dict:
    """MERGE's new rows: FRESH_KEYS order keys past `max_key`, prices (cents)
    from a seed."""
    rng = np.random.default_rng(10)
    return {"k": np.arange(max_key + 1, max_key + 1 + FRESH_KEYS, dtype=np.int64),
            "p": rng.integers(100, 50_000_000, FRESH_KEYS).astype(np.int64)}


def add_memory_catalog(engine, fresh) -> None:
    """Register a writable `memory` catalog on `engine`, holding only
    MERGE's source rows."""
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.connectors.spi import ColumnSchema
    from trino_tpu_torch.data.types import BIGINT, parse_type

    mem = MemoryConnector()
    mem.create_table("fresh", [ColumnSchema("k", BIGINT),
                               ColumnSchema("p", parse_type("decimal(12,2)"))])
    mem.insert("fresh", dict(fresh))
    engine.register_catalog("memory", mem)


def memory_engine(device, scale, fresh):
    """A new engine over TPC-H at `scale` with the `memory` catalog."""
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.runtime.engine import Engine

    e = Engine(device=device)
    e.register_catalog("tpch", TpchConnector(scale))
    add_memory_catalog(e, fresh)
    return e


def dispatch_count(op: str, impl: str) -> int:
    from trino_tpu_torch.ops import kernels

    return int(kernels._DISPATCH.value(op, impl))


def run_statements(engine, measure: bool) -> list:
    """The statement sequence once through `engine.execute`, in order.
    Returns one record per step: each statement's result, each read's rows
    and, with `measure`, the timings (on the card) and the launches of the
    statements and of each read's first run."""
    cuda = engine.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    steps = []
    for step, writes, reads in STATEMENT_STEPS:
        rec = {"step": step, "writes": [], "reads": {}, "launches": dict.fromkeys(KERNEL_NAMES, 0)}

        def count(fn):
            before = kernel_counts() if measure else None
            out = fn()
            if measure:
                after = kernel_counts()
                for k in KERNEL_NAMES:
                    rec["launches"][k] += after[k] - before[k]
            return out

        for sql in writes:
            engine._last_txn_info = None
            joins = {impl: dispatch_count("join", impl) for impl in ("cuda", "sort", "fallback")}
            if not measure:
                rec["writes"].append({"sql": sql, "result": engine.execute(sql)})
                continue
            out, walls = [], []

            def once():
                sync()
                t0 = time.perf_counter()
                out.append(engine.execute(sql))
                sync()
                walls.append((time.perf_counter() - t0) * 1e3)

            busy = count(lambda: traced_busy(once, 1))
            if not out:  # the profiler failed before the statement ran
                count(once)
            info = engine._last_txn_info
            w = {"sql": " ".join(sql.split())[:90], "result": out[0], "wall_ms": walls[0],
                 **engine.last_write_split,
                 "commit_ms": None if info is None else info["commit_ms"],
                 "txn_outcome": None if info is None else info["outcome"],
                 "device_busy_ms": busy["device_busy_ms"],
                 "device_idle_share": None if busy["device_busy_ms"] is None
                 else 1.0 - busy["device_busy_ms"] / walls[0],
                 "top_kernels": busy["top_kernels"],
                 "joins": {impl: dispatch_count("join", impl) - n for impl, n in joins.items()}}
            rec["writes"].append(w)
        for name, sql in reads.items():
            if not measure:
                rec["reads"][name] = {"rows": engine.execute(sql)}
                continue
            sync()
            t0 = time.perf_counter()
            rows = count(lambda: engine.execute(sql))
            sync()
            cold_ms = (time.perf_counter() - t0) * 1e3
            r = {"rows": rows, "cold_ms": cold_ms,
                 "upload_ms": engine.executor.last_upload_ms,
                 "first_run_retries": list(engine.executor.last_retries)}
            warm = []
            for _ in range(3):
                sync()
                t0 = time.perf_counter()
                engine.execute(sql)
                sync()
                warm.append((time.perf_counter() - t0) * 1e3)
            r["warm_ms"] = statistics.median(warm)
            busy = traced_busy(lambda: engine.execute(sql), 1)
            r["device_busy_ms"] = busy["device_busy_ms"]
            r["device_idle_share"] = (None if busy["device_busy_ms"] is None
                                      else 1.0 - busy["device_busy_ms"] / r["warm_ms"])
            r["top_kernels"] = busy["top_kernels"]
            rec["reads"][name] = r
        if measure:
            rec["memory_allocated"] = torch.cuda.memory_allocated()
        steps.append(rec)
    return steps


def cache_bytes(engine, catalog: str) -> tuple:
    """(device bytes, {table: generations}) of the executor's cached scan
    columns of `catalog`."""
    seen, total, gens = set(), 0, {}
    for key, col in engine.executor._table_cols.items():
        if key[0] != catalog:
            continue
        gens.setdefault(key[1], set()).add(key[-1])
        for t in (col.data, col.valid, col.data2):
            if t is not None and t.data_ptr() not in seen:
                seen.add(t.data_ptr())
                total += t.numel() * t.element_size()
    return total, gens


def table_bytes(conn, table: str) -> int:
    """Device bytes of one generation of a memory table: every column's
    lanes at its type's width (VARCHAR as int32 codes), its validity where
    it holds NULLs."""
    schema = conn.table_schema(table)
    n = max(conn.estimated_row_count(table) or 0, 1)
    total = 0
    for c in schema.columns:
        arr = conn._data[table][c.name]
        total += n * (4 if c.type.is_string else np.dtype(c.type.np_dtype).itemsize)
        if isinstance(arr, np.ma.MaskedArray) and np.ma.getmaskarray(arr).any():
            total += n
    return total


def statements_reference(li: dict, orders: dict, fresh: dict) -> dict:
    """What each step's statements and reads must give, in numpy and python
    ints over the generated columns."""
    ship = li["l_shipdate"].astype(np.int64)
    keep = ship <= _days(1998, 9, 2)
    rf = np.asarray(li["l_returnflag"]).astype("U1")
    disc2 = li["l_discount"].astype(np.int64) + (rf == "R")
    qty = li["l_quantity"].astype(np.int64)
    extra = li["l_orderkey"] < 60000
    okey, tp = orders["o_orderkey"].astype(np.int64), orders["o_totalprice"].astype(np.int64)
    matched = okey % 7 == 0
    merged_sum = exact_sum(tp) + int(matched.sum()) * 100 + exact_sum(fresh["p"])
    top = [(int(k),) for k in np.sort(np.concatenate([okey, fresh["k"]]))[::-1][:10]]
    # the copy after the INSERT: the kept rows (discounts updated), then the
    # inserted ones
    final = {c: np.concatenate([np.asarray(li[c])[keep], np.asarray(li[c])[extra]])
             for c in ("l_quantity", "l_extendedprice", "l_tax", "l_shipdate",
                       "l_returnflag", "l_linestatus")}
    final_disc = np.concatenate([disc2[keep], li["l_discount"][extra]])
    qty2 = np.concatenate([qty[keep], qty[extra]])
    price2 = np.concatenate([li["l_extendedprice"][keep], li["l_extendedprice"][extra]])
    cheap = qty2 < 2400
    ok8 = np.concatenate([li["l_orderkey"][keep], li["l_orderkey"][extra]])
    ok8 = ok8[ok8 < 8].astype(np.int64)
    return {
        "deleted": int((~keep).sum()),
        "updated": int((keep & (rf == "R")).sum()),
        "inserted": int(extra.sum()),
        "q01_updated": q1_reference(li, keep, disc2),
        "q01_final": q1_reference(final, disc=final_disc),
        "li_totals": [(int(keep.sum() + extra.sum()),
                       dec(exact_sum(qty[keep]) + exact_sum(qty[extra]), 2),
                       dec(exact_sum(disc2[keep]) + exact_sum(li["l_discount"][extra]), 2))],
        "orders": [(len(okey), dec(exact_sum(tp), 2))],
        "merged": int(matched.sum()) + FRESH_KEYS,
        "orders_merged": [(len(okey) + FRESH_KEYS, dec(merged_sum, 2))],
        "top_merged": top,
        "orders_committed": [(len(okey), dec(merged_sum - exact_sum(fresh["p"]), 2))],
        "top_committed": [(int(k),) for k in np.sort(okey)[::-1][:10]],
        "cheap": [(int(cheap.sum()), dec(exact_sum(price2[cheap]), 2))],
        "e": [(len(ok8), exact_sum(ok8))],
    }


def statements_phase(engine, scale):
    """The statement surface on the card: STATEMENT_STEPS through
    `Engine.execute` over a `memory` catalog at TPC-H `scale`, every step
    against numpy, then the same steps at SF 0.01 on a card engine and on
    `Engine(device="cpu")` with every result and final table compared.
    Returns (the path's launch counts, phase seconds)."""
    from trino_tpu_torch.connectors.tpch import tpch_data

    t_phase = time.perf_counter()
    li, orders = tpch_data("lineitem", scale), tpch_data("orders", scale)
    fresh = fresh_source(int(orders["o_orderkey"].max()))
    want = statements_reference(li, orders, fresh)
    main_want = reference_rows(li, orders, tpch_data("customer", scale))
    # the TPC-H engine of the earlier phases: its lineitem and orders columns
    # are on the card already
    engine.execute("set session data_plane_kernels = true")
    add_memory_catalog(engine, fresh)
    mem_engine = engine
    n_lineitem = len(li["l_orderkey"])
    del li
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    tpch_before, _ = cache_bytes(mem_engine, "tpch")
    steps = run_statements(mem_engine, measure=True)
    counts = {k: sum(st["launches"][k] for st in steps) for k in KERNEL_NAMES}
    by_step = {st["step"]: st for st in steps}

    def result(step, i=0):
        return by_step[step]["writes"][i]["result"]

    def read(step, name):
        return by_step[step]["reads"][name]["rows"]

    # every step against numpy (and the copy against tpch.lineitem itself)
    for name, sql in (("q01", Q01), ("q06", Q06), ("topn", TOPN)):
        rows_match(read("ctas_lineitem", name), main_want[name], f"statements {name} over the copy")
        rows_match(read("ctas_lineitem", name), engine.query(sql),
                   f"statements {name} over the copy vs tpch.lineitem")
    rows_match(result("ctas_lineitem"), [(n_lineitem,)], "statements CTAS lineitem count")
    rows_match(result("delete"), [(want["deleted"],)], "statements DELETE count")
    rows_match(read("delete", "q01_no_date"), main_want["q01"], "statements Q1 after DELETE")
    rows_match(result("update"), [(want["updated"],)], "statements UPDATE count")
    rows_match(read("update", "q01"), want["q01_updated"], "statements Q1 after UPDATE")
    rows_match(result("insert"), [(want["inserted"],)], "statements INSERT count")
    rows_match(read("insert", "totals"), want["li_totals"], "statements totals after INSERT")
    rows_match(result("ctas_orders"), [(want["orders"][0][0],)], "statements CTAS orders count")
    rows_match(read("ctas_orders", "orders"), want["orders"], "statements orders copy")
    rows_match(result("merge"), [(want["merged"],)], "statements MERGE count")
    rows_match(read("merge", "orders"), want["orders_merged"], "statements orders after MERGE")
    rows_match(read("merge", "top_keys"), want["top_merged"], "statements top keys after MERGE")
    joins = by_step["merge"]["writes"][0]["joins"]
    if joins["cuda"] < 4 or joins["sort"] or joins["fallback"]:
        fail(f"statements MERGE: its joins took {joins}, not the hash path")
    rows_match(read("rollback", "orders"), want["orders_merged"], "statements ROLLBACK")
    rows_match(result("commit", 1), [(FRESH_KEYS,)], "statements committed DELETE count")
    rows_match(read("commit", "orders"), want["orders_committed"], "statements COMMIT")
    rows_match(read("commit", "top_keys"), want["top_committed"], "statements top keys after COMMIT")
    rows_match(read("prepare", "execute"), read("prepare", "literal"), "statements EXECUTE")
    rows_match(read("prepare", "literal"), want["cheap"], "statements prepared statement")
    rows_match(read("view", "view"), want["q01_final"], "statements view over Q1")
    rows_match(read("empty", "empty"), [(0, None)], "statements empty table")
    explain, analyze = (w["result"] for w in by_step["explain"]["writes"])
    if not explain or not str(explain[0][0]).startswith("Write[Insert"):
        fail(f"statements EXPLAIN of a write printed {explain[:2]}")
    footer = [r[0] for r in analyze if str(r[0]).startswith("-- txn:")]
    if len(footer) != 1 or "outcome=committed" not in footer[0]:
        fail(f"statements EXPLAIN ANALYZE of a write: txn footer {footer}")
    rows_match(read("explain", "e"), want["e"], "statements EXPLAIN ANALYZE's write")
    for k in KERNEL_NAMES:
        if counts[k] < 1:
            fail(f"statements path never launched {k}: {counts}")

    # device memory: at most one generation of each written table cached
    torch.cuda.synchronize()
    after_alloc = torch.cuda.memory_allocated()
    tpch_after, _ = cache_bytes(mem_engine, "tpch")
    mem_cached, gens = cache_bytes(mem_engine, "memory")
    conn = mem_engine.catalogs.get("memory")
    one_gen = sum(table_bytes(conn, t) for t in WRITTEN_TABLES)
    growth = after_alloc - base - (tpch_after - tpch_before)
    slack = 64 << 20
    if any(len(g) > 1 for g in gens.values()) or mem_cached > one_gen \
            or growth > one_gen + slack:
        fail(f"statements: device memory holds more than one generation of the written "
             f"tables: growth {growth} B, cached {mem_cached} B, one generation {one_gen} B, "
             f"generations {gens}")
    lines = [("statements", "true", n, on_copy(sql), 0, ()) for n, sql in
             (("q01", Q01), ("topn", TOPN))]
    calls = check_main_path_calls(mem_engine, lines + [(
        "statements", "true", "merge_join",
        "select count(*), sum(t.o_totalprice) from memory.ord t join memory.li l "
        "on t.o_orderkey = l.l_orderkey", 0, ())], require_all=False)

    for st in steps:
        emit({"phase": "statements", "step": st["step"], "scale": scale, "correct": True,
              "writes": [{k: v for k, v in w.items() if k != "result"} | {
                  "result": w["result"] if len(w["result"]) <= 2 else f"{len(w['result'])} lines"}
                  for w in st["writes"]],
              "reads": {n: {k: v for k, v in r.items() if k != "rows"} | {"rows": len(r["rows"])}
                        for n, r in st["reads"].items()},
              "launches": st["launches"], "memory_allocated": st["memory_allocated"]})
    emit({"phase": "statements", "step": "memory", "base_bytes": base, "after_bytes": after_alloc,
          "tpch_cache_growth_bytes": tpch_after - tpch_before, "growth_bytes": growth,
          "memory_cached_bytes": mem_cached, "one_generation_bytes": one_gen,
          "generations": {t: sorted(g) for t, g in gens.items()}})
    emit({"phase": "statements", "step": "kernel_calls", "calls": calls})
    del steps, by_step
    mem_engine.execute("drop view memory.q1v")
    for t in WRITTEN_TABLES:  # their device columns leave with them
        mem_engine.execute(f"drop table memory.{t}")
    torch.cuda.empty_cache()

    # the same sequence at SF 0.01 on the card and on the host
    small = tpch_data("orders", 0.01)
    fresh_small = fresh_source(int(small["o_orderkey"].max()))
    t0 = time.perf_counter()
    card, host = (memory_engine(d, 0.01, fresh_small) for d in ("cuda", "cpu"))
    card_steps, host_steps = run_statements(card, False), run_statements(host, False)
    compared = 0
    for a, b in zip(card_steps, host_steps):
        for i, (wa, wb) in enumerate(zip(a["writes"], b["writes"])):
            if not wa["sql"].startswith("explain"):
                rows_match(wa["result"], wb["result"], f"statements SF 0.01 {a['step']} #{i}")
        for name in a["reads"]:
            rows_match(a["reads"][name]["rows"], b["reads"][name]["rows"],
                       f"statements SF 0.01 {a['step']}/{name}: cuda vs cpu engine")
            compared += 1
    finals = {}
    for t in WRITTEN_TABLES:
        sql = f"select * from memory.{t}"
        got, exp = card.execute(sql), host.execute(sql)
        rows_match(unordered(got), unordered(exp), f"statements SF 0.01 final memory.{t}")
        finals[t] = len(exp)
    emit({"phase": "statements", "step": "cross_scale", "scale": 0.01, "correct": True,
          "reads_compared": compared, "final_rows": finals,
          "seconds": round(time.perf_counter() - t0, 3)})
    del card, host
    torch.cuda.empty_cache()
    return counts, time.perf_counter() - t_phase


# ------------------------------------------------------------------ nested
# Arrays, JSON, lambdas, UNNEST and MATCH_RECOGNIZE over the TPC-H tables of
# the earlier phases and a `nested.events` table of JSON payloads made here.

NESTED = {
    # N1: ~5 words per part name; hash GROUP BY over the UNNEST rows
    "words_part": (
        "select w, count(*) as c from part cross join unnest(split(p_name, ' ')) as t(w) "
        "group by w order by c desc, w limit 10"),
    # N2: ~10 M elements of mostly distinct arrays, with their ordinality
    "words_orders": (
        "select w, count(*) as c, sum(o) as so from orders "
        "cross join unnest(split(o_comment, ' ')) with ordinality as t(w, o) "
        "group by w order by c desc, w limit 10"),
    # N3: a lambda, a reduce, contains, array_sort / array_join, element_at
    "lambdas": (
        "select p_brand, "
        "sum(cardinality(filter(split(p_name, ' '), w -> length(w) > 5))) as long_words, "
        "sum(reduce(transform(split(p_name, ' '), w -> length(w)), 0, (s, x) -> s + x, "
        "s -> s)) as letters, "
        "sum(case when contains(split(p_name, ' '), 'green') then 1 else 0 end) as green, "
        "max(array_join(array_sort(split(p_name, ' ')), '-')) as sorted_name, "
        "max(element_at(split(p_name, ' '), -1)) as last_word "
        "from part group by p_brand order by p_brand"),
    # N4: JSON paths over mostly distinct payloads; malformed ones are NULL
    "json_events": (
        "select tier, count(*) as n, sum(tags) as tags, sum(members) as members from ("
        "select json_extract_scalar(p, '$.user.tier') as tier, "
        "json_array_length(json_extract(p, '$.tags')) as tags, "
        "json_size(p, '$') as members from nested.events) "
        "group by tier order by tier"),
    # N5: runs of strictly rising order prices per customer
    "rising_runs": (
        "select count(*) as matches, sum(f) as first_keys, sum(l) as last_keys, "
        "max(mno) as most, sum(p1 - p0) as rise from ("
        "select * from orders match_recognize ("
        "partition by o_custkey order by o_orderdate, o_orderkey "
        "measures match_number() as mno, first(strt.o_orderkey) as f, "
        "last(up.o_orderkey) as l, first(strt.o_totalprice) as p0, "
        "last(up.o_totalprice) as p1 "
        "one row per match after match skip past last row "
        "pattern (strt up+) define up as up.o_totalprice > prev(up.o_totalprice)))"),
    # N6: ORDER BY ... LIMIT over the ~1 M UNNEST rows of N1 (radix TopN)
    "unnest_topn": (
        "select p_partkey, o, w from part "
        "cross join unnest(split(p_name, ' ')) with ordinality as t(w, o) "
        "order by p_partkey desc, o desc limit 10"),
}
NESTED_KERNELS = ("segment_reduce", "hash_build", "radix_select")  # the path's kernels
EVENTS_ROWS = 500_000  # at scale 1 (halved from 1,000,000 to keep the script within its time)
EVENT_TIERS = ("bronze", "silver", "gold", "platinum")
EVENT_TAGS = ("new", "sale", "mobile", "web", "promo", "return", "gift", "bulk", "eu", "us",
              "apac", "trial", "vip", "app", "email", "ads", "search", "social", "b2b", "b2c")
NESTED_TEST_FILES = ("test_torch_arrays", "test_torch_lambdas", "test_torch_matchrec",
                     "test_torch_nested")


def events_table(n: int, seed: int = 11) -> dict:
    """`n` JSON payloads from a seed: a user id and tier, 0-4 tags and an
    amount, mostly distinct; one in 200 cut in half (malformed)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 10**9, n)
    tier = rng.choice(len(EVENT_TIERS), n, p=[0.5, 0.3, 0.15, 0.05])
    ntags = rng.integers(0, 5, n)
    tags = rng.integers(0, len(EVENT_TAGS), (n, 4))
    cents = rng.integers(0, 10**7, n)
    bad = rng.random(n) < 0.005
    out = np.empty(n, dtype=object)
    for i in range(n):
        tag_list = ",".join(f'"{EVENT_TAGS[t]}"' for t in tags[i, :ntags[i]])
        s = (f'{{"user":{{"id":{ids[i]},"tier":"{EVENT_TIERS[tier[i]]}"}},'
             f'"tags":[{tag_list}],"amount":{cents[i] // 100}.{cents[i] % 100:02d}}}')
        out[i] = s[: len(s) // 2] if bad[i] else s
    return {"k": np.arange(n, dtype=np.int64), "p": out}


def words_reference(texts, limit: int = 10, ordinality: bool = False) -> list:
    counts, ords = {}, {}
    for s in texts:
        for i, w in enumerate(s.split(" "), 1):
            counts[w] = counts.get(w, 0) + 1
            ords[w] = ords.get(w, 0) + i
    top = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))[:limit]
    return [(w, c, ords[w]) if ordinality else (w, c) for w, c in top]


def lambdas_reference(part: dict) -> list:
    groups: dict = {}
    for name, brand in zip(part["p_name"], part["p_brand"]):
        words = name.split(" ")
        g = groups.setdefault(brand, [0, 0, 0, "", ""])
        g[0] += sum(len(w) > 5 for w in words)
        g[1] += sum(len(w) for w in words)
        g[2] += "green" in words
        g[3] = max(g[3], "-".join(sorted(words)))
        g[4] = max(g[4], words[-1])
    return [(b, *groups[b]) for b in sorted(groups)]


def json_reference(events: dict) -> list:
    import json

    groups: dict = {}
    for p in events["p"]:
        try:
            d = json.loads(p)
        except ValueError:
            d = None
        tier = None if d is None else d["user"]["tier"]
        g = groups.setdefault(tier, [0, None, None])
        g[0] += 1
        if d is not None:
            g[1] = (g[1] or 0) + len(d["tags"])
            g[2] = (g[2] or 0) + len(d)
    order = sorted(t for t in groups if t is not None) + ([None] if None in groups else [])
    return [(t, *groups[t]) for t in order]


def rising_reference(orders: dict) -> list:
    """Maximal runs of strictly rising o_totalprice per customer, in
    (o_orderdate, o_orderkey) order: each run of two rows or more is one
    match of (strt up+) under AFTER MATCH SKIP PAST LAST ROW."""
    cust, key, price = orders["o_custkey"], orders["o_orderkey"], orders["o_totalprice"]
    order = np.lexsort((key, orders["o_orderdate"], cust))
    cust, key, price = cust[order], key[order], price[order]
    up = (price[1:] > price[:-1]) & (cust[1:] == cust[:-1])
    # runs of True in `up`: run [a, b) of up covers rows a .. b
    edges = np.diff(np.concatenate([[0], up.astype(np.int8), [0]]))
    starts, ends = np.flatnonzero(edges == 1), np.flatnonzero(edges == -1)
    # the match number: 1 + earlier runs of the same customer
    first_of_cust = np.searchsorted(cust, cust[starts], side="left")
    runs_before = np.searchsorted(starts, first_of_cust, side="left")
    mno = np.arange(len(starts)) - runs_before + 1
    rise = int(price[ends].sum()) - int(price[starts].sum())
    return [(len(starts), int(key[starts].sum()), int(key[ends].sum()),
             int(mno.max()) if len(mno) else None, rise / 100.0)]


def unnest_topn_reference(part: dict) -> list:
    top = np.argsort(-part["p_partkey"], kind="stable")[:3]
    rows = []
    for i in top:
        words = part["p_name"][i].split(" ")
        rows.extend((int(part["p_partkey"][i]), o, w)
                    for o, w in reversed(list(enumerate(words, 1))))
    return rows[:10]


def nested_reference(part: dict, orders: dict, events: dict) -> dict:
    return {
        "words_part": words_reference(part["p_name"]),
        "words_orders": words_reference(orders["o_comment"], ordinality=True),
        "lambdas": lambdas_reference(part),
        "json_events": json_reference(events),
        "rising_runs": rising_reference(orders),
        "unnest_topn": unnest_topn_reference(part),
    }


def nested_timing(engine, sql) -> dict:
    """SHORT_RUNS warm runs of a statement on the card, layer by layer (plan,
    execute, fetch), inside one card-only profiler trace: `warm_ms` is the
    median run, the device's busy time is the trace's per run.  (One set of
    runs, not three as in statement_timing: this path's host passes take
    seconds per run, and a card-only trace adds microseconds per launch.)"""
    laps = []

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan = engine.plan(sql)
        t1 = time.perf_counter()
        page = engine.executor.execute(plan)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        page.to_pylist()
        laps.append((t0, t1, t2, time.perf_counter()))

    busy = traced_busy(run, SHORT_RUNS)
    while len(laps) < SHORT_RUNS:  # the profiler failed before the runs: run them plain
        run()
    laps = laps[-SHORT_RUNS:]
    med = lambda i, j: statistics.median((lap[j] - lap[i]) * 1e3 for lap in laps)
    warm_ms = med(0, 3)
    idle = None if busy["device_busy_ms"] is None else 1.0 - busy["device_busy_ms"] / warm_ms
    return {"warm_ms": warm_ms, "warm_runs_ms": [(l[3] - l[0]) * 1e3 for l in laps],
            "device_idle_share": idle, **busy,
            "plan_ms": med(0, 1), "execute_ms": med(1, 2), "fetch_ms": med(2, 3)}


def nested_test_module(name: str):
    """One of the port's nested-value test files, loaded from tests/ for
    its statements (CASES) and its engine builder (port_engine)."""
    import importlib.util

    path = Path(__file__).resolve().parent / "tests" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"nested_cases_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    threads = torch.get_num_threads()
    spec.loader.exec_module(mod)
    torch.set_num_threads(threads)  # the test files pin one thread
    return mod


def nested_cross_check() -> dict:
    """Every statement of the port's nested-value test files (arrays, maps,
    rows, JSON, lambdas, UNNEST, MATCH_RECOGNIZE, sequence(), zip_with) at
    SF 0.01 on a card engine and on Engine(device="cpu"), rows compared,
    and against the test's expected rows where it states them."""
    compared = {}
    for name in NESTED_TEST_FILES:
        mod = nested_test_module(name)
        card, host = mod.port_engine("cuda"), mod.port_engine("cpu")
        for case, (sql, want) in mod.CASES.items():
            got, exp = card.execute(sql), host.execute(sql)
            rows_match(got, exp, f"nested SF 0.01 {name}/{case}: cuda vs cpu engine")
            if want is not None:
                rows_match(got, want, f"nested SF 0.01 {name}/{case}: cuda vs the test's rows")
        compared[name] = len(mod.CASES)
        del card, host
    return compared


def nested_phase(engine, scale):
    """The nested-value family on the card at TPC-H `scale`: NESTED through
    `Engine.query` on the TPC-H engine (plus a `nested` memory catalog
    holding the JSON events), each statement against its python / numpy
    reference; then the nested-value test files' statements at SF 0.01, card
    vs Engine(device="cpu").  Returns (the path's launch counts, phase
    seconds)."""
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.connectors.spi import ColumnSchema
    from trino_tpu_torch.connectors.tpch import tpch_data
    from trino_tpu_torch.data.types import BIGINT, VARCHAR
    from trino_tpu_torch.exec.compiler import _node_ids
    from trino_tpu_torch.ops import kernels
    from trino_tpu_torch.plan.nodes import Unnest

    t_phase = time.perf_counter()
    part, orders = tpch_data("part", scale), tpch_data("orders", scale)
    t0 = time.perf_counter()
    events = events_table(max(1000, int(EVENTS_ROWS * scale)))
    make_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = nested_reference(part, orders, events)
    reference_s = time.perf_counter() - t0
    conn = MemoryConnector()
    conn.create_table("events", [ColumnSchema("k", BIGINT), ColumnSchema("p", VARCHAR)])
    conn.insert("events", events)
    engine.register_catalog("nested", conn)
    emit({"phase": "nested", "step": "data", "scale": scale, "events": len(events["k"]),
          "events_make_s": round(make_s, 3), "reference_s": round(reference_s, 3),
          "part": len(part["p_partkey"]), "orders": len(orders["o_orderkey"])})
    del events
    engine.execute("set session data_plane_kernels = true")
    counts = dict.fromkeys(KERNEL_NAMES, 0)
    for name, sql in NESTED.items():
        before = kernel_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = engine.query(sql)
        torch.cuda.synchronize()
        cold_ms = (time.perf_counter() - t0) * 1e3
        retries = list(engine.executor.last_retries)
        required = dict(engine.executor.last_required)
        after = kernel_counts()
        launches = {k: after[k] - before[k] for k in KERNEL_NAMES}
        for k in KERNEL_NAMES:
            counts[k] += launches[k]
        rows_match(rows, want[name], f"nested {name} on cuda vs python reference")
        plan = engine.plan(sql)
        events_run = kernels.events_for(plan)
        unnest_rows = [required.get(nid) for nid, node in _node_ids(plan).items()
                       if isinstance(node, Unnest)]
        emit({"phase": "nested", "query": name, "scale": scale, "rows": len(rows),
              "correct": True, "cold_ms": cold_ms, **nested_timing(engine, sql),
              "first_run_retries": retries,
              "host_values": sum(int(d) for op, _, d in events_run if op == "host_pass"),
              "host_passes": sum(1 for op, _, _ in events_run if op == "host_pass"),
              "unnest_rows": unnest_rows, "launches": launches,
              "dispatch": [[op, impl] for op, impl, _ in events_run if op != "host_pass"]})
    for k in NESTED_KERNELS:
        if counts[k] < 1:
            fail(f"nested path never launched {k}: {counts}")
    # the kernels' calls of N1 and N6 against their plain versions on the
    # engine's own tensors (after the counts were read)
    calls = check_main_path_calls(
        engine, [("nested", "true", n, NESTED[n], 0, ()) for n in ("words_part", "unnest_topn")],
        require_all=False)
    missing = set(NESTED_KERNELS) - {c["kernel"] for c in calls}
    if missing:
        fail(f"nested kernel_calls reached no call of {sorted(missing)}")
    emit({"phase": "nested", "step": "kernel_calls", "calls": calls})
    engine.execute("drop table nested.events")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    compared = nested_cross_check()
    emit({"phase": "nested", "step": "cross_scale", "scale": 0.01, "correct": True,
          "statements_compared": compared, "seconds": round(time.perf_counter() - t0, 3)})
    torch.cuda.empty_cache()
    return counts, time.perf_counter() - t_phase


# ------------------------------------------------------------------ spill

SPILL_QUERIES = ("q01", "q03", "q05", "q18")
SPILL_PARTS = 8  # each statement's budget is set from its estimate for this many
SPILL_PEAK_CHECKED = ("q01", "q18")  # out of core must peak lower than in memory
SPILL_KERNELS = ("segment_reduce", "hash_build", "hash_probe")  # the path's kernels
NARROW_PART_KEYS = 20_000  # at scale 1: a tenth of part, so about a tenth of lineitem joins
SPILL_CROSS_SCALE = 0.01
SPILL_CROSS_BUDGET = 3_000_000  # bytes: several slices at SF 0.01
NARROW_CROSS = (200, 400_000)  # p_partkey bound and budget of the join at SF 0.01


def narrow_join(bound: int) -> str:
    """A join whose build side (part) is narrow: dynamic filtering drops the
    lineitem rows outside [min, max] of its keys before upload."""
    return ("select count(*), sum(l_extendedprice) from lineitem, part "
            f"where l_partkey = p_partkey and p_partkey <= {bound}")


def peak_run(engine, sql) -> tuple:
    """(rows, peak device bytes above the pre-query baseline, ms) of one run
    from a cold scan cache: the engine's cached table columns are dropped
    first, so the uploads count in memory and out of core alike."""
    engine.executor.drop_scans()
    gc.collect()  # what earlier runs left must not be freed inside this one
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rows = engine.query(sql)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return rows, torch.cuda.max_memory_allocated() - base, ms


def warm_median(engine, sql, runs: int = 3) -> float:
    laps = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.query(sql)
        torch.cuda.synchronize()
        laps.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(laps)


def cuda_allocations() -> int:
    """How many device allocations the caching allocator has made so far."""
    return int(torch.cuda.memory_stats().get("allocation.all.allocated", 0))


def tpch_engine(device, scale):
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.runtime.engine import Engine

    eng = Engine(device=device)
    eng.register_catalog("tpch", TpchConnector(scale))
    return eng


def reactive_oom(scale, want_rows) -> dict:
    """The reactive re-run after a device out-of-memory error.  Real where it
    can be made so: Q6's in-memory peak and its 2-part out-of-core peak are
    measured on a fresh engine, the process is capped between the two
    (torch.cuda.set_per_process_memory_fraction) and a second fresh engine
    runs Q6 under the default budget: the estimate admits it, the in-memory
    run raises torch.cuda.OutOfMemoryError, the engine re-runs it out of
    core.  The run fails when that re-run runs out of memory too.  Only
    where the peaks leave no room for a cap, or the capped run raised no
    out-of-memory error at all, is one OutOfMemoryError raised through the
    executor as the tests do ("simulated": true); `case` says which."""
    from trino_tpu_torch.exec.spill import estimate_plan_bytes

    probe = tpch_engine("cuda", scale)
    est = estimate_plan_bytes(probe.plan(Q06), probe.catalogs)
    probe.session.set("query_max_memory_bytes", "-1")
    _, peak_mem, _ = peak_run(probe, Q06)
    probe.session.set("query_max_memory_bytes", str(est // 2 + 1))
    _, peak_two, _ = peak_run(probe, Q06)
    parts_two = probe.last_spill.parts
    del probe
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    base = torch.cuda.memory_reserved()
    limit = base + (peak_mem + peak_two) // 2
    out = {"statement": "q06", "peak_in_memory_bytes": peak_mem,
           "peak_two_parts_bytes": peak_two, "cap_bytes": limit - base, "simulated": True,
           "case": "simulated: the two peaks leave no room for a cap between them"}
    if parts_two == 2 and peak_two < 0.8 * peak_mem:
        eng, rerun_oom = None, None
        torch.cuda.set_per_process_memory_fraction(limit / total)
        try:
            eng = tpch_engine("cuda", scale)
            rows = eng.query(Q06)
        except torch.cuda.OutOfMemoryError as err:
            rerun_oom = str(err)[:200]
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0)
        if rerun_oom is not None:
            fail(f"spill reactive: the out-of-core re-run under the cap ran out of "
                 f"device memory too: {rerun_oom}")
        ooc = eng.last_spill
        if ooc is not None:
            rows_match(rows, want_rows, "spill reactive (real OOM) vs in memory")
            out.update(simulated=False, case="real: out of memory under the cap, re-run "
                       "out of core", parts=ooc.parts, spill_files=ooc.spill_files,
                       spilled_bytes=ooc.spilled_bytes)
        else:
            out["case"] = "simulated: the capped run raised no out-of-memory error"
        del eng
        torch.cuda.empty_cache()
    if out["simulated"]:
        eng = tpch_engine("cuda", scale)
        real = eng.executor.execute
        calls = [0]

        def oom_once(plan, *a, **kw):
            if calls[0] == 0:
                calls[0] += 1
                raise torch.cuda.OutOfMemoryError("CUDA out of memory (raised once by chip_smoke)")
            return real(plan, *a, **kw)

        eng.executor.execute = oom_once
        rows = eng.query(Q06)
        ooc = eng.last_spill
        if calls[0] != 1 or ooc is None:
            fail("spill reactive (simulated): the engine did not re-run out of core")
        rows_match(rows, want_rows, "spill reactive (simulated) vs in memory")
        out.update(parts=ooc.parts, spill_files=ooc.spill_files, spilled_bytes=ooc.spilled_bytes)
        del eng
        torch.cuda.empty_cache()
    return out


def spill_cross_check() -> dict:
    """The four statements and the narrow join at SF 0.01, out of core on a
    card engine and on Engine(device="cpu"): rows, parts, spill files and
    pruned rows equal; the CPU engine's run moves no CUDA allocation."""
    queries, ordered = tpch_queries()
    card, host = tpch_engine("cuda", SPILL_CROSS_SCALE), tpch_engine("cpu", SPILL_CROSS_SCALE)
    stmts = {n: (Q01 if n == "q01" else queries[n], SPILL_CROSS_BUDGET) for n in SPILL_QUERIES}
    stmts["narrow_join"] = (narrow_join(NARROW_CROSS[0]), NARROW_CROSS[1])
    out = {}
    for name, (sql, budget) in stmts.items():
        for eng in (card, host):
            eng.session.set("query_max_memory_bytes", str(budget))
        got = card.query(sql)
        torch.cuda.synchronize()
        before = cuda_allocations()
        exp = host.query(sql)
        if cuda_allocations() != before:
            fail(f"spill SF 0.01 {name}: the CPU engine's out-of-core run allocated on the card")
        rows_agree(got, exp, name, f"spill SF 0.01 {name}: cuda vs cpu engine", ordered)
        a, b = card.last_spill, host.last_spill
        facts = lambda s: (s.parts, s.spill_files, s.rows_pruned)
        if a is None or b is None or facts(a) != facts(b):
            fail(f"spill SF 0.01 {name}: cuda {a and facts(a)} vs cpu {b and facts(b)}")
        out[name] = {"parts": a.parts, "spill_files": a.spill_files, "rows_pruned": a.rows_pruned}
    return out


def spill_phase(engine, scale):
    """Out-of-core execution on the card at TPC-H `scale`: Q1, Q3, Q5, Q18
    and a narrow join, each with a budget set from its own byte estimate for
    8 parts, against the same engine in memory (rows, warm_ms, peak device
    bytes from a cold scan cache) and Q1 / Q18 against numpy; then the
    reactive re-run after an out-of-memory error, and the statements at SF
    0.01 card vs CPU.  Returns (the path's launch counts, phase seconds)."""
    from trino_tpu_torch.connectors.tpch import tpch_data
    from trino_tpu_torch.exec.spill import estimate_plan_bytes

    t_phase = time.perf_counter()
    queries, ordered = tpch_queries()
    stmts = {n: (Q01 if n == "q01" else queries[n]) for n in SPILL_QUERIES}
    stmts["narrow_join"] = narrow_join(max(1, int(NARROW_PART_KEYS * scale)))
    li, orders, customer = (tpch_data(t, scale) for t in ("lineitem", "orders", "customer"))
    want = {"q01": q1_reference(li), "q18": q18_reference(li, orders, customer)}
    del li, orders, customer
    engine.execute("set session data_plane_kernels = true")
    counts = dict.fromkeys(KERNEL_NAMES, 0)
    peaks, pruned, in_memory = {}, {}, {}
    for name, sql in stmts.items():
        est = estimate_plan_bytes(engine.plan(sql), engine.catalogs)
        budget = est // 6  # ceil(est / budget) is 6 or 7: 8 parts
        engine.session.set("query_max_memory_bytes", "-1")
        rows_mem, peak_mem, cold_mem = peak_run(engine, sql)
        warm_mem = warm_median(engine, sql, SHORT_RUNS)
        in_memory[name] = rows_mem
        engine.session.set("query_max_memory_bytes", str(budget))
        before = kernel_counts()
        rows, peak, cold = peak_run(engine, sql)
        after = kernel_counts()
        ooc = engine.last_spill
        warm = warm_median(engine, sql, SHORT_RUNS)
        engine.session.set("query_max_memory_bytes", "0")
        launches = {k: after[k] - before[k] for k in KERNEL_NAMES}
        for k in KERNEL_NAMES:
            counts[k] += launches[k]
        if ooc is None or ooc.parts != SPILL_PARTS or ooc.spill_files < 1:
            fail(f"spill {name}: expected {SPILL_PARTS} parts with spill files, got "
                 f"{ooc and (ooc.parts, ooc.spill_files)}")
        rows_agree(rows, rows_mem, name, f"spill {name}: out of core vs in memory", ordered)
        if name in want:
            rows_agree(rows, want[name], name, f"spill {name}: out of core vs numpy", ordered)
        peaks[name] = (peak, peak_mem)
        pruned[name] = ooc.rows_pruned
        emit({"phase": "spill", "query": name, "scale": scale, "rows": len(rows),
              "correct": True, "estimate_bytes": est, "budget_bytes": budget,
              "parts": ooc.parts, "fragments": ooc.fragments, "spill_files": ooc.spill_files,
              "spilled_bytes": ooc.spilled_bytes, "rows_pruned": ooc.rows_pruned,
              "slices_that_retried": len(ooc.slice_retries),
              "warm_ms": warm, "warm_ms_in_memory": warm_mem,
              "cold_ms": cold, "cold_ms_in_memory": cold_mem,
              "peak_bytes": peak, "peak_bytes_in_memory": peak_mem, "launches": launches})
    for name in SPILL_PEAK_CHECKED:
        if peaks[name][0] >= peaks[name][1]:
            fail(f"spill {name}: out-of-core peak {peaks[name][0]} is not below the "
                 f"in-memory peak {peaks[name][1]}")
    if pruned["narrow_join"] < 1:
        fail(f"spill narrow_join: dynamic filtering pruned no row ({pruned})")
    for k in SPILL_KERNELS:
        if counts[k] < 1:
            fail(f"spill path never launched {k}: {counts}")
    # the kernels' calls of one out-of-core statement against their plain
    # versions on the engine's own tensors (after the counts were read)
    engine.session.set("query_max_memory_bytes", str(
        estimate_plan_bytes(engine.plan(stmts["q03"]), engine.catalogs) // 6))
    try:
        calls = check_main_path_calls(
            engine, [("spill", "true", "q03", stmts["q03"], 0, ())], require_all=False)
    finally:
        engine.session.set("query_max_memory_bytes", "0")
    missing = set(SPILL_KERNELS) - {c["kernel"] for c in calls}
    if missing:
        fail(f"spill kernel_calls reached no call of {sorted(missing)}")
    emit({"phase": "spill", "step": "kernel_calls", "calls": calls})
    engine.executor.drop_scans()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    emit({"phase": "spill", "step": "reactive", **reactive_oom(scale, in_memory_q06(engine)),
          "seconds": round(time.perf_counter() - t0, 3)})
    t0 = time.perf_counter()
    compared = spill_cross_check()
    emit({"phase": "spill", "step": "cross_scale", "scale": SPILL_CROSS_SCALE, "correct": True,
          "statements": compared, "seconds": round(time.perf_counter() - t0, 3)})
    torch.cuda.empty_cache()
    return counts, time.perf_counter() - t_phase


def in_memory_q06(engine) -> list:
    engine.session.set("query_max_memory_bytes", "-1")
    try:
        return engine.query(Q06)
    finally:
        engine.session.set("query_max_memory_bytes", "0")
        engine.executor.drop_scans()
        torch.cuda.empty_cache()


# --------------------------------------------------------------- fast path

FASTPATH = {
    "q6_shape": (
        "select sum(l_extendedprice * l_discount) as revenue from lineitem "
        "where l_shipdate >= ? and l_shipdate < ? and l_discount between ? and ? "
        "and l_quantity < ?"
    ),
    "q1_shape": (
        "select l_returnflag, l_linestatus, sum(l_quantity), sum(l_extendedprice), "
        "sum(l_extendedprice * (1 - l_discount)), avg(l_quantity), count(*) "
        "from lineitem where l_shipdate <= ? group by l_returnflag, l_linestatus "
        "order by l_returnflag, l_linestatus"
    ),
    "q3_shape": (
        "select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue, "
        "o_orderdate, o_shippriority from customer, orders, lineitem "
        "where c_mktsegment = ? and c_custkey = o_custkey and l_orderkey = o_orderkey "
        "and o_orderdate < ? and l_shipdate > ? "
        "group by l_orderkey, o_orderdate, o_shippriority "
        "order by revenue desc, o_orderdate, l_orderkey limit 10"
    ),
    "topn_shape": (
        "select l_orderkey, l_linenumber, l_extendedprice from lineitem "
        "where l_shipdate > ? order by l_extendedprice desc, l_orderkey, l_linenumber limit 10"
    ),
}
FASTPATH_BINDINGS = 20
FASTPATH_SEED = 23
FASTPATH_KERNELS = KERNEL_NAMES
SEGMENTS = ("AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY")
BATCH_THREADS = 8
BATCH_WINDOW_MS = 25


def fastpath_binding(name: str, rng) -> list:
    """One binding of a FASTPATH template as SQL literals."""
    day = lambda base, span: f"date '{_iso(base + int(rng.integers(0, span)))}'"
    if name == "q6_shape":
        y, d = int(rng.integers(1993, 1998)), int(rng.integers(2, 9))
        return [f"date '{y}-01-01'", f"date '{y + 1}-01-01'", f"{(d - 1) / 100:.2f}",
                f"{(d + 1) / 100:.2f}", str(int(rng.integers(10, 50)))]
    if name == "q1_shape":
        return [day(_days(1998, 12, 1) - 120, 61)]
    if name == "q3_shape":
        d = day(_days(1995, 3, 1), 31)
        return [f"'{SEGMENTS[int(rng.integers(0, len(SEGMENTS)))]}'", d, d]
    return [day(_days(1992, 1, 1), 2500)]


def with_literals(sql: str, args) -> str:
    for a in args:
        sql = sql.replace("?", a, 1)
    return sql


def fastpath_phase(engine, scale):
    """The prepared-statement fast path on the card at TPC-H `scale`: four
    templates (Q6-, Q1-, Q3- and TopN-shaped), 20 seeded bindings each through
    EXECUTE, each against Engine.query with the literals on the same engine;
    a binding that hit the plan cache must add no NVRTC compile and no
    learned-capacity entry.  Then a batch window of 8 threads, and the
    fast-path test file's templates at SF 0.01, card vs CPU.  Returns (the
    path's launch counts, phase seconds)."""
    from trino_tpu_torch.ops import kernels
    from trino_tpu_torch.ops.cuda import fused_codegen
    from trino_tpu_torch.runtime.fastpath import EXECUTE_BATCH, PLAN_CACHE_EVENTS

    t_phase = time.perf_counter()
    engine.execute("set session data_plane_kernels = true")
    fp = engine.fastpath()
    counts = dict.fromkeys(KERNEL_NAMES, 0)
    rng = np.random.default_rng(FASTPATH_SEED)
    compared = 0
    for name, sql in FASTPATH.items():
        engine.execute(f"prepare {name} from {sql}")
        ex_ms, q_cold_ms, q_warm_ms, plan_ms, caches = [], [], [], [], []
        added = [0, 0]  # NVRTC compiles and learned-capacity entries the EXECUTEs added
        reruns = 0  # capacity re-runs of the EXECUTEs
        before_all = (len(fused_codegen._COMPILES), len(engine.executor._learned_caps))
        h0, m0 = PLAN_CACHE_EVENTS.value("hit"), PLAN_CACHE_EVENTS.value("miss")
        for i in range(FASTPATH_BINDINGS):
            args = fastpath_binding(name, rng)
            c0, k0 = len(fused_codegen._COMPILES), len(engine.executor._learned_caps)
            before = kernel_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = engine.execute(f"execute {name} using {', '.join(args)}")
            torch.cuda.synchronize()
            ex_ms.append((time.perf_counter() - t0) * 1e3)
            reruns += len(engine.executor.last_retries)
            after = kernel_counts()
            for k in KERNEL_NAMES:
                counts[k] += after[k] - before[k]
            caches.append(fp.last_info.cache)
            c1, k1 = len(fused_codegen._COMPILES), len(engine.executor._learned_caps)
            added[0] += c1 - c0
            added[1] += k1 - k0
            if fp.last_info.cache == "hit" and (c1 > c0 or k1 > k0):
                fail(f"fastpath {name} binding {i}: a plan-cache hit added "
                     f"{c1 - c0} NVRTC compiles and {k1 - k0} learned-capacity entries")
            literal = with_literals(sql, args)
            laps = []
            for _ in range(2):  # the literal statement: a new plan, then warm
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                want = engine.query(literal)
                torch.cuda.synchronize()
                laps.append((time.perf_counter() - t0) * 1e3)
            q_cold_ms.append(laps[0])
            q_warm_ms.append(laps[1])
            t0 = time.perf_counter()
            engine.plan(literal)
            plan_ms.append((time.perf_counter() - t0) * 1e3)
            rows_match(got, want, f"fastpath {name} binding {i} ({args}) vs Engine.query")
            compared += 1
        emit({"phase": "fastpath", "template": name, "scale": scale,
              "bindings": FASTPATH_BINDINGS, "correct": True,
              "bound": fp.last_info.bound, "baked": fp.last_info.baked,
              "execute_warm_ms": statistics.median(ex_ms[1:]), "execute_first_ms": ex_ms[0],
              "query_warm_ms": statistics.median(q_warm_ms),
              "query_cold_ms": statistics.median(q_cold_ms),
              "query_plan_ms": statistics.median(plan_ms),
              "plan_cache_hits": int(PLAN_CACHE_EVENTS.value("hit") - h0),
              "plan_cache_misses": int(PLAN_CACHE_EVENTS.value("miss") - m0),
              # added by the EXECUTEs (all on their plan-cache misses; a hit adds none)
              "nvrtc_compiles_added": added[0], "learned_cap_entries_added": added[1],
              "capacity_reruns": reruns,
              # the process's totals before and after the template's bindings
              # (the literal statements' plans add entries of their own)
              "nvrtc_compiles_before_after": [before_all[0], len(fused_codegen._COMPILES)],
              "learned_cap_entries_before_after": [before_all[1],
                                                   len(engine.executor._learned_caps)],
              "dispatch": sorted({f"{op}/{impl}" for k, e in fp._cache.items() if k[0] == sql
                                  for op, impl, _ in kernels.events_for(e.plan)})})
    for k in FASTPATH_KERNELS:
        if counts[k] < 1:
            fail(f"fastpath never launched {k}: {counts}")

    # one batch window: 8 threads EXECUTE the Q6 shape together
    import threading

    args_list = [fastpath_binding("q6_shape", rng) for _ in range(BATCH_THREADS)]
    wants = [engine.query(with_literals(FASTPATH["q6_shape"], a)) for a in args_list]
    outcomes0 = {o: EXECUTE_BATCH.value(o) for o in ("batched", "single", "fallback")}
    results, errors = [None] * BATCH_THREADS, []
    engine.execute(f"set session execute_batch_window_ms = {BATCH_WINDOW_MS}")

    def run(i):
        try:
            results[i] = engine.execute(f"execute q6_shape using {', '.join(args_list[i])}")
        except Exception as e:  # reported below
            errors.append(repr(e))

    before = kernel_counts()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(i,)) for i in range(BATCH_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    window_ms = (time.perf_counter() - t0) * 1e3
    engine.execute("set session execute_batch_window_ms = 0")
    after = kernel_counts()
    for k in KERNEL_NAMES:
        counts[k] += after[k] - before[k]
    if errors:
        fail(f"fastpath batch window: {errors}")
    for i, (got, want) in enumerate(zip(results, wants)):
        rows_match(got, want, f"fastpath batch window query {i}")
    outcomes = {o: int(EXECUTE_BATCH.value(o) - outcomes0[o]) for o in outcomes0}
    emit({"phase": "fastpath", "step": "batch_window", "threads": BATCH_THREADS,
          "window_ms": BATCH_WINDOW_MS, "wall_ms": window_ms, "correct": True,
          "execute_batch": outcomes})

    # the kernels' calls of one binding against their plain versions
    calls = check_main_path_calls(
        engine, [("fastpath", "true", "q3_shape",
                  f"execute q3_shape using 'BUILDING', date '1995-03-15', date '1995-03-15'",
                  0, ()),
                 ("fastpath", "true", "topn_shape",
                  "execute topn_shape using date '1995-01-01'", 0, ()),
                 ("fastpath", "true", "q6_shape",
                  "execute q6_shape using date '1994-01-01', date '1995-01-01', 0.05, 0.07, 24",
                  0, ())],
        require_all=False)
    missing = set(FASTPATH_KERNELS) - {c["kernel"] for c in calls}
    if missing:
        fail(f"fastpath kernel_calls reached no call of {sorted(missing)}")
    emit({"phase": "fastpath", "step": "kernel_calls", "calls": calls})

    t0 = time.perf_counter()
    cross = fastpath_cross_check(rng)
    emit({"phase": "fastpath", "step": "cross_scale", "scale": 0.01, "correct": True,
          "statements_compared": cross, "seconds": round(time.perf_counter() - t0, 3)})
    emit({"phase": "fastpath", "step": "summary", "bindings_compared": compared})
    torch.cuda.empty_cache()
    return counts, time.perf_counter() - t_phase


def fastpath_cross_check(rng) -> int:
    """The fast-path test file's templates and five bindings of each FASTPATH
    template at SF 0.01 through EXECUTE on a card engine and on
    Engine(device="cpu"), rows compared."""
    mod = nested_test_module("test_torch_fastpath")
    card, host = mod.port_engine("cuda"), mod.port_engine("cpu")
    stmts = [(n, sql, args) for n, (sql, args) in mod.TEMPLATES.items()]
    for name, sql in FASTPATH.items():
        stmts += [(name, sql, fastpath_binding(name, rng)) for _ in range(5)]
    for name, sql, args in stmts:
        for eng in (card, host):
            eng.execute(f"prepare {name} from {sql}")
        stmt = f"execute {name} using {', '.join(args)}"
        rows_match(card.execute(stmt), host.execute(stmt),
                   f"fastpath SF 0.01 {name} {args}: cuda vs cpu engine")
    return len(stmts)


# ------------------------------------------------------- files and lakehouse

LAKE_ROW_GROUP = 262_144  # lineitem and orders: lineitem's 8 slices are uneven
LAKE_FAKER_ROWS = 8_388_608  # at scale 1
LAKE_CROSS_SCALE = 0.005  # cut from 0.01 so that the script keeps within its time
# the Faker table of the SF 0.01 cross-check: the CPU engine's plain hash
# build walks a round per collision chain, and its GROUP BY user_id over a
# hundredth of the full table (~53 K groups) costs tens of seconds
LAKE_CROSS_FAKER_ROWS = 8_192
LAKE_OOC = ("q01", "q18")  # out of core over Parquet, 8 parts
LAKE_KERNEL_CHECKS = ("q01", "q18", "faker_top_users")  # held against the plain versions
# a Q3 / Q10-shaped join across three catalogs; the same SQL runs on `tpch`
LAKE_JOIN = """
select c_custkey, c_name, sum(l_extendedprice * (1 - l_discount)) as revenue, n_name
from {c}customer, {o}orders, {l}lineitem, {c}nation
where c_custkey = o_custkey and l_orderkey = o_orderkey
  and o_orderdate >= date '1993-10-01' and o_orderdate < date '1994-01-01'
  and l_returnflag = 'R' and c_nationkey = n_nationkey
group by c_custkey, c_name, n_name
order by revenue desc, c_custkey
limit 20
"""
ORDERS_COLS = ("o_orderkey, o_custkey, o_orderstatus, o_totalprice, o_orderdate, "
               "o_orderpriority, o_clerk, o_shippriority, o_comment")
KEY_SHIFT = 100_000_000  # inserted orders get keys past every generated one
# the writes to Iceberg, in order: each commits one snapshot (the CTAS two:
# the create's empty one first)
ICEBERG_STEPS = (
    ("ctas", "create table iceberg.orders as select * from parquet.orders"),
    ("insert", f"insert into iceberg.orders select o_orderkey + {KEY_SHIFT}, "
               + ORDERS_COLS.split(", ", 1)[1]
               + " from parquet.orders where o_orderdate < date '1993-01-01'"),
    ("delete", "delete from iceberg.orders where o_orderdate >= date '1995-01-01' "
               "and o_orderdate < date '1996-01-01'"),
    ("update", "update iceberg.orders set o_totalprice = o_totalprice + 1.00 "
               "where o_orderpriority = '1-URGENT'"),
)
ICEBERG_TOTALS = "select count(*), sum(o_totalprice) from iceberg.{t}"
ICEBERG_PREPARED = ("select count(*), sum(o_totalprice) from iceberg.orders "
                    "where o_orderdate >= ?")
ICEBERG_LATE = (f"insert into iceberg.orders select o_orderkey + {2 * KEY_SHIFT}, "
                + ORDERS_COLS.split(", ", 1)[1]
                + " from parquet.orders where o_orderdate >= date '1998-01-01'")
FAKER = {
    "faker_users": ("select count(*), sum(c), sum(c * c), max(c), sum(s) from "
                    "(select user_id, count(*) as c, sum(amount) as s "
                    "from faker.events group by user_id)"),
    "faker_top_users": ("select user_id, count(*) as c from faker.events group by user_id "
                        "order by c desc, user_id limit 10"),
    "faker_kind_day": ("select kind, day, count(*), sum(amount) from faker.events "
                       "group by kind, day order by kind, day"),
}


def write_lake(root: str, scale: float) -> dict:
    """TPC-H at `scale` written under `root` by the port's conversions: the 8
    tables as Parquet (lineitem and orders in row groups of 262,144 rows),
    lineitem and orders as ORC, customer and nation in a SQLite file.
    Returns seconds by step."""
    import os
    import sqlite3

    import pyarrow as pa
    import pyarrow.orc as orc
    import pyarrow.parquet as pq

    from trino_tpu_torch.connectors.parquet import _numpy_to_arrow
    from trino_tpu_torch.connectors.tpch import tpch_data
    from trino_tpu_torch.connectors.tpch.generator import TPCH_SCHEMAS

    secs = dict.fromkeys(("convert_s", "parquet_s", "orc_s", "sqlite_s"), 0.0)

    def lap(key, t0):
        secs[key] += time.perf_counter() - t0

    for table, schema in TPCH_SCHEMAS.items():
        data = tpch_data(table, scale)
        t0 = time.perf_counter()
        tbl = pa.table({c: _numpy_to_arrow(data[c], t) for c, t in schema})
        lap("convert_s", t0)
        if table == "lineitem":
            secs.update(conversion_times(data, dict(schema), tbl))
        t0 = time.perf_counter()
        os.makedirs(os.path.join(root, "parquet", table))
        groups = LAKE_ROW_GROUP if table in ("lineitem", "orders") else None
        pq.write_table(tbl, os.path.join(root, "parquet", table, "part-0.parquet"),
                       row_group_size=groups)
        lap("parquet_s", t0)
        if table in ("lineitem", "orders"):
            t0 = time.perf_counter()
            os.makedirs(os.path.join(root, "orc", table))
            orc.write_table(tbl, os.path.join(root, "orc", table, "part-0.orc"))
            lap("orc_s", t0)
        if table in ("customer", "nation"):
            t0 = time.perf_counter()
            decl = lambda t: ("text" if t.is_string else f"decimal({t.precision},{t.scale})"
                              if t.is_decimal else "integer")
            cols = [data[c].tolist() if not t.is_decimal else (data[c] / 10.0**t.scale).tolist()
                    for c, t in schema]
            db = sqlite3.connect(os.path.join(root, "tpch.db"))
            try:
                db.execute(f"create table {table} ("
                           + ", ".join(f"{c} {decl(t)}" for c, t in schema) + ")")
                db.executemany(f"insert into {table} values ({', '.join('?' * len(schema))})",
                               zip(*cols))
                db.commit()
            finally:
                db.close()
            lap("sqlite_s", t0)
    secs["write_s"] = sum(secs[k] for k in ("convert_s", "parquet_s", "orc_s", "sqlite_s"))
    return secs


def conversion_times(li: dict, types: dict, tbl) -> dict:
    """Host seconds per million values of the two conversions the port
    vectorises, beside the per-value loops the JAX package's module runs
    (the port's copy still runs them for object lanes): l_extendedprice into
    a decimal128 arrow array from its int64 lanes, and l_comment out of
    arrow through one to_numpy call against to_pylist."""
    from trino_tpu_torch.connectors.parquet import _column_to_numpy, _numpy_to_arrow

    n = min(1_000_000, len(li["l_extendedprice"]))
    lanes, t = li["l_extendedprice"][:n], types["l_extendedprice"]
    comments = tbl.column("l_comment").slice(0, n)

    def per_million(fn) -> float:
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e6 / n

    return {"decimal_to_arrow_s_per_million": per_million(lambda: _numpy_to_arrow(lanes, t)),
            "decimal_per_value_s_per_million": per_million(
                lambda: _numpy_to_arrow(lanes.astype(object), t)),
            "varchar_to_numpy_s_per_million": per_million(
                lambda: _column_to_numpy(comments, types["l_comment"])),
            "varchar_to_pylist_s_per_million": per_million(
                lambda: np.asarray(comments.to_pylist(), dtype=object))}


def lake_engine(device, root: str, faker_rows: int, warehouse: str):
    """An engine over the files of write_lake (default catalog `parquet`,
    also `orc`, `sqlite`), an empty Iceberg warehouse under `root`, and a
    Faker `events` table of `faker_rows` rows made through the connector
    API."""
    import os

    from trino_tpu_torch.connectors.dbapi import SqliteConnector
    from trino_tpu_torch.connectors.faker import FakerConnector
    from trino_tpu_torch.connectors.iceberg import IcebergConnector
    from trino_tpu_torch.connectors.orc import OrcConnector
    from trino_tpu_torch.connectors.parquet import ParquetConnector
    from trino_tpu_torch.connectors.spi import ColumnSchema
    from trino_tpu_torch.data.types import BIGINT, DATE, DOUBLE, VARCHAR
    from trino_tpu_torch.runtime.engine import Engine

    eng = Engine(default_catalog="parquet", device=device)
    eng.register_catalog("parquet", ParquetConnector(os.path.join(root, "parquet")))
    eng.register_catalog("orc", OrcConnector(os.path.join(root, "orc")))
    eng.register_catalog("sqlite", SqliteConnector(os.path.join(root, "tpch.db")))
    eng.register_catalog("iceberg", IcebergConnector(os.path.join(root, warehouse)))
    faker = FakerConnector()
    faker.create_table("events", [ColumnSchema("user_id", BIGINT),
                                  ColumnSchema("amount", DOUBLE), ColumnSchema("kind", VARCHAR),
                                  ColumnSchema("day", DATE)],
                       rows=faker_rows)
    eng.register_catalog("faker", faker)
    return eng


def on_orc(sql: str) -> str:
    import re

    return re.sub(r"\blineitem\b", "orc.lineitem", sql)


class ScanClock:
    """Host time of the cold scans of one statement, by step: the Parquet and
    ORC connectors' read_split (the file read, and within it the arrow to
    numpy conversion), the VARCHAR dictionary encode, and what is left of the
    upload (padding, the copies to the card).  Wraps those functions while
    it is open."""

    def __init__(self):
        from trino_tpu_torch.connectors import orc, parquet
        from trino_tpu_torch.data import page

        self.mods = parquet, orc, page
        self.real = (parquet.ParquetConnector.read_split, orc.OrcConnector.read_split,
                     parquet._column_to_numpy, page.Dictionary.encode)
        self.encodes = []  # (rows, distinct values, ms) of each encode

    def reset(self):
        self.read_ms = self.convert_ms = self.encode_ms = 0.0
        self.rows = 0

    def __enter__(self):
        parquet, orc, page = self.mods
        read_pq, read_orc, convert, encode = self.real
        clock = self
        self.reset()

        def timed(read):
            def timed_read(conn, split, columns):
                t0 = time.perf_counter()
                out = read(conn, split, columns)
                clock.read_ms += (time.perf_counter() - t0) * 1e3
                clock.rows += len(next(iter(out.values()))) if out else 0
                return out
            return timed_read

        def timed_convert(chunked, t):
            t0 = time.perf_counter()
            out = convert(chunked, t)
            clock.convert_ms += (time.perf_counter() - t0) * 1e3
            return out

        def timed_encode(values):
            t0 = time.perf_counter()
            codes, d = encode(values)
            ms = (time.perf_counter() - t0) * 1e3
            clock.encode_ms += ms
            clock.encodes.append((len(codes), len(d.values), ms))
            return codes, d

        parquet.ParquetConnector.read_split = timed(read_pq)
        orc.OrcConnector.read_split = timed(read_orc)
        parquet._column_to_numpy = orc._column_to_numpy = timed_convert
        page.Dictionary.encode = staticmethod(timed_encode)
        return self

    def __exit__(self, *exc):
        parquet, orc, page = self.mods
        parquet.ParquetConnector.read_split, orc.OrcConnector.read_split = self.real[:2]
        parquet._column_to_numpy = orc._column_to_numpy = self.real[2]
        page.Dictionary.encode = staticmethod(self.real[3])


def lake_statements() -> dict:
    """The read statements of the lake path: the 22 TPC-H queries and the
    ten most expensive line items over Parquet, Q1 / Q6 over ORC, the join
    across SQLite, Parquet and ORC, the Faker GROUP BYs."""
    queries, _ = tpch_queries()
    stmts = {n: queries[n] for n in sorted(queries)}
    stmts["topn"] = TOPN
    stmts["orc_q01"], stmts["orc_q06"] = on_orc(Q01), on_orc(Q06)
    stmts["cross_join"] = LAKE_JOIN.format(c="sqlite.", o="parquet.", l="orc.")
    stmts.update(FAKER)
    return stmts


def iceberg_sequence(eng, counted, measure: bool) -> dict:
    """The Iceberg steps on `eng` (each write timed as query / export /
    commit with `measure`), the totals of every snapshot through
    "orders@N", "orders$snapshots", a rollback, and one prepared EXECUTE
    before and after a commit.  Returns name -> rows, plus the writes'
    timings under "writes"."""
    conn = eng.catalogs.get("iceberg")
    sync = torch.cuda.synchronize if eng.device.type == "cuda" else (lambda: None)
    out, writes = {}, []
    for step, sql in ICEBERG_STEPS:
        eng._last_txn_info = None
        sync()
        t0 = time.perf_counter()
        out[f"iceberg_{step}"] = counted(lambda: eng.execute(sql))
        sync()
        info = eng._last_txn_info
        writes.append({"step": step, "wall_ms": (time.perf_counter() - t0) * 1e3,
                       **eng.last_write_split, "commit_ms": info and info["commit_ms"],
                       "result": out[f"iceberg_{step}"]})
        out[f"iceberg_{step}_totals"] = counted(
            lambda: eng.execute(ICEBERG_TOTALS.format(t="orders")))
    snaps = [s["snapshot_id"] for s in conn.snapshots("orders")]
    for sid in snaps:
        out[f"iceberg_at_{sid}"] = counted(
            lambda: eng.execute(ICEBERG_TOTALS.format(t=f'"orders@{sid}"')))
    out["iceberg_snapshots"] = counted(lambda: eng.execute(
        'select snapshot_id, file_count, row_count from iceberg."orders$snapshots" '
        "order by snapshot_id"))
    conn.rollback_to_snapshot("orders", snaps[2])  # back to the INSERT's snapshot
    out["iceberg_rolled_back"] = counted(lambda: eng.execute(ICEBERG_TOTALS.format(t="orders")))
    eng.execute(f"prepare lake_p from {ICEBERG_PREPARED}")
    fp = eng.fastpath()
    out["execute_before"] = counted(lambda: eng.execute("execute lake_p using date '1994-01-01'"))
    out["execute_again"] = counted(lambda: eng.execute("execute lake_p using date '1994-01-01'"))
    cache_again = fp.last_info.cache
    out["iceberg_late"] = counted(lambda: eng.execute(ICEBERG_LATE))
    out["execute_after"] = counted(lambda: eng.execute("execute lake_p using date '1994-01-01'"))
    from trino_tpu_torch.exec.compiler import _generation

    gens = {k[-1] for k in eng.executor._table_cols if k[:2] == ("iceberg", "orders")}
    if cache_again != "hit" or fp.last_info.cache != "miss":
        fail(f"lake iceberg: EXECUTE plan cache {cache_again} before the commit and "
             f"{fp.last_info.cache} after it (expected hit, then miss)")
    if gens != {_generation(conn, "orders")}:
        fail(f"lake iceberg: the scan cache holds generations {gens} after the commit")
    out["writes"] = writes if measure else None
    return out


def iceberg_reference(orders: dict) -> dict:
    """numpy over the generator's orders: count and price total of each
    snapshot, in the order of ICEBERG_STEPS (the create's empty snapshot
    first), and of the EXECUTE before and after the late INSERT."""
    day = orders["o_orderdate"]
    price = orders["o_totalprice"].astype(np.int64)
    urgent = _strs(orders["o_orderpriority"]) == "1-URGENT"
    early = day < _days(1993, 1, 1)
    # the table as (dates, prices, urgent flags) after each step
    base = (day, price, urgent)
    ins = tuple(np.concatenate([a, a[early]]) for a in base)
    keep = ~((ins[0] >= _days(1995, 1, 1)) & (ins[0] < _days(1996, 1, 1)))
    dele = tuple(a[keep] for a in ins)
    upd = (dele[0], dele[1] + np.where(dele[2], 100, 0), dele[2])
    late = day >= _days(1998, 1, 1)
    tot = lambda t: (len(t[0]), dec(exact_sum(t[1]), 2))
    after_rollback = tuple(np.concatenate([a, b[late]]) for a, b in zip(ins, base))
    since = lambda t: (int((t[0] >= _days(1994, 1, 1)).sum()),
                       dec(exact_sum(t[1][t[0] >= _days(1994, 1, 1)]), 2))
    return {"snapshots": [(0, None)] + [tot(t) for t in (base, ins, dele, upd)],
            "rolled_back": tot(ins), "execute_before": since(ins),
            "execute_after": since(after_rollback)}


def faker_reference(eng) -> dict:
    """numpy over the Faker connector's own read_split columns."""
    conn = eng.catalogs.get("faker")
    cols = conn.read_split(conn.get_splits("events", 1)[0], ["user_id", "amount", "kind", "day"])
    uid, amount = cols["user_id"], cols["amount"]
    users, first, counts = np.unique(uid, return_index=True, return_counts=True)
    top = np.lexsort((users, -counts))[:10]
    kinds = _strs(cols["kind"])
    keys = np.rec.fromarrays([kinds, cols["day"]])
    groups, inv = np.unique(keys, return_inverse=True)
    per_count = np.bincount(inv.ravel())
    per_sum = np.bincount(inv.ravel(), weights=amount)
    per_abs = np.bincount(inv.ravel(), weights=np.abs(amount))
    return {
        "faker_users": (len(users), int(counts.sum()), int((counts.astype(np.int64) ** 2).sum()),
                        int(counts.max()), float(amount.sum()), float(np.abs(amount).sum())),
        "faker_top_users": [(int(users[i]), int(counts[i])) for i in top],
        "faker_kind_day": [(str(g[0]), _iso(int(g[1])), int(c), float(sm), float(ab))
                           for g, c, sm, ab in zip(groups, per_count, per_sum, per_abs)],
        "rows": len(uid),
    }


def faker_match(rows: dict, want: dict, what: str) -> None:
    n = want["rows"]
    g, total, squares, most, s = rows["faker_users"][0]
    users, w_total, w_squares, w_most, w_sum, w_abs = want["faker_users"]
    if (g, total, squares, most) != (users, w_total, w_squares, w_most):
        fail(f"{what} faker_users: {(g, total, squares, most)} != "
             f"{(users, w_total, w_squares, w_most)}")
    if abs(s - w_sum) > sum_tolerance(n) * w_abs:
        fail(f"{what} faker_users: sum {s} != {w_sum}")
    rows_match(rows["faker_top_users"], want["faker_top_users"], f"{what} faker_top_users")
    got = rows["faker_kind_day"]
    if len(got) != len(want["faker_kind_day"]):
        fail(f"{what} faker_kind_day: {len(got)} groups, expected {len(want['faker_kind_day'])}")
    for r, (x, (k, d, c, sm, ab)) in enumerate(zip(got, want["faker_kind_day"])):
        if (x[0], str(x[1]), x[2]) != (k, d, c) or abs(x[3] - sm) > sum_tolerance(c) * ab:
            fail(f"{what} faker_kind_day row {r}: {x} != {(k, d, c, sm)}")


def run_lake(eng, measure: bool) -> dict:
    """The lake path once on `eng`: every statement of lake_statements,
    out of core over Parquet, the Iceberg sequence.  With `measure` (the
    card at full size) each read statement's cold run is split by host step
    and timed warm, and the launches of every statement's first run are
    counted.  Returns name -> rows, and the measurements."""
    cuda = eng.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    counts = dict.fromkeys(KERNEL_NAMES, 0)

    def counted(fn):
        before = kernel_counts() if measure else None
        out = fn()
        if measure:
            after = kernel_counts()
            for k in KERNEL_NAMES:
                counts[k] += after[k] - before[k]
        return out

    rows, lines = {}, []
    eng.execute("set session data_plane_kernels = true")
    clock = ScanClock()
    for name, sql in lake_statements().items():
        groups0 = {impl: dispatch_count("group_by", impl) for impl in ("cuda", "sort", "torch")}
        with clock:
            before = kernel_counts() if measure else None
            sync()
            t0 = time.perf_counter()
            rows[name] = counted(lambda: eng.query(sql))
            sync()
            cold_ms = (time.perf_counter() - t0) * 1e3
        if not measure:
            continue
        after = kernel_counts()
        up = eng.executor.last_upload_ms
        line = {"phase": "lake", "query": name, "rows": len(rows[name]),
                "cold_ms": cold_ms, "file_read_ms": clock.read_ms - clock.convert_ms,
                "convert_ms": clock.convert_ms, "encode_ms": clock.encode_ms,
                "upload_ms": up - clock.read_ms - clock.encode_ms, "execute_ms": cold_ms - up,
                "rows_scanned": clock.rows,
                "scan_rows_per_s": clock.rows / (up / 1e3) if up else None,
                "first_run_retries": list(eng.executor.last_retries),
                "group_by": {impl: dispatch_count("group_by", impl) - n
                             for impl, n in groups0.items()},
                "launches": {k: after[k] - before[k] for k in KERNEL_NAMES}}
        if name in ("faker_users", "faker_top_users") and line["group_by"]["cuda"] < 1:
            fail(f"lake {name}: GROUP BY user_id did not take the hash path: "
                 f"{line['group_by']}")
        line["warm_ms"] = warm_median(eng, sql, SHORT_RUNS)
        busy = device_busy(eng, sql, 3)
        line.update(device_busy_ms=busy["device_busy_ms"], top_kernels=busy["top_kernels"],
                    device_idle_share=None if busy["device_busy_ms"] is None
                    else 1.0 - busy["device_busy_ms"] / line["warm_ms"])
        lines.append(line)
    # out of core over Parquet: lineitem's 23 row groups in 8 uneven slices
    from trino_tpu_torch.exec.spill import estimate_plan_bytes

    queries, _ = tpch_queries()
    ooc = {}
    for name in LAKE_OOC:
        sql = Q01 if name == "q01" else queries[name]
        est = estimate_plan_bytes(eng.plan(sql), eng.catalogs)
        if measure:
            eng.session.set("query_max_memory_bytes", "-1")
            mem_rows, peak_mem, _ = peak_run(eng, sql)
        else:
            mem_rows = eng.query(sql)
        eng.session.set("query_max_memory_bytes", str(est // 6))
        if measure:
            before = kernel_counts()
            got, peak, ms = peak_run(eng, sql)
            after = kernel_counts()
            for k in KERNEL_NAMES:
                counts[k] += after[k] - before[k]
        else:
            got = eng.query(sql)
        eng.session.set("query_max_memory_bytes", "0")
        spill = eng.last_spill
        if spill is None or spill.parts != SPILL_PARTS:
            fail(f"lake out of core {name}: expected {SPILL_PARTS} parts, got "
                 f"{spill and spill.parts}")
        rows_agree(got, mem_rows, name, f"lake out of core {name} vs in memory")
        rows[f"ooc_{name}"] = got
        ooc[name] = {"parts": spill.parts, "spill_files": spill.spill_files,
                     "slices_that_retried": len(spill.slice_retries)}
        if measure:
            if peak >= peak_mem:
                fail(f"lake out of core {name}: peak {peak} is not below the in-memory "
                     f"peak {peak_mem}")
            ooc[name].update(cold_ms=ms, peak_bytes=peak, peak_bytes_in_memory=peak_mem,
                             spilled_bytes=spill.spilled_bytes,
                             slice_retries=spill.slice_retries)
    rows.update(iceberg_sequence(eng, counted, measure))
    return {"rows": rows, "lines": lines, "ooc": ooc, "launches": counts,
            "encodes": sorted(clock.encodes, key=lambda e: -e[2])[:5]}


def lake_check(rows: dict, scale: float, tpch_rows, eng, tpch_engine, what: str) -> None:
    """The lake path's rows against their references: the `tpch` connector's
    rows of each query (from the tpch phase at full size, else run here on
    `tpch_engine`), ORC against Parquet, the cross-catalog join and the TopN
    against `tpch_engine`, Iceberg against numpy over the generator's orders,
    Faker against numpy over the connector's own columns."""
    from trino_tpu_torch.connectors.tpch import tpch_data

    queries, ordered = tpch_queries()
    for name in sorted(queries):
        want = tpch_rows[name] if tpch_rows is not None else tpch_engine.query(queries[name])
        rows_agree(rows[name], want, name, f"{what} {name} (Parquet) vs tpch", ordered)
    rows_match(rows["topn"], tpch_engine.query(TOPN), f"{what} topn (Parquet) vs tpch")
    for q in ("q01", "q06"):
        rows_match(rows[f"orc_{q}"], rows[q], f"{what} {q}: ORC vs Parquet")
    rows_match(rows["cross_join"], tpch_engine.query(LAKE_JOIN.format(c="", o="", l="")),
               f"{what} cross-catalog join vs tpch")
    want = iceberg_reference(tpch_data("orders", scale))
    totals = [rows[f"iceberg_at_{i}"][0] for i in range(1, len(want["snapshots"]) + 1)]
    rows_match(totals, want["snapshots"], f"{what} iceberg snapshot totals")
    for k, (step, _) in enumerate(ICEBERG_STEPS, 1):
        rows_match(rows[f"iceberg_{step}_totals"], [want["snapshots"][k]],
                   f"{what} iceberg after {step}")
    rows_match([(r[0], r[2]) for r in rows["iceberg_snapshots"]],
               [(i + 1, c) for i, (c, _) in enumerate(want["snapshots"])],
               f"{what} iceberg orders$snapshots")
    rows_match(rows["iceberg_rolled_back"], [want["rolled_back"]], f"{what} iceberg rollback")
    rows_match(rows["execute_before"], [want["execute_before"]], f"{what} EXECUTE before")
    rows_match(rows["execute_again"], [want["execute_before"]], f"{what} EXECUTE again")
    rows_match(rows["execute_after"], [want["execute_after"]], f"{what} EXECUTE after commit")
    faker_match(rows, faker_reference(eng), what)


def lake_cross_check(tmp: str) -> int:
    """The lake path at LAKE_CROSS_SCALE on a card engine and on Engine(device="cpu"),
    every statement's rows compared, every result held as at full size; the
    CPU engine's run makes no CUDA allocation."""
    import os

    root = os.path.join(tmp, "cross")
    write_lake(root, LAKE_CROSS_SCALE)
    card = lake_engine("cuda", root, LAKE_CROSS_FAKER_ROWS, "warehouse-cuda")
    host = lake_engine("cpu", root, LAKE_CROSS_FAKER_ROWS, "warehouse-cpu")
    got = run_lake(card, measure=False)["rows"]
    torch.cuda.synchronize()
    before = cuda_allocations()
    exp = run_lake(host, measure=False)["rows"]
    if cuda_allocations() != before:
        fail(f"lake SF {LAKE_CROSS_SCALE}: the CPU engine's run allocated on the card")
    queries, ordered = tpch_queries()
    for name in got:
        if name == "writes":
            continue
        rows_agree(got[name], exp[name], name, f"lake SF {LAKE_CROSS_SCALE} {name}: cuda vs cpu engine",
                   ordered)
    ref = tpch_engine("cuda", LAKE_CROSS_SCALE)
    lake_check(got, LAKE_CROSS_SCALE, None, card, ref, f"lake SF {LAKE_CROSS_SCALE}")
    return len(got) - 1


def lake_phase(engine, scale, tpch_rows):
    """The file and lakehouse connectors on the card at TPC-H `scale`: the
    tables written to Parquet, ORC and SQLite in a temporary directory (removed
    at the end), the 22 queries from Parquet against the tpch phase's rows,
    ORC, a join across three catalogs, out of core over uneven row groups,
    Iceberg writes, time travel and EXECUTE across a commit, Faker GROUP BYs;
    the kernels' calls against their plain versions; then the same at
    LAKE_CROSS_SCALE, card vs CPU.  Returns (the path's launch counts, phase
    seconds)."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    engine.executor.drop_scans()
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_lake_")
    try:
        secs = write_lake(tmp, scale)
        emit({"phase": "lake", "step": "write", "scale": scale,
              **{k: round(v, 3) for k, v in secs.items()}})
        eng = lake_engine("cuda", tmp, int(LAKE_FAKER_ROWS * scale), "warehouse")
        out = run_lake(eng, measure=True)
        rows = out["rows"]
        for line in out["lines"]:
            emit(line)
        for name, rec in out["ooc"].items():
            emit({"phase": "lake", "step": "out_of_core", "query": name, "correct": True, **rec})
        for w in rows["writes"]:
            emit({"phase": "lake", "step": "iceberg_write", "write": w.pop("step"), **w})
        lake_check(rows, scale, tpch_rows, eng, engine, "lake")
        counts = out["launches"]
        for k in KERNEL_NAMES:
            if counts[k] < 1:
                fail(f"lake path never launched {k}: {counts}")
        stmts = lake_statements()
        calls = check_main_path_calls(
            eng, [("lake", "true", n, stmts[n], 0, ()) for n in LAKE_KERNEL_CHECKS],
            require_all=False)
        missing = set(KERNEL_NAMES) - {c["kernel"] for c in calls}
        if missing:
            fail(f"lake kernel_calls reached no call of {sorted(missing)}")
        emit({"phase": "lake", "step": "kernel_calls", "calls": calls})
        emit({"phase": "lake", "step": "encodes", "largest": out["encodes"]})
        del eng
        engine.executor.drop_scans()
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        n = lake_cross_check(tmp)
        emit({"phase": "lake", "step": "cross_scale", "scale": LAKE_CROSS_SCALE, "correct": True,
              "statements_compared": n, "seconds": round(time.perf_counter() - t0, 3)})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    emit({"phase": "lake", "step": "summary", "scale": scale, "seconds": round(seconds, 1),
          "statements": len(out["lines"]), "launches": counts})
    torch.cuda.empty_cache()
    return counts, seconds


# ------------------------------------------------------- distributed plane

DIST_WORKERS = 4  # Engine(distributed=True, devices=["cuda:0"] * 4): four workers, one card
DIST_KERNELS = ("segment_reduce", "hash_build", "hash_probe", "radix_select")  # must launch
DIST_OPERATORS = ("q03", "q18")  # again with data_plane_kernels = false
DIST_CROSS_SCALE = 0.01
DIST_CASES_FILE = Path(__file__).resolve().parent / "tests" / "distributed_cases.py"
TPCH_WARM_MS: dict = {}  # query -> the tpch phase's warm_ms (filled by measure_lines)


def dist_engine(device, scale, devices, catalog: str = "tpch", conn=None):
    """A distributed engine over `devices` (None: every visible card) with
    TPC-H at `scale`, or `conn` as `catalog`."""
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.runtime.engine import Engine

    eng = Engine(default_catalog=catalog, device=device, distributed=True, devices=devices)
    eng.register_catalog(catalog, conn if conn is not None else TpchConnector(scale))
    return eng


def distributed_cases():
    """tests/distributed_cases.py (the distributed test files' statements and
    tables; it imports neither JAX nor the tests package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("distributed_cases", DIST_CASES_FILE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def exchange_host_reads(engine, sql) -> tuple:
    """One run of `sql` with every exchange of the distributed executor
    watched: (rows, [(op, elements)] of each read from the card into host
    memory made inside an exchange — a host value, a numpy array, or a copy
    to the CPU)."""
    from torch.overrides import TorchFunctionMode

    import trino_tpu_torch.exec.spmd as spmd

    reads, inside = [], [0]
    host_ops = {"tolist", "numpy", "item", "cpu", "__array__", "__int__", "__float__",
                "__bool__", "__index__"}

    class Watch(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = getattr(func, "__name__", "")
            if inside[0] and args and isinstance(args[0], torch.Tensor):
                src = args[0]
                targets = [str(a) for a in list(args[1:]) + list(kwargs.values())]
                if src.is_cuda and (name in host_ops or (
                        name == "to" and any(t.startswith("cpu") for t in targets))):
                    reads.append((name, src.numel()))
                elif (name == "copy_" and not src.is_cuda and len(args) > 1
                      and isinstance(args[1], torch.Tensor) and args[1].is_cuda):
                    reads.append((name, args[1].numel()))
            return func(*args, **kwargs)

    def watched(fn):
        def run(*a, **k):
            inside[0] += 1
            try:
                return fn(*a, **k)
            finally:
                inside[0] -= 1
        return run

    saved = spmd.repartition, spmd.gather_all
    spmd.repartition, spmd.gather_all = watched(saved[0]), watched(saved[1])
    try:
        with Watch():
            rows = engine.query(sql)
    finally:
        spmd.repartition, spmd.gather_all = saved
    return rows, reads


def distributed_cross_check() -> dict:
    """At SF 0.01, a distributed card engine (four workers on one card)
    against Engine(device="cpu", distributed=True) over four CPU workers:
    EXPLAIN ANALYZE row counts of Q3 and of the test files' four-exchange
    statement, then every statement of the distributed test files
    (tests/distributed_cases.py), rows compared and held against the test's
    expected rows where it states them."""
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.plan.nodes import format_plan

    cases = distributed_cases()
    queries, ordered = tpch_queries()
    dev0 = torch.device("cuda", 0)
    card = dist_engine("cuda", DIST_CROSS_SCALE, [dev0] * DIST_WORKERS)
    host = dist_engine("cpu", DIST_CROSS_SCALE, ["cpu"] * DIST_WORKERS)
    out = {}

    def same_counts(a, b, sql, what):
        pa, pb = a.plan(sql), b.plan(sql)
        if format_plan(pa) != format_plan(pb):
            fail(f"distributed {what}: the card's distributed plan differs from the CPU's")
        _, got = a.executor.explain_analyze(pa)
        _, want = b.executor.explain_analyze(pb)
        if got != want:
            fail(f"distributed {what}: EXPLAIN ANALYZE rows {got} != the CPU's {want}")
        return {nid: s["rows"] for nid, s in got.items()}

    out["q03_explain_rows"] = same_counts(card, host, queries["q03"], "q03 SF 0.01")
    text = [r[0] for r in card.execute("explain analyze " + queries["q03"])]
    if not text[0].startswith("TopN") or "[rows: " not in text[0]:
        fail(f"distributed EXPLAIN ANALYZE q03 renders {text[:2]}")
    for name, (sql, _oracle_sql) in cases.tpch_cases().items():
        rows_agree(card.query(sql), host.query(sql), name,
                   f"distributed SF 0.01 {name}: cuda vs cpu", {name: False})
    mem_card = dist_engine("cuda", None, [dev0] * DIST_WORKERS, "memory", MemoryConnector())
    mem_host = dist_engine("cpu", None, ["cpu"] * DIST_WORKERS, "memory", MemoryConnector())
    for name, (setup, sql, want) in cases.MEMORY_CASES.items():
        for stmt in setup:
            mem_card.execute(stmt)
            mem_host.execute(stmt)
        got = mem_card.execute(sql)
        rows_match(got, mem_host.execute(sql), f"distributed {name}: cuda vs cpu")
        rows_match(got, want, f"distributed {name}: cuda vs the test's rows")
    tables = [dist_engine(dev, None, [dev] * DIST_WORKERS, "mem",
                          cases.explain_tables("trino_tpu_torch")) for dev in (dev0, "cpu")]
    out["explain_rows"] = same_counts(*tables, cases.EXPLAIN_SQL, "four-exchange statement")
    buckets = [dist_engine(dev, None, [dev] * DIST_WORKERS, "mem",
                           cases.bucketed_tables("trino_tpu_torch", cases.bucket_inserts()))
               for dev in (dev0, "cpu")]
    rows_match(unordered(buckets[0].query(cases.BUCKET_GROUP_BY)),
               unordered(buckets[1].query(cases.BUCKET_GROUP_BY)),
               "distributed bucketed GROUP BY: cuda vs cpu")
    out["statements"] = len(cases.tpch_cases()) + len(cases.MEMORY_CASES) + 2
    return out


def distributed_phase(engine, scale, tpch_rows):
    """The distributed plane on the card at TPC-H `scale`: the 22 queries
    and the ten most expensive line items (TOPN) through
    Engine(distributed=True, devices=["cuda:0"] * 4), each against the tpch
    phase's rows (TOPN: the TPC-H engine's), with warm_ms beside the tpch
    phase's, cold_ms and
    peak device bytes from a cold scan cache, fragments, bytes moved per
    exchange kind, idle share and launches; Q3 and Q18 again with kernels
    off; a warm run that uploads nothing and reads no exchanged column to
    the host; the kernels' calls of Q18 against their plain versions; then
    SF 0.01 card vs CPU (distributed_cross_check) and, where the machine
    has more than one card, Q3 and Q18 over every card.  Returns (the
    path's launch counts, phase seconds)."""
    t_phase = time.perf_counter()
    queries, ordered = tpch_queries()
    # the ten most expensive line items: a partial TopN over every task's
    # 1.5 M-row shard (radix select), a gather, the final TopN
    want = dict(tpch_rows, topn=engine.query(TOPN))
    engine.executor.drop_scans()
    gc.collect()
    torch.cuda.empty_cache()
    queries = dict(queries, topn=TOPN)
    dev0 = torch.device("cuda", 0)
    eng = dist_engine("cuda", scale, [dev0] * DIST_WORKERS)
    path = [(name, "true") for name in sorted(queries)]
    path += [(name, "false") for name in DIST_OPERATORS]
    # every count to 0 just before the path, read just after
    reset_kernel_counts()
    for name, flag in path:
        sql = queries[name]
        eng.execute(f"set session data_plane_kernels = {flag}")
        before = kernel_counts()
        rows, peak, cold = peak_run(eng, sql)
        after = kernel_counts()
        ex = eng.executor
        moved, fragments = dict(ex.last_exchange_bytes), ex.fragments
        what = f"distributed {name} (data_plane_kernels = {flag})"
        rows_agree(rows, want[name], name, f"{what} vs tpch", ordered)
        warm = warm_median(eng, sql, 1)
        if ex.last_upload_ms:
            fail(f"{what}: a warm run uploaded ({ex.last_upload_ms} ms)")
        busy = traced_busy(lambda: eng.query(sql), 1)
        idle = None if busy["device_busy_ms"] is None else 1.0 - busy["device_busy_ms"] / warm
        emit({"phase": "distributed", "query": name, "workers": DIST_WORKERS,
              "data_plane_kernels": flag, "rows": len(rows), "correct": True,
              "warm_ms": warm, "warm_ms_tpch": TPCH_WARM_MS.get(name) if flag == "true" else None,
              "cold_ms": cold, "peak_bytes": peak, "fragments": fragments,
              "exchange_bytes": moved, "device_idle_share": idle, **busy,
              "launches": {k: after[k] - before[k] for k in KERNEL_NAMES}})
    eng.execute("set session data_plane_kernels = true")
    counts = kernel_counts()
    for k in DIST_KERNELS:
        if counts[k] < 1:
            fail(f"distributed path never launched {k}: {counts}")
    # a warm Q3: nothing uploaded, no exchanged column read to the host
    eng.query(queries["q03"])  # its columns back on the card after the runs above
    rows, reads = exchange_host_reads(eng, queries["q03"])
    rows_agree(rows, tpch_rows["q03"], "q03", "distributed q03 (watched) vs tpch", ordered)
    bad = [r for r in reads if r[0] != "tolist" or r[1] > DIST_WORKERS * DIST_WORKERS]
    if bad or not reads or eng.executor.last_upload_ms:
        fail(f"distributed q03: exchange host reads {reads}, upload "
             f"{eng.executor.last_upload_ms} ms")
    emit({"phase": "distributed", "step": "warm_q03_host_reads", "exchange_host_reads": reads,
          "upload_ms": eng.executor.last_upload_ms})
    calls = check_main_path_calls(
        eng, [("distributed", "true", n, queries[n], 0, ()) for n in ("q18", "topn")],
        require_all=False)
    missing = set(DIST_KERNELS) - {c["kernel"] for c in calls}
    if missing:
        fail(f"distributed kernel_calls reached no call of {sorted(missing)}")
    emit({"phase": "distributed", "step": "kernel_calls", "calls": calls})
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cross = distributed_cross_check()
    emit({"phase": "distributed", "step": "cross_scale", "scale": DIST_CROSS_SCALE,
          "correct": True, **cross, "seconds": round(time.perf_counter() - t0, 3)})
    if torch.cuda.device_count() > 1:
        every = dist_engine("cuda", scale, None)
        for name in DIST_OPERATORS:
            rows_agree(every.query(queries[name]), tpch_rows[name], name,
                       f"distributed {name} over {torch.cuda.device_count()} cards vs tpch",
                       ordered)
        emit({"phase": "distributed", "step": "every_card", "cards": torch.cuda.device_count(),
              "queries": list(DIST_OPERATORS), "correct": True})
        del every
    gc.collect()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    emit({"phase": "distributed", "step": "summary", "scale": scale, "seconds": round(seconds, 1),
          "statements": len(path), "launches": counts})
    return counts, seconds


# ------------------------------------------------------------ the cluster

CLUSTER_WORKERS = 3  # DistributedQueryRunner(devices=["cuda:0"] * 3): three workers, one card
CLUSTER_QUERIES = ("q01", "q03", "q06", "q13", "q18")  # and TOPN
CLUSTER_CROSS_SCALE = 0.01
# the statements of tests/test_torch_cluster.py that read TPC-H (the five
# queries above are run too), card cluster against CPU cluster at SF 0.01
CLUSTER_CROSS = {
    "count": "select count(*) from lineitem",
    "sum_count": "select sum(l_quantity), count(*) from lineitem",
    "sum_quantity": "select sum(l_quantity) from lineitem",
    "orders": "select count(*) from orders",
    "chunked": "select l_orderkey, count(*) from lineitem group by l_orderkey",
}
CLUSTER_CTAS = ("create table memory.big_qty as "
                "select l_orderkey, l_quantity from lineitem where l_quantity > 45")
CLUSTER_CTAS_READ = "select count(*), sum(l_quantity) from memory.big_qty"


def cluster_runner(devices, scale):
    """A started cluster (coordinator + one worker per device, over loopback
    HTTP in this process) with TPC-H at `scale` and an empty memory
    catalog."""
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.testing import DistributedQueryRunner

    runner = DistributedQueryRunner(num_workers=len(devices), devices=devices)
    runner.register_catalog("tpch", TpchConnector(scale))
    runner.register_catalog("memory", MemoryConnector())
    runner.start()
    # every run executes on the workers: the coordinator's result cache
    # would answer a statement's third run from its rows
    runner.coordinator.session.set("result_cache_enabled", "false")
    return runner


def last_query_info(runner) -> dict:
    coord = runner.coordinator
    return coord.queries[list(coord.queries)[-1]].get("query_info") or {}


def cluster_task_totals(info: dict) -> dict:
    """Exchange bytes fetched and upload ms summed over a query's tasks."""
    tasks = [t for st in info.get("stages") or [] for t in st.get("tasks") or []]
    return {
        "stages": info.get("stage_count"),
        "tasks": len(tasks),
        "exchange_bytes_fetched": sum(int(t.get("exchange_bytes_fetched") or 0) for t in tasks),
        "upload_ms": sum(float(t.get("upload_ms") or 0.0) for t in tasks),
    }


def stage_rows(info: dict) -> dict:
    """{stage id: {node id: live rows summed over the stage's tasks}}."""
    return {str(st["stage_id"]): {nid: s.get("rows") for nid, s in st["operators"].items()}
            for st in info["stages"]}


class ClusterFront:
    """What check_main_path_calls drives: queries go to the cluster; the
    kernel setting is the process-global policy every worker task reads."""

    def __init__(self, runner):
        self.runner = runner

    def execute(self, sql: str):
        from trino_tpu_torch.ops import kernels

        flag = sql.rsplit("=", 1)[1].strip()
        kernels.set_policy(kernels.KernelPolicy(enabled=flag == "true"))

    def query(self, sql: str):
        return self.runner.query(sql)


def cluster_kernel_calls(runner, sql) -> list:
    """The kernels' calls of `sql` inside worker 0's tasks, each held against
    its plain version on the task's own tensors (the other workers' calls
    only run).  The checks run on the worker's task threads, where a failed
    one must fail the task, not end the thread: they raise there and the
    run fails here."""
    errors = []

    def thread_fail(msg):
        errors.append(msg)
        raise RuntimeError(msg)

    saved = globals()["fail"]
    globals()["fail"] = thread_fail
    try:
        prefix = f"worker-{runner.workers[0].port}-task"
        calls = check_main_path_calls(
            ClusterFront(runner), [("cluster", "true", "q18", sql, 0, ())], require_all=False,
            select=lambda: threading.current_thread().name.startswith(prefix))
    except RuntimeError as ex:
        errors.append(str(ex))
        calls = []
    finally:
        globals()["fail"] = saved
    if errors:
        fail(f"cluster kernel_calls: {errors[0]}")
    return calls


def cluster_cross_check(queries, ordered) -> dict:
    """At SF 0.01, a card cluster (three workers on one card) against a CPU
    cluster (`device="cpu"`, three workers): the cluster test file's TPC-H
    statements, rows compared, and the per-stage operator row counts of
    EXPLAIN ANALYZE of Q3 (QueryInfo in the JSON explain format)."""
    dev0 = torch.device("cuda", 0)
    card = cluster_runner([dev0] * CLUSTER_WORKERS, CLUSTER_CROSS_SCALE)
    host = cluster_runner(["cpu"] * CLUSTER_WORKERS, CLUSTER_CROSS_SCALE)
    try:
        stmts = dict({n: queries[n] for n in CLUSTER_QUERIES}, topn=TOPN, **CLUSTER_CROSS)
        for name, sql in stmts.items():
            rows_agree(card.query(sql), host.query(sql), name,
                       f"cluster SF {CLUSTER_CROSS_SCALE} {name}: cuda vs cpu",
                       dict(ordered, **{k: False for k in CLUSTER_CROSS}))
        explain = []
        for r in (card, host):
            r.coordinator.session.set("explain_format", "json")
            explain.append(json.loads(r.query("explain analyze " + queries["q03"])[0][0]))
        got, want = stage_rows(explain[0]), stage_rows(explain[1])
        if got != want:
            fail(f"cluster EXPLAIN ANALYZE q03 at SF {CLUSTER_CROSS_SCALE}: {got} != the CPU's {want}")
        return {"statements": len(stmts), "q03_explain_rows": got}
    finally:
        card.stop()
        host.stop()


def cluster_phase(engine, scale, tpch_rows):
    """The multi-host runtime on the card at TPC-H `scale`: a coordinator and
    three workers over loopback HTTP in this process
    (DistributedQueryRunner(devices=["cuda:0"] * 3)), every task on the
    card.  Q1, Q3, Q6, Q13, Q18 and TOPN cold then warm, each against the
    tpch phase's rows (TOPN: the TPC-H engine's), with exchange bytes
    fetched, the tasks' upload ms, idle share and launches; count(*) of
    lineitem through StatementClient and Q6 through the DB-API driver; a
    CTAS into a memory catalog through the protocol, its count and sum
    against numpy; Q3 under retry_policy=TASK with a task failure injected
    on worker 0; the kernels' calls of Q18 inside a worker's tasks against
    their plain versions; then SF 0.01, card cluster against CPU cluster.
    Returns (the path's launch counts, phase seconds)."""
    from trino_tpu_torch.client import StatementClient
    from trino_tpu_torch.client.dbapi import connect
    from trino_tpu_torch.connectors.tpch import tpch_data
    from trino_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    queries, ordered = tpch_queries()
    want = dict(tpch_rows, topn=engine.query(TOPN))
    engine.executor.drop_scans()
    gc.collect()
    torch.cuda.empty_cache()
    kernels.set_policy(kernels.KernelPolicy())  # the session defaults: every kernel on
    stmts = dict({n: queries[n] for n in CLUSTER_QUERIES}, topn=TOPN)
    dev0 = torch.device("cuda", 0)
    runner = cluster_runner([dev0] * CLUSTER_WORKERS, scale)
    try:
        # every count to 0 just before the path, read just after
        reset_kernel_counts()
        for name, sql in stmts.items():
            before = kernel_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rows = runner.query(sql)
            torch.cuda.synchronize()
            cold = (time.perf_counter() - t0) * 1e3
            cold_totals = cluster_task_totals(last_query_info(runner))
            rows_agree(rows, want[name], name, f"cluster {name} (cold) vs tpch", ordered)
            # one warm run inside a card-only trace (it adds microseconds per
            # launch): its wall is warm_ms, the trace its device time
            laps, got = [], []

            def warm_run():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got.append(runner.query(sql))
                torch.cuda.synchronize()
                laps.append((time.perf_counter() - t0) * 1e3)

            busy = traced_busy(warm_run, 1)
            if not laps:  # the profiler failed before the run: run it plain
                warm_run()
            warm = laps[-1]
            rows = got[-1]
            warm_totals = cluster_task_totals(last_query_info(runner))
            rows_agree(rows, want[name], name, f"cluster {name} (warm) vs tpch", ordered)
            if warm_totals["upload_ms"]:
                fail(f"cluster {name}: a warm run uploaded ({warm_totals['upload_ms']} ms)")
            after = kernel_counts()
            idle = None if busy["device_busy_ms"] is None else 1.0 - busy["device_busy_ms"] / warm
            emit({"phase": "cluster", "query": name, "workers": CLUSTER_WORKERS,
                  "rows": len(rows), "correct": True, "warm_ms": warm,
                  "warm_ms_tpch": TPCH_WARM_MS.get(name), "cold_ms": cold,
                  "cold": cold_totals, "warm": warm_totals, "device_idle_share": idle, **busy,
                  "launches": {k: after[k] - before[k] for k in KERNEL_NAMES}})
        # the client protocol, the DB-API driver and a write through them
        t0 = time.perf_counter()
        _cols, got = StatementClient(runner.coordinator.url).execute(
            "select count(*) from lineitem")
        count_ms = (time.perf_counter() - t0) * 1e3
        n_li = engine.query("select count(*) from lineitem")[0][0]
        if [list(r) for r in got] != [[n_li]]:
            fail(f"cluster count(*) through StatementClient: {got} != {n_li}")
        t0 = time.perf_counter()
        with connect(runner.coordinator.url) as conn:
            cur = conn.cursor()
            cur.execute(queries["q06"])
            q6 = cur.fetchall()
        q6_ms = (time.perf_counter() - t0) * 1e3
        if [[Decimal(str(v)) for v in r] for r in q6] != [list(r) for r in want["q06"]]:
            fail(f"cluster q06 through dbapi: {q6} != {want['q06']}")
        li = tpch_data("lineitem", scale)
        qty = np.asarray(li["l_quantity"], np.int64)  # decimal(12,2), unscaled
        big = qty[qty > 4500]
        t0 = time.perf_counter()
        StatementClient(runner.coordinator.url).execute(CLUSTER_CTAS)
        ctas_ms = (time.perf_counter() - t0) * 1e3
        _cols, got = StatementClient(runner.coordinator.url).execute(CLUSTER_CTAS_READ)
        want_ctas = [len(big), Decimal(exact_sum(big)) / 100]
        if [int(got[0][0]), Decimal(str(got[0][1]))] != want_ctas:
            fail(f"cluster CTAS through the protocol: {got} != numpy {want_ctas}")
        # a task failure under retry_policy=TASK: re-scheduled, same rows
        runner.coordinator.session.set("retry_policy", "TASK")
        runner.inject_task_failure(worker_index=0, task_id="*")
        t0 = time.perf_counter()
        rows = runner.query(queries["q03"])
        retry_ms = (time.perf_counter() - t0) * 1e3
        coord = runner.coordinator
        retried = coord.queries[list(coord.queries)[-1]].get("task_retries", 0)
        coord.session.set("retry_policy", "NONE")
        rows_agree(rows, want["q03"], "q03", "cluster q03 under TASK retry vs tpch", ordered)
        if not retried:
            fail("cluster q03 under TASK retry: no task was retried")
        counts = kernel_counts()
        emit({"phase": "cluster", "step": "protocol", "count_ms": count_ms, "q06_dbapi_ms": q6_ms,
              "ctas_ms": ctas_ms, "ctas_rows": len(big), "task_retry_q03_ms": retry_ms,
              "task_retries": retried, "correct": True})
        for k in KERNEL_NAMES:
            if counts[k] < 1:
                fail(f"cluster path never launched {k}: {counts}")
        # launches made from here on are not part of the path's count
        calls = cluster_kernel_calls(runner, queries["q18"])
        missing = {"segment_reduce", "hash_build", "hash_probe"} - {c["kernel"] for c in calls}
        if missing:
            fail(f"cluster kernel_calls of q18 reached no call of {sorted(missing)}")
        emit({"phase": "cluster", "step": "kernel_calls", "calls": calls})
        kernels.set_policy(kernels.KernelPolicy())
    finally:
        runner.stop()
    del runner
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cross = cluster_cross_check(queries, ordered)
    emit({"phase": "cluster", "step": "cross_scale", "scale": CLUSTER_CROSS_SCALE,
          "correct": True, **cross, "seconds": round(time.perf_counter() - t0, 3)})
    gc.collect()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    emit({"phase": "cluster", "step": "summary", "scale": scale, "seconds": round(seconds, 1),
          "statements": len(stmts) + 4, "launches": counts})
    return counts, seconds


# ------------------------------------------ the compile plane and the drills

RESILIENCE_WORKERS = 3  # DistributedQueryRunner(devices=["cuda:0"] * 3), as in `cluster`
RESILIENCE_BUDGET_MS = 50  # compile_wait_budget_ms of the fallback runs
RESILIENCE_DEADLINE_S = 0.2  # compile_deadline_s of the timeout run
# every injected delay (COMPILE_SLOW, SLOW, GRAY_SLOW) waits on a gate the
# script opens once it is done with the straggler: this is its upper bound
RESILIENCE_DELAY_MS = 60_000
CHAOS_SEED = 2  # its schedule over CHAOS_QUERIES arms all five modes
CHAOS_QUERIES = ("q01", "q03", "q06", "q18")
FALLBACK_REASONS = ("compile_wait", "compile_timeout", "compile_error", "breaker_open")


def gate_faults(injectors, method: str) -> threading.Event:
    """Make the injectors' `method` faults (compile_fault, task_fault,
    link_fault) wait on the returned gate, at most their delay, instead of
    sleeping: the script opens it when it is done with the straggler."""
    gate = threading.Event()
    for inj in injectors:
        plain = getattr(type(inj), method)
        setattr(inj, method, lambda *a, _p=plain, _i=inj, **kw: _p(_i, *a, **dict(kw, sleep=gate.wait)))
    return gate


def ungate_faults(injectors, method: str) -> None:
    """Undo gate_faults: the injectors' faults sleep again."""
    for inj in injectors:
        inj.__dict__.pop(method, None)


def fallbacks_total() -> int:
    from trino_tpu_torch.exec.compilesvc import FALLBACKS

    return int(sum(FALLBACKS.value(r) for r in FALLBACK_REASONS))


def breaker_failures() -> int:
    from trino_tpu_torch.exec.compilesvc import SERVICE

    return sum(e["failures"] for e in SERVICE.breaker.snapshot().values())


def hold_stage(workers, fragment_id: int):
    """Every task of fragment `fragment_id` waits on the returned gate as it
    starts (at the workers' fault hook, outside any lock of the worker):
    the script decides when the stage runs.  Returns (gate, the held task
    ids)."""
    gate, held = threading.Event(), []
    tag = f"_f{fragment_id}_"
    for w in workers:
        inj = w.fault_injector
        plain = type(inj).task_fault

        def hook(task_id, sleep=time.sleep, _p=plain, _i=inj):
            if tag in task_id:
                held.append(task_id)
                if not gate.wait(timeout=120):
                    raise RuntimeError("the drill's gate never opened")
            return _p(_i, task_id, sleep=sleep)

        inj.task_fault = hook
    return gate, held


def heal_links(runner) -> None:
    """Forget every worker's link grades and wait until the coordinator's
    link matrix shows no impaired link: an impaired link steers placement
    away from its workers (runtime/coordinator.py _steer_by_links), and a
    later drill needs a task on every worker."""
    for w in runner.workers:
        w.link_health.reset()
    wait_for(lambda: not any(cell.get("state") in ("SUSPECT", "DEAD")
                             for row in runner.coordinator.link_matrix().values()
                             for cell in row.values()),
             "the graded links never healed", 30)


def last_worker_stage(coord, qid) -> int:
    """The fragment of a finished query's worker stage that started last:
    the consumer of every other worker stage's output."""
    times = coord.queries[qid]["stage_times"]
    return max(times, key=lambda f: times[f][0])


def wait_for(pred, what: str, timeout: float = 120.0, phase: str = "resilience") -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            fail(f"{phase}: {what}")
        time.sleep(0.02)


def compile_plane_checks(run_q1, injectors, set_session, what: str, last_fallbacks) -> dict:
    """The compile plane around kernel 2 on one path (the cluster or the
    local engine): a build held pending past the wait budget falls back to
    the unfused path (kernel 2 0 launches, kernel 1 more than 0), the
    finished kernel swaps in on the next run (its totals against
    fused.run_plain, built on the service's pool and launched from the
    query's thread), COMPILE_FAIL three times opens the breaker, and a
    deadline below the injected delay gives a typed COMPILE_TIMEOUT.  Rows
    equal the tpch phase's every time (run_q1 checks them)."""
    from trino_tpu_torch.exec import compilesvc
    from trino_tpu_torch.ops.cuda import fused, fused_codegen

    svc = compilesvc.SERVICE
    out = {}
    run_q1("warm-up")  # scan slices uploaded: the runs below are warm
    fused_codegen.clear_cache()  # the next build is a cold NVRTC compile
    # 1. a pending build: the unfused path answers
    gate = gate_faults(injectors, "compile_fault")
    set_session(RESILIENCE_BUDGET_MS, 300.0)
    for inj in injectors:
        inj.arm(task_id="*", mode="COMPILE_SLOW", delay_ms=RESILIENCE_DELAY_MS)
    before, fb0 = kernel_counts(), fallbacks_total()
    out["fallback_warm_ms"] = run_q1("fallback")
    after = kernel_counts()
    if gate.is_set():
        fail(f"resilience {what}: the build was released before the fallback run returned")
    if after["fused_pipeline"] != before["fused_pipeline"]:
        fail(f"resilience {what}: kernel 2 launched while its build was pending")
    if after["segment_reduce"] <= before["segment_reduce"]:
        fail(f"resilience {what}: the fallback did not run kernel 1")
    reasons = last_fallbacks()
    if not reasons.get("compile_wait") or fallbacks_total() <= fb0:
        fail(f"resilience {what}: the fallback was not named ({reasons})")
    out["fallback_reasons"] = reasons
    # 2. the build finishes on the service's pool; the next run launches it
    builds, real_build = [], fused_codegen.build

    def recorded_build(recipe, device_index):
        info = real_build(recipe, device_index)
        builds.append((threading.current_thread().name, info))
        return info

    fused_codegen.build = recorded_build
    try:
        gate.set()
        svc.drain(timeout_s=300)
    finally:
        fused_codegen.build = real_build
    for inj in injectors:
        inj.clear()
    made = [(t, info) for t, info in builds if info is not None]
    if not made or not all(t.startswith("compile-svc") for t, _ in made):
        fail(f"resilience {what}: no build on the compile service's pool: {builds}")
    out["cold_compile_ms"] = {info["signature"]: info["compile_s"] * 1e3 for _, info in made}
    out["cold_compile_cache"] = sorted({info["cache"] for _, info in made})
    calls, real_run = [], fused.run

    def captured_run(recipe, cols, live):
        got = real_run(recipe, cols, live)
        calls.append((recipe, cols, live, got, threading.current_thread().name))
        return got

    before = kernel_counts()
    fused.run = captured_run
    try:
        out["compiled_first_ms"] = run_q1("compiled")
    finally:
        fused.run = real_run
    after = kernel_counts()
    if after["fused_pipeline"] <= before["fused_pipeline"] or not calls:
        fail(f"resilience {what}: the built kernel did not swap in")
    out["compiled_launch_threads"] = sorted({c[4] for c in calls})
    out["compiled_max_abs_err"] = max(
        fused_case(r, c, lv, f"resilience {what} compiled q01", got=g) for r, c, lv, g, _ in calls)
    del calls
    out["compiled_warm_ms"] = run_q1("compiled warm")
    # 3. a build that fails every time: the breaker opens, the rows stay right
    fused_codegen.clear_cache()
    for inj in injectors:
        inj.arm(task_id="*", mode="COMPILE_FAIL", count=10)
    sig = None
    for _ in range(svc.breaker.threshold):
        run_q1("compile_fail")
        failed = [s for s, n in last_fallbacks(signatures=True).items() if n.get("compile_error")]
        sig = failed[0] if failed else sig
    if sig is None or svc.breaker.state(sig) != "OPEN":
        fail(f"resilience {what}: COMPILE_FAIL did not open the breaker "
             f"({svc.breaker.snapshot()})")
    out["breaker"] = {sig: svc.breaker.state(sig)}
    for inj in injectors:
        inj.clear()
    svc.reset()
    # 4. a deadline below the injected delay: a typed COMPILE_TIMEOUT
    gate = gate_faults(injectors, "compile_fault")
    set_session(0, RESILIENCE_DEADLINE_S)
    for inj in injectors:
        inj.arm(task_id="*", mode="COMPILE_SLOW", delay_ms=RESILIENCE_DELAY_MS)
    t0 = compilesvc.COMPILE_TIMEOUTS.value()
    out["deadline_ms"] = run_q1("deadline")
    reasons = last_fallbacks()
    if compilesvc.COMPILE_TIMEOUTS.value() < t0 + 1 or not reasons.get("compile_timeout"):
        fail(f"resilience {what}: the deadline gave no typed COMPILE_TIMEOUT ({reasons})")
    gate.set()
    svc.drain(timeout_s=300)
    for inj in injectors:
        inj.clear()
    ungate_faults(injectors, "compile_fault")
    set_session(0, 300.0)
    svc.reset()
    return out


def resilience_phase(engine, scale, tpch_rows):
    """The compile plane, the capacity cache, the task-retry drills and the
    chaos harness on the card at TPC-H `scale`, three workers on cuda:0 as in
    the `cluster` phase, every result against the tpch phase's rows.
    Returns (the path's launch counts, phase seconds)."""
    import tempfile

    from trino_tpu_torch.exec import capcache, compilesvc
    from trino_tpu_torch.ops import kernels
    from trino_tpu_torch.runtime.failure import FaultInjector
    from trino_tpu_torch.runtime.health import HEDGED_FETCHES
    from trino_tpu_torch.testing import DistributedQueryRunner
    from trino_tpu_torch.testing.chaos import RECOVERABLE_MODES, ChaosRunner

    t_phase = time.perf_counter()
    queries, ordered = tpch_queries()
    # no hidden fallback: every earlier phase ran kernel 2 whenever it could
    if fallbacks_total() or breaker_failures():
        fail(f"a fallback or a failed build before the resilience phase: "
             f"{fallbacks_total()} fallbacks, {compilesvc.SERVICE.breaker.snapshot()}")
    engine.executor.drop_scans()
    gc.collect()
    torch.cuda.empty_cache()
    kernels.set_policy(kernels.KernelPolicy())
    from trino_tpu_torch.connectors.tpch import TpchConnector

    dev0 = torch.device("cuda", 0)
    runner = DistributedQueryRunner(num_workers=RESILIENCE_WORKERS, devices=[dev0] * RESILIENCE_WORKERS)
    runner.register_catalog("tpch", TpchConnector(scale))
    runner.start()
    coord = runner.coordinator
    coord.session.set("result_cache_enabled", "false")  # every run executes on the workers
    spool = tempfile.mkdtemp(prefix="chip_smoke_spool_")
    reset_kernel_counts()  # every count to 0 just before the path, read just after
    try:
        # ---- the compile plane through the cluster, then the local engine
        def cluster_q1(what):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rows = runner.query(queries["q01"])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            rows_agree(rows, tpch_rows["q01"], "q01", f"resilience cluster {what} vs tpch", ordered)
            return ms

        def cluster_session(budget_ms, deadline_s):
            coord.session.set("compile_wait_budget_ms", str(budget_ms))
            coord.session.set("compile_deadline_s", str(deadline_s))

        def cluster_fallbacks(signatures=False):
            qi = last_query_info(runner)
            if signatures:
                return {s: a.get("fallbacks") or {} for s, a in
                        (qi.get("compile_signatures") or {}).items()}
            return dict(qi.get("fallback_reasons") or {})

        t0 = time.perf_counter()
        cl = compile_plane_checks(cluster_q1, [w.fault_injector for w in runner.workers],
                                  cluster_session, "cluster", cluster_fallbacks)
        emit({"phase": "resilience", "step": "compile_plane", "path": "cluster",
              "workers": RESILIENCE_WORKERS, "correct": True, **cl,
              "seconds": round(time.perf_counter() - t0, 3)})

        inj = FaultInjector()
        engine.executor.fault_injector = inj

        def local_q1(what):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rows = engine.query(queries["q01"])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            rows_agree(rows, tpch_rows["q01"], "q01", f"resilience local {what} vs tpch", ordered)
            return ms

        def local_session(budget_ms, deadline_s):
            engine.session.set("compile_wait_budget_ms", str(budget_ms))
            engine.session.set("compile_deadline_s", str(deadline_s))

        def local_fallbacks(signatures=False):
            ev = engine.executor.fallback_events[-1:] if engine.executor.fallback_events else []
            if signatures:
                return {e["signature"]: {e["reason"]: 1} for e in ev}
            return {e["reason"]: 1 for e in ev}

        t0 = time.perf_counter()
        n_events = len(engine.executor.fallback_events)
        try:
            lo = compile_plane_checks(local_q1, [inj], local_session, "local", local_fallbacks)
        finally:
            engine.executor.fault_injector = None
        lo["fallback_events"] = len(engine.executor.fallback_events) - n_events
        emit({"phase": "resilience", "step": "compile_plane", "path": "local", "correct": True,
              **lo, "seconds": round(time.perf_counter() - t0, 3)})
        fallbacks_after_plane = fallbacks_total()

        # ---- the capacity cache: a fresh engine starts at stored tiers
        t0 = time.perf_counter()
        caps_dir = tempfile.mkdtemp(prefix="chip_smoke_caps_")
        os.environ[capcache.ENV] = os.path.join(caps_dir, "caps.json")
        capcache._mem.clear()
        def lookups():
            return {r: capcache._CAPS_LOOKUPS.value(r) for r in ("hit", "miss")}

        try:
            first = tpch_engine("cuda", scale)
            before = lookups()
            rows_agree(first.query(queries["q18"]), tpch_rows["q18"], "q18",
                       "resilience capcache first engine vs tpch", ordered)
            first_lookups = {r: n - before[r] for r, n in lookups().items()}
            first_retries = list(first.executor.last_retries)
            del first
            gc.collect()
            with open(os.environ[capcache.ENV]) as f:
                stored = [capcache._decode(e) for e in json.load(f).values()]
            if not stored:
                fail("resilience capcache: the first engine stored no tiers")
            if first_lookups["hit"] or not first_lookups["miss"]:
                fail(f"resilience capcache: the first engine did not start cold: {first_lookups}")
            capcache._mem.clear()  # the second engine reads the file, as a fresh process would
            second = tpch_engine("cuda", scale)
            before = lookups()
            rows_agree(second.query(queries["q18"]), tpch_rows["q18"], "q18",
                       "resilience capcache second engine vs tpch", ordered)
            second_lookups = {r: n - before[r] for r, n in lookups().items()}
            second_retries = list(second.executor.last_retries)
            # each plan the second engine ran starts at, and keeps, a stored entry
            learned = [(caps, joins) for _, caps, joins in second.executor._learned_caps.values()]
            del second
            gc.collect()
            torch.cuda.empty_cache()
        finally:
            os.environ[capcache.ENV] = "off"
            capcache._mem.clear()
        if second_lookups["miss"] or not second_lookups["hit"]:
            fail(f"resilience capcache: the second fresh engine missed the stored tiers:"
                 f" {second_lookups}")
        if not learned or any(entry not in stored for entry in learned):
            fail("resilience capcache: the second engine's tiers are not the stored ones")
        if second_retries:
            fail(f"resilience capcache: the second fresh engine re-ran: {second_retries}")
        emit({"phase": "resilience", "step": "capacity_cache", "query": "q18", "correct": True,
              "entries": len(stored), "first_engine_lookups": first_lookups,
              "second_engine_lookups": second_lookups,
              "first_engine_retries": first_retries, "second_engine_retries": second_retries,
              "seconds": round(time.perf_counter() - t0, 3)})

        # ---- the drills, under retry_policy=TASK with a spooled exchange and
        # one task per worker and stage (split-driven scans place a stage's
        # tasks where splits are asked for, and a drill needs a task on its
        # worker); the scan caches hold the slices of this one split mode
        coord.session.set("retry_policy", "TASK")
        coord.session.set("exchange_spool_dir", spool)
        coord.session.set("split_driven_scans", "false")
        drills = {}

        def q(name):
            rows = runner.query(queries[name])
            rows_agree(rows, tpch_rows[name], name, f"resilience drill {name} vs tpch", ordered)

        # a gray slow producer: its fetches by the other workers answer late
        t0 = time.perf_counter()
        q("q03")  # warms this split mode's scan caches
        # a cold run's fetches wait on their producers, and on a slow host
        # that grades links: an impaired link steers the next placement
        # away from its workers, and the slow producer then serves no one
        heal_links(runner)
        won0 = HEDGED_FETCHES.value("won")
        gate = gate_faults([runner.workers[1].fault_injector], "link_fault")
        for consumer in (0, 2):
            runner.gray_slow(producer_index=1, delay_ms=RESILIENCE_DELAY_MS, consumer_index=consumer)
        try:
            q("q03")
            if gate.is_set() or HEDGED_FETCHES.value("won") <= won0:
                fired = runner.workers[1].fault_injector.fired
                fail("resilience gray slow: the hedge did not win"
                     f" (hedged fetches {[HEDGED_FETCHES.value(o) for o in ('won', 'lost', 'failed')]},"
                     f" gray faults fired {sum(m == 'GRAY_SLOW' for m, _ in fired)},"
                     f" links {json.dumps(coord.link_matrix())[:1500]})")
        finally:
            gate.set()
            runner.workers[1].fault_injector.clear()
            ungate_faults([runner.workers[1].fault_injector], "link_fault")
        # the links the late answers graded heal before the next drill: an
        # impaired link steers the coordinator's placement away from its
        # workers (runtime/coordinator.py _steer_by_links), which would put
        # every later task on the one worker left
        graded = {c: {p: cell["state"] for p, cell in row.items()}
                  for c, row in coord.link_matrix().items()}
        heal_links(runner)
        drills["gray_slow_q03"] = {"hedges_won": HEDGED_FETCHES.value("won") - won0,
                                   "graded_links": graded,
                                   "seconds": round(time.perf_counter() - t0, 3)}
        # a straggler speculated: its backup wins while it sleeps
        t0 = time.perf_counter()
        coord.session.set("speculation_enabled", "true")
        coord.session.set("speculation_quantile", "1.5")
        spec = coord._m_speculative
        won0 = spec.value("won")
        gate = gate_faults([runner.workers[0].fault_injector], "task_fault")
        runner.inject_task_failure(worker_index=0, mode="SLOW", delay_ms=RESILIENCE_DELAY_MS)
        try:
            q("q06")
            if not any(m == "SLOW" for m, _ in runner.workers[0].fault_injector.fired):
                fail("resilience speculation: the straggler's fault met no task")
            if gate.is_set() or spec.value("won") <= won0:
                fail(f"resilience speculation: no backup won ({spec.value('launched')} launched)")
        finally:
            gate.set()
            runner.workers[0].fault_injector.clear()
            ungate_faults([runner.workers[0].fault_injector], "task_fault")
        coord.session.set("speculation_enabled", "false")
        drills["speculation_q06"] = {"backups_won": spec.value("won") - won0,
                                     "seconds": round(time.perf_counter() - t0, 3)}
        # chaos: a seeded schedule of recoverable faults and corrupt frames
        t0 = time.perf_counter()
        for w in runner.workers:
            w.fault_injector.fired.clear()  # what fires from here on is the schedule's
        chaos = ChaosRunner(runner, seed=CHAOS_SEED, modes=RECOVERABLE_MODES + ("CORRUPT",))
        for name in CHAOS_QUERIES:
            rows = chaos.run_query(queries[name])
            rows_agree(rows, tpch_rows[name], name, f"resilience chaos {name} vs tpch "
                       f"under {chaos.schedule[-1]}", ordered)
        fired = sorted(chaos.fired_modes())
        if len(fired) < 3:
            fail(f"resilience chaos: only {fired} fired across {chaos.schedule}")
        heal_links(runner)  # the schedule's dropped fetches graded links too
        emit({"phase": "resilience", "step": "chaos", "seed": CHAOS_SEED, "correct": True,
              "queries": list(CHAOS_QUERIES), "schedule": chaos.schedule, "fired": fired,
              "seconds": round(time.perf_counter() - t0, 3)})
        # a worker drained mid-query: zero retries.  The last stage's tasks
        # are held until the coordinator sees the victim DRAINING, so the
        # victim is running one of them
        t0 = time.perf_counter()
        quarantined0 = coord._m_breaker.value("QUARANTINED")
        q("q03")
        gate, held = hold_stage(runner.workers, last_worker_stage(coord, list(coord.queries)[-1]))
        victim = runner.workers[2]
        try:
            qid = coord.submit_query(queries["q03"])
            wait_for(lambda: len(held) >= len(runner.workers), "drain: the stage never started")
            runner.drain_worker(2)
            wait_for(lambda: coord.failure_detector.state(victim.url) == "DRAINING",
                     "drain: the coordinator never saw DRAINING", 30)
        finally:
            gate.set()
        wait_for(lambda: coord.queries[qid]["sm"].done, "drain: the query never finished")
        ungate_faults([w.fault_injector for w in runner.workers], "task_fault")
        record = coord.queries[qid]
        if record["sm"].state != "FINISHED":
            fail(f"resilience drain: q03 {record['sm'].state}: {record['sm'].error}")
        rows_agree(record["result"], tpch_rows["q03"], "q03", "resilience drain q03 vs tpch", ordered)
        if record.get("task_retries", 0) or coord._m_breaker.value("QUARANTINED") != quarantined0:
            fail(f"resilience drain: {record.get('task_retries')} retries, quarantined")
        wait_for(lambda: victim.state == "drained" and victim.url not in coord.workers,
                 "drain: the victim never deregistered", 60)
        drills["drain_q03"] = {"held_tasks": len(held), "task_retries": 0,
                               "seconds": round(time.perf_counter() - t0, 3)}
        # a worker killed after its stage output finished: the last stage's
        # tasks are held until every other stage finished, then worker 1 dies
        t0 = time.perf_counter()
        alive = [w for w in runner.workers if w is not victim]
        q("q18")
        last = last_worker_stage(coord, list(coord.queries)[-1])
        gate, held = hold_stage(alive, last)
        try:
            qid = coord.submit_query(queries["q18"])
            record = coord.queries[qid]
            wait_for(lambda: len(held) >= len(alive)
                     and len(record.get("stage_times") or {}) >= 1,
                     "kill: no stage finished before the last one")
            finished = sorted(record["stage_times"])
            runner.kill_worker(runner.workers.index(alive[1]))
        finally:
            gate.set()
        wait_for(lambda: record["sm"].done, "kill: the query never finished")
        ungate_faults([w.fault_injector for w in alive], "task_fault")
        if record["sm"].state != "FINISHED":
            fail(f"resilience kill: q18 {record['sm'].state}: {record['sm'].error}")
        rows_agree(record["result"], tpch_rows["q18"], "q18", "resilience kill q18 vs tpch", ordered)
        recovered = record.get("task_retries", 0) + record.get("task_heals", 0)
        if recovered < 1:
            fail("resilience kill: the dead worker's tasks were not retried")
        drills["kill_q18"] = {"finished_before_kill": finished, "held_stage": last,
                              "task_retries": record.get("task_retries", 0),
                              "task_heals": record.get("task_heals", 0),
                              "seconds": round(time.perf_counter() - t0, 3)}
        emit({"phase": "resilience", "step": "drills", "correct": True, **drills})
        counts = kernel_counts()
    finally:
        runner.stop()
    del runner
    gc.collect()
    torch.cuda.empty_cache()
    # no hidden fallback outside the armed faults
    if fallbacks_total() != fallbacks_after_plane or breaker_failures():
        fail(f"resilience: a fallback outside the armed faults "
             f"({fallbacks_total()} != {fallbacks_after_plane}, "
             f"{compilesvc.SERVICE.breaker.snapshot()})")
    for k in ("segment_reduce", "fused_pipeline", "hash_build", "hash_probe"):
        if counts[k] < 1:
            fail(f"resilience path never launched {k}: {counts}")
    seconds = time.perf_counter() - t_phase
    emit({"phase": "resilience", "step": "summary", "scale": scale,
          "seconds": round(seconds, 1), "launches": counts})
    return counts, seconds


# ---------------------------------------- governance and recovery on the card

GOV_WORKERS = 3  # DistributedQueryRunner(devices=["cuda:0"] * 3), as in `cluster`
GOV_RESERVE = 1 << 30  # task_memory_reserve_bytes of the memory steps (nominal)
GOV_NODE_BYTES = 3 << 29  # each worker's node pool: one and a half reservations
GOV_KILLER_DELAY_S = 0.5  # low_memory_killer_delay_s of the memory steps
GOV_SPLIT_ROWS = 1 << 19  # split_target_rows: 12 lineitem morsels at SF 1, 2 at SF 0.1
GOV_SPLIT_SMALL = 0.1  # the second scale of the split step
GOV_SPLIT_QUERIES = ("q01", "q06", "topn")
GOV_KILL_SQL = "select count(*), sum(l_partkey) from lineitem"  # columns no step scanned
GOV_CTAS = ("create table memory.{t} as "
            "select l_orderkey, l_quantity from lineitem where l_quantity > 45")
GOV_HOLD_S = 120  # the most a held task waits for the script to release it


class TaskGate:
    """The script's hold on the tasks of a cluster.  Every task a worker runs
    passes here twice: before its node-pool reservation
    (`Worker._run_task_inner`, wrapped while the phase runs: the fragment's
    shape is noted, and `before` may return an event the task waits for,
    asked again each time it is set, until it returns None) and
    after it (each worker's fault hook: `started` lists the task, and a task
    that `hold` matches waits on the gate once `free` of them have passed).
    Every wait is bounded by GOV_HOLD_S."""

    def __init__(self):
        self.info: dict = {}  # task id -> {"revocable", "leaf", "worker"}
        self.started: list = []
        self.finished: list = []
        self.held: list = []
        self.hold = None
        self.free = 0
        self.before = None
        self.gate = threading.Event()
        self.reached: dict = {}  # worker url -> Event: a held revocable task reserved there
        self.query = None  # the first new query a task of reached the gate since `arm`
        self._old: set = set()  # queries with a task started before `arm`
        self._lock = threading.Lock()
        self._plain = None

    def first(self, task_id: str) -> bool:
        """Is this a task of the first query seen since `arm` that had no
        task before it (which this call may make it)?  A task id is
        `<query id>_a<attempt>_f...`."""
        qid = task_id.rsplit("_a", 1)[0]
        with self._lock:
            if self.query is None and qid not in self._old:
                self.query = qid
            return self.query == qid

    def install(self) -> None:
        from trino_tpu_torch.plan.nodes import RemoteSource, walk
        from trino_tpu_torch.plan.serde import plan_from_json
        from trino_tpu_torch.runtime import worker as wmod

        plain = self._plain = wmod.Worker._run_task_inner
        gate = self

        def inner(w, task, req, t0):
            frag = plan_from_json(req["fragment"])
            with gate._lock:
                gate.info[task.task_id] = {
                    "revocable": wmod._fragment_revocable(frag),
                    "leaf": not any(isinstance(n, RemoteSource) for n in walk(frag)),
                    "worker": w.url,
                }
                before = gate.before
            while before is not None:
                ev = before(task.task_id, w.url)
                if ev is None:
                    break
                if not ev.wait(timeout=GOV_HOLD_S):
                    raise RuntimeError("governance: a task waited for its turn too long")
                with gate._lock:
                    before = gate.before
            try:
                return plain(w, task, req, t0)
            finally:
                with gate._lock:
                    gate.finished.append(task.task_id)

        wmod.Worker._run_task_inner = inner

    def uninstall(self) -> None:
        from trino_tpu_torch.runtime import worker as wmod

        if self._plain is not None:
            wmod.Worker._run_task_inner = self._plain
            self._plain = None

    def attach(self, workers) -> None:
        for w in workers:
            inj = w.fault_injector
            plain = type(inj).task_fault

            def hook(task_id, sleep=time.sleep, _p=plain, _i=inj, _url=w.url):
                hold = self.hold
                wait = hold is not None and hold(task_id)
                with self._lock:
                    self.started.append(task_id)
                    if wait and self.free > 0:
                        self.free -= 1
                        wait = False
                    if wait:
                        self.held.append(task_id)
                        if (self.info.get(task_id) or {}).get("revocable"):
                            self.reached.setdefault(_url, threading.Event()).set()
                    gate = self.gate
                if wait and not gate.wait(timeout=GOV_HOLD_S):
                    raise RuntimeError("governance: the gate never opened")
                return _p(_i, task_id, sleep=sleep)

            inj.task_fault = hook

    def detach(self, workers) -> None:
        for w in workers:
            w.fault_injector.__dict__.pop("task_fault", None)

    def arm(self, hold, free: int = 0, before=None) -> None:
        with self._lock:
            self.hold, self.free, self.before = hold, free, before
            self.held, self.reached, self.query = [], {}, None
            self._old = {t.rsplit("_a", 1)[0] for t in self.started}
            self.gate = threading.Event()

    def release(self) -> None:
        with self._lock:
            self.hold = self.before = None
            gate = self.gate
        gate.set()

    def started_since(self, mark: int) -> list:
        with self._lock:
            return list(self.started[mark:])


def gov_wait(pred, what: str, timeout: float = 60.0) -> None:
    wait_for(pred, what, timeout, phase="governance")


def wait_port_free(port: int, timeout: float = 15.0) -> None:
    """Until a listener could bind `port` again (as ThreadingHTTPServer does,
    SO_REUSEADDR): a restarted coordinator takes the dead one's port."""
    import socket

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        s = socket.socket()
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.bind(("127.0.0.1", port))
            return
        except OSError:
            time.sleep(0.05)
        finally:
            s.close()
    fail(f"port {port} never freed for a restarted coordinator")


def device_memory(dev, reset: bool = False) -> dict:
    """Allocated and peak allocated bytes of the card (the caching allocator's
    view; every node of the cluster shares it); `reset` starts a new peak
    after reading."""
    got = {"allocated": torch.cuda.memory_allocated(dev),
           "peak": torch.cuda.max_memory_allocated(dev)}
    if reset:
        torch.cuda.reset_peak_memory_stats(dev)
    return got


def drop_cluster_caches(runner, dev) -> None:
    for w in runner.workers:
        w.scan_cache.drop_device()
    for c in runner.coordinators:
        c.scan_cache.drop_device()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def committed_tasks(spool: str, qid: str) -> list:
    """Task ids of `qid` whose output committed to the spool."""
    return [name for name in (os.listdir(spool) if os.path.isdir(spool) else ())
            if name.startswith(qid + "_")
            and os.path.exists(os.path.join(spool, name, "COMMITTED"))]


def committed_fragments(spool: str, qid: str) -> set:
    return {task_fragment(t) for t in committed_tasks(spool, qid)}


def task_fragment(task_id: str) -> int:
    """`<query id>_a<attempt>_f<fragment>_p<part>_t<try>` -> fragment."""
    return int(task_id.rsplit("_f", 1)[1].split("_", 1)[0])


def task_part(task_id: str) -> int:
    return int(task_id.rsplit("_p", 1)[1].split("_", 1)[0])


def protocol_rows(got, want, what: str = "governance") -> list:
    """Rows read through the client protocol (decimals and dates as text)
    typed like `want`'s, column by column."""
    import datetime

    def typed(g, w):
        if g is None or w is None:
            return g
        if isinstance(w, Decimal):
            return Decimal(str(g))
        if isinstance(w, datetime.date):
            return datetime.date.fromisoformat(str(g))
        if isinstance(w, float):
            return float(g)
        if isinstance(w, int) and not isinstance(w, bool):
            return int(g)
        return g

    if len(got) != len(want):
        fail(f"{what}: {len(got)} rows through the protocol, {len(want)} wanted")
    return [tuple(typed(g, w) for g, w in zip(gr, wr)) for gr, wr in zip(got, want)]


def gov_runner(scale, dev, **kwargs):
    """A started cluster of GOV_WORKERS workers on `dev` with TPC-H at
    `scale` and an empty memory catalog; the result cache off (every run
    executes), task retry over a spooled exchange in a temporary directory,
    one task per worker and stage (split-driven scans off) unless a step
    turns them on."""
    import tempfile

    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.testing import DistributedQueryRunner

    runner = DistributedQueryRunner(num_workers=GOV_WORKERS, devices=[dev] * GOV_WORKERS,
                                    **kwargs)
    runner.register_catalog("tpch", TpchConnector(scale))
    runner.register_catalog("memory", MemoryConnector())
    runner.start()
    runner.spool = tempfile.mkdtemp(prefix="chip_smoke_gov_spool_")
    runner.session_props = {
        "result_cache_enabled": "false", "retry_policy": "TASK",
        "exchange_spool_dir": runner.spool, "split_driven_scans": "false",
    }
    for c in runner.coordinators:
        for k, v in runner.session_props.items():
            c.session.set(k, v)
    return runner


def stop_runner(runner, dev) -> None:
    import shutil

    runner.stop()
    shutil.rmtree(runner.spool, ignore_errors=True)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def gov_memory(runner, gate, queries, want, ordered, dev) -> dict:
    """Q18 over node pools of one and a half reservations, by revocation and
    spill with no kill; the low-memory killer's typed error between two
    queries that cannot both fit; CORRUPT frames refetched on Q3."""
    from trino_tpu_torch.runtime import wire

    coord = runner.coordinator
    s = coord.session
    out = {}

    def revocable_done(qid, tasks=None):
        """Have the revocable leaf tasks of `qid` (or `tasks`) all finished?"""
        if tasks is None:
            tasks = [t for t in gate.started if t.startswith(qid)
                     and (gate.info.get(t) or {}).get("revocable")
                     and (gate.info.get(t) or {}).get("leaf")]
        return len(tasks) >= GOV_WORKERS and set(tasks) <= set(gate.finished)

    # the unrevoked run: the pools hold every task of Q18 at once.  Peaks
    # are read twice: while the revocable stage (the lineitem partial
    # aggregate) runs, and over the whole query, whose last stage no
    # revocation touches
    for w in runner.workers:
        w.memory_pool.set_capacity(1 << 50)
    s.set("task_memory_reserve_bytes", str(GOV_RESERVE))
    s.set("low_memory_killer_delay_s", str(GOV_KILLER_DELAY_S))
    s.set("memory_blocked_timeout_s", "60")
    drop_cluster_caches(runner, dev)
    base0 = device_memory(dev, reset=True)
    t0 = time.perf_counter()
    qid0 = coord.submit_query(queries["q18"])
    gov_wait(lambda: revocable_done(qid0), "memory: the unrevoked q18's leaf stage never ended", 300)
    stage0 = device_memory(dev)
    record = coord.queries[qid0]
    gov_wait(lambda: record["sm"].done, "memory: the unrevoked q18 never finished", 300)
    ms0 = (time.perf_counter() - t0) * 1e3
    if record["sm"].state != "FINISHED":
        fail(f"governance memory: unrevoked q18 {record['sm'].state}: {record['sm'].error}")
    rows_agree(record["result"], want["q18"], "q18", "governance memory q18 unrevoked vs tpch",
               ordered)
    end0 = device_memory(dev)
    revocations0 = sum(w.memory_pool.revocations for w in runner.workers)
    given0 = sum(w.revoked_device_bytes for w in runner.workers)
    kills0 = coord.oom_kills
    if revocations0:
        fail("governance memory: a revocation in the unrevoked run")
    # the revoked run: Q18's leaf stages send each worker their tasks at
    # once into a pool of one and a half reservations.  The revocable ones
    # (the lineitem partial aggregate) reserve first and are held; then one
    # other task of the worker reserves and blocks; the pressure outlasts
    # the killer's delay, the coordinator revokes Q18's revocable leases on
    # each node (after which the blocked one fits), the worker gives back
    # its cached columns, and the held tasks, released, run sliced; the
    # other tasks wait for the release, and then queue for the pool
    for w in runner.workers:
        w.memory_pool.set_capacity(GOV_NODE_BYTES)
    warm = device_memory(dev, reset=True)
    qa, passed = {}, set()

    def before(task_id, url):
        """A worker's revocable tasks reserve at once; one other task once
        a revocable one holds its reservation there; the rest at release."""
        info = gate.info.get(task_id) or {}
        if not gate.first(task_id) or info.get("revocable"):
            return None
        with gate._lock:
            reached = gate.reached.setdefault(url, threading.Event())
            if not reached.is_set():
                return reached
            if url not in passed:
                passed.add(url)
                return None
            return gate.gate

    gate.arm(lambda t: gate.first(t) and (gate.info.get(t) or {}).get("revocable", False),
             before=before)
    t0 = time.perf_counter()
    try:
        qa["id"] = coord.submit_query(queries["q18"])
        gov_wait(lambda: all(w.memory_pool.revocations >= 1 for w in runner.workers),
                 "memory: the pools' pressure never revoked on every worker "
                 f"({[w.memory_pool.snapshot() for w in runner.workers]}; tasks "
                 f"{[(t, i['revocable'], i['leaf']) for t, i in gate.info.items() if gate.first(t)]})",
                 60)
        # from here on a task that waits for memory queues: the later
        # stages wait for the sliced ones, which outlast a short delay
        s.set("low_memory_killer_delay_s", str(GOV_HOLD_S))
        held = list(gate.held)
        after_revoke = device_memory(dev, reset=True)
    finally:
        gate.release()
    gov_wait(lambda: revocable_done(qa["id"], held), "memory: the revoked tasks never ended", 300)
    stage1 = device_memory(dev)
    record = coord.queries[qa["id"]]
    gov_wait(lambda: record["sm"].done, "memory: the revoked q18 never finished", 300)
    ms1 = (time.perf_counter() - t0) * 1e3
    if record["sm"].state != "FINISHED":
        fail(f"governance memory: revoked q18 {record['sm'].state}: {record['sm'].error}")
    rows_agree(record["result"], want["q18"], "q18", "governance memory q18 revoked vs tpch",
               ordered)
    peak1 = max(after_revoke["peak"], device_memory(dev)["peak"])
    qi = record.get("query_info") or {}
    revoked_tasks = int(qi.get("memory_revocations") or 0)
    revocations = sum(w.memory_pool.revocations for w in runner.workers) - revocations0
    given = sum(w.revoked_device_bytes for w in runner.workers) - given0
    if coord.oom_kills != kills0:
        fail("governance memory: the revoked q18 was answered by a kill")
    if revocations < GOV_WORKERS or revoked_tasks < GOV_WORKERS:
        fail(f"governance memory: {revocations} revocations, {revoked_tasks} revoked tasks")
    if not after_revoke["allocated"] < warm["allocated"]:
        fail(f"governance memory: memory_allocated did not fall after the revoke "
             f"({warm['allocated']} -> {after_revoke['allocated']})")
    if not stage1["peak"] < stage0["peak"]:
        fail(f"governance memory: the revoked stage peaked at {stage1['peak']} bytes, the "
             f"unrevoked one at {stage0['peak']}")
    out["revocation_q18"] = {
        "node_pool_bytes": GOV_NODE_BYTES, "reserve_bytes": GOV_RESERVE,
        "revocations": revocations, "revoked_tasks": revoked_tasks, "kills": 0,
        "cache_bytes_given_back": given,
        "unrevoked": {"ms": ms0, "base_allocated": base0["allocated"],
                      "stage_peak_allocated": stage0["peak"],
                      "peak_allocated": max(stage0["peak"], end0["peak"]),
                      "end_allocated": end0["allocated"]},
        "revoked": {"ms": ms1, "allocated_before_revoke": warm["allocated"],
                    "allocated_after_revoke": after_revoke["allocated"],
                    "stage_peak_allocated": stage1["peak"], "peak_allocated": peak1},
    }
    # the killer: revocation off, two queries that cannot both fit.  Q3's
    # leaf tasks are held past their reservations (one per worker fits, the
    # others block), Q6's block behind them; the pressure outlasts the delay
    # and the largest reservation (Q3) dies
    s.set("memory_revocation_enabled", "false")
    s.set("low_memory_killer_delay_s", str(GOV_KILLER_DELAY_S))
    t0 = time.perf_counter()
    victim = {}
    gate.arm(gate.first)
    try:
        victim["id"] = coord.submit_query(queries["q03"])
        gov_wait(lambda: len(gate.held) >= GOV_WORKERS, "memory: q03 never held its pools")
        other = coord.submit_query(queries["q06"])
        rec_v, rec_o = coord.queries[victim["id"]], coord.queries[other]
        gov_wait(lambda: rec_v["sm"].done, "memory: the killer never fired", 60)
    finally:
        gate.release()
    gov_wait(lambda: rec_o["sm"].done, "memory: q06 never finished beside the kill", 120)
    if rec_v["sm"].state != "FAILED" or "CLUSTER_OUT_OF_MEMORY" not in (rec_v["sm"].error or ""):
        fail(f"governance killer: q03 {rec_v['sm'].state}: {rec_v['sm'].error}")
    if rec_o["sm"].state != "FINISHED":
        fail(f"governance killer: q06 {rec_o['sm'].state}: {rec_o['sm'].error}")
    rows_agree(rec_o["result"], want["q06"], "q06", "governance killer q06 vs tpch", ordered)
    if coord.oom_kills != kills0 + 1:
        fail(f"governance killer: {coord.oom_kills - kills0} kills, not one")
    out["killer"] = {"victim": "q03", "survivor": "q06", "kills": 1,
                     "error": (rec_v["sm"].error or "")[:160],
                     "seconds": round(time.perf_counter() - t0, 3)}
    s.set("memory_revocation_enabled", "true")
    s.set("task_memory_reserve_bytes", "0")
    for w in runner.workers:
        w.memory_pool.set_capacity(1 << 50)
    # corrupted frames: every served page frame of the first two fetches
    # per worker gets a flipped byte; the consumer's crc32 check refetches
    t0 = time.perf_counter()
    before_err = wire._TRANSPORT_ERRORS.value()
    for i in range(GOV_WORKERS):
        runner.workers[i].fault_injector.fired.clear()
        runner.inject_task_failure(i, mode="CORRUPT", count=2)
    try:
        rows = runner.query(queries["q03"])
    finally:
        for w in runner.workers:
            w.fault_injector.clear()
    rows_agree(rows, want["q03"], "q03", "governance corrupt q03 vs tpch", ordered)
    fired = sum(m == "CORRUPT" for w in runner.workers for m, _ in w.fault_injector.fired)
    detected = wire._TRANSPORT_ERRORS.value() - before_err
    heal_links(runner)  # the corrupt frames graded links: placement would avoid them
    if not fired or not detected:
        fail(f"governance corrupt: {fired} frames corrupted, {detected} detected")
    out["corrupt_q03"] = {"frames_corrupted": fired, "detected": detected,
                          "seconds": round(time.perf_counter() - t0, 3)}
    return out


def gov_disk(runner, queries, want, ordered) -> dict:
    """A disk budget below Q18's spooled bytes, full of fragment memo: the
    blocked commits are freed by reclaim (memo only, never a live spool);
    then a spool-lost fault drives reproduction."""
    from trino_tpu_torch.runtime.spool import SpooledExchange

    coord = runner.coordinator
    out = {}
    t0 = time.perf_counter()
    rows = runner.query(queries["q18"])
    rows_agree(rows, want["q18"], "q18", "governance disk q18 vs tpch", ordered)
    qi = last_query_info(runner)
    by_worker = {}
    for st in qi.get("stages") or []:
        for t in st.get("tasks") or []:
            url = t.get("worker") or ""
            by_worker[url] = by_worker.get(url, 0) + int(t.get("output_bytes") or 0)
    by_worker.pop("coordinator", None)
    spooled = sum(by_worker.values())
    # each worker's budget is below what Q18 spools in all (one worker never
    # holds all of it), and starts full of fragment memo: no commit of Q18
    # fits unless a reclaim frees memo first
    budget = spooled - 1
    memo = []
    for i, w in enumerate(runner.workers):
        pool = w.disk_pool
        pool.set_capacity(budget)
        pool.reserve("gov_probe", 0).release()  # harvests the leases of deleted dirs
        name = f"memo_gov_w{i}_p0"
        SpooledExchange(runner.spool, disk_pool=pool).commit_task(
            name, {0: [bytes(budget - pool.reserved)]})
        memo.append(name)
    reclaims0 = [w.disk_pool.reclaims for w in runner.workers]
    sheds0 = [w.disk_pool.sheds for w in runner.workers]
    rows = runner.query(queries["q18"])
    rec = coord.queries[list(coord.queries)[-1]]
    rows_agree(rows, want["q18"], "q18", "governance disk q18 over a full budget vs tpch",
               ordered)
    reclaimed = [w.disk_pool.reclaims - r for w, r in zip(runner.workers, reclaims0)]
    shed = [w.disk_pool.sheds - n for w, n in zip(runner.workers, sheds0)]
    left = [n for n in memo if os.path.exists(os.path.join(runner.spool, n))]
    if not any(reclaimed) or len(left) == len(memo):
        fail(f"governance disk: no reclaim freed a blocked commit ({reclaimed}, memo left {left})")
    if any(shed) or rec.get("spool_reproductions", 0) or rec.get("task_retries", 0):
        fail(f"governance disk: sheds {shed}, reproductions "
             f"{rec.get('spool_reproductions', 0)}, retries {rec.get('task_retries', 0)}")
    out["reclaim_q18"] = {"budget_bytes": budget, "q18_spooled_bytes": spooled,
                          "q18_spooled_bytes_by_worker": sorted(by_worker.values()),
                          "memo_evicted": len(memo) - len(left), "reclaims": reclaimed,
                          "sheds": 0, "seconds": round(time.perf_counter() - t0, 3)}
    for w in runner.workers:
        w.disk_pool.set_capacity(1 << 50)
    # a committed partition lost before its consumer reads it
    t0 = time.perf_counter()
    for i in range(GOV_WORKERS):
        runner.inject_task_failure(i, mode="SPOOL_LOST")
    try:
        rows = runner.query(queries["q03"])
    finally:
        for w in runner.workers:
            w.fault_injector.clear()
    rows_agree(rows, want["q03"], "q03", "governance spool lost q03 vs tpch", ordered)
    heal_links(runner)
    rec = coord.queries[list(coord.queries)[-1]]
    repro = rec.get("spool_reproductions", 0)
    if repro < 1:
        fail("governance disk: a lost spool partition drove no reproduction")
    out["spool_lost_q03"] = {"reproductions": repro,
                             "seconds": round(time.perf_counter() - t0, 3)}
    return out


def gov_resource_groups(runner, gate, queries, want, ordered) -> dict:
    """A resource group of concurrency 1: the second query queues, then runs;
    a queued cancel leaves nothing behind.  Then the cluster memory limit:
    its killer takes the query that buffers most, which requeues out of
    core and answers."""
    from trino_tpu_torch.runtime.resourcegroups import ResourceGroupConfig, ResourceGroupManager

    coord = runner.coordinator
    out = {}
    t0 = time.perf_counter()
    saved = coord.resource_groups
    coord.resource_groups = ResourceGroupManager(ResourceGroupConfig(max_concurrency=1,
                                                                     max_queued=5))
    ids = {}
    gate.arm(gate.first)
    try:
        ids["first"] = coord.submit_query(queries["q06"])
        gov_wait(lambda: gate.held, "resource groups: q06 never started")
        ids["queued"] = coord.submit_query(queries["q01"])
        ids["canceled"] = coord.submit_query(queries["q03"])
        states = {k: coord.queries[v]["sm"].state for k, v in ids.items()}
        if states["queued"] != "QUEUED" or states["canceled"] != "QUEUED":
            fail(f"resource groups: no query queued behind the running one: {states}")
        if not coord.cancel_query(ids["canceled"]):
            fail("resource groups: the queued query could not be canceled")
    finally:
        gate.release()
    recs = {k: coord.queries[v] for k, v in ids.items()}
    gov_wait(lambda: all(r["sm"].done for r in recs.values()),
             "resource groups: the queries never finished", 120)
    rows_agree(recs["first"]["result"], want["q06"], "q06", "governance rg q06 vs tpch", ordered)
    if recs["queued"]["sm"].state != "FINISHED":
        fail(f"resource groups: the queued q01 {recs['queued']['sm'].state}")
    rows_agree(recs["queued"]["result"], want["q01"], "q01", "governance rg q01 vs tpch", ordered)
    stats = coord.resource_groups.stats()["global"]
    ran = [t for t in gate.started if t.startswith(ids["canceled"])]
    leftovers = [n for n in os.listdir(runner.spool) if n.startswith(ids["canceled"])]
    if recs["canceled"]["sm"].state != "FAILED" or ran or leftovers \
            or stats.get("running") or stats.get("queued"):
        fail(f"resource groups: the canceled query left {ran} tasks, {leftovers} spool dirs,"
             f" {recs['canceled']['sm'].state}, group {stats}")
    coord.resource_groups = saved
    out["concurrency_1"] = {"queued_then_ran": "q01", "canceled_queued": "q03",
                            "group": stats, "seconds": round(time.perf_counter() - t0, 3)}
    # the cluster memory limit: with no spool the finished stages' output
    # waits in the workers' buffers (un-acked under task retry) while the
    # script holds every consumer task; the heartbeat sweep kills the query
    # holding most, whose stage wait sees the kill and requeues it
    t0 = time.perf_counter()
    coord.session.set("exchange_spool_dir", "")
    kills0, requeues0 = coord.memory_kills, coord.memory_requeues
    ids = {}
    gate.arm(lambda t: not (gate.info.get(t) or {}).get("leaf", True))
    try:
        ids["q18"] = coord.submit_query(queries["q18"])
        ids["q03"] = coord.submit_query(queries["q03"])
        gov_wait(lambda: {t.rsplit("_a", 1)[0] for t in gate.held} >= set(ids.values()),
                 "cluster memory: the consumer stages never started")

        def buffered():
            got = {}
            for w in runner.workers:
                for q, b in w.buffered_by_query().items():
                    got[q] = got.get(q, 0) + b
            return got

        gov_wait(lambda: all(buffered().get(q, 0) for q in ids.values()),
                 "cluster memory: nothing buffered")
        held_bytes = buffered()
        coord.cluster_memory_limit_bytes = sum(held_bytes.get(q, 0) for q in ids.values()) - 1
        gov_wait(lambda: coord.memory_kills > kills0, "cluster memory: no kill", 30)
    finally:
        coord.cluster_memory_limit_bytes = 0
        gate.release()
    recs = {k: coord.queries[v] for k, v in ids.items()}
    gov_wait(lambda: all(r["sm"].done for r in recs.values()),
             "cluster memory: the queries never finished", 300)
    coord.session.set("exchange_spool_dir", runner.spool)
    killed = [k for k, r in recs.items() if "cluster memory limit" in (r.get("kill_reason") or "")]
    biggest = max(ids, key=lambda k: held_bytes.get(ids[k], 0))
    for k, r in recs.items():
        if r["sm"].state != "FINISHED":
            fail(f"cluster memory: {k} {r['sm'].state}: {r['sm'].error}")
        rows_agree(r["result"], want[k], k, f"governance cluster memory {k} vs tpch", ordered)
    if killed != [biggest] or coord.memory_kills != kills0 + 1 \
            or coord.memory_requeues != requeues0 + 1:
        fail(f"cluster memory: killed {killed}, the biggest {biggest} ({held_bytes}), "
             f"{coord.memory_requeues - requeues0} requeues")
    out["cluster_memory"] = {"killed": biggest, "buffered_bytes": {k: held_bytes.get(v, 0)
                                                                    for k, v in ids.items()},
                             "requeued_out_of_core": 1,
                             "seconds": round(time.perf_counter() - t0, 3)}
    return out


def gov_recovery(runner, gate, queries, want, ordered) -> dict:
    """The coordinator killed mid-Q18 after a stage committed to the spool:
    the restart replays the journal; RESUME re-reads committed stages and
    runs no task of them again, RESTART recomputes them.  A CTAS into the
    memory catalog crashed at the intent (a clean abort) and after its
    commit (a no-op replay)."""
    from trino_tpu_torch.runtime.journal import QueryJournal
    from trino_tpu_torch.runtime.txn import TXN_TOTAL

    out = {}
    last = want["_q18_last_stage"]
    for policy in ("RESUME", "RESTART"):
        t0 = time.perf_counter()
        coord = runner.coordinator
        # the last stage's tasks wait: every other stage commits first
        gate.arm(lambda t: task_fragment(t) == last)
        try:
            qid = coord.submit_query(queries["q18"])
            gov_wait(lambda: gate.held and committed_fragments(runner.spool, qid),
                     f"recovery {policy}: no stage committed before the held one")
            committed = committed_fragments(runner.spool, qid)
            port = runner.kill_coordinator()
            mark = len(gate.started)
            wait_port_free(port)
            coord2 = runner.restart_coordinator(
                port=port, session=dict(runner.session_props, resume_policy=policy))
        finally:
            gate.release()
        gov_wait(lambda: qid in coord2.queries, f"recovery {policy}: nothing resumed", 30)
        record = coord2.queries[qid]
        gov_wait(lambda: record["sm"].done, f"recovery {policy}: q18 never finished", 300)
        if record["sm"].state != "FINISHED":
            fail(f"recovery {policy}: q18 {record['sm'].state}: {record['sm'].error}")
        rows_agree(record["result"], want["q18"], "q18", f"governance recovery {policy} vs tpch",
                   ordered)
        rerun = sorted({task_fragment(t) for t in gate.started_since(mark)
                        if t.startswith(qid) and task_fragment(t) in committed})
        if policy == "RESUME" and (rerun or record.get("stages_resumed", 0) < 1):
            fail(f"recovery RESUME: committed stages {sorted(committed)} ran again: {rerun}"
                 f" (stages resumed {record.get('stages_resumed', 0)})")
        if policy == "RESTART" and not rerun:
            fail(f"recovery RESTART: committed stages {sorted(committed)} were not recomputed")
        out[f"q18_{policy.lower()}"] = {
            "committed_before_kill": sorted(committed), "rerun_after_restart": rerun,
            "stages_resumed": record.get("stages_resumed", 0),
            "seconds": round(time.perf_counter() - t0, 3)}
    # writes: a CTAS crashed at its intent aborts clean, after its commit
    # replays as a no-op
    conn = runner.catalogs.get("memory")
    li = want["_lineitem_big"]
    for phase, table in (("intent", "gov_ctas_intent"), ("ack", "gov_ctas_ack")):
        t0 = time.perf_counter()
        coord = runner.coordinator
        counter = "aborted" if phase == "intent" else "replayed_noop"
        n0 = TXN_TOTAL.value(counter)
        runner.inject_write_failure(phase=phase)
        sql = GOV_CTAS.format(t=table)
        errors: list = []
        threading.Thread(target=_quiet, args=(errors, coord.execute_query, sql),
                         daemon=True).start()
        gov_wait(lambda: coord._killed,
                 f"recovery CTAS {phase}: the crash never fired (the statement: {errors})")
        port = coord.port
        wait_port_free(port)
        coord2 = runner.restart_coordinator(port=port, session=runner.session_props)
        gov_wait(lambda: TXN_TOTAL.value(counter) == n0 + 1,
                 f"recovery CTAS {phase}: the replay never settled the write", 60)
        gov_wait(lambda: all(r["done"].is_set() for r in coord2.queries.values()),
                 f"recovery CTAS {phase}: a replayed query never finished", 60)
        exists = table in conn.list_tables()
        if phase == "intent":
            if exists or conn.orphaned_staging():
                fail(f"recovery CTAS intent: table {exists}, staging {conn.orphaned_staging()}")
        else:
            got = coord2.execute_query(f"select count(*), sum(l_quantity) from memory.{table}")
            if [list(r) for r in got] != [li]:
                fail(f"recovery CTAS ack: {got} != numpy {li} (applied twice or lost)")
        jq = QueryJournal.replay(runner.journal_path)
        out[f"ctas_{phase}"] = {"outcome": counter, "table_exists": exists,
                                "journaled_queries": len(jq),
                                "seconds": round(time.perf_counter() - t0, 3)}
    return out


def _quiet(errors: list, fn, *args) -> None:
    try:
        fn(*args)
    except Exception as e:  # a coordinator that crashes mid-statement answers nothing
        errors.append(repr(e)[:400])


def learned_tiers(runner) -> list:
    """The capacity tiers the workers learned: each plan's caps, sorted."""
    return sorted({tuple(sorted(caps.items())) for w in runner.workers
                   for _, caps, _ in w.scan_cache.learned_caps.values()})


def gov_splits(scale, dev, gate, queries, want, ordered) -> tuple:
    """Q1, Q6 and TOPN under split-driven scans at SF `scale` and at
    GOV_SPLIT_SMALL: the morsel count grows with scale, the executed
    signatures, kernel 2's recipes and the capacity tiers do not.  Then a
    worker killed mid-scan: zero client failures, 1 <= retries < splits, and
    no committed morsel read again.  Returns (lines, the runner's counts)."""
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.ops.cuda import fused, fused_codegen
    from trino_tpu_torch.utils.profiler import PROFILER

    cpu = tpch_engine("cpu", GOV_SPLIT_SMALL)
    small_want = {n: cpu.query(TOPN if n == "topn" else queries[n]) for n in GOV_SPLIT_QUERIES}
    del cpu
    per_scale = {}
    for sf, rows_want in ((GOV_SPLIT_SMALL, small_want), (scale, want)):
        t0 = time.perf_counter()
        runner = gov_runner(sf, dev)
        gate.attach(runner.workers)
        runner.coordinator.session.set("split_driven_scans", "true")
        runner.coordinator.session.set("split_target_rows", str(GOV_SPLIT_ROWS))
        recipes = set()
        plain_run = fused.run

        def counted(recipe, scan_cols, live):
            recipes.add(fused_codegen.recipe_key(recipe))
            return plain_run(recipe, scan_cols, live)

        fused.run = counted
        try:
            built0 = len(fused_codegen._KERNELS)
            before = PROFILER.snapshot()
            splits = {}
            for name in GOV_SPLIT_QUERIES:
                rows = runner.query(TOPN if name == "topn" else queries[name])
                rows_agree(rows, rows_want[name], name, f"governance splits {name} at SF {sf}",
                           ordered)
                splits[name] = (last_query_info(runner).get("splits") or {}).get("splits", 0)
            after = PROFILER.snapshot()
        finally:
            fused.run = plain_run
        used = sorted(sig for sig, e in after.items()
                      if e.get("executes", 0) + e.get("fallback_executes", 0)
                      > (before.get(sig) or {}).get("executes", 0)
                      + (before.get(sig) or {}).get("fallback_executes", 0))
        per_scale[sf] = {"splits": splits, "signatures": used, "recipes": sorted(recipes),
                         "recipes_built": len(fused_codegen._KERNELS) - built0,
                         "tiers": learned_tiers(runner),
                         "seconds": round(time.perf_counter() - t0, 3)}
        if sf == scale:
            big = runner
        else:
            gate.detach(runner.workers)
            stop_runner(runner, dev)
    lo, hi = per_scale[GOV_SPLIT_SMALL], per_scale[scale]
    if not all(hi["splits"][n] > lo["splits"][n] >= 1 for n in GOV_SPLIT_QUERIES):
        fail(f"governance splits: the morsel count did not grow with scale: {lo['splits']} "
             f"-> {hi['splits']}")
    if not lo["signatures"] or len(lo["signatures"]) != len(hi["signatures"]):
        fail(f"governance splits: executed signatures {lo['signatures']} -> {hi['signatures']}")
    if not lo["recipes"] or lo["recipes"] != hi["recipes"] or hi["recipes_built"]:
        fail(f"governance splits: kernel 2 recipes {lo['recipes']} -> {hi['recipes']}, "
             f"{hi['recipes_built']} built at SF {scale}")
    if not lo["tiers"] or len(lo["tiers"]) != len(hi["tiers"]):
        fail(f"governance splits: capacity tiers {lo['tiers']} -> {hi['tiers']}")
    lines = {"scales": {str(k): {**v, "signatures": len(v["signatures"]),
                                 "recipes": len(v["recipes"]), "tiers": len(v["tiers"])}
                        for k, v in per_scale.items()}}
    # the kill drill, on the SF `scale` runner: four morsels commit, the next
    # three (one per worker) are held at the fault hook, worker 1 dies
    t0 = time.perf_counter()
    runner = big
    try:
        conn = runner.catalogs.get("tpch")
        reads, rlock = {}, threading.Lock()
        plain_read = type(conn).read_split

        def read_split(split, columns):
            if split.table == "lineitem":
                with rlock:
                    reads[split.part] = reads.get(split.part, 0) + 1
            return plain_read(conn, split, columns)

        conn.read_split = read_split
        runner.coordinator.session.set("split_queue_depth", "1")
        gate.arm(lambda t: (gate.info.get(t) or {}).get("leaf", False), free=4)
        try:
            qid = runner.coordinator.submit_query(GOV_KILL_SQL)
            gov_wait(lambda: len(gate.held) >= GOV_WORKERS
                     and len(committed_tasks(runner.spool, qid)) >= 4,
                     "splits kill: the scan never reached mid-flight")
            before_kill = {task_part(t) for t in committed_tasks(runner.spool, qid)}
            runner.kill_worker(1)
        finally:
            gate.release()
        record = runner.coordinator.queries[qid]
        gov_wait(lambda: record["sm"].done, "splits kill: the query never finished", 300)
        del conn.read_split
        if record["sm"].state != "FINISHED":
            fail(f"splits kill: {record['sm'].state}: {record['sm'].error}")
        rows_match([tuple(r) for r in record["result"]], [tuple(want["_kill"])],
                   "governance splits kill vs numpy")
        info = (record.get("query_info") or {}).get("splits") or {}
        n, retries, steals = info.get("splits", 0), info.get("retries", 0), info.get("steals", 0)
        reread = sorted(p for p in before_kill if reads.get(p, 0) > 1)
        if not (1 <= retries < n) or info.get("completed") != n or reread \
                or not n <= sum(reads.values()) <= n + retries + steals:
            fail(f"splits kill: {info}, reads {reads}, committed morsels read again {reread}")
        lines["kill_mid_scan"] = {"splits": n, "retries": retries, "steals": steals,
                                  "reads": sum(reads.values()),
                                  "committed_before_kill": len(before_kill),
                                  "client_failures": 0,
                                  "seconds": round(time.perf_counter() - t0, 3)}
    finally:
        gate.detach(runner.workers)
        stop_runner(runner, dev)
    return lines


def gov_fleet(scale, dev, gate, queries, want, ordered) -> dict:
    """Two coordinators behind FleetRouter over three workers: Q6 and Q3
    through the router, then the coordinator owning a Q18 killed mid-query;
    the survivor adopts it from the dead member's journal and recomputes no
    committed stage."""
    from trino_tpu_torch.client import StatementClient

    t0 = time.perf_counter()
    runner = gov_runner(scale, dev, num_coordinators=2, fleet_ttl_s=1.5,
                        heartbeat_interval=0.3)
    gate.attach(runner.workers)
    out = {}
    try:
        for c in runner.coordinators:
            c.session.set("resume_policy", "RESUME")
        for name in ("q06", "q03"):
            got = protocol_rows(runner.query_via_protocol(queries[name]), want[name])
            rows_agree(got, want[name], name, f"governance fleet {name} through the router",
                       ordered)
        routed = {f"c{i}": len(c.queries) for i, c in enumerate(runner.coordinators)}
        res = {}
        client = StatementClient(runner.client_url, reattach_max_elapsed_s=90.0)

        def go():
            try:
                res["rows"] = client.execute(queries["q18"], timeout=300)[1]
            except Exception as e:
                res["err"] = e

        # Q3 and Q6 are done: only Q18's last stage is held
        gate.arm(lambda t: task_fragment(t) == want["_q18_last_stage"])
        th = threading.Thread(target=go, daemon=True)
        try:
            th.start()
            gov_wait(lambda: gate.held, "fleet: q18 never reached its last stage")
            owner = next(i for i, c in enumerate(runner.coordinators)
                         if any(not r["done"].is_set() for r in c.queries.values()))
            q18 = next(q for q, r in runner.coordinators[owner].queries.items()
                       if not r["done"].is_set())
            gov_wait(lambda: committed_fragments(runner.spool, q18),
                     "fleet: no stage committed before the kill")
            committed = committed_fragments(runner.spool, q18)
            runner.kill_coordinator(owner)
            mark = len(gate.started)
        finally:
            gate.release()
        th.join(timeout=300)
        if th.is_alive() or "err" in res:
            fail(f"fleet: the client saw {res.get('err')!r} (alive {th.is_alive()})")
        rows_agree(protocol_rows(res["rows"], want["q18"]), want["q18"], "q18",
                   "governance fleet q18 across the kill", ordered)
        survivor = runner.coordinators[1 - owner]
        adopted = [r for r in survivor.queries.values() if r.get("adopted_from")]
        rerun = sorted({task_fragment(t) for t in gate.started_since(mark)
                        if task_fragment(t) in committed and q18 in t})
        if not adopted or rerun:
            fail(f"fleet: adopted {len(adopted)}, committed stages {sorted(committed)} ran "
                 f"again: {rerun}")
        out = {"routed": routed, "owner": f"c{owner}", "adopted_by": f"c{1 - owner}",
               "committed_before_kill": sorted(committed), "recomputed": rerun,
               "stages_resumed": adopted[0].get("stages_resumed", 0),
               "seconds": round(time.perf_counter() - t0, 3)}
    finally:
        gate.detach(runner.workers)
        stop_runner(runner, dev)
    return out


def governance_phase(engine, scale, tpch_rows, device=None):
    """The control plane of the cluster on the card at TPC-H `scale`, three
    workers on one card (memory and disk escalation, split-driven scans,
    resource groups, journal replay, the write path's coordinator crashes,
    the fleet router), every result against the tpch phase's rows (TOPN:
    the TPC-H engine's).  Returns (the path's launch counts, phase
    seconds)."""
    import shutil
    import tempfile

    from trino_tpu_torch.connectors.tpch import tpch_data
    from trino_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    dev = torch.device(device) if device is not None else torch.device("cuda", 0)
    queries, ordered = tpch_queries()
    ordered = dict(ordered, topn=True)
    li = tpch_data("lineitem", scale)
    qty = np.asarray(li["l_quantity"], np.int64)  # decimal(12,2), unscaled
    big = qty[qty > 4500]
    want = dict(tpch_rows, topn=engine.query(TOPN),
                _kill=(len(qty), exact_sum(np.asarray(li["l_partkey"], np.int64))),
                _lineitem_big=[len(big), Decimal(exact_sum(big)) / 100])
    engine.executor.drop_scans()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    kernels.set_policy(kernels.KernelPolicy())
    gate = TaskGate()
    gate.install()
    journal_dir = tempfile.mkdtemp(prefix="chip_smoke_gov_journal_")
    journal = os.path.join(journal_dir, "journal.jsonl")
    reset_kernel_counts()  # every count to 0 just before the path, read just after
    try:
        runner = gov_runner(scale, dev, heartbeat_interval=0.1, node_memory_bytes=1 << 50,
                            disk_budget_bytes=1 << 50, journal_path=journal)
        gate.attach(runner.workers)
        try:
            steps = (
                ("memory", lambda: gov_memory(runner, gate, queries, want, ordered, dev)),
                ("disk", lambda: gov_disk(runner, queries, want, ordered)),
                ("resource_groups",
                 lambda: gov_resource_groups(runner, gate, queries, want, ordered)),
                ("recovery", lambda: gov_recovery(runner, gate, queries, want, ordered)),
            )
            for step, fn in steps:
                t0 = time.perf_counter()
                if step == "recovery":  # Q18's last worker stage, from its last run
                    coord = runner.coordinator
                    qid = [q for q, r in coord.queries.items()
                           if r.get("sql") == queries["q18"] and r.get("stage_times")][-1]
                    want["_q18_last_stage"] = last_worker_stage(coord, qid)
                emit({"phase": "governance", "step": step, "correct": True, **fn(),
                      "seconds": round(time.perf_counter() - t0, 3)})
        finally:
            gate.detach(runner.workers)
            stop_runner(runner, dev)
        t0 = time.perf_counter()
        emit({"phase": "governance", "step": "splits", "correct": True,
              **gov_splits(scale, dev, gate, queries, want, ordered),
              "seconds": round(time.perf_counter() - t0, 3)})
        emit({"phase": "governance", "step": "fleet", "correct": True,
              **gov_fleet(scale, dev, gate, queries, want, ordered)})
        counts = kernel_counts()
    finally:
        gate.uninstall()
        shutil.rmtree(journal_dir, ignore_errors=True)
    for k in KERNEL_NAMES:
        if counts[k] < 1:
            fail(f"governance path never launched {k}: {counts}")
    seconds = time.perf_counter() - t_phase
    emit({"phase": "governance", "step": "summary", "scale": scale,
          "seconds": round(seconds, 1), "launches": counts})
    return counts, seconds


# ----------------------------------- the result cache and the fragment memo

CACHE_QUERIES = ("q01", "q03", "q06", "q18")  # and TOPN: each executed warm, then a hit
# Q6 in another text: the cache key is the optimized plan's signature
CACHE_Q6_ALIKE = (
    "SELECT SUM(l_extendedprice * l_discount) AS revenue FROM lineitem "
    "WHERE l_shipdate >= DATE '1994-01-01' AND l_shipdate < DATE '1994-01-01' + INTERVAL '1' YEAR "
    "AND l_discount BETWEEN 0.06 - 0.01 AND 0.06 + 0.01 AND l_quantity < 24"
)
CACHE_ADMIT = "select count(*), sum(l_discount) from lineitem where l_quantity < 7"  # run nowhere else
CACHE_AGG = ("select l_quantity, count(*), sum(l_orderkey), min(l_orderkey), max(l_orderkey) "
             "from memory.big_qty group by l_quantity order by l_quantity")
# MERGE's source: one row per order key below half the largest one
CACHE_SRC = ("create table memory.cache_src as select l_orderkey as k, l_quantity as q "
             "from lineitem where l_linenumber = 1 and l_orderkey < {k}")
CACHE_SRC_SHARE = 1 / 2
CACHE_WRITES = (  # {k}: a share of the largest order key; each applied to numpy alike
    ("delete", "delete from memory.big_qty where l_orderkey < {k}", 1 / 6),
    ("update", "update memory.big_qty set l_quantity = l_quantity - 1 where l_orderkey < {k}", 1 / 3),
    ("insert", "insert into memory.big_qty select l_orderkey, l_quantity from memory.big_qty "
               "where l_orderkey >= {k}", 5 / 6),
    ("merge", "merge into memory.big_qty b using memory.cache_src s on b.l_orderkey = s.k "
              "when matched then update set l_quantity = s.q", 0),
)
# both leaves are memory tables: a write to the catalog moves both keys
CACHE_MEMO = (
    "select count(*), sum(b.l_quantity) from memory.big_qty b, memory.cache_src s "
    "where b.l_orderkey = s.k and s.q < 30",
    "select min(b.l_quantity), max(b.l_quantity), count(*) from memory.big_qty b, "
    "memory.cache_src s where b.l_orderkey = s.k and s.q < 30",
)
CACHE_MEMO_WRITE = "delete from memory.cache_src where k < {k}"
CACHE_ICEBERG = "select count(*) from iceberg.ice"
CACHE_TRAVEL = 'select k from iceberg."ice@2" order by k'
CACHE_COUNT = "select count(*) from memory.big_qty"
CACHE_CROSS_SCALE = 0.01
CACHE_TEST_FILE = "test_torch_result_cache"


class TaskLog:
    """Every task id the workers accept while installed (Worker.submit_task
    wrapped), and every scan a task runs per table (LocalExecutor.table_page
    wrapped): a hit schedules no task, and a memoized leaf runs no scan.
    A task id is `<query id>_a<attempt>_f<fragment>_p<part>_t<try>`."""

    def __init__(self):
        self.tasks: list = []
        self.scans: dict = {}
        self._lock = threading.Lock()
        self._plain = None

    def install(self) -> None:
        from trino_tpu_torch.exec.compiler import LocalExecutor
        from trino_tpu_torch.runtime.worker import Worker

        submit, page = Worker.submit_task, LocalExecutor.table_page
        self._plain = (submit, page)
        log = self

        def submit_task(w, req):
            with log._lock:
                log.tasks.append(req["task_id"])
            return submit(w, req)

        def table_page(ex, catalog, table, *args, **kwargs):
            with log._lock:
                log.scans[table] = log.scans.get(table, 0) + 1
            return page(ex, catalog, table, *args, **kwargs)

        Worker.submit_task = submit_task
        LocalExecutor.table_page = table_page

    def uninstall(self) -> None:
        from trino_tpu_torch.exec.compiler import LocalExecutor
        from trino_tpu_torch.runtime.worker import Worker

        if self._plain is not None:
            Worker.submit_task, LocalExecutor.table_page = self._plain
            self._plain = None

    def of(self, qid: str) -> list:
        with self._lock:
            return [t for t in self.tasks if t.rsplit("_a", 1)[0] == qid]

    def scan_total(self, *tables) -> int:
        with self._lock:
            return sum(self.scans.get(t, 0) for t in tables)


def cache_run(runner, sql: str, what: str):
    """`sql` through the coordinator's managed path: (rows, record, wall ms).
    The record carries `cached` and the cache disposition."""
    coord = runner.coordinator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qid = coord.submit_query(sql)
    record = coord.queries[qid]
    if not record["done"].wait(timeout=600):
        fail(f"caches {what}: the statement never finished")
    wall = (time.perf_counter() - t0) * 1e3
    if record["sm"].state != "FINISHED":
        fail(f"caches {what}: {record['sm'].state}: {record['sm'].error}")
    return [tuple(r) for r in record["result"]], record, wall


def cache_executed(log, rows_rec, what: str) -> int:
    """A run that must have executed: not cached, and tasks scheduled."""
    _rows, record, _wall = rows_rec
    n = len(log.of(record["sm"].query_id))
    if record.get("cached") or not n:
        fail(f"caches {what}: expected an execution, got cached={record.get('cached')} "
             f"with {n} tasks ({(record.get('cache') or {}).get('disposition')})")
    return n


def cache_hit(log, rows_rec, before: dict, what: str) -> dict:
    """A run that must have been served: cached, no stage, no task, no kernel
    launch and no device allocation since `before`."""
    _rows, record, _wall = rows_rec
    info = record.get("query_info") or {}
    tasks = log.of(record["sm"].query_id)
    launched = {k: v - before["launches"][k] for k, v in kernel_counts().items()}
    allocated = cuda_allocations() - before["allocations"]
    if record.get("cached") is not True or info.get("stage_count") or tasks:
        fail(f"caches {what}: not a hit (cached={record.get('cached')}, stages "
             f"{info.get('stage_count')}, tasks {tasks})")
    if (info.get("cache") or {}).get("disposition") != "hit":
        fail(f"caches {what}: disposition {info.get('cache')}")
    if any(launched.values()) or allocated:
        fail(f"caches {what}: a hit touched the card: launches {launched}, "
             f"{allocated} device allocations")
    return {"launches": sum(launched.values()), "allocations": allocated}


def card_state() -> dict:
    torch.cuda.synchronize()
    return {"launches": kernel_counts(), "allocations": cuda_allocations()}


def big_qty_rows(ok: np.ndarray, qty: np.ndarray) -> list:
    """CACHE_AGG over the numpy copy of memory.big_qty (qty unscaled)."""
    out = []
    for q in np.unique(qty):
        keys = ok[qty == q]
        out.append((dec(int(q), 2), len(keys), exact_sum(keys), int(keys.min()), int(keys.max())))
    return out


def cache_hits(runner, log, queries, want, ordered) -> dict:
    """Each statement once with the cache off (the cold run fills the workers'
    scan caches), then executed warm (a miss that stores), then a hit; Q6 in
    another text hits Q6's entry."""
    coord = runner.coordinator
    out, executed_tasks = {}, {}
    for name, sql in dict({n: queries[n] for n in CACHE_QUERIES}, topn=TOPN).items():
        coord.session.set("result_cache_enabled", "false")
        cold = cache_run(runner, sql, f"{name} cold")
        coord.session.set("result_cache_enabled", "true")
        before = kernel_counts()
        warm = cache_run(runner, sql, f"{name} warm")
        executed_tasks[name] = cache_executed(log, warm, f"{name} warm")
        launched = {k: v - before[k] for k, v in kernel_counts().items()}
        state = card_state()
        hit = cache_run(runner, sql, f"{name} hit")
        touched = cache_hit(log, hit, state, f"{name} hit")
        for label, run in (("cold", cold), ("warm", warm), ("hit", hit)):
            rows_agree(run[0], want[name], name, f"caches {name} ({label}) vs tpch", ordered)
        out[name] = {"cold_ms": cold[2], "executed_warm_ms": warm[2], "hit_ms": hit[2],
                     "tasks_executed": executed_tasks[name], "launches_executed": launched,
                     "hit_touched": touched}
    state = card_state()
    alike = cache_run(runner, CACHE_Q6_ALIKE, "q06 in another text")
    cache_hit(log, alike, state, "q06 in another text")
    rows_agree(alike[0], want["q06"], "q06", "caches q06 in another text vs tpch", ordered)
    out["q06_alike_hit_ms"] = alike[2]
    return out, executed_tasks


def cache_admission(runner, log, engine) -> dict:
    """At the session's default result_cache_min_recurrences the statement is
    stored once its signature recurred that many times in the history."""
    coord = runner.coordinator
    need = int(coord.session.get("result_cache_min_recurrences"))
    want = engine.query(CACHE_ADMIT)
    dispositions = []
    for i in range(need + 1):  # run n sees n - 1 records: run need + 1 stores
        run = cache_run(runner, CACHE_ADMIT, f"admission run {i + 1}")
        cache_executed(log, run, f"admission run {i + 1} of {need + 2}")
        rows_match(run[0], want, f"caches admission run {i + 1} vs the TPC-H engine")
        dispositions.append(run[1]["cache"]["disposition"])
    state = card_state()
    run = cache_run(runner, CACHE_ADMIT, "admission hit")
    cache_hit(log, run, state, f"admission run {need + 2}")
    rows_match(run[0], want, "caches admission hit vs the TPC-H engine")
    return {"min_recurrences": need, "executed_runs": need + 1,
            "dispositions": dispositions + [run[1]["cache"]["disposition"]]}


def cache_invalidation(runner, log, li, iceberg, tables: dict) -> dict:
    """The cluster's CTAS of lineitem's large quantities into memory.big_qty,
    CACHE_AGG cached over it, then DELETE, UPDATE, INSERT and MERGE: after
    each the next read executes and equals numpy over the changed table,
    and the one after it hits.  Then an Iceberg table: an external commit
    invalidates, a time-travel read bypasses.  Leaves the numpy copies of
    the memory tables in `tables`."""
    qty_all = np.asarray(li["l_quantity"], np.int64)
    keys_all = np.asarray(li["l_orderkey"], np.int64)
    big = qty_all > 4500
    ok, qty = keys_all[big].copy(), qty_all[big].copy()
    top = int(keys_all.max())
    first = np.asarray(li["l_linenumber"], np.int64) == 1
    src_cut = int(top * CACHE_SRC_SHARE)
    src = first & (keys_all < src_cut)
    src_q = dict(zip(keys_all[src].tolist(), qty_all[src].tolist()))
    runner.query(CLUSTER_CTAS)
    runner.query(CACHE_SRC.format(k=src_cut))
    out = {"rows": len(ok), "writes": []}

    def read_twice(label):
        want = big_qty_rows(ok, qty)
        miss = cache_run(runner, CACHE_AGG, f"aggregate after {label}")
        cache_executed(log, miss, f"aggregate after {label}")
        rows_match(miss[0], want, f"caches aggregate after {label} vs numpy")
        state = card_state()
        hit = cache_run(runner, CACHE_AGG, f"aggregate hit after {label}")
        cache_hit(log, hit, state, f"aggregate hit after {label}")
        rows_match(hit[0], want, f"caches aggregate hit after {label} vs numpy")
        return miss[2], hit[2]

    out["first"] = read_twice("the CTAS")
    for label, sql, frac in CACHE_WRITES:
        k = int(top * frac)
        t0 = time.perf_counter()
        runner.query(sql.format(k=k))
        write_ms = (time.perf_counter() - t0) * 1e3
        if label == "delete":
            ok, qty = ok[ok >= k], qty[ok >= k]
        elif label == "update":
            qty = np.where(ok < k, qty - 100, qty)
        elif label == "insert":
            ok, qty = np.concatenate([ok, ok[ok >= k]]), np.concatenate([qty, qty[ok >= k]])
        else:
            qty = np.array([src_q.get(o, q) for o, q in zip(ok.tolist(), qty.tolist())],
                           np.int64)
        miss_ms, hit_ms = read_twice(label)
        out["writes"].append({"write": label, "write_ms": write_ms, "executed_ms": miss_ms,
                              "hit_ms": hit_ms, "rows_after": len(ok)})
    # an Iceberg table: the snapshot id is the version
    runner.query("create table iceberg.ice (k bigint)")
    runner.query("insert into iceberg.ice values (1), (2)")
    run = cache_run(runner, CACHE_ICEBERG, "iceberg count")
    cache_executed(log, run, "iceberg count")
    state = card_state()
    hit = cache_run(runner, CACHE_ICEBERG, "iceberg count hit")
    cache_hit(log, hit, state, "iceberg count hit")
    if run[0] != [(2,)] or hit[0] != [(2,)]:
        fail(f"caches iceberg count: {run[0]}, {hit[0]} != [(2,)]")
    iceberg.insert("ice", {"k": np.array([3], dtype=np.int64)})  # no engine hook
    run = cache_run(runner, CACHE_ICEBERG, "iceberg count after an external commit")
    cache_executed(log, run, "iceberg count after an external commit")
    if run[0] != [(3,)]:
        fail(f"caches iceberg count after an external commit: {run[0]} != [(3,)]")
    for i in range(2):
        run = cache_run(runner, CACHE_TRAVEL, f"time travel {i + 1}")
        cache_executed(log, run, f"time travel {i + 1}")
        if run[0] != [(1,), (2,)] or run[1]["cache"].get("disposition") != "bypass":
            fail(f"caches time travel {i + 1}: {run[0]} ({run[1].get('cache')})")
    out["iceberg"] = {"external_commit": "executed", "time_travel": "bypass"}
    tables.update(ok=ok, qty=qty, src_q=src_q)
    return out


def memo_rows(ok, qty, src_q, which: int) -> list:
    live = np.array([src_q.get(o, 10 ** 9) < 3000 for o in ok.tolist()], bool)
    q = qty[live]
    if which == 0:
        return [(len(q), dec(exact_sum(q), 2))]
    return [(dec(int(q.min()), 2), dec(int(q.max()), 2), len(q))]


def cache_memo(runner, log, spool: str, tables: dict) -> dict:
    """CACHE_MEMO's first join (a miss that adopts both leaves' spooled
    outputs), then the second statement over the same leaves: the memo seeds
    them, no scan runs; then a write, and the memo misses."""
    coord = runner.coordinator
    coord.session.set("retry_policy", "TASK")
    coord.session.set("exchange_spool_dir", spool)
    coord.session.set("join_distribution_type", "PARTITIONED")
    # admission never opens: reuse can only come from the memo
    coord.session.set("result_cache_min_recurrences", "99")
    ok, qty, src_q = tables["ok"], tables["qty"], tables["src_q"]
    tables = ("big_qty", "cache_src")
    try:
        s0 = log.scan_total(*tables)
        first = cache_run(runner, CACHE_MEMO[0], "memo first join")
        n_first = cache_executed(log, first, "memo first join")
        rows_match(first[0], memo_rows(ok, qty, src_q, 0), "caches memo first join vs numpy")
        if first[1].get("memo_misses", 0) < 2 or len(coord.fragment_memo) < 2:
            fail(f"caches memo first join: {first[1].get('memo_misses')} misses, "
                 f"{len(coord.fragment_memo)} entries (both leaves memoizable)")
        s1 = log.scan_total(*tables)
        second = cache_run(runner, CACHE_MEMO[1], "memo second join")
        n_second = len(log.of(second[1]["sm"].query_id))
        rows_match(second[0], memo_rows(ok, qty, src_q, 1), "caches memo second join vs numpy")
        s2 = log.scan_total(*tables)
        if second[1].get("memo_hits", 0) < 2 or s2 != s1 or n_second >= n_first:
            fail(f"caches memo second join: {second[1].get('memo_hits')} memo hits, "
                 f"{s2 - s1} scans, {n_second} tasks against {n_first}")
        cut = int(max(src_q) * 0.1)
        runner.query(CACHE_MEMO_WRITE.format(k=cut))
        src_q = {k: v for k, v in src_q.items() if k >= cut}
        after = cache_run(runner, CACHE_MEMO[0], "memo join after a write")
        rows_match(after[0], memo_rows(ok, qty, src_q, 0), "caches memo after a write vs numpy")
        s3 = log.scan_total(*tables)
        if after[1].get("memo_hits") or s3 == s2:
            fail(f"caches memo after a write: {after[1].get('memo_hits')} memo hits, "
                 f"{s3 - s2} scans")
    finally:
        for k, v in (("retry_policy", "NONE"), ("join_distribution_type", "AUTOMATIC"),
                     ("result_cache_min_recurrences", "0")):
            coord.session.set(k, v)
    return {"first_ms": first[2], "second_ms": second[2], "after_write_ms": after[2],
            "tasks": [n_first, n_second], "scans": [s1 - s0, s2 - s1, s3 - s2],
            "memo_hits_second": second[1].get("memo_hits", 0),
            "memo_misses_after_write": after[1].get("memo_misses", 0)}


def cache_dedup(runner, log, sql: str, want, ordered, executed_tasks: int) -> dict:
    """Two identical Q18 statements, the first held at the workers' fault hook
    (TaskGate) until the second waits on it as a follower: one execution by
    task count, one cached record, equal rows."""
    coord = runner.coordinator
    cache = coord.result_cache
    cache.clear()
    followers = []
    plain = cache.begin

    def begin(key):
        leader, fl = plain(key)
        if not leader:
            followers.append(key)
        return leader, fl

    gate = TaskGate()
    gate.attach(runner.workers)
    cache.begin = begin
    try:
        gate.arm(lambda t: True)
        q1 = coord.submit_query(sql)
        wait_for(lambda: gate.held, "dedup: the leader's tasks never reached the gate",
                 phase="caches")
        q2 = coord.submit_query(sql)
        wait_for(lambda: followers, "dedup: the second statement never followed",
                 phase="caches")
    finally:
        gate.release()
        gate.detach(runner.workers)
        cache.begin = plain
    for qid in (q1, q2):
        if not coord.queries[qid]["done"].wait(timeout=600):
            fail("caches dedup: a statement never finished")
    r1, r2 = coord.queries[q1], coord.queries[q2]
    for r in (r1, r2):
        if r["sm"].state != "FINISHED":
            fail(f"caches dedup: {r['sm'].state}: {r['sm'].error}")
        rows_agree([tuple(x) for x in r["result"]], want, "q18", "caches dedup q18 vs tpch",
                   ordered)
    t1, t2 = log.of(q1), log.of(q2)
    cached = [bool(r1.get("cached")), bool(r2.get("cached"))]
    if t2 or len(t1) != executed_tasks or cached != [False, True]:
        fail(f"caches dedup: tasks {len(t1)} + {len(t2)} (one execution has "
             f"{executed_tasks}), cached {cached}")
    return {"tasks": [len(t1), len(t2)], "cached": cached, "held": len(gate.held)}


def cache_protocol(runner, engine) -> dict:
    """PREPARE of the Q6 shape through StatementClient and EXECUTE with 20
    seeded bindings, each against Engine.query with the literals (a binding
    that hits the plan cache adds no NVRTC compile and no learned-capacity
    entry); a header-only client; DEALLOCATE; the DB-API driver binding a
    quote-bearing parameter; the EXPLAIN ANALYZE EXECUTE footer."""
    from trino_tpu_torch.client import StatementClient
    from trino_tpu_torch.client.dbapi import connect
    from trino_tpu_torch.ops.cuda import fused_codegen

    coord = runner.coordinator
    sql = FASTPATH["q6_shape"]
    c = StatementClient(coord.url)
    c.execute(f"prepare cache_q6 from {sql}")
    if c.prepared.get("cache_q6") != sql:
        fail(f"caches protocol: PREPARE echoed {c.prepared} into the client")
    surface = coord._stmt_surface

    def learned():
        return len(surface.executor._learned_caps) + sum(
            len(w.scan_cache.learned_caps) for w in runner.workers)

    rng = np.random.default_rng(FASTPATH_SEED)
    laps, plan_cache, first = [], [], None
    for i in range(FASTPATH_BINDINGS):
        args = fastpath_binding("q6_shape", rng)
        c0, k0 = len(fused_codegen._COMPILES), learned()
        t0 = time.perf_counter()
        _cols, got = c.execute(f"execute cache_q6 using {', '.join(args)}")
        laps.append((time.perf_counter() - t0) * 1e3)
        info = surface.fastpath().last_info
        plan_cache.append(info.cache)
        if info.cache == "hit" and (len(fused_codegen._COMPILES) > c0 or learned() > k0):
            fail(f"caches protocol binding {i}: a plan-cache hit added "
                 f"{len(fused_codegen._COMPILES) - c0} NVRTC compiles and "
                 f"{learned() - k0} learned-capacity entries")
        want = engine.query(with_literals(sql, args))
        rows_match(protocol_rows(got, want, "caches protocol"), want,
                   f"caches protocol binding {i} ({args}) vs Engine.query")
        if first is None:
            first = (args, got)
    if plan_cache.count("hit") < FASTPATH_BINDINGS - 1:
        fail(f"caches protocol: plan cache {plan_cache}")
    c2 = StatementClient(coord.url)  # only the header registry: no server session
    c2.prepared["cache_q6"] = sql
    _cols, got = c2.execute(f"execute cache_q6 using {', '.join(first[0])}")
    if got != first[1]:
        fail(f"caches protocol: the header-only client got {got}, not {first[1]}")
    c.execute("deallocate prepare cache_q6")
    if "cache_q6" in c.prepared:
        fail("caches protocol: DEALLOCATE left cache_q6 in the client's registry")
    with connect(coord.url) as conn:
        cur = conn.cursor()
        cur.execute("select count(*) from nation where n_name = ?", ("x' or '1'='1",))
        quoted = cur.fetchone()
        cur.execute("select count(*) from nation where n_name = ?", ("FRANCE",))
        france = cur.fetchone()
        bound = [k for k in conn._client.prepared if k.startswith("dbapi_")]
    if quoted != (0,) or france != (1,) or not bound:
        fail(f"caches protocol dbapi: {quoted}, {france}, registry {bound}")
    c.prepared["cache_ef"] = "select count(*) from nation where n_regionkey = ?"
    c.execute("execute cache_ef using 1")
    _cols, rows = c.execute("explain analyze execute cache_ef using 1")
    text = "\n".join(r[0] for r in rows)
    if "-- fastpath:" not in text or "plan_cache=hit" not in text:
        fail(f"caches protocol: EXPLAIN ANALYZE EXECUTE footer: {text[-400:]}")
    return {"bindings": FASTPATH_BINDINGS, "execute_first_ms": laps[0],
            "execute_warm_ms": statistics.median(laps[1:]),
            "plan_cache_hits": plan_cache.count("hit"), "dbapi": [quoted, france],
            "footer": [ln for ln in text.splitlines() if ln.startswith("-- fastpath:")]}


def cache_restart(runner, log) -> dict:
    """A cached count; the coordinator killed; the table changed while it is
    down; the restarted coordinator comes up cold and answers the new count."""
    conn = runner.catalogs.get("memory")
    run = cache_run(runner, CACHE_COUNT, "count before the restart")
    cache_executed(log, run, "count before the restart")
    state = card_state()
    hit = cache_run(runner, CACHE_COUNT, "count hit before the restart")
    cache_hit(log, hit, state, "count hit before the restart")
    n = run[0][0][0]
    port = runner.kill_coordinator()
    wait_port_free(port)
    top = 10 ** 9
    conn.insert("big_qty", {"l_orderkey": np.array([top, top + 1], np.int64),
                            "l_quantity": np.array([4600, 4700], np.int64)})
    coord = runner.restart_coordinator(port=port, session=runner.session_props)
    if coord.result_cache.stats()["entries"]:
        fail("caches restart: the restarted coordinator's cache is not empty")
    after = cache_run(runner, CACHE_COUNT, "count after the restart")
    cache_executed(log, after, "count after the restart")
    if after[0] != [(n + 2,)]:
        fail(f"caches restart: {after[0]} != [({n + 2},)] (stale: {n})")
    return {"count_before": n, "count_after": n + 2, "cached_after": False}


def cache_cross_check() -> dict:
    """The result-cache test file's statement sequence at SF 0.01 (its memory
    table `t` and TPC-H): a card cluster against a CPU cluster, rows and
    dispositions step by step."""
    from trino_tpu_torch.connectors.tpch import TpchConnector

    mod = nested_test_module(CACHE_TEST_FILE)
    runners = []
    try:
        for device in (torch.device("cuda", 0), "cpu"):
            r = mod.start_cluster(mod.make_table(), device=device)
            r.register_catalog("tpch", TpchConnector(CACHE_CROSS_SCALE))
            runners.append(r)
        steps = []
        for i, sql in enumerate(mod.CROSS_STEPS):
            got = [cache_run(r, sql, f"SF {CACHE_CROSS_SCALE} step {i}") for r in runners]
            (g, gr, _), (h, hr, _) = got
            rows_match(g, h, f"caches SF {CACHE_CROSS_SCALE} step {i} ({sql}): cuda vs cpu")
            if bool(gr.get("cached")) != bool(hr.get("cached")):
                fail(f"caches SF {CACHE_CROSS_SCALE} step {i} ({sql}): cached "
                     f"{gr.get('cached')} on the card, {hr.get('cached')} on the CPU")
            steps.append(bool(gr.get("cached")))
        return {"statements": len(steps), "cached": sum(steps)}
    finally:
        for r in runners:
            r.stop()


def caches_phase(engine, scale, tpch_rows):
    """The coordinator's result cache, the fragment memo and prepared
    statements over the protocol on the card at TPC-H `scale`, three workers
    on one card with the result cache ON: hits (Q1, Q3, Q6, Q18, TOPN: the
    hit schedules no task, launches no kernel, allocates nothing on the
    card), admission by recurrences, invalidation by DELETE / UPDATE /
    INSERT / MERGE and by an external Iceberg commit, time travel bypassing,
    the fragment memo, in-flight dedup, a cold restart, the protocol's
    prepared statements; then the test file's sequence at SF 0.01, card
    cluster against CPU cluster.  Returns (the path's launch counts, phase
    seconds)."""
    import shutil
    import tempfile

    from trino_tpu_torch.connectors.iceberg import IcebergConnector
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.connectors.tpch import TpchConnector, tpch_data
    from trino_tpu_torch.ops import kernels
    from trino_tpu_torch.runtime.session import PROPERTIES
    from trino_tpu_torch.testing import DistributedQueryRunner

    t_phase = time.perf_counter()
    queries, ordered = tpch_queries()
    ordered = dict(ordered, topn=True)
    want = dict(tpch_rows, topn=engine.query(TOPN))
    li = tpch_data("lineitem", scale)
    engine.executor.drop_scans()
    gc.collect()
    torch.cuda.empty_cache()
    kernels.set_policy(kernels.KernelPolicy())
    tmp = tempfile.mkdtemp(prefix="chip_smoke_caches_")
    dev0 = torch.device("cuda", 0)
    log = TaskLog()
    log.install()
    runner = None
    reset_kernel_counts()  # every count to 0 just before the path, read just after
    try:
        iceberg = IcebergConnector(os.path.join(tmp, "warehouse"))
        runner = DistributedQueryRunner(num_workers=CLUSTER_WORKERS,
                                        devices=[dev0] * CLUSTER_WORKERS,
                                        journal_path=os.path.join(tmp, "journal.jsonl"))
        runner.register_catalog("tpch", TpchConnector(scale))
        runner.register_catalog("memory", MemoryConnector())
        runner.register_catalog("iceberg", iceberg)
        runner.start()
        # the result cache is on (the session's default); every stored
        # statement is admitted at once except in the admission step
        runner.session_props = {"result_cache_min_recurrences": "0"}
        runner.coordinator.session.set("result_cache_min_recurrences", "0")
        if not runner.coordinator.session.get("result_cache_enabled"):
            fail("caches: the result cache is not on by default")

        def step(name, fn):
            t0 = time.perf_counter()
            got = fn()
            emit({"phase": "caches", "step": name, "correct": True, **got,
                  "seconds": round(time.perf_counter() - t0, 3)})

        executed = {}

        def hits():
            got, tasks = cache_hits(runner, log, queries, want, ordered)
            executed.update(tasks)
            return {"statements": got}

        def admission():
            coord = runner.coordinator
            coord.session.set("result_cache_min_recurrences",
                              str(PROPERTIES["result_cache_min_recurrences"].default))
            try:
                return cache_admission(runner, log, engine)
            finally:
                coord.session.set("result_cache_min_recurrences", "0")

        step("hits", hits)
        step("admission", admission)
        tables: dict = {}  # the numpy copies of the memory tables
        step("invalidation", lambda: cache_invalidation(runner, log, li, iceberg, tables))
        step("memo", lambda: cache_memo(runner, log, os.path.join(tmp, "spool"), tables))
        step("dedup", lambda: cache_dedup(runner, log, queries["q18"], want["q18"], ordered,
                                          executed["q18"]))
        step("protocol", lambda: cache_protocol(runner, engine))
        step("restart", lambda: cache_restart(runner, log))
        counts = kernel_counts()
    finally:
        log.uninstall()
        if runner is not None:
            runner.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    for k in KERNEL_NAMES:
        if counts[k] < 1:
            fail(f"caches path never launched {k}: {counts}")
    del runner
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cross = cache_cross_check()
    emit({"phase": "caches", "step": "cross_scale", "scale": CACHE_CROSS_SCALE, "correct": True,
          **cross, "seconds": round(time.perf_counter() - t0, 3)})
    gc.collect()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    emit({"phase": "caches", "step": "summary", "scale": scale, "seconds": round(seconds, 1),
          "launches": counts})
    return counts, seconds


def sass_report() -> dict:
    """Atomic and local-memory instructions in the SASS of kernel 1 (both
    routes), of kernels 3 and 4 (one instantiation per key width W, with
    their 64- and 128-bit vector loads), of kernel 5 (each pass and the
    candidate pass, with every load) and of every generated kernel 2 of this
    run, from cuobjdump."""
    import re
    import shutil

    from trino_tpu_torch.ops.cuda import build, fused_codegen

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {"cuobjdump": None}
    op = re.compile(r"\b((?:ATOMS|ATOMG|ATOM|RED|REDG|LDL|STL|LDG)(?:\.[A-Z0-9_]+)*)")

    def count(path, want) -> dict:
        text = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                              timeout=300).stdout
        out = {}
        for block in text.split("Function : ")[1:]:
            name = block.split(None, 1)[0]
            label = want(name)
            if label is None:
                continue
            ops = {}
            for m in op.finditer(block):
                # of the loads, only the vector ones (.64 / .128) are listed,
                # except in kernel 5, whose every load is listed
                if (m.group(1).startswith("LDG") and not label.startswith("radix_select")
                        and not re.search(r"\.(64|128)\b", m.group(1))):
                    continue
                ops[m.group(1)] = ops.get(m.group(1), 0) + 1
            out[label] = ops
        return out

    def label(nm):
        if "radix_pass_kernel" in nm:
            p = re.search(r"radix_pass_kernelILi(\d)E", nm)
            return f"radix_select/pass{int(p.group(1)) + 1 if p else '?'}"
        if "radix_rows_kernel" in nm:
            return "radix_select/candidates"
        if "segreduce_kernel" in nm:
            return "segment_reduce/shared" if "ILb1E" in nm else "segment_reduce/global"
        for kernel, name in (("hash_build_kernel", "hash_build"),
                             ("hash_probe_kernel", "hash_probe")):
            if kernel in nm:
                w = re.search(r"ILi(\d)E", nm)
                return f"{name}/W{w.group(1) if w else '?'}"
        return None

    rep = count(build.LIB_PATH, label)
    from trino_tpu_torch.utils import compilecache

    for cubin in sorted(compilecache.ROOT.rglob("*.cubin")):
        rep.update(count(cubin, lambda nm: f"fused_pipeline/{nm}"))
    hash_rows = {k: v for k, v in rep.items() if k.startswith(("hash_build/", "hash_probe/"))}
    rep["hash_kernels_local_memory"] = sum(
        n for ops in hash_rows.values() for o, n in ops.items() if o.startswith(("LDL", "STL")))
    rep["radix_kernels_local_memory"] = sum(
        n for k, ops in rep.items() if k.startswith("radix_select/")
        for o, n in ops.items() if o.startswith(("LDL", "STL")))
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--rows", type=int, default=64 * 1024 * 1024)
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false); "
              "this script drives the port on an NVIDIA GPU", file=sys.stderr)
        return 2

    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.ops.cuda import build, fused_codegen, nvrtc
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

    # learned capacities stay in memory in every phase but `resilience`,
    # which points the capacity cache at a temporary file of its own
    os.environ["TRINO_TPU_TORCH_CAPS_CACHE"] = "off"
    build.load_library(verbose=args.ptxas)
    info = build.last_build()
    if args.ptxas:
        print(info.get("log", ""), file=sys.stderr)
    fused_codegen.clear_cache()  # kernel 2's first compile below is a cold one
    emit({"phase": "build", "seconds": round(info["seconds"], 3), "cached": info["cached"],
          "library": "trino_tpu_torch/build/libtrino_kernels.so",
          "kernel_2": f"generated per recipe, NVRTC {nvrtc.nvrtc_version()}, cached in "
                      "trino_tpu_torch/build/nvrtc/"})

    engine = Engine(device="cuda")
    engine.register_catalog("tpch", TpchConnector(args.scale))
    cpu_engine = Engine(device="cpu")
    cpu_engine.register_catalog("tpch", TpchConnector(args.scale))

    rows = kernels_phase(engine, dev, args.rows)
    for r in rows:
        r["card"] = smi_line
    torch.cuda.empty_cache()
    counts = main_path_phase(engine, cpu_engine, args.scale)
    tpch_counts, tpch_rows = tpch_phase(engine, cpu_engine, args.scale)
    del cpu_engine
    torch.cuda.empty_cache()
    t_tpcds = time.perf_counter()
    tpcds_counts, tpcds_path_s = tpcds_phase(engine, args.scale)
    tpcds_s = time.perf_counter() - t_tpcds
    statements_counts, statements_s = statements_phase(engine, args.scale)
    nested_counts, nested_s = nested_phase(engine, args.scale)
    spill_counts, spill_s = spill_phase(engine, args.scale)
    fastpath_counts, fastpath_s = fastpath_phase(engine, args.scale)
    lake_counts, lake_s = lake_phase(engine, args.scale, tpch_rows)
    dist_counts, dist_s = distributed_phase(engine, args.scale, tpch_rows)
    cluster_counts, cluster_s = cluster_phase(engine, args.scale, tpch_rows)
    # read before `resilience`, whose compile-plane drills clear the cubin cache
    sass = sass_report()
    resilience_counts, resilience_s = resilience_phase(engine, args.scale, tpch_rows)
    governance_counts, governance_s = governance_phase(engine, args.scale, tpch_rows)
    caches_counts, caches_s = caches_phase(engine, args.scale, tpch_rows)
    for r in rows:
        by_path = {"main_path": counts[r["name"]], "tpch": tpch_counts[r["name"]],
                   "tpcds": tpcds_counts[r["name"]], "statements": statements_counts[r["name"]],
                   "nested": nested_counts[r["name"]], "spill": spill_counts[r["name"]],
                   "fastpath": fastpath_counts[r["name"]], "lake": lake_counts[r["name"]],
                   "distributed": dist_counts[r["name"]], "cluster": cluster_counts[r["name"]],
                   "resilience": resilience_counts[r["name"]],
                   "governance": governance_counts[r["name"]],
                   "caches": caches_counts[r["name"]]}
        r["launches"] = sum(by_path.values())
        r["launches_by_path"] = by_path
        if r["launches"] < 1:
            fail(f"kernel {r['name']} was never launched on the main path")

    emit({"phase": "sass", "card": smi_line, "atomics_and_local_memory": sass})
    emit({"phase": "timing", "seconds": round(time.perf_counter() - t_start, 1),
          "tpcds_seconds": round(tpcds_s, 1), "tpcds_path_seconds": round(tpcds_path_s, 1),
          "statements_seconds": round(statements_s, 1), "nested_seconds": round(nested_s, 1),
          "spill_seconds": round(spill_s, 1), "fastpath_seconds": round(fastpath_s, 1),
          "lake_seconds": round(lake_s, 1), "distributed_seconds": round(dist_s, 1),
          "cluster_seconds": round(cluster_s, 1), "resilience_seconds": round(resilience_s, 1),
          "governance_seconds": round(governance_s, 1), "caches_seconds": round(caches_s, 1)})
    print(smi_line, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
