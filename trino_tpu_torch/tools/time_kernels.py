#!/usr/bin/env python3
"""Time kernels 1-5 of a checkout of the port at the shapes PERF.md tracks.

    python3 trino_tpu_torch/tools/time_kernels.py [--package-root DIR] [--rows N]
        [--iters K]

`trino_tpu_torch` is imported from DIR (default: the checkout holding this
file), and only through calls every version of the port has (`Engine.plan`,
`fused.plan_pipeline`, `fused.run`, `segreduce.fused_segment_reduce`,
`hashagg.build_hash_table`, `hashjoin.probe_hash_table`,
`topk.radix_topk_threshold`, `topk.sortable_u32`), so the same script times
an older checkout's kernels beside this one's.  Run the two in one
machine, in turns (old, new, new, old): two calls may land on two cards.
Shapes, all made on the card from a seed: at N rows (64 Mi by default),
kernel 2 on the fused recipes of TPC-H Q1 and Q6 and of Q1 grouped by four
keys (D = 168); kernel 1 on a 6-reduction GROUP BY over 6 groups and on the
20 reductions q01 sends through the operator path (16 decimal limb sums, 3
double sums, 1 count).  Where DIR's kernel 2 is generated per recipe, the
D = 168 recipe is also timed with its table forced past shared memory (the
global-atomics route) beside the route it takes.  Kernels 3 and 4 (build,
then probe of the table built) at two shapes: chip_smoke.py's timed shape
(N/8 rows drawing N/64 distinct 2-word keys at random, 2^24 slots at the
default N; probe rows half hits) and join #5 of TPC-H Q3 at SF 1 (6,002,367
lineitem rows, order keys in runs of 1-7, live an order at a time, ~827 K
distinct live keys, cap = rows, 2^24 slots; probed by the 1.5 M order keys,
half of them live).  Kernel 5 first, as the whole selection
`radix_topk_threshold(u, live, k)` at three shapes: chip_smoke.py's two timed
shapes (N int32-mapped prices, 90 % live, K = 10; N random u32 keys, 90 %
live, K = 4096) and the topn statement's (6,002,367 rows of
`lineitem_columns`' l_extendedprice mapped as top_n maps it, all live,
K = 10).  Each line: the kernel's median time over K launches
(CUDA events, chip_smoke.py's `time_ms`), the first call's time (with a
generated kernel's compile), the bytes bound on an H100 (chip_smoke.py's
rate), and the card's name and power limit.  Needs a CUDA card; exits 2
without one.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

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


# Q1 grouped by four dictionary keys: D = 3 x 2 x 7 x 4 = 168 groups, a table
# that still fits shared memory on kernel 2's warp route
Q01_D168 = """
select l_returnflag, l_linestatus, l_shipmode, l_shipinstruct,
  sum(l_quantity) as sum_qty, sum(l_extendedprice) as sum_base_price,
  sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
  sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
  avg(l_quantity) as avg_qty, avg(l_extendedprice) as avg_price,
  avg(l_discount) as avg_disc, count(*) as count_order
from lineitem
where l_shipdate <= date '1998-12-01' - interval '90' day
group by l_returnflag, l_linestatus, l_shipmode, l_shipinstruct
"""


def _chip_smoke():
    """chip_smoke.py of the checkout holding this file: its `time_ms` and
    `HBM_BYTES_PER_S` are the ones every timing of the port uses."""
    path = Path(__file__).resolve().parents[2] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def lineitem_columns(n: int, dev, seed: int = 20240601) -> dict:
    """Q1's and Q6's lineitem columns at n rows, in the engine's lanes
    (decimals as scaled int64, dates as int32 days, dictionary codes as
    int32), made on the card from a seed."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def ints(lo, hi, dtype):
        return torch.randint(lo, hi, (n,), generator=g, device=dev, dtype=dtype)

    return {
        "l_quantity": ints(100, 5001, torch.int64),
        "l_extendedprice": ints(90000, 10500000, torch.int64),
        "l_discount": ints(0, 11, torch.int64),
        "l_tax": ints(0, 9, torch.int64),
        "l_returnflag": ints(0, 3, torch.int32),
        "l_linestatus": ints(0, 2, torch.int32),
        "l_shipdate": ints(8036, 10562, torch.int32),
        "l_shipmode": ints(0, 7, torch.int32),
        "l_shipinstruct": ints(0, 4, torch.int32),
    }


def fused_inputs(engine, sql: str, by_name: dict):
    """(recipe, scan columns) of the fused fragment of `sql` over by_name."""
    import numpy as np

    from trino_tpu_torch.data.page import Dictionary
    from trino_tpu_torch.exec.compiler import fused_fragment
    from trino_tpu_torch.ops.cuda import fused
    from trino_tpu_torch.ops.expr import ColumnVal
    from trino_tpu_torch.plan.nodes import Aggregate, walk

    plan = engine.plan(sql)
    agg = next(nd for nd in walk(plan) if isinstance(nd, Aggregate))
    scan, filters, keys, args, _ = fused_fragment(agg)
    dicts = {
        "l_returnflag": Dictionary(np.asarray(["A", "N", "R"], dtype=object)),
        "l_linestatus": Dictionary(np.asarray(["F", "O"], dtype=object)),
        "l_shipmode": Dictionary(np.asarray(
            ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"], dtype=object)),
        "l_shipinstruct": Dictionary(np.asarray(
            ["COLLECT COD", "DELIVER IN PERSON", "NONE", "TAKE BACK RETURN"], dtype=object)),
    }
    cols = [
        ColumnVal(by_name[name], None, dicts.get(name), ty)
        for name, ty in zip(scan.column_names, scan.output_types)
    ]
    recipe, why = fused.plan_pipeline(
        cols, filters, keys, [a.fn for a in agg.aggs], args, [a.type for a in agg.aggs]
    )
    if recipe is None:
        raise SystemExit(f"time_kernels: the fused fragment was declined: {why}")
    return recipe, cols


def fused_bytes(recipe, cols) -> int:
    seen = {}
    for what, c, _ in recipe.table:
        t = cols[c].data if what == "data" else cols[c].valid
        seen[t.data_ptr()] = t.numel() * t.element_size()
    return sum(seen.values()) + len(recipe.streams) * 2 * recipe.domain * 8


def segreduce_shapes(by_name: dict) -> dict:
    """name -> (seg, reductions, G): the 6-reduction GROUP BY and q01's
    20-reduction operator-path call over the same rows."""
    import torch

    from trino_tpu_torch.data.dec128 import limbs32
    from trino_tpu_torch.ops.cuda.segreduce import SegRed

    seg = (by_name["l_returnflag"] * 2 + by_name["l_linestatus"]).to(torch.int32)
    live = by_name["l_shipdate"] <= 10471
    qty, price = by_name["l_quantity"], by_name["l_extendedprice"]
    disc, tax = by_name["l_discount"], by_name["l_tax"]
    six = [
        SegRed("count", None, live),
        SegRed("sum", qty, live),
        SegRed("sum", price, live),
        SegRed("sum", price.to(torch.float64) / 100.0, live),
        SegRed("min", by_name["l_shipdate"], live),
        SegRed("max", price, live),
    ]
    disc_price = price * (100 - disc)
    twenty = []
    for v in (qty, price, disc_price, disc_price * (100 + tax)):
        twenty += [SegRed("sum", limb, live) for limb in limbs32(v, v >> 63)]
    twenty += [SegRed("sum", v.to(torch.float64) / 100.0, live) for v in (qty, price, disc)]
    twenty.append(SegRed("count", None, live))
    return {"segment_reduce_6": (seg, six, 6), "segment_reduce_20": (seg, twenty, 6)}


def segreduce_bytes(seg, reds, G) -> int:
    seen = {seg.data_ptr(): seg.numel() * 4}
    for r in reds:
        for t in (r.values, r.valid):
            if t is not None:
                seen[t.data_ptr()] = t.numel() * t.element_size()
    return sum(seen.values()) + len(reds) * G * 8


def hash_shapes(smoke, dev, n_rows: int) -> dict:
    """name -> (build words, build live, cap, probe words, probe live)."""
    import torch

    words, live, cap, pwords = smoke.hash_timed_inputs(dev, n_rows // 8)
    shapes = {"timed": (words, live, cap, pwords, live)}
    n = 6_002_367
    words, live = smoke.keys_in_runs(dev, n, 2, 61, 0.551, orderkeys=True)
    orders = torch.unique(words[0])  # every order key once, ascending
    g = torch.Generator(device=dev)
    g.manual_seed(62)
    plive = torch.rand(orders.numel(), generator=g, device=dev) < 0.5
    shapes["join5"] = (words, live, n, [orders.contiguous(), torch.zeros_like(orders)], plive)
    return shapes


def radix_shapes(smoke, dev, n_rows: int) -> dict:
    """name -> (u, live, k) of kernel 5's three timed shapes."""
    import torch

    from trino_tpu_torch.ops.cuda import topk

    shapes = {kind: smoke.radix_timed_inputs(dev, n_rows, kind) for kind in ("prices", "random")}
    n = 6_002_367
    price = lineitem_columns(n, dev)["l_extendedprice"]
    # top_n's map of a descending int64 key whose values fit int32
    u = topk.sortable_u32(price, False, narrow=torch.tensor(True, device=dev))
    shapes["topn"] = (u, torch.ones(n, dtype=torch.bool, device=dev), 10)
    return shapes


def hash_bytes(smoke, words, live, table_slots: int) -> int:
    """The work of a build or probe as chip_smoke.py bounds it: the words and
    the live byte in, the id out, and past L2 one sector per distinct start
    slot the live rows touch."""
    import torch

    from trino_tpu_torch.ops.cuda import hashagg

    n, W = live.shape[0], len(words)
    stream = n * (4 * W + 1) + 4 * n
    touched = torch.unique(hashagg.hash_words(words, live)[live] & (table_slots - 1)).numel()
    past_l2 = table_slots * 4 * (1 + W) > smoke.L2_BYTES
    return stream + (smoke.SECTOR * touched if past_l2 else 0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package-root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--rows", type=int, default=64 * 1024 * 1024)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    smoke = _chip_smoke()
    sys.path.insert(0, os.path.abspath(args.package_root))
    import torch

    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 2
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.ops.cuda import fused, hashagg, hashjoin, topk
    from trino_tpu_torch.ops.cuda import segreduce as sr
    from trino_tpu_torch.runtime.engine import Engine

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0] if smi else torch.cuda.get_device_name(0)
    dev = torch.device("cuda")
    base = {"package": os.path.abspath(args.package_root), "card": card, "rows": args.rows}

    def emit(name, fn, n_bytes, **extra):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        first = (time.perf_counter() - t0) * 1e3
        ms = smoke.time_ms(fn, 2, args.iters)
        bound = n_bytes / smoke.HBM_BYTES_PER_S * 1e3
        print(json.dumps({**base, "shape": name, "ms": ms, "first_call_ms": first,
                          "bound_ms": bound, "share_of_bound": bound / ms, **extra}), flush=True)

    for shape, (u, live, k) in radix_shapes(smoke, dev, args.rows).items():
        n = u.shape[0]
        emit(f"radix_select_{shape}", lambda: topk.radix_topk_threshold(u, live, k),
             n * 5 + 256 * 8, rows=n, live_rows=int(live.sum()), k=k,
             threshold=int(topk.radix_topk_threshold(u, live, k)))
        del u, live
    torch.cuda.empty_cache()

    for shape, (words, live, cap, pwords, plive) in hash_shapes(smoke, dev, args.rows).items():
        T = hashagg.table_size(cap)
        extra = {"rows": live.shape[0], "live_rows": int(live.sum()), "words": len(words),
                 "table_slots": T}
        gid, table, n_groups, _ = hashagg.build_hash_table(words, live, cap, keep_keys=False)
        emit(f"hash_build_{shape}",
             lambda: hashagg.build_hash_table(words, live, cap, keep_keys=False),
             hash_bytes(smoke, words, live, T), groups=int(n_groups), **extra)
        extra.update(rows=plive.shape[0], live_rows=int(plive.sum()))
        emit(f"hash_probe_{shape}", lambda: hashjoin.probe_hash_table(pwords, plive, table),
             hash_bytes(smoke, pwords, plive, T),
             hits=int((hashjoin.probe_hash_table(pwords, plive, table)[0] >= 0).sum()),
             **extra)
        del gid, table
        torch.cuda.empty_cache()

    engine = Engine(device="cuda")
    engine.register_catalog("tpch", TpchConnector(0.01))
    by_name = lineitem_columns(args.rows, dev)

    try:
        from trino_tpu_torch.ops.cuda import fused_codegen as fc
    except ImportError:  # a checkout whose kernel 2 is not generated per recipe
        fc = None
    for qname, sql in (("fused_q1", Q01), ("fused_q6", Q06), ("fused_q1_d168", Q01_D168)):
        recipe, cols = fused_inputs(engine, sql, by_name)
        extra = {"streams": len(recipe.streams), "D": recipe.domain}
        if fc is not None:
            extra["accumulation"] = fc.route_for(recipe)[0]
        emit(qname, lambda: fused.run(recipe, cols, None), fused_bytes(recipe, cols), **extra)
        if fc is None or extra["accumulation"] != "warp":
            continue
        # the same recipe with no room for its table in shared memory
        saved = fc._WARP_TABLE_BYTES
        fc._WARP_TABLE_BYTES = 0
        fc.clear_cache()
        try:
            emit(f"{qname}_global", lambda: fused.run(recipe, cols, None),
                 fused_bytes(recipe, cols), **{**extra, "accumulation": fc.route_for(recipe)[0]})
        finally:
            fc._WARP_TABLE_BYTES = saved
            fc.clear_cache()
    for name, (seg, reds, G) in segreduce_shapes(by_name).items():
        emit(name, lambda: sr.fused_segment_reduce(seg, reds, G), segreduce_bytes(seg, reds, G),
             reductions=len(reds), groups=G)
    return 0


if __name__ == "__main__":
    sys.exit(main())
