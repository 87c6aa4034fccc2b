#!/usr/bin/env python3
"""Warm wall time of every TPC-DS statement at SF 1 (and TPC-H Q1) through
`Engine.query` on the card, for a checkout of the port; with `--execute`,
of prepared statements' EXECUTEs instead.

    python3 trino_tpu_torch/tools/time_statements.py [--package-root DIR]
        [--label NAME] [--scale F] [--execute]

`trino_tpu_torch` is imported from DIR (default: the checkout holding this
file); the statements, the ones left out (chip_smoke.py's TPCDS_SKIPPED:
too large for the card at SF 1) and Q1 come from this checkout's
chip_smoke.py, so two checkouts run the same SQL.  Each statement runs once
cold, then 3 times; its `warm_ms` is the median of the 3, synchronized.
One JSON line: the label, the package root, the card's name and power
limit, the seconds taken, the median over statements of `warm_ms`, and
`warm_ms` per statement.  To compare two checkouts, run both in one
machine, in turns (old, new, new, old): two calls may land on two cards.
Needs a CUDA card; exits 2 without one.

`--execute` prepares chip_smoke.py's FASTPATH templates on TPC-H and runs
the same 20 seeded bindings of each (chip_smoke's FASTPATH_SEED) through
`EXECUTE`, however the checkout serves it.  Per template: `execute_ms`, the
median of bindings 2..20 (binding 1 plans); `plan_run_ms`, the median over
the bindings of a warm run of the literal statement's plan, made before the
clock starts (the work with no parse and no planning); the kernel launches
and NVRTC compiles of the 20 EXECUTEs.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path


def _chip_smoke():
    """chip_smoke.py of the checkout holding this file."""
    path = Path(__file__).resolve().parents[2] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package-root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--label", default="")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--execute", action="store_true")
    args = ap.parse_args(argv)
    smoke = _chip_smoke()
    root = os.path.abspath(args.package_root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("time_statements: no CUDA device", file=sys.stderr)
        return 2
    import trino_tpu_torch
    from trino_tpu_torch.connectors.tpcds import TpcdsConnector
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.ops.cuda import build
    from trino_tpu_torch.runtime.engine import Engine

    if not os.path.abspath(trino_tpu_torch.__file__).startswith(root):
        print(f"time_statements: trino_tpu_torch came from {trino_tpu_torch.__file__}, "
              f"not {root}", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    build.load_library()
    card = smi.splitlines()[0] if smi else torch.cuda.get_device_name(0)
    if args.execute:
        return _time_execute(smoke, args, root, card)
    queries, _ = smoke.tpcds_queries()
    engine = Engine(device="cuda", default_catalog="tpcds")
    engine.register_catalog("tpcds", TpcdsConnector(args.scale))
    engine.register_catalog("tpch", TpchConnector(args.scale))
    statements = {n: q for n, q in queries.items() if n not in smoke.TPCDS_SKIPPED}
    statements["tpch_q01"] = smoke.Q01.replace("from lineitem", "from tpch.lineitem")
    warm = {}
    t_all = time.perf_counter()
    for name, sql in sorted(statements.items()):
        engine.query(sql)
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.query(sql)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        warm[name] = statistics.median(walls)
    print(json.dumps({"label": args.label, "package": root, "card": card,
                      "seconds": time.perf_counter() - t_all,
                      "median_warm_ms": statistics.median(warm.values()), "warm_ms": warm}),
          flush=True)
    return 0


def _synced_ms(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _time_execute(smoke, args, root, card) -> int:
    import numpy as np

    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.ops.cuda import fused_codegen
    from trino_tpu_torch.runtime.engine import Engine

    engine = Engine(device="cuda")
    engine.register_catalog("tpch", TpchConnector(args.scale))
    engine.execute("set session data_plane_kernels = true")
    # a checkout without the memory budget runs a plan on its executor
    run_plan = getattr(engine, "_execute_planned", None) or engine.executor.execute
    rng = np.random.default_rng(smoke.FASTPATH_SEED)
    out = {}
    t_all = time.perf_counter()
    for name, sql in smoke.FASTPATH.items():
        engine.execute(f"prepare {name} from {sql}")
        bindings = [smoke.fastpath_binding(name, rng) for _ in range(smoke.FASTPATH_BINDINGS)]
        execute_ms, plan_run_ms, launches, compiles = [], [], {}, 0
        for args_ in bindings:
            plan = engine.plan(smoke.with_literals(sql, args_))
            run_plan(plan)
            plan_run_ms.append(_synced_ms(lambda: run_plan(plan).to_pylist()))
            before, c0 = smoke.kernel_counts(), len(fused_codegen._COMPILES)
            execute_ms.append(_synced_ms(
                lambda: engine.execute(f"execute {name} using {', '.join(args_)}")))
            after = smoke.kernel_counts()
            compiles += len(fused_codegen._COMPILES) - c0
            for k in after:
                launches[k] = launches.get(k, 0) + after[k] - before[k]
        out[name] = {"execute_ms": statistics.median(execute_ms[1:]),
                     "execute_first_ms": execute_ms[0],
                     "plan_run_ms": statistics.median(plan_run_ms),
                     "launches": launches, "nvrtc_compiles": compiles}
    print(json.dumps({"label": args.label, "package": root, "card": card, "mode": "execute",
                      "scale": args.scale, "seconds": time.perf_counter() - t_all,
                      "templates": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
