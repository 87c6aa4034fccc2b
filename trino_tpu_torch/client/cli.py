"""Interactive SQL console (reference: client/trino-cli Trino.java:50,
Console.java:87 — jline3 console; here a stdlib REPL).

Usage:  python -m trino_tpu_torch.client.cli --server http://host:port
        python -m trino_tpu_torch.client.cli --local [--scale 0.01] [--device cpu]
        (in-process engine; the CUDA card unless --device says otherwise)
"""

from __future__ import annotations

import argparse
import sys


def _print_table(columns, rows) -> None:
    if not rows:
        print("(0 rows)")
        return
    cols = columns or [f"c{i}" for i in range(len(rows[0]))]
    widths = [len(str(c)) for c in cols]
    srows = [[("NULL" if v is None else str(v)) for v in r] for r in rows]
    for r in srows:
        for i, v in enumerate(r):
            widths[i] = max(widths[i], len(v))
    line = " | ".join(str(c).ljust(w) for c, w in zip(cols, widths))
    print(line)
    print("-" * len(line))
    for r in srows:
        print(" | ".join(v.ljust(w) for v, w in zip(r, widths)))
    print(f"({len(rows)} rows)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="trino-tpu")
    ap.add_argument("--server", help="coordinator URL (http://host:port)")
    ap.add_argument("--local", action="store_true", help="in-process engine")
    ap.add_argument("--scale", type=float, default=0.01, help="tpch scale for --local")
    ap.add_argument("--device", default="cuda", help="device of the --local engine")
    ap.add_argument("--execute", "-e", help="run one statement and exit")
    args = ap.parse_args(argv)

    if args.local or not args.server:
        from ..connectors.memory import MemoryConnector
        from ..connectors.tpch import TpchConnector
        from ..runtime.engine import Engine

        eng = Engine(device=args.device)
        eng.register_catalog("tpch", TpchConnector(args.scale))
        eng.register_catalog("memory", MemoryConnector())

        def run(sql: str):
            rows = eng.execute(sql)
            _print_table(None, rows)

    else:
        from .client import StatementClient

        client = StatementClient(args.server)

        def run(sql: str):
            columns, rows = client.execute(sql)
            _print_table(columns, rows)

    if args.execute:
        run(args.execute)
        return 0

    print("trino-tpu console — end statements with ';', \\q to quit")
    buf = []
    while True:
        try:
            prompt = "trino-tpu> " if not buf else "        -> "
            line = input(prompt)
        except EOFError:
            break
        if line.strip() in ("\\q", "quit", "exit"):
            break
        buf.append(line)
        if line.rstrip().endswith(";"):
            sql = "\n".join(buf).rstrip().rstrip(";")
            buf = []
            try:
                run(sql)
            except Exception as e:
                print(f"error: {e}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
