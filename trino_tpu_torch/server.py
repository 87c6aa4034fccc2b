"""Node launcher: `python -m trino_tpu_torch.server --etc DIR [--default-catalog C]`.

Boots a coordinator or worker from etc/ properties files (runtime/config.py)
— the reference's TrinoServer main (core/trino-server-main/TrinoServer.java:
23-27) with airlift bootstrap replaced by the properties loader.  A worker
node announces itself to `discovery.uri` and serves tasks; a coordinator
serves the client protocol (/v1/statement + nextUri) until interrupted.
Tasks (and the coordinator's root fragment) run on the CUDA card unless
config.properties sets `node.device=cpu`; a node without a card fails at
boot.  Kernel 2's NVRTC builds are cached on disk under
trino_tpu_torch/build/nvrtc/ by ops/cuda/fused_codegen.py itself, so there
is no compile cache to switch on here.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.request


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="trino_tpu_torch.server")
    ap.add_argument("--etc", required=True, help="etc/ directory with config.properties + catalog/")
    ap.add_argument("--default-catalog", default=None)
    args = ap.parse_args(argv)

    from .runtime.config import (
        apply_flightrecorder_config,
        apply_timeseries_config,
        load_catalogs,
        load_node_config,
    )
    cfg = load_node_config(args.etc)
    apply_flightrecorder_config(cfg)
    apply_timeseries_config(cfg)
    catalogs = load_catalogs(args.etc)
    names = catalogs.names()
    default_catalog = args.default_catalog or (names[0] if names else "memory")

    if cfg.coordinator and cfg.fleet_coordinators and not cfg.fleet_dir:
        # router role: fleet.coordinators WITHOUT fleet.dir is the front
        # door over already-running members — shard admission by query-id
        # hash, fail over on coordinator death, pass 429/503 through
        from .runtime.fleet import FleetRouter

        router = FleetRouter(cfg.fleet_coordinators, port=cfg.port).start()
        print(
            f"fleet router listening on {router.url} -> "
            f"{', '.join(cfg.fleet_coordinators)}",
            flush=True,
        )
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            router.stop()
        return 0

    if cfg.coordinator:
        from .runtime.coordinator import Coordinator

        coord = Coordinator(
            catalogs,
            default_catalog,
            port=cfg.port,
            cluster_memory_limit_bytes=cfg.cluster_memory_limit_bytes,
            journal_path=cfg.journal_path or None,
            # fleet membership: journal/history move into the shared dir
            # and the lease machinery arms (runtime/fleet.py)
            fleet_dir=cfg.fleet_dir or None,
            fleet_ttl_s=cfg.fleet_lease_ttl_s,
            coordinator_id=cfg.fleet_coordinator_id,
            device=cfg.device,
        )
        # session defaults are applied BEFORE start(): journal recovery
        # (the resume thread) reads resume_policy / spool dir at takeover
        if cfg.query_max_memory_bytes:
            coord.session.set("query_max_memory_bytes", str(cfg.query_max_memory_bytes))
        if cfg.exchange_spool_dir:
            coord.session.set("exchange_spool_dir", cfg.exchange_spool_dir)
        if cfg.retry_policy != "NONE":
            coord.session.set("retry_policy", cfg.retry_policy)
        if cfg.resume_policy:
            coord.session.set("resume_policy", cfg.resume_policy)
        coord.start()
        print(f"coordinator listening on {coord.url}", flush=True)
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            coord.stop()
        return 0

    from .runtime.worker import Worker

    worker = Worker(
        catalogs, default_catalog, port=cfg.port,
        task_concurrency=cfg.task_concurrency,
        node_memory_bytes=cfg.node_memory_bytes,
        disk_budget_bytes=cfg.disk_budget_bytes or None,
        disk_blocked_timeout_s=cfg.disk_blocked_timeout_s,
        device=cfg.device,
    ).start()
    print(f"worker listening on {worker.url}", flush=True)
    # fleet-aware discovery: announce to EVERY coordinator in
    # fleet.coordinators (or TRINO_TPU_COORDINATORS, already parsed by the
    # Worker itself), falling back to the single discovery.uri — any fleet
    # member can then dispatch to this worker, and an adopter needs no
    # re-announce round-trip before resuming a dead peer's query
    coords = cfg.fleet_coordinators or worker.coordinator_urls
    if not coords and cfg.discovery_uri:
        coords = [cfg.discovery_uri]
    if coords:
        worker.coordinator_urls = [u.rstrip("/") for u in coords]
        for base in worker.coordinator_urls:
            try:
                req = urllib.request.Request(
                    f"{base}/v1/announce",
                    data=json.dumps({"url": worker.url}).encode(),
                )
                urllib.request.urlopen(req, timeout=10).read()
                print(f"announced to {base}", flush=True)
            except OSError as e:
                # a dead member re-learns us from the periodic announce
                print(f"announce to {base} failed ({e}); will retry", flush=True)

    # SIGTERM == graceful drain (reference: GracefulShutdownHandler bound
    # to the shutdown hook): finish running tasks, commit output, serve
    # remaining fetches, deregister — then exit.  kill -9 stays the hard
    # death the chaos harness exercises.
    import signal

    def _on_sigterm(signum, frame):
        print("SIGTERM: draining", flush=True)
        worker.request_drain()

    signal.signal(signal.SIGTERM, _on_sigterm)
    try:
        while worker.state != "drained":
            time.sleep(0.2)
        print("drained; exiting", flush=True)
        worker.kill()
    except KeyboardInterrupt:
        worker.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
