"""Config-file deployment surface (etc/ properties files).

The reference boots from `etc/config.properties` (396 @Config setters bound
by airlift bootstrap), catalogs from `etc/catalog/*.properties`
(connector.name=... picks the plugin), and per-query overrides ride session
properties.  Same shape here:

    etc/
      config.properties          node role + ports + limits
      catalog/
        tpch.properties          connector.name=tpch\ntpch.scale=0.01
        lake.properties          connector.name=parquet\nparquet.root=/data

Recognized config.properties keys:
    coordinator=true|false          node role (default true)
    http-server.http.port=8080      listen port (0 = ephemeral)
    discovery.uri=http://host:port  coordinator URL a worker announces to
    query.max-memory-per-node=...   bytes; becomes query_max_memory_bytes
    memory.heap-headroom-per-node   bytes; cluster_memory_limit_bytes
    exchange.spool-dir=/path        durable spooled exchange directory
    spool.disk-budget-bytes=...     per-node disk budget for spool + spill
                                    writes (runtime/disk.py; 0 = ungoverned)
    spool.disk-blocked-timeout-s=10 blocked-on-disk park time before the
                                    typed EXCEEDED_SPILL_LIMIT shed
    retry-policy=NONE|QUERY|TASK    default retry policy
    task.concurrency=4              worker executor pool width
    query.journal-path=/path        durable query journal (crash recovery)
    query.resume-policy=RESUME|FAIL|RESTART
                                    what a restarted coordinator does with
                                    journaled in-flight queries
    fleet.dir=/path                 shared coordinator-fleet directory
                                    (leases + per-member journals + history)
    fleet.coordinators=u1,u2        fleet member URLs; a coordinator role
                                    starts the FleetRouter front door over
                                    them, a worker role announces to all
    fleet.lease-ttl-s=10            seconds before an unrenewed lease
                                    expires and peers adopt its queries
    fleet.coordinator-id=c1         stable member id (defaults to random)
    flightrecorder.enabled=true     process-global flight recorder
                                    (utils/flightrecorder.py): bounded ring
                                    of structured runtime events served at
                                    GET /v1/flightrecorder on every node
    flightrecorder.ring-size=4096   events held in the ring; overflow drops
                                    the oldest (counted in
                                    trino_tpu_flightrecorder_dropped_total)
    timeseries.enabled=true         per-node utilization sampler + ring TSDB
                                    (utils/timeseries.py) served at
                                    GET /v1/timeseries on every node and
                                    federated by the coordinator
    timeseries.ring-size=512        points held per (node, series) lane;
                                    overflow drops the oldest (counted in
                                    trino_tpu_timeseries_points_dropped_total)
    timeseries.sample-interval-s=1  seconds between sampler ticks
    node.device=cuda                where the node's tasks run: cuda (the
                                    card, the default; a node without one
                                    fails at boot), cuda:N, or cpu

Connector factories (connector.name=):
    tpch (tpch.scale=), tpcds (tpcds.scale=), memory, blackhole,
    parquet (parquet.root=), orc (orc.root=), iceberg (iceberg.root=),
    faker (faker.rows= faker.schema= as JSON)

A copy of the JAX package's module, plus `node.device`.  `python -m
trino_tpu_torch.server --etc DIR` boots a coordinator or a worker over these
files; `load_catalogs` builds the port's connectors.
"""

from __future__ import annotations

import os
from typing import Optional

__all__ = [
    "load_properties",
    "load_catalogs",
    "NodeConfig",
    "load_node_config",
    "apply_flightrecorder_config",
    "apply_timeseries_config",
]


def load_properties(path: str) -> dict[str, str]:
    """Java-style .properties: key=value lines, # comments, trimmed."""
    out: dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            k, _, v = line.partition("=")
            out[k.strip()] = v.strip()
    return out


def _make_connector(props: dict[str, str]):
    name = props.get("connector.name")
    if name == "tpch":
        from ..connectors.tpch import TpchConnector

        return TpchConnector(float(props.get("tpch.scale", "0.01")))
    if name == "tpcds":
        from ..connectors.tpcds import TpcdsConnector

        return TpcdsConnector(float(props.get("tpcds.scale", "0.002")))
    if name == "memory":
        from ..connectors.memory import MemoryConnector

        return MemoryConnector()
    if name == "blackhole":
        from ..connectors.memory import BlackholeConnector

        return BlackholeConnector()
    if name == "parquet":
        from ..connectors.parquet import ParquetConnector

        return ParquetConnector(props["parquet.root"])
    if name == "orc":
        from ..connectors.orc import OrcConnector

        return OrcConnector(props["orc.root"])
    if name == "iceberg":
        from ..connectors.iceberg import IcebergConnector

        return IcebergConnector(props["iceberg.root"])
    if name == "faker":
        from ..connectors.faker import FakerConnector

        return FakerConnector(int(props.get("faker.rows", "1000")))
    raise ValueError(f"unknown connector.name: {name!r}")


def load_catalogs(etc_dir: str):
    """etc/catalog/*.properties -> CatalogManager (reference: catalog
    properties loaded by CatalogManager at boot)."""
    from ..connectors.spi import CatalogManager

    catalogs = CatalogManager()
    cat_dir = os.path.join(etc_dir, "catalog")
    if os.path.isdir(cat_dir):
        for fname in sorted(os.listdir(cat_dir)):
            if not fname.endswith(".properties"):
                continue
            props = load_properties(os.path.join(cat_dir, fname))
            catalogs.register(fname[: -len(".properties")], _make_connector(props))
    return catalogs


class NodeConfig:
    def __init__(self, props: dict[str, str]):
        self.coordinator = props.get("coordinator", "true").lower() == "true"
        self.port = int(props.get("http-server.http.port", "0"))
        self.discovery_uri: Optional[str] = props.get("discovery.uri")
        self.query_max_memory_bytes = int(props.get("query.max-memory-per-node", "0"))
        self.cluster_memory_limit_bytes = int(
            props.get("memory.heap-headroom-per-node", "0")
        )
        # the same headroom figure sizes each worker's NodeMemoryPool
        # (runtime/memory.py) — task reservations are carved from it
        self.node_memory_bytes = self.cluster_memory_limit_bytes
        self.exchange_spool_dir = props.get("exchange.spool-dir", "")
        # disk governance (runtime/disk.py NodeDiskPool): spool commits and
        # spill files lease bytes against this per-node budget; 0 = ungoverned
        self.disk_budget_bytes = int(props.get("spool.disk-budget-bytes", "0"))
        # how long a writer parks on a full disk pool (after reclaim) before
        # shedding with the typed EXCEEDED_SPILL_LIMIT
        self.disk_blocked_timeout_s = float(
            props.get("spool.disk-blocked-timeout-s", "10")
        )
        self.retry_policy = props.get("retry-policy", "NONE")
        self.task_concurrency = int(props.get("task.concurrency", "4"))
        self.journal_path = props.get("query.journal-path", "")
        self.resume_policy = props.get("query.resume-policy", "")
        # coordinator fleet (runtime/fleet.py): shared lease/journal dir,
        # member list for the router + fleet-aware worker announce
        self.fleet_dir = props.get("fleet.dir", "")
        self.fleet_coordinators = [
            u.strip().rstrip("/")
            for u in props.get("fleet.coordinators", "").split(",")
            if u.strip()
        ]
        self.fleet_lease_ttl_s = float(props.get("fleet.lease-ttl-s", "10"))
        self.fleet_coordinator_id = props.get("fleet.coordinator-id", "") or None
        # flight recorder (utils/flightrecorder.py) — applied to the
        # process-global ring at node boot
        self.flightrecorder_enabled = (
            props.get("flightrecorder.enabled", "true").lower() == "true"
        )
        self.flightrecorder_ring_size = int(
            props.get("flightrecorder.ring-size", "4096")
        )
        # time-series plane (utils/timeseries.py) — applied to the
        # process-global store at node boot
        self.timeseries_enabled = (
            props.get("timeseries.enabled", "true").lower() == "true"
        )
        self.timeseries_ring_size = int(props.get("timeseries.ring-size", "512"))
        self.timeseries_sample_interval_s = float(
            props.get("timeseries.sample-interval-s", "1")
        )
        # the device the node's tasks (and a coordinator's root fragment)
        # run on: the card unless the file asks for the CPU
        self.device = props.get("node.device", "cuda")


def apply_flightrecorder_config(cfg: "NodeConfig") -> None:
    """Push the node's flight-recorder keys onto the process-global ring
    (server boot path; tests configure the ring directly)."""
    from ..utils import flightrecorder as _fr

    _fr.configure(
        ring_size=cfg.flightrecorder_ring_size, enabled=cfg.flightrecorder_enabled
    )


def apply_timeseries_config(cfg: "NodeConfig") -> None:
    """Push the node's time-series keys onto the process-global store
    (server boot path; tests configure the store directly)."""
    from ..utils import timeseries as _ts

    _ts.configure(
        enabled=cfg.timeseries_enabled,
        ring_size=cfg.timeseries_ring_size,
        sample_interval_s=cfg.timeseries_sample_interval_s,
    )


def load_node_config(etc_dir: str) -> NodeConfig:
    path = os.path.join(etc_dir, "config.properties")
    return NodeConfig(load_properties(path) if os.path.exists(path) else {})
