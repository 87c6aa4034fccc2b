"""In-process multi-node cluster for tests.

Reference: testing/trino-testing/.../DistributedQueryRunner.java:107 —
launches a coordinator + N workers as full servers in ONE JVM over loopback
HTTP: the whole stack runs (discovery, scheduling, task execution,
exchanges), only the network is local.  Identical trick here: coordinator +
N Worker HTTP servers in one process, real wire serde, real fragment
scheduling, loopback sockets.

Every task runs on its worker's device and the root fragment on the first
device: `device=` (one for every node; the CUDA card by default, which
raises without one) or `devices=[...]`, one per worker, where a card may
repeat (`["cuda:0"] * 3`: three workers on one card).
"""

from __future__ import annotations

import json
import shutil
import tempfile
import urllib.request
from typing import Optional

from .. import resolve_device
from ..connectors.spi import CatalogManager, Connector
from ..runtime.coordinator import Coordinator
from ..runtime.worker import Worker

__all__ = ["DistributedQueryRunner"]


class DistributedQueryRunner:
    def __init__(
        self,
        num_workers: int = 2,
        default_catalog: str = "tpch",
        heartbeat_interval: float = 2.0,
        worker_buffer_memory_bytes: Optional[int] = None,
        cluster_memory_limit_bytes: int = 0,
        node_memory_bytes: Optional[int] = None,
        disk_budget_bytes: Optional[int] = None,
        journal_path: Optional[str] = None,
        num_coordinators: int = 1,
        fleet_dir: Optional[str] = None,
        fleet_ttl_s: float = 10.0,
        device="cuda",
        devices=None,
    ):
        if devices is None:
            devices = [device] * num_workers
        elif len(devices) != num_workers:
            raise ValueError(
                f"{len(devices)} devices for {num_workers} workers: give one per worker"
            )
        # resolved now: a runner on a machine without a card fails here
        self.devices = [resolve_device(d) for d in devices] or [resolve_device(device)]
        self.catalogs = CatalogManager()
        self.default_catalog = default_catalog
        self.num_workers = num_workers
        self.heartbeat_interval = heartbeat_interval
        self.worker_buffer_memory_bytes = worker_buffer_memory_bytes
        self.cluster_memory_limit_bytes = cluster_memory_limit_bytes
        self.node_memory_bytes = node_memory_bytes
        self.disk_budget_bytes = disk_budget_bytes
        self.journal_path = journal_path
        # coordinator fleet (runtime/fleet.py): N>1 members share a lease
        # dir (auto-created when not given) behind a FleetRouter front door
        self.num_coordinators = num_coordinators
        self.fleet_dir = fleet_dir
        self.fleet_ttl_s = fleet_ttl_s
        self._fleet_tmp: Optional[str] = None
        self.router = None
        self.coordinators: list[Coordinator] = []
        self.workers: list[Worker] = []

    # `runner.coordinator` predates the fleet: keep it meaning "the first
    # coordinator" so single-coordinator tests read unchanged, and let
    # restart_coordinator() assign the replacement through the setter
    @property
    def coordinator(self) -> Optional[Coordinator]:
        return self.coordinators[0] if self.coordinators else None

    @coordinator.setter
    def coordinator(self, coord: Optional[Coordinator]) -> None:
        if coord is None:
            self.coordinators = []
        elif self.coordinators:
            self.coordinators[0] = coord
        else:
            self.coordinators.append(coord)

    @property
    def client_url(self) -> str:
        """What a client should connect to: the router in fleet mode."""
        if self.router is not None:
            return self.router.url
        return self.coordinator.url

    def register_catalog(self, name: str, connector: Connector) -> None:
        self.catalogs.register(name, connector)

    def _make_coordinator(self, index: int, port: int = 0) -> Coordinator:
        fdir = self.fleet_dir
        return Coordinator(
            self.catalogs,
            self.default_catalog,
            port=port,
            heartbeat_interval=self.heartbeat_interval,
            cluster_memory_limit_bytes=self.cluster_memory_limit_bytes,
            # fleet members journal into their leased per-member namespace
            journal_path=None if fdir else self.journal_path,
            fleet_dir=fdir,
            fleet_ttl_s=self.fleet_ttl_s,
            coordinator_id=f"c{index}" if fdir else None,
            device=self.devices[0],
        )

    def start(self) -> "DistributedQueryRunner":
        if self.num_coordinators > 1 and self.fleet_dir is None:
            self._fleet_tmp = tempfile.mkdtemp(prefix="trino_tpu_fleet_")
            self.fleet_dir = self._fleet_tmp
        for i in range(self.num_coordinators):
            self.coordinators.append(self._make_coordinator(i).start())
        if self.num_coordinators > 1:
            from ..runtime.fleet import FleetRouter

            self.router = FleetRouter(
                [c.url for c in self.coordinators]
            ).start()
        for i in range(self.num_workers):
            w = Worker(
                self.catalogs,
                self.default_catalog,
                buffer_memory_bytes=self.worker_buffer_memory_bytes,
                node_memory_bytes=self.node_memory_bytes,
                disk_budget_bytes=self.disk_budget_bytes,
                device=self.devices[i],
            ).start()
            self.workers.append(w)
            # the worker knows every coordinator so a completed drain can
            # deregister itself and any fleet member can dispatch to it
            w.coordinator_urls = [c.url for c in self.coordinators]
            # announce over the wire like a real worker would
            for c in self.coordinators:
                req = urllib.request.Request(
                    f"{c.url}/v1/announce",
                    data=json.dumps({"url": w.url}).encode(),
                )
                urllib.request.urlopen(req, timeout=10).read()
        return self

    def stop(self) -> None:
        for w in self.workers:
            w.stop()
        if self.router is not None:
            self.router.stop()
        for c in self.coordinators:
            try:
                c.stop()
            except Exception:
                pass  # a killed member has nothing left to stop
        if self._fleet_tmp is not None:
            shutil.rmtree(self._fleet_tmp, ignore_errors=True)

    def drain_worker(self, index: int) -> None:
        """Trigger a graceful drain over the wire (PUT /v1/info/state
        DRAINING) — the worker finishes running tasks, keeps serving its
        buffers, then deregisters.  Returns immediately; the drain
        completes on the worker's background thread."""
        w = self.workers[index]
        req = urllib.request.Request(
            f"{w.url}/v1/info/state", data=b'"DRAINING"', method="PUT"
        )
        urllib.request.urlopen(req, timeout=10).read()

    def kill_worker(self, index: int) -> None:
        """Hard-stop a worker (the SIGKILL analogue): no drain, in-flight
        tasks are abandoned — recovery must come from retry/spool."""
        self.workers[index].kill()

    def kill_coordinator(self, index: int = 0) -> int:
        """Crash a coordinator (the SIGKILL analogue): the HTTP server
        stops and every scheduling thread abandons its work mid-flight —
        no task cleanup, no spool remove_query, no journal finish, no lease
        release (fleet peers see the lease EXPIRE and adopt).  Workers keep
        running and serving their buffers.  Returns the port so a restart
        can rebind the same client-visible URL."""
        port = self.coordinators[index].port
        self.coordinators[index].kill()
        return port

    def restart_coordinator(
        self,
        port: Optional[int] = None,
        session: Optional[dict] = None,
        index: int = 0,
    ) -> Coordinator:
        """Boot a replacement coordinator on the same port (clients keep
        polling an unchanged nextUri) against the same catalogs and
        journal.  `session` properties are applied BEFORE start() so the
        journal-resume thread sees them (resume_policy, spool dir).  Live
        workers are re-pointed and re-announced immediately — their own
        periodic announce would also find it within one interval."""
        port = port if port is not None else self.coordinators[index].port
        coord = self._make_coordinator(index, port=port)
        self.coordinators[index] = coord
        for name, value in (session or {}).items():
            coord.session.set(name, str(value))
        coord.start()
        for w in self.workers:
            w.coordinator_urls = [c.url for c in self.coordinators]
            try:
                req = urllib.request.Request(
                    f"{coord.url}/v1/announce",
                    data=json.dumps({"url": w.url}).encode(),
                )
                urllib.request.urlopen(req, timeout=10).read()
            except Exception:
                pass  # a killed worker can't be re-announced
        return coord

    def query(self, sql: str) -> list[tuple]:
        """Direct (synchronous) execution through the scheduler."""
        return [tuple(r) for r in self.coordinator.execute_query(sql)]

    def query_via_protocol(self, sql: str) -> list[tuple]:
        """Through the HTTP client protocol (POST /v1/statement + nextUri),
        via the fleet router when one is running."""
        from ..client import StatementClient

        _, rows = StatementClient(self.client_url).execute(sql)
        return [tuple(r) for r in rows]

    def inject_task_failure(
        self,
        worker_index: int = 0,
        task_id: str = "*",
        mode: str = "ERROR",
        delay_ms: int = 0,
        count: int = 1,
        probability: float = 1.0,
        seed: int | None = None,
        capacity_bytes: int | None = None,
        consumer: str | None = None,
    ) -> None:
        """Arm one rule of the worker's fault matrix (reference:
        TestingTrinoServer.injectTaskFailure, FailureInjector.java).  Modes:
        ERROR (raise), TIMEOUT (sleep delay_ms then raise), SLOW (sleep
        delay_ms then run), EXCHANGE_DROP (503 the next `count` page
        fetches), CORRUPT (flip a byte in the next `count` served page
        frames), MEMORY_PRESSURE (shrink the worker's NodeMemoryPool to
        `capacity_bytes` immediately), PARTITION / GRAY_SLOW / FLAKY_LINK
        (pairwise link faults on this worker's served exchange fetches,
        scoped by `consumer` — a worker-url prefix; "*" hits every
        consumer).  probability<1 arms a seeded probabilistic variant;
        count<0 arms a persistent rule that never exhausts."""
        w = self.workers[worker_index]
        body = {
            "task_id": task_id,
            "mode": mode,
            "delay_ms": delay_ms,
            "count": count,
            "probability": probability,
        }
        if seed is not None:
            body["seed"] = seed
        if capacity_bytes is not None:
            body["capacity_bytes"] = capacity_bytes
        if consumer is not None:
            body["consumer"] = consumer
        req = urllib.request.Request(
            f"{w.url}/v1/inject_failure",
            data=json.dumps(body).encode(),
        )
        urllib.request.urlopen(req, timeout=10).read()

    def inject_write_failure(
        self,
        phase: str = "commit",
        txn_id: str = "",
        mode: str = "COMMIT_CRASH",
        delay_ms: int = 0,
        count: int = 1,
        coordinator_index: int = 0,
    ) -> None:
        """Arm one write-plane fault on a coordinator (runtime/txn.py hook
        points).  `phase` is intent|commit|ack — the txn layer consults the
        injector with key "<phase>:<txn_id>", so arming just a phase prefix
        hits every write at that boundary.  COMMIT_CRASH simulates a hard
        coordinator death mid-write (no abort, no terminal journal record);
        WRITE_STALL sleeps delay_ms inside the phase."""
        self.coordinators[coordinator_index].fault_injector.arm(
            task_id=f"{phase}:{txn_id}", mode=mode, delay_ms=delay_ms,
            count=count,
        )

    def memory_pressure(self, worker_index: int, capacity_bytes: int) -> None:
        """Shrink one worker's NodeMemoryPool mid-run — the MEMORY_PRESSURE
        chaos lever.  Running reservations keep their bytes; new reserve()
        calls see the reduced capacity and park BLOCKED."""
        self.inject_task_failure(
            worker_index, mode="MEMORY_PRESSURE", capacity_bytes=capacity_bytes
        )

    def partition_link(
        self, producer_index: int, consumer_index: int, count: int = -1
    ) -> None:
        """Black-hole the (consumer -> producer) exchange link: the
        producer 503s every results fetch that identifies itself as coming
        from that consumer — an ASYMMETRIC partition (heartbeats and every
        other consumer's fetches keep working).  Persistent by default
        (count=-1); the consumer's LinkHealth must grade the link DEAD and
        reroute through the spool hedge path."""
        self.inject_task_failure(
            producer_index, mode="PARTITION", count=count,
            consumer=self.workers[consumer_index].url,
        )

    def gray_slow(
        self,
        producer_index: int,
        delay_ms: int,
        consumer_index: int | None = None,
        count: int = -1,
    ) -> None:
        """Make a producer serve exchange pages delay_ms late WITHOUT any
        error — the latency-only gray failure the link scorer must catch
        (SUSPECT on the latency ratio) and the hedge race must mitigate.
        Scopes to one consumer when given, otherwise to every fetcher."""
        self.inject_task_failure(
            producer_index, mode="GRAY_SLOW", delay_ms=delay_ms, count=count,
            consumer=(
                self.workers[consumer_index].url
                if consumer_index is not None
                else "*"
            ),
        )

    def disk_full(self, worker_index: int, capacity_bytes: int) -> None:
        """Shrink one worker's NodeDiskPool mid-run — the DISK_FULL chaos
        lever.  Spool commits and spill writes on that node reclaim, then
        block, then shed with the typed EXCEEDED_SPILL_LIMIT error that
        the coordinator's task retry rotates away from."""
        self.inject_task_failure(
            worker_index, mode="DISK_FULL", capacity_bytes=capacity_bytes
        )

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
