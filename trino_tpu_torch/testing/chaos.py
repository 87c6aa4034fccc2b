"""Seeded chaos harness for the multi-host runtime.

Reference: the reference engine proves fault tolerance by running its
product-test query suites under injected faults (FailureInjector wired
through TestingTrinoServer.injectTaskFailure) and asserting results still
match the H2 oracle.  Same structure here: a ChaosRunner wraps the
in-process DistributedQueryRunner, arms a RANDOM-BUT-SEEDED schedule of
faults from the worker fault matrix before every query, runs the query
under retry_policy=TASK, and hands the caller the rows to diff against the
sqlite oracle.  Determinism: one `random.Random(seed)` drives every choice
(mode, target worker, delay, count), so a failing schedule replays exactly
from its seed.  The cluster's nodes run where the runner puts them
(`device=` / `devices=`, as DistributedQueryRunner takes them): the CPU in
the tests, the card in chip_smoke.py.
"""

from __future__ import annotations

import random
from typing import Optional, Sequence

from .runner import DistributedQueryRunner

__all__ = [
    "ChaosRunner", "RECOVERABLE_MODES", "CORRUPTION_MODES", "COMPILE_MODES",
    "SPLIT_MODES", "STORAGE_MODES", "WRITE_MODES", "PARTITION_MODES",
]

# modes that a retry_policy=TASK cluster must absorb without losing the
# query: ERROR/TIMEOUT fail the task (re-scheduled on another worker),
# SLOW delays it (no failure at all), EXCHANGE_DROP 503s page fetches
# (consumer Backoff resumes from its ack token)
RECOVERABLE_MODES = ("ERROR", "TIMEOUT", "SLOW", "EXCHANGE_DROP")

# opt-in: CORRUPT flips a byte inside a served page frame — the consumer's
# crc32 check (runtime/wire.py) must detect it and re-fetch from its ack
# token, so results stay byte-correct.  Kept out of RECOVERABLE_MODES so
# existing seeded schedules replay identically; pass
# modes=CORRUPTION_MODES (or RECOVERABLE_MODES + ("CORRUPT",)) to arm it.
CORRUPTION_MODES = RECOVERABLE_MODES + ("CORRUPT",)

# opt-in: compile-plane chaos (exec/compilesvc.py).  COMPILE_SLOW stalls a
# task's kernel 2 build by delay_ms (the query must fall back / absorb the
# wait), COMPILE_FAIL raises inside the build (the query must succeed via
# fallback and the signature breaker must stop the churn).  A separate
# tuple — not folded into RECOVERABLE_MODES — so existing seeded schedules
# replay identically; pass modes=COMPILE_MODES (or RECOVERABLE_MODES +
# COMPILE_MODES) to arm it.
COMPILE_MODES = ("COMPILE_SLOW", "COMPILE_FAIL")

# opt-in: storage-plane chaos (runtime/disk.py + the self-healing spool).
# SPOOL_LOST deletes a producer's COMMITTED spool partition right before a
# consumer reads it — the consumer fails typed ("SPOOL_LOST:{tid}:") and
# the coordinator must REPRODUCE the producer under first-commit-wins
# instead of failing the query.  DISK_FULL shrinks a worker's NodeDiskPool
# at arm time (capacity_bytes) — commits on that node reclaim, block, then
# shed with the typed EXCEEDED_SPILL_LIMIT error that task retry rotates
# away from.  A separate tuple — not folded into RECOVERABLE_MODES — so
# existing seeded schedules replay identically; pass
# modes=RECOVERABLE_MODES + STORAGE_MODES to arm it alongside the rest.
STORAGE_MODES = ("SPOOL_LOST", "DISK_FULL")

# opt-in: write-plane chaos (runtime/txn.py phase boundaries).
# COMMIT_CRASH simulates a hard coordinator death at intent|commit|ack —
# the txn layer re-raises without abort and the coordinator swallows it like
# kill(), so recovery must come from journal replay checking the commit
# marker (exactly-once: no-op if committed, clean abort + staging reclaim if
# not).  WRITE_STALL sleeps inside a phase (lease-timeout / janitor-grace
# exercise).  These arm on the COORDINATOR's fault injector
# (runner.inject_write_failure), not a worker's, and live in their own
# tuple — not folded into RECOVERABLE_MODES — so existing seeded schedules
# replay identically.
WRITE_MODES = ("COMMIT_CRASH", "WRITE_STALL")

# opt-in: exchange-plane partition chaos (runtime/health.py + the hedged
# fetch path in runtime/worker.py).  PARTITION black-holes a pairwise
# (consumer -> producer) link with 503s — the consumer's LinkHealth must
# grade it DEAD and the hedge path must serve the data from the spool;
# GRAY_SLOW serves pages correctly but delay_ms late (latency-only gray
# failure: no errors, the hedge race is the only mitigation); FLAKY_LINK
# drops probabilistically (probability/seed).  All three scope by the
# consumer= field on the rule and arm persistent (count=-1) so the link
# stays broken for the whole drill.  A separate tuple — not folded into
# RECOVERABLE_MODES — so existing seeded schedules replay identically;
# pass modes=RECOVERABLE_MODES + PARTITION_MODES to arm it alongside the
# rest (the cluster must run a spooled exchange for the hedge to win).
PARTITION_MODES = ("PARTITION", "GRAY_SLOW", "FLAKY_LINK")

# opt-in: split-plane chaos (runtime/splits.py).  SPLIT_LOST raises inside
# one task's execution hook — under split_driven_scans a task IS one
# morsel, so exactly that split retries on another worker while every
# committed sibling is left alone.  A separate tuple — not folded into
# RECOVERABLE_MODES — so existing seeded schedules replay identically;
# pass modes=RECOVERABLE_MODES + SPLIT_MODES to arm it alongside the rest.
SPLIT_MODES = ("SPLIT_LOST",)


class ChaosRunner:
    """Arm seeded random fault schedules around queries on a live cluster.

    Usage:
        chaos = ChaosRunner(runner, seed=7)
        for name, sql in queries:
            got = chaos.run_query(sql)        # faults armed, query survives
            assert_rows_equal(got, oracle.query(sql))
        assert len(chaos.fired_modes()) >= 3  # the schedule actually bit
    """

    def __init__(
        self,
        runner: DistributedQueryRunner,
        seed: int = 0,
        modes: Sequence[str] = RECOVERABLE_MODES,
        max_faults_per_query: int = 2,
    ):
        self.runner = runner
        self.rng = random.Random(seed)
        self.modes = tuple(modes)
        self.max_faults_per_query = max_faults_per_query
        self.schedule: list[list[dict]] = []  # one entry per run_query

    # ------------------------------------------------------------ schedule

    def arm_random_faults(self) -> list[dict]:
        """Arm 1..max_faults rules drawn from the seeded rng and return the
        armed schedule (also appended to self.schedule for replay logs)."""
        events = []
        for _ in range(self.rng.randint(1, self.max_faults_per_query)):
            mode = self.rng.choice(self.modes)
            ev = {
                "mode": mode,
                "worker_index": self.rng.randrange(len(self.runner.workers)),
                "task_id": "*",
                "delay_ms": (
                    self.rng.choice((50, 150, 300))
                    if mode in ("TIMEOUT", "SLOW", "COMPILE_SLOW")
                    else 0
                ),
                "count": self.rng.randint(1, 3) if mode == "EXCHANGE_DROP" else 1,
            }
            if mode == "DISK_FULL":
                # consumed at arm time: shrink the worker's NodeDiskPool so
                # commits/spills there reclaim -> block -> shed typed (the
                # cluster must only be armed with this mode when its
                # workers run a governed disk pool)
                ev["capacity_bytes"] = self.rng.choice(
                    (64 << 10, 256 << 10, 1 << 20)
                )
            if mode in ("PARTITION", "GRAY_SLOW", "FLAKY_LINK"):
                # pairwise link fault: scope the rule to one OTHER worker's
                # consumer identity and arm it persistent — a partition
                # does not heal after N fetches, the hedge path must route
                # around it for the rest of the query
                others = [
                    w.url
                    for i, w in enumerate(self.runner.workers)
                    if i != ev["worker_index"]
                ]
                ev["consumer"] = self.rng.choice(others) if others else "*"
                ev["count"] = -1
                if mode == "GRAY_SLOW":
                    ev["delay_ms"] = self.rng.choice((200, 500, 1000))
                if mode == "FLAKY_LINK":
                    ev["probability"] = self.rng.choice((0.3, 0.5, 0.7))
                    ev["seed"] = self.rng.randrange(1 << 30)
            self.runner.inject_task_failure(**ev)
            events.append(ev)
        self.schedule.append(events)
        return events

    def clear_faults(self) -> None:
        """Disarm leftover rules on every worker (a rule armed for a stage
        that never ran on its worker would otherwise leak into the next
        query)."""
        for w in self.runner.workers:
            w.fault_injector.clear()

    # ------------------------------------------------------------ running

    def run_query(self, sql: str, arm: bool = True) -> list[tuple]:
        """Arm a random schedule, run `sql`, disarm leftovers, return rows.
        The query is expected to SURVIVE — any RuntimeError propagates to
        the caller (a real resilience failure, replayable from the seed)."""
        if arm:
            self.arm_random_faults()
        try:
            return self.runner.query(sql)
        finally:
            self.clear_faults()

    def run_query_with_action(
        self, sql: str, action, delay_s: float = 0.1
    ) -> list[tuple]:
        """Lifecycle chaos: run `sql` with `action()` fired from a
        background thread after delay_s — drain or hard-kill a worker
        mid-flight (runner.drain_worker / runner.kill_worker).  The query
        is expected to survive; action exceptions surface after the rows."""
        import threading
        import time as _time

        err: list[BaseException] = []

        def _fire():
            _time.sleep(delay_s)
            try:
                action()
            except BaseException as e:  # surfaced below, not swallowed
                err.append(e)

        t = threading.Thread(target=_fire, daemon=True)
        t.start()
        try:
            rows = self.runner.query(sql)
        finally:
            t.join()
        if err:
            raise err[0]
        return rows

    # ------------------------------------------------------------ observability

    def fired(self) -> list[tuple[str, str]]:
        """(mode, task_id) pairs that actually fired, across all workers."""
        out: list[tuple[str, str]] = []
        for w in self.runner.workers:
            out.extend(w.fault_injector.fired)
        return out

    def fired_modes(self) -> set[str]:
        return {mode for mode, _ in self.fired()}

    def armed_modes(self) -> set[str]:
        return {ev["mode"] for events in self.schedule for ev in events}


def make_chaos_cluster(
    catalog_factory,
    num_workers: int = 3,
    default_catalog: str = "tpch",
    heartbeat_interval: float = 1.0,
    seed: int = 0,
    modes: Sequence[str] = RECOVERABLE_MODES,
    num_coordinators: int = 1,
    fleet_ttl_s: float = 10.0,
    disk_budget_bytes: Optional[int] = None,
    device="cuda",
    devices=None,
) -> tuple[DistributedQueryRunner, ChaosRunner]:
    """Start a retry_policy=TASK cluster plus its ChaosRunner.  The caller
    owns shutdown (runner.stop()).  num_coordinators>1 stands up a
    coordinator fleet behind a FleetRouter for failover chaos.
    disk_budget_bytes gives every worker a governed NodeDiskPool —
    required when arming STORAGE_MODES (DISK_FULL shrinks that pool).
    `device` / `devices` place the nodes as DistributedQueryRunner does
    (the card by default, which raises without one)."""
    runner = DistributedQueryRunner(
        num_workers=num_workers,
        default_catalog=default_catalog,
        heartbeat_interval=heartbeat_interval,
        num_coordinators=num_coordinators,
        fleet_ttl_s=fleet_ttl_s,
        disk_budget_bytes=disk_budget_bytes,
        device=device,
        devices=devices,
    )
    runner.register_catalog(default_catalog, catalog_factory())
    runner.start()
    for coord in runner.coordinators:
        coord.session.set("retry_policy", "TASK")
    return runner, ChaosRunner(runner, seed=seed, modes=modes)
