"""The port's coordinator fleet: leases, adoption, router, failover
(runtime/fleet.py).  Ports of the 15 cases of tests/test_fleet.py, every
node on the CPU.

Unit tier: lease lifecycle (acquire / renew / expire / steal), the
single-winner adoption claim, GC-owner election + the fleet-wide live-query
union, shard stability, decorrelated backoff spread, the snapshot-reading
journal replay under a concurrent foreign writer, and client endpoint-list
failover.

Cluster tier (slow/chaos, as in the reference): a two-coordinator
fleet behind the FleetRouter — router shard routing end to end, and the
tentpole scenario: kill one coordinator mid multi-stage query and the
survivor adopts it off the dead member's journal with ZERO client-visible
failures and ZERO recompute of spool-committed stages.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

try:  # arrow before torch: loaded after it, arrow's parquet writer crashes the process
    import pyarrow  # noqa: F401
except ImportError:
    pass
import torch

from trino_tpu_torch.client import StatementClient
from trino_tpu_torch.connectors.memory import MemoryConnector
from trino_tpu_torch.connectors.spi import ColumnSchema
from trino_tpu_torch.data.types import BIGINT
from trino_tpu_torch.runtime.failure import Backoff
from trino_tpu_torch.runtime.fleet import FleetMember, FleetRouter, shard_for
from trino_tpu_torch.runtime.journal import QueryJournal
from trino_tpu_torch.testing.runner import DistributedQueryRunner
from tests.test_torch_recovery import scans  # noqa: F401  (fixture: scans per table)

# ---------------------------------------------------------------- fixtures


class _Clock:
    """Settable clock for lease tests — expiry without sleeping."""

    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


class GatedMemoryConnector(MemoryConnector):
    """Memory connector whose reads block on a gate — holds a query
    mid-flight — and count per-table reads (the recompute witness)."""

    def __init__(self):
        super().__init__()
        self.gate = threading.Event()
        self.gated_table = None
        self.reads: dict[str, int] = {}
        self._rlock = threading.Lock()

    def read_split(self, split, columns):
        with self._rlock:
            self.reads[split.table] = self.reads.get(split.table, 0) + 1
        if split.table == self.gated_table:
            assert self.gate.wait(timeout=120), "test gate never opened"
        return super().read_split(split, columns)


def _make_tables(conn):
    conn.create_table("build", [ColumnSchema("k", BIGINT), ColumnSchema("w", BIGINT)])
    conn.insert("build", {"k": np.arange(50, dtype=np.int64),
                          "w": np.arange(50, dtype=np.int64) * 10})
    conn.create_table("probe", [ColumnSchema("k", BIGINT), ColumnSchema("v", BIGINT)])
    conn.insert("probe", {"k": np.arange(2000, dtype=np.int64) % 50,
                          "v": np.arange(2000, dtype=np.int64)})
    return int((np.arange(2000) + (np.arange(2000) % 50) * 10).sum())


JOIN_SQL = "select sum(v + w) from probe, build where probe.k = build.k"


def _wait(pred, timeout=30.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return bool(pred())


def _committed_dirs(spool_dir):
    if not os.path.isdir(spool_dir):
        return []
    return [n for n in os.listdir(spool_dir)
            if os.path.exists(os.path.join(spool_dir, n, "COMMITTED"))]


# ------------------------------------------------------------ lease lifecycle


def test_lease_acquire_renew_expire_steal(tmp_path):
    clock = _Clock()
    a = FleetMember(str(tmp_path), coordinator_id="c0", url="http://a",
                    ttl_s=10.0, clock=clock)
    b = FleetMember(str(tmp_path), coordinator_id="c1", url="http://b",
                    ttl_s=10.0, clock=clock)
    assert a.acquire() == 1
    assert b.acquire() == 1

    # renew embeds live queries; peers read them from the lease file
    assert a.renew({"q_x", "q_y"})
    [lease] = [l for l in b.peers() if l["coordinator_id"] == "c0"]
    assert lease["live_queries"] == ["q_x", "q_y"]
    assert b.expired_peers() == []

    # TTL runs out without renewal: the peer becomes an adoption candidate
    clock.t += 11.0
    assert b.renew({"q_z"})  # b renewed itself first
    expired = b.expired_peers()
    assert [l["coordinator_id"] for l in expired] == ["c0"]

    # a restart of the same identity bumps PAST the prior epoch
    a2 = FleetMember(str(tmp_path), coordinator_id="c0", url="http://a",
                     ttl_s=10.0, clock=clock)
    assert a2.acquire() == 2
    assert b.expired_peers() == []  # fresh lease: no longer expired

    # a second process taking the same UNEXPIRED identity is a steal; the
    # loser's renew sees the higher epoch and stands down
    a3 = FleetMember(str(tmp_path), coordinator_id="c0", url="http://a",
                     ttl_s=10.0, clock=clock)
    assert a3.acquire() == 3
    assert a2.renew() is False
    assert a3.renew()

    # graceful release removes the lease entirely — nothing to adopt
    a3.release()
    clock.t += 100.0
    assert [l["coordinator_id"] for l in b.expired_peers()] == []


def test_adoption_claim_single_winner(tmp_path):
    clock = _Clock()
    dead = FleetMember(str(tmp_path), coordinator_id="c9", ttl_s=1.0, clock=clock)
    dead.acquire()
    dead.renew({"q_dead"})
    clock.t += 5.0

    s1 = FleetMember(str(tmp_path), coordinator_id="c0", ttl_s=10.0, clock=clock)
    s2 = FleetMember(str(tmp_path), coordinator_id="c1", ttl_s=10.0, clock=clock)
    s1.acquire(); s2.acquire()
    [lease1] = s1.expired_peers()
    [lease2] = s2.expired_peers()
    wins = [s1.try_adopt(lease1), s2.try_adopt(lease2)]
    assert sorted(wins) == [False, True], "exactly one survivor may adopt"
    # the adopted marker stops further sweeps from seeing the corpse
    assert s1.expired_peers() == [] and s2.expired_peers() == []
    # a NEW incarnation of c9 gets a fresh epoch -> freshly adoptable later
    dead2 = FleetMember(str(tmp_path), coordinator_id="c9", ttl_s=1.0, clock=clock)
    assert dead2.acquire() == 2


def test_gc_owner_election_and_live_union(tmp_path):
    clock = _Clock()
    a = FleetMember(str(tmp_path), coordinator_id="c0", ttl_s=10.0, clock=clock)
    b = FleetMember(str(tmp_path), coordinator_id="c1", ttl_s=10.0, clock=clock)
    a.acquire(); b.acquire()
    a.renew({"q_a"}); b.renew({"q_b"})

    # exactly one owner for destructive sweeps: smallest unexpired id
    assert a.is_gc_owner() and not b.is_gc_owner()

    # both members compute the same fleet-wide live union
    assert a.fleet_live_queries() == {"q_a", "q_b"}
    assert b.fleet_live_queries() == {"q_a", "q_b"}

    # c0 dies: c1 takes over GC ownership, and the DEAD member's queries
    # stay in the union until adoption — their spool output is exactly
    # what the adopter must re-read, so GC must not touch it
    clock.t += 11.0
    b.renew({"q_b"})
    assert not a.is_gc_owner() and b.is_gc_owner()
    assert b.fleet_live_queries() == {"q_a", "q_b"}


def test_fleet_info_snapshot(tmp_path):
    clock = _Clock()
    a = FleetMember(str(tmp_path), coordinator_id="c0", url="http://a",
                    ttl_s=10.0, clock=clock)
    a.acquire()
    a.renew({"q_1"})
    info = a.info()
    assert info["coordinator_id"] == "c0" and info["gc_owner"]
    [m] = info["members"]
    assert m["alive"] and m["live_queries"] == 1 and m["url"] == "http://a"


# ------------------------------------------------------------------ sharding


def test_shard_stability_and_router_order():
    # deterministic across calls/processes (sha1, not salted hash())
    assert shard_for("q_abc123", 2) == shard_for("q_abc123", 2)
    assert all(0 <= shard_for(f"q_{i}", 3) < 3 for i in range(100))
    # non-degenerate: both shards of a 2-fleet get traffic
    shards = {shard_for(f"q_{i:04x}", 2) for i in range(64)}
    assert shards == {0, 1}

    urls = ["http://c0", "http://c1", "http://c2"]
    router = FleetRouter(urls)
    try:
        for qid in ("q_aa", "q_bb", "q_cc"):
            order = router.order_for(qid)
            # the shard owner is first, every member is a failover target
            assert order[0] == urls[shard_for(qid, 3)]
            assert sorted(order) == sorted(urls)
            assert order == router.order_for(qid)  # stable for the query
        # no query id: natural order (admission pre-mint)
        assert router.order_for(None) == urls
        # body rewrite points every member URL back at the router
        body = b'{"nextUri": "http://c1/v1/statement/q_aa/1"}'
        assert router.url.encode() in router.rewrite(body)
        assert b"http://c1" not in router.rewrite(body)
    finally:
        router.stop()


# ----------------------------------------------------- decorrelated backoff


def test_backoff_decorrelated_jitter_spread():
    # first-retry delays from a cohort of clients must SPREAD over
    # [min, 3*min], not cluster around one center: this is what keeps a
    # mass re-attach after a coordinator death from arriving in waves
    firsts = [
        Backoff(min_delay=0.1, max_delay=2.0, decorrelated=True,
                rng=random.Random(i)).delay()
        for i in range(200)
    ]
    assert all(0.1 <= d <= 0.3 + 1e-9 for d in firsts)
    assert len({round(d, 4) for d in firsts}) > 50, "delays did not spread"
    spread = max(firsts) - min(firsts)
    assert spread > 0.1, f"cohort clustered: spread={spread}"

    # the walk stays within [min, max] and is capped at max_delay
    b = Backoff(min_delay=0.1, max_delay=2.0, decorrelated=True,
                rng=random.Random(7))
    seq = [b.delay() for _ in range(50)]
    assert all(0.1 <= d <= 2.0 for d in seq)
    assert max(seq) <= 2.0
    # success() resets the walk to the first-retry distribution
    b.success()
    assert 0.1 <= b.delay() <= 0.3 + 1e-9

    # default (correlated) schedule is untouched: deterministic centers
    c = Backoff(min_delay=0.1, max_delay=2.0, jitter=0.0)
    c.failure(); d1 = c.delay()
    c.failure(); d2 = c.delay()
    assert (d1, d2) == (0.1, 0.2)


# -------------------------------------------- journal under foreign writers


def test_journal_replay_with_concurrent_foreign_writer(tmp_path):
    """An adopter replays a journal file another process may still be
    appending to (the dying peer's last buffered write, a slow NFS flush):
    replay must fold every COMPLETE record and ignore a torn tail."""
    p = str(tmp_path / "journal-c9.jsonl")
    j = QueryJournal(p)
    j.append("admit", "q_aa", sql="select 1", session={}, spooled=True)
    j.append("dispatch", "q_aa", fragment=1, ntasks=2, attempt=0)
    j.append("commit", "q_aa", fragment=1, part=0, task_id="t0")
    j.close()

    # a foreign writer holds the file open and has written HALF a record
    f = open(p, "a")
    f.write('{"kind": "commit", "query_id": "q_aa", "fragm')
    f.flush()

    states = QueryJournal.replay(p)
    assert states["q_aa"].state == "INFLIGHT"
    assert states["q_aa"].commits == {1: {0: "t0"}}

    # the writer completes the line + adds one more record: a SECOND
    # snapshot read picks both up (replay is a pure function of the bytes
    # present at stat time)
    f.write('ent": 1, "part": 1, "task_id": "t1"}\n')
    f.write(json.dumps({"kind": "finish", "query_id": "q_aa",
                        "state": "FINISHED", "error": None,
                        "error_code": None}) + "\n")
    f.flush()
    f.close()
    states2 = QueryJournal.replay(p)
    assert states2["q_aa"].state == "FINISHED"
    assert states2["q_aa"].commits == {1: {0: "t0", 1: "t1"}}


# ------------------------------------------------- client endpoint failover


class _StubCoordinator:
    """Minimal /v1/statement server: answers every POST with a complete
    inline result — enough to witness the client's endpoint failover."""

    def __init__(self):
        outer = self

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                self.rfile.read(n)
                outer.hits += 1
                body = json.dumps({
                    "id": "q_stub", "columns": ["one"], "data": [[1]],
                    "stats": {"state": "FINISHED"},
                }).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.hits = 0
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self._t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._t.start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def test_client_endpoint_list_failover():
    stub = _StubCoordinator()
    # a port from a server we already closed: guaranteed refused
    probe = ThreadingHTTPServer(("127.0.0.1", 0), BaseHTTPRequestHandler)
    dead_url = f"http://127.0.0.1:{probe.server_address[1]}"
    probe.server_close()
    try:
        sc = StatementClient([dead_url, stub.url])
        assert sc.endpoints == [dead_url, stub.url]
        cols, rows = sc.execute("select 1")
        assert rows == [[1]] and stub.hits == 1
    finally:
        stub.stop()


# ------------------------------------------------------------- cluster tier


def _fleet_cluster(conn, spool_dir):
    runner = DistributedQueryRunner(
        device="cpu", num_workers=2, default_catalog="memory", heartbeat_interval=0.3,
        num_coordinators=2, fleet_ttl_s=1.5,
    )
    runner.register_catalog("memory", conn)
    runner.start()
    for c in runner.coordinators:
        c.session.set("retry_policy", "TASK")
        c.session.set("exchange_spool_dir", spool_dir)
        c.session.set("resume_policy", "RESUME")
    return runner


class _ClientThread(threading.Thread):
    """One protocol client riding a query across the coordinator kill."""

    def __init__(self, url, sql):
        super().__init__(daemon=True)
        self.client = StatementClient(url, reattach_max_elapsed_s=90.0)
        self.sql = sql
        self.result = None
        self.error = None

    def run(self):
        try:
            self.result = self.client.execute(self.sql, timeout=120)
        except Exception as e:  # re-raised on the main thread by the test
            self.error = e


@pytest.mark.slow
@pytest.mark.chaos
def test_router_shards_and_serves_two_coordinators(tmp_path):
    conn = MemoryConnector()
    expect = _make_tables(conn)
    runner = _fleet_cluster(conn, str(tmp_path / "spool"))
    try:
        # queries through the router land on the coordinator the minted
        # id hashes to — and return correct rows through URL rewriting
        for _ in range(4):
            rows = runner.query_via_protocol(JOIN_SQL)
            assert int(rows[0][0]) == expect
        owners = {i: 0 for i in range(2)}
        for i, c in enumerate(runner.coordinators):
            with c._lock:
                for qid in c.queries:
                    owners[i] += 1
                    assert shard_for(qid, 2) == i, (
                        f"{qid} landed off-shard on c{i}"
                    )
        assert sum(owners.values()) >= 4
        # both members lease-visible and one GC owner fleet-wide
        infos = [c.fleet.info() for c in runner.coordinators]
        assert [i["gc_owner"] for i in infos].count(True) == 1
        assert all(len(i["members"]) == 2 for i in infos)
    finally:
        runner.stop()


@pytest.mark.slow
@pytest.mark.chaos
def test_kill_one_of_two_adoption_zero_recompute(tmp_path, scans):
    """The tentpole: kill the coordinator that owns a gated multi-stage
    join after its build side spool-COMMITTED.  The survivor must adopt
    the query off the dead member's journal, re-read (not recompute) the
    committed build stage, and the client — polling through the router —
    must see ZERO failures."""
    conn = GatedMemoryConnector()
    expect = _make_tables(conn)
    spool = str(tmp_path / "spool")
    runner = _fleet_cluster(conn, spool)
    try:
        conn.gated_table = "probe"
        t = _ClientThread(runner.client_url, JOIN_SQL)
        t.start()
        ready = _wait(
            lambda: _committed_dirs(spool) and conn.reads.get("probe", 0) > 0,
            timeout=60,
        )
        assert ready, "build stage never committed / probe never started"

        owner = None
        for i, c in enumerate(runner.coordinators):
            with c._lock:
                if any(not r["done"].is_set() for r in c.queries.values()):
                    owner = i
        assert owner is not None, "no coordinator owns the in-flight query"
        builds_before = conn.reads.get("build", 0)
        assert builds_before > 0
        build_scans = scans["build"]

        runner.kill_coordinator(owner)
        conn.gate.set()
        t.join(timeout=120)
        assert not t.is_alive(), "client never finished after the kill"
        assert t.error is None, f"client saw a failure: {t.error!r}"
        _, rows = t.result
        assert int(rows[0][0]) == expect

        # profiler-witnessed zero recompute: the spool-committed build
        # stage was re-read, not re-run
        assert conn.reads.get("build", 0) == builds_before
        assert scans["build"] == build_scans

        survivor = runner.coordinators[1 - owner]
        with survivor._lock:
            adopted = [
                (qid, rec) for qid, rec in survivor.queries.items()
                if rec.get("adopted_from")
            ]
        assert adopted, "survivor never adopted the dead member's query"
        qid, rec = adopted[0]
        fleet_info = (rec.get("query_info") or {}).get("fleet") or {}
        assert fleet_info.get("adopted")
        assert fleet_info.get("adopted_from") == f"c{owner}"
        assert fleet_info.get("stages_resumed", 0) >= 1

        # observability: adoption + lease expiry counters moved, and the
        # survivor's /metrics carries them
        body = urllib.request.urlopen(
            f"{survivor.url}/metrics", timeout=10
        ).read().decode()
        adoption_lines = [
            ln for ln in body.splitlines()
            if ln.startswith("trino_tpu_fleet_adoptions_total")
            and not ln.startswith("#")
        ]
        assert adoption_lines and float(adoption_lines[0].split()[-1]) >= 1
        assert 'trino_tpu_fleet_lease_transitions_total{event="expire"}' in body
    finally:
        conn.gate.set()
        runner.stop()


# ------------------------------------------- router failover-response audit


def _static_backend(code, body=b"{}", headers=None):
    """One fake coordinator that answers every request with a fixed
    verdict — the router's failover contract is tested against it."""

    class H(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def _go(self):
            self.send_response(code)
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        do_GET = do_POST = do_DELETE = _go

    srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def test_router_midpoll_502_fails_over_and_counts_retry():
    """A member mid-teardown answers a poll with 502: the router must try
    the peer (the query may have been adopted), count the hop in
    trino_tpu_fleet_router_retries_total, and the client sees only the
    peer's 200."""
    from trino_tpu_torch.runtime.fleet import FLEET_ROUTER_RETRIES

    bad_srv, bad = _static_backend(502, b'{"error": "teardown"}')
    ok_srv, ok = _static_backend(200, b'{"ok": true}')
    # a query id whose shard OWNER is the 502 member, so the poll hits the
    # bad coordinator first and must fail over
    qid = next(q for q in (f"q_{i}" for i in range(100))
               if shard_for(q, 2) == 0)
    router = FleetRouter([bad, ok]).start()
    try:
        before = FLEET_ROUTER_RETRIES.value()
        with urllib.request.urlopen(
            f"{router.url}/v1/statement/{qid}/0", timeout=10
        ) as r:
            assert r.status == 200 and b"ok" in r.read()
        assert FLEET_ROUTER_RETRIES.value() == before + 1
    finally:
        router.stop()
        bad_srv.shutdown()
        ok_srv.shutdown()


def test_router_unanimous_502_passes_through_with_retry_after():
    """Every member says 502: transient, pass it through — and the reply
    MUST carry Retry-After even though no backend set one (the router's
    failover-response contract: every 429/502/503 tells the client when
    to come back)."""
    b0_srv, b0 = _static_backend(502, b'{"error": "x"}')
    b1_srv, b1 = _static_backend(502, b'{"error": "x"}')
    router = FleetRouter([b0, b1]).start()
    try:
        req = urllib.request.Request(f"{router.url}/v1/statement/q_ab/0")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10)
        assert ei.value.code == 502
        assert ei.value.headers.get("Retry-After") == "1"
    finally:
        router.stop()
        b0_srv.shutdown()
        b1_srv.shutdown()


@pytest.mark.parametrize("code", [429, 503])
def test_router_injects_retry_after_on_bare_shed(code):
    """A backend that sheds (429) or is mid-adoption (503) WITHOUT a
    Retry-After hint: the router adds its 1s default instead of silently
    dropping the backpressure signal; a backend-set value passes through
    untouched."""
    srv, url = _static_backend(code, b'{"error": "busy"}')
    srv2, url2 = _static_backend(code, b'{"error": "busy"}',
                                 headers={"Retry-After": "7"})
    for backend_srv, backend, want in ((srv, url, "1"), (srv2, url2, "7")):
        router = FleetRouter([backend]).start()
        try:
            req = urllib.request.Request(
                f"{router.url}/v1/statement/q_cd/0"
            )
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(req, timeout=10)
            assert ei.value.code == code
            assert ei.value.headers.get("Retry-After") == want
        finally:
            router.stop()
    srv.shutdown()
    srv2.shutdown()


@pytest.mark.slow
@pytest.mark.chaos
def test_adoption_consults_commit_marker_never_double_applies(tmp_path):
    """Write-plane adoption guard (runtime/txn.py): a peer adopting a dead
    member's journaled in-flight INSERT must consult the commit marker
    before RESUME.  The dead member committed but never acked — the
    adopter replays the write as a NO-OP, and the row-count oracle proves
    the insert applied exactly once across the whole failover."""
    from trino_tpu_torch.runtime.txn import TXN_TOTAL

    conn = MemoryConnector()
    conn.create_table(
        "t", [ColumnSchema("k", BIGINT), ColumnSchema("v", BIGINT)]
    )
    conn.insert("t", {"k": np.arange(6, dtype=np.int64),
                      "v": np.arange(6, dtype=np.int64) * 10})
    runner = _fleet_cluster(conn, str(tmp_path / "spool"))
    try:
        c0 = runner.coordinators[0]
        noop0 = TXN_TOTAL.value("replayed_noop")
        # crash c0 at the committed-unacked boundary of the INSERT
        runner.inject_write_failure(phase="ack", coordinator_index=0)

        def _go():
            try:
                c0.execute_query("insert into t select k + 100, v from t")
            except Exception:
                pass  # the dying coordinator returns nothing useful

        threading.Thread(target=_go, daemon=True).start()
        assert _wait(lambda: c0._killed), "COMMIT_CRASH never fired"
        # oracle BEFORE adoption: the connector commit landed (6 -> 12)
        assert _wait(lambda: conn.estimated_row_count("t") == 12)
        # the survivor adopts off c0's expired lease and replays the
        # intent against the commit marker — a re-execution would land a
        # THIRD copy of the rows
        c1 = runner.coordinators[1]
        assert _wait(
            lambda: TXN_TOTAL.value("replayed_noop") == noop0 + 1,
            timeout=30,
        ), "adopter never replayed the write as a no-op"
        adopted = [
            rec for rec in c1.queries.values() if rec.get("adopted_from")
        ]
        assert adopted, "survivor never adopted the peer's query"
        assert _wait(lambda: adopted[0]["done"].is_set())
        assert adopted[0]["sm"].state == "FINISHED"
        assert adopted[0]["result"] == [(6,)]
        # oracle AFTER adoption: exactly-once — still 12, never 18
        assert conn.estimated_row_count("t") == 12
        # the adopter re-journaled the peer's marker: a second failover
        # would ALSO no-op off the adopter's own journal
        adopted_jq = QueryJournal.replay(c1.fleet.journal_path_for())
        qid = next(iter(
            q for q in adopted_jq.values() if q.write_commits
        ))
        assert qid.write_commits and qid.state == "FINISHED"
    finally:
        runner.stop()
