"""Coordinator fleet: leased shared state + the front-door router.

Reference shape: the dispatcher/coordinator split (PAPER L4/L7; Trino's
disaggregated-coordinator work — DispatchManager in front of N
coordinators sharing external state).  Two pieces live here:

- ``FleetMember``: one coordinator's handle on the shared fleet directory.
  Each member owns a heartbeat-renewed *epoch lease* file
  (``lease-{id}.json``, atomic tmp+rename writes) embedding its live query
  ids, so peers can compute the fleet-wide live-query union from lease
  files alone — that union is what gates spool GC and orphan-task sweeps
  (two coordinators must never double-delete).  A member whose lease
  expired is adopted by exactly one survivor: the adoption *claim* is an
  ``O_CREAT|O_EXCL`` file keyed by the dead member's id AND epoch, so two
  survivors racing to adopt resolve to one winner per incarnation and a
  restarted coordinator (new epoch) is never mistaken for the corpse.

- ``FleetRouter``: the front door.  Shards admission by query-id hash
  across member coordinators (the id is minted HERE and forwarded via
  ``X-Trino-Query-Id`` so the shard is stable for the query's whole
  life), retries admission on the next member when one is dead, passes
  429/503 backpressure through verbatim (Retry-After intact), and
  rewrites coordinator URLs in response bodies to its own so clients only
  ever see the router.  Poll/cancel/result paths proxy to the sharded
  owner first and fail over to the other members — after an adoption the
  query answers from the adopter, and the client never sees the failover.

Journal namespacing: in fleet mode each coordinator journals to
``{fleet_dir}/journal-{id}.jsonl`` (``journal_path_for``); the adopter
replays the dead peer's file with the snapshot-reading
``QueryJournal.replay`` and resumes through the journal's RESUME path, so
spool-COMMITTED stages are re-read, never recomputed.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
import urllib.error
import urllib.request
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Iterable, Optional

from ..utils import metrics as _metrics

__all__ = ["FleetMember", "FleetRouter", "shard_for"]

# registered at import (coordinator.py imports this module unconditionally)
# so every /metrics scrape carries the families + HELP even on a
# single-coordinator deployment that never transitions a lease
FLEET_LEASE_TRANSITIONS = _metrics.GLOBAL.counter(
    "trino_tpu_fleet_lease_transitions_total",
    "Coordinator fleet lease lifecycle events (acquire / renew_lost / "
    "expire observed / steal / release)",
    ("event",),
)
FLEET_ADOPTIONS = _metrics.GLOBAL.counter(
    "trino_tpu_fleet_adoptions_total",
    "In-flight queries adopted from an expired peer coordinator's journal",
)
FLEET_ROUTER_RETRIES = _metrics.GLOBAL.counter(
    "trino_tpu_fleet_router_retries_total",
    "Requests the fleet router retried on another coordinator after the "
    "preferred one refused the connection",
)

_LEASE_PREFIX = "lease-"


def shard_for(query_id: str, n: int) -> int:
    """Stable query-id -> coordinator shard (sha1, not hash(): Python's
    string hash is per-process salted and the router + tests + a restarted
    router must all agree)."""
    if n <= 0:
        return 0
    digest = hashlib.sha1(query_id.encode()).hexdigest()
    return int(digest, 16) % n


class FleetMember:
    """One coordinator's lease + adoption protocol over a shared dir."""

    def __init__(
        self,
        fleet_dir: str,
        coordinator_id: Optional[str] = None,
        url: str = "",
        ttl_s: float = 10.0,
        clock=time.time,
    ):
        self.dir = fleet_dir
        os.makedirs(fleet_dir, exist_ok=True)
        self.coordinator_id = coordinator_id or f"c{uuid.uuid4().hex[:8]}"
        self.url = url
        self.ttl_s = float(ttl_s)
        self.epoch = 0
        self._clock = clock
        self._lock = threading.Lock()
        # peer epochs whose expiry we already counted (one expire event per
        # incarnation, not one per sweep)
        self._seen_expired: set[tuple[str, int]] = set()

    # ------------------------------------------------------------- lease io
    def _lease_path(self, cid: str) -> str:
        return os.path.join(self.dir, f"{_LEASE_PREFIX}{cid}.json")

    def journal_path_for(self, cid: Optional[str] = None) -> str:
        return os.path.join(
            self.dir, f"journal-{cid or self.coordinator_id}.jsonl"
        )

    def history_path(self) -> str:
        return os.path.join(self.dir, "history.jsonl")

    def _read_lease(self, path: str) -> Optional[dict]:
        try:
            with open(path, "r", encoding="utf-8") as f:
                return json.loads(f.read())
        except (OSError, ValueError):
            return None  # mid-rename or torn: treat as absent this sweep

    def _write_lease(self, lease: dict) -> None:
        """Atomic publish: full tmp write + rename, so a concurrent reader
        never sees a half-written lease (same idiom as the spool commit)."""
        path = self._lease_path(lease["coordinator_id"])
        tmp = f"{path}.tmp-{self.coordinator_id}"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(json.dumps(lease))
        os.replace(tmp, path)

    # ------------------------------------------------------------ lifecycle
    def acquire(self) -> int:
        """Take (or take OVER) this id's lease: the epoch bumps past any
        prior incarnation's, so claim files and journal replays of the old
        epoch can never be confused with the new process."""
        with self._lock:
            prior = self._read_lease(self._lease_path(self.coordinator_id))
            prior_epoch = int((prior or {}).get("epoch") or 0)
            now = self._clock()
            stolen = bool(prior) and float(prior.get("expires_ts") or 0) > now
            self.epoch = prior_epoch + 1
            self._write_lease({
                "coordinator_id": self.coordinator_id,
                "url": self.url,
                "epoch": self.epoch,
                "expires_ts": now + self.ttl_s,
                "live_queries": [],
            })
        FLEET_LEASE_TRANSITIONS.labels("steal" if stolen else "acquire").inc()
        return self.epoch

    def renew(self, live_queries: Iterable[str] = ()) -> bool:
        """Heartbeat renewal, embedding the member's live query ids.
        Returns False (and records renew_lost) when the on-disk lease shows
        a HIGHER epoch — another process took this identity over and this
        one must stop acting as an owner (no GC, no adoption)."""
        with self._lock:
            current = self._read_lease(self._lease_path(self.coordinator_id))
            if current and int(current.get("epoch") or 0) > self.epoch:
                FLEET_LEASE_TRANSITIONS.labels("renew_lost").inc()
                return False
            self._write_lease({
                "coordinator_id": self.coordinator_id,
                "url": self.url,
                "epoch": self.epoch,
                "expires_ts": self._clock() + self.ttl_s,
                "live_queries": sorted(set(live_queries)),
            })
        return True

    def release(self) -> None:
        """Graceful shutdown: drop the lease so peers neither wait out the
        TTL nor adopt queries that finished cleanly."""
        try:
            os.unlink(self._lease_path(self.coordinator_id))
        except OSError:
            pass
        FLEET_LEASE_TRANSITIONS.labels("release").inc()

    # ---------------------------------------------------------------- peers
    def leases(self) -> list[dict]:
        """Every lease file in the fleet dir, own included."""
        out = []
        try:
            names = os.listdir(self.dir)
        except OSError:
            return out
        for name in sorted(names):
            if not (name.startswith(_LEASE_PREFIX) and name.endswith(".json")):
                continue
            lease = self._read_lease(os.path.join(self.dir, name))
            if lease and lease.get("coordinator_id"):
                out.append(lease)
        return out

    def peers(self) -> list[dict]:
        return [
            l for l in self.leases()
            if l["coordinator_id"] != self.coordinator_id
        ]

    def expired_peers(self, now: Optional[float] = None) -> list[dict]:
        """Peers whose lease ran out and whose incarnation has not been
        adopted yet — the adoption candidates.  Counts one ``expire`` per
        (peer, epoch) observed."""
        now = self._clock() if now is None else now
        out = []
        for lease in self.peers():
            if float(lease.get("expires_ts") or 0) >= now:
                continue
            if lease.get("adopted_by"):
                continue
            key = (lease["coordinator_id"], int(lease.get("epoch") or 0))
            if key not in self._seen_expired:
                self._seen_expired.add(key)
                FLEET_LEASE_TRANSITIONS.labels("expire").inc()
            out.append(lease)
        return out

    def try_adopt(self, peer_lease: dict) -> bool:
        """Claim the right to adopt one dead incarnation.  The claim file
        is created O_CREAT|O_EXCL and keyed by (peer id, epoch): exactly
        one survivor wins per incarnation — the double-adopt race resolves
        at the filesystem, not by timing."""
        cid = peer_lease["coordinator_id"]
        epoch = int(peer_lease.get("epoch") or 0)
        claim = os.path.join(self.dir, f"{cid}.e{epoch}.adopted")
        try:
            fd = os.open(claim, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False  # another survivor won (or we already did)
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            f.write(json.dumps({
                "adopted_by": self.coordinator_id,
                "epoch": epoch,
                "ts": self._clock(),
            }))
        # mark the corpse's lease adopted so other survivors stop sweeping
        # it; its live queries stay listed until OUR next renew carries
        # them, keeping the GC union gap-free across the handoff
        marked = dict(peer_lease)
        marked["adopted_by"] = self.coordinator_id
        try:
            self._write_lease(marked)
        except OSError:
            pass  # claim already decides ownership; the mark is advisory
        return True

    # ------------------------------------------------------ fleet-wide view
    def is_gc_owner(self, now: Optional[float] = None) -> bool:
        """Single-owner election for destructive sweeps (spool GC, orphan
        task deletes): the member with the smallest id among UNEXPIRED
        leases.  Deterministic from the shared dir alone — no extra
        coordination channel, and a partitioned loser simply sees itself
        expired and stands down."""
        now = self._clock() if now is None else now
        alive = [
            l["coordinator_id"] for l in self.leases()
            if float(l.get("expires_ts") or 0) >= now
        ]
        return bool(alive) and min(alive) == self.coordinator_id

    def fleet_live_queries(self) -> set[str]:
        """Union of live query ids across EVERY lease file — expired and
        unadopted ones included, because their spool output is exactly what
        the imminent adoption must re-read."""
        live: set[str] = set()
        for lease in self.leases():
            live.update(lease.get("live_queries") or ())
        return live

    def info(self) -> dict:
        """Membership snapshot for /v1/info and the /ui fleet table."""
        now = self._clock()
        members = []
        for lease in self.leases():
            members.append({
                "coordinator_id": lease.get("coordinator_id"),
                "url": lease.get("url"),
                "epoch": lease.get("epoch"),
                "alive": float(lease.get("expires_ts") or 0) >= now,
                "adopted_by": lease.get("adopted_by"),
                "live_queries": len(lease.get("live_queries") or ()),
            })
        return {
            "coordinator_id": self.coordinator_id,
            "epoch": self.epoch,
            "gc_owner": self.is_gc_owner(now),
            "members": members,
        }


# hop-by-hop / recomputed headers the proxy must not forward verbatim
_SKIP_HEADERS = frozenset({
    "host", "content-length", "connection", "transfer-encoding",
})


class FleetRouter:
    """Front-door HTTP server sharding admission across coordinators."""

    def __init__(self, coordinator_urls: Iterable[str], port: int = 0):
        self.coordinators = [u.rstrip("/") for u in coordinator_urls]
        if not self.coordinators:
            raise ValueError("FleetRouter needs at least one coordinator")
        handler = _make_router_handler(self)
        self.httpd = ThreadingHTTPServer(("127.0.0.1", port), handler)
        self.port = self.httpd.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "FleetRouter":
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name="fleet-router", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is not None:
            # shutdown() handshakes with serve_forever; calling it on a
            # never-started server would block forever
            self.httpd.shutdown()
        self.httpd.server_close()

    # ----------------------------------------------------------- internals
    def order_for(self, query_id: Optional[str]) -> list[str]:
        """Preferred coordinator order: the query's shard first (stable by
        id hash), then the rest as failover targets — which is where an
        adopted query answers from after its shard died."""
        urls = list(self.coordinators)
        if query_id:
            k = shard_for(query_id, len(urls))
            urls = urls[k:] + urls[:k]
        return urls

    def rewrite(self, body: bytes) -> bytes:
        """Point coordinator-absolute URLs (nextUri, spooled segment uris)
        back at the router, so every subsequent hop re-enters the failover
        path instead of pinning the client to one backend."""
        for u in self.coordinators:
            body = body.replace(u.encode(), self.url.encode())
        return body


def _qid_from_path(path: str) -> Optional[str]:
    """Extract the query id from protocol paths the router proxies:
    /v1/statement/{qid}[/...], /v1/query/{qid}[/...], /v1/spooled/{qid}/…"""
    parts = path.split("?")[0].strip("/").split("/")
    if len(parts) >= 3 and parts[0] == "v1" and parts[1] in (
        "statement", "query", "spooled"
    ):
        return parts[2]
    return None


def _make_router_handler(router: FleetRouter):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):  # quiet
            pass

        def _reply(self, code: int, body: bytes, headers: dict) -> None:
            # failover-response contract: ANY backpressure/transient verdict
            # the router forwards or mints (shed 429s, adoption-window and
            # member-death 503s, mid-poll 502s) must tell the client WHEN to
            # come back — a backend that omitted Retry-After gets the
            # router's 1s default instead of silently dropping the hint
            if code in (429, 502, 503) and not any(
                k.lower() == "retry-after" for k in headers
            ):
                headers = dict(headers, **{"Retry-After": "1"})
            self.send_response(code)
            for k, v in headers.items():
                if k.lower() not in _SKIP_HEADERS:
                    self.send_header(k, v)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _proxy(self, body: Optional[bytes], extra_headers=None) -> None:
            qid = _qid_from_path(self.path)
            targets = router.order_for(qid)
            headers = {
                k: v for k, v in self.headers.items()
                if k.lower() not in _SKIP_HEADERS
            }
            headers.update(extra_headers or {})
            last_err: Optional[Exception] = None
            not_found = None
            bad_gateway = None
            for i, base in enumerate(targets):
                if i:
                    FLEET_ROUTER_RETRIES.inc()
                req = urllib.request.Request(
                    base + self.path, data=body, headers=headers,
                    method=self.command,
                )
                try:
                    with urllib.request.urlopen(req, timeout=30) as r:
                        self._reply(
                            r.status, router.rewrite(r.read()),
                            dict(r.headers),
                        )
                        return
                except urllib.error.HTTPError as e:
                    payload = e.read()
                    if e.code == 404 and qid and len(targets) > 1:
                        # the shard may have died and the query moved to
                        # its adopter — ask the other members before
                        # giving the client a 404
                        not_found = (e.code, payload, dict(e.headers))
                        continue
                    if e.code == 502 and len(targets) > 1:
                        # mid-poll Bad Gateway: a member mid-teardown (or a
                        # front proxy covering one) answered for a query a
                        # peer may still serve — treat it like a member
                        # death and try the others, counting the retry like
                        # any other failover hop; the LAST 502 passes
                        # through (with Retry-After, _reply's contract) only
                        # when every member gave the same answer
                        bad_gateway = (e.code, payload, dict(e.headers))
                        continue
                    # backpressure (429/503 + Retry-After) and every other
                    # coordinator verdict pass through verbatim
                    self._reply(e.code, router.rewrite(payload), dict(e.headers))
                    return
                except OSError as e:  # refused/reset: coordinator death
                    last_err = e
                    continue
            if bad_gateway is not None and last_err is None:
                # every member was asked and the best verdict is still a
                # 502: transient, pass it through (Retry-After added)
                code, payload, hdrs = bad_gateway
                self._reply(code, router.rewrite(payload), hdrs)
                return
            if not_found is not None and last_err is None:
                # every member answered and none knows the query: a real
                # 404, not a failover window — pass it through
                code, payload, hdrs = not_found
                self._reply(code, router.rewrite(payload), hdrs)
                return
            # a member is DEAD and the survivors don't know the query yet:
            # the adoption window.  503 + Retry-After keeps the client
            # polling until the adopter picks the query up off the dead
            # member's journal (client treats 503 as transient, not fatal)
            self._reply(
                503,
                json.dumps({"error": f"no coordinator reachable: {last_err}"})
                .encode(),
                {"Content-Type": "application/json", "Retry-After": "1"},
            )

        def do_POST(self):
            length = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(length) if length else b""
            if self.path.split("?")[0] == "/v1/statement":
                # mint the id HERE: the hash shard stays stable for the
                # query's whole life, and re-submits after failover land
                # on the same (or adopting) coordinator
                qid = f"q_{uuid.uuid4().hex[:12]}"
                k = shard_for(qid, len(router.coordinators))
                targets = (
                    router.coordinators[k:] + router.coordinators[:k]
                )
                headers = {
                    h: v for h, v in self.headers.items()
                    if h.lower() not in _SKIP_HEADERS
                }
                headers["X-Trino-Query-Id"] = qid
                last_err: Optional[Exception] = None
                for i, base in enumerate(targets):
                    if i:
                        FLEET_ROUTER_RETRIES.inc()
                    req = urllib.request.Request(
                        f"{base}/v1/statement", data=body, headers=headers,
                    )
                    try:
                        with urllib.request.urlopen(req, timeout=30) as r:
                            self._reply(
                                r.status, router.rewrite(r.read()),
                                dict(r.headers),
                            )
                            return
                    except urllib.error.HTTPError as e:
                        # 429/503 backpressure passes through: the FLEET
                        # is saturated; rerouting would just migrate the
                        # herd to the next coordinator
                        self._reply(
                            e.code, router.rewrite(e.read()), dict(e.headers)
                        )
                        return
                    except OSError as e:
                        last_err = e
                        continue
                self._reply(
                    503,
                    json.dumps(
                        {"error": f"no coordinator reachable: {last_err}"}
                    ).encode(),
                    {"Content-Type": "application/json", "Retry-After": "1"},
                )
                return
            self._proxy(body)

        def do_GET(self):
            if self.path.split("?")[0] == "/v1/router":
                self._reply(
                    200,
                    json.dumps({
                        "router": router.url,
                        "coordinators": router.coordinators,
                    }).encode(),
                    {"Content-Type": "application/json"},
                )
                return
            self._proxy(None)

        def do_DELETE(self):
            length = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(length) if length else None
            self._proxy(body)

        def do_PUT(self):
            length = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(length) if length else None
            self._proxy(body)

    return Handler
