"""StatementClient: submit SQL, follow nextUri until results.

Reference: client/trino-client/.../StatementClientV1.java:76 (POST
/v1/statement at :154, advance() polling nextUri at :391)."""

from __future__ import annotations

import json
import time
import urllib.request
from typing import Optional, Sequence, Union
from urllib.parse import quote, urlsplit

__all__ = ["StatementClient", "QueryFailed"]


class QueryFailed(Exception):
    # typed failure reason from the protocol (errorCode), when the server
    # attached one — e.g. EXCEEDED_TIME_LIMIT from the deadline watchdog
    error_code: Optional[str] = None


class StatementClient:
    def __init__(
        self, server_url: Union[str, Sequence[str]],
        poll_interval: float = 0.05,
        spooled: bool = False, shed_retries: int = 0,
        reattach: bool = True, reattach_max_elapsed_s: float = 30.0,
        total_deadline_s: float = 0.0,
    ):
        """spooled=True advertises the SPOOLED result protocol (reference:
        client/spooling SegmentLoader): when the server has a spool
        configured, results come back as segment URIs fetched out-of-band
        (and acknowledged, releasing server storage) instead of inline.

        shed_retries > 0 makes submission retry up to that many times when
        the coordinator load-sheds with 429, sleeping the server-suggested
        Retry-After between attempts (reference: the client honoring
        TOO_MANY_REQUESTS backpressure instead of failing outright).

        reattach=True (default) rides nextUri polls through coordinator
        death: connection errors retry with decorrelated-jitter backoff
        for up to reattach_max_elapsed_s — a journaled coordinator restart
        resumes the query under the same id on the same port, so the poll
        that finally lands gets the live state, not a dead socket.

        server_url may be a LIST of endpoints (a coordinator fleet): the
        first is preferred for submission, and a connection-refused —
        submitting OR re-attaching — fails over to the others instead of
        retrying one dead host until reattach_max_elapsed_s expires.  A
        query adopted by a surviving coordinator answers the same
        /v1/statement/{qid}/... path there, so the failed-over poll lands
        on the live copy.

        total_deadline_s > 0 caps the CUMULATIVE seconds this client will
        sleep across every retry family — shed 429 Retry-After waits,
        re-attach backoff, fleet-adoption 429/503 waits.  Each family's
        own bound (shed_retries, reattach_max_elapsed_s) still applies;
        the total cap closes the gap where the families chain (shed, then
        reattach, then shed again) into an unbounded stall.  Exceeding it
        raises QueryFailed with error_code CLIENT_DEADLINE."""
        if isinstance(server_url, str):
            endpoints = [server_url]
        else:
            endpoints = list(server_url) or [""]
        self.endpoints = [u.rstrip("/") for u in endpoints]
        self.server_url = self.endpoints[0]
        self.poll_interval = poll_interval
        self.spooled = spooled
        self.shed_retries = shed_retries
        self.reattach = reattach
        self.reattach_max_elapsed_s = reattach_max_elapsed_s
        self.total_deadline_s = total_deadline_s
        self._retry_slept_s = 0.0  # cumulative retry sleep, all families
        # client-held prepared-statement registry (reference: ClientSession
        # preparedStatements): replayed on every request via the
        # X-Trino-Prepared-Statement header, updated from the terminal
        # response's addedPrepare / deallocatedPrepare deltas, so EXECUTE
        # works against a stateless (or restarted) coordinator
        self.prepared: dict[str, str] = {}
        self.last_query_id: Optional[str] = None

    def _retry_sleep(self, seconds: float) -> None:
        """Every retry-family sleep funnels through here so the cumulative
        cap (total_deadline_s) covers shed waits + re-attach backoff +
        adoption-window waits TOGETHER, not each family separately."""
        if self.total_deadline_s > 0:
            remaining = self.total_deadline_s - self._retry_slept_s
            if remaining <= 0:
                exc = QueryFailed(
                    f"client retry budget exhausted: slept "
                    f"{self._retry_slept_s:.1f}s across retries, "
                    f"total_deadline_s={self.total_deadline_s}"
                )
                exc.error_code = "CLIENT_DEADLINE"
                raise exc
            seconds = min(seconds, remaining)
        time.sleep(seconds)
        self._retry_slept_s += seconds

    def _post_statement(self, sql: str, headers: dict) -> dict:
        """POST /v1/statement, honoring 429 + Retry-After backpressure.
        With multiple endpoints, connection-refused fails over to the next
        one (HTTP verdicts — 429, 4xx, 5xx — do NOT fail over: the
        coordinator answered)."""
        attempt = 0
        while True:
            last_err: Optional[OSError] = None
            for base in self.endpoints:
                req = urllib.request.Request(
                    f"{base}/v1/statement", data=sql.encode(),
                    headers=headers,
                )
                try:
                    with urllib.request.urlopen(req, timeout=30) as r:
                        return json.loads(r.read())
                except urllib.error.HTTPError as e:
                    if e.code != 429 or attempt >= self.shed_retries:
                        raise
                    attempt += 1
                    try:
                        delay = float(e.headers.get("Retry-After") or 1)
                    except ValueError:
                        delay = 1.0
                    e.read()  # drain the shed response before re-posting
                    self._retry_sleep(delay)
                    last_err = None
                    break  # re-post to the SAME endpoint after the shed
                except OSError as e:
                    last_err = e
                    continue  # dead endpoint: try the next one
            if last_err is not None:
                raise last_err

    def _fetch_segments(self, state: dict) -> list[list]:
        rows: list[list] = []
        for seg in state["segments"]:
            with urllib.request.urlopen(seg["uri"], timeout=60) as r:
                rows.extend(json.loads(r.read()))
            ack = urllib.request.Request(seg["uri"], method="DELETE")
            try:
                urllib.request.urlopen(ack, timeout=10).close()
            except Exception:
                pass  # best-effort release; server GC covers the rest
        return rows

    def _poll_failover(self, next_uri: str) -> Optional[dict]:
        """Try the dead nextUri's PATH against the other endpoints — a
        fleet survivor that adopted the query serves the same
        /v1/statement/{qid}/... there.  Returns the new poll state (whose
        nextUri re-pins to the live coordinator) or None."""
        parts = urlsplit(next_uri)
        suffix = parts.path + (f"?{parts.query}" if parts.query else "")
        origin = f"{parts.scheme}://{parts.netloc}"
        for base in self.endpoints:
            if base == origin:
                continue  # that is the host that just refused
            try:
                with urllib.request.urlopen(base + suffix, timeout=30) as r:
                    return json.loads(r.read())
            except urllib.error.HTTPError:
                continue  # 404 from a non-owner: keep looking
            except OSError:
                continue
        return None

    def _apply_prepared_deltas(self, state: dict) -> None:
        for name, text in (state.get("addedPrepare") or {}).items():
            self.prepared[name] = text
        for name in state.get("deallocatedPrepare") or ():
            self.prepared.pop(name, None)

    def execute(self, sql: str, timeout: float = 600.0) -> tuple[list[str], list[list]]:
        """-> (column_names, rows)"""
        headers = {"X-Trino-Spooled": "1"} if self.spooled else {}
        if self.prepared:
            headers["X-Trino-Prepared-Statement"] = ",".join(
                f"{quote(n)}={quote(s)}" for n, s in self.prepared.items()
            )
        state = self._post_statement(sql, headers)
        # the fleet router shards by this id (runtime/fleet.py shard_for);
        # callers attribute the query to a member through it
        self.last_query_id = state.get("id")
        deadline = time.time() + timeout
        backoff = None  # live only across a re-attach streak
        while True:
            if "segments" in state:
                self._apply_prepared_deltas(state)
                return state.get("columns", []), self._fetch_segments(state)
            if "data" in state:
                self._apply_prepared_deltas(state)
                return state.get("columns", []), state["data"]
            if state.get("stats", {}).get("state") == "FAILED":
                exc = QueryFailed(state.get("error", "query failed"))
                # typed reason (EXCEEDED_TIME_LIMIT, ...) for callers that
                # branch on failure class
                exc.error_code = state.get("errorCode")
                raise exc
            next_uri = state.get("nextUri")
            if next_uri is None:
                raise QueryFailed(f"no nextUri and no data: {state}")
            if time.time() > deadline:
                raise TimeoutError(f"query did not finish in {timeout}s")
            time.sleep(self.poll_interval)
            try:
                with urllib.request.urlopen(next_uri, timeout=30) as r:
                    state = json.loads(r.read())
                backoff = None  # healthy poll resets the re-attach streak
            except urllib.error.HTTPError as e:
                # HTTPError subclasses OSError: handle it FIRST.  410 GONE
                # is the typed resume_policy=FAIL refusal after a restart
                if e.code == 410:
                    try:
                        detail = json.loads(e.read() or b"{}")
                    except ValueError:
                        detail = {}
                    exc = QueryFailed(
                        detail.get("error")
                        or "query abandoned by coordinator restart"
                    )
                    exc.error_code = detail.get("errorCode")
                    raise exc
                if e.code in (429, 503) and self.reattach:
                    # transient by contract: load shedding, or the fleet
                    # router bridging an adoption window (a dead member's
                    # query isn't answerable until a peer replays its
                    # journal).  Honor Retry-After, bounded by the same
                    # re-attach clock as connection failures.
                    if backoff is None:
                        from ..runtime.failure import Backoff

                        backoff = Backoff(
                            min_delay=0.1, max_delay=2.0,
                            max_elapsed=self.reattach_max_elapsed_s,
                            decorrelated=True,
                        )
                    if backoff.failure():
                        raise
                    retry_after = e.headers.get("Retry-After")
                    if retry_after:
                        self._retry_sleep(min(float(retry_after), 2.0))
                    else:
                        self._retry_sleep(backoff.delay())
                    continue
                raise
            except OSError:
                # coordinator death mid-poll: re-attach through Backoff
                # (reference: the task-status fetcher retrying through
                # Backoff before declaring the peer dead)
                if not self.reattach:
                    raise
                # fleet failover first: a surviving endpoint that adopted
                # the query answers NOW — no backoff spent on the corpse
                alt = self._poll_failover(next_uri)
                if alt is not None:
                    state = alt
                    backoff = None
                    continue
                if backoff is None:
                    from ..runtime.failure import Backoff

                    # decorrelated: a mass re-attach after a coordinator
                    # death must not arrive at the survivor in waves
                    backoff = Backoff(
                        min_delay=0.1, max_delay=2.0,
                        max_elapsed=self.reattach_max_elapsed_s,
                        decorrelated=True,
                    )
                if backoff.failure():
                    raise
                self._retry_sleep(backoff.delay())

    def submit(self, sql: str) -> str:
        """Fire-and-return: the query id (poll or cancel it later)."""
        return self._post_statement(sql, {})["id"]

    def cancel(self, query_id: str) -> bool:
        """Reference: StatementClient close() -> DELETE nextUri."""
        req = urllib.request.Request(
            f"{self.server_url}/v1/statement/{query_id}", method="DELETE"
        )
        with urllib.request.urlopen(req, timeout=10) as r:
            return json.loads(r.read()).get("canceled", False)

    def query_state(self, query_id: str) -> str:
        # state-only endpoint: polling never ships the result payload
        with urllib.request.urlopen(
            f"{self.server_url}/v1/query/{query_id}/state", timeout=10
        ) as r:
            return json.loads(r.read()).get("state", "UNKNOWN")

    def server_info(self) -> dict:
        with urllib.request.urlopen(f"{self.server_url}/v1/info", timeout=10) as r:
            return json.loads(r.read())
