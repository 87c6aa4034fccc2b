"""The port cluster's observability plane: distributed EXPLAIN ANALYZE with
every stage annotated, QueryInfo at /v1/query/{id}, Prometheus /metrics on
the coordinator and the workers, W3C trace propagation from the query span
to the worker task spans, enriched completion events and the JSON explain
format.  Ports of the cluster cases of tests/test_obs_plane.py, every task
on the CPU."""

import json
import re
import urllib.request

import pytest

try:  # arrow before torch: loaded after it, arrow's parquet writer crashes the process
    import pyarrow  # noqa: F401
except ImportError:
    pass
import torch

torch.set_num_threads(1)

# Prometheus text exposition 0.0.4: `name{label="v",...} value`
_SAMPLE_RE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="[^"]*")*\})? [^ ]+$'
)


def _assert_prometheus_parses(text: str) -> dict:
    samples = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        assert _SAMPLE_RE.match(line), f"bad exposition line: {line!r}"
        name_part, value = line.rsplit(" ", 1)
        samples[name_part] = float(value)
    return samples


@pytest.fixture(scope="module")
def cluster():
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.testing import DistributedQueryRunner

    runner = DistributedQueryRunner(num_workers=3, device="cpu")
    runner.register_catalog("tpch", TpchConnector(0.01))
    runner.start()
    yield runner
    runner.stop()


ANALYZE_SQL = (
    "explain analyze select l_returnflag, count(*) c from lineitem "
    "where l_quantity < 30 group by l_returnflag order by c desc"
)


def test_distributed_explain_analyze_all_stages_annotated(cluster):
    text = "\n".join(r[0] for r in cluster.query(ANALYZE_SQL))
    frags = [ln for ln in text.splitlines() if ln.startswith("Fragment")]
    assert len(frags) >= 2, text  # the root and the worker stages
    # every operator line of every stage carries rows and eager ms
    for ln in text.splitlines():
        if ln.startswith(("Fragment", "--")) or not ln.strip():
            continue
        assert "[rows: " in ln, f"stats-less operator line: {ln!r}"
        assert " ms]" in ln, f"un-timed operator line: {ln!r}"
    assert "slowest operator:" in text and "cluster cpu:" in text
    assert any("wall:" in f for f in frags[1:])
    # the compile footer says what the port compiles (nothing on the CPU)
    assert "-- compile: none" in text


def test_query_info_endpoint(cluster):
    cluster.query("select count(*) from orders")
    qid = list(cluster.coordinator.queries)[-1]
    with urllib.request.urlopen(f"{cluster.coordinator.url}/v1/query/{qid}") as r:
        info = json.loads(r.read())
    assert info["state"] == "FINISHED"
    assert info["stage_count"] >= 2 and info["cpu_ms"] > 0
    for stage in info["stages"]:
        assert stage["operators"], f"stage {stage['stage_id']} has no stats"
        for s in stage["operators"].values():
            assert s["rows"] >= 0 and s["invocations"] >= 1
    worker_tasks = [
        t for st in info["stages"] for t in st["tasks"] if t["worker"] != "coordinator"
    ]
    assert worker_tasks and all(t["wall_ms"] is not None for t in worker_tasks)
    # the scan stage counted every orders row once over its three tasks
    scans = [
        s["rows"] for st in info["stages"] for s in st["operators"].values()
        if s["operator"] == "TableScan"
    ]
    assert scans == [15000]


def test_metrics_endpoints_parse_and_counters_move(cluster):
    def scrape(url):
        with urllib.request.urlopen(f"{url}/metrics") as r:
            assert r.headers["Content-Type"].startswith("text/plain")
            return _assert_prometheus_parses(r.read().decode())

    before = scrape(cluster.coordinator.url)
    cluster.query("select count(*) from region")
    after = scrape(cluster.coordinator.url)
    fin = 'trino_tpu_queries_total{state="FINISHED"}'
    assert after.get(fin, 0) == before.get(fin, 0) + 1
    assert after["trino_tpu_tasks_dispatched_total"] > before.get(
        "trino_tpu_tasks_dispatched_total", 0)
    assert after["trino_tpu_query_seconds_count"] >= 1
    wsamples = scrape(cluster.workers[0].url)
    assert wsamples['trino_tpu_worker_tasks_total{event="finished"}'] >= 1
    assert "trino_tpu_exchange_served_bytes_total" in wsamples
    # process-global families ride along on every scrape: the per-fragment
    # execute ledger the workers feed (utils/profiler.py)
    assert wsamples["trino_tpu_execute_seconds_count"] >= 1


def test_trace_propagates_coordinator_to_workers(cluster):
    from trino_tpu_torch.utils.tracing import InMemorySpanExporter

    wexps = []
    for w in cluster.workers:
        exp = InMemorySpanExporter()
        w.tracer.add_exporter(exp)
        wexps.append(exp)
    cexp = InMemorySpanExporter()
    cluster.coordinator.tracer.add_exporter(cexp)
    try:
        cluster.query("select count(*) from nation")
    finally:
        cluster.coordinator.tracer._exporters.clear()
        for w in cluster.workers:
            w.tracer._exporters.clear()
    (qspan,) = [s for s in cexp.snapshot() if s.name == "query"]
    task_spans = [s for exp in wexps for s in exp.snapshot() if s.name == "task"]
    assert task_spans, "no worker task spans exported"
    assert all(s.trace_id == qspan.trace_id for s in task_spans)
    assert all(s.parent_id == qspan.span_id for s in task_spans)


def test_coordinator_events_enriched(cluster):
    events = []
    cluster.coordinator.add_event_listener(events.append)
    try:
        cluster.query("select count(*) from region")
    finally:
        cluster.coordinator.events._listeners.clear()
    assert [e.kind for e in events] == ["created", "completed"]
    done = events[-1]
    assert done.rows == 1 and done.wall_s > 0
    assert done.stage_count >= 2 and done.cpu_ms > 0


def test_explain_format_json_session_property(cluster):
    coord = cluster.coordinator
    coord.session.set("explain_format", "json")
    try:
        obj = json.loads(cluster.query("explain select count(*) from region")[0][0])
        assert obj["operator"] and isinstance(obj["children"], list)
        info = json.loads(
            cluster.query("explain analyze select count(*) from region")[0][0])
        assert info["stage_count"] >= 2
        assert all(st["operators"] for st in info["stages"])
    finally:
        coord.session.set("explain_format", "text")


def test_ui_has_wall_and_state_age_columns(cluster):
    with urllib.request.urlopen(f"{cluster.coordinator.url}/ui") as r:
        page = r.read().decode()
    assert "wall (s)" in page and "in state (s)" in page
    assert "seen (s)" in page
