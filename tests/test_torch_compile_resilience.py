"""The port's compile plane (exec/compilesvc.py, exec/capcache.py,
utils/compilecache.py): a counterpart of each of the 15 cases of
tests/test_compile_resilience.py, every query on the CPU.

The build the service runs is kernel 2's: on the card an NVRTC compile and
load per recipe, on the CPU the recipe's preparation (its generated source),
so these tests drive real build jobs through the service.  The fallback is
the unfused operator path, whose aggregates run on kernel 1's plain version.
Statements are fused-shaped (a VARCHAR key, DOUBLE values): kernel 2 takes
sums of doubles and decimals over dictionary keys.  Rows are held against
numpy.

Injected delays are events: a COMPILE_SLOW fault waits on a gate the test
opens when it is done with the pending build (`_gated`), and builds in the
service-level cases wait on events, so no case races the clock.  The
breaker's open windows run on an injected clock.

The reference's `test_aot_structure_mismatch_retraces_lazily` is XLA's: a
lazy retrace after a failed launch would be a hidden fallback, so its place
is taken by a test that a cubin cached under another architecture or NVRTC
release is never read.  Two more cases hold the capacity cache: a second
fresh engine re-runs nothing, and a partial entry is ignored.
"""

import json
import threading
import time

import numpy as np
import pytest

try:  # arrow before torch: loaded after it, arrow's parquet writer crashes the process
    import pyarrow  # noqa: F401
except ImportError:
    pass
import torch

from trino_tpu_torch.connectors.memory import MemoryConnector
from trino_tpu_torch.connectors.spi import ColumnSchema
from trino_tpu_torch.data.types import BIGINT, DOUBLE, VARCHAR
from trino_tpu_torch.exec.compilesvc import (
    COMPILE_DEDUP, COMPILE_TIMEOUTS, FALLBACKS, CompileService, SignatureBreaker,
)
from trino_tpu_torch.ops import kernels
from trino_tpu_torch.runtime.engine import Engine
from trino_tpu_torch.runtime.failure import FaultInjector, InjectedCompileFailure
from trino_tpu_torch.runtime.history import QueryHistoryStore
from trino_tpu_torch.utils.profiler import PROFILER, _PCACHE_EVENTS

torch.set_num_threads(1)

GROUP_SQL = "select k, sum(v) as s from t group by k order by k"


@pytest.fixture(autouse=True)
def _policy():
    saved = kernels.get_policy()
    yield
    kernels.set_policy(saved)


def _table(seed: int, n: int, groups: int = 16):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, groups, n)
    v = rng.integers(0, 100, n).astype(np.float64)
    return np.array([f"k{x:02d}" for x in k], dtype=object), v


def _connector(k, v) -> MemoryConnector:
    conn = MemoryConnector()
    conn.create_table("t", [ColumnSchema("k", VARCHAR), ColumnSchema("v", DOUBLE)])
    conn.insert("t", {"k": k, "v": v})
    return conn


def _sums(k, v, plus: float = 0.0):
    return [(key, float((v[k == key] + plus).sum())) for key in sorted(set(k.tolist()))]


def _make_engine(seed=0, n=4000):
    """Local engine over a seeded memory table, with a service of its own
    (no done-map or breaker shared with other tests), and GROUP_SQL's rows
    from numpy."""
    k, v = _table(seed, n)
    eng = Engine(device="cpu", default_catalog="mem")
    eng.register_catalog("mem", _connector(k, v))
    eng.executor.compile_service = CompileService()
    return eng, _sums(k, v)


def _gated(inj: FaultInjector) -> threading.Event:
    """COMPILE_SLOW faults of `inj` wait on the returned gate (at most their
    delay) instead of sleeping."""
    gate = threading.Event()
    plain = type(inj).compile_fault
    inj.compile_fault = lambda task_id, sleep=None: plain(inj, task_id, sleep=gate.wait)
    return gate


def _paths(eng, sql) -> set:
    return {op for op, _, _ in kernels.events_for(eng.plan(sql))}


# ----------------------------------------------------- fallback + swap-in


def test_budget_exhausted_falls_back_then_swaps_in_compiled():
    """Under a pending build and a small wait budget, a cold recipe's query
    returns correct rows through the unfused path (kernel 1) while the
    build is still blocked; once the build lands, the next execution runs
    kernel 2 with zero new fallbacks."""
    eng, expected = _make_engine(seed=0)
    eng.session.set("compile_wait_budget_ms", "50")
    inj = FaultInjector()
    inj.arm(task_id="*", mode="COMPILE_SLOW", delay_ms=60_000, count=1)
    gate = _gated(inj)
    eng.executor.fault_injector = inj
    fb0 = FALLBACKS.value("compile_wait")
    try:
        assert eng.query(GROUP_SQL) == expected
        assert not gate.is_set()  # the build is still pending: nothing waited it out
        assert ("COMPILE_SLOW", "local") in inj.fired
        assert _paths(eng, GROUP_SQL) == {"segment_reduce"}
        assert eng.executor.last_fallback_reason == "compile_wait"
        ev = eng.executor.fallback_events[-1]
        assert ev["mode"] == "fallback" and ev["reason"] == "compile_wait"
        assert eng.executor.compile_events[-1] == ev
        assert FALLBACKS.value("compile_wait") == fb0 + 1
        # the profiler ledger attributes the degraded execution apart
        snap = PROFILER.snapshot(ev["signature"])
        assert snap["fallback_executes"] >= 1
        assert snap["fallbacks"].get("compile_wait", 0) >= 1
    finally:
        gate.set()
    # the build finished in the background: it swaps in, no new fallback
    eng.executor.compile_service.drain(timeout_s=30)
    n_fallbacks = len(eng.executor.fallback_events)
    assert eng.query(GROUP_SQL) == expected
    assert "fused_pipeline" in _paths(eng, GROUP_SQL)
    assert len(eng.executor.fallback_events) == n_fallbacks
    swapped = eng.executor.compile_events[-1]
    assert swapped["mode"] == "async" and "reason" not in swapped


def test_explain_analyze_footer_names_fallback():
    eng, _ = _make_engine(seed=6, n=1000)
    eng.session.set("compile_wait_budget_ms", "20")
    inj = FaultInjector()
    inj.arm(task_id="*", mode="COMPILE_SLOW", delay_ms=60_000, count=1)
    gate = _gated(inj)
    eng.executor.fault_injector = inj
    try:
        lines = [r[0] for r in eng.execute(f"explain analyze {GROUP_SQL}")]
    finally:
        gate.set()
    compile_lines = [ln for ln in lines if ln.startswith("-- compile:")]
    assert any("fallback (compile_wait" in ln for ln in compile_lines), lines
    # and the footprint of the cubin cache (utils/compilecache.py)
    assert any(ln.startswith("-- compile cache: ") for ln in lines), lines
    eng.executor.compile_service.drain(timeout_s=30)


# --------------------------------------------------------- storm admission


def test_compile_storm_collapses_to_one_build():
    svc = CompileService(max_workers=4)
    dedup0 = COMPILE_DEDUP.value()
    release = threading.Event()

    def build():
        assert release.wait(30)
        return {"program": object()}

    key = ("storm-sig", "cuda", 0, ())
    results = []
    barrier = threading.Barrier(6)

    def go():
        barrier.wait()
        results.append(svc.obtain(key, "storm-sig", build))

    threads = [threading.Thread(target=go) for _ in range(6)]
    for t in threads:
        t.start()
    # release the build once the five joiners have joined it
    deadline = time.monotonic() + 30
    while COMPILE_DEDUP.value() < dedup0 + 5 and time.monotonic() < deadline:
        time.sleep(0.01)
    release.set()
    for t in threads:
        t.join()
    assert svc.builds == 1, "compile storm was not deduplicated"
    assert all(r.status == "ready" for r in results)
    assert len({id(r.result["program"]) for r in results}) == 1, "joiners got different programs"
    assert sum(1 for r in results if r.fresh) == 1
    assert COMPILE_DEDUP.value() == dedup0 + 5
    # the done-map serves later obtains without a new build
    assert svc.obtain(key, "storm-sig", build).status == "ready"
    assert svc.builds == 1


# -------------------------------------------------------------- deadlines


def test_compile_deadline_is_typed_and_never_hangs():
    svc = CompileService(max_workers=2)
    sig = "deadline-sig"
    t_before = COMPILE_TIMEOUTS.value()
    timeouts_before = (PROFILER.snapshot(sig) or {}).get("timeouts", 0)
    release = threading.Event()

    def build():
        assert release.wait(30)
        return "program"

    key = (sig, 1)
    out = svc.obtain(key, sig, build, wait_budget_s=None, deadline_s=0.1)
    # the build cannot finish before `release`: only the deadline ended the wait
    assert out.status == "timeout" and out.reason == "compile_timeout"
    assert not release.is_set()
    assert COMPILE_TIMEOUTS.value() == t_before + 1
    assert PROFILER.snapshot(sig)["timeouts"] == timeouts_before + 1
    # a late completion still lands for future swap-in
    release.set()
    svc.drain(timeout_s=10)
    assert svc.obtain(key, sig, build).status == "ready"


def test_executor_deadline_records_typed_compile_timeout():
    eng, expected = _make_engine(seed=1)
    # budget 0 == wait for the build, bounded only by the deadline
    eng.session.set("compile_deadline_s", "0.1")
    inj = FaultInjector()
    inj.arm(task_id="*", mode="COMPILE_SLOW", delay_ms=60_000, count=1)
    gate = _gated(inj)
    eng.executor.fault_injector = inj
    t0 = COMPILE_TIMEOUTS.value()
    try:
        assert eng.query(GROUP_SQL) == expected
        assert not gate.is_set()
    finally:
        gate.set()
    ev = eng.executor.fallback_events[-1]
    assert ev["reason"] == "compile_timeout"
    assert ev["error"] == "COMPILE_TIMEOUT"
    assert COMPILE_TIMEOUTS.value() == t0 + 1
    eng.executor.compile_service.drain(timeout_s=30)


# -------------------------------------------------------- circuit breaker


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_breaker_opens_and_half_open_probe_recovers():
    clock = _Clock()
    svc = CompileService(
        max_workers=2,
        breaker=SignatureBreaker(threshold=3, min_open_s=0.05, max_open_s=0.2, clock=clock),
    )
    sig = "breaker-sig"

    def boom():
        raise InjectedCompileFailure("injected compile failure")

    for i in range(3):
        out = svc.obtain((sig, i), sig, boom)
        assert out.status == "error" and out.reason == "compile_error"
    assert svc.breaker.state(sig) == "OPEN"

    # an open breaker starts no build (no churn)
    builds = svc.builds
    out = svc.obtain((sig, 3), sig, boom)
    assert out.status == "breaker_open" and out.reason == "breaker_open"
    assert svc.builds == builds

    # a half-open probe that FAILS re-opens with a longer window
    clock.t += 0.35
    assert svc.obtain((sig, 4), sig, boom).status == "error"
    assert svc.breaker.state(sig) == "OPEN"
    assert svc.obtain((sig, 5), sig, boom).status == "breaker_open"

    # a half-open probe that SUCCEEDS closes it
    clock.t += 0.35
    out = svc.obtain((sig, 6), sig, lambda: "ok")
    assert out.status == "ready" and out.result == "ok"
    assert svc.breaker.state(sig) == "CLOSED"


def test_compile_fail_falls_back_and_breaker_stops_churn():
    eng, expected = _make_engine(seed=2)
    svc = CompileService(
        breaker=SignatureBreaker(threshold=3, min_open_s=30.0, max_open_s=30.0)
    )
    eng.executor.compile_service = svc
    inj = FaultInjector()
    inj.arm(task_id="*", mode="COMPILE_FAIL", count=10)
    eng.executor.fault_injector = inj
    for _ in range(3):
        assert eng.query(GROUP_SQL) == expected  # degraded, never failed
        assert eng.executor.last_fallback_reason == "compile_error"
    sig = eng.executor.fallback_events[-1]["signature"]
    assert svc.breaker.state(sig) == "OPEN"
    # a poisoned recipe pins the fallback WITHOUT new build attempts
    builds = svc.builds
    assert eng.query(GROUP_SQL) == expected
    assert eng.executor.last_fallback_reason == "breaker_open"
    assert svc.builds == builds
    assert _paths(eng, GROUP_SQL) == {"segment_reduce"}


def test_a_build_error_without_an_armed_fault_fails_the_query(monkeypatch):
    """A kernel build that fails with no COMPILE_FAIL armed is a fault of
    the port: its error (here nvrtc.NvrtcError, as a compile or load on the
    card raises it) goes to the query every time, nothing falls back, and
    the breaker never pins the recipe to the unfused path."""
    from trino_tpu_torch.ops.cuda import fused_codegen
    from trino_tpu_torch.ops.cuda.nvrtc import NvrtcError

    eng, _ = _make_engine(seed=5)
    svc = CompileService(breaker=SignatureBreaker(threshold=3, min_open_s=30.0, max_open_s=30.0))
    eng.executor.compile_service = svc

    def broken(recipe):
        raise NvrtcError("error: identifier \"x\" is undefined")

    monkeypatch.setattr(fused_codegen, "generate", broken)
    fb0 = sum(FALLBACKS.value(r) for r in ("compile_error", "compile_wait", "breaker_open"))
    for _ in range(4):  # past the breaker's threshold
        with pytest.raises(NvrtcError, match="undefined"):
            eng.query(GROUP_SQL)
    assert svc.builds == 4
    assert all(e == {"state": "CLOSED", "failures": 0} for e in svc.breaker.snapshot().values())
    assert sum(FALLBACKS.value(r) for r in ("compile_error", "compile_wait", "breaker_open")) == fb0
    assert eng.executor.fallback_events == []


def test_service_breaker_counts_injected_failures_only():
    """At the service: a build error other than an injected COMPILE_FAIL
    comes back as `error` on every call, each call builds again, and the
    breaker stays closed."""
    svc = CompileService(
        max_workers=1, breaker=SignatureBreaker(threshold=2, min_open_s=30.0, max_open_s=30.0)
    )
    sig = "bug-sig"

    def bug():
        raise ValueError("a bug in the build")

    for i in range(4):
        out = svc.obtain((sig, i), sig, bug)
        assert out.status == "error" and isinstance(out.error, ValueError)
    assert svc.builds == 4
    assert svc.breaker.state(sig) == "CLOSED"


# ----------------------------------------------------------- cache warming


def test_top_statements_ranks_by_recurrence_then_recency():
    from trino_tpu_torch.runtime.warmup import top_statements

    store = QueryHistoryStore(capacity=50)
    store.record({"query_id": "q1", "state": "FINISHED", "sql": "select a from t"})
    store.record({"query_id": "q2", "state": "FINISHED", "sql": "select b from t"})
    store.record({"query_id": "q3", "state": "FINISHED", "sql": "select a from t"})
    store.record({"query_id": "q4", "state": "FINISHED", "sql": "insert into t values (1)"})
    store.record({"query_id": "q5", "state": "FAILED", "sql": "select broken from t"})
    store.record({"query_id": "q6", "state": "FINISHED", "sql": "<planned>"})
    assert top_statements(store, 5) == ["select a from t", "select b from t"]
    assert top_statements(store, 1) == ["select a from t"]


def test_engine_warm_from_history_prepays_the_compile():
    eng, expected = _make_engine(seed=3)
    store = QueryHistoryStore(capacity=10)
    store.record({"query_id": "w1", "state": "FINISHED", "sql": GROUP_SQL})
    store.record({"query_id": "w2", "state": "FINISHED", "sql": GROUP_SQL})
    store.record({"query_id": "w3", "state": "FAILED", "sql": "select nope"})
    warm0 = _PCACHE_EVENTS.value("warm")
    assert eng.warm_from_history(store, limit=4) == 1
    assert _PCACHE_EVENTS.value("warm") == warm0 + 1
    svc = eng.executor.compile_service
    assert svc.builds == 1  # the replay built the recipe through the service
    # the client query is a pure hit: no build, no compile event
    n_events = len(eng.executor.compile_events)
    assert eng.query(GROUP_SQL) == expected
    assert len(eng.executor.compile_events) == n_events
    assert svc.builds == 1
    assert "fused_pipeline" in _paths(eng, GROUP_SQL)


def test_coordinator_startup_warming_env_gated(tmp_path, monkeypatch):
    """TRINO_TPU_WARM_SIGNATURES=K makes a starting coordinator replay its
    history's top statements; the replay's kernel 2 build goes through the
    (here: fresh) process-global compile service."""
    import trino_tpu_torch.exec.compilesvc as compilesvc
    from trino_tpu_torch.testing import DistributedQueryRunner

    svc = CompileService()
    monkeypatch.setattr(compilesvc, "SERVICE", svc)
    sql = "select k, sum(v + 3) as s from t group by k order by k"
    hist = tmp_path / "history.jsonl"
    hist.write_text(
        json.dumps({"query_id": "h1", "state": "FINISHED", "sql": sql}) + "\n"
        + json.dumps({"query_id": "h2", "state": "FINISHED", "sql": sql}) + "\n"
    )
    monkeypatch.setenv("TRINO_TPU_HISTORY_FILE", str(hist))
    monkeypatch.setenv("TRINO_TPU_WARM_SIGNATURES", "2")
    warm0 = _PCACHE_EVENTS.value("warm")
    runner = DistributedQueryRunner(num_workers=1, default_catalog="mem", device="cpu")
    runner.register_catalog("mem", _connector(*_table(7, 2000, groups=8)))
    runner.start()
    try:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and _PCACHE_EVENTS.value("warm") < warm0 + 1:
            time.sleep(0.05)
        assert _PCACHE_EVENTS.value("warm") >= warm0 + 1, (
            "startup warmer never replayed the history statement"
        )
        assert svc.builds >= 1
    finally:
        runner.stop()


# ------------------------------------- capacity bucketing and persistence


def test_pow2_bucketing_collapses_near_identical_capacities():
    """Learned capacities land on pow2 tiers, and nudged capacities fold
    back onto the same tiers: the nudged run builds nothing new."""
    eng, expected = _make_engine(seed=4)
    assert eng.query(GROUP_SQL) == expected
    plan_key, (gens, caps, joins) = next(iter(eng.executor._learned_caps.items()))
    assert caps and all(v >= 1 and (v & (v - 1)) == 0 for v in caps.values()), (
        f"learned caps not on the pow2 grid: {caps}"
    )
    n_events = len(eng.executor.compile_events)
    sigs_before = set(PROFILER.snapshot().keys())
    builds = eng.executor.compile_service.builds
    eng.executor._learned_caps[plan_key] = (
        gens, {nid: (v - 1 if v > 2 else v) for nid, v in caps.items()}, joins,
    )
    assert eng.query(GROUP_SQL) == expected
    assert len(eng.executor.compile_events) == n_events
    assert eng.executor.compile_service.builds == builds
    assert set(PROFILER.snapshot().keys()) == sigs_before
    _, caps_after, _ = eng.executor._learned_caps[plan_key]
    assert caps_after == caps


def _join_engine():
    """A many-to-many join whose expansion the stats underestimate: a fresh
    engine's first run re-runs at a larger tier."""
    conn = MemoryConnector()
    for t in ("a", "b"):
        conn.create_table(t, [ColumnSchema("k", BIGINT), ColumnSchema("v", BIGINT)])
        conn.insert(t, {"k": np.arange(1000, dtype=np.int64) % 10,
                        "v": np.arange(1000, dtype=np.int64)})
    eng = Engine(device="cpu", default_catalog="mem")
    eng.register_catalog("mem", conn)
    return eng


JOIN_SQL = (
    "select a.k, count(*), sum(a.v + b.v) from a join b on a.k = b.k "
    "group by a.k order by a.k"
)
JOIN_ROWS = [
    (k, 10_000, int(((np.arange(1000) % 10 == k) * np.arange(1000)).sum() * 200))
    for k in range(10)
]


def test_capacity_cache_round_trip_starts_a_fresh_engine_converged(tmp_path, monkeypatch):
    path = tmp_path / "caps.json"
    monkeypatch.setenv("TRINO_TPU_TORCH_CAPS_CACHE", str(path))
    first = _join_engine()
    assert first.query(JOIN_SQL) == JOIN_ROWS
    assert first.executor.last_retries, "the first engine should have re-run"
    stored = json.loads(path.read_text())
    assert stored and all({"caps", "sort_joins"} <= set(e) for e in stored.values())
    # a second fresh engine (a fresh process's view: the file, not memory)
    from trino_tpu_torch.exec import capcache

    monkeypatch.setattr(capcache, "_mem", {})
    second = _join_engine()
    assert second.query(JOIN_SQL) == JOIN_ROWS
    assert second.executor.last_retries == []


def test_capacity_cache_ignores_a_partial_entry(tmp_path, monkeypatch):
    from trino_tpu_torch.exec import capcache

    path = tmp_path / "caps.json"
    monkeypatch.setenv("TRINO_TPU_TORCH_CAPS_CACHE", str(path))
    assert _join_engine().query(JOIN_SQL) == JOIN_ROWS
    stored = json.loads(path.read_text())
    # drop one sized node from every entry: the tiers no longer cover the plan
    for entry in stored.values():
        entry["caps"].pop(sorted(entry["caps"])[0])
    path.write_text(json.dumps(stored))
    monkeypatch.setattr(capcache, "_mem", {})
    hits0 = capcache._CAPS_LOOKUPS.value("hit")
    eng = _join_engine()
    assert eng.query(JOIN_SQL) == JOIN_ROWS
    assert capcache._CAPS_LOOKUPS.value("hit") == hits0
    assert eng.executor.last_retries, "a partial entry was trusted"
    # and an unset variable keeps the CPU's tiers in memory only
    monkeypatch.delenv("TRINO_TPU_TORCH_CAPS_CACHE")
    assert capcache.cache_path(torch.device("cpu")) is None
    assert capcache.cache_path(torch.device("cuda", 0)) == str(capcache.DEFAULT_PATH)


# ------------------------------- a cubin of another card class is never read


def _a_recipe():
    """The kernel 2 recipe GROUP_SQL's fused chain asks for."""
    from trino_tpu_torch.exec.compiler import LocalExecutor

    eng, _ = _make_engine(seed=8, n=500)
    seen = []
    plain = LocalExecutor._kernel_ready

    def spy(self, recipe, device):
        seen.append(recipe)
        return plain(self, recipe, device)

    LocalExecutor._kernel_ready = spy
    try:
        eng.query(GROUP_SQL)
    finally:
        LocalExecutor._kernel_ready = plain
    return seen[0]


def test_cubin_of_another_arch_or_nvrtc_release_is_not_read(tmp_path, monkeypatch):
    """The cubin cache is keyed by target architecture, NVRTC release and
    compute capability (utils/compilecache.py): a cubin cached under another
    class is never loaded; the build compiles afresh, and a second build
    under the first class reads its own cubin.  NVRTC and the CUDA driver API are
    stubbed: the build path is the real one."""
    from trino_tpu_torch.ops.cuda import fused_codegen, nvrtc
    from trino_tpu_torch.utils import compilecache

    recipe = _a_recipe()
    monkeypatch.setattr(compilecache, "ROOT", tmp_path / "nvrtc")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda i=None: (9, 0))
    monkeypatch.setattr(nvrtc, "bind_context", lambda i: None)
    compiled, loaded = [], []
    monkeypatch.setattr(
        nvrtc, "compile_cubin",
        lambda src, name, opts: (compiled.append(name) or b"fresh", "log", 1.0),
    )
    monkeypatch.setattr(
        nvrtc, "load_kernel", lambda cubin, name, idx: loaded.append(cubin) or object()
    )
    for name in ("_KERNELS", "_BY_RECIPE", "_COMPILES"):
        monkeypatch.setattr(fused_codegen, name, {})

    # a poisoned cubin under another NVRTC release and another architecture
    monkeypatch.setattr(nvrtc, "nvrtc_version", lambda: "12.8")
    key = fused_codegen.recipe_key(recipe)
    other = compilecache.cubin_dir(0)
    other.mkdir(parents=True)
    (other / f"{fused_codegen.cubin_stem(key, '12.8')}.cubin").write_bytes(b"poison")
    assert other.name == compilecache.fingerprint("sm_90a", "12.8", (9, 0))
    assert compilecache.fingerprint("sm_100a", "12.9", (9, 0)) != compilecache.fingerprint(
        "sm_90a", "12.9", (9, 0))
    assert compilecache.fingerprint("sm_90a", "12.9", (10, 0)) != compilecache.fingerprint(
        "sm_90a", "12.9", (9, 0))

    monkeypatch.setattr(nvrtc, "nvrtc_version", lambda: "12.9")
    info = fused_codegen.build(recipe, 0)
    assert info["cache"] == "miss" and compiled and loaded == [b"fresh"]
    assert compilecache.cubin_dir(0) != other
    assert (compilecache.cubin_dir(0) / f"{fused_codegen.cubin_stem(key, '12.9')}.cubin").exists()
    stats = compilecache.cache_stats()
    assert stats["entries"] == 2 and stats["bytes"] > 0

    # unloaded, then built again: its own class's cubin is read, not compiled
    for name in ("_KERNELS", "_BY_RECIPE"):
        getattr(fused_codegen, name).clear()
    info = fused_codegen.build(recipe, 0)
    assert info["cache"] == "hit" and loaded == [b"fresh", b"fresh"]
    assert len(compiled) == 1


# -------------------------------------------------- cluster chaos modes


def _cluster(seed: int, n_rows: int = 5000):
    from trino_tpu_torch.testing import DistributedQueryRunner

    k, v = _table(seed, n_rows, groups=12)
    runner = DistributedQueryRunner(num_workers=2, default_catalog="mem", device="cpu")
    runner.register_catalog("mem", _connector(k, v))
    runner.start()
    # every run executes (the result cache would answer a repeated statement)
    runner.coordinator.session.set("result_cache_enabled", "false")
    return runner, k, v


def test_chaos_compile_slow_completes_via_fallback(monkeypatch):
    """COMPILE_SLOW on every worker and compile_wait_budget_ms=50: the query
    returns numpy's rows while the build is still blocked, through the
    unfused path, and QueryInfo names the fallback."""
    import trino_tpu_torch.exec.compilesvc as compilesvc

    monkeypatch.setattr(compilesvc, "SERVICE", CompileService())
    sql = "select k, sum(v + 7) as s from t group by k order by k"
    runner, k, v = _cluster(seed=11)
    gates = [_gated(w.fault_injector) for w in runner.workers]
    try:
        runner.coordinator.session.set("compile_wait_budget_ms", "50")
        for i in range(len(runner.workers)):
            runner.inject_task_failure(
                worker_index=i, mode="COMPILE_SLOW", delay_ms=60_000, count=1
            )
        fb0 = FALLBACKS.value("compile_wait")
        assert runner.query(sql) == _sums(k, v, 7.0)
        assert not any(g.is_set() for g in gates)
        fired = {m for w in runner.workers for (m, _) in w.fault_injector.fired}
        assert "COMPILE_SLOW" in fired, "the injected fault never bit"
        assert FALLBACKS.value("compile_wait") >= fb0 + 1
        qi = runner.coordinator.queries[list(runner.coordinator.queries)[-1]]["query_info"]
        assert qi["fallback_executions"] >= 1
        assert qi["fallback_reasons"].get("compile_wait", 0) >= 1
    finally:
        for g in gates:
            g.set()
        runner.stop()


def test_chaos_compile_fail_completes_via_fallback(monkeypatch):
    """COMPILE_FAIL on every worker: the query succeeds through the
    fallback (typed compile_error), and once the faults are disarmed the
    same query builds and matches again."""
    import trino_tpu_torch.exec.compilesvc as compilesvc

    svc = CompileService()
    monkeypatch.setattr(compilesvc, "SERVICE", svc)
    sql = "select k, sum(v) - sum(v * 0.5) as d from t group by k order by k"
    runner, k, v = _cluster(seed=13)
    expected = [(key, float(v[k == key].sum() * 0.5)) for key in sorted(set(k.tolist()))]
    try:
        for i in range(len(runner.workers)):
            runner.inject_task_failure(worker_index=i, mode="COMPILE_FAIL", count=10)
        fb0 = FALLBACKS.value("compile_error")
        assert runner.query(sql) == expected
        assert FALLBACKS.value("compile_error") >= fb0 + 1
        fired = {m for w in runner.workers for (m, _) in w.fault_injector.fired}
        assert "COMPILE_FAIL" in fired
        for w in runner.workers:
            w.fault_injector.clear()
        builds = svc.builds
        fb1 = sum(FALLBACKS.value(r) for r in ("compile_error", "compile_wait", "breaker_open"))
        assert runner.query(sql) == expected
        assert svc.builds > builds
        assert sum(
            FALLBACKS.value(r) for r in ("compile_error", "compile_wait", "breaker_open")
        ) == fb1
    finally:
        runner.stop()


def test_chaos_harness_arms_compile_modes():
    """COMPILE_MODES ride the seeded schedule without perturbing the other
    mode tuples, and every mode is one the fault injector knows."""
    from trino_tpu_torch.testing.chaos import (
        COMPILE_MODES, CORRUPTION_MODES, PARTITION_MODES, RECOVERABLE_MODES, SPLIT_MODES,
        STORAGE_MODES, WRITE_MODES,
    )

    assert COMPILE_MODES == ("COMPILE_SLOW", "COMPILE_FAIL")
    assert RECOVERABLE_MODES == ("ERROR", "TIMEOUT", "SLOW", "EXCHANGE_DROP")
    assert CORRUPTION_MODES == RECOVERABLE_MODES + ("CORRUPT",)
    for modes in (COMPILE_MODES, CORRUPTION_MODES, PARTITION_MODES, SPLIT_MODES,
                  STORAGE_MODES, WRITE_MODES):
        assert set(modes) <= set(FaultInjector.MODES)
