"""The port's import rule: trino_tpu_torch and chip_smoke import torch,
never jax and nothing of the JAX package (importing any trino_tpu module
flips a process-global 64-bit switch)."""

import ast
import os
import subprocess
import sys

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = os.path.join(_ROOT, "trino_tpu_torch")

_IMPORT_ALL = """
import importlib, pkgutil, sys
import trino_tpu_torch
names = ["trino_tpu_torch"]
for m in pkgutil.walk_packages(trino_tpu_torch.__path__, "trino_tpu_torch."):
    importlib.import_module(m.name)
    names.append(m.name)
import chip_smoke
bad = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.") or m == "jaxlib"
    or m == "trino_tpu" or m.startswith("trino_tpu.")
)
print("MODULES", len(names))
print("BAD", bad)
print("NAMES", ",".join(names))
"""

# the statement surface and its storage plane: each must be walked (and so
# imported) by the check above
STATEMENT_MODULES = (
    "trino_tpu_torch.connectors.memory", "trino_tpu_torch.runtime.dml",
    "trino_tpu_torch.runtime.txn", "trino_tpu_torch.runtime.security",
    "trino_tpu_torch.utils.flightrecorder", "trino_tpu_torch.runtime.engine",
)


# the nested-value family (arrays, maps, rows, JSON, lambdas, UNNEST,
# MATCH_RECOGNIZE) and the modules it changed: each must be walked too
NESTED_MODULES = (
    "trino_tpu_torch.ops.matchrec", "trino_tpu_torch.ops.expr",
    "trino_tpu_torch.ops.relops", "trino_tpu_torch.exec.compiler",
    "trino_tpu_torch.runtime.engine",
)


# the out-of-core path and the prepared-statement fast path, and the
# modules they changed: each must be walked too
OUT_OF_CORE_MODULES = (
    "trino_tpu_torch.plan.fragmenter", "trino_tpu_torch.plan.distribute",
    "trino_tpu_torch.native", "trino_tpu_torch.runtime.wire",
    "trino_tpu_torch.runtime.disk", "trino_tpu_torch.runtime.memory",
    "trino_tpu_torch.exec.dynfilter", "trino_tpu_torch.exec.spill",
    "trino_tpu_torch.runtime.resultcache", "trino_tpu_torch.runtime.fastpath",
    "trino_tpu_torch.ops.kernels", "trino_tpu_torch.exec.compiler",
)


# the file and lakehouse connectors, catalog files and the write-fault path,
# and the modules they changed: each must be walked too
FILE_CONNECTOR_MODULES = (
    "trino_tpu_torch.connectors.parquet", "trino_tpu_torch.connectors.orc",
    "trino_tpu_torch.connectors.iceberg", "trino_tpu_torch.connectors.faker",
    "trino_tpu_torch.connectors.dbapi", "trino_tpu_torch.runtime.config",
    "trino_tpu_torch.runtime.failure", "trino_tpu_torch.runtime.txn",
    "trino_tpu_torch.exec.compiler",
)


# the multi-host cluster (coordinator, workers, clients, server, test
# runner) and every module they import: each must be walked too
CLUSTER_MODULES = (
    "trino_tpu_torch.runtime.coordinator", "trino_tpu_torch.runtime.worker",
    "trino_tpu_torch.runtime.statemachine", "trino_tpu_torch.runtime.events",
    "trino_tpu_torch.runtime.history", "trino_tpu_torch.runtime.health",
    "trino_tpu_torch.runtime.resourcegroups", "trino_tpu_torch.runtime.journal",
    "trino_tpu_torch.runtime.fleet", "trino_tpu_torch.runtime.spool",
    "trino_tpu_torch.runtime.splits", "trino_tpu_torch.runtime.warmup",
    "trino_tpu_torch.runtime.resultcache", "trino_tpu_torch.utils.tracing",
    "trino_tpu_torch.utils.timeseries", "trino_tpu_torch.utils.roofline",
    "trino_tpu_torch.utils.profiler", "trino_tpu_torch.client",
    "trino_tpu_torch.client.client", "trino_tpu_torch.client.dbapi",
    "trino_tpu_torch.client.cli", "trino_tpu_torch.testing",
    "trino_tpu_torch.testing.runner", "trino_tpu_torch.server",
)


# the compile plane and the chaos harness, and the modules they changed:
# each must be walked too
COMPILE_PLANE_MODULES = (
    "trino_tpu_torch.exec.compilesvc", "trino_tpu_torch.exec.capcache",
    "trino_tpu_torch.utils.compilecache", "trino_tpu_torch.testing.chaos",
    "trino_tpu_torch.ops.cuda.fused_codegen", "trino_tpu_torch.exec.compiler",
    "trino_tpu_torch.runtime.wire",
)


# cluster governance and recovery (node memory and disk pools, split
# scheduling, resource groups, the journal, the spool, the fleet, write
# transactions) and the modules around them: each must be walked too
GOVERNANCE_MODULES = (
    "trino_tpu_torch.runtime.memory", "trino_tpu_torch.runtime.disk",
    "trino_tpu_torch.runtime.splits", "trino_tpu_torch.runtime.resourcegroups",
    "trino_tpu_torch.runtime.journal", "trino_tpu_torch.runtime.spool",
    "trino_tpu_torch.runtime.fleet", "trino_tpu_torch.runtime.txn",
)


# the result cache, the fragment memo, the history store that admission reads,
# and the clients that carry prepared statements over the protocol: each must
# be walked too, and each is host-only
CACHE_MODULES = (
    "trino_tpu_torch.runtime.resultcache", "trino_tpu_torch.runtime.history",
    "trino_tpu_torch.client.client", "trino_tpu_torch.client.dbapi",
)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = _ROOT
    return env


def _python_files():
    out = [os.path.join(_ROOT, "chip_smoke.py")]
    for base, _dirs, files in os.walk(_PKG):
        out.extend(os.path.join(base, f) for f in files if f.endswith(".py"))
    return sorted(out)


def test_importing_every_module_loads_neither_jax_nor_the_reference():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=_ROOT, env=_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = dict(l.split(" ", 1) for l in proc.stdout.strip().splitlines())
    assert int(lines["MODULES"]) >= 30
    assert lines["BAD"] == "[]", lines["BAD"]
    walked = set(lines["NAMES"].split(","))
    assert set(STATEMENT_MODULES) <= walked, sorted(set(STATEMENT_MODULES) - walked)
    assert set(NESTED_MODULES) <= walked, sorted(set(NESTED_MODULES) - walked)
    assert set(OUT_OF_CORE_MODULES) <= walked, sorted(set(OUT_OF_CORE_MODULES) - walked)
    assert set(FILE_CONNECTOR_MODULES) <= walked, sorted(
        set(FILE_CONNECTOR_MODULES) - walked)
    assert set(CLUSTER_MODULES) <= walked, sorted(set(CLUSTER_MODULES) - walked)
    assert set(COMPILE_PLANE_MODULES) <= walked, sorted(
        set(COMPILE_PLANE_MODULES) - walked)
    assert set(GOVERNANCE_MODULES) <= walked, sorted(set(GOVERNANCE_MODULES) - walked)
    assert set(CACHE_MODULES) <= walked, sorted(set(CACHE_MODULES) - walked)


def _assert_host_only(name):
    """`name` imports neither torch, jax nor the JAX package, and names no
    device (so it cannot pick the CPU where the caller asked for nothing)."""
    path = os.path.join(_ROOT, *name.split(".")) + ".py"
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = [(node.module or "").split(".")[0]]
        else:
            roots = []
        for root in roots:
            assert root not in ("torch", "jax", "jaxlib", "trino_tpu"), (
                f"{path}:{node.lineno} imports {root}")
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert node.value.lower() not in ("cpu", "cuda"), (
                f"{path}:{node.lineno} names a device")
        if isinstance(node, ast.arg):
            assert node.arg not in ("device", "devices"), f"{path}: takes a device"


@pytest.mark.parametrize("name", GOVERNANCE_MODULES)
def test_governance_modules_are_host_only_and_pick_no_device(name):
    """The governance modules count bytes, leases, splits and journal
    records on the host: none imports torch, jax or the JAX package, and
    none names a device; the nodes that run them hold the device."""
    _assert_host_only(name)


@pytest.mark.parametrize("name", CACHE_MODULES)
def test_cache_and_client_modules_are_host_only_and_pick_no_device(name):
    """The result cache and fragment memo keep host rows and spool paths,
    the history store host records, the clients HTTP requests: none imports
    torch, jax or the JAX package, and none names a device; the coordinator
    and the workers that use them hold the device."""
    _assert_host_only(name)


def test_governed_nodes_raise_without_a_device(tmp_path):
    """The nodes that act on the card under governance (node memory and
    disk pools, a journal, a fleet) raise the typed error without one, and
    run where the caller asks."""
    try:  # arrow before torch (see test_torch_dec128)
        import pyarrow  # noqa: F401
    except ImportError:
        pass
    import torch

    from trino_tpu_torch.connectors.spi import CatalogManager
    from trino_tpu_torch.runtime.coordinator import Coordinator
    from trino_tpu_torch.runtime.worker import Worker
    from trino_tpu_torch.testing import DistributedQueryRunner

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Worker(CatalogManager(), "tpch", node_memory_bytes=1 << 20, disk_budget_bytes=1 << 20)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Coordinator(CatalogManager(), journal_path=str(tmp_path / "j.jsonl"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistributedQueryRunner(num_workers=3, node_memory_bytes=1 << 20,
                               disk_budget_bytes=1 << 20, num_coordinators=2,
                               journal_path=str(tmp_path / "j.jsonl"))
    w = Worker(CatalogManager(), "tpch", node_memory_bytes=1 << 20, device="cpu")
    try:
        assert w.device.type == "cpu" and w.memory_pool.capacity == 1 << 20
        assert w.scan_cache.drop_device() == 0
    finally:  # never started: close its listening socket
        w.httpd.server_close()
        w._pool.shutdown(wait=False)


def test_no_refusal_names_the_nested_value_family():
    """Nothing in the package raises naming ROADMAP A.8b any more: arrays,
    maps, rows, JSON, lambdas, Unnest and MATCH_RECOGNIZE all run."""
    left = []
    for base, _dirs, files in os.walk(_PKG):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(base, f)
                for i, line in enumerate(open(path), 1):
                    if "A.8b" in line:
                        left.append(f"{os.path.relpath(path, _ROOT)}:{i}")
    assert left == []
    from trino_tpu_torch.exec import compiler

    assert "Unnest" not in compiler._ROADMAP_ITEM
    assert "MatchRecognize" not in compiler._ROADMAP_ITEM


def test_no_refusal_names_the_out_of_core_slice():
    """Nothing in the package raises naming ROADMAP A.9b any more: RemoteSource
    leaves run, ir.Param evaluates, EXECUTE takes the fast path.  No plan
    node is left unported (the Exchange runs between tasks, exec/spmd.py)."""
    left = []
    for base, _dirs, files in os.walk(_PKG):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(base, f)
                for i, line in enumerate(open(path), 1):
                    if "A.9b" in line:
                        left.append(f"{os.path.relpath(path, _ROOT)}:{i}")
    assert left == []
    from trino_tpu_torch.exec import compiler

    assert compiler._ROADMAP_ITEM == {}


@pytest.mark.parametrize("kind", ["orc", "sqlite"])
def test_no_refusal_names_the_distributed_plane(kind, tmp_path):
    """Nothing in the package raises or documents ROADMAP A.10 any more: a
    plan distributed over ORC stripes or DB-API row ranges runs through the
    distributed executor (tests/test_torch_distributed.py holds the ports of
    the reference's cases), and LocalExecutor, handed an Exchange, names
    the executors of distributed plans."""
    try:  # arrow before torch (see test_torch_dec128)
        import pyarrow  # noqa: F401
    except ImportError:
        pytest.skip("needs pyarrow")
    left = []
    for base, _dirs, files in os.walk(_PKG):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(base, f)
                for i, line in enumerate(open(path), 1):
                    if "A.10" in line:
                        left.append(f"{os.path.relpath(path, _ROOT)}:{i}")
    assert left == []
    from trino_tpu_torch.plan.distribute import distribute
    from trino_tpu_torch.runtime.engine import Engine

    if kind == "orc":
        from trino_tpu_torch.connectors.orc import OrcConnector

        conn = OrcConnector(str(tmp_path))
    else:
        from trino_tpu_torch.connectors.dbapi import SqliteConnector

        conn = SqliteConnector(str(tmp_path / "x.db"), splits_per_table=2)
    eng = Engine(default_catalog=kind, device="cpu")
    eng.register_catalog(kind, conn)
    eng.execute("create table big (k bigint)")
    eng.execute("insert into big values " + ", ".join(f"({i})" for i in range(100)))
    assert eng.execute("select count(*), sum(k) from big") == [(100, 4950)]
    plan = distribute(eng.plan("select count(*), sum(k) from big"), eng.catalogs, 2,
                      eng.session)
    with pytest.raises(NotImplementedError, match=r"exec/spmd\.py.*exec/spill\.py"):
        eng.executor.execute(plan)
    dist = Engine(default_catalog=kind, device="cpu", distributed=True, devices=["cpu"] * 2)
    dist.register_catalog(kind, conn)
    assert dist.execute("select count(*), sum(k) from big") == [(100, 4950)]


def test_timeseries_config_names_the_control_plane(tmp_path):
    """The time-series applier of runtime/config.py applies a node config's
    keys to the process-global store (utils/timeseries.py), as a node boot
    does (`python -m trino_tpu_torch.server --etc DIR`)."""
    from trino_tpu_torch.runtime.config import apply_timeseries_config, load_node_config
    from trino_tpu_torch.utils import timeseries

    (tmp_path / "config.properties").write_text(
        "coordinator=false\nnode.device=cpu\ntimeseries.enabled=false\n"
        "timeseries.ring-size=64\ntimeseries.sample-interval-s=0.5\n"
    )
    cfg = load_node_config(str(tmp_path))
    assert cfg.device == "cpu" and not cfg.coordinator
    saved = timeseries.STORE.stats()
    try:
        apply_timeseries_config(cfg)
        got = timeseries.STORE.stats()
        assert got["enabled"] is False and got["ring_size"] == 64
        assert got["sample_interval_s"] == 0.5
    finally:
        timeseries.configure(
            enabled=saved["enabled"], ring_size=saved["ring_size"],
            sample_interval_s=saved["sample_interval_s"],
        )


def test_serde_is_built_at_first_use_not_at_import():
    """Importing the wire and spill modules builds nothing: the serde
    library is compiled when a page first crosses the wire."""
    code = (
        "import trino_tpu_torch.native as n, trino_tpu_torch.exec.spill, "
        "trino_tpu_torch.runtime.wire; print(n._SERDE is None)"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=_ROOT, env=_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "True"


@pytest.mark.parametrize(
    "path", _python_files(), ids=lambda p: os.path.relpath(p, _ROOT)
)
def test_no_import_statement_names_jax_or_the_reference(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = [(node.module or "").split(".")[0]]
        else:
            continue
        for root in roots:
            assert root not in ("jax", "jaxlib", "trino_tpu"), (
                f"{path}:{node.lineno} imports {root}"
            )


def test_chip_smoke_refuses_to_run_without_a_cuda_device():
    try:  # arrow before torch (see test_torch_dec128)
        import pyarrow  # noqa: F401
    except ImportError:
        pass
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal path does not apply")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=_ROOT, env=_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_cuda_entry_points_raise_without_a_device():
    import numpy as np
    import torch

    from trino_tpu_torch.data.page import Column
    from trino_tpu_torch.data.types import BIGINT
    from trino_tpu_torch.runtime.engine import Engine

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine()  # the default device is the card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(distributed=True)  # every visible card: there is none
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(distributed=True, devices=["cuda:0"] * 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Column.from_numpy(BIGINT, np.arange(3))
    # the cluster's nodes and its runner run on the card unless told otherwise
    from trino_tpu_torch.connectors.spi import CatalogManager
    from trino_tpu_torch.runtime.coordinator import Coordinator
    from trino_tpu_torch.runtime.worker import Worker
    from trino_tpu_torch.testing import DistributedQueryRunner

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Coordinator(CatalogManager())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Worker(CatalogManager(), "tpch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistributedQueryRunner(num_workers=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistributedQueryRunner(num_workers=2, devices=["cuda:0"] * 2)
    # the chaos harness's cluster runs on the card unless told otherwise
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.testing import make_chaos_cluster

    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_chaos_cluster(MemoryConnector, num_workers=2)
    # the NVRTC cubin cache belongs to a card; a card's build job through
    # the compile service fails typed, it does not hang or fall back
    # silently (the capacity cache is host-only: it has no device path)
    from trino_tpu_torch.exec.compilesvc import CompileService
    from trino_tpu_torch.utils import compilecache

    with pytest.raises(RuntimeError, match="no CUDA device"):
        compilecache.cubin_dir(0)
    out = CompileService(max_workers=1).obtain(
        ("job", "cuda", 0), "job", lambda: compilecache.cubin_dir(0)
    )
    assert out.status == "error" and "no CUDA device" in str(out.error)
