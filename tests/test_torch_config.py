"""The port's catalog files and node config (trino_tpu_torch/runtime/config.py)
against the JAX package's: the catalog and node-config half of
tests/test_config.py::test_load_properties_and_catalogs, once per connector
name, and the two process-global appliers (the time-series one applies
since the port has utils/timeseries.py)."""

import pytest
try:  # arrow before torch: loaded after it, arrow's parquet writer crashes the process
    import pyarrow  # noqa: F401
except ImportError:
    pass
import torch

torch.set_num_threads(1)

CONFIG = (
    "coordinator=true\n"
    "# a comment\n"
    "http-server.http.port=0\n"
    "retry-policy=TASK\n"
    "exchange.spool-dir=/tmp/spool_x\n"
    "memory.heap-headroom-per-node=123456\n"
    "spool.disk-budget-bytes=4096\n"
    "flightrecorder.ring-size=64\n"
    "timeseries.enabled=false\n"
)


def catalog_props(name: str, root) -> str:
    extra = {
        "tpch": "tpch.scale=0.01\n", "tpcds": "tpcds.scale=0.002\n",
        "parquet": f"parquet.root={root}\n", "orc": f"orc.root={root}\n",
        "iceberg": f"iceberg.root={root}\n", "faker": "faker.rows=77\n",
    }
    return f"connector.name={name}\n" + extra.get(name, "")


CONNECTORS = ("tpch", "tpcds", "memory", "blackhole", "parquet", "orc", "iceberg", "faker")


@pytest.mark.parametrize("connector", CONNECTORS)
def test_load_properties_and_catalogs(connector, tmp_path):
    from trino_tpu.runtime import config as ref
    from trino_tpu_torch.runtime import config as port

    etc = tmp_path / "etc"
    (etc / "catalog").mkdir(parents=True)
    (tmp_path / "data").mkdir()
    (etc / "config.properties").write_text(CONFIG)
    (etc / "catalog" / "tiny.properties").write_text("connector.name=tpch\ntpch.scale=0.01\n")
    (etc / "catalog" / "c.properties").write_text(catalog_props(connector, tmp_path / "data"))

    assert port.load_properties(str(etc / "config.properties")) == ref.load_properties(
        str(etc / "config.properties"))
    cfg, ref_cfg = port.load_node_config(str(etc)), ref.load_node_config(str(etc))
    # the port's one key of its own: the device a node's tasks run on
    assert cfg.device == "cuda"
    assert {k: v for k, v in vars(cfg).items() if k != "device"} == vars(ref_cfg)
    assert cfg.coordinator and cfg.retry_policy == "TASK"
    assert cfg.exchange_spool_dir == "/tmp/spool_x"
    assert cfg.cluster_memory_limit_bytes == 123456
    catalogs, ref_catalogs = port.load_catalogs(str(etc)), ref.load_catalogs(str(etc))
    assert sorted(catalogs.names()) == sorted(ref_catalogs.names()) == ["c", "tiny"]
    conn, ref_conn = catalogs.get("c"), ref_catalogs.get("c")
    assert type(conn).__name__ == type(ref_conn).__name__
    assert type(conn).__module__ == type(ref_conn).__module__.replace(
        "trino_tpu.", "trino_tpu_torch.", 1)
    assert catalogs.get("tiny").table_schema("region") is not None
    if connector == "faker":
        assert conn.default_rows == ref_conn.default_rows == 77


def test_an_unknown_connector_name_is_refused(tmp_path):
    from trino_tpu_torch.runtime.config import load_catalogs

    (tmp_path / "catalog").mkdir()
    (tmp_path / "catalog" / "x.properties").write_text("connector.name=nosuch\n")
    with pytest.raises(ValueError, match="unknown connector.name: 'nosuch'"):
        load_catalogs(str(tmp_path))


def test_appliers(tmp_path):
    from trino_tpu_torch.runtime.config import (
        apply_flightrecorder_config, apply_timeseries_config, load_node_config,
    )
    from trino_tpu_torch.utils import flightrecorder

    (tmp_path / "config.properties").write_text(CONFIG)
    cfg = load_node_config(str(tmp_path))
    ring = flightrecorder.RECORDER
    saved = (ring._size, ring.enabled)
    try:
        apply_flightrecorder_config(cfg)
        assert (ring._size, ring.enabled) == (64, True)
    finally:
        flightrecorder.configure(ring_size=saved[0], enabled=saved[1])
    from trino_tpu_torch.utils import timeseries

    saved = timeseries.STORE.stats()
    try:
        apply_timeseries_config(cfg)
        assert timeseries.STORE.stats()["enabled"] is False
    finally:
        timeseries.configure(
            enabled=saved["enabled"], ring_size=saved["ring_size"],
            sample_interval_s=saved["sample_interval_s"],
        )
