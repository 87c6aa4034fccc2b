"""The port of tests/test_tpch_distributed.py: all 22 TPC-H queries at SF
0.01 through `Engine(distributed=True)` over four CPU workers (exec/spmd.py:
every fragment as four tasks, the exchanges in memory), against the sqlite
oracle."""

import pytest
try:  # arrow before torch: loaded after it, arrow's parquet writer crashes the process
    import pyarrow  # noqa: F401
except ImportError:
    pass
import torch

from tests.oracle import assert_rows_equal
from tests.tpch_queries import ORDERED, QUERIES

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _restore_kernel_policy():
    from trino_tpu_torch.ops import kernels

    saved = kernels.get_policy()
    yield
    kernels.set_policy(saved)


@pytest.fixture(scope="module")
def dist_engine():
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.runtime.engine import Engine

    eng = Engine(device="cpu", distributed=True, devices=["cpu"] * 4)
    eng.register_catalog("tpch", TpchConnector(0.01))
    return eng


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_tpch_distributed(name, dist_engine, oracle):
    sql = QUERIES[name]
    got = dist_engine.query(sql)
    assert_rows_equal(got, oracle.query(sql), ordered=ORDERED[name])
    ex = dist_engine.executor
    assert ex.fragments >= 2  # at least one exchange ran between tasks
