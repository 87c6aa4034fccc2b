"""The port's Faker connector (trino_tpu_torch/connectors/faker.py):
`read_split` against the JAX package's for 1, 3 and 7 parts, and the
assertions of tests/test_clients.py's faker tests on a CPU engine (the
reference runs them through a cluster)."""

import numpy as np
import pytest
try:  # arrow before torch: loaded after it, arrow's parquet writer crashes the process
    import pyarrow  # noqa: F401
except ImportError:
    pass
import torch

torch.set_num_threads(1)

EVENTS = (("id", "bigint"), ("kind", "varchar"), ("score", "double"), ("day", "date"),
          ("price", "decimal(12,2)"), ("flag", "boolean"))


@pytest.fixture(autouse=True)
def _restore_kernel_policy():
    from trino_tpu_torch.ops import kernels

    saved = kernels.get_policy()
    yield
    kernels.set_policy(saved)


def events(pkg, rows=2000):
    if pkg == "port":
        from trino_tpu_torch.connectors.faker import FakerConnector
        from trino_tpu_torch.connectors.spi import ColumnSchema
        from trino_tpu_torch.data.types import parse_type
    else:
        from trino_tpu.connectors.faker import FakerConnector
        from trino_tpu.connectors.spi import ColumnSchema
        from trino_tpu.data.types import parse_type
    conn = FakerConnector()
    conn.create_table("events", [ColumnSchema(n, parse_type(t)) for n, t in EVENTS], rows=rows)
    return conn


@pytest.mark.parametrize("parts", [1, 3, 7])
def test_read_split_equals_the_reference(parts):
    port, ref = events("port"), events("ref")
    names = [n for n, _ in EVENTS]
    pieces = []
    for s, rs in zip(port.get_splits("events", parts), ref.get_splits("events", parts)):
        got, want = port.read_split(s, names), ref.read_split(rs, names)
        for c in names:
            assert got[c].dtype == want[c].dtype and np.array_equal(got[c], want[c]), c
        pieces.append(got)
    whole = port.read_split(port.get_splits("events", 1)[0], names)
    for c in names:  # split-stable: the parts concatenate to the whole
        assert np.array_equal(np.concatenate([p[c] for p in pieces]), whole[c]), c


def test_faker_deterministic_and_split_stable():
    from trino_tpu_torch.connectors.faker import FakerConnector
    from trino_tpu_torch.connectors.spi import ColumnSchema
    from trino_tpu_torch.data.types import BIGINT

    conn = FakerConnector()
    conn.create_table("t", [ColumnSchema("x", BIGINT)], rows=100)
    whole = conn.read_split(conn.get_splits("t", 1)[0], ["x"])["x"]
    parts = [conn.read_split(s, ["x"])["x"] for s in conn.get_splits("t", 4)]
    assert np.array_equal(np.concatenate(parts), whole)
    again = FakerConnector()
    again.create_table("t", [ColumnSchema("x", BIGINT)], rows=100)
    assert np.array_equal(again.read_split(again.get_splits("t", 1)[0], ["x"])["x"], whole)


def test_faker_queries():
    from trino_tpu_torch.runtime.engine import Engine

    eng = Engine(default_catalog="faker", device="cpu")
    eng.register_catalog("faker", events("port"))
    rows = eng.query("select count(*), count(distinct kind) from faker.events")
    assert rows[0][0] == 2000 and 1 < rows[0][1] <= 32  # vocab size
    rows = eng.query(
        "select kind, count(*) c from faker.events group by kind order by c desc limit 3")
    assert len(rows) == 3 and rows[0][1] >= rows[2][1]
    rows = eng.query("select count(*) from faker.events where day >= date '2021-01-01'")
    assert 0 < rows[0][0] < 2000
    with pytest.raises(NotImplementedError, match="generated, not written"):
        eng.execute("insert into events select * from events")
