"""The port's ORC connector (trino_tpu_torch/connectors/orc.py): the
single-process tests of tests/test_orc.py on a CPU engine, and `read_split`
of a file of several stripes against the JAX package's connector."""

import numpy as np
import pytest
try:  # arrow before torch: loaded after it, arrow's parquet writer crashes the process
    import pyarrow as pa
    import pyarrow.orc  # noqa: F401
except ImportError:
    pa = None
import torch

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(pa is None, reason="needs pyarrow")


@pytest.fixture(autouse=True)
def _restore_kernel_policy():
    from trino_tpu_torch.ops import kernels

    saved = kernels.get_policy()
    yield
    kernels.set_policy(saved)


@pytest.fixture()
def engine(tmp_path):
    from trino_tpu_torch.connectors.orc import OrcConnector
    from trino_tpu_torch.runtime.engine import Engine

    eng = Engine(default_catalog="orc", device="cpu")
    eng.register_catalog("orc", OrcConnector(str(tmp_path)))
    return eng


def test_roundtrip_with_nulls(engine):
    engine.execute("create table t (k bigint, v double, s varchar)")
    engine.execute("insert into t values (1, 1.5, 'a'), (2, 2.5, null), (3, null, 'c')")
    engine.execute("insert into t values (4, 4.5, 'd')")  # second file
    assert engine.execute("select k, v, s from t order by k") == [
        (1, 1.5, "a"), (2, 2.5, None), (3, None, "c"), (4, 4.5, "d"),
    ]
    assert engine.execute("select count(*), count(v), sum(v) from t") == [(4, 3, 8.5)]


def test_ctas_orc(engine):
    engine.execute("create table src (k bigint)")
    engine.execute("insert into src values (1), (2), (3)")
    engine.execute("create table dst as select k * 2 as k2 from src where k > 1")
    assert engine.execute("select k2 from dst order by k2") == [(4,), (6,)]


def test_matches_parquet_connector(engine, tmp_path):
    """Same rows through ORC and Parquet produce identical results."""
    from trino_tpu_torch.connectors.parquet import ParquetConnector

    engine.register_catalog("parquet", ParquetConnector(str(tmp_path / "pq")))
    for cat in ("orc", "parquet"):
        engine.execute(f"create table {cat}.data (k bigint, s varchar)")
        engine.execute(f"insert into {cat}.data values (1, 'x'), (2, 'y'), (3, 'x')")
    a = engine.execute("select s, count(*) from orc.data group by s order by s")
    b = engine.execute("select s, count(*) from parquet.data group by s order by s")
    assert a == b == [("x", 2), ("y", 1)]


@pytest.mark.parametrize("parts", [1, 3])
def test_stripe_splits_equal_the_reference(parts, tmp_path):
    """A file of several stripes (nulls, decimals, dates, strings) read in
    `parts` splits by both packages' connectors: the same arrays."""
    import pyarrow.orc as orc

    from tests.test_torch_parquet import assert_arrays_equal
    from trino_tpu.connectors.orc import OrcConnector as RefOrc
    from trino_tpu_torch.connectors.orc import OrcConnector
    from trino_tpu_torch.connectors.parquet import _numpy_to_arrow
    from trino_tpu_torch.data.types import DATE, DOUBLE, VARCHAR, DecimalType

    rng = np.random.default_rng(3)
    n = 30_000
    mask = rng.random(n) < 0.1
    cols = {
        "k": pa.array(np.arange(n, dtype=np.int64)),
        "d": _numpy_to_arrow(np.ma.MaskedArray(rng.integers(-10**9, 10**9, n), mask=mask),
                             DecimalType(12, 2)),
        "day": _numpy_to_arrow(rng.integers(8000, 9000, n).astype(np.int32), DATE),
        "x": _numpy_to_arrow(np.ma.MaskedArray(rng.normal(0, 1, n), mask=mask[::-1]), DOUBLE),
        "s": _numpy_to_arrow(np.asarray([f"v{i % 101}" for i in range(n)], object), VARCHAR),
    }
    (tmp_path / "t").mkdir()
    orc.write_table(pa.table(cols), str(tmp_path / "t" / "part-0.orc"), stripe_size=64 * 1024)
    port, ref = OrcConnector(str(tmp_path)), RefOrc(str(tmp_path))
    assert orc.ORCFile(str(tmp_path / "t" / "part-0.orc")).nstripes > 3
    assert [(c.name, c.type.name) for c in port.table_schema("t").columns] == [
        (c.name, c.type.name) for c in ref.table_schema("t").columns]
    names = list(cols)
    total = 0
    for s, rs in zip(port.get_splits("t", parts), ref.get_splits("t", parts)):
        got, want = port.read_split(s, names), ref.read_split(rs, names)
        for c in names:
            assert_arrays_equal(got[c], want[c], f"t.{c} part {s.part}/{parts}")
        total += len(got["k"])
    assert total == n
