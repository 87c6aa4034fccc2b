"""The port's clients against its cluster: the DB-API 2.0 driver (the JDBC
analogue), the Faker connector through the cluster, and the spooled result
protocol.  Ports of tests/test_clients.py, every task on the CPU."""

import numpy as np
import pytest

try:  # arrow before torch: loaded after it, arrow's parquet writer crashes the process
    import pyarrow  # noqa: F401
except ImportError:
    pass
import torch

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cluster(tpch_tiny):
    from trino_tpu_torch.connectors.faker import FakerConnector
    from trino_tpu_torch.connectors.spi import ColumnSchema
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.data.types import BIGINT, DATE, DOUBLE, VARCHAR
    from trino_tpu_torch.testing import DistributedQueryRunner

    runner = DistributedQueryRunner(num_workers=3, device="cpu")
    runner.register_catalog("tpch", TpchConnector(0.01))
    faker = FakerConnector()
    faker.create_table(
        "events",
        [
            ColumnSchema("id", BIGINT),
            ColumnSchema("kind", VARCHAR),
            ColumnSchema("score", DOUBLE),
            ColumnSchema("day", DATE),
        ],
        rows=2000,
    )
    runner.register_catalog("faker", faker)
    runner.start()
    yield runner
    runner.stop()


def test_dbapi_basic(cluster):
    from trino_tpu_torch.client.dbapi import connect

    with connect(cluster.coordinator.url) as conn:
        cur = conn.cursor()
        cur.execute("select n_name, n_regionkey from nation order by n_name limit 3")
        assert cur.rowcount == 3
        assert [d[0] for d in cur.description] == ["n_name", "n_regionkey"]
        rows = cur.fetchall()
        assert len(rows) == 3 and rows == sorted(rows)
        cur.execute("select count(*) from region")
        assert cur.fetchone() == (5,)
        assert cur.fetchone() is None


def test_dbapi_parameters_and_iteration(cluster):
    from trino_tpu_torch.client.dbapi import connect

    conn = connect(cluster.coordinator.url)
    cur = conn.cursor()
    cur.execute(
        "select n_name from nation where n_regionkey = ? and n_name <> ?",
        (0, "doesn't-exist"),  # an embedded quote exercises escaping
    )
    names = [r[0] for r in cur]
    assert len(names) == 5
    with pytest.raises(Exception):
        cur.execute("select * from nation where n_regionkey = ?", ())


def test_dbapi_errors(cluster):
    from trino_tpu_torch.client.dbapi import DatabaseError, ProgrammingError, connect

    conn = connect(cluster.coordinator.url)
    cur = conn.cursor()
    with pytest.raises(DatabaseError):
        cur.execute("select nonexistent_col from nation")
    conn.close()
    with pytest.raises(ProgrammingError):
        conn.cursor()


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


def test_faker_queries(cluster):
    rows = cluster.query("select count(*), count(distinct kind) from faker.events")
    assert rows[0][0] == 2000 and 1 < rows[0][1] <= 32  # the vocabulary's size
    rows = cluster.query(
        "select kind, count(*) c from faker.events group by kind order by c desc limit 3"
    )
    assert len(rows) == 3 and rows[0][1] >= rows[2][1]
    rows = cluster.query("select count(*) from faker.events where day >= date '2021-01-01'")
    assert 0 < rows[0][0] < 2000


def test_spooled_client_protocol(cluster, tmp_path):
    """The SPOOLED result protocol: with a client spool configured and the
    client advertising support, results come back as on-disk segment URIs;
    the response carries no inline data, the coordinator drops the rows
    from RAM, and the client's segment ack deletes the files."""
    import glob

    from trino_tpu_torch.client.client import StatementClient

    coord = cluster.coordinator
    coord.session.set("client_spool_dir", str(tmp_path))
    try:
        sql = "select n_nationkey, n_name from nation order by n_nationkey"
        plain = StatementClient(coord.url).execute(sql)
        _cols, rows = StatementClient(coord.url, spooled=True).execute(sql)
        assert rows == plain[1]
        assert len(rows) == 25
        qid = [q for q, rec in coord.queries.items() if rec.get("segments") is not None]
        assert qid, "no spooled query recorded"
        assert coord.queries[qid[0]]["result"] == []  # rows left coordinator RAM
        assert glob.glob(str(tmp_path / f"{qid[0]}_seg*")) == []  # acked: deleted
    finally:
        coord.session.set("client_spool_dir", "")
