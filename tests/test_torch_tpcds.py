"""TPC-DS through the port's `Engine.query` (device="cpu") against the sqlite
oracle at SF 0.002, with the data-plane kernels' plain versions on (hash
joins and GROUP BYs) and off (sort joins and GROUP BYs).

The statements: the reference suite's tier-1 set (tests/test_tpcds.py, every
statement outside its SLOW set) plus the window statements of SLOW, less q51,
q58, q59 and q97, which the reference's suite leaves to its full run for
sqlite limits (q58: an ambiguous column in sqlite; q59: ORDER BY ... LIMIT
over ties).  Rows are compared as the reference's suite does (its ORDERED
flags, doubles within rel 1e-9).  The port's copy of the generator is held
to the reference's, table by table and array by array."""

import numpy as np
import pytest
try:  # arrow before torch: loaded after it, arrow's parquet writer crashes the process
    import pyarrow  # noqa: F401
except ImportError:
    pass
import torch

from tests.oracle import SqliteOracle, assert_rows_equal
from tests.test_tpcds import SLOW
from tests.tpcds_queries import ORDERED, QUERIES

torch.set_num_threads(1)

SCALE = 0.002
WINDOW_SLOW = ("q36", "q47", "q49", "q57", "q63", "q67", "q70", "q86", "q89")
LEFT_OUT = ("q51", "q58", "q59", "q97")
STATEMENTS = sorted(
    n for n in QUERIES if (n not in SLOW or n in WINDOW_SLOW) and n not in LEFT_OUT
)


@pytest.fixture(scope="module")
def tpcds_oracle():
    from trino_tpu.connectors.tpcds import TPCDS_SCHEMAS, tpcds_data

    # only the tables the statements touch, as the reference's suite loads
    needed = {t for sql in QUERIES.values() for t in TPCDS_SCHEMAS if t in sql}
    return SqliteOracle({t: tpcds_data(t, SCALE) for t in sorted(needed)},
                        schemas=TPCDS_SCHEMAS)


@pytest.fixture(scope="module")
def ds_port():
    from trino_tpu_torch.connectors.tpcds import TpcdsConnector
    from trino_tpu_torch.runtime.engine import Engine

    eng = Engine(default_catalog="tpcds", device="cpu")
    eng.register_catalog("tpcds", TpcdsConnector(SCALE))
    return eng


@pytest.mark.parametrize("kernels_on", [True, False], ids=["kernels_on", "kernels_off"])
@pytest.mark.parametrize("name", STATEMENTS)
def test_tpcds_query_equals_oracle(name, kernels_on, ds_port, tpcds_oracle):
    sql = QUERIES[name]
    ds_port.execute(f"set session data_plane_kernels = {'true' if kernels_on else 'false'}")
    try:
        rows = ds_port.query(sql)
    finally:
        ds_port.execute("set session data_plane_kernels = true")
    assert_rows_equal(rows, tpcds_oracle.query(sql), ordered=ORDERED[name])


def test_statement_set():
    """51 tier-1 statements of the reference suite plus nine window
    statements of its SLOW set, less the four it leaves out."""
    assert len([n for n in QUERIES if n not in SLOW]) == 51
    assert set(LEFT_OUT) <= SLOW and set(WINDOW_SLOW) <= SLOW
    assert len(STATEMENTS) == 60


def test_generated_tables_equal_the_reference():
    """The data are the weights: the port's tpcds_data equals the
    reference's for all 24 tables, array by array (values, dtypes, masks)."""
    from trino_tpu.connectors.tpcds import TPCDS_SCHEMAS as RS
    from trino_tpu.connectors.tpcds import tpcds_data as ref_data
    from trino_tpu_torch.connectors.tpcds import TPCDS_SCHEMAS, tpcds_data

    assert len(TPCDS_SCHEMAS) == 24
    assert [(t, [(c, ty.name) for c, ty in cols]) for t, cols in sorted(TPCDS_SCHEMAS.items())] \
        == [(t, [(c, ty.name) for c, ty in cols]) for t, cols in sorted(RS.items())]
    for table in sorted(TPCDS_SCHEMAS):
        got, want = tpcds_data(table, SCALE), ref_data(table, SCALE)
        assert list(got) == list(want), table
        for col in want:
            g, w = got[col], want[col]
            assert g.dtype == w.dtype, (table, col)
            assert np.array_equal(np.ma.getmaskarray(g), np.ma.getmaskarray(w)), (table, col)
            assert np.array_equal(np.ma.getdata(g), np.ma.getdata(w)), (table, col)
