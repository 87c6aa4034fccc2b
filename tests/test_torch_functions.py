"""The scalar function library through the port's `Engine.query`
(device="cpu", TPC-H SF 0.01): the scalar cases of tests/test_functions.py
against the same sqlite oracle / python expectations — functions sqlite
shares, strings, regexps, float math, trig domains, dates, NULL-producing
strings, functions in WHERE / GROUP BY, try_cast — plus varchar casts.
String functions run once per distinct dictionary value on the host and
gather by code; float math runs in f64 lanes.  The JSON and `sequence`
cases are in tests/test_torch_nested.py."""

import math
import re
import sqlite3

import numpy as np
import pytest
try:  # arrow before torch: loaded after it, arrow's parquet writer crashes the process
    import pyarrow  # noqa: F401
except ImportError:
    pass
import torch

from tests.oracle import assert_rows_equal
from tests.test_functions import SQLITE_SHARED
from tests.test_torch_tpch import port, run_with_kernels  # noqa: F401 (fixture)

torch.set_num_threads(1)

_KERNELS = pytest.mark.parametrize("kernels_on", [True, False],
                                   ids=["kernels_on", "kernels_off"])


@_KERNELS
@pytest.mark.parametrize(
    "name",
    [
        # the oracle side of math_basic needs sqlite >= 3.35 (sign())
        pytest.param(
            n,
            marks=pytest.mark.skipif(
                sqlite3.sqlite_version_info < (3, 35),
                reason=f"sqlite {sqlite3.sqlite_version} lacks sign()",
            ),
        )
        if n == "math_basic"
        else n
        for n in sorted(SQLITE_SHARED)
    ],
)
def test_function_vs_oracle(name, kernels_on, port, oracle):  # noqa: F811
    sql = SQLITE_SHARED[name]
    assert_rows_equal(run_with_kernels(port, sql, kernels_on), oracle.query(sql),
                      ordered="order by" in sql)


def test_string_functions_python(port, tpch_tiny):  # noqa: F811
    names = [str(v) for v in tpch_tiny["nation"]["n_name"]]
    comments = [str(v) for v in tpch_tiny["nation"]["n_comment"]]
    order = np.argsort(tpch_tiny["nation"]["n_nationkey"])
    rows = port.query(
        "select strpos(n_name, 'AN'), starts_with(n_name, 'A'),"
        " lpad(n_name, 5, '*'), rpad(n_name, 4, '.'),"
        " split_part(n_comment, ' ', 1), reverse(n_name)"
        " from nation order by n_nationkey"
    )
    for i, oi in enumerate(order):
        s, c = names[oi], comments[oi]
        lpad = ("*" * 5)[: max(0, 5 - len(s))] + s if len(s) < 5 else s[:5]
        rpad = s + ("." * 4)[: max(0, 4 - len(s))] if len(s) < 4 else s[:4]
        exp = (
            s.find("AN") + 1, s.startswith("A"), lpad, rpad,
            c.split(" ")[0], s[::-1],
        )
        assert rows[i] == exp, (rows[i], exp)


def test_regexp_functions(port, tpch_tiny):  # noqa: F811
    names = [str(v) for v in tpch_tiny["nation"]["n_name"]]
    order = np.argsort(tpch_tiny["nation"]["n_nationkey"])
    rows = port.query(
        "select regexp_like(n_name, '^[A-C]'), regexp_replace(n_name, '[AEIOU]', '_'),"
        " regexp_extract(n_name, '([A-Z]+)A', 1) from nation order by n_nationkey"
    )
    for i, oi in enumerate(order):
        s = names[oi]
        m = re.search("([A-Z]+)A", s)
        exp = (
            bool(re.search("^[A-C]", s)),
            re.sub("[AEIOU]", "_", s),
            m.group(1) if m else None,  # no match is NULL, not ''
        )
        assert rows[i] == exp, (rows[i], exp)


def test_float_math(port):  # noqa: F811
    rows = port.query(
        "select ln(s_suppkey), exp(1.0), log10(100), sqrt(s_suppkey),"
        " greatest(s_suppkey, 50), least(s_suppkey, 50),"
        " bitwise_and(s_suppkey, 6), bitwise_or(s_suppkey, 8)"
        " from supplier order by s_suppkey limit 3"
    )
    k = 1
    assert abs(rows[0][0] - math.log(k)) < 1e-9
    assert abs(rows[0][1] - math.e) < 1e-9
    assert rows[0][2] == 2.0
    assert rows[0][4:] == (50, 1, 0, 9)
    # ln of a non-positive argument is NULL, not NaN
    rows = port.query("select ln(n_regionkey - 2) from nation where n_regionkey = 0")
    assert rows and all(r[0] is None for r in rows)


def test_trig_domain_null(port):  # noqa: F811
    rows = port.query("select asin(n_regionkey) from nation where n_regionkey >= 2")
    assert rows and all(r[0] is None for r in rows)


def test_date_functions(port):  # noqa: F811
    rows = port.query(
        "select date_trunc('month', d), date_trunc('year', d), date_trunc('week', d),"
        " quarter(d), day_of_week(d), day_of_year(d), last_day_of_month(d),"
        " date_diff('day', date '2024-01-01', d)"
        " from (select date '2024-02-15' as d from nation limit 1)"
    )
    assert rows[0] == (
        "2024-02-01", "2024-01-01", "2024-02-12", 1, 4, 46, "2024-02-29", 45,
    )


def test_null_producing_string_functions(port):  # noqa: F811
    rows = port.query(
        "select split_part(n_name, 'ZZZZ', 3), regexp_extract(n_name, 'q(x)?'),"
        " truncate(3.456, 2), 'n=' || n_name || '!' from nation limit 1"
    )
    assert rows[0][0] is None  # out-of-range split index
    assert rows[0][1] is None  # unmatched regex
    assert abs(rows[0][2] - 3.45) < 1e-9  # truncate honors the scale arg
    assert rows[0][3].startswith("n=") and rows[0][3].endswith("!")


@_KERNELS
def test_functions_in_where_and_group(kernels_on, port, oracle):  # noqa: F811
    # functions compose with filters and aggregation
    sql = (
        "select upper(o_orderstatus), count(*) from orders"
        " where length(o_orderpriority) > 5 group by upper(o_orderstatus)"
    )
    assert_rows_equal(run_with_kernels(port, sql, kernels_on), oracle.query(sql), ordered=False)


def test_try_cast(port):  # noqa: F811
    rows = port.query(
        "select try_cast(s as bigint), try_cast(s as double),"
        " try_cast(s as date) from"
        " (select 'abc' as s from nation limit 1)"
    )
    assert rows[0] == (None, None, None)
    rows = port.query(
        "select try_cast(s as bigint) from (select '42' as s from nation limit 1)"
    )
    assert rows[0] == (42,)
    rows = port.query("select try_cast('2024-01-15' as date)")
    assert rows[0] == ("2024-01-15",)


def test_try_cast_column(port, tpch_tiny):  # noqa: F811
    # mixed parseable/unparseable values in one dictionary
    rows = port.query(
        "select try_cast(substring(n_name, 1, 1) as bigint) from nation limit 3"
    )
    assert rows and all(r[0] is None for r in rows)  # letters never parse
    # digits parse: the first two characters of every phone are its country
    rows = port.query(
        "select c_phone, try_cast(substring(c_phone, 1, 2) as bigint),"
        " cast(substring(c_phone, 1, 2) as integer) from customer order by c_custkey limit 20"
    )
    for phone, t, c in rows:
        assert t == c == int(phone[:2])


def test_varchar_casts(port):  # noqa: F811
    """Casts from varchar parse each distinct value on the host (an error
    where one does not parse); a cast to varchar is refused, as the
    reference refuses it."""
    rows = port.query(
        "select cast(s as double), cast(s as decimal(8, 3)), cast(d as date) from"
        " (select '12.5' as s, '1998-12-01' as d from nation limit 1)"
    )
    from decimal import Decimal

    assert rows[0] == (12.5, Decimal("12.500"), "1998-12-01")
    with pytest.raises(ValueError):
        port.query("select cast(n_name as bigint) from nation")
    with pytest.raises(NotImplementedError, match="cast to varchar"):
        port.query("select cast(n_nationkey as varchar) from nation")
