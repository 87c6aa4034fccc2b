"""Columnar data plane of the port vs the reference: every TPC-H SF 0.01
table loads to identical rows, and convert.py carries reference state over
without loss (NULLs, dictionaries, decimal128 high limbs)."""

import numpy as np
import pytest
try:  # arrow before torch: loaded after it, arrow's parquet writer crashes the process
    import pyarrow  # noqa: F401
except ImportError:
    pass
import torch

torch.set_num_threads(1)

TABLES = ["customer", "lineitem", "nation", "orders", "part", "partsupp", "region", "supplier"]


@pytest.mark.parametrize("table", TABLES)
def test_table_rows_identical(table, tpch_tiny):
    from trino_tpu.connectors.tpch.generator import TPCH_SCHEMAS as REF_SCHEMAS
    from trino_tpu.data.page import Page as RefPage
    from trino_tpu_torch.connectors.tpch import tpch_data
    from trino_tpu_torch.connectors.tpch.generator import TPCH_SCHEMAS
    from trino_tpu_torch.data.page import Page

    ref_cols = tpch_tiny[table]
    port_cols = tpch_data(table, 0.01)  # the port's own generator copy
    n = min(len(next(iter(ref_cols.values()))), 3000)
    names = [c for c, _ in TPCH_SCHEMAS[table]]
    assert names == [c for c, _ in REF_SCHEMAS[table]]
    for c in names:  # same generator -> same data from the same scale
        assert np.array_equal(np.asarray(ref_cols[c]), np.asarray(port_cols[c])), c
    ref_page = RefPage.from_numpy(
        [t for _, t in REF_SCHEMAS[table]], [ref_cols[c][:n] for c in names]
    )
    port_page = Page.from_numpy(
        [t for _, t in TPCH_SCHEMAS[table]], [port_cols[c][:n] for c in names],
        device="cpu",
    )
    assert port_page.capacity == ref_page.capacity == n
    assert port_page.to_pylist() == ref_page.to_pylist()


def _mixed_reference_page():
    from trino_tpu.data.page import Page as RefPage
    from trino_tpu.data.types import BIGINT, DATE, DOUBLE, DecimalType, VARCHAR

    rng = np.random.default_rng(3)
    n = 200
    big = np.empty(n, dtype=object)
    big[:] = [int(v) * (1 << 40) for v in rng.integers(-(2**62), 2**62, n)]
    big[:4] = [(1 << 100) + 7, -(1 << 100) - 7, 0, -1]
    cols = [
        np.ma.MaskedArray(rng.integers(-10**12, 10**12, n), mask=rng.random(n) < 0.2),
        np.ma.MaskedArray(
            np.asarray([f"s{v}" for v in rng.integers(0, 9, n)], dtype=object),
            mask=rng.random(n) < 0.2,
        ),
        big,
        rng.integers(8000, 11000, n).astype(np.int32),
        np.ma.MaskedArray(rng.normal(size=n), mask=rng.random(n) < 0.1),
        rng.integers(-10**6, 10**6, n),
    ]
    types = [BIGINT, VARCHAR, DecimalType(38, 2), DATE, DOUBLE, DecimalType(12, 2)]
    page = RefPage.from_numpy(types, cols)
    live = np.asarray(rng.random(n) < 0.8)
    import jax.numpy as jnp

    return page.with_live(jnp.asarray(live)), types


def _port_types(types):
    from trino_tpu_torch.data.types import parse_type

    return [parse_type(t.name) for t in types]


def test_convert_round_trip_from_numpy_columns():
    from trino_tpu_torch.convert import page_from_reference

    ref_page, types = _mixed_reference_page()
    assert ref_page.columns[2].data2 is not None  # the decimal128 column is limbed
    names = [f"c{i}" for i in range(len(types))]
    dicts = [
        None if c.dictionary is None else np.asarray(c.dictionary.values, dtype=object)
        for c in ref_page.columns
    ]
    port_page = page_from_reference(
        names, _port_types(types), ref_page.to_numpy_columns(), dicts, device="cpu"
    )
    assert port_page.to_pylist() == ref_page.to_pylist()
    assert port_page.columns[2].data2 is not None
    # the string column keeps the reference's code space
    assert list(port_page.columns[1].dictionary.values) == list(dicts[1])
    # and the port's own numpy surface gives the same arrays back
    for a, b in zip(port_page.to_numpy_columns(), ref_page.to_numpy_columns()):
        assert np.array_equal(np.ma.getmaskarray(a), np.ma.getmaskarray(b))
        assert np.array_equal(np.ma.getdata(a)[~np.ma.getmaskarray(a)],
                              np.ma.getdata(b)[~np.ma.getmaskarray(b)])


def test_convert_raw_lanes_keep_capacity_live_mask_and_limbs():
    from trino_tpu_torch.convert import page_from_lanes

    ref_page, types = _mixed_reference_page()
    lanes = [
        (
            np.asarray(c.data),
            None if c.valid is None else np.asarray(c.valid),
            None if c.dictionary is None else np.asarray(c.dictionary.values, dtype=object),
            None if c.data2 is None else np.asarray(c.data2),
        )
        for c in ref_page.columns
    ]
    port_page = page_from_lanes(
        _port_types(types), lanes, np.asarray(ref_page.live), device="cpu"
    )
    assert port_page.capacity == ref_page.capacity
    assert port_page.to_pylist() == ref_page.to_pylist()
    # narrowed reference lanes widen back to the type's width
    assert port_page.columns[5].data.dtype == torch.int64
    assert port_page.columns[3].data.dtype == torch.int32
    assert torch.equal(
        port_page.columns[2].data2, torch.from_numpy(np.asarray(ref_page.columns[2].data2))
    )


def test_dictionary_interning_and_sorted_rank():
    from trino_tpu.data.page import Dictionary as RefDictionary
    from trino_tpu_torch.data.page import Dictionary

    vals = np.asarray(["pear", "apple", "fig", "apple"], dtype=object)
    codes, d = Dictionary.encode(vals)
    rcodes, rd = RefDictionary.encode(vals)
    assert np.array_equal(codes, rcodes) and list(d.values) == list(rd.values)
    assert Dictionary.encode(vals)[1] is d  # content-keyed interning
    unsorted = Dictionary(np.asarray(["b", "c", "a"], dtype=object))
    assert list(unsorted.sorted_rank()) == [1, 2, 0]
    assert unsorted.code_of("c") == 1 and unsorted.code_of("zz") == -1


@pytest.mark.parametrize("distinct", [1, 3, 40, 5000, 200_000])
def test_dictionary_encode_equals_the_reference(distinct):
    """The port encodes a VARCHAR column by hashing its rows into their
    distinct values and sorting only those, from one value to mostly
    distinct ones (the last case): codes and dictionary must be what the
    reference's `np.unique` gives."""
    from trino_tpu.data.page import Dictionary as RefDictionary
    from trino_tpu_torch.data.page import Dictionary

    rng = np.random.default_rng(distinct)
    words = np.asarray([f"w{i:05d}" for i in rng.permutation(distinct)] + ["", "Z", "a"],
                       dtype=object)
    values = words[rng.integers(0, len(words), 20_000)]
    codes, d = Dictionary.encode(values)
    ref_codes, ref_d = RefDictionary.encode(values)
    assert codes.dtype == np.int32
    np.testing.assert_array_equal(codes, np.asarray(ref_codes))
    assert list(d.values) == list(ref_d.values)
    assert list(d.values[codes]) == list(values)
    empty_codes, empty = Dictionary.encode(np.asarray([], dtype=object))
    assert len(empty_codes) == 0 and len(empty) == 0
