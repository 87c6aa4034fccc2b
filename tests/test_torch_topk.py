"""Radix-select TopN (kernel 5) of the port against the reference: the u32
key map, the four-pass threshold (the reference's passes run through its
segmented reduce's XLA fallback on the CPU), and top_n with the radix path
forced (`topk.FORCE`, both packages) — rows and the candidate count
`required`.  The lane-width case: an int64 key whose values fit int32 must
give the candidate count the reference gives on the int32 lane it narrows
such a column to.  The CUDA histogram kernel is held against its plain
version on the card by chip_smoke.py."""

import numpy as np
import pytest
try:  # arrow before torch: loaded after it, arrow's parquet writer crashes the process
    import pyarrow  # noqa: F401
except ImportError:
    pass
import torch

torch.set_num_threads(1)


@pytest.fixture
def forced():
    from trino_tpu.ops.pallas import topk as ref_topk
    from trino_tpu_torch.ops.cuda import topk

    ref_topk.FORCE = topk.FORCE = True
    yield
    ref_topk.FORCE = topk.FORCE = False


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("dtype", ["float64", "int32", "int64_wide", "bool"])
@pytest.mark.parametrize("descending", [False, True])
def test_sortable_u32_matches_reference(dtype, descending):
    import jax.numpy as jnp

    from trino_tpu.ops.pallas import topk as ref
    from trino_tpu_torch.ops.cuda import topk

    rng = np.random.default_rng(5)
    data = {
        "float64": np.concatenate([rng.normal(0, 1e6, 500), [0.0, -0.0, np.inf, -np.inf]]),
        "int32": rng.integers(-2**31, 2**31 - 1, 504).astype(np.int32),
        "int64_wide": rng.integers(-2**62, 2**62, 504),
        "bool": rng.random(504) < 0.5,
    }[dtype]
    got = topk.sortable_u32(torch.from_numpy(data), descending)
    assert got.dtype == torch.int32
    assert np.array_equal(_u32(got), np.asarray(ref.sortable_u32(jnp.asarray(data), descending)))


def test_int64_key_that_fits_int32_maps_as_int32():
    import jax.numpy as jnp

    from trino_tpu.ops.pallas import topk as ref
    from trino_tpu_torch.ops.cuda import topk

    data = np.random.default_rng(6).integers(90_000, 10_500_000, 1000)
    fits = torch.tensor(True)
    got = topk.sortable_u32(torch.from_numpy(data), True, narrow=fits)
    want = ref.sortable_u32(jnp.asarray(data.astype(np.int32)), True)
    assert np.array_equal(_u32(got), np.asarray(want))
    # without the flag the top 32 bits collapse every value into one key
    assert len(set(_u32(topk.sortable_u32(torch.from_numpy(data), True)).tolist())) == 1


@pytest.mark.parametrize("k", [1, 10, 700])
def test_radix_threshold_matches_reference(k):
    import jax.numpy as jnp

    from trino_tpu.ops.pallas import topk as ref
    from trino_tpu_torch.ops.cuda import topk

    rng = np.random.default_rng(k)
    n = 3000
    u = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    u[:400] = u[0]  # a heavy tie
    u[400:600] = rng.integers(0, 2**32, 1)[0] & 0xFFFF00FF  # shared high bytes
    live = rng.random(n) < 0.9
    got = topk.radix_topk_threshold(torch.from_numpy(u.view(np.int32)), torch.from_numpy(live), k)
    want = ref.radix_topk_threshold(jnp.asarray(u), jnp.asarray(live), k)
    assert int(got) == int(np.asarray(want))
    assert ((u >= int(got)) & live).sum() >= min(k, live.sum())


def test_radix_threshold_admits_every_live_row_when_k_exceeds_them():
    """Fewer live rows than K: the threshold is the smallest live key, so
    every live row is a candidate.  (The reference takes the largest
    non-empty bin there and drops rows — ROADMAP queue C.)"""
    from trino_tpu_torch.ops.cuda import topk

    rng = np.random.default_rng(12)
    u = rng.integers(0, 2**32, 3000, dtype=np.uint64).astype(np.uint32)
    live = rng.random(3000) < 0.1
    got = topk.radix_topk_threshold(torch.from_numpy(u.view(np.int32)), torch.from_numpy(live), 5000)
    assert int(got) == int(u[live].min())


def test_top_n_keeps_every_live_row_when_k_exceeds_them(forced):
    """Five live rows, LIMIT 10: all five come back (the reference's radix
    path returns one of them here)."""
    from trino_tpu.data.types import INTEGER
    from trino_tpu_torch.ops import relops
    from trino_tpu_torch.ops.expr import ColumnVal

    d = np.random.default_rng(1).integers(-2**31, 2**31 - 1, 5000).astype(np.int32)
    live = np.zeros(5000, bool)
    live[:5] = True
    key = ColumnVal(torch.from_numpy(d), None, None, INTEGER)
    cols, out_live, req = relops.top_n([key], torch.from_numpy(live), [key],
                                       [relops.SortSpec(False)], 10, 2048)
    assert int(req) == 5
    assert cols[0].data[out_live].tolist() == sorted(d[:5].tolist(), reverse=True)


def test_histogram_counts_only_the_prefix():
    from trino_tpu_torch.ops.cuda import topk

    u = torch.tensor([0x01020304, 0x01020305, 0x01030304, 0x02020304, -1], dtype=torch.int32)
    live = torch.tensor([True, True, True, True, False])
    h24 = topk.radix_histogram(u, live, torch.tensor(0), 24)
    assert h24[1] == 3 and h24[2] == 1 and h24.sum() == 4
    h8 = topk.radix_histogram(u, live, torch.tensor(0x01020000), 8)
    assert h8[3] == 2 and h8.sum() == 2
    with pytest.raises(ValueError, match="byte boundary"):
        topk.radix_histogram(u, live, torch.tensor(0), 4)


def _topn_case(kind, n=3000, seed=3):
    """(numpy data, valid, reference lane, port lane, type)"""
    from trino_tpu.data.types import BIGINT, DOUBLE, INTEGER, DecimalType

    rng = np.random.default_rng(seed)
    if kind == "double_nulls":
        d = rng.normal(0, 100, n).round(2)
        return d, rng.random(n) > 0.1, d, d, DOUBLE
    if kind == "int32":
        d = rng.integers(-50, 50, n).astype(np.int32)  # heavy ties
        return d, None, d, d, INTEGER
    if kind == "int64_wide":
        d = rng.integers(-2**40, 2**40, n)
        return d, rng.random(n) > 0.05, d, d, BIGINT
    # lane width: the reference narrows this column to int32 at upload
    d = rng.integers(90_000, 10_500_000, n)
    return d, None, d.astype(np.int32), d, DecimalType(12, 2)


@pytest.mark.parametrize("kind", ["double_nulls", "int32", "int64_wide", "int64_fits_int32"])
@pytest.mark.parametrize("ascending,nulls_first", [(False, False), (True, True)],
                         ids=["desc", "asc_nulls_first"])
def test_top_n_matches_reference(kind, ascending, nulls_first, forced):
    import jax.numpy as jnp

    from trino_tpu.ops import relops as ref
    from trino_tpu.ops.expr import ColumnVal as RefCV
    from trino_tpu_torch.ops import kernels, relops
    from trino_tpu_torch.ops.expr import ColumnVal

    d, valid, ref_lane, port_lane, t = _topn_case(kind)
    n = d.shape[0]
    rowid = np.arange(n, dtype=np.int64)
    live = np.random.default_rng(8).random(n) < 0.9
    k, cap = 10, 2048
    rkey = RefCV(jnp.asarray(ref_lane), None if valid is None else jnp.asarray(valid), None, t)
    pkey = ColumnVal(torch.from_numpy(port_lane),
                     None if valid is None else torch.from_numpy(valid), None, t)
    specs_r = [ref.SortSpec(ascending, nulls_first), ref.SortSpec()]
    specs_p = [relops.SortSpec(ascending, nulls_first), relops.SortSpec()]
    rid_r = RefCV(jnp.asarray(rowid), None, None, t)
    rid_p = ColumnVal(torch.from_numpy(rowid), None, None, t)
    r_cols, r_live, r_req = ref.top_n([rkey, rid_r], jnp.asarray(live), [rkey, rid_r],
                                      specs_r, k, cap)
    events = kernels.begin_capture()
    try:
        p_cols, p_live, p_req = relops.top_n([pkey, rid_p], torch.from_numpy(live),
                                             [pkey, rid_p], specs_p, k, cap)
    finally:
        kernels.end_capture()
    assert ("topn", "torch") in {(e[0], e[1]) for e in events}
    assert int(p_req) == int(np.asarray(r_req))
    if kind == "int64_fits_int32":
        assert int(p_req) < 100  # not every live row (the top-32-bit map)
    r_live = np.asarray(r_live)
    assert np.array_equal(p_live.numpy(), r_live)
    assert np.array_equal(p_cols[1].data.numpy()[r_live], np.asarray(r_cols[1].data)[r_live])


def test_top_n_declines_to_sort_below_the_radix_size():
    from trino_tpu.data.types import BIGINT
    from trino_tpu_torch.ops import kernels, relops
    from trino_tpu_torch.ops.expr import ColumnVal

    key = ColumnVal(torch.arange(1000), None, None, BIGINT)
    events = kernels.begin_capture()
    try:
        cols, live, req = relops.top_n([key], torch.ones(1000, dtype=torch.bool), [key],
                                       [relops.SortSpec(False)], 5, 16384)
    finally:
        kernels.end_capture()
    assert [(e[0], e[1]) for e in events] == [("topn", "sort")]
    assert cols[0].data.tolist() == [999, 998, 997, 996, 995] and int(req) == 0


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run chip_smoke.py on the card)")
    from trino_tpu_torch.ops.cuda import topk

    rng = np.random.default_rng(9)
    dev = torch.device("cuda")
    u = torch.from_numpy(rng.integers(0, 2**32, 1000003, dtype=np.uint64)
                         .astype(np.uint32).view(np.int32)).to(dev)
    live = torch.from_numpy(rng.random(1000003) < 0.9).to(dev)
    prefix = torch.tensor(int(u[0]) & 0xFFFFFFFF, dtype=torch.int64, device=dev)
    for shift in (24, 16, 8, 0):
        assert torch.equal(topk.radix_histogram(u, live, prefix, shift),
                           topk.plain_radix_histogram(u, live, prefix, shift))
