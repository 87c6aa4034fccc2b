"""Radix-select TopN (kernel 5) of the port against the reference: the u32
key map, the threshold (the port's three digit passes against the
reference's four byte passes, which run through its segmented reduce's XLA
fallback on the CPU), and top_n with the radix path forced (`topk.FORCE`,
both packages) — rows and the candidate count `required`.  The lane-width
case: an int64 key whose values fit int32 must give the candidate count the
reference gives on the int32 lane it narrows such a column to.  The CUDA
kernels are held against their plain versions on the card by chip_smoke.py
and by the `cuda`-marked test here."""

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
    """The digits are 11, 11 and 10 bits: a pass counts the digit of the live
    rows whose higher digits equal the prefix's."""
    from trino_tpu_torch.ops.cuda import topk

    rows = [(3 << 21) | (5 << 10) | 7, (3 << 21) | (5 << 10) | 8, (3 << 21) | (6 << 10) | 7,
            (4 << 21) | (5 << 10) | 7, -1]
    u = torch.tensor(rows, dtype=torch.int64).to(torch.int32)
    live = torch.tensor([True, True, True, True, False])
    h21 = topk.plain_radix_histogram(u, live, torch.tensor(0), 21)
    assert h21.shape == (2048,) and h21[3] == 3 and h21[4] == 1 and h21.sum() == 4
    h10 = topk.plain_radix_histogram(u, live, torch.tensor(3 << 21), 10)
    assert h10.shape == (2048,) and h10[5] == 2 and h10[6] == 1 and h10.sum() == 3
    h0 = topk.plain_radix_histogram(u, live, torch.tensor((3 << 21) | (5 << 10)), 0)
    assert h0.shape == (1024,) and h0[7] == 1 and h0[8] == 1 and h0.sum() == 2
    with pytest.raises(ValueError, match="digit boundary"):
        topk.plain_radix_histogram(u, live, torch.tensor(0), 24)


def _keys(kind: str, n: int, seed: int):
    """u32 keys of one kind, and a live mask, made with numpy from a seed."""
    rng = np.random.default_rng(seed)
    live = rng.random(n) < 0.9
    if kind == "random":
        u = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    elif kind == "prices":  # int32-mapped cent values: one top byte for every row
        u = (rng.integers(90_000, 10_500_000, n) + 2**31).astype(np.uint32)
    else:  # every key equal: the candidate buffer cannot hold the chosen bin
        u = np.full(n, 0x80001234, np.uint32)
    return u, live


@pytest.mark.parametrize("kind", ["random", "prices", "all_equal"])
@pytest.mark.parametrize("k", [1, 10, 4096])
def test_plain_selection_matches_reference(kind, k):
    """The three-pass selection gives the reference's threshold exactly, and
    each pass's histogram is the plain count at the prefix it reached."""
    import jax.numpy as jnp

    from trino_tpu.ops.pallas import topk as ref
    from trino_tpu_torch.ops.cuda import topk

    u, live = _keys(kind, 20_000, 40 + k)
    tu, tl = torch.from_numpy(u.view(np.int32)), torch.from_numpy(live)
    sel = topk.plain_radix_select(tu, tl, k)
    want = ref.radix_topk_threshold(jnp.asarray(u), jnp.asarray(live), k)
    thr = int(sel.threshold)
    assert thr == int(np.asarray(want))
    assert thr == int(np.sort(u[live])[::-1][k - 1])
    for (shift, bits), hist in zip(topk.DIGITS, sel.hists):
        prefix = torch.tensor(thr & ((0xFFFFFFFF << (shift + bits)) & 0xFFFFFFFF))
        assert hist.dtype == torch.int32 and hist.shape == (1 << bits,)
        assert torch.equal(hist.to(torch.int64), topk.plain_radix_histogram(tu, tl, prefix, shift))
    assert int(sel.hists[0].sum()) == int(live.sum())


def test_plain_selection_k_above_the_live_rows_takes_the_smallest():
    """The port's rule when K exceeds the live rows: the smallest live key,
    through the lowest non-empty bin of every pass; every live row is then a
    candidate, listed in row order."""
    from trino_tpu_torch.ops.cuda import topk

    for kind in ("random", "prices", "all_equal"):
        u, live = _keys(kind, 5000, 7)
        live &= np.random.default_rng(8).random(5000) < 0.05
        tu, tl = torch.from_numpy(u.view(np.int32)), torch.from_numpy(live)
        sel = topk.plain_radix_select(tu, tl, 4096, cap=512)
        assert int(sel.threshold) == int(u[live].min())
        assert int(sel.required) == int(live.sum())
        assert sel.ids[: int(live.sum())].tolist() == np.nonzero(live)[0].tolist()


def test_plain_candidates_are_the_first_cap_rows_in_row_order():
    from trino_tpu_torch.ops.cuda import topk

    u, live = _keys("prices", 20_000, 3)
    tu, tl = torch.from_numpy(u.view(np.int32)), torch.from_numpy(live)
    thr = int(np.sort(u[live])[::-1][299])
    rows = np.nonzero(live & (u >= thr))[0]
    for cap in (1024, 100):
        ids, required = topk.plain_radix_candidates(tu, tl, torch.tensor(thr), cap)
        assert int(required) == len(rows) == 300
        m = min(cap, len(rows))
        assert ids.shape == (cap,) and ids[:m].tolist() == rows[:m].tolist()


def test_selection_of_an_offset_view_equals_a_copy():
    """Keys and live mask that start inside their storage (the kernel's
    unaligned head rows) give what a contiguous copy gives."""
    from trino_tpu_torch.ops.cuda import topk

    u, live = _keys("random", 10_007, 11)
    tu, tl = torch.from_numpy(u.view(np.int32)), torch.from_numpy(live)
    for a, b in ((1, 3), (3, 0), (2, 5)):
        n = 10_000
        vu, vl = tu[a:a + n], tl[b:b + n]
        got = topk.radix_select(vu, vl, 10, cap=64)
        want = topk.radix_select(vu.clone(), vl.clone(), 10, cap=64)
        assert vu.storage_offset() == a and int(got.threshold) == int(want.threshold)
        assert int(got.required) == int(want.required)
        assert torch.equal(got.ids, want.ids)


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
    """Every pass's histogram, the threshold, the candidates' ids and
    `required` of the card's selection equal the plain version's — with the
    buffer (random keys, prices at K = 10), past it (prices at K = 4096 over
    100,003 rows, every key equal) and on offset views."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run chip_smoke.py on the card)")
    from trino_tpu_torch.ops.cuda import topk

    dev = torch.device("cuda")
    for kind in ("random", "prices", "all_equal"):
        u, live = _keys(kind, 100_003, 9)
        tu = torch.from_numpy(u.view(np.int32)).to(dev)
        tl = torch.from_numpy(live).to(dev)
        for k, (a, b) in ((1, (0, 0)), (10, (0, 0)), (4096, (0, 0)), (10, (1, 3)), (10, (3, 2))):
            vu, vl = tu[a:a + 100_000], tl[b:b + 100_000]
            got = topk.radix_select(vu, vl, k, cap=16384)
            want = topk.plain_radix_select(vu, vl, k, cap=16384)
            assert int(got.threshold) == int(want.threshold)
            for g, w in zip(got.hists, want.hists):
                assert torch.equal(g, w)
            req = int(want.required)
            assert int(got.required) == req
            m = min(req, 16384)
            if req <= 16384:
                assert torch.equal(got.ids[:m], want.ids[:m])
            else:  # past the cap: some `cap` candidates, ascending
                ids = got.ids[:m]
                assert bool((ids[1:] > ids[:-1]).all())
                assert bool(vl[ids].all())
                assert bool(((vu[ids].to(torch.int64) & 0xFFFFFFFF) >= int(got.threshold)).all())
