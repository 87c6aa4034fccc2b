"""Segmented reduce of the port (plain PyTorch version — the CUDA kernel has
no interpret mode and is held against this plain version on the card by
chip_smoke.py) vs the reference: its XLA fallback (ints exact, doubles rel
1e-12) and its Pallas kernel in interpret mode (the reference's own
tolerance: rel 1e-6 for float sums)."""

import numpy as np
import pytest
try:  # arrow before torch: loaded after it, arrow's parquet writer crashes the process
    import pyarrow  # noqa: F401
except ImportError:
    pass
import torch

torch.set_num_threads(1)

_I64 = np.iinfo(np.int64)


def _case(n, G, seed):
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, G + 2, size=n).astype(np.int32)  # ids >= G: dead lanes
    vi = rng.integers(-10**12, 10**12, size=n).astype(np.int64)
    if n > 8:
        vi[:8] = (_I64.max, _I64.max, _I64.min, _I64.min, 0, -1, _I64.max, 1)
        seg[:8] = 0  # the extremes wrap inside one group
    return {
        "seg": seg, "vi": vi,
        "v32": rng.integers(-2**31, 2**31 - 1, size=n).astype(np.int32),
        "vf": rng.normal(0, 1e4, size=n),
        "valid": rng.random(n) < 0.7,
        "none": np.zeros(n, np.bool_),  # an all-NULL column
    }


def _reds(SegRed, wrap, c, with_int64_extremes=True):
    vi = c["vi"] if with_int64_extremes else np.clip(c["vi"], -10**12, 10**12)
    v = {k: wrap(a) for k, a in c.items()}
    v["vi"] = wrap(vi)
    return [
        SegRed("count", None, None), SegRed("count", None, v["valid"]),
        SegRed("sum", v["vi"], None), SegRed("sum", v["vi"], v["valid"]),
        SegRed("sum", v["v32"], v["valid"]), SegRed("sum", v["vf"], v["valid"]),
        SegRed("min", v["vi"], v["valid"]), SegRed("max", v["vi"], None),
        SegRed("min", v["v32"], None), SegRed("max", v["v32"], v["valid"]),
        SegRed("min", v["vf"], v["valid"]), SegRed("max", v["vf"], None),
        SegRed("sum", v["vi"], v["none"]), SegRed("min", v["vf"], v["none"]),
        SegRed("max", v["v32"], v["none"]), SegRed("count", None, v["none"]),
    ]


def _compare(got, want, rel):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, i
        if np.issubdtype(g.dtype, np.floating):
            assert np.issubdtype(w.dtype, np.floating), i
            with np.errstate(invalid="ignore"):
                both_inf = np.isinf(g) & np.isinf(w) & (g == w)
                ok = both_inf | (np.abs(g - w) <= rel * np.maximum(np.abs(w), 1.0))
            assert ok.all(), (i, g, w)
        else:
            assert g.dtype == w.dtype, (i, g.dtype, w.dtype)
            assert np.array_equal(g, w), (i, g, w)


SHAPES = [(0, 4), (1, 1), (1, 8192), (1000, 1), (1003, 6), (4099, 8192), (5001, 700)]


@pytest.mark.parametrize("n,G", SHAPES, ids=[f"n{n}-G{G}" for n, G in SHAPES])
def test_plain_version_vs_reference_fallback(n, G):
    import jax.numpy as jnp

    from trino_tpu.ops.pallas import segreduce as ref
    from trino_tpu_torch.ops.cuda import segreduce as port

    c = _case(n, G, seed=n + G)
    got = port.fused_segment_reduce(
        torch.from_numpy(c["seg"]), _reds(port.SegRed, torch.from_numpy, c), G
    )
    want = ref._xla_fallback(jnp.asarray(c["seg"]), _reds(ref.SegRed, jnp.asarray, c), G)
    _compare(got, want, rel=1e-12)


@pytest.mark.parametrize("n,G", [(1, 1), (1003, 6), (2500, 700)],
                         ids=["n1-G1", "n1003-G6", "n2500-G700"])
def test_plain_version_vs_reference_kernel_interpreted(n, G):
    import jax.numpy as jnp

    from trino_tpu.ops.pallas import segreduce as ref
    from trino_tpu_torch.ops.cuda import segreduce as port

    c = _case(n, G, seed=3 * n + G)
    port_reds = _reds(port.SegRed, torch.from_numpy, c)
    got = port.fused_segment_reduce(torch.from_numpy(c["seg"]), port_reds, G)
    want = ref.fused_segment_reduce(
        jnp.asarray(c["seg"]), _reds(ref.SegRed, jnp.asarray, c), G, interpret=True
    )
    live = (c["seg"] >= 0) & (c["seg"] < G)
    for i, (r, g, w) in enumerate(zip(port_reds, got, want)):
        g, w = g.numpy(), np.asarray(w)
        if not np.issubdtype(g.dtype, np.floating):
            assert np.array_equal(g, w.astype(g.dtype)), (i, g, w)
            continue
        with np.errstate(invalid="ignore"):
            both_inf = np.isinf(g) & np.isinf(w) & (g == w)
            err = np.where(both_inf, 0.0, np.abs(g - w))
        if r.op == "sum":
            # the reference kernel sums compensated f32: rel 1e-6 of the
            # group's sum of magnitudes (its own tolerance)
            ok = live if r.valid is None else (live & r.valid.numpy())
            mag = np.zeros(G)
            np.add.at(mag, c["seg"][ok], np.abs(r.values.numpy()[ok]))
            assert (err <= 1e-6 * np.maximum(mag, 1.0)).all(), (i, g, w)
        else:  # float min/max ride f32 lanes in the reference kernel
            assert (err <= 1e-6 * np.maximum(np.abs(g), 1.0)).all(), (i, g, w)


def test_dead_lanes_are_skipped_not_clamped():
    from trino_tpu_torch.ops.cuda.segreduce import SegRed, fused_segment_reduce

    seg = torch.tensor([0, 1, 2, 3, 7, -1, 1], dtype=torch.int32)
    vals = torch.tensor([1, 10, 100, 1000, 10000, 100000, 5], dtype=torch.int64)
    s, mx, cnt = fused_segment_reduce(
        seg, [SegRed("sum", vals, None), SegRed("max", vals, None),
              SegRed("count", None, None)], 3,
    )
    assert s.tolist() == [1, 15, 100]  # ids 3, 7 and -1 fell nowhere
    assert mx.tolist() == [1, 10, 100] and cnt.tolist() == [1, 2, 1]


def test_empty_groups_and_result_types():
    from trino_tpu_torch.ops.cuda.segreduce import SegRed, fused_segment_reduce

    seg = torch.tensor([2], dtype=torch.int32)
    out = fused_segment_reduce(
        seg,
        [SegRed("min", torch.tensor([5], dtype=torch.int32), None),
         SegRed("max", torch.tensor([5], dtype=torch.int64), None),
         SegRed("min", torch.tensor([5.0], dtype=torch.float64), None),
         SegRed("max", torch.tensor([5.0], dtype=torch.float64), None),
         SegRed("sum", torch.tensor([5.0], dtype=torch.float64), None),
         SegRed("sum", torch.tensor([True]), None)],
        3,
    )
    assert [o.dtype for o in out] == [
        torch.int32, torch.int64, torch.float64, torch.float64, torch.float64, torch.int64
    ]
    assert out[0].tolist() == [2**31 - 1, 2**31 - 1, 5]
    assert out[1].tolist() == [-(2**63), -(2**63), 5]
    assert out[2].tolist() == [float("inf"), float("inf"), 5.0]
    assert out[3].tolist() == [float("-inf"), float("-inf"), 5.0]
    assert out[4].tolist() == [0.0, 0.0, 5.0] and out[5].tolist() == [0, 0, 1]


def test_wrapper_counts_only_kernel_launches():
    from trino_tpu_torch.ops.cuda import segreduce as port

    before = port.launches()
    port.fused_segment_reduce(
        torch.zeros(4, dtype=torch.int32), [port.SegRed("count", None, None)], 1
    )
    assert port.launches() == before  # a CPU tensor never launches the kernel
    with pytest.raises(ValueError, match="unknown reduction"):
        port.fused_segment_reduce(
            torch.zeros(4, dtype=torch.int32), [port.SegRed("median", None, None)], 1
        )


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run chip_smoke.py on the card)")
    from trino_tpu_torch.ops.cuda import segreduce as port

    c = _case(100003, 6, seed=5)
    dev = torch.device("cuda")
    up = lambda a: torch.from_numpy(a).to(dev)
    reds = _reds(port.SegRed, up, c)
    got = port.fused_segment_reduce(up(c["seg"]), reds, 6)
    want = port.plain_segment_reduce(up(c["seg"]), reds, 6)
    _compare([g.cpu() for g in got], [w.cpu().numpy() for w in want], rel=1e-12)


# ---------------------------------------------- kernel 1's launch plan (host)


def _mixed_reds(n=64):
    from trino_tpu_torch.ops.cuda.segreduce import SegRed

    rng = np.random.default_rng(17)
    f = torch.from_numpy(rng.normal(size=n))
    i64 = torch.from_numpy(rng.integers(-99, 99, n).astype(np.int64))
    i32 = i64.to(torch.int32)
    b = i64 > 0
    m1, m2 = torch.from_numpy(rng.random(n) < 0.5), torch.from_numpy(rng.random(n) < 0.5)
    return [
        SegRed("max", f, m1), SegRed("sum", i64, m1), SegRed("count", None, m2),
        SegRed("min", i32, None), SegRed("sum", f, m1), SegRed("count", None, None),
        SegRed("sum", b, m2), SegRed("max", i64, m1), SegRed("min", f, m2),
        SegRed("sum", i32, None), SegRed("max", b, None), SegRed("min", i64, m1),
    ]


def test_launch_plan_sorts_by_kind_and_restores_the_callers_order():
    from trino_tpu_torch.ops.cuda import segreduce as port

    reds = _mixed_reds()
    plan = port.plan_launch(64, 6, reds, sms=132)
    names = [port._KINDS[k] for k in plan.kinds]
    assert names == sorted(names, key=port._KINDS.index)  # grouped in the kernel's order
    assert sorted(plan.order) == list(range(len(reds)))
    for pos, caller in enumerate(plan.order):
        assert plan.kinds[pos] == port._kind(reds[caller])
    ends = [0] + list(plan.kind_end)
    for k in range(len(port._KINDS)):
        assert all(plan.kinds[p] == k for p in range(ends[k], ends[k + 1]))
    # kernel-ordered rows come back in the caller's order
    rows = [torch.tensor([caller]) for caller in plan.order]
    assert [int(r) for r in plan.unsort(rows)] == list(range(len(reds)))
    # and the CPU path gives the plain results in the caller's order
    seg = torch.from_numpy(np.random.default_rng(1).integers(0, 7, 64).astype(np.int32))
    got = port.fused_segment_reduce(seg, reds, 6)
    want = port.plain_segment_reduce(seg, reds, 6)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_launch_plan_reads_each_distinct_mask_once():
    from trino_tpu_torch.ops.cuda import segreduce as port

    reds = _mixed_reds()
    plan = port.plan_launch(64, 6, reds, sms=132)
    assert len(plan.masks) == 2  # m1 and m2, each shared by several reductions
    for pos, caller in enumerate(plan.order):
        v = reds[caller].valid
        if v is None:
            assert plan.mask_of[pos] == -1
        else:
            assert plan.masks[plan.mask_of[pos]] is v
    # q01's 20 operator-path reductions all share the live mask: one entry
    live = torch.ones(64, dtype=torch.bool)
    twenty = [port.SegRed("sum", torch.zeros(64, dtype=torch.int64), live) for _ in range(19)]
    plan = port.plan_launch(64, 6, twenty + [port.SegRed("count", None, live)], sms=132)
    assert len(plan.masks) == 1 and set(plan.mask_of) == {0}


@pytest.mark.parametrize("n", [0, 1, 300, 65_536, 65_537, 64 * 2**20, 2**32 + 7])
def test_launch_plan_caps_rows_per_block_so_32_bit_words_cannot_wrap(n):
    from trino_tpu_torch.ops.cuda import segreduce as port

    reds = _mixed_reds()
    plan = port.plan_launch(n, 6, reds, sms=132)
    assert plan.shared_words > 0  # a small table: the shared route
    if n == 0:
        assert plan.blocks == 0
        return
    # grid-stride over blocks * 256 threads * R rows: a block sees at most
    # this many rows
    step = 256 * port._ROWS_PER_THREAD
    assert plan.rows_per_block == -(-n // (plan.blocks * step)) * step
    assert plan.rows_per_block <= port._BLOCK_ROWS
    assert plan.blocks * port._BLOCK_ROWS >= n
    # 16-bit limb sums and counts of a block stay below 2^32
    assert plan.rows_per_block * 0xFFFF < 2**32
    assert plan.blocks <= max(132 * 8, -(-n // port._BLOCK_ROWS))


def test_launch_plan_lays_out_the_block_table_and_picks_the_route():
    from trino_tpu_torch.ops.cuda import segreduce as port

    reds = _mixed_reds()
    G = 6
    plan = port.plan_launch(1000, G, reds, sms=132)
    spans = []
    for pos, caller in enumerate(plan.order):
        size = port._entry_words(plan.kinds[pos])
        if size == 2:
            assert plan.words[pos] % 2 == 0  # 64-bit entries on 8-byte boundaries
        spans.append((plan.words[pos], plan.words[pos] + size * G))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))  # no overlap
    assert plan.shared_words == spans[-1][1]
    assert plan.shared_words * 4 <= port._SHARED_BYTES
    # q03's 2^20 groups take the global route
    assert port.plan_launch(1000, 1 << 20, reds, sms=132).shared_words == 0
    with pytest.raises(ValueError, match="reductions in one launch"):
        port.plan_launch(10, 1, reds * 3, sms=132)


def _card_case(name):
    from trino_tpu_torch.ops.cuda.segreduce import SegRed

    rng = np.random.default_rng(41)
    n = 300_007
    G = {"g1": 1, "one_group": 6, "carries": 6, "nan_inf": 6, "global": 1 << 20}[name]
    if name in ("g1", "one_group"):
        seg = np.full(n, G - 1, np.int32)
    else:
        seg = rng.integers(0, G, n).astype(np.int32)
    vi = rng.integers(-10**12, 10**12, n).astype(np.int64)
    if name == "carries":
        vi = np.full(n, 2**32 - 1, np.int64)
        vi[::5] = 2**62 + 2**40 + 0xFFFF
    vf = rng.normal(0, 1e3, n)
    if name == "nan_inf":
        vf[[10, 20_000]] = np.nan
        vf[[11, 12, 13]] = (np.inf, -np.inf, np.inf)
    valid = rng.random(n) < 0.8
    t = torch.from_numpy
    reds = [
        SegRed("count", None, None), SegRed("count", None, t(valid)),
        SegRed("sum", t(vi), t(valid)), SegRed("sum", t(vi.astype(np.int32)), None),
        SegRed("sum", t(vf), None), SegRed("min", t(vf), None), SegRed("max", t(vf), t(valid)),
        SegRed("min", t(vi), t(valid)), SegRed("max", t(vi.astype(np.int32)), None),
    ]
    return seg, reds, G


@pytest.mark.parametrize("name", ["g1", "one_group", "carries", "nan_inf", "global"])
def test_card_cases_plain_version_vs_reference_fallback(name):
    """The card cases' inputs on the CPU: the plain version agrees with the
    reference's XLA fallback (NaN and +-inf compared as such)."""
    import jax.numpy as jnp

    from trino_tpu.ops.pallas import segreduce as ref
    from trino_tpu_torch.ops.cuda import segreduce as port

    seg, reds, G = _card_case(name)
    if name == "global":  # keep the reference's one-hot fallback small
        reds = reds[:4]
    got = port.fused_segment_reduce(torch.from_numpy(seg), reds, G)
    want = ref._xla_fallback(
        jnp.asarray(seg),
        [ref.SegRed(r.op, None if r.values is None else jnp.asarray(r.values.numpy()),
                    None if r.valid is None else jnp.asarray(r.valid.numpy())) for r in reds], G)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        if np.issubdtype(g.dtype, np.floating):
            with np.errstate(invalid="ignore"):
                same = (np.isnan(g) & np.isnan(w)) | (np.isinf(g) & (g == w))
                ok = same | (np.abs(g - w) <= 1e-9 * np.maximum(np.abs(w), 1.0))
            assert ok.all(), (name, i)
        else:
            assert np.array_equal(g, w.astype(g.dtype)), (name, i)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["g1", "one_group", "carries", "nan_inf", "global"])
def test_kernel_matches_plain_version_on_the_card_cases(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run chip_smoke.py on the card)")
    from trino_tpu_torch.ops.cuda import segreduce as port

    seg, reds, G = _card_case(name)
    dev = torch.device("cuda")
    up = lambda t: None if t is None else t.to(dev)  # noqa: E731
    got = port.fused_segment_reduce(up(torch.from_numpy(seg)),
                                    [port.SegRed(r.op, up(r.values), up(r.valid)) for r in reds], G)
    # the plain version on the CPU: torch's CUDA scatter_reduce may let a
    # later value overwrite a NaN
    want = port.plain_segment_reduce(torch.from_numpy(seg), reds, G)
    _compare_nan([g.cpu() for g in got], [w.numpy() for w in want], rel=1e-12)


def _compare_nan(got, want, rel):
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, i
        if np.issubdtype(g.dtype, np.floating):
            with np.errstate(invalid="ignore"):
                same = (np.isnan(g) & np.isnan(w)) | (np.isinf(g) & (g == w))
                ok = same | (np.abs(g - w) <= rel * np.maximum(np.abs(np.nan_to_num(w)), 1.0))
            assert ok.all(), i
        else:
            assert np.array_equal(g, w), i
