"""Hash build (kernel 3) and the hash / sort GROUP BY of the port against the
reference.  The build's plain version is held against the reference's Pallas
kernel in interpret mode (group ids come in claim order, so the comparison
is of the partition of the rows); the hashing helpers bit for bit; the
port's group_aggregate — hash path and sort exit — against the reference's
group_aggregate (its sort path on the CPU), groups compared as sets.  The
CUDA kernel is held against the same plain version on the card by
chip_smoke.py."""

import numpy as np
import pytest
try:  # arrow before torch: loaded after it, arrow's parquet writer crashes the process
    import pyarrow  # noqa: F401
except ImportError:
    pass
import torch

torch.set_num_threads(1)

_I64 = np.iinfo(np.int64)


@pytest.fixture(autouse=True)
def _restore_policies():
    yield
    from trino_tpu.ops import kernels as ref_kernels
    from trino_tpu_torch.ops import kernels

    kernels.set_policy(kernels.KernelPolicy())
    ref_kernels.set_policy(ref_kernels.KernelPolicy())


def _same_partition(a, b) -> bool:
    """Two id vectors name the same groups: -1 in the same rows, and a
    one-to-one map between the ids of the rest."""
    a, b = np.asarray(a).astype(np.int64), np.asarray(b).astype(np.int64)
    if not np.array_equal(a < 0, b < 0):
        return False
    m = a >= 0
    pairs = set(zip(a[m].tolist(), b[m].tolist()))
    return len(pairs) == len(set(a[m].tolist())) == len(set(b[m].tolist()))


def test_mix64_and_hash_words_match_reference_bit_for_bit():
    import jax.numpy as jnp

    from trino_tpu.ops import relops as ref
    from trino_tpu.ops.pallas import hashagg as ref_hashagg
    from trino_tpu_torch.ops import relops as port
    from trino_tpu_torch.ops.cuda import hashagg

    rng = np.random.default_rng(3)
    x = rng.integers(_I64.min, _I64.max, size=5000, dtype=np.int64)
    x[:6] = (_I64.min, _I64.max, 0, -1, 1, 2**32)
    got = port._mix64(torch.from_numpy(x)).numpy().view(np.uint64)
    want = np.asarray(ref._mix64(jnp.asarray(x.view(np.uint64))))
    assert np.array_equal(got, want)

    words = [rng.integers(-2**31, 2**31 - 1, size=5000).astype(np.int32) for _ in range(6)]
    live = rng.random(5000) < 0.8
    got = hashagg.hash_words([torch.from_numpy(w) for w in words], torch.from_numpy(live))
    want = ref_hashagg.hash_words([jnp.asarray(w) for w in words], jnp.asarray(live))
    assert np.array_equal(got.numpy().view(np.uint64), np.asarray(want))


def _key_columns(n, seed):
    """Both packages' ColumnVals over the same numpy data: an int64 key with
    NULLs, a double, a dictionary key, a decimal128 key, an int32 key."""
    from trino_tpu.data.page import Dictionary as RefDict
    from trino_tpu.data.types import BIGINT, DOUBLE, INTEGER, VARCHAR, DecimalType
    from trino_tpu.ops.expr import ColumnVal as RefCV
    from trino_tpu_torch.data.page import Dictionary
    from trino_tpu_torch.ops.expr import ColumnVal
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    vals = [f"s{i}" for i in range(20)]
    cols = [
        (rng.integers(-(1 << 40), 1 << 40, n), rng.random(n) > 0.1, None, BIGINT, None),
        (rng.normal(0, 1, n).round(1), None, None, DOUBLE, None),
        (rng.integers(0, 20, n).astype(np.int32), None, "dict", VARCHAR, None),
        (rng.integers(-(1 << 62), 1 << 62, n), rng.random(n) > 0.05, None,
         DecimalType(38, 0), rng.integers(-3, 3, n)),
        (rng.integers(-50, 50, n).astype(np.int32), None, None, INTEGER, None),
    ]
    cols[1][0][:3] = (0.0, -0.0, 0.0)
    ref_d, port_d = RefDict(np.asarray(vals, object)), Dictionary(np.asarray(vals, object))

    def wrap(cv_cls, conv, dct):
        return [
            cv_cls(conv(d), None if v is None else conv(v), dct if k == "dict" else None, t,
                   None if hi is None else conv(hi))
            for d, v, k, t, hi in cols
        ]

    return wrap(RefCV, jnp.asarray, ref_d), wrap(ColumnVal, torch.from_numpy, port_d)


@pytest.mark.parametrize("for_join", [False, True], ids=["group_by", "join"])
def test_hash_key_words_and_combined_hash_match_reference(for_join):
    import jax.numpy as jnp

    from trino_tpu.ops import relops as ref
    from trino_tpu_torch.ops import relops as port

    n = 3000
    ref_cols, port_cols = _key_columns(n, seed=5)
    keys = [0, 2, 3, 4] if not for_join else [0, 1, 2, 3, 4]
    rw, rlay = ref._hash_key_words([ref_cols[i] for i in keys], n, for_join)
    pw, play = port._hash_key_words([port_cols[i] for i in keys], n, for_join)
    assert play == rlay
    assert len(pw) == len(rw)
    for g, w in zip(pw, rw):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w))
    if not for_join:  # a double key cannot group by words
        assert port._hash_key_words([port_cols[1]], n, False) == (None, None)

    live = np.random.default_rng(9).random(n) < 0.9
    got = port._combined_hash([port_cols[i] for i in keys], torch.from_numpy(live), n,
                              port._SENT_BUILD)
    want = ref._combined_hash([ref_cols[i] for i in keys], jnp.asarray(live), n,
                              ref._SENT_BUILD)
    assert np.array_equal(got.numpy(), np.asarray(want))


def keys_in_runs(n: int, n_words: int, seed: int):
    """n rows whose keys come in runs of equal keys, run lengths 1..7 (as
    lineitem's lines of one order), each run a new random key of n_words
    int32 words, live or dead a run at a time (about half live).  Returns
    (rows [n, n_words] int32, live [n] bool)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 8, n)
    run = np.repeat(np.arange(n), lens)[:n]
    keys = rng.integers(-2**31, 2**31 - 1, size=(n, n_words)).astype(np.int32)
    return keys[run], (rng.random(n) < 0.5)[run]


BUILD_CASES = ["random", "runs-1", "runs-2", "runs-3", "runs-6"]


def _build_rows(case: str, n: int, seed: int, n_keys: int = 300, live_share: float = 0.85):
    """(rows [n, W] int32, live [n] bool) of a build case: `random` draws
    the rows from n_keys keys of 3 words at random (duplicates inside one
    sub-chunk of the reference), `runs-W` brings W-word keys in runs
    (keys_in_runs: W = 1, 2, 3, 6 cover every record size, 8, 16 and 32
    bytes)."""
    if case == "random":
        rng = np.random.default_rng(seed)
        uniq = rng.integers(-2**31, 2**31 - 1, size=(n_keys, 3)).astype(np.int32)
        return uniq[rng.integers(0, n_keys, n)], rng.random(n) < live_share
    W = int(case.split("-")[1])
    return keys_in_runs(n, W, seed + W)


@pytest.mark.parametrize("case", BUILD_CASES)
def test_plain_build_vs_reference_kernel_interpreted(case):
    """The plain build and one interpret-mode run of the reference build
    over the same rows: the same n_groups and overflow, the same partition
    of the rows, -1 for dead rows, and group_keys holding each group's
    key."""
    import jax.numpy as jnp

    from trino_tpu.ops.pallas import hashagg as ref
    from trino_tpu_torch.ops.cuda import hashagg

    rows, live = _build_rows(case, 4096 if case == "random" else 2000, 13)
    cap = 512
    W = rows.shape[1]
    words = [np.ascontiguousarray(rows[:, i]) for i in range(W)]
    gid, table, n_groups, overflow = hashagg.build_hash_table(
        [torch.from_numpy(w) for w in words], torch.from_numpy(live), cap
    )
    r_gid, _, r_n, r_over = ref.build_hash_table(
        [jnp.asarray(w) for w in words], jnp.asarray(live), cap, interpret=True
    )
    assert int(n_groups) == int(r_n) == len({tuple(r) for r in rows[live]})
    assert bool(overflow) is bool(r_over) is False
    assert _same_partition(gid.numpy(), np.asarray(r_gid))
    assert gid.dtype == torch.int32 and (gid.numpy()[~live] == -1).all()
    assert table.slots.shape == (hashagg.table_size(cap), hashagg.record_words(W))
    # the words the build kept per group id are the group's key
    gk = table.group_keys.numpy()
    g = gid.numpy()
    for i in range(W):
        assert np.array_equal(gk[i][g[live]], words[i][live])


def test_build_overflow_and_walk_budget():
    from trino_tpu_torch.ops.cuda import hashagg

    rng = np.random.default_rng(17)
    n = 3000
    w = [torch.from_numpy(rng.integers(0, 900, n).astype(np.int32))]
    live = torch.ones(n, dtype=torch.bool)
    gid, table, n_groups, overflow = hashagg.build_hash_table(w, live, 512)
    assert bool(overflow) and int(n_groups) > 512  # more keys than the tier
    assert table.size == 1024
    gid, _, n_groups, overflow = hashagg.build_hash_table(w, live, 1024)
    assert not bool(overflow) and int(n_groups) == len(set(w[0].tolist()))
    # a walk past its budget raises the flag and leaves its row unassigned
    old = hashagg.PROBE_LIMIT
    hashagg.PROBE_LIMIT = 0
    try:
        gid0, _, _, over0 = hashagg.build_hash_table(w, live, 1024)
    finally:
        hashagg.PROBE_LIMIT = old
    assert bool(over0) and (gid0 == -1).any()
    # empty and all-dead inputs
    for live_n in (torch.zeros(n, dtype=torch.bool), torch.zeros(0, dtype=torch.bool)):
        k = live_n.shape[0]
        gid, _, n_groups, overflow = hashagg.build_hash_table(
            [torch.zeros(k, dtype=torch.int32)], live_n, 8
        )
        assert int(n_groups) == 0 and not bool(overflow) and (gid == -1).all()


# ------------------------------------------------------------ group_aggregate


def _norm_groups(out, to_np):
    """Live groups as a sorted list of (key..., agg...) tuples."""
    out_keys, out_aggs, out_live, n_groups = out
    live = to_np(out_live).astype(bool)
    rows = []
    for g in np.nonzero(live)[0]:
        row = []
        for k in out_keys:
            d = to_np(k[0])[g]
            ok = True if k[1] is None else bool(to_np(k[1])[g])
            if k[2] is not None:
                full = int(to_np(k[2])[g]) * (1 << 64) + int(np.asarray(d).astype(np.int64).view(np.uint64))
                row.append((ok, full if ok else None))
            else:
                row.append((ok, d.item() if ok else None))
        for a in out_aggs:
            d = to_np(a[0])[g]
            ok = True if a[1] is None else bool(to_np(a[1])[g])
            if len(a) == 4:
                full = int(to_np(a[3])[g]) * (1 << 64) + int(np.asarray(d).astype(np.int64).view(np.uint64))
                row.append((ok, full if ok else None))
            else:
                row.append((ok, round(float(d), 6) if ok else None))
        rows.append(tuple(row))
    return sorted(rows, key=repr), int(to_np(n_groups))


def _case(rows: str):
    """A GROUP BY over the key kinds the hash words carry, with every fused
    aggregate (NULL arguments and decimal128 sums included).  `mixed`: an
    int64 key, an int32 key with NULLs and a dictionary key (5 words with
    the validity word); `dec128`: a decimal128 key and the int32 key (6
    words, the most a row may have); `all_dead`: `mixed` with no live row."""
    from trino_tpu.data.types import BIGINT, DOUBLE, INTEGER, VARCHAR, DecimalType

    rng = np.random.default_rng(7)
    n = 3000
    t38 = DecimalType(38, 2)
    big = (rng.integers(-1000, 1000, n), rng.random(n) > 0.15, None, BIGINT, None)
    dec = (rng.integers(-(1 << 62), 1 << 62, n), rng.random(n) > 0.1, None, t38,
           rng.integers(-4, 4, n))
    dbl = (rng.normal(0, 10, n), None, None, DOUBLE, None)
    i32 = (rng.integers(-5, 5, n).astype(np.int32), rng.random(n) > 0.1, None, INTEGER, None)
    if rows == "dec128":
        keys = [(rng.integers(0, 40, n), None, None, DecimalType(38, 0), rng.integers(-2, 2, n)), i32]
    else:
        keys = [(rng.integers(0, 8, n) * ((1 << 37) + 12345), None, None, BIGINT, None), i32,
                (rng.integers(0, 30, n).astype(np.int32), None, "dict", VARCHAR, None)]
    aggs = [
        (big, "sum", None), (big, "count", None), (big, "min", None), (big, "max", None),
        (big, "avg", None), (None, "count_star", None), (dec, "sum", t38), (dec, "min", t38),
        (dec, "max", t38), (dbl, "sum", None), (dbl, "avg", None),
    ]
    live = np.zeros(n, bool) if rows == "all_dead" else rng.random(n) > 0.2
    return keys, [a for a, _, _ in aggs], [f for _, f, _ in aggs], [t for _, _, t in aggs], live, 4096


def _build_case(case, cv_cls, conv, dct):
    keys, args, fns, types, live, G = case

    def col(c):
        if c is None:
            return None
        d, v, k, t, hi = c
        return cv_cls(conv(d), None if v is None else conv(v), dct if k == "dict" else None, t,
                      None if hi is None else conv(hi))

    return [col(c) for c in keys], [col(c) for c in args], fns, types, conv(live), G


def _reference_groups(case, dictionary):
    """The reference's group_aggregate (its sort path on the CPU) over a
    numpy case, traced once under jax.jit: one compile instead of one per
    eager primitive."""
    import jax
    import jax.numpy as jnp

    from trino_tpu.ops import relops as ref
    from trino_tpu.ops.expr import ColumnVal as RefCV

    keys, args, fns, types, live, G = case

    def arrays(col):
        return None if col is None else (col[0], col[1], col[4])

    def run(packed):
        pk, pa, lv = packed

        def cv(p, col):
            if p is None:
                return None
            return RefCV(p[0], p[1], dictionary if col[2] == "dict" else None, col[3], p[2])

        return ref.group_aggregate(
            [cv(p, c) for p, c in zip(pk, keys)], [cv(p, c) for p, c in zip(pa, args)],
            [ref.AggSpec(f, type=t) for f, t in zip(fns, types)], lv, G,
        )

    packed = ([arrays(c) for c in keys], [arrays(c) for c in args], live)
    return _norm_groups(jax.jit(run)(jax.tree_util.tree_map(jnp.asarray, packed)), np.asarray)


_REF_GROUPS: dict = {}


@pytest.mark.parametrize("path", ["hash", "sort_exit"])
@pytest.mark.parametrize("rows", ["mixed", "dec128", "all_dead"])
def test_group_aggregate_matches_reference(rows, path):
    from trino_tpu.data.page import Dictionary as RefDict
    from trino_tpu_torch.data.page import Dictionary
    from trino_tpu_torch.ops import kernels, relops
    from trino_tpu_torch.ops.expr import ColumnVal

    c = _case(rows)
    vals = np.asarray([f"v{i}" for i in range(30)], object)
    pk, pa, fns, types, pl, G = _build_case(c, ColumnVal, torch.from_numpy, Dictionary(vals))
    if rows not in _REF_GROUPS:
        _REF_GROUPS[rows] = _reference_groups(c, RefDict(vals))
    kernels.set_policy(kernels.KernelPolicy(enabled=path == "hash"))
    events = kernels.begin_capture()
    try:
        out = relops.group_aggregate(
            pk, pa, [relops.AggSpec(f, type=t) for f, t in zip(fns, types)], pl, G
        )
    finally:
        kernels.end_capture()
    got = _norm_groups(out, lambda t: t.numpy())
    assert got == _REF_GROUPS[rows]
    assert (got[1] == 0) == (rows == "all_dead")
    impl = {e[1] for e in events if e[0] == "group_by"}
    assert impl == ({"torch"} if path == "hash" else {"sort"})


def test_group_by_overflow_inflates_then_sorts_past_the_limit():
    """More groups than the tier: the hash path reports n_groups > cap (the
    executor's retry signal); at a doubled tier it matches the reference;
    past hash_agg_kernel_limit the gate dispatches `fallback` and the sort
    exit matches too."""
    from trino_tpu.data.types import BIGINT
    from trino_tpu_torch.ops import kernels, relops
    from trino_tpu_torch.ops.expr import ColumnVal

    rng = np.random.default_rng(29)
    n = 4000
    key, arg = rng.integers(0, 700, n), rng.integers(0, 9, n)
    pk = [ColumnVal(torch.from_numpy(key), None, None, BIGINT)]
    pa = [ColumnVal(torch.from_numpy(arg), None, None, BIGINT)]
    live = torch.ones(n, dtype=torch.bool)
    spec = [relops.AggSpec("sum")]
    out = relops.group_aggregate(pk, pa, spec, live, 512)
    assert int(out[3]) > 512
    want = _reference_groups(
        ([(key, None, None, BIGINT, None)], [(arg, None, None, BIGINT, None)], ["sum"], [None],
         np.ones(n, bool), 1024),
        None,
    )
    assert _norm_groups(relops.group_aggregate(pk, pa, spec, live, 1024), lambda t: t.numpy()) == want
    kernels.set_policy(kernels.KernelPolicy(hash_agg_max_groups=512))
    events = kernels.begin_capture()
    try:
        got = relops.group_aggregate(pk, pa, spec, live, 1024)
    finally:
        kernels.end_capture()
    assert ("group_by", "fallback") in {(e[0], e[1]) for e in events}
    assert _norm_groups(got, lambda t: t.numpy()) == want


def test_value_sorted_aggregates_still_raise():
    from trino_tpu.data.types import BIGINT
    from trino_tpu_torch.ops import relops
    from trino_tpu_torch.ops.expr import ColumnVal

    k = ColumnVal(torch.arange(10), None, None, BIGINT)
    with pytest.raises(NotImplementedError, match="ROADMAP A.7"):
        relops.group_aggregate([k], [k], [relops.AggSpec("count", distinct=True)],
                               torch.ones(10, dtype=torch.bool), 16)


def test_policy_defaults_are_the_cards():
    from trino_tpu_torch.ops import kernels
    from trino_tpu_torch.runtime.session import SessionProperties

    p = kernels.KernelPolicy()
    assert p.hash_agg_max_groups == p.hash_join_max_build == 1 << 24
    s = SessionProperties()
    assert s.get("hash_agg_kernel_limit") == s.get("hash_join_kernel_limit") == 1 << 24


@pytest.mark.cuda
@pytest.mark.parametrize("case", BUILD_CASES)
def test_kernel_matches_plain_version_on_the_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run chip_smoke.py on the card)")
    from trino_tpu_torch.ops.cuda import hashagg

    rows, live_np = _build_rows(case, 100003, 5, n_keys=5000, live_share=0.9)
    cap = 8192 if case == "random" else 100003
    dev = torch.device("cuda")
    words = [torch.from_numpy(np.ascontiguousarray(c)).to(dev) for c in rows.T]
    live = torch.from_numpy(live_np).to(dev)
    gid, table, n, over = hashagg.build_hash_table(words, live, cap)
    pgid, _, pn, pover = hashagg.plain_build_hash_table(words, live, cap)
    assert int(n) == int(pn) and bool(over) is bool(pover) is False
    assert _same_partition(gid.cpu().numpy(), pgid.cpu().numpy())
    g = gid.cpu().numpy()[live_np]
    for i, w in enumerate(words):
        assert torch.equal(table.group_keys[i].cpu()[g], w.cpu()[live_np])
