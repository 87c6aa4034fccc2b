"""Hash probe (kernel 4) and equi_join of the port against the reference.
The probe's plain version is held against the reference's Pallas kernels in
interpret mode (build + probe: group ids come in claim order, so the ids of
both sides are compared through one consistent map); equi_join of every kind,
on the port's hash path and on its sort path, against the reference's
equi_join (its sort path on the CPU).  The CUDA kernel is held against the
same plain version on the card by chip_smoke.py."""

import numpy as np
import pytest
try:  # arrow before torch: loaded after it, arrow's parquet writer crashes the process
    import pyarrow  # noqa: F401
except ImportError:
    pass
import torch

torch.set_num_threads(1)

KINDS = ["inner", "left", "full", "semi", "anti", "null_anti", "mark", "mark_in"]


@pytest.fixture(autouse=True)
def _restore_policy():
    yield
    from trino_tpu_torch.ops import kernels

    kernels.set_policy(kernels.KernelPolicy())


def test_plain_probe_vs_reference_kernel_interpreted():
    import jax.numpy as jnp

    from trino_tpu.ops.pallas import hashagg as ref_build
    from trino_tpu.ops.pallas import hashjoin as ref_probe
    from trino_tpu_torch.ops.cuda import hashagg, hashjoin

    rng = np.random.default_rng(21)
    nb, n_probe = 400, 2048
    uniq = rng.integers(-2**31, 2**31 - 1, size=(300, 2)).astype(np.int32)
    b_rows = uniq[rng.integers(0, 200, nb)]  # keys 0..199 built, 200..299 absent
    p_rows = uniq[rng.integers(0, 300, n_probe)]
    bw = [np.ascontiguousarray(b_rows[:, i]) for i in range(2)]
    pw = [np.ascontiguousarray(p_rows[:, i]) for i in range(2)]
    b_live = rng.random(nb) < 0.9
    p_live = rng.random(n_probe) < 0.9

    gid_b, table, _, over = hashagg.build_hash_table(
        [torch.from_numpy(w) for w in bw], torch.from_numpy(b_live), nb, keep_keys=False
    )
    gid_p, unres = hashjoin.probe_hash_table(
        [torch.from_numpy(w) for w in pw], torch.from_numpy(p_live), table
    )
    r_gid_b, r_table, _, r_over = ref_build.build_hash_table(
        [jnp.asarray(w) for w in bw], jnp.asarray(b_live), nb, interpret=True
    )
    r_gid_p, r_unres = ref_probe.probe_hash_table(
        [jnp.asarray(w) for w in pw], jnp.asarray(p_live), r_table, interpret=True
    )
    assert not bool(over) and not bool(r_over) and not bool(unres) and not bool(r_unres)
    got = np.concatenate([gid_b.numpy(), gid_p.numpy()]).astype(np.int64)
    want = np.concatenate([np.asarray(r_gid_b), np.asarray(r_gid_p)]).astype(np.int64)
    assert np.array_equal(got < 0, want < 0)
    m = got >= 0
    pairs = set(zip(got[m].tolist(), want[m].tolist()))
    assert len(pairs) == len(set(got[m].tolist())) == len(set(want[m].tolist()))
    # hits are exactly the live probe rows whose key was built live
    built = {tuple(r) for r in b_rows[b_live]}
    assert np.array_equal(gid_p.numpy() >= 0,
                          p_live & np.asarray([tuple(r) in built for r in p_rows]))


def test_probe_walk_budget_and_word_count():
    from trino_tpu_torch.ops.cuda import hashagg, hashjoin

    w = [torch.arange(500, dtype=torch.int32)]
    live = torch.ones(500, dtype=torch.bool)
    _, table, _, _ = hashagg.build_hash_table(w, live, 500, keep_keys=False)
    gid, unres = hashjoin.probe_hash_table([torch.arange(1000, dtype=torch.int32)],
                                           torch.ones(1000, dtype=torch.bool), table)
    assert not bool(unres)
    assert sorted(gid[:500].tolist()) == list(range(500)) and (gid[500:] == -1).all()
    old = hashagg.PROBE_LIMIT
    hashjoin.PROBE_LIMIT = 0
    try:
        _, unres0 = hashjoin.probe_hash_table(w, live, table)
    finally:
        hashjoin.PROBE_LIMIT = old
    assert bool(unres0)  # some walk had to step past its first slot
    with pytest.raises(ValueError, match="key words"):
        hashjoin.probe_hash_table(w + w, live, table)


def _sides(seed=11):
    from trino_tpu.data.types import BIGINT

    rng = np.random.default_rng(seed)
    nl, nr = 2000, 300
    return {
        "lc": (rng.integers(0, 100, nl), None), "lk": (rng.integers(0, 50, nl), rng.random(nl) > 0.05),
        "rc": (rng.integers(0, 100, nr), rng.random(nr) > 0.1),
        "rk": (rng.integers(0, 60, nr), rng.random(nr) > 0.05),
        "ll": rng.random(nl) > 0.1, "rl": rng.random(nr) > 0.1, "type": BIGINT,
    }


def _rows(cols, live, to_np):
    live = to_np(live).astype(bool)
    mats = [(to_np(c.data), None if c.valid is None else to_np(c.valid).astype(bool)) for c in cols]
    return sorted(
        (tuple(d[i].item() if v is None or v[i] else None for d, v in mats)
         for i in np.nonzero(live)[0]),
        key=repr,
    )


_REF_JOINS: dict = {}


def _reference_joins(C):
    """Every join kind of the reference (its sort path on the CPU), traced
    once under jax.jit."""
    if C in _REF_JOINS:
        return _REF_JOINS[C]
    import jax
    import jax.numpy as jnp

    from trino_tpu.ops import relops as ref
    from trino_tpu.ops.expr import ColumnVal as RefCV

    s = _sides()
    t = s["type"]

    def run(a):
        lc, lk, rc, rk = (RefCV(a[x][0], a[x][1], None, t) for x in ("lc", "lk", "rc", "rk"))
        out = {}
        for kind in KINDS:
            cols, live, req = ref.equi_join(kind, [lc], a["ll"], [rc], a["rl"], [lk], [rk], None, C)
            out[kind] = ([(c.data, c.valid) for c in cols], live, req)
        return out

    packed = jax.tree_util.tree_map(jnp.asarray, {k: v for k, v in s.items() if k != "type"})
    res = jax.jit(run)(packed)

    class _C:
        def __init__(self, d, v):
            self.data, self.valid = d, v

    _REF_JOINS[C] = {
        k: (_rows([_C(d, v) for d, v in cols], live, np.asarray), int(req))
        for k, (cols, live, req) in res.items()
    }
    return _REF_JOINS[C]


@pytest.mark.parametrize("path", ["hash", "sort"])
@pytest.mark.parametrize("kind", KINDS)
def test_equi_join_matches_reference(kind, path):
    from trino_tpu_torch.ops import kernels, relops
    from trino_tpu_torch.ops.expr import ColumnVal

    C = 1 << 15
    s = _sides()
    t = s["type"]

    def cv(x):
        d, v = s[x]
        return ColumnVal(torch.from_numpy(d), None if v is None else torch.from_numpy(v), None, t)

    want_rows, want_req = _reference_joins(C)[kind]
    kernels.set_policy(kernels.KernelPolicy(enabled=path == "hash"))
    events = kernels.begin_capture()
    try:
        cols, live, req, failed = relops.equi_join(
            kind, [cv("lc")], torch.from_numpy(s["ll"]), [cv("rc")], torch.from_numpy(s["rl"]),
            [cv("lk")], [cv("rk")], None, C,
        )
    finally:
        kernels.end_capture()
    assert int(req) == want_req
    assert not bool(failed)
    assert _rows(cols, live, lambda x: x.numpy()) == want_rows
    assert {(e[0], e[1]) for e in events} == {("join", "torch" if path == "hash" else "sort")}


def test_join_build_over_limit_dispatches_fallback_and_force_sort():
    from trino_tpu.data.types import BIGINT
    from trino_tpu_torch.ops import kernels, relops
    from trino_tpu_torch.ops.expr import ColumnVal

    rng = np.random.default_rng(31)
    nl, nr = 500, 4000  # build side past the policy limit
    col = lambda k, n: ColumnVal(torch.from_numpy(rng.integers(0, k, n)), None, None, BIGINT)
    lk, rk, lc, rc = col(50, nl), col(50, nr), col(9, nl), col(9, nr)
    args = ([lc], torch.ones(nl, dtype=torch.bool), [rc], torch.ones(nr, dtype=torch.bool),
            [lk], [rk], None, 1 << 16)
    kernels.set_policy(kernels.KernelPolicy(hash_join_max_build=1024))
    events = kernels.begin_capture()
    try:
        over_limit = relops.equi_join("inner", *args)
    finally:
        kernels.end_capture()
    assert ("join", "fallback") in {(e[0], e[1]) for e in events}
    kernels.set_policy(kernels.KernelPolicy())
    hashed = relops.equi_join("inner", *args)
    forced = relops.equi_join("inner", *args, force_sort=True)
    rows = [_rows(c, lv, lambda x: x.numpy()) for c, lv, _, _ in (over_limit, hashed, forced)]
    assert rows[0] == rows[1] == rows[2]


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run chip_smoke.py on the card)")
    from trino_tpu_torch.ops.cuda import hashagg, hashjoin

    rng = np.random.default_rng(7)
    dev = torch.device("cuda")
    keys = torch.from_numpy(rng.integers(0, 20000, 50000).astype(np.int32)).to(dev)
    probe = torch.from_numpy(rng.integers(0, 40000, 100003).astype(np.int32)).to(dev)
    live = torch.ones(50000, dtype=torch.bool, device=dev)
    plive = torch.from_numpy(rng.random(100003) < 0.9).to(dev)
    _, table, _, _ = hashagg.build_hash_table([keys], live, 50000, keep_keys=False)
    got, unres = hashjoin.probe_hash_table([probe], plive, table)
    want, punres = hashjoin.plain_probe_hash_table([probe], plive, table)
    assert torch.equal(got, want) and not bool(unres) and not bool(punres)
