"""The port's page wire (trino_tpu_torch/runtime/wire.py) and its serde
loader (trino_tpu_torch/native) against the JAX package's: the partition
hash routes every row to the reference's part for int, double, varchar (two
dictionaries), limbed decimal and NULL keys; bucket ids equal the
reference's; blobs written by either package decode in the other with equal
rows; the serde library the port loads is its own build under
trino_tpu_torch/build/."""

import os

import numpy as np
import pytest
try:  # arrow before torch: loaded after it, arrow's parquet writer crashes the process
    import pyarrow  # noqa: F401
except ImportError:
    pass
import torch

torch.set_num_threads(1)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 3000


def _columns(seed: int):
    """(name, type name, numpy values, valid or None) of every key kind."""
    rng = np.random.default_rng(seed)
    words = np.asarray([f"w{i:03d}" for i in range(40)], dtype=object)
    big = [int(v) * (10 ** 20) + int(w) for v, w in zip(
        rng.integers(-5, 5, N), rng.integers(0, 10 ** 6, N))]
    null_heavy = rng.random(N) < 0.9
    return [
        ("i", "bigint", rng.integers(-(1 << 62), 1 << 62, N, dtype=np.int64), None),
        ("d", "double", rng.normal(0, 1e6, N), None),
        ("s", "varchar", words[rng.integers(0, 40, N)], None),
        ("s2", "varchar", words[rng.integers(10, 40, N)], None),
        ("m", "decimal(38,2)", np.asarray(big, dtype=object), None),
        ("n", "bigint", rng.integers(0, 50, N, dtype=np.int64), rng.random(N) < 0.7),
        ("h", "integer", rng.integers(0, 9, N).astype(np.int32), ~null_heavy),
        ("dt", "date", rng.integers(8000, 10000, N).astype(np.int32), None),
        ("id", "bigint", np.arange(N, dtype=np.int64), None),
    ]


def _pages(seed: int = 5, live_share: float = 0.8):
    """The same rows as a port page (on the CPU) and a reference page."""
    from trino_tpu.data.page import Column as RCol
    from trino_tpu.data.page import Page as RPage
    from trino_tpu.data.types import parse_type as rparse
    from trino_tpu_torch.data.page import Column, Page
    from trino_tpu_torch.data.types import parse_type

    import jax.numpy as jnp

    cols = _columns(seed)
    live = np.random.default_rng(seed + 1).random(N) < live_share
    port = Page(
        tuple(Column.from_numpy(parse_type(t), v, valid, device="cpu") for _, t, v, valid in cols),
        torch.from_numpy(live),
    )
    ref = RPage(
        tuple(RCol.from_numpy(rparse(t), v, valid) for _, t, v, valid in cols),
        jnp.asarray(live),
    )
    return cols, port, ref


def _keys(cols, names, pkg):
    if pkg == "port":
        from trino_tpu_torch.data.types import parse_type
        from trino_tpu_torch.plan.ir import FieldRef
    else:
        from trino_tpu.data.types import parse_type
        from trino_tpu.plan.ir import FieldRef
    index = {c[0]: (i, c[1]) for i, c in enumerate(cols)}
    return [FieldRef(index[n][0], parse_type(index[n][1])) for n in names]


def _routes(chunk_lists, decode):
    """{row id: part} from each part's decoded rows (the id is the last
    column)."""
    out = {}
    for part, blobs in enumerate(chunk_lists):
        for row in decode(blobs):
            out[row[-1]] = part
    return out


def _decode_port(types):
    from trino_tpu_torch.runtime.wire import wire_to_page

    return lambda blobs: wire_to_page(blobs, types, device="cpu").to_pylist()


def _decode_ref(types):
    from trino_tpu.runtime.wire import wire_to_page

    return lambda blobs: wire_to_page(blobs, types).to_pylist()


KEYS = {
    "int": ["i"], "double": ["d"], "varchar": ["s"], "varchar_other_dict": ["s2"],
    "limbed_decimal": ["m"], "null_keys": ["n"], "null_heavy": ["h"], "date": ["dt"],
    "int_varchar_double": ["i", "s", "d"], "decimal_and_nulls": ["m", "n"],
}


@pytest.mark.parametrize("nparts", [4, 7])
@pytest.mark.parametrize("kind", sorted(KEYS))
def test_partition_page_routes_rows_as_the_reference(kind, nparts):
    from trino_tpu.runtime.wire import partition_page as ref_partition
    from trino_tpu_torch.data.types import parse_type
    from trino_tpu_torch.runtime.wire import partition_page

    cols, port, ref = _pages()
    assert port.columns[4].data2 is not None and ref.columns[4].data2 is not None
    types_port = [parse_type(t) for _, t, _, _ in cols]
    got = _routes(
        partition_page(port, _keys(cols, KEYS[kind], "port"), nparts, chunk_rows=700),
        _decode_port(types_port),
    )
    want = _routes(
        ref_partition(ref, _keys(cols, KEYS[kind], "ref"), nparts, chunk_rows=700),
        _decode_ref([c.type for c in ref.columns]),
    )
    assert len(got) == len(want) == int(np.asarray(port.live).sum())
    assert got == want
    assert len(set(got.values())) > 1 or kind == "null_heavy"


def test_partition_ids_cover_the_unsigned_range():
    """Hashes with the top bit set land where the uint64 remainder puts them
    (a signed remainder would move them)."""
    from trino_tpu.runtime.wire import _mix64_np
    from trino_tpu_torch.runtime.wire import partition_ids

    cols, port, _ = _pages()
    ids = partition_ids(port, _keys(cols, ["i"], "port"), 7).numpy()
    bits = cols[0][2].view(np.uint64)
    h = _mix64_np(np.zeros(N, np.uint64) ^ _mix64_np(bits))
    assert (h >= np.uint64(1 << 63)).sum() > N // 4
    np.testing.assert_array_equal(ids, (h % np.uint64(7)).astype(np.int64))


def test_varchar_keys_route_by_value_across_dictionaries():
    """Two pages whose dictionaries differ route an equal string alike."""
    from trino_tpu_torch.data.page import Column, Page
    from trino_tpu_torch.data.types import VARCHAR
    from trino_tpu_torch.plan.ir import FieldRef
    from trino_tpu_torch.runtime.wire import partition_ids

    a = np.asarray(["x", "y", "z", "common"], dtype=object)
    b = np.asarray(["common", "q", "r", "s", "t"], dtype=object)
    pa = Page((Column.from_numpy(VARCHAR, a, device="cpu"),))
    pb = Page((Column.from_numpy(VARCHAR, b, device="cpu"),))
    assert pa.columns[0].dictionary is not pb.columns[0].dictionary
    key = [FieldRef(0, VARCHAR)]
    assert partition_ids(pa, key, 5)[3] == partition_ids(pb, key, 5)[0]


@pytest.mark.parametrize("nbuckets", [3, 16])
def test_bucket_assignments_equal_the_reference(nbuckets):
    from trino_tpu.runtime.wire import bucket_assignments as ref_buckets
    from trino_tpu_torch.runtime.wire import bucket_assignments

    rng = np.random.default_rng(9)
    arrays = {
        "i": rng.integers(-(1 << 62), 1 << 62, 2000, dtype=np.int64),
        "d": rng.normal(0, 1, 2000),
        "s": np.asarray([f"k{v}" for v in rng.integers(0, 300, 2000)], dtype=object),
        "n": np.ma.MaskedArray(rng.integers(0, 9, 2000), mask=rng.random(2000) < 0.3),
    }
    for keys in (["i"], ["d"], ["s"], ["n"], ["i", "s", "n"]):
        got = bucket_assignments(arrays, keys, nbuckets)
        np.testing.assert_array_equal(got, ref_buckets(arrays, keys, nbuckets))
    # the partition hash of a page gives the same ids as the bucket hash
    from trino_tpu_torch.data.page import Column, Page
    from trino_tpu_torch.data.types import BIGINT
    from trino_tpu_torch.plan.ir import FieldRef
    from trino_tpu_torch.runtime.wire import partition_ids

    page = Page((Column.from_numpy(BIGINT, arrays["i"], device="cpu"),))
    np.testing.assert_array_equal(
        partition_ids(page, [FieldRef(0, BIGINT)], nbuckets).numpy(),
        bucket_assignments(arrays, ["i"], nbuckets),
    )


@pytest.mark.parametrize("chunk_rows", [0, 512])
def test_port_blobs_decode_in_the_reference_and_back(chunk_rows):
    from trino_tpu.runtime.wire import page_to_wire_chunks as ref_to_wire
    from trino_tpu.runtime.wire import wire_to_page as ref_from_wire
    from trino_tpu_torch.data.types import parse_type
    from trino_tpu_torch.runtime.wire import page_to_wire_chunks, wire_to_page

    cols, port, ref = _pages(seed=11)
    want = ref.to_pylist()
    assert port.to_pylist() == want
    port_blobs = page_to_wire_chunks(port, chunk_rows)
    ref_blobs = ref_to_wire(ref, chunk_rows)
    assert len(port_blobs) == len(ref_blobs)
    ref_types = [c.type for c in ref.columns]
    port_types = [parse_type(t) for _, t, _, _ in cols]
    assert ref_from_wire(port_blobs, ref_types).to_pylist() == want
    back = wire_to_page(ref_blobs, port_types, pad_pow2=True, device="cpu")
    assert back.capacity == 1 << (len(want) - 1).bit_length()
    assert back.to_pylist() == want
    # the port's own round trip, and the bytes of one chunk decode alike
    assert wire_to_page(port_blobs, port_types, device="cpu").to_pylist() == want
    from trino_tpu.native import page_serde as ref_serde
    from trino_tpu_torch.native import page_serde

    a = page_serde().deserialize_columns(port_blobs[0])
    b = ref_serde().deserialize_columns(port_blobs[0])
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_arrays_travel_as_json_and_empty_pages_are_one_dead_row():
    from trino_tpu.data.types import parse_type as rparse
    from trino_tpu.runtime.wire import wire_to_page as ref_from_wire
    from trino_tpu_torch.data.page import Column, Page
    from trino_tpu_torch.data.types import parse_type
    from trino_tpu_torch.runtime.wire import page_to_wire_chunks, wire_to_page

    vals = np.empty(4, dtype=object)
    vals[:] = [(1, 2), (), (3,), (1, 2)]
    t = parse_type("array(bigint)")
    page = Page((Column.from_numpy(t, vals, device="cpu"),
                 Column.from_numpy(parse_type("varchar"),
                                   np.asarray(["a", "", "c", "d"], dtype=object),
                                   np.asarray([True, True, False, True]), device="cpu")))
    blobs = page_to_wire_chunks(page)
    want = [((1, 2), "a"), ((), ""), ((3,), None), ((1, 2), "d")]
    got = wire_to_page(blobs, [t, parse_type("varchar")], device="cpu").to_pylist()
    assert [(tuple(a), s) for a, s in got] == want
    ref = ref_from_wire(blobs, [rparse("array(bigint)"), rparse("varchar")]).to_pylist()
    assert [(tuple(a), s) for a, s in ref] == want
    empty = wire_to_page([], [t, parse_type("bigint")], device="cpu")
    assert empty.capacity == 1 and empty.to_pylist() == []


def test_integrity_frame_rejects_a_flipped_bit():
    from trino_tpu_torch.data.page import Column, Page
    from trino_tpu_torch.data.types import BIGINT
    from trino_tpu_torch.runtime.wire import PageTransportError, page_to_wire, wire_to_page

    blob = bytearray(page_to_wire(Page((Column.from_numpy(BIGINT, np.arange(50), device="cpu"),))))
    blob[-3] ^= 0x10
    with pytest.raises(PageTransportError, match="PAGE_TRANSPORT_ERROR"):
        wire_to_page([bytes(blob)], [BIGINT], device="cpu")


def test_serde_library_is_the_ports_own_build():
    from trino_tpu_torch import native

    serde = native.page_serde()
    lib = os.path.realpath(serde._lib._name)
    assert lib == os.path.realpath(os.path.join(_ROOT, "trino_tpu_torch", "build",
                                                "libpageserde.so"))
    assert os.path.realpath(str(native.SOURCE)) == os.path.realpath(
        os.path.join(_ROOT, "native", "pageserde.cpp"))
    with open("/proc/self/maps") as fh:
        port_maps = [ln for ln in fh if "libpageserde" in ln and "trino_tpu_torch" in ln]
    assert port_maps


def test_serde_build_failure_raises_with_the_compiler_output(monkeypatch, tmp_path):
    from trino_tpu_torch import native

    bad = tmp_path / "pageserde.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "build" / "libpageserde.so")
    monkeypatch.setattr(native, "_HASH_PATH", tmp_path / "build" / "libpageserde.sha256")
    with pytest.raises(RuntimeError, match="building the page serde failed"):
        native.build_serde()
    assert not (tmp_path / "build" / "libpageserde.so").exists()
