"""ctypes bindings for the repo's C++ page serde (native/pageserde.cpp).

The port's own loader: it compiles the repo's `native/pageserde.cpp` with
`g++ -O3 -shared -fPIC` into trino_tpu_torch/build/libpageserde.so (linked
against the system zstd: `-lzstd`, or the versioned runtime library where
no linker symlink is installed) at first use, never at import.  A sidecar
file keeps the hash of the source and flags the library was built from; a
changed source triggers a rebuild.  A failed build raises with the
compiler's output: there is no pure-python codec to fall back to, so a page
on the wire or in a spill file is always the one format both packages read.

serialize_columns / deserialize_columns move host column batches across
the wire (spill files, and later the exchange between worker processes,
ROADMAP A.11): fixed-width columns go as raw little-endian buffers; object
columns (strings) as int32 codes plus a length-prefixed dictionary blob.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import json
import os
import struct
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

__all__ = ["page_serde", "PageSerde", "LIB_PATH", "SOURCE", "build_serde"]

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "native" / "pageserde.cpp"
BUILD_DIR = _REPO / "trino_tpu_torch" / "build"
LIB_PATH = BUILD_DIR / "libpageserde.so"
_HASH_PATH = BUILD_DIR / "libpageserde.sha256"
FLAGS = ("-O3", "-shared", "-fPIC")

_LOCK = threading.Lock()


def _zstd_runtime() -> Optional[str]:
    """The system zstd runtime library (libzstd.so.1) for hosts with no dev
    package: g++ links against the versioned .so directly."""
    for pat in (
        "/usr/lib/*/libzstd.so*",
        "/usr/lib/libzstd.so*",
        "/usr/local/lib/libzstd.so*",
        "/lib/*/libzstd.so*",
    ):
        hits = sorted(glob.glob(pat))
        if hits:
            return hits[0]
    return None


def _source_hash() -> str:
    h = hashlib.sha256()
    h.update(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()


def build_serde() -> Path:
    """Compile the serde library when it is missing or stale; returns its
    path.  Raises RuntimeError naming the compiler's stderr on failure."""
    want = _source_hash()
    if LIB_PATH.exists() and _HASH_PATH.exists() and _HASH_PATH.read_text() == want:
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a private name and rename: concurrent processes (test
    # workers) never load a half-written library
    tmp = BUILD_DIR / f"libpageserde.{os.getpid()}.{threading.get_ident()}.so"
    cmd = ["g++", *FLAGS, str(SOURCE), "-o", str(tmp)]
    errors = []
    for link in (["-lzstd"], [_zstd_runtime()]):
        if link[0] is None:
            errors.append("no libzstd runtime library found")
            continue
        try:
            proc = subprocess.run(cmd + link, capture_output=True, text=True, timeout=300)
        except FileNotFoundError as e:
            raise RuntimeError(f"trino_tpu_torch: cannot build the page serde: {e}") from e
        if proc.returncode == 0:
            os.replace(tmp, LIB_PATH)
            _HASH_PATH.write_text(want)
            return LIB_PATH
        errors.append(f"{' '.join(cmd + link)}\n{proc.stderr.strip()}")
    tmp.unlink(missing_ok=True)
    raise RuntimeError(
        "trino_tpu_torch: building the page serde failed:\n" + "\n---\n".join(errors)
    )


def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_serde()))
    lib.tt_serialize_bound.restype = ctypes.c_int64
    lib.tt_serialize_bound.argtypes = [ctypes.POINTER(ctypes.c_int64), ctypes.c_int32]
    lib.tt_page_serialize.restype = ctypes.c_int64
    lib.tt_page_serialize.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.tt_page_peek.restype = ctypes.c_int32
    lib.tt_page_peek.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32,
    ]
    lib.tt_page_deserialize.restype = ctypes.c_int32
    lib.tt_page_deserialize.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_char_p),
    ]
    return lib


class PageSerde:
    """Buffer-level serde.  serialize(buffers) -> bytes; the reverse returns
    the raw buffers (the schema travels as the first buffer, a JSON
    header)."""

    def __init__(self, level: int = 3):
        self.level = level
        self._lib = _load()

    def serialize(self, buffers: Sequence[bytes], nrows: int) -> bytes:
        ncols = len(buffers)
        sizes = (ctypes.c_int64 * ncols)(*[len(b) for b in buffers])
        bufs = (ctypes.c_char_p * ncols)(*buffers)
        bound = self._lib.tt_serialize_bound(sizes, ncols)
        out = ctypes.create_string_buffer(bound)
        n = self._lib.tt_page_serialize(bufs, sizes, ncols, nrows, self.level, out, bound)
        if n < 0:
            raise RuntimeError("page serialization failed")
        return ctypes.string_at(out, n)  # the n bytes written, one copy

    def deserialize(self, data: bytes) -> tuple[list[bytes], int]:
        max_cols = 4096
        ncols = ctypes.c_int32()
        nrows = ctypes.c_int64()
        raw_sizes = (ctypes.c_int64 * max_cols)()
        rc = self._lib.tt_page_peek(
            data, len(data), ctypes.byref(ncols), ctypes.byref(nrows), raw_sizes, max_cols,
        )
        if rc != 0:
            raise RuntimeError(f"corrupt page frame: {rc}")
        outs = [ctypes.create_string_buffer(raw_sizes[i]) for i in range(ncols.value)]
        bufs = (ctypes.c_char_p * ncols.value)(
            *[ctypes.cast(o, ctypes.c_char_p) for o in outs]
        )
        rc = self._lib.tt_page_deserialize(data, len(data), bufs)
        if rc != 0:
            raise RuntimeError(f"page deserialization failed: {rc}")
        return [o.raw for o in outs], nrows.value

    # ---- column <-> buffer mapping ----------------------------------------
    def serialize_columns(self, columns: dict[str, np.ndarray]) -> bytes:
        """Encode named numpy columns (object arrays = strings) to wire bytes
        with a small schema header."""
        names = sorted(columns)
        buffers: list[bytes] = []
        schema = []
        nrows = len(next(iter(columns.values()))) if columns else 0
        for name in names:
            arr = columns[name]
            if arr.dtype == object:
                uniq, codes = np.unique(arr.astype(str), return_inverse=True)
                # length-prefixed entries: one "" entry stays distinct from
                # no entries, so an all-"" column round-trips
                parts = [struct.pack("<I", len(uniq))]
                for v in uniq.tolist():
                    b = v.encode("utf-8")
                    parts.append(struct.pack("<I", len(b)))
                    parts.append(b)
                buffers.append(codes.astype(np.int32).tobytes())
                buffers.append(b"".join(parts))
                schema.append({"name": name, "kind": "dict"})
            else:
                buffers.append(np.ascontiguousarray(arr).tobytes())
                schema.append({"name": name, "kind": "fixed", "dtype": arr.dtype.str})
        header = json.dumps(schema).encode("utf-8")
        return self.serialize([header] + buffers, nrows)

    def deserialize_columns(self, data: bytes) -> dict[str, np.ndarray]:
        if data[:4] == b"TPG1":
            # an integrity-framed wire chunk (runtime/wire.py frame_chunk)
            from ..runtime.wire import unframe_chunk

            data = unframe_chunk(data)
        buffers, _nrows = self.deserialize(data)
        schema = json.loads(buffers[0].decode("utf-8"))
        out: dict[str, np.ndarray] = {}
        i = 1
        for col in schema:
            if col["kind"] == "dict":
                codes = np.frombuffer(buffers[i], dtype=np.int32)
                blob = buffers[i + 1]
                i += 2
                (count,) = struct.unpack_from("<I", blob, 0)
                off = 4
                entries = []
                for _ in range(count):
                    (ln,) = struct.unpack_from("<I", blob, off)
                    off += 4
                    entries.append(blob[off: off + ln].decode("utf-8"))
                    off += ln
                values = np.asarray(entries, dtype=object)
                out[col["name"]] = values[codes] if len(values) else np.array([], dtype=object)
            else:
                out[col["name"]] = np.frombuffer(buffers[i], dtype=np.dtype(col["dtype"]))
                i += 1
        return out


_SERDE: Optional[PageSerde] = None


def page_serde() -> PageSerde:
    global _SERDE
    with _LOCK:
        if _SERDE is None:
            _SERDE = PageSerde()
        return _SERDE
