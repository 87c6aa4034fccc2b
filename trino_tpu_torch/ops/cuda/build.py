"""Build and load the port's CUDA kernels.

Every source under trino_tpu_torch/csrc/ is compiled by its own nvcc process,
all started together, and the objects are linked into
trino_tpu_torch/build/libtrino_kernels.so — a shared library with a plain C
interface, loaded with ctypes (no torch headers, so the build takes seconds:
as long as the slowest source, plus the link).
The build happens at first use, never at import: machines without nvcc can
import every module and run the plain PyTorch versions on CPU tensors.

A sidecar file keeps the hash of the sources the library was built from;
a changed source triggers a rebuild.  A failed build raises with nvcc's
output — nothing falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

__all__ = ["load_library", "build_library", "last_build", "NVCC_FLAGS", "check_launch"]

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
LIB_PATH = BUILD_DIR / "libtrino_kernels.so"
HASH_PATH = BUILD_DIR / "libtrino_kernels.sha256"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
# {"seconds": float, "cached": bool, "log": str} of the build this process
# triggered (or found on disk)
_LAST_BUILD: dict = {}


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _source_hash(sources) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for p in sources + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def _find_nvcc() -> str:
    for cand in (
        os.environ.get("NVCC"),
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "trino_tpu_torch: nvcc not found (set NVCC or CUDA_HOME); the CUDA "
        "kernels cannot be built on this machine"
    )


def build_library(verbose: bool = False) -> dict:
    """Compile csrc/*.cu when the library is missing or stale.  Returns
    {"seconds", "cached", "log"}."""
    sources = _sources()
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    want = _source_hash(sources)
    if LIB_PATH.exists() and HASH_PATH.exists() and HASH_PATH.read_text().strip() == want:
        return {"seconds": 0.0, "cached": True, "log": ""}
    nvcc = _find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    tmp = BUILD_DIR / f"libtrino_kernels.{tag}.so"
    objects = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
    t0 = time.perf_counter()
    compiles = []
    for src, obj in zip(sources, objects):
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-c", "-o", str(obj), str(src)]
        compiles.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *[str(o) for o in objects]]
    logs, failed = [], None
    for cmd, proc in compiles:  # every compile is waited for, failed or not
        out, _ = proc.communicate()
        logs.append(out or "")
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode)
    if failed is None:
        proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs.append(proc.stdout or "")
        if proc.returncode != 0:
            failed = (link, proc.returncode)
    seconds = time.perf_counter() - t0
    log = "".join(logs)
    for obj in objects:
        obj.unlink(missing_ok=True)
    if failed is not None:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (exit {failed[1]}): {' '.join(failed[0])}\n{log}")
    os.replace(tmp, LIB_PATH)
    HASH_PATH.write_text(want + "\n")
    return {"seconds": seconds, "cached": False, "log": log}


def load_library(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library (built first when needed)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            info = build_library(verbose=verbose)
            _LAST_BUILD.update(info)
            _LIB = ctypes.CDLL(str(LIB_PATH))
        return _LIB


def last_build() -> dict:
    """What load_library() did in this process ({} before the first load)."""
    return dict(_LAST_BUILD)


def check_launch(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a kernel's C entry reported a CUDA error for its launch."""
    if code != 0:
        lib.trino_cuda_error_string.restype = ctypes.c_char_p
        lib.trino_cuda_error_string.argtypes = [ctypes.c_int]
        msg = lib.trino_cuda_error_string(code)
        raise RuntimeError(
            f"{what}: CUDA launch failed with error {code}"
            f" ({msg.decode() if msg else 'unknown'})"
        )
