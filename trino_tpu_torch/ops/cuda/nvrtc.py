"""Run-time compilation of generated CUDA C++ with NVRTC, launched through
the CUDA driver API.

NVRTC is the CUDA toolkit's library form of the same device compiler nvcc
drives, so a kernel built here is CUDA C++ compiled for `sm_90a` — only
without a process start per kernel, which matters when one kernel is
generated per query shape (ops/cuda/fused_codegen.py).  Both libraries are
loaded with ctypes at first use, never at import: machines without a card
import every module and run the plain PyTorch versions.

  * `compile_cubin` compiles one source and returns the cubin and NVRTC's
    log (the log is kept on success too: ptxas's register and spill report
    lands there); a failed compile raises `NvrtcError` with the log;
  * `load_kernel` loads a cubin into the primary context torch made current
    and returns a `Kernel`; `Kernel.launch` calls `cuLaunchKernel` on the
    caller's stream.  A failed load or launch raises with the driver's
    message.  Nothing here falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import os
import threading
import time
from typing import Optional, Sequence

__all__ = [
    "NvrtcError", "Kernel", "compile_cubin", "load_kernel", "memset_async",
    "nvrtc_version",
]

ARCH = "sm_90a"
_FUNC_ATTR_MAX_DYNAMIC_SHARED = 8  # CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES

_NVRTC: Optional[ctypes.CDLL] = None
_CUDA: Optional[ctypes.CDLL] = None


class NvrtcError(RuntimeError):
    """A generated kernel failed to compile, load or launch."""


def _nvrtc_candidates() -> list[str]:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    out = [os.environ.get("NVRTC_LIB", "")]
    for d in (os.path.join(home, "lib64"), os.path.join(home, "lib"),
              os.path.join(home, "targets", "x86_64-linux", "lib")):
        out += sorted(glob.glob(os.path.join(d, "libnvrtc.so*")), key=len)
    return [p for p in out if p and "builtins" not in p and "alt" not in p]


def _nvrtc() -> ctypes.CDLL:
    global _NVRTC
    if _NVRTC is None:
        tried = _nvrtc_candidates()
        for path in tried:
            try:
                _NVRTC = ctypes.CDLL(path)
                break
            except OSError:
                continue
        else:
            raise NvrtcError(
                f"libnvrtc not found (tried {tried}; set CUDA_HOME or NVRTC_LIB): "
                "the generated fused-pipeline kernels cannot be built here"
            )
        lib = _NVRTC
        lib.nvrtcGetErrorString.restype = ctypes.c_char_p
        lib.nvrtcGetErrorString.argtypes = [ctypes.c_int]
    return _NVRTC


def _cuda() -> ctypes.CDLL:
    global _CUDA
    if _CUDA is None:
        try:
            _CUDA = ctypes.CDLL("libcuda.so.1")
        except OSError as ex:
            raise NvrtcError(f"the CUDA driver (libcuda.so.1) cannot be loaded: {ex}") from ex
        _CUDA.cuGetErrorString.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p)]
        _CUDA.cuLaunchKernel.argtypes = [
            ctypes.c_void_p, ctypes.c_uint, ctypes.c_uint, ctypes.c_uint,
            ctypes.c_uint, ctypes.c_uint, ctypes.c_uint, ctypes.c_uint,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        _CUDA.cuMemsetD8Async.argtypes = [
            ctypes.c_uint64, ctypes.c_ubyte, ctypes.c_size_t, ctypes.c_void_p,
        ]
        _CUDA.cuOccupancyMaxActiveBlocksPerMultiprocessor.argtypes = [
            ctypes.POINTER(ctypes.c_int), ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t,
        ]
        _CUDA.cuFuncSetAttribute.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        _CUDA.cuModuleGetFunction.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p, ctypes.c_char_p,
        ]
        _CUDA.cuModuleLoadData.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p]
    return _CUDA


def _check_nvrtc(code: int, what: str, log: str = "") -> None:
    if code != 0:
        msg = _nvrtc().nvrtcGetErrorString(code)
        raise NvrtcError(
            f"{what} failed: {msg.decode() if msg else code}" + (f"\n{log}" if log else "")
        )


def _check_cu(code: int, what: str) -> None:
    if code != 0:
        msg = ctypes.c_char_p()
        _cuda().cuGetErrorString(code, ctypes.byref(msg))
        raise NvrtcError(
            f"{what} failed with CUDA driver error {code} "
            f"({msg.value.decode() if msg.value else 'unknown'})"
        )


@functools.lru_cache(maxsize=1)
def nvrtc_version() -> str:
    major, minor = ctypes.c_int(), ctypes.c_int()
    _check_nvrtc(_nvrtc().nvrtcVersion(ctypes.byref(major), ctypes.byref(minor)), "nvrtcVersion")
    return f"{major.value}.{minor.value}"


def compile_cubin(source: str, name: str, options: Sequence[str]) -> tuple[bytes, str, float]:
    """Compile `source` for `sm_90a`.  Returns (cubin, log, milliseconds)."""
    lib = _nvrtc()
    prog = ctypes.c_void_p()
    t0 = time.perf_counter()
    _check_nvrtc(
        lib.nvrtcCreateProgram(ctypes.byref(prog), source.encode(), name.encode(),
                               0, None, None),
        "nvrtcCreateProgram",
    )
    try:
        opts = [f"--gpu-architecture={ARCH}", *options]
        arr = (ctypes.c_char_p * len(opts))(*[o.encode() for o in opts])
        code = lib.nvrtcCompileProgram(prog, len(opts), arr)
        size = ctypes.c_size_t()
        _check_nvrtc(lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size)), "nvrtcGetProgramLogSize")
        buf = ctypes.create_string_buffer(size.value)
        _check_nvrtc(lib.nvrtcGetProgramLog(prog, buf), "nvrtcGetProgramLog")
        log = buf.value.decode(errors="replace")
        _check_nvrtc(code, f"NVRTC compile of {name}", log)
        _check_nvrtc(lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)), "nvrtcGetCUBINSize")
        cubin = ctypes.create_string_buffer(size.value)
        _check_nvrtc(lib.nvrtcGetCUBIN(prog, cubin), "nvrtcGetCUBIN")
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))
    return cubin.raw, log, (time.perf_counter() - t0) * 1e3


def _ensure_context(device_index: int) -> None:
    """The driver API acts on the calling thread's current context: the
    primary context of the device, which torch made current."""
    import torch

    torch.cuda.init()
    with torch.cuda.device(device_index):
        torch.cuda.current_stream()  # makes the primary context current
        ctx = ctypes.c_void_p()
        _check_cu(_cuda().cuCtxGetCurrent(ctypes.byref(ctx)), "cuCtxGetCurrent")
        if not ctx.value:
            dev, primary = ctypes.c_int(), ctypes.c_void_p()
            _check_cu(_cuda().cuDeviceGet(ctypes.byref(dev), device_index), "cuDeviceGet")
            _check_cu(_cuda().cuDevicePrimaryCtxRetain(ctypes.byref(primary), dev),
                      "cuDevicePrimaryCtxRetain")
            _check_cu(_cuda().cuCtxSetCurrent(primary), "cuCtxSetCurrent")


_BOUND = threading.local()  # per thread: the devices whose context it made current


def bind_context(device_index: int) -> None:
    """Make the device's primary context current on the calling thread, once
    per thread: a thread on which torch made no runtime call (a prepared
    statement's batch window runs in the caller's thread) has none, and the
    driver API would refuse the launch."""
    done = getattr(_BOUND, "devices", None)
    if done is None:
        done = _BOUND.devices = set()
    if device_index not in done:
        _ensure_context(device_index)
        done.add(device_index)


class Kernel:
    """One loaded `__global__` function of a cubin."""

    def __init__(self, cubin: bytes, fn_name: str, device_index: int):
        _ensure_context(device_index)
        self.device_index = device_index
        self._image = ctypes.create_string_buffer(cubin, len(cubin))  # outlives the load
        self._module = ctypes.c_void_p()
        _check_cu(_cuda().cuModuleLoadData(ctypes.byref(self._module), self._image),
                  f"cuModuleLoadData({fn_name})")
        self._fn = ctypes.c_void_p()
        _check_cu(_cuda().cuModuleGetFunction(ctypes.byref(self._fn), self._module,
                                              fn_name.encode()),
                  f"cuModuleGetFunction({fn_name})")
        self.name = fn_name
        self._smem_opt_in = 48 * 1024
        self._occupancy: dict = {}

    def blocks_per_sm(self, threads: int, smem: int) -> int:
        got = self._occupancy.get((threads, smem))
        if got is None:
            self._allow_smem(smem)
            out = ctypes.c_int()
            _check_cu(_cuda().cuOccupancyMaxActiveBlocksPerMultiprocessor(
                ctypes.byref(out), self._fn, threads, smem),
                "cuOccupancyMaxActiveBlocksPerMultiprocessor")
            got = self._occupancy[(threads, smem)] = out.value
        return got

    def _allow_smem(self, smem: int) -> None:
        if smem > self._smem_opt_in:
            _check_cu(_cuda().cuFuncSetAttribute(self._fn, _FUNC_ATTR_MAX_DYNAMIC_SHARED, smem),
                      f"cuFuncSetAttribute({self.name}, max dynamic shared {smem})")
            self._smem_opt_in = smem

    def launch(self, grid: int, threads: int, smem: int, stream: int, args: Sequence) -> None:
        """`args`: ctypes objects, one per kernel parameter, in order."""
        self._allow_smem(smem)
        params = (ctypes.c_void_p * len(args))(
            *[ctypes.cast(ctypes.pointer(a), ctypes.c_void_p) for a in args]
        )
        _check_cu(_cuda().cuLaunchKernel(self._fn, grid, 1, 1, threads, 1, 1, smem,
                                         stream, params, None),
                  f"cuLaunchKernel({self.name}, grid {grid}, block {threads}, smem {smem})")


def load_kernel(cubin: bytes, fn_name: str, device_index: int) -> Kernel:
    return Kernel(cubin, fn_name, device_index)


def memset_async(ptr: int, nbytes: int, stream: int) -> None:
    """Zero `nbytes` of device memory at `ptr` on `stream`."""
    _check_cu(_cuda().cuMemsetD8Async(ptr, 0, nbytes, stream), "cuMemsetD8Async")
