"""The disk cache of kernel 2's NVRTC builds, keyed to the card and the toolkit.

The reference keys its XLA cache directory by the host's CPU feature flags
(trino_tpu/utils/compilecache.py), because an entry compiled on another
machine class is poison.  The port's only run-time compiles are kernel 2's
per-recipe NVRTC builds (ops/cuda/fused_codegen.py), and a cubin is bound to
the same things: the target architecture it was compiled for, the NVRTC
release that compiled it, and the card that must load it.  So every cubin
lives in a directory named by all three,

    trino_tpu_torch/build/nvrtc/<arch>-nvrtc<version>-cc<major><minor>/

and a cubin built for another card or toolkit sits in another directory,
where no lookup ever reads it.  `build/` is listed in .gitignore; delete
`trino_tpu_torch/build/nvrtc` (or call `clear()`) to empty the cache.
`cache_stats()` reports the footprint (entries and bytes) for /metrics and
the EXPLAIN ANALYZE `-- compile:` footer.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path

__all__ = ["ROOT", "fingerprint", "cubin_dir", "cache_stats", "clear"]

ROOT = Path(__file__).resolve().parents[1] / "build" / "nvrtc"


def fingerprint(arch: str, nvrtc_version: str, capability: tuple[int, int]) -> str:
    """The directory name of one (architecture, NVRTC release, compute
    capability) class: `sm_90a-nvrtc12.9-cc90`."""
    return f"{arch}-nvrtc{nvrtc_version}-cc{capability[0]}{capability[1]}"


def cubin_dir(device_index: int) -> Path:
    """Where the cubins for the card `device_index` live: the class of the
    target architecture, this process's NVRTC and the card's compute
    capability.  Raises without a CUDA device."""
    import torch

    from ..ops.cuda import nvrtc

    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the NVRTC cubin cache belongs to a card "
            "(torch.cuda.is_available() is false)"
        )
    cap = torch.cuda.get_device_capability(device_index)
    return ROOT / fingerprint(nvrtc.ARCH, nvrtc.nvrtc_version(), cap)


def cache_stats() -> dict:
    """On-disk footprint of the cubin cache: {"dir", "entries" (cubins over
    every class directory), "bytes" (every file, sources and logs too)}."""
    d = ROOT
    entries = 0
    size = 0
    for base, _dirs, files in os.walk(d):
        for name in files:
            try:
                size += os.path.getsize(os.path.join(base, name))
            except OSError:
                continue  # removed mid-walk
            if name.endswith(".cubin"):
                entries += 1
    return {"dir": str(d), "entries": entries, "bytes": size}


def clear() -> None:
    """Delete every cached cubin (of every card and toolkit class)."""
    shutil.rmtree(ROOT, ignore_errors=True)
