"""Build and load the port's CUDA kernels.

``csrc/flash_fwd.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes``. The build runs at first use, on the
machine with the card, into ``<checkout>/build/kernels/`` (listed in
``.gitignore``). The library is named by a hash of its source and flags, so
an edited source rebuilds and an unchanged one loads at once. Nothing here
runs at import time: the CPU tests import every module of the package.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_fwd.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib: Optional[ctypes.CDLL] = None
# {"seconds": build time (0.0 when already built), "ptxas": -Xptxas -v lines}
build_log: Dict[str, object] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{SOURCE.stem}_{digest.hexdigest()[:16]}.so"


def load() -> ctypes.CDLL:
    """Compile the kernels unless already built, and load the library.
    Raises with the compiler's output on failure."""
    global _lib
    if _lib is None:
        target = _lib_path()
        build_log.update(seconds=0.0, ptxas=[])
        if not target.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                                 capture_output=True, text=True)
            output = res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{output}")
            os.replace(tmp, target)
            build_log.update(seconds=time.perf_counter() - t0,
                             ptxas=[ln.strip() for ln in output.splitlines() if ln.strip()])
        _lib = ctypes.CDLL(str(target))
    return _lib
