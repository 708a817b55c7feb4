"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` compiles with ``nvcc`` into its own shared library with a
plain C interface, loaded with ``ctypes``; the sources build in parallel, one
``nvcc`` each, all started together. The build runs at first use, on the
machine with the card, into ``<checkout>/build/kernels/`` (listed in
``.gitignore``). A library is named by a hash of its source, the shared
headers and the flags, so an edited source rebuilds and an unchanged one loads
at once. Nothing here runs at import time: the CPU tests import every module
of the package.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"flash_fwd": CSRC / "flash_fwd.cu", "flash_bwd": CSRC / "flash_bwd.cu",
           "ln_linear": CSRC / "ln_linear.cu", "lab": CSRC / "lab.cu",
           "layer_norm": CSRC / "layer_norm.cu"}
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# Sources that nvcc optimises on several threads (--split-compile=0):
# flash_fwd.cu, the longest build, took 47-50 s with it against 70-77 s
# without, beside the other builds on the card's 8-core host, and its
# kernels' times did not move; flash_bwd.cu's warpgroup ring ran 5% slower
# at [336, 128, 8 x 64] built so, and the other sources finish sooner anyway.
SPLIT_COMPILE = ("flash_fwd",)

_libs: Dict[str, ctypes.CDLL] = {}
# per source: {"seconds": nvcc wall time (0.0 when already built), "ptxas": -Xptxas -v lines}
build_log: Dict[str, Dict[str, object]] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _flags(name: str) -> List[str]:
    return [*NVCC_FLAGS, *(["--split-compile=0"] if name in SPLIT_COMPILE else [])]


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"{name}_{digest.hexdigest()[:16]}.so"


def load_all() -> Dict[str, ctypes.CDLL]:
    """Compile every source not yet built, in parallel, and load all the
    libraries. Raises with the compiler's output on failure."""
    if len(_libs) == len(SOURCES):
        return _libs
    targets = {name: _lib_path(name) for name in SOURCES}
    jobs: List[tuple] = []
    for name, target in targets.items():
        build_log[name] = {"seconds": 0.0, "ptxas": []}
        if not target.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [_nvcc(), *_flags(name), "-o", str(tmp), str(SOURCES[name])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((name, target, tmp, proc, time.perf_counter()))
    failures = []
    for name, target, tmp, proc, t0 in jobs:
        output, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {SOURCES[name].name}:\n{output}")
            continue
        os.replace(tmp, target)
        build_log[name] = {"seconds": time.perf_counter() - t0,
                           "ptxas": [ln.strip() for ln in output.splitlines() if ln.strip()]}
    if failures:
        raise RuntimeError("\n".join(failures))
    for name, target in targets.items():
        _libs[name] = ctypes.CDLL(str(target))
    return _libs


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu`` (every source builds on the
    first call)."""
    return load_all()[name]
