"""The host's native JPEG decoder for the train input path (port of
``latteclip_tpu/native/__init__.py``).

``fastjpeg.c`` (a byte-identical copy of the JAX package's) decodes with
libjpeg's DCT scaling, crops the box and resizes bilinearly to the square
output in one pass. :func:`load_fastjpeg` compiles it at first use with the
host's C compiler (``$CC``, default ``cc``) against libjpeg and Python's
headers into ``build/native/`` at the repository root (named by a hash of
the source; a library there that does not load, built on another host, is
built again), loads it and returns the module; where it cannot be built it
logs why and returns None, and the callers decode with PIL, as the JAX
package does. :func:`build_status` tells which happened.
"""
from __future__ import annotations

import hashlib
import importlib.util
import logging
import os
import subprocess
import sysconfig
import time
from functools import lru_cache
from pathlib import Path
from typing import Optional

logger = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parent / "fastjpeg.c"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_status = {"loaded": False, "path": None, "seconds": None, "error": "not built yet"}


def _compile(so_path: Path) -> Optional[str]:
    """Build the extension; the compiler's error, or None."""
    so_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [os.environ.get("CC", "cc"), "-O3", "-shared", "-fPIC", "-std=c11", str(SOURCE),
           f"-I{sysconfig.get_paths()['include']}", "-ljpeg", "-o", str(tmp)]
    try:
        result = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{cmd[0]}: {e}"
    if result.returncode != 0:
        return result.stderr[-400:] or f"{cmd[0]} exited with {result.returncode}"
    os.replace(tmp, so_path)
    return None


def _load(so_path: Path):
    spec = importlib.util.spec_from_file_location("_fastjpeg", so_path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@lru_cache()
def load_fastjpeg():
    """The compiled ``_fastjpeg`` module (``probe``, ``decode_crop_resize``),
    or None where it cannot be built (``LATTECLIP_DISABLE_NATIVE=1`` too)."""
    _status.update(loaded=False, path=None, seconds=None)
    if os.environ.get("LATTECLIP_DISABLE_NATIVE", "0") == "1":
        _status["error"] = "LATTECLIP_DISABLE_NATIVE=1"
        return None
    t0 = time.perf_counter()
    try:
        digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
        so_path = BUILD_DIR / f"_fastjpeg_{digest}.so"
        built = not so_path.exists()
        error = _compile(so_path) if built else None
        if error is None:
            try:
                module = _load(so_path)
            except ImportError:
                if built:
                    raise
                # a library built on another host (its libjpeg absent here): build it here
                error = _compile(so_path)
                module = _load(so_path) if error is None else None
        if error is not None:
            _status["error"] = error
            logger.warning("fastjpeg build failed: %s", error)
            return None
    except Exception as e:  # any failure: the PIL decode
        _status["error"] = f"{type(e).__name__}: {e}"
        logger.warning("fastjpeg unavailable: %s", e)
        return None
    _status.update(loaded=True, path=str(so_path), error=None,
                   seconds=time.perf_counter() - t0)
    return module


def build_status() -> dict:
    """Builds (or loads) the decoder and says how: ``loaded``, the
    library's ``path``, the ``seconds`` it took and the ``error`` if not."""
    load_fastjpeg()
    return dict(_status)
