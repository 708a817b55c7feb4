"""Checkpoint/result sync to remote storage (reference ``file_utils.py``;
the port's own copy of ``latteclip_tpu/obs/file_sync.py``, which imports no
JAX).

Mirrors the reference's remote-sync subsystem: a background daemon thread
periodically pushes the local log dir to a remote destination
(``file_utils.py:54-61``), using ``aws s3 sync`` for ``s3://`` URLs
(``:10-18``, excluding the in-progress ``epoch_latest.pt``) and a local
recursive copy otherwise (the fsspec path, ``:20-42``). ``pt_load_path``
resolves possibly-remote checkpoint paths for resume (``:69-75``).
"""
from __future__ import annotations

import logging
import os
import shutil
import subprocess
import threading
from typing import Optional

logger = logging.getLogger("latteclip_torch")


def sync_dir_s3(local_dir: str, remote_dir: str) -> bool:
    """aws s3 sync, excluding the atomically-rewritten latest checkpoint."""
    result = subprocess.run(
        ["aws", "s3", "sync", local_dir, remote_dir, "--exclude", "*epoch_latest.pt"],
        capture_output=True,
        text=True,
    )
    if result.returncode != 0:
        logger.error("s3 sync failed: %s", result.stderr.strip()[-500:])
        return False
    return True


def sync_dir_local(local_dir: str, remote_dir: str) -> bool:
    """Recursive copy for mounted/NFS destinations."""
    try:
        for root, _dirs, files in os.walk(local_dir):
            rel = os.path.relpath(root, local_dir)
            for f in files:
                if f == "epoch_latest.pt":
                    continue
                dst_dir = os.path.join(remote_dir, rel) if rel != "." else remote_dir
                os.makedirs(dst_dir, exist_ok=True)
                src = os.path.join(root, f)
                dst = os.path.join(dst_dir, f)
                if not os.path.exists(dst) or os.path.getmtime(src) > os.path.getmtime(dst):
                    shutil.copy2(src, dst)
        return True
    except OSError as e:
        logger.error("local sync failed: %s", e)
        return False


def sync_dir(local_dir: str, remote_dir: str) -> bool:
    if remote_dir.startswith("s3://"):
        return sync_dir_s3(local_dir, remote_dir)
    return sync_dir_local(local_dir, remote_dir)


class RemoteSync:
    """Background periodic sync (reference start_sync_process equivalent,
    thread-based: there is no CUDA-context reason to pay a process here)."""

    def __init__(self, local_dir: str, remote_dir: str, frequency_s: float = 300.0,
                 protocol: str = "s3"):
        # --remote-sync-protocol (reference file_utils.py:20-61): "s3" keeps
        # the URL-based dispatch (aws s3 sync for s3:// urls); "fsspec"
        # forces the recursive-copy path like remote_sync_fsspec
        self.local_dir = local_dir
        self.remote_dir = remote_dir
        self.frequency_s = frequency_s
        self.protocol = protocol
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "RemoteSync":
        def run():
            while not self._stop.wait(self.frequency_s):
                if self.protocol == "fsspec":
                    ok = sync_dir_local(self.local_dir, self.remote_dir)
                else:
                    ok = sync_dir(self.local_dir, self.remote_dir)
                logger.info("remote sync %s", "ok" if ok else "FAILED")

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return self

    def final_sync(self) -> bool:
        self._stop.set()
        return sync_dir(self.local_dir, self.remote_dir)


def pt_load_path(path: str, cache_dir: Optional[str] = None) -> str:
    """Resolve a possibly-remote checkpoint path to a local file for loading
    (reference ``file_utils.py:69-75`` pt_load). s3:// paths are fetched
    with ``aws s3 cp`` into ``cache_dir`` (or a temp dir); local paths pass
    through unchanged."""
    if not path.startswith("s3://"):
        return path
    import tempfile

    cache_dir = cache_dir or tempfile.mkdtemp(prefix="latteclip_s3_")
    os.makedirs(cache_dir, exist_ok=True)
    local = os.path.join(cache_dir, os.path.basename(path))
    result = subprocess.run(
        ["aws", "s3", "cp", path, local], capture_output=True, text=True
    )
    if result.returncode != 0:
        raise FileNotFoundError(
            f"could not fetch {path}: {result.stderr.strip()[-500:]}"
        )
    return local
