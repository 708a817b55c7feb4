"""Minimal TensorBoard scalar writer, stdlib only (the port's own copy of
``latteclip_tpu/obs/tensorboard.py``, which imports no JAX; the two write
the same bytes).

The reference treats ``--report-to tensorboard`` as first-class
(``src/training/main.py:434-457``, writer created from
``torch.utils.tensorboard``; scalars logged in ``train.py`` ~599-607 as
``train/<name>`` and in ``evaluate`` as ``val/<name>``). This module
produces byte-compatible TensorBoard event files from scratch:

* records in TFRecord framing: ``uint64 len | masked-crc32c(len) |
  payload | masked-crc32c(payload)``;
* payload is a hand-encoded ``tensorflow.Event`` protobuf carrying
  ``wall_time``, ``step`` and a ``Summary`` with one ``simple_value``;
* the first record is the canonical ``brain.Event:2`` file-version event.

crc32c is the Castagnoli polynomial (0x82F63B78, reflected), table-driven;
masking is TensorFlow's ``((crc >> 15) | (crc << 17)) + 0xa282ead8``.
"""
from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Optional

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_delimited(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def encode_scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    """Serialize a ``tensorflow.Event`` proto with one scalar summary value."""
    # Summary.Value { tag = 1 (string), simple_value = 2 (float) }
    val = _len_delimited(1, tag.encode("utf-8")) + _tag(2, 5) + struct.pack("<f", value)
    summary = _len_delimited(1, val)  # Summary { value = 1 (repeated) }
    # Event { wall_time = 1 (double), step = 2 (int64), summary = 5 }
    return (
        _tag(1, 1) + struct.pack("<d", wall_time)
        + _tag(2, 0) + _varint(step & 0xFFFFFFFFFFFFFFFF)
        + _len_delimited(5, summary)
    )


def encode_file_version_event(wall_time: float) -> bytes:
    # Event { wall_time = 1, file_version = 3 (string) }
    return _tag(1, 1) + struct.pack("<d", wall_time) + _len_delimited(3, b"brain.Event:2")


def frame_record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (
        header
        + struct.pack("<I", masked_crc32c(header))
        + payload
        + struct.pack("<I", masked_crc32c(payload))
    )


def read_records(path: str):
    """Parse a TFRecord file back into payload bytes (crc-checked). Test aid
    and debugging tool; TensorBoard itself is the intended consumer."""
    out = []
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return out
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            if hcrc != masked_crc32c(header):
                raise ValueError("length crc mismatch")
            payload = f.read(length)
            (pcrc,) = struct.unpack("<I", f.read(4))
            if pcrc != masked_crc32c(payload):
                raise ValueError("payload crc mismatch")
            out.append(payload)


def decode_scalar_event(payload: bytes) -> Optional[Dict]:
    """Inverse of :func:`encode_scalar_event` (enough of the proto to test)."""
    i, out = 0, {}
    while i < len(payload):
        key = payload[i]
        i += 1
        field, wire = key >> 3, key & 7
        if wire == 1:
            (v,) = struct.unpack_from("<d", payload, i)
            i += 8
            if field == 1:
                out["wall_time"] = v
        elif wire == 0:
            v, shift = 0, 0
            while True:
                b = payload[i]
                i += 1
                v |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            if field == 2:
                out["step"] = v
        elif wire == 2:
            ln, shift = 0, 0
            while True:
                b = payload[i]
                i += 1
                ln |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            body = payload[i:i + ln]
            i += ln
            if field == 3:
                out["file_version"] = body.decode()
            elif field == 5:  # Summary -> first Value {tag, simple_value}
                j = 0
                while j < len(body):
                    k = body[j]
                    j += 1
                    if k >> 3 == 1 and k & 7 == 2:
                        vl, shift = 0, 0
                        while True:
                            b = body[j]
                            j += 1
                            vl |= (b & 0x7F) << shift
                            shift += 7
                            if not b & 0x80:
                                break
                        vb, m = body[j:j + vl], 0
                        j += vl
                        while m < len(vb):
                            vk = vb[m]
                            m += 1
                            if vk >> 3 == 1 and vk & 7 == 2:
                                tl = vb[m]
                                m += 1
                                out["tag"] = vb[m:m + tl].decode()
                                m += tl
                            elif vk >> 3 == 2 and vk & 7 == 5:
                                (out["simple_value"],) = struct.unpack_from("<f", vb, m)
                                m += 4
                            else:
                                return out
                    else:
                        break
        else:
            break
    return out


class SummaryWriter:
    """Drop-in for the two ``torch.utils.tensorboard`` methods the reference
    uses: ``add_scalar`` (train.py:607, zero-shot eval) and ``flush``."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self.path = os.path.join(log_dir, fname)
        self._f = open(self.path, "ab")
        self._f.write(frame_record(encode_file_version_event(time.time())))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        payload = encode_scalar_event(tag, float(value), int(step), time.time())
        self._f.write(frame_record(payload))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.flush()
        self._f.close()


class WandbWriter:
    """wandb sink with the writer interface the train loop drives
    (``add_scalar``/``flush``/``close``), mirroring the reference's usage:
    ``wandb.init(project, name, id, notes, tags=[], resume, config)``
    (main.py:444-453) and one ``wandb.log(log_data, step=step)`` per logged
    step (train.py:626-629) — scalars are batched per step and emitted at
    ``flush`` so each step produces a single log call like the reference's
    dict logging."""

    def __init__(self, project: str, run_name: str, notes: str = "",
                 resume=None, config: dict = None):
        import wandb

        self._wandb = wandb
        wandb.init(
            project=project,
            name=run_name,
            id=run_name,
            notes=notes,
            tags=[],
            resume=resume,
            config=dict(config or {}),
        )
        self._pending: dict = {}

    def add_scalar(self, name: str, value: float, step: int) -> None:
        self._pending.setdefault(int(step), {})[name] = float(value)

    def flush(self) -> None:
        for step in sorted(self._pending):
            self._wandb.log(self._pending[step], step=step)
        self._pending.clear()

    def close(self) -> None:
        self.flush()
        self._wandb.finish()


def make_writers(report_to: str, log_base_path: str, run_name: str, is_master: bool,
                 wandb_project: str = "open-clip", wandb_notes: str = "",
                 wandb_resume=None, config: dict = None):
    """Build the reporting sinks the reference supports (main.py:434-457).

    ``report_to`` is a comma-separated subset of {"tensorboard", "wandb"}.
    wandb is not installed in this environment; requesting it raises the
    same hard error the reference's ``assert wandb is not None`` produces.
    """
    writers = []
    if not is_master:
        return writers
    for target in [t for t in (report_to or "").split(",") if t]:
        if target == "tensorboard":
            writers.append(SummaryWriter(os.path.join(log_base_path, run_name, "tensorboard")))
        elif target == "wandb":
            try:
                import wandb  # noqa: F401
            except ImportError as e:
                # the reference's `assert wandb is not None, 'Please install
                # wandb.'` failure mode (main.py:438)
                raise ImportError(
                    "wandb requested via --report-to but not installed"
                ) from e
            writers.append(WandbWriter(
                project=wandb_project, run_name=run_name, notes=wandb_notes,
                resume=wandb_resume, config=config))
        else:
            raise ValueError(f"unknown --report-to target: {target!r}")
    return writers
