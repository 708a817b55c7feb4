"""Pack a flat webdataset split into NNNNN.tar shards (offline preprocess;
port of ``latteclip_tpu/preprocess/create_tarfiles.py``).

CLI parity with the reference ``preprocess/create_tarfiles.py:10-40``: group
``{id}.{json,txt,jpg}`` triples into tars of ``--items-per-tar`` samples.

Usage:
    python -m latteclip_torch.preprocess.create_tarfiles \\
        --input-dir .../webdataset/train --output-dir .../webdataset/train_tar \\
        --items-per-tar 100
"""
from __future__ import annotations

import argparse
import os
import tarfile
from typing import List

MEMBER_ORDER = (".json", ".txt", ".jpg")


def pack(input_dir: str, output_dir: str, items_per_tar: int = 100) -> List[str]:
    os.makedirs(output_dir, exist_ok=True)
    image_ids = sorted({os.path.splitext(f)[0] for f in os.listdir(input_dir)})
    shards: List[str] = []
    for start in range(0, len(image_ids), items_per_tar):
        shard_ids = image_ids[start : start + items_per_tar]
        path = os.path.join(output_dir, f"{start // items_per_tar:05d}.tar")
        with tarfile.open(path, "w") as tf:
            for image_id in shard_ids:
                for ext in MEMBER_ORDER:
                    member = os.path.join(input_dir, image_id + ext)
                    if os.path.exists(member):
                        tf.add(member, arcname=image_id + ext)
        shards.append(path)
    return shards


def main(argv=None) -> int:
    p = argparse.ArgumentParser(__doc__)
    p.add_argument("--input-dir", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--items-per-tar", type=int, default=100)
    args = p.parse_args(argv)
    shards = pack(args.input_dir, args.output_dir, args.items_per_tar)
    print(f"wrote {len(shards)} shards to {args.output_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
