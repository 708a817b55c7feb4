"""Classification dataset -> flat webdataset layout (offline preprocess; port
of ``latteclip_tpu/preprocess/to_webdataset.py``, host code only).

One parameterized CLI replaces the reference's ten near-identical converter
scripts (``preprocess/unsupervised/*_to_webdataset.py``). Semantics match
the reference: the CoOp ``split_zhou_<Name>.json`` lists
``[impath, class_id, classname]``; ``train+val`` become the train split and
``test`` becomes the val split (reference ``dtd_to_webdataset.py:39-41``);
outputs are ``id_to_class.json`` / ``class_to_id.json`` at the preprocess
root and ``{image_id}.jpg/.txt/.json`` flat files per split
(``dtd_to_webdataset.py:49-92``). FGVC-Aircraft builds its split from
``variants.txt`` + ``images_variant_{split}.txt``
(``fgvc_aircraft_to_webdataset.py:30-47``).

Usage:
    python -m latteclip_torch.preprocess.to_webdataset --dataset dtd \\
        --dataset-dir $LATTECLIP_DATA_DIR/dtd \\
        --preprocess-dir $LATTECLIP_DATA_DIR/dtd_preprocess
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
from typing import Dict, List, Optional, Tuple

Sample = Tuple[str, int, str]  # (image path relative to images root, class id, classname)


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    split_file: str            # CoOp split json inside dataset_dir
    images_subdir: str = "images"  # subdir holding the image files
    id_scheme: str = "basename"    # 'basename' | 'class_prefixed'


# per-dataset conventions lifted from the reference converter scripts
DATASET_SPECS: Dict[str, DatasetSpec] = {
    "dtd": DatasetSpec("split_zhou_DescribableTextures.json", "images"),
    "eurosat": DatasetSpec("split_zhou_EuroSAT.json", "images"),
    "sun397": DatasetSpec("split_zhou_SUN397.json", "images"),
    "caltech101": DatasetSpec("split_zhou_Caltech101.json", "images", "class_prefixed"),
    "flower102": DatasetSpec("split_zhou_OxfordFlowers.json", "jpg"),
    "oxford_pets": DatasetSpec("split_zhou_OxfordPets.json", "images"),
    "stanford_cars": DatasetSpec("split_zhou_StanfordCars.json", ""),
    "ucf101": DatasetSpec("split_zhou_UCF101.json", "images"),
    "food101": DatasetSpec("split_zhou_food101.json", "images"),
}


def load_coop_split(dataset_dir: str, spec: DatasetSpec) -> Tuple[List[Sample], List[Sample]]:
    with open(os.path.join(dataset_dir, spec.split_file)) as f:
        split = json.load(f)
    train = [tuple(s) for s in split["train"] + split["val"]]
    test = [tuple(s) for s in split["test"]]
    return train, test


def load_fgvc_split(dataset_dir: str) -> Tuple[List[Sample], List[Sample]]:
    with open(os.path.join(dataset_dir, "variants.txt")) as f:
        classnames = [line.strip() for line in f if line.strip()]
    cname2lab = {c: i for i, c in enumerate(classnames)}

    def read(split_file: str) -> List[Sample]:
        out: List[Sample] = []
        with open(os.path.join(dataset_dir, split_file)) as f:
            for line in f:
                parts = line.strip().split(" ")
                imname, classname = parts[0], " ".join(parts[1:])
                out.append((imname + ".jpg", cname2lab[classname], classname))
        return out

    train = read("images_variant_train.txt") + read("images_variant_val.txt")
    test = read("images_variant_test.txt")
    return train, test


def image_id_of(image_path: str, class_name: str, scheme: str) -> str:
    base = os.path.basename(image_path).split(".")[0]
    if scheme == "class_prefixed":
        return f"{class_name}_{base}"
    return base


def convert(
    dataset: str,
    dataset_dir: str,
    preprocess_dir: str,
    exp_name: str = "",
    text_dirs: Optional[List[str]] = None,
) -> Dict[str, int]:
    if dataset == "fgvc_aircraft":
        spec = DatasetSpec("", "images")
        train, test = load_fgvc_split(dataset_dir)
    else:
        spec = DATASET_SPECS[dataset]
        train, test = load_coop_split(dataset_dir, spec)

    os.makedirs(preprocess_dir, exist_ok=True)
    id_to_class: Dict[str, str] = {}
    class_to_id: Dict[str, int] = {}
    for _path, class_id, class_name in train + test:
        id_to_class[str(class_id)] = class_name
        class_to_id[class_name] = class_id
    with open(os.path.join(preprocess_dir, "id_to_class.json"), "w") as f:
        json.dump(id_to_class, f)
    with open(os.path.join(preprocess_dir, "class_to_id.json"), "w") as f:
        json.dump(class_to_id, f)

    images_root = os.path.join(dataset_dir, spec.images_subdir) if spec.images_subdir else dataset_dir
    counts = {}
    for split, data in (("train", train), ("val", test)):
        split_dir = os.path.join(preprocess_dir, "webdataset", f"{split}{exp_name}")
        os.makedirs(split_dir, exist_ok=True)
        for image_path, _class_id, class_name in data:
            image_id = image_id_of(image_path, class_name, spec.id_scheme)

            # caption text: concatenated text dirs on train, empty otherwise
            text = ""
            if split == "train" and text_dirs:
                parts = []
                for td in text_dirs:
                    with open(os.path.join(td, f"{image_id}.txt")) as f:
                        parts.append(f.read().replace("\n", ""))
                text = "\n".join(parts)
            with open(os.path.join(split_dir, f"{image_id}.txt"), "w") as f:
                f.write(text)

            with open(os.path.join(split_dir, f"{image_id}.json"), "w") as f:
                json.dump({"image_id": image_id, "class_name": class_name}, f)

            shutil.copy(
                os.path.join(images_root, image_path),
                os.path.join(split_dir, f"{image_id}.jpg"),
            )
        counts[split] = len(data)
    return counts


def main(argv=None) -> int:
    p = argparse.ArgumentParser(__doc__)
    p.add_argument("--dataset", required=True,
                   choices=sorted(list(DATASET_SPECS) + ["fgvc_aircraft"]))
    p.add_argument("--dataset-dir", required=True)
    p.add_argument("--preprocess-dir", required=True)
    p.add_argument("--exp-name", default="")
    p.add_argument("--text-dirs", "-td", action="append", default=None)
    args = p.parse_args(argv)
    counts = convert(args.dataset, args.dataset_dir, args.preprocess_dir,
                     args.exp_name, args.text_dirs)
    for split, n in counts.items():
        print(f"Total {n} images in {split} split.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
