"""Offline caption generation: per-image and per-group LLaVA captions (port of
``latteclip_tpu/preprocess/captions.py``).

Reproduces the reference's offline caption jobs
(``preprocess/extract_captions_llava_1_6.py`` and ``..._compare.py``):

* per-image: for each train-split tar sample, prompt a vision-language model
  with the dataset-specific prompt (reference ``:355-381``), write
  ``{image_id}.txt``; resumable — existing outputs are skipped
  (``:72-74``); work shards across processes by ``tars[pid::world]``
  (``:216``);
* per-group: sample ``n_images`` images sharing the top-1 pseudo-class,
  concatenate into a 2×2 grid of 672×672 (``_compare.py:89-134,175``), ask
  for *common* visual attributes, write under the donor image's id.

The model is pluggable: ``HFCaptioner`` drives any HF image-text-to-text
model (LLaVA-1.6 etc., requires downloaded weights and ``transformers``,
imported only when one is built) on an explicit ``device``; ``EchoCaptioner``
is a deterministic stub for tests and hermetic smoke runs. Caption
generation stays offline -- only its outputs feed training. Tars are read by
:mod:`latteclip_torch.data.tar_reader`, the pseudo-labels from the pickle of
:mod:`latteclip_torch.eval.features`.

Usage:
    python -m latteclip_torch.preprocess.captions --mode per_image --dataset dtd \
        --data-dir .../dtd_preprocess --output-dir .../captions_per_image \
        --clip-prediction-path .../clip_features_train.pkl --captioner echo

(``--data-dir`` holds ``train_tar/``, the packer's output, and
``webdataset/train/``, the converter's.)
"""
from __future__ import annotations

import argparse
import io
import os
import pickle
from pathlib import Path
from typing import Dict, List, Optional, Protocol, Sequence

import numpy as np
from PIL import Image

from latteclip_torch.data.tar_reader import iter_tar_samples

# dataset-specific prompts (reference extract_captions_llava_1_6.py:355-381)
PER_IMAGE_PROMPTS: Dict[str, str] = {
    "flower102": "Describe the {} flower in the photo concisely, less than 20 words.",
    "food101": "Describe the {} food in the photo concisely, less than 20 words.",
    "eurosat": "Describe the land use in the satellite image concisely, less than 20 words.",
    "sun397": "Describe the scene in the photo concisely, less than 20 words.",
    "dtd": "Describe the texture in the photo concisely, less than 20 words.",
    "fgvc_aircraft": "Describe the aircraft in the photo concisely, less than 20 words.",
    "oxford_pets": "Describe the pet in the photo concisely, less than 20 words.",
    "stanford_cars": "Describe the car in the photo concisely, less than 20 words.",
    "ucf101": "Describe the action of the person in the photo concisely, less than 20 words.",
    "caltech101": "Describe the object in the photo concisely, less than 20 words.",
}

# reference extract_captions_llava_1_6_compare.py:365-381
GROUP_PROMPTS: Dict[str, str] = {
    "flower102": "Describe the common visual attributes of the flowers in all the photos concisely, less than 20 words.",
    "eurosat": "Describe the common visual attributes of the land use in all the satellite images concisely, less than 20 words.",
    "food101": "Describe the common visual attributes of the foods in all the photos concisely, less than 20 words.",
    "sun397": "Describe the common visual attributes of the scenes in all the photos concisely, less than 20 words.",
    "dtd": "Describe the common visual attributes of the textures in all the photos concisely, less than 20 words.",
    "fgvc_aircraft": "Describe the common visual attributes of the aircrafts in all the photos concisely, less than 20 words.",
    "stanford_cars": "Describe the common visual attributes of the cars in all the photos concisely, less than 20 words.",
    "oxford_pets": "Describe the common visual attributes of the pets in all the photos concisely, less than 20 words.",
    "ucf101": "Describe the common visual attributes of the person's actions in all the photos concisely, less than 20 words.",
    "caltech101": "Describe the common visual attributes of the objects in all the photos concisely, less than 20 words.",
}


class Captioner(Protocol):
    def caption(self, image: Image.Image, prompt: str) -> str: ...


class EchoCaptioner:
    """Deterministic stub: echoes the prompt subject (tests / smoke runs)."""

    def caption(self, image: Image.Image, prompt: str) -> str:
        w, h = image.size
        return f"synthetic caption ({w}x{h}): {prompt.split('.')[0].lower()}"


class HFCaptioner:
    """HuggingFace image-text-to-text captioner (LLaVA-1.6 & friends).

    Greedy decoding, <=77 new tokens by default -- the reference's budget
    (``extract_captions_llava_1_6.py:163-177``, temperature 0). The model
    loads on ``device`` (JAX's ``device_map="auto"`` spreads it instead).
    """

    def __init__(self, model_path: str = "llava-hf/llava-v1.6-mistral-7b-hf",
                 max_new_tokens: int = 77, load_4bit: bool = True, device: str = "cuda"):
        from transformers import AutoProcessor, LlavaNextForConditionalGeneration

        kwargs = {"device_map": device}
        if load_4bit:
            kwargs["load_in_4bit"] = True
        self.processor = AutoProcessor.from_pretrained(model_path)
        self.model = LlavaNextForConditionalGeneration.from_pretrained(model_path, **kwargs)
        self.max_new_tokens = max_new_tokens

    def caption(self, image: Image.Image, prompt: str) -> str:
        text = f"[INST] <image>\n{prompt} [/INST]"
        inputs = self.processor(images=image, text=text, return_tensors="pt").to(self.model.device)
        out = self.model.generate(**inputs, max_new_tokens=self.max_new_tokens, do_sample=False)
        decoded = self.processor.decode(out[0], skip_special_tokens=True)
        return decoded.split("[/INST]")[-1].strip()


def make_image_grid(images: Sequence[Image.Image], cell: int = 336) -> Image.Image:
    """2x2 grid of ``cell``-sized tiles (reference _compare.py:89-134: 672x672)."""
    cols = rows = 2
    grid = Image.new("RGB", (cols * cell, rows * cell))
    for idx, img in enumerate(images[: cols * rows]):
        tile = img.resize((cell, cell), Image.BICUBIC)
        grid.paste(tile, ((idx % cols) * cell, (idx // cols) * cell))
    return grid


def _sample_image(raw: dict) -> Optional[Image.Image]:
    data = raw.get("jpg") or raw.get("jpeg") or raw.get("png")
    if data is None:
        return None
    img = Image.open(io.BytesIO(data))
    return img.convert("RGB") if img.mode != "RGB" else img


def extract_per_image_captions(
    tar_paths: Sequence[str],
    clip_prediction_path: str,
    output_dir: str,
    captioner: Captioner,
    prompt_template: str,
    *,
    process_id: int = 0,
    world_size: int = 1,
) -> int:
    """Caption every sample in this process's shard; returns #written."""
    os.makedirs(output_dir, exist_ok=True)
    with open(clip_prediction_path, "rb") as f:
        predictions = pickle.load(f)
    written = 0
    for tar_path in sorted(tar_paths)[process_id::world_size]:
        for raw in iter_tar_samples(str(tar_path)):
            image_id = raw["__key__"]
            out_path = os.path.join(output_dir, f"{image_id}.txt")
            if os.path.exists(out_path):  # resumable (reference :72-74)
                continue
            img = _sample_image(raw)
            if img is None or image_id not in predictions:
                continue
            top1 = predictions[image_id]["class_names"][0]
            prompt = prompt_template.format(top1) if "{}" in prompt_template else prompt_template
            text = captioner.caption(img, prompt).replace("\n", " ").strip()
            with open(out_path, "w") as f:
                f.write(text)
            written += 1
    return written


def extract_group_captions(
    tar_paths: Sequence[str],
    clip_prediction_path: str,
    output_dir: str,
    captioner: Captioner,
    prompt: str,
    *,
    split_dir: Optional[str] = None,
    n_images: int = 4,
    process_id: int = 0,
    world_size: int = 1,
    seed: int = 0,
) -> int:
    """For each sample: grid of n same-pseudo-class images -> common caption."""
    os.makedirs(output_dir, exist_ok=True)
    with open(clip_prediction_path, "rb") as f:
        predictions = pickle.load(f)
    class_to_ids: Dict[str, List[str]] = {}
    for image_id, rec in predictions.items():
        class_to_ids.setdefault(rec["class_names"][0], []).append(image_id)

    # donor images are loaded from the flat split dir (or the tars themselves)
    def load_donor(image_id: str) -> Optional[Image.Image]:
        if split_dir:
            path = os.path.join(split_dir, image_id + ".jpg")
            if os.path.exists(path):
                img = Image.open(path)
                return img.convert("RGB") if img.mode != "RGB" else img
        return None

    rng = np.random.default_rng(seed + process_id)
    written = 0
    for tar_path in sorted(tar_paths)[process_id::world_size]:
        for raw in iter_tar_samples(str(tar_path)):
            image_id = raw["__key__"]
            out_path = os.path.join(output_dir, f"{image_id}.txt")
            if os.path.exists(out_path) or image_id not in predictions:
                continue
            own = _sample_image(raw)
            if own is None:
                continue
            top1 = predictions[image_id]["class_names"][0]
            peers = [i for i in class_to_ids.get(top1, []) if i != image_id]
            rng.shuffle(peers)
            group = [own] + [d for d in map(load_donor, peers) if d is not None][: n_images - 1]
            grid = make_image_grid(group)
            text = captioner.caption(grid, prompt).replace("\n", " ").strip()
            with open(out_path, "w") as f:
                f.write(text)
            written += 1
    return written


def main(argv=None) -> int:
    p = argparse.ArgumentParser(__doc__)
    p.add_argument("--mode", choices=["per_image", "per_group"], required=True)
    p.add_argument("--dataset", required=True)
    p.add_argument("--data-dir", required=True, help="preprocess dir with <split>_tar/")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--clip-prediction-path", required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--captioner", choices=["hf", "echo"], default="hf")
    p.add_argument("--model-path", default="llava-hf/llava-v1.6-mistral-7b-hf")
    p.add_argument("--max-new-tokens", type=int, default=77)
    p.add_argument("--n-images", type=int, default=4)
    p.add_argument("--process-id", "-p", type=int, default=0)
    p.add_argument("--world-size", "-w", type=int, default=1)
    p.add_argument("--device", default="cuda", help="where the HF captioner runs")
    args = p.parse_args(argv)

    tar_dir = Path(args.data_dir) / f"{args.split}_tar"
    tar_paths = sorted(str(t) for t in tar_dir.glob("*.tar"))
    captioner = (
        EchoCaptioner()
        if args.captioner == "echo"
        else HFCaptioner(args.model_path, args.max_new_tokens, device=args.device)
    )
    if args.mode == "per_image":
        prompt = PER_IMAGE_PROMPTS.get(args.dataset, "Describe the image concisely, less than 20 words.")
        n = extract_per_image_captions(
            tar_paths, args.clip_prediction_path, args.output_dir, captioner, prompt,
            process_id=args.process_id, world_size=args.world_size,
        )
    else:
        prompt = GROUP_PROMPTS.get(args.dataset, "Describe the common visual attributes of the images concisely, less than 20 words.")
        split_dir = os.path.join(args.data_dir, "webdataset", args.split)
        n = extract_group_captions(
            tar_paths, args.clip_prediction_path, args.output_dir, captioner, prompt,
            split_dir=split_dir if os.path.isdir(split_dir) else None,
            n_images=args.n_images,
            process_id=args.process_id, world_size=args.world_size,
        )
    print(f"wrote {n} captions to {args.output_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
