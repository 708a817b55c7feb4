"""Hugging Face Hub export: an OpenCLIP-loadable model folder, and its push
(port of ``latteclip_tpu/core/hf_hub.py``, after the reference's
``push_to_hf_hub.py``).

The folder holds:

* ``open_clip_pytorch_model.bin`` -- the state dict through ``torch.save``;
* ``open_clip_model.safetensors`` -- the same tensors, by this module's own
  writer (:func:`save_safetensors`, no ``safetensors`` package needed);
* ``open_clip_config.json`` -- ``{"model_cfg": <the registry JSON>,
  "preprocess_cfg": {mean, std[, interpolation, resize_mode]}}``;
* the BPE tokenizer as HF ``CLIPTokenizer`` files (``vocab.json``,
  ``merges.txt``, the special-token maps), from the port's own tables;
* ``README.md``, the model card (:func:`generate_readme`), written by the push.

``push_to_hf_hub`` uploads with ``huggingface_hub`` where it imports;
everything before the upload is local. Run as a module::

    python -m latteclip_torch.hf_hub --model ViT-B-32 --pretrained <file> \\
        --repo-id <org/name> --local-dir <folder>
"""
from __future__ import annotations

import json
import os
import struct
from pathlib import Path
from typing import Any, Dict, Optional, Union

import torch

HF_WEIGHTS_NAME = "open_clip_pytorch_model.bin"
HF_SAFE_WEIGHTS_NAME = "open_clip_model.safetensors"
HF_CONFIG_NAME = "open_clip_config.json"

# the port's special-token spellings -> HF CLIPTokenizer's (same ids)
_HF_SPECIALS = {"<start_of_text>": "<|startoftext|>", "<end_of_text>": "<|endoftext|>"}

_SAFE_DTYPES = {
    torch.float32: "F32", torch.float16: "F16", torch.float64: "F64", torch.bfloat16: "BF16",
    torch.int64: "I64", torch.int32: "I32", torch.int16: "I16", torch.int8: "I8",
    torch.uint8: "U8", torch.bool: "BOOL",
}


def save_safetensors(tensors: Dict[str, torch.Tensor], path: Union[str, Path]) -> None:
    """A safetensors file (format v0.4: 8-byte little-endian header length,
    the JSON header padded to 8 bytes, then the data), names in sorted order."""
    header: Dict[str, Any] = {}
    blobs, offset = [], 0
    for name in sorted(tensors):
        t = torch.as_tensor(tensors[name]).detach().cpu().contiguous()
        dt = _SAFE_DTYPES.get(t.dtype)
        if dt is None:
            raise ValueError(f"unsupported dtype {t.dtype} for {name}")
        data = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()
        header[name] = {"dtype": dt, "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    hjson = json.dumps(header, separators=(",", ":")).encode("utf-8")
    hjson += b" " * ((8 - len(hjson) % 8) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for b in blobs:
            f.write(b)


def save_tokenizer_for_hf(tokenizer, save_directory: Union[str, Path]) -> None:
    """The BPE tokenizer as HF ``CLIPTokenizer`` files: ``vocab.json`` (the
    HF special-token spellings at the same ids), ``merges.txt`` in rank
    order, the special-token map and the tokenizer config."""
    save_directory = Path(save_directory)
    save_directory.mkdir(parents=True, exist_ok=True)
    vocab = {_HF_SPECIALS.get(tok, tok): idx for tok, idx in tokenizer.encoder.items()}
    with open(save_directory / "vocab.json", "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    merges = sorted(tokenizer.merge_rank.items(), key=lambda kv: kv[1])
    with open(save_directory / "merges.txt", "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        for (a, b), _rank in merges:
            f.write(f"{a} {b}\n")
    specials = {"bos_token": "<|startoftext|>", "eos_token": "<|endoftext|>",
                "unk_token": "<|endoftext|>", "pad_token": "<|endoftext|>"}
    with open(save_directory / "special_tokens_map.json", "w") as f:
        json.dump(specials, f, indent=2)
    with open(save_directory / "tokenizer_config.json", "w") as f:
        json.dump({"tokenizer_class": "CLIPTokenizer",
                   "model_max_length": tokenizer.context_length or 77, **specials}, f, indent=2)


def raw_model_config(model_name: str) -> Dict[str, Any]:
    """The registry JSON of ``model_name`` as it is on disk."""
    from latteclip_torch.config import _CONFIG_DIR

    path = _CONFIG_DIR / f"{model_name}.json"
    if not path.exists():
        raise FileNotFoundError(f"unknown model config: {model_name}")
    with open(path) as f:
        return json.load(f)


def save_config_for_hf(cfg, config_path: Union[str, Path], model_config: Optional[dict],
                       image_interpolation: Optional[str] = None,
                       image_resize_mode: Optional[str] = None) -> None:
    from latteclip_torch.data import transforms as T

    mean, std = T.model_mean_std(cfg)
    preprocess_cfg: Dict[str, Any] = {"mean": list(mean), "std": list(std)}
    if image_interpolation:
        preprocess_cfg["interpolation"] = image_interpolation
    if image_resize_mode:
        preprocess_cfg["resize_mode"] = image_resize_mode
    with open(config_path, "w") as f:
        json.dump({"model_cfg": model_config, "preprocess_cfg": preprocess_cfg}, f, indent=2)


def save_for_hf(model, tokenizer, model_config: Optional[dict],
                save_directory: Union[str, Path], safe_serialization: Union[bool, str] = "both",
                skip_weights: bool = False, memory_bank: Optional[torch.Tensor] = None,
                class_names: Optional[list] = None, image_interpolation: Optional[str] = None,
                image_resize_mode: Optional[str] = None) -> None:
    """Weights (pickle and/or safetensors), tokenizer files and
    ``open_clip_config.json`` of ``model`` into ``save_directory``."""
    save_directory = Path(save_directory)
    save_directory.mkdir(parents=True, exist_ok=True)
    if not skip_weights:
        from latteclip_torch.checkpoint import state_dict_with_bank

        sd = state_dict_with_bank(model, memory_bank, class_names)
        if safe_serialization in (True, "both"):
            save_safetensors(sd, save_directory / HF_SAFE_WEIGHTS_NAME)
        if safe_serialization in (False, "both"):
            torch.save(sd, save_directory / HF_WEIGHTS_NAME)
    save_tokenizer_for_hf(tokenizer, save_directory)
    save_config_for_hf(model.cfg, save_directory / HF_CONFIG_NAME, model_config=model_config,
                       image_interpolation=image_interpolation,
                       image_resize_mode=image_resize_mode)


def generate_readme(model_card: dict, model_name: str) -> str:
    """The model card's markdown (the reference's ``generate_readme``)."""
    model_card = dict(model_card)  # the reference pops from the caller's dict
    tags = model_card.pop("tags", ("clip",))
    pipeline_tag = model_card.pop("pipeline_tag", "zero-shot-image-classification")
    text = "---\n"
    if tags:
        text += "tags:\n" + "".join(f"- {t}\n" for t in tags)
    text += "library_name: open_clip\n"
    text += f"pipeline_tag: {pipeline_tag}\n"
    text += f"license: {model_card.get('license', 'mit')}\n"
    if "details" in model_card and "Dataset" in model_card["details"]:
        text += "datasets:\n"
        text += f"- {model_card['details']['Dataset'].lower()}\n"
    text += "---\n"
    text += f"# Model card for {model_name}\n"
    if "description" in model_card:
        text += f"\n{model_card['description']}\n"
    if "details" in model_card:
        text += "\n## Model Details\n"
        for k, v in model_card["details"].items():
            if isinstance(v, (list, tuple)):
                text += f"- **{k}:**\n" + "".join(f"  - {vi}\n" for vi in v)
            elif isinstance(v, dict):
                text += f"- **{k}:**\n" + "".join(f"  - {ki}: {vi}\n" for ki, vi in v.items())
            else:
                text += f"- **{k}:** {v}\n"
    if "usage" in model_card:
        text += "\n## Model Usage\n" + model_card["usage"] + "\n"
    if "comparison" in model_card:
        text += "\n## Model Comparison\n" + model_card["comparison"] + "\n"
    if "citation" in model_card:
        text += "\n## Citation\n"
        citations = model_card["citation"]
        if not isinstance(citations, (list, tuple)):
            citations = [citations]
        for c in citations:
            text += f"```bibtex\n{c}\n```\n"
    return text


def push_to_hf_hub(model, tokenizer, model_config: Optional[dict], repo_id: str,
                   commit_message: str = "Add model", token: Optional[str] = None,
                   revision: Optional[str] = None, private: bool = False,
                   create_pr: bool = False, model_card: Optional[dict] = None,
                   safe_serialization: Union[bool, str] = "both",
                   local_dir: Optional[str] = None, **save_kwargs):
    """Build the model folder (kept at ``local_dir`` when given) and upload
    it with ``huggingface_hub``; without that package it raises after the
    folder is built."""
    from tempfile import TemporaryDirectory

    try:
        from huggingface_hub import create_repo, upload_folder
    except ImportError:  # the reference's _has_hf_hub gate
        create_repo = upload_folder = None
    ctx = TemporaryDirectory() if local_dir is None else None
    folder = ctx.name if ctx is not None else local_dir
    try:
        save_for_hf(model, tokenizer, model_config, save_directory=folder,
                    safe_serialization=safe_serialization, **save_kwargs)
        readme_path = Path(folder) / "README.md"
        if not readme_path.exists():
            readme_path.write_text(generate_readme(model_card or {}, repo_id.split("/")[-1]))
        if upload_folder is None:
            where = (f"folder kept at {folder}" if local_dir is not None
                     else "pass local_dir= to keep the built folder")
            raise RuntimeError(f"Please install huggingface_hub to push to the Hugging Face Hub "
                               f"({where})")
        create_repo(repo_id, token=token, private=private, exist_ok=True)
        return upload_folder(repo_id=repo_id, folder_path=folder, revision=revision,
                             create_pr=create_pr, commit_message=commit_message, token=token)
    finally:
        if ctx is not None:
            ctx.cleanup()


def push_pretrained_to_hf_hub(model_name: str, pretrained: str, repo_id: str,
                              image_interpolation: Optional[str] = None,
                              image_resize_mode: Optional[str] = None,
                              local_dir: Optional[str] = None, device="cuda", **kwargs):
    """Load a pretrained checkpoint (a file, or a registry tag resolved in
    the cache) and push it."""
    from latteclip_torch.checkpoint import load_clip_pt
    from latteclip_torch.config import get_model_config
    from latteclip_torch.models.tokenizer import get_tokenizer
    from latteclip_torch.pretrained import resolve_pretrained

    cfg = get_model_config(model_name)
    path = pretrained if os.path.exists(pretrained) else resolve_pretrained(model_name, pretrained)
    model, _bank, _classnames, _meta = load_clip_pt(path, cfg, device=device)
    return push_to_hf_hub(model, get_tokenizer(), model_config=raw_model_config(model_name),
                          repo_id=repo_id, image_interpolation=image_interpolation,
                          image_resize_mode=image_resize_mode, local_dir=local_dir, **kwargs)


def _main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="Push to Hugging Face Hub")
    p.add_argument("--model", type=str, required=True)
    p.add_argument("--pretrained", type=str, required=True)
    p.add_argument("--repo-id", type=str, required=True)
    p.add_argument("--image-interpolation", default=None, choices=["bicubic", "bilinear", "random"])
    p.add_argument("--image-resize-mode", default=None, choices=["shortest", "longest", "squash"])
    p.add_argument("--local-dir", default=None, help="also keep the built folder at this path")
    p.add_argument("--device", default="cuda", help="where the checkpoint loads (cuda or cpu)")
    args = p.parse_args(argv)
    print(f"Saving model {args.model} ({args.pretrained}) to {args.repo_id}")
    push_pretrained_to_hf_hub(args.model, args.pretrained, args.repo_id,
                              image_interpolation=args.image_interpolation,
                              image_resize_mode=args.image_resize_mode,
                              local_dir=args.local_dir, device=args.device)
    print(f"{args.model} saved.")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
