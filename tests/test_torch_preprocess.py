"""The port's offline preprocess jobs (latteclip_torch/preprocess/) against
latteclip_tpu/preprocess/ on tests/test_preprocess.py's fixtures (a
miniature CoOp dataset; ``make_full_fixture``'s tars and pseudo-label
pickle): the converter's flat files, the packer's tar members (names in
order and bytes), and the per-image and per-group caption files are equal
to JAX's; the jobs' ``main``s run; the FGVC split reader reads as JAX's;
the resumable caption job writes nothing on a second run."""
import dataclasses
import filecmp
import os
import pickle
import tarfile

import pytest
from PIL import Image

from latteclip_tpu.data.synthetic import make_full_fixture
from latteclip_tpu.preprocess import captions as jax_captions
from latteclip_tpu.preprocess import create_tarfiles as jax_tarfiles
from latteclip_tpu.preprocess import to_webdataset as jax_webdataset
from latteclip_torch.preprocess import captions, create_tarfiles, to_webdataset

from test_preprocess import coop_dataset  # noqa: F401


def same_tree(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for n in names:
        pa, pb = os.path.join(a, n), os.path.join(b, n)
        if os.path.isdir(pa):
            same_tree(pa, pb)
        else:
            assert filecmp.cmp(pa, pb, shallow=False), pa


def members(path):
    with tarfile.open(path) as tf:
        return [(m.name, tf.extractfile(m).read()) for m in tf.getmembers()]


def test_converter_and_packer_equal_jax(coop_dataset, tmp_path):  # noqa: F811
    assert to_webdataset.convert("dtd", coop_dataset, str(tmp_path / "torch")) == \
        jax_webdataset.convert("dtd", coop_dataset, str(tmp_path / "jax")) == {"train": 8, "val": 4}
    same_tree(tmp_path / "torch", tmp_path / "jax")
    train = str(tmp_path / "torch" / "webdataset" / "train")
    ours = create_tarfiles.pack(train, str(tmp_path / "tars_torch"), items_per_tar=3)
    theirs = jax_tarfiles.pack(train, str(tmp_path / "tars_jax"), items_per_tar=3)
    assert [os.path.basename(p) for p in ours] == [os.path.basename(p) for p in theirs]
    for a, b in zip(ours, theirs):
        assert members(a) == members(b)


def test_mains_equal_jax(coop_dataset, tmp_path, capsys):  # noqa: F811
    for mod, out in ((to_webdataset, "torch"), (jax_webdataset, "jax")):
        assert mod.main(["--dataset", "dtd", "--dataset-dir", coop_dataset,
                         "--preprocess-dir", str(tmp_path / out), "--exp-name", "_x"]) == 0
    same_tree(tmp_path / "torch", tmp_path / "jax")
    src = str(tmp_path / "torch" / "webdataset" / "train_x")
    for mod, out in ((create_tarfiles, "torch"), (jax_tarfiles, "jax")):
        assert mod.main(["--input-dir", src, "--output-dir", str(tmp_path / f"{out}_tar"),
                         "--items-per-tar", "5"]) == 0
    for name in sorted(os.listdir(tmp_path / "torch_tar")):
        assert members(tmp_path / "torch_tar" / name) == members(tmp_path / "jax_tar" / name)
    out = capsys.readouterr().out
    assert "Total 8 images in train split." in out and "wrote 2 shards" in out


def test_fgvc_split_equals_jax(tmp_path):
    (tmp_path / "variants.txt").write_text("707-320\nA300B4\n")
    for split, rows in (("train", ["0001 707-320", "0002 A300B4"]), ("val", ["0003 A300B4"]),
                        ("test", ["0004 707-320"])):
        (tmp_path / f"images_variant_{split}.txt").write_text("\n".join(rows) + "\n")
    assert to_webdataset.load_fgvc_split(str(tmp_path)) == \
        jax_webdataset.load_fgvc_split(str(tmp_path))
    assert to_webdataset.image_id_of("a/b/img_1.jpg", "Faces", "class_prefixed") == "Faces_img_1"
    assert {k: dataclasses.astuple(v) for k, v in to_webdataset.DATASET_SPECS.items()} == \
        {k: dataclasses.astuple(v) for k, v in jax_webdataset.DATASET_SPECS.items()}


@pytest.fixture(scope="module")
def caption_fixture(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("capfix"))
    make_full_fixture(root, num_train=8, num_val=4, image_size=32)
    return root


def test_caption_files_equal_jax(caption_fixture, tmp_path):
    tars = [os.path.join(caption_fixture, "webdataset", "train_tars", "00000.tar")]
    pkl = os.path.join(caption_fixture, "clip_features_train.pkl")
    split_dir = os.path.join(caption_fixture, "webdataset", "train")
    assert captions.PER_IMAGE_PROMPTS == jax_captions.PER_IMAGE_PROMPTS
    assert captions.GROUP_PROMPTS == jax_captions.GROUP_PROMPTS
    for mod, out in ((captions, "torch"), (jax_captions, "jax")):
        assert mod.extract_per_image_captions(
            tars, pkl, str(tmp_path / out / "img"), mod.EchoCaptioner(),
            "Describe the {} texture concisely.") == 8
        assert mod.extract_group_captions(
            tars, pkl, str(tmp_path / out / "grp"), mod.EchoCaptioner(),
            "Describe the common visual attributes.", split_dir=split_dir, seed=3) == 8
    same_tree(tmp_path / "torch", tmp_path / "jax")
    # resumable: a second run writes nothing
    assert captions.extract_per_image_captions(tars, pkl, str(tmp_path / "torch" / "img"),
                                               captions.EchoCaptioner(), "x") == 0
    grid = captions.make_image_grid([Image.new("RGB", (50, 60))] * 4, cell=336)
    assert grid.size == (672, 672)
    assert grid.tobytes() == jax_captions.make_image_grid([Image.new("RGB", (50, 60))] * 4).tobytes()


def test_caption_main_shards_by_process(caption_fixture, tmp_path, capsys):
    """``main`` with the echo captioner, two processes over the shards
    (``tars[pid::world]``), the group job reading donors from the flat split."""
    data = tmp_path / "pre"
    os.makedirs(data / "webdataset")
    os.symlink(os.path.join(caption_fixture, "webdataset", "train_tars"), data / "train_tar")
    os.symlink(os.path.join(caption_fixture, "webdataset", "train"), data / "webdataset" / "train")
    pkl = os.path.join(caption_fixture, "clip_features_train.pkl")
    for mode in ("per_image", "per_group"):
        for pid in (0, 1):
            assert captions.main(["--mode", mode, "--dataset", "dtd", "--data-dir", str(data),
                                  "--output-dir", str(tmp_path / mode),
                                  "--clip-prediction-path", pkl, "--captioner", "echo",
                                  "-p", str(pid), "-w", "2"]) == 0
        assert len(os.listdir(tmp_path / mode)) == 8
    with open(pkl, "rb") as f:
        assert {n[:-4] for n in os.listdir(tmp_path / "per_image")} == set(pickle.load(f))
    assert "wrote 8 captions" in capsys.readouterr().out
