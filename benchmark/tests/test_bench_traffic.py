"""The seeded traffic: the same seed gives the same inputs, and every seed
the same sizes."""
import numpy as np
import torch

from benchmark import run, traffic

MIX = run.load_json(run.HERE, "traffic", "train_packed.json")


def pool(seed, **over):
    return traffic.train_pool(dict(MIX, batch=16, **over), seed, 32, 77, "cpu", pinned=False)


def test_same_seed_same_pool_and_tokens():
    a, b = pool(2 ** 31 + 77), pool(2 ** 31 + 77)
    for x, y in zip(a, b):
        assert x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)
    tok = traffic.SeededTokenizer(2 ** 33 + 5, 77, 6, 12)
    assert np.array_equal(tok(["a photo of a cat."]), tok("a photo of a cat."))
    assert not np.array_equal(tok("a"), traffic.SeededTokenizer(2 ** 33 + 6, 77, 6, 12)("a"))


def test_every_seed_the_same_caption_sizes_in_its_own_order():
    a, b = pool(1), pool(2 ** 32 + 9)
    la = np.argmax(a[0]["per_image_tokens"], axis=1)
    lb = np.argmax(b[0]["per_image_tokens"], axis=1)
    assert sorted(la) == sorted(lb) and not np.array_equal(la, lb)
    assert not np.array_equal(a[0]["images"], b[0]["images"])
    lengths = traffic.lognormal_lengths(2048, 30, 0.35, 8, 77, np.random.default_rng(0))
    assert 8 <= lengths.min() and lengths.max() <= 77 and 30 <= np.median(lengths) <= 34


def test_rows_end_in_eot_at_their_length():
    rows = traffic.token_rows(np.array([2, 5, 77]), 77, np.random.default_rng(0))
    assert list(np.argmax(rows, axis=1) + 1) == [2, 5, 77]
    assert (rows[:, 0] == traffic.SOT).all()


def test_images_follow_their_labels_grid():
    cells = traffic.exemplar_cells(3, 4, 8, "cpu")
    gen = torch.Generator().manual_seed(0)
    img = traffic.grid_images(torch.tensor([2, 2]), cells, 32, 0, gen)
    assert torch.equal(img[0], img[1]) and img.shape == (2, 32, 32, 3)
    assert torch.equal(img[0, 0, 0], cells[2, 0, 0])
