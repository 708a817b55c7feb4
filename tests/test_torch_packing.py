"""latteclip_torch.data.packing against latteclip_tpu.data.packing: the same
arrays, element for element, for the same token rows, and the row
bucketer's rules. Exact equality, since both are integer numpy code."""
import numpy as np
import pytest

from latteclip_tpu.data import packing as jax_packing
from latteclip_torch.data import packing

CTX = 77
PACK = 128


def _caption_rows(rng, n):
    """Padded [n, 77] rows with LLaVA-like lengths (lognormal, median ~30,
    clipped to 8..77), EOT (the highest id) last; a few all-zero rows, as
    the pipeline writes for a missing caption."""
    lengths = np.clip(np.round(rng.lognormal(np.log(30.0), 0.35, n)).astype(np.int64) + 2, 8, CTX)
    lengths[rng.random(n) < 0.05] = CTX
    rows = np.zeros((n, CTX), np.int32)
    for i, ln in enumerate(lengths):
        rows[i, :ln - 1] = rng.integers(1, 40000, ln - 1)
        rows[i, ln - 1] = 49407
    rows[rng.random(n) < 0.03] = 0
    return rows


def _assert_same(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed,n,pack_len", [(0, 64, 128), (1, 200, 128), (2, 37, 80)])
def test_pack_token_rows_matches_jax(seed, n, pack_len):
    tokens = _caption_rows(np.random.default_rng(seed), n)
    lengths = packing.token_lengths(tokens)
    np.testing.assert_array_equal(lengths, jax_packing.token_lengths(tokens))
    need = packing.pack_rows_needed(lengths, pack_len)
    assert need == jax_packing.pack_rows_needed(lengths, pack_len)
    _assert_same(packing.pack_token_rows(tokens, lengths, pack_len),
                 jax_packing.pack_token_rows(tokens, lengths, pack_len))
    _assert_same(packing.pack_token_rows(tokens, lengths, pack_len, rows=need + 3),
                 jax_packing.pack_token_rows(tokens, lengths, pack_len, rows=need + 3))
    with pytest.raises(ValueError, match="rows"):
        packing.pack_token_rows(tokens, lengths, pack_len, rows=need - 1)


def test_template_table_and_caption_batch_match_jax():
    from latteclip_torch.models.tokenizer import get_tokenizer

    tok = get_tokenizer()
    table = tok([f"a photo of a class {i}." for i in range(47)])
    _assert_same(packing.pack_template_table(table, PACK),
                 jax_packing.pack_template_table(table, PACK))
    rng = np.random.default_rng(3)
    per_image, per_group = _caption_rows(rng, 16), _caption_rows(rng, 16)
    lengths = packing.token_lengths(np.concatenate([per_image, per_group]))
    rows = packing.pack_rows_needed(lengths, PACK) + 2
    ours = packing.pack_caption_batch(per_image, per_group, PACK, rows)
    ref = jax_packing.pack_caption_batch(per_image, per_group, PACK, rows)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])


def test_packed_rows_reconstruct_every_sequence():
    tokens = _caption_rows(np.random.default_rng(4), 50)
    lengths = packing.token_lengths(tokens)
    pk = packing.pack_token_rows(tokens, lengths, PACK)
    for n, ln in enumerate(lengths):
        r, c = pk.eot_row[n], pk.eot_col[n]
        np.testing.assert_array_equal(pk.tokens[r, c - ln + 1:c + 1], tokens[n, :ln])
        np.testing.assert_array_equal(pk.positions[r, c - ln + 1:c + 1], np.arange(ln))
        assert len(set(pk.seg_ids[r, c - ln + 1:c + 1].tolist())) == 1
    assert (pk.seg_ids > 0).sum() == lengths.sum()


def test_lengths_out_of_range_raise():
    tokens = np.ones((2, CTX), np.int32)
    with pytest.raises(ValueError, match="lengths"):
        packing.pack_token_rows(tokens, np.array([0, 5]), PACK)
    with pytest.raises(ValueError, match="lengths"):
        packing.pack_token_rows(tokens, np.array([5, 78]), PACK)


def test_bucketer_rules_match_jax():
    ours, ref = packing.PackRowBucketer(multiple=8), jax_packing.PackRowBucketer(multiple=8)
    for need in (10, 5, 100, 40, 130, 7):
        assert ours.rows_for(need) == ref.rows_for(need)
    b = packing.PackRowBucketer(multiple=8)
    r1 = b.rows_for(10)
    assert r1 % 8 == 0 and r1 >= 12      # need + slack, rounded up
    assert b.rows_for(5) == r1           # never shrinks
    assert b.rows_for(100) >= 104        # grows when needed
    fixed = packing.PackRowBucketer(multiple=8, fixed=32)
    assert fixed.rows_for(30) == 32
    with pytest.raises(ValueError):
        fixed.rows_for(33)
