"""Each traffic generator gives the same inputs for the same seed, other
inputs for another, in the shapes and ranges its traffic file states."""

import pytest
import torch

from benchmark.harness import core
from benchmark.tests.tiny import tiny_files

BIG = 2 ** 31 + 977


def _pool(seed):
    f = tiny_files("vitb32.msrvtt_train")
    return f["traffic"], core.generator(f).make_pool(
        f["traffic"], f["config"]["clip"]["image_resolution"], seed, "cpu")


def test_train_pool_repeats_per_seed():
    t, a = _pool(BIG)
    _, b = _pool(BIG)
    _, c = _pool(BIG + 1)
    assert len(a) == t["pool"]
    for x, y, z in zip(a, b, c):
        for k in x:
            assert torch.equal(x[k], y[k])
        assert not torch.equal(x["video"], z["video"])


def test_train_batch_layout():
    t, pool = _pool(5)
    lo, hi = t["caption_tokens"]
    ids = torch.cat([b["idx"] for b in pool])
    assert len(set(ids.tolist())) == ids.numel()
    for b in pool:
        n = b["text_mask"].sum(1)
        assert ((n >= lo + 2) & (n <= hi + 2)).all()
        assert (b["text_ids"][:, 0] == 49406).all()
        last = (n - 1).long()
        assert (b["text_ids"].gather(1, last[:, None]) == 49407).all()
        assert (b["text_ids"] * (1 - b["text_mask"]).int() == 0).all()
        f = b["video_mask"].sum(1)
        assert ((f >= t["frames"][0]) & (f <= t["frames"][1])).all()
        assert b["video"].dtype == torch.uint8
        pad = b["video"][b["video_mask"] == 0]
        assert pad.numel() == 0 or int(pad.max()) == 0


@pytest.mark.parametrize("seed", [3, BIG])
def test_search_inputs_repeat_per_seed(seed):
    f = tiny_files("vitb32.search")
    t, gen = f["traffic"], core.generator(f)
    a = gen.make_index(t, 64, seed, "cpu")
    b = gen.make_index(t, 64, seed, "cpu")
    c = gen.make_index(t, 64, seed + 1, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert a[0].shape == (t["videos"], t["max_frames"], 64)
    assert a[0].dtype == torch.float16
    q = gen.make_queries(t, seed)
    assert q == gen.make_queries(t, seed) != gen.make_queries(t, seed + 1)
    lo, hi = t["words"]
    assert all(lo <= len(x.split()) <= hi for x in q)


def test_reference_tokenizer_matches_clip_bpe():
    """The reference's frozen BPE gives the program's tokenizer's ids on
    the traffic's vocabulary."""
    from neighborretr_tpu_torch.data.text import encode_caption
    from neighborretr_tpu_torch.data.tokenizer import ClipTokenizer
    from benchmark.reference.tokenizer import Tokenizer
    f = core.cell_files(core.manifest(), "vitb32.search")
    t = f["traffic"]
    ours, theirs = Tokenizer(), ClipTokenizer()
    for q in core.generator(f).make_queries(t, 11)[:200]:
        a_ids, a_mask = ours.caption(q, t["max_words"])
        b_ids, b_mask = encode_caption(theirs, q, t["max_words"])
        assert a_ids.tolist() == b_ids.tolist()
        assert a_mask.tolist() == b_mask.tolist()
