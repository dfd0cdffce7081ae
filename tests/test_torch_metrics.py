"""The port's retrieval metrics and evaluation harness against the JAX
package's on the same arrays (CPU): ranks, R@K and tie counts exactly, the
similarity matrix within fp32 summation noise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neighborretr_tpu.core import config as jc
from neighborretr_tpu.data.datasets.synthetic import SyntheticDataset
from neighborretr_tpu.data.loader import BatchLoader as JLoader
from neighborretr_tpu.models import neighborretr as jm
from neighborretr_tpu.train import evaluate as jeval
from neighborretr_tpu.train import metrics as jmet
from neighborretr_tpu_torch.core import config as tc
from neighborretr_tpu_torch.data.datasets.synthetic import \
    SyntheticDataset as TSyntheticDataset
from neighborretr_tpu_torch.data.loader import BatchLoader as TLoader
from neighborretr_tpu_torch.models import weights_io as W
from neighborretr_tpu_torch.train import evaluate as teval
from neighborretr_tpu_torch.train import metrics as tmet

KEYS = ("R1", "R5", "R10", "R50", "MR", "MedianR", "MeanR")


def tied_matrix(seed, n):
    """Scores on a coarse grid, so rows and columns tie at the diagonal."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 12, (n, n)) / 4.0).astype(np.float32)


@pytest.mark.parametrize("seed,n,tied", [(0, 40, False), (1, 64, True),
                                         (2, 7, True)])
def test_ranks_ties_and_metrics_equal_jax(seed, n, tied):
    sim = tied_matrix(seed, n) if tied else \
        np.random.default_rng(seed).normal(size=(n, n)).astype(np.float32)
    t2v, v2t = tmet.device_ranks_both(torch.tensor(sim))
    j_t2v, j_v2t = jmet.device_ranks_both(jnp.asarray(sim))
    np.testing.assert_array_equal(t2v.numpy(), np.asarray(j_t2v))
    np.testing.assert_array_equal(v2t.numpy(), np.asarray(j_v2t))
    np.testing.assert_array_equal(tmet.device_ranks(torch.tensor(sim)).numpy(),
                                  np.asarray(jmet.device_ranks(jnp.asarray(sim))))
    ties = tmet.device_ties_both(torch.tensor(sim))
    j_ties = jmet.device_ties_both(jnp.asarray(sim))
    assert [int(x) for x in ties] == [int(x) for x in j_ties]
    assert (int(ties[0]) > 0) == tied
    got = tmet.metrics_from_ranks(t2v.numpy())
    want = jmet.metrics_from_ranks(np.asarray(j_t2v))
    assert got == want and tuple(got) == KEYS
    # the host form is the strict ranks': one entry per query; where nothing
    # ties it equals the JAX package's host compute_metrics
    host = tmet.compute_metrics(sim)
    assert host == got
    if not tied:
        ref = jmet.compute_metrics(sim)
        assert {k: ref[k] for k in KEYS} == host
    assert tmet.format_metrics(got, "t2v ") == jmet.format_metrics(want, "t2v ")


def test_multi_sentence_ranks_and_ties_equal_jax():
    rng = np.random.default_rng(4)
    cuts = [3, 4, 8, 9, 12]                  # 5 videos, 12 captions
    sim = (rng.integers(0, 9, (12, 5)) / 2.0).astype(np.float32)
    t3 = teval.reshape_multi_sentence_device(torch.tensor(sim), cuts)
    j3 = jeval.reshape_multi_sentence_device(jnp.asarray(sim), cuts)
    np.testing.assert_array_equal(t3.numpy(), np.asarray(j3))
    ranks, valid = tmet.device_multi_sentence_ranks(t3)
    j_ranks, j_valid = jmet.device_multi_sentence_ranks(j3)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(j_valid))
    np.testing.assert_array_equal(ranks[valid].numpy(),
                                  np.asarray(j_ranks)[np.asarray(j_valid)])
    np.testing.assert_array_equal(
        tmet.device_video_to_text_ranks(t3).numpy(),
        np.asarray(jmet.device_video_to_text_ranks(j3)))
    assert int(tmet.device_multi_sentence_ties(t3)) == \
        int(jmet.device_multi_sentence_ties(j3))
    assert int(tmet.device_video_to_text_ties(t3)) == \
        int(jmet.device_video_to_text_ties(j3))


def test_best_metrics_tracker_round_trip():
    t, j = tmet.BestMetricsTracker(), jmet.BestMetricsTracker()
    seq = [({"R1": 10.0}, {"R1": 20.0}), ({"R1": 12.0}, {"R1": 14.0}),
           ({"R1": 30.0}, {"R1": 5.0})]
    assert [t.update(a, b) for a, b in seq] == [j.update(a, b) for a, b in seq]
    assert t.to_dict() == j.to_dict()
    fresh = tmet.BestMetricsTracker()
    fresh.load_dict(t.to_dict())
    assert fresh.to_dict() == t.to_dict()


@pytest.fixture(scope="module")
def eval_setup():
    import jax
    words, frames = 8, 4
    jcfg = jc.Config(model=jc.ModelConfig.tiny(max_words=words,
                                               max_frames=frames))
    tcfg = tc.Config(model=tc.ModelConfig.tiny(max_words=words,
                                               max_frames=frames))
    params = jm.init_params(jax.random.PRNGKey(2), jcfg.model)
    model = W.from_jax_params(jax.device_get(params), tcfg.model)
    kw = dict(n=21, seed=5, max_words=words, max_frames=frames,
              resolution=jcfg.model.clip.image_resolution,
              vocab_size=jcfg.model.clip.vocab_size)
    loaders = (JLoader(SyntheticDataset(**kw), 8, shuffle=False,
                       drop_last=False, workers=0, pad_to_batch=True),
               TLoader(TSyntheticDataset(**kw), 8, shuffle=False,
                       drop_last=False, workers=0, pad_to_batch=True))
    return jcfg, tcfg, params, model, loaders


def test_evaluate_matches_jax(eval_setup):
    """21 pairs in batches of 8 (a padded trailing batch): the feature
    cache, the similarity matrix (1e-5) and R@K (equal)."""
    jcfg, tcfg, params, model, (jloader, tloader) = eval_setup
    j_feats = jeval.extract_features(params, jcfg, jloader)
    t_feats = teval.extract_features(model, tcfg, tloader)
    for a, b in zip(t_feats, j_feats):
        a = a.numpy() if torch.is_tensor(a) else a
        assert a.shape[0] == 21
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5)
    want = np.asarray(jeval.similarity_matrix_device(params, jcfg, *j_feats))
    got = teval.similarity_matrix_device(model, *t_feats)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # the row-blocked plain route (forced by a small cap) changes nothing
    blocked = teval.similarity_matrix_device(model, *t_feats, block=8,
                                             max_logits_bytes=1024)
    np.testing.assert_allclose(blocked.numpy(), got.numpy(), atol=1e-6)
    j_t2v, j_v2t = jeval.evaluate(params, jcfg, jloader)
    t_t2v, t_v2t = teval.evaluate(model, tcfg, tloader)
    assert t_t2v == j_t2v and t_v2t == j_v2t


def test_evaluate_multi_sentence_keeps_one_video_per_group(eval_setup):
    """The MSVD protocol: caption groups share a video; only the rows at
    cut_off_points - 1 go through the vision tower."""
    jcfg, tcfg, params, model, (jloader, tloader) = eval_setup
    cuts = [2, 5, 9, 10, 16, 21]

    class Multi:
        multi_sentence_per_video = True
        cut_off_points = cuts

    keep = np.asarray(cuts) - 1
    t_feat, t_mask, v_feat, v_mask = teval.extract_features(
        model, tcfg, tloader, video_keep=keep)
    full = teval.extract_features(model, tcfg, tloader)
    assert v_feat.shape[0] == len(cuts) and t_feat.shape[0] == 21
    np.testing.assert_allclose(v_feat.numpy(), full[2][keep].numpy(),
                               atol=1e-6)
    np.testing.assert_array_equal(v_mask, full[3][keep])
    j_t2v, j_v2t = jeval.evaluate(params, jcfg, jloader, dataset=Multi())
    t_t2v, t_v2t = teval.evaluate(model, tcfg, tloader, dataset=Multi())
    assert t_t2v == j_t2v and t_v2t == j_v2t
