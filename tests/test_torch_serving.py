"""The port's serving path against the JAX package (tiny config, fp32):
index build, search, index files crossing between the packages, and the
port's index/search CLIs."""

import os
import subprocess
import sys
import zlib

import jax
import numpy as np
import pytest

from neighborretr_tpu import serving as jserving
from neighborretr_tpu.core.config import Config, ModelConfig
from neighborretr_tpu.data.datasets.synthetic import SyntheticDataset
from neighborretr_tpu.data.loader import BatchLoader
from neighborretr_tpu.models import neighborretr as jm
from neighborretr_tpu_torch import serving as pserving
from neighborretr_tpu_torch.core import config as pconfig
from neighborretr_tpu_torch.models import weights_io as W

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Wd, F, N = 8, 4, 20
# each package gets a configuration built from its own dataclasses
PCFG = pconfig.Config(model=pconfig.ModelConfig.tiny(max_words=Wd,
                                                     max_frames=F))
QUERIES = ["a dog runs on the beach", "cooking pasta", "a car", "x y z",
           "people dance at night"]


class StubTokenizer:
    """Whitespace tokens onto the tiny 512-entry vocab (real BPE ids would
    overflow it); the caption pipeline around it is the real one."""

    def tokenize(self, text):
        return text.split()

    def convert_tokens_to_ids(self, tokens):
        special = {"<|startoftext|>": 1, "<|endoftext|>": 2}
        return [special.get(t, 3 + zlib.crc32(t.encode()) % 500)
                for t in tokens]


@pytest.fixture(scope="module")
def setup():
    cfg = Config(model=ModelConfig.tiny(max_words=Wd, max_frames=F))
    ds = SyntheticDataset(n=N, seed=3, max_words=Wd, max_frames=F,
                          resolution=cfg.model.clip.image_resolution,
                          vocab_size=cfg.model.clip.vocab_size)
    params = jax.device_get(jm.init_params(jax.random.PRNGKey(0), cfg.model))
    model = W.from_jax_params(params, PCFG.model)

    def loader():
        return BatchLoader(ds, 8, shuffle=False, drop_last=False, workers=0,
                           pad_to_batch=True)

    j_index = jserving.build_video_index(params, cfg, loader(), dataset=ds)
    p_index = pserving.build_video_index(model, PCFG, loader(), dataset=ds)
    return cfg, ds, params, model, loader, j_index, p_index


def assert_within_fp16_ulp(a, b):
    """|a - b| <= one fp16 ulp of max(|a|, |b|), the ulp taken no finer
    than at 2^-6: below that the fp32 features' own ~1e-6 disagreement
    (the 1e-4 parity bound above) spans several fp16 steps."""
    a32, b32 = a.astype(np.float32), b.astype(np.float32)
    mag = np.maximum(np.maximum(np.abs(a32), np.abs(b32)), 2.0 ** -6)
    ulp = np.spacing(mag.astype(np.float16)).astype(np.float32)
    assert (np.abs(a32 - b32) <= ulp).all()


def test_index_matches_jax(setup):
    *_, j_index, p_index = setup
    assert p_index["v_feat"].dtype == np.float16
    assert p_index["v_feat"].shape == j_index["v_feat"].shape
    assert_within_fp16_ulp(p_index["v_feat"], j_index["v_feat"])
    np.testing.assert_array_equal(p_index["v_mask"], j_index["v_mask"])
    assert list(p_index["video_ids"]) == list(j_index["video_ids"])
    # same config + same weights → byte-equal meta (fingerprint included)
    assert p_index["meta"].tobytes() == j_index["meta"].tobytes()


def test_int8_index_matches_jax(setup):
    cfg, ds, params, model, loader, *_ = setup
    j8 = jserving.build_video_index(params, cfg, loader(), dataset=ds,
                                    feature_dtype="int8")
    p8 = pserving.build_video_index(model, PCFG, loader(), dataset=ds,
                                    feature_dtype="int8")
    assert p8["v_feat"].dtype == np.int8
    assert np.abs(p8["v_feat"].astype(int) - j8["v_feat"]).max() <= 1
    assert_within_fp16_ulp(p8["v_scale"], j8["v_scale"])


def assert_same_hits(got, want, gap=1e-4):
    for g_row, w_row in zip(got, want):
        g_ids, g_s = zip(*g_row)
        w_ids, w_s = zip(*w_row)
        np.testing.assert_allclose(g_s, w_s, atol=1e-4, rtol=0)
        for r, (gi, wi) in enumerate(zip(g_ids, w_ids)):
            # a rank may swap only between near-ties
            near = [abs(w_s[r] - s) <= gap for s in w_s]
            assert gi == wi or near.count(True) > 1, (r, gi, wi)


def test_search_matches_jax(setup):
    cfg, _, params, model, _, j_index, p_index = setup
    tok = StubTokenizer()
    want = jserving.Searcher(params, cfg, j_index, tok).search(QUERIES, 5)
    got = pserving.Searcher(model, PCFG, p_index, tok).search(QUERIES, 5)
    assert [len(r) for r in got] == [5] * len(QUERIES)
    assert_same_hits(got, want)
    # similarity rows agree as well
    np.testing.assert_allclose(
        pserving.Searcher(model, PCFG, p_index, tok).similarities(QUERIES),
        jserving.Searcher(params, cfg, j_index, tok).similarities(QUERIES),
        atol=1e-4, rtol=0)


def test_indexes_cross_between_packages(setup, tmp_path):
    cfg, _, params, model, _, j_index, p_index = setup
    tok = StubTokenizer()
    j_path = jserving.save_index(str(tmp_path / "jax_built"), j_index)
    p_path = pserving.save_index(str(tmp_path / "port_built"), p_index)
    # a JAX-built index loads and searches in the port ...
    port_on_jax = pserving.search(model, PCFG, pserving.load_index(j_path),
                                  tok, QUERIES, topk=4)
    # ... and a port-built index in the JAX package
    jax_on_port = jserving.search(params, cfg, jserving.load_index(p_path),
                                  tok, QUERIES, topk=4)
    assert_same_hits(port_on_jax, jax_on_port)
    assert_same_hits(port_on_jax, jserving.search(params, cfg, j_index, tok,
                                                  QUERIES, topk=4))


def test_search_pads_queries_and_buckets_topk(setup):
    cfg, _, _, model, _, _, p_index = setup
    s = pserving.Searcher(model, PCFG, p_index, StubTokenizer(), query_batch=4)
    one = s.search(QUERIES[:1], topk=3)
    five = s.search(QUERIES, topk=3)         # 5 → padded to 8 rows
    assert one[0] == five[0]
    assert len(s.search(QUERIES[:2], topk=50)[0]) == N   # k capped at N
    assert s.search([], topk=3) == []
    assert s.similarities([]).shape == (0, N)


def _raw_similarity(model, index, tok, queries, query_batch):
    """similarity_matrix_device on the index's raw rows, widened as the
    Searcher widens them, for the queries padded as it pads them."""
    import torch
    from neighborretr_tpu_torch.train import evaluate as pev
    padded = list(queries) + [""] * ((-len(queries)) % query_batch)
    t_feat, t_mask = pserving.encode_queries(model, PCFG, tok, padded)
    v = torch.as_tensor(index["v_feat"]).float()
    if "v_scale" in index:
        v = v * torch.as_tensor(index["v_scale"]).float()[..., None]
    return pev.similarity_matrix_device(model, t_feat, t_mask, v,
                                        index["v_mask"])[:len(queries)]


@pytest.mark.parametrize("query_batch", [5, 4])
@pytest.mark.parametrize("feature_dtype", ["float16", "int8"])
def test_prepared_corpus_matches_the_raw_index(setup, monkeypatch,
                                               feature_dtype, query_batch):
    """The Searcher's corpus, prepared once (in slabs of 7 videos, the last
    one short), scores as similarity_matrix_device on the raw index does
    (within 1e-6) and returns its top-k ids, fp16 and int8, a query batch
    that pads (4: 5 queries → 8 rows) and one that does not."""
    import torch
    from neighborretr_tpu_torch.models import neighborretr as pm
    *_, model, _, _, p_index = setup
    monkeypatch.setattr(pm, "CORPUS_SLAB_ROWS", 7)
    index = dict(p_index)
    if feature_dtype == "int8":
        index["v_feat"], index["v_scale"] = pserving.quantize_features(
            p_index["v_feat"].astype(np.float32))
    tok = StubTokenizer()
    s = pserving.Searcher(model, PCFG, index, tok, query_batch=query_batch)
    want = _raw_similarity(model, index, tok, QUERIES, query_batch)
    got = s.similarities(QUERIES)
    np.testing.assert_allclose(got, want.numpy(), atol=1e-6, rtol=0)
    top = torch.topk(want, 5, dim=1)
    for row, ids, vals in zip(s.search(QUERIES, topk=5), top.indices,
                              top.values):
        assert [v for v, _ in row] == [s.video_ids[int(j)] for j in ids]
        np.testing.assert_allclose([sc for _, sc in row], vals.numpy(),
                                   atol=1e-6, rtol=0)


def test_corpus_is_prepared_once(setup):
    """One preparation at construction; searches and similarities() reuse
    it, and the Searcher holds the prepared corpus, not the raw rows."""
    *_, model, _, _, p_index = setup
    s = pserving.Searcher(model, PCFG, p_index, StubTokenizer(),
                          query_batch=4)
    assert s.corpus_preparations == 1
    for n in (1, 3, 5):
        s.search(QUERIES[:n], topk=3)
    s.similarities(QUERIES)
    assert s.corpus_preparations == 1 and s.calls == 4
    _, corpus, _ = s._shards[0]
    norms = np.linalg.norm(corpus.feat.numpy(), axis=-1)
    np.testing.assert_allclose(norms, p_index["v_mask"], atol=1e-6)
    np.testing.assert_allclose(corpus.weight.sum(-1).numpy(), 1, atol=1e-6)


def test_check_meta_rejects_other_weights(setup):
    cfg, _, _, _, _, _, p_index = setup
    other = W.init_model(PCFG.model, seed=5)
    with pytest.raises(ValueError, match="DIFFERENT CHECKPOINT"):
        pserving.Searcher(other, PCFG, p_index, StubTokenizer())
    wider = pconfig.Config(model=pconfig.ModelConfig.tiny(
        max_words=Wd, max_frames=F + 1))
    with pytest.raises(ValueError, match="different model config"):
        pserving.check_meta(p_index, wider)


def test_index_and_search_clis(tmp_path):
    """cli.index on synthetic tiny data, then cli.search on its output, as
    subprocesses on the CPU."""
    out = str(tmp_path / "idx.npz")
    env = dict(os.environ, PYTHONPATH=ROOT)
    common = ["--tiny", "--device", "cpu", "--max_words", "8"]
    r = subprocess.run(
        [sys.executable, "-m", "neighborretr_tpu_torch.cli.index",
         "--datatype", "synthetic", "--out", out, "--batch_size", "8",
         "--synthetic_size", "12", "--max_frames", "4", "--workers", "0",
         *common], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stderr
    assert "seeded random weights" in r.stderr
    index = pserving.load_index(out)
    assert index["v_feat"].shape == (12, 4, 64)
    r = subprocess.run(
        [sys.executable, "-m", "neighborretr_tpu_torch.cli.search",
         "--index", out, "--query", "a man is cooking", "--query", "a dog",
         "--topk", "3", *common], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert lines[0] == "query: a man is cooking" and lines[4] == "query: a dog"
    assert sum(line.startswith("  ") for line in lines) == 6
