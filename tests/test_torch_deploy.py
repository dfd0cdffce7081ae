"""The port's deployment bundle and reference-checkpoint export against the
JAX package (tiny config, fp32, on the CPU).

Tolerances: the bundle's program is the port's plain query path traced by
torch.export, so its top-k must be the plain `Searcher`'s ids with scores
within 1e-5 (the JAX test's bound for its bundle against its Searcher);
against the JAX bundle, scores within 1e-4 with ranks swapping only between
near-ties, as tests/test_torch_serving.py holds search.  The reference
checkpoint must equal the JAX exporter's key for key and bit for bit."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from neighborretr_tpu import deploy as jdeploy
from neighborretr_tpu import serving as jserving
from neighborretr_tpu.core.checkpoint import flatten_tree
from neighborretr_tpu.core.config import Config, ModelConfig
from neighborretr_tpu.data.datasets.synthetic import SyntheticDataset
from neighborretr_tpu.data.loader import BatchLoader
from neighborretr_tpu.data.text import encode_caption
from neighborretr_tpu.models import neighborretr as jm
from neighborretr_tpu.models.weights_io import \
    save_reference_checkpoint as j_save_reference
from neighborretr_tpu_torch import deploy as pdeploy
from neighborretr_tpu_torch import serving as pserving
from neighborretr_tpu_torch.core import config as pconfig
from neighborretr_tpu_torch.models import weights_io as W

from test_torch_serving import StubTokenizer, assert_same_hits

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Wd, F, N = 8, 4, 24
QB, K = 4, 3
PCFG = pconfig.Config(model=pconfig.ModelConfig.tiny(max_words=Wd,
                                                     max_frames=F))
QUERIES = ["a dog runs", "cooking pasta", "street at night"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    cfg = Config(model=ModelConfig.tiny(max_words=Wd, max_frames=F))
    ds = SyntheticDataset(n=N, seed=3, max_words=Wd, max_frames=F,
                          resolution=cfg.model.clip.image_resolution,
                          vocab_size=cfg.model.clip.vocab_size)
    params = jax.device_get(jm.init_params(jax.random.PRNGKey(0), cfg.model))
    model = W.from_jax_params(params, PCFG.model)
    index = pserving.build_video_index(
        model, PCFG, BatchLoader(ds, 8, shuffle=False, drop_last=False,
                                 workers=0, pad_to_batch=True), dataset=ds)
    bundle_dir = str(tmp_path_factory.mktemp("bundle"))
    pdeploy.save_bundle(bundle_dir, model, PCFG, index, query_batch=QB,
                        topk=K)
    jax_dir = str(tmp_path_factory.mktemp("jax_bundle"))
    jdeploy.save_bundle(jax_dir, params, cfg, index, query_batch=QB, topk=K,
                        platforms=("cpu",))
    return cfg, params, model, index, bundle_dir, jax_dir


def _tokenize(queries):
    enc = [encode_caption(StubTokenizer(), q, Wd) for q in queries]
    return (np.stack([e[0] for e in enc]).astype(np.int32),
            np.stack([e[1] for e in enc]).astype(np.float32))


def _assert_plain_searcher(bundle, vals, idx, model, index, queries):
    hits = pserving.Searcher(model, PCFG, index, StubTokenizer(),
                             query_batch=QB, kernels=False).search(queries, K)
    for q in range(len(queries)):
        assert [bundle.video_ids[j] for j in idx[q]] == \
            [vid for vid, _ in hits[q]], q
        np.testing.assert_allclose(vals[q], [s for _, s in hits[q]],
                                   rtol=0, atol=1e-5)


def test_bundle_layout_is_the_jax_one(setup):
    """Same files but the program's, meta with the JAX bundle's keys,
    params.npz in the JAX npz key layout with the JAX bundle's arrays."""
    *_, bundle_dir, jax_dir = setup
    for name in ("query_program.pt2", "params.npz", "index.npz",
                 "meta.json", "bpe_simple_vocab_16e6.txt.gz"):
        assert os.path.exists(os.path.join(bundle_dir, name)), name
    meta = json.load(open(os.path.join(bundle_dir, "meta.json")))
    jmeta = json.load(open(os.path.join(jax_dir, "meta.json")))
    assert set(meta) == set(jmeta)
    assert meta["platforms"] == ["cpu"]
    for key in ("query_batch", "topk", "n_videos", "max_words",
                "param_dtypes", "params_fingerprint"):
        assert meta[key] == jmeta[key], key
    with np.load(os.path.join(bundle_dir, "params.npz")) as got, \
            np.load(os.path.join(jax_dir, "params.npz")) as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_bundle_matches_plain_searcher_and_jax_bundle(setup):
    cfg, params, model, index, bundle_dir, jax_dir = setup
    bundle = pdeploy.load_bundle(bundle_dir)
    assert len(bundle) == N and bundle.device.type == "cpu"
    ids, mask = _tokenize(QUERIES)
    vals, idx = bundle.search_tokens(ids, mask)
    assert vals.shape == idx.shape == (len(QUERIES), K)
    _assert_plain_searcher(bundle, vals, idx, model, index, QUERIES)
    jb = jdeploy.load_bundle(jax_dir)
    jvals, jidx = jb.search_tokens(ids, mask)
    assert_same_hits(
        [[(bundle.video_ids[j], float(s)) for j, s in zip(ir, vr)]
         for ir, vr in zip(idx, vals)],
        [[(jb.video_ids[j], float(s)) for j, s in zip(ir, vr)]
         for ir, vr in zip(jidx, jvals)])


def test_bundle_runs_with_both_packages_blocked(setup):
    """A subprocess that can import neither package loads the bundle with
    torch.export.load, torch and numpy, and gives the in-process result."""
    *_, bundle_dir, _ = setup
    ids, mask = _tokenize(QUERIES)
    want_vals, want_idx = pdeploy.load_bundle(bundle_dir).search_tokens(
        ids, mask)
    np.save(os.path.join(bundle_dir, "q_ids.npy"), ids)
    np.save(os.path.join(bundle_dir, "q_mask.npy"), mask)
    script = r"""
import json, os, sys

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("neighborretr_tpu", "neighborretr_tpu_torch",
                                  "jax"):
            raise ImportError(f"{name} imported by the bundle loader")
        return None
sys.meta_path.insert(0, _Block())

import numpy as np
import torch

d = sys.argv[1]
meta = json.load(open(os.path.join(d, "meta.json")))
dev = torch.device(meta["platforms"][0])
program = torch.export.load(os.path.join(d, "query_program.pt2")).module()
with np.load(os.path.join(d, "params.npz"), allow_pickle=False) as z:
    leaves = [torch.as_tensor(z[k].astype(meta["param_dtypes"][k]),
                              device=dev) for k in sorted(z.files)]
with np.load(os.path.join(d, "index.npz"), allow_pickle=False) as z:
    index = {k: z[k] for k in z.files}
v_feat = index["v_feat"].astype(np.float32)
if "v_scale" in index:
    v_feat = v_feat * index["v_scale"].astype(np.float32)[..., None]
ids = np.load(os.path.join(d, "q_ids.npy"))
mask = np.load(os.path.join(d, "q_mask.npy"))
pad = meta["query_batch"] - ids.shape[0]
ids = np.pad(ids, ((0, pad), (0, 0)))
mask = np.pad(mask, ((0, pad), (0, 0)))
with torch.no_grad():
    vals, idx = program(leaves, torch.as_tensor(ids, device=dev),
                        torch.as_tensor(mask, device=dev),
                        torch.as_tensor(v_feat, device=dev),
                        torch.as_tensor(index["v_mask"].astype(np.float32),
                                        device=dev))
np.save(os.path.join(d, "out_vals.npy"), vals.cpu().numpy())
np.save(os.path.join(d, "out_idx.npy"), idx.cpu().numpy())
print("BARE_TORCH_OK")
"""
    proc = subprocess.run([sys.executable, "-c", script, bundle_dir],
                          cwd=bundle_dir, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert "BARE_TORCH_OK" in proc.stdout
    q = len(QUERIES)
    np.testing.assert_array_equal(
        np.load(os.path.join(bundle_dir, "out_idx.npy"))[:q], want_idx)
    np.testing.assert_allclose(
        np.load(os.path.join(bundle_dir, "out_vals.npy"))[:q], want_vals,
        rtol=0, atol=1e-6)


def test_int8_bundle(setup, tmp_path):
    """An int8 index dequantizes at load and ranks as the plain Searcher
    over it."""
    _, _, model, index, _, _ = setup
    q8 = dict(index)
    q8["v_feat"], q8["v_scale"] = pserving.quantize_features(
        index["v_feat"].astype(np.float32))
    pdeploy.save_bundle(str(tmp_path), model, PCFG, q8, query_batch=QB,
                        topk=K)
    bundle = pdeploy.load_bundle(str(tmp_path))
    ids, mask = _tokenize(QUERIES[:2])
    vals, idx = bundle.search_tokens(ids, mask)
    _assert_plain_searcher(bundle, vals, idx, model, q8, QUERIES[:2])


def test_export_refuses_topk_and_overflow(setup):
    _, _, model, _, bundle_dir, _ = setup
    for topk in (0, N + 1):
        with pytest.raises(ValueError, match="topk"):
            pdeploy.export_query_program(model, PCFG, n_videos=N,
                                         query_batch=QB, topk=topk)
    with pytest.raises(ValueError, match="query_batch"):
        pdeploy.export_query_program(model, PCFG, n_videos=N, query_batch=0,
                                     topk=K)
    bundle = pdeploy.load_bundle(bundle_dir)
    with pytest.raises(ValueError, match="query_batch"):
        bundle.search_tokens(np.zeros((QB + 1, Wd), np.int32),
                             np.ones((QB + 1, Wd), np.float32))


def test_reference_checkpoint_matches_jax_exporter(setup, tmp_path):
    cfg, params, model, *_ = setup
    W.save_reference_checkpoint(model, str(tmp_path / "port.bin"))
    j_save_reference(params, cfg.model, str(tmp_path / "jax.bin"))
    got = torch.load(str(tmp_path / "port.bin"))
    want = torch.load(str(tmp_path / "jax.bin"))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k


def test_export_clis(setup, tmp_path):
    """cli.export_checkpoint and cli.export as subprocesses on the CPU."""
    cfg, params, *_ = setup
    ckpt = str(tmp_path / "best.npz")
    np.savez(ckpt, **flatten_tree(params))
    env = dict(os.environ, PYTHONPATH=ROOT)

    def cli(module, *args):
        return subprocess.run(
            [sys.executable, "-m", f"neighborretr_tpu_torch.cli.{module}",
             *args, "--tiny", "--device", "cpu", "--max_words", str(Wd),
             "--checkpoint", ckpt], cwd=ROOT, env=env, capture_output=True,
            text=True, timeout=300)

    out = str(tmp_path / "ref.bin")
    r = cli("export_checkpoint", "--out", out, "--max_frames", str(F))
    assert r.returncode == 0, r.stderr
    j_save_reference(params, cfg.model, str(tmp_path / "jax.bin"))
    got, want = torch.load(out), torch.load(str(tmp_path / "jax.bin"))
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    # the index from the same weights, then its bundle
    index = jserving.build_video_index(
        params, cfg, BatchLoader(
            SyntheticDataset(n=6, seed=1, max_words=Wd, max_frames=F,
                             resolution=cfg.model.clip.image_resolution,
                             vocab_size=cfg.model.clip.vocab_size),
            6, shuffle=False, drop_last=False, workers=0, pad_to_batch=True))
    idx_path = jserving.save_index(str(tmp_path / "idx"), index)
    r = cli("export", "--index", idx_path, "--output",
            str(tmp_path / "bundle"), "--query_batch", "2", "--topk", "4")
    assert r.returncode == 0, r.stderr
    meta = json.load(open(tmp_path / "bundle" / "meta.json"))
    assert (meta["query_batch"], meta["topk"], meta["n_videos"]) == (2, 4, 6)
    assert meta["platforms"] == ["cpu"]
