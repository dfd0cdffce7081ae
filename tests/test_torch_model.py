"""The port's model against the JAX package on the tiny config, fp32.

Weights: init_params(PRNGKey(0)) → jax.device_get → from_jax_params.
Inputs come from a numpy seed and reach both frameworks as numpy arrays.
"""

import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from neighborretr_tpu import serving as jserving
from neighborretr_tpu.core import checkpoint as jckpt
from neighborretr_tpu.core.config import Config, ModelConfig
from neighborretr_tpu.data.video import normalize_frames as jax_normalize
from neighborretr_tpu.models import neighborretr as jm
from neighborretr_tpu.models.weights_io import reference_state_dict_from_params
from neighborretr_tpu.train.evaluate import similarity_matrix as jax_sim_matrix
from neighborretr_tpu_torch import eval as peval
from neighborretr_tpu_torch.core import config as pconfig
from neighborretr_tpu_torch import serving as pserving
from neighborretr_tpu_torch.models import weights_io as W
from neighborretr_tpu_torch.models.neighborretr import local_similarity
from neighborretr_tpu_torch.ops.video import normalize_frames

W_, F_, B_ = 8, 4, 5
# the port's own configuration: each package gets one from its dataclasses
PCFG = pconfig.ModelConfig.tiny(max_words=W_, max_frames=F_)


@pytest.fixture(scope="module")
def setup():
    cfg = ModelConfig.tiny(max_words=W_, max_frames=F_)
    params = jax.device_get(jm.init_params(jax.random.PRNGKey(0), cfg))
    model = W.from_jax_params(params, PCFG)
    rng = np.random.default_rng(0)
    vocab = cfg.clip.vocab_size
    ids = np.zeros((B_, W_), np.int32)
    mask = np.zeros((B_, W_), np.float32)
    for i in range(B_):                       # ragged captions, EoT = max id
        n = int(rng.integers(3, W_ + 1))
        ids[i, :n] = rng.integers(1, vocab - 1, n)
        ids[i, n - 1] = vocab - 1
        mask[i, :n] = 1
    R = cfg.clip.image_resolution
    video = rng.integers(0, 256, (B_, F_, R, R, 3)).astype(np.uint8)
    vmask = np.ones((B_, F_), np.float32)
    vmask[1, 2:] = 0                          # padded frames
    vmask[3, 3:] = 0
    return cfg, params, model, ids, mask, video, vmask


def test_text_features_match_jax(setup):
    cfg, params, model, ids, mask, _, _ = setup
    want = np.asarray(jm.get_text_feat(params, cfg, ids, mask))
    got = peval.encode_text_batch(model, ids, mask).numpy()
    assert got.shape == want.shape == (B_, W_, cfg.clip.embed_dim)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_video_features_match_jax(setup):
    cfg, params, model, _, _, video, vmask = setup
    want = np.asarray(jm.get_video_feat(params, cfg, video, vmask))
    got = peval.encode_video_batch(model, video, vmask).numpy()
    assert got.shape == want.shape == (B_, F_, cfg.clip.embed_dim)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_similarity_matrix_matches_jax(setup):
    cfg, params, model, ids, mask, video, vmask = setup
    tf = np.asarray(jm.get_text_feat(params, cfg, ids, mask))
    vf = np.asarray(jm.get_video_feat(params, cfg, video, vmask))
    full = Config(model=cfg)
    want = jax_sim_matrix(params, full, tf, mask, vf, vmask)
    got = peval.similarity_matrix(model, tf, mask, vf, vmask)
    assert got.shape == (B_, B_)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # the plain version's row-blocked branch gives the same matrix
    blocked = peval.similarity_matrix(model, tf, mask, vf, vmask, block=2,
                                      max_logits_bytes=0)
    np.testing.assert_allclose(blocked, got, atol=1e-6, rtol=0)


def test_local_similarity_long_tokens_on_cpu_is_chunked(setup):
    """T·V ≥ 2048 (the JAX package's blocked-kernel shapes) takes the
    chunked plain version on the CPU and agrees with the JAX chunked form."""
    cfg, params, model, _, _, _, _ = setup
    rng = np.random.default_rng(4)
    E = cfg.clip.embed_dim
    tf = rng.normal(size=(3, 64, E)).astype(np.float32)
    vf = rng.normal(size=(5, 32, E)).astype(np.float32)
    tm = np.ones((3, 64), np.float32)
    vm = np.ones((5, 32), np.float32)
    tm[0, 40:] = 0
    vm[2, 20:] = 0
    want = np.asarray(jm.local_similarity(params, tf, vf, tm, vm))
    got = local_similarity(model, *map(torch.as_tensor, (tf, vf, tm, vm)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)


def test_state_dict_matches_reference_export(setup):
    """Every tensor of the port carries the reference's name and value
    (weights_io.reference_state_dict_from_params)."""
    cfg, params, model, *_ = setup
    ref = reference_state_dict_from_params(params, cfg)
    sd = model.state_dict()
    assert set(sd) <= set(ref)
    for name, t in sd.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(ref[name]),
                                      err_msg=name)
    # what the port leaves out is training-only (CTM stacks, *_fc1 nets)
    assert all(k.startswith(("text_ctm", "video_ctm", "text_block",
                             "video_block", "text_weight_fc1",
                             "video_weight_fc1"))
               for k in set(ref) - set(sd))


def test_params_fingerprint_matches_jax(setup):
    _, params, model, *_ = setup
    assert pserving.params_fingerprint(model) == \
        jserving.params_fingerprint(params)


def test_normalize_frames_matches_jax():
    u8 = np.random.default_rng(1).integers(0, 256, (2, 3, 8, 8, 3)).astype(
        np.uint8)
    want = np.asarray(jax_normalize(u8))
    got = normalize_frames(torch.as_tensor(u8)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("layout", ["params_only", "train_state"])
def test_npz_checkpoint_reader(setup, tmp_path, layout):
    cfg, params, model, *_ = setup
    flat = jckpt.flatten_tree(params)
    if layout == "train_state":
        flat = {f"params//{k}": v for k, v in flat.items()}
        flat["opt_step"] = np.asarray(3)
        flat["opt_state//mu//x"] = np.zeros(2, np.float32)
    path = str(tmp_path / "ckpt.npz")
    np.savez(path, **flat)
    loaded = W.load_checkpoint(path, PCFG)
    for name, t in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[name], t), name


def test_init_model_is_seeded_and_follows_init_params():
    cfg = pconfig.ModelConfig.tiny()
    a, b = W.init_model(cfg, 0), W.init_model(cfg, 0)
    c = W.init_model(cfg, 1)
    for name, t in a.state_dict().items():
        assert torch.equal(t, b.state_dict()[name]), name
    assert not torch.equal(a.clip.text_projection, c.clip.text_projection)
    assert a.clip.logit_scale.item() == 1.0
    # the temporal tower starts as a copy of the first text blocks
    torch.testing.assert_close(a.frame_position_embeddings.weight,
                               a.clip.positional_embedding)
    for t_blk, c_blk in zip(a.transformerClip.resblocks,
                            a.clip.transformer.resblocks):
        for (n, x), (_, y) in zip(t_blk.state_dict().items(),
                                  c_blk.state_dict().items()):
            assert torch.equal(x, y), n
    # init_params' scales: in_proj std D^-0.5, token table std 0.02
    D = cfg.clip.transformer_width
    w = a.clip.transformer.resblocks[0].attn.in_proj_weight
    assert abs(w.std().item() - D ** -0.5) < 0.1 * D ** -0.5
    assert abs(a.clip.token_embedding.weight.std().item() - 0.02) < 0.002
    # one tensor's shape does not move any other's draw (vocab change)
    import dataclasses as dc
    big = W.init_model(dc.replace(cfg, clip=dc.replace(cfg.clip,
                                                       vocab_size=1000)), 0)
    assert pserving.params_fingerprint(big) == pserving.params_fingerprint(a)


def test_port_imports_without_jax():
    """Every module of the port and chip_smoke import with `jax` blocked,
    and pull in neither JAX nor any module of the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "import neighborretr_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "assert len(names) > 30, names\n"
        "for name in names + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and "
        "(m == 'jax' or m.startswith('jax.') or m == 'jaxlib' or "
        "m == 'neighborretr_tpu' or m.startswith('neighborretr_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    root = str(__import__("pathlib").Path(__file__).resolve().parents[1])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
