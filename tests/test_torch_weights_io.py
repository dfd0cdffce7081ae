"""The port's checkpoint readers against the JAX package's
(models/weights_io.py): an OpenAI CLIP archive (torch.save dict and
TorchScript, fp16) and a reference-trained `best.pth` load into the port
leaf for leaf as into the JAX pytree, the towers then agree, the shape
sniffer agrees on the tiny and the four published backbones, and the
rejections raise as in JAX.

The archive's weights come from a numpy seed (tools/clip_archive.py); the
tiny dims are `ClipConfig.tiny()`'s, the ones `--tiny` uses.
"""

import logging

import jax
import numpy as np
import pytest
import torch

from neighborretr_tpu.core import checkpoint as jckpt
from neighborretr_tpu.core.config import ClipConfig as JClipConfig
from neighborretr_tpu.core.config import ModelConfig as JModelConfig
from neighborretr_tpu.models import neighborretr as jm
from neighborretr_tpu.models import weights_io as jw
from neighborretr_tpu_torch import eval as peval
from neighborretr_tpu_torch.core.config import ClipConfig, ModelConfig
from neighborretr_tpu_torch.models import weights_io as W
from neighborretr_tpu_torch.tools import clip_archive as CA

WORDS, FRAMES = 8, 4
JCFG = JModelConfig.tiny(max_words=WORDS, max_frames=FRAMES)
PCFG = ModelConfig.tiny(max_words=WORDS, max_frames=FRAMES)
# fp32 towers of 2 layers on the CPU; the same products in another order
FEATURE_RTOL = 1e-5


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    """The same seeded tiny CLIP as a torch.save dict and as a TorchScript
    archive, both fp16, and its fp32 values after the fp16 round trip."""
    d = tmp_path_factory.mktemp("clip")
    c = ClipConfig.tiny()
    sd = CA.random_openai_state_dict(c, seed=3)
    paths = {}
    for kind, script in (("plain", False), ("torchscript", True)):
        paths[kind] = str(d / f"tiny_{kind}.pt")
        CA.save_openai_archive(sd, c, paths[kind], torchscript=script)
    rounded = {k: np.asarray(v, np.float16).astype(np.float32)
               for k, v in sd.items()}
    return paths, rounded


def leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}"
        out.update(leaves(v, name) if isinstance(v, dict)
                   else {name: np.asarray(v)})
    return out


def assert_trees_equal(got, want):
    got, want = leaves(got), leaves(want)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].shape == want[name].shape, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def jax_params(seed=0):
    return jax.device_get(jm.init_params(jax.random.PRNGKey(seed), JCFG))


def text_and_video(seed=0):
    rng = np.random.default_rng(seed)
    vocab = JCFG.clip.vocab_size
    ids = np.zeros((3, WORDS), np.int32)
    mask = np.zeros((3, WORDS), np.float32)
    for i, n in enumerate((3, WORDS, 5)):
        ids[i, :n] = rng.integers(1, vocab - 1, n)
        ids[i, n - 1] = vocab - 1
        mask[i, :n] = 1
    R = JCFG.clip.image_resolution
    video = rng.integers(0, 256, (2, FRAMES, R, R, 3)).astype(np.uint8)
    vmask = np.ones((2, FRAMES), np.float32)
    vmask[1, 2:] = 0
    return ids, mask, video, vmask


@pytest.mark.parametrize("kind", ["plain", "torchscript"])
def test_openai_archive_loads_as_in_jax(archives, kind):
    paths, rounded = archives
    want = jax.device_get(jw.load_openai_clip_into(jax_params(), JCFG,
                                                   paths[kind]))
    model = W.load_openai_clip_into(W.init_model(PCFG, seed=5), paths[kind])
    got = W.to_jax_params(model.state_dict(), PCFG)
    # the loaded subtrees are a copy of the file in both packages; the rest
    # keeps each package's own random init
    for sub in ("clip", "temporal"):
        assert_trees_equal(got[sub], want[sub])
    sd = model.clip.state_dict()
    assert sorted(sd) == sorted(rounded)
    for k, v in rounded.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    # the temporal tower is the text tower's first blocks again
    for dst, src in zip(model.transformerClip.resblocks,
                        model.clip.transformer.resblocks):
        for (n, a), b in zip(dst.state_dict().items(),
                             src.state_dict().values()):
            assert torch.equal(a, b), n
    assert torch.equal(model.frame_position_embeddings.weight,
                       model.clip.positional_embedding)


def test_loaded_towers_agree_with_jax(archives):
    paths, _ = archives
    torch.backends.cuda.matmul.allow_tf32 = False
    params = jax.device_get(jw.load_openai_clip_into(
        jax_params(), JCFG, paths["torchscript"]))
    model = W.from_jax_params(params, PCFG)
    W.load_openai_clip_into(model, paths["torchscript"])
    ids, mask, video, vmask = text_and_video()
    for want, got in (
            (jm.get_text_feat(params, JCFG, ids, mask),
             peval.encode_text_batch(model, ids, mask)),
            (jm.get_video_feat(params, JCFG, video, vmask),
             peval.encode_video_batch(model, video, vmask))):
        want, got = np.asarray(want), got.numpy()
        assert got.shape == want.shape
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= FEATURE_RTOL, err


def _stubs(shapes):
    # zero-stride views: the sniffer reads shapes only, nothing is allocated
    return {k: np.broadcast_to(np.float32(0), s) for k, s in shapes.items()}


@pytest.mark.parametrize("name", ["tiny"] + list(ClipConfig.backbone_names()))
def test_sniff_matches_jax(name):
    c = ClipConfig.tiny() if name == "tiny" else ClipConfig.from_name(name)
    stubs = _stubs(CA.openai_clip_shapes(c))
    got, want = W.sniff_clip_config(stubs), jw.sniff_clip_config(stubs)
    assert got == c
    assert dict(vars(got)) == dict(vars(want))
    jc = (JClipConfig.tiny() if name == "tiny"
          else JClipConfig.from_name(name))
    assert want == jc


def test_reference_checkpoint_loads_as_in_jax(tmp_path):
    params = jax_params(seed=1)
    path = str(tmp_path / "best.pth")
    jw.save_reference_checkpoint(params, JCFG, path)
    want = jax.device_get(jw.load_reference_checkpoint_into(
        jax_params(seed=2), JCFG, path))
    assert_trees_equal(want, params)
    model = W.load_reference_checkpoint_into(W.init_model(PCFG, seed=4), path)
    assert_trees_equal(W.to_jax_params(model.state_dict(), PCFG), want)
    # the dispatch takes a non-npz file down the same path
    again = W.load_model_checkpoint(W.init_model(PCFG, seed=6), path)
    assert_trees_equal(W.to_jax_params(again.state_dict(), PCFG), want)
    # and the reference's extra tensors (its dead weighting nets, the
    # memory-bank buffers) are ignored, as in JAX
    sd = torch.load(path, weights_only=True)
    sd["text_weight_fc0.0.weight"] = torch.zeros(3, 3)
    sd["mb_feat_t"] = torch.zeros(2, 2)
    torch.save(sd, path)
    extra = W.load_model_checkpoint(W.init_model(PCFG, seed=6), path)
    assert_trees_equal(W.to_jax_params(extra.state_dict(), PCFG), want)
    assert_trees_equal(jax.device_get(jw.load_model_checkpoint_into(
        jax_params(seed=2), JCFG, path)), want)


def test_npz_dispatch_as_in_jax(tmp_path, caplog):
    params = jax_params(seed=1)
    path = str(tmp_path / "best.npz")
    jckpt.save_params(path, params)
    want = jax.device_get(jw.load_model_checkpoint_into(jax_params(seed=2),
                                                        JCFG, path))
    got = W.load_model_checkpoint(W.init_model(PCFG, seed=4), path)
    assert_trees_equal(W.to_jax_params(got.state_dict(), PCFG), want)
    # strict=False: a file without the weighting nets keeps the model's
    # own, in both packages, and the diff is logged
    with np.load(path) as f:
        kept = {k: f[k] for k in f.files if "weight_fc" not in k}
    partial = str(tmp_path / "partial.npz")
    np.savez(partial, **kept)
    start = W.init_model(PCFG, seed=4)
    before = W.to_jax_params(start.state_dict(), PCFG)
    with caplog.at_level(logging.INFO):
        warm = W.load_model_checkpoint(start, partial, strict=False,
                                       logger=logging.getLogger("t"))
    assert "warm-start missing leaves (16)" in caplog.text
    jwarm = jax.device_get(jw.load_model_checkpoint_into(
        jax_params(seed=2), JCFG, partial, strict=False))
    got = W.to_jax_params(warm.state_dict(), PCFG)
    for name in ("text_weight_fc", "video_weight_fc", "text_weight_fc1",
                 "video_weight_fc1"):
        assert_trees_equal(got[name], before[name])
        got[name] = jwarm[name] = None
    assert_trees_equal({k: v for k, v in got.items() if v is not None},
                       {k: v for k, v in jwarm.items() if v is not None})
    with pytest.raises(KeyError):
        W.load_model_checkpoint(W.init_model(PCFG, seed=4), partial)


def test_rejections_raise_as_in_jax(archives, tmp_path):
    paths, _ = archives
    # a bare CLIP archive on the model-checkpoint path points at
    # --clip_checkpoint
    for kind in ("plain", "torchscript"):
        with pytest.raises(ValueError, match="clip_checkpoint"):
            jw.load_reference_checkpoint_into(jax_params(), JCFG, paths[kind])
        with pytest.raises(ValueError, match="clip_checkpoint"):
            W.load_model_checkpoint(W.init_model(PCFG), paths[kind])
    # another architecture than configured: the CLIP and the reference path
    import dataclasses as dc
    jother = dc.replace(JCFG, clip=dc.replace(JCFG.clip, vision_layers=3))
    pother = dc.replace(PCFG, clip=dc.replace(PCFG.clip, vision_layers=3))
    with pytest.raises(ValueError, match="architecture"):
        jw.load_openai_clip_into(jm.init_params(jax.random.PRNGKey(0),
                                                jother), jother,
                                 paths["torchscript"])
    with pytest.raises(ValueError, match="architecture"):
        W.load_openai_clip_into(W.init_model(pother), paths["torchscript"])
    ref = str(tmp_path / "best.pth")
    jw.save_reference_checkpoint(jax_params(), JCFG, ref)
    with pytest.raises(ValueError, match="different architecture"):
        jw.load_reference_checkpoint_into(
            jm.init_params(jax.random.PRNGKey(0), jother), jother, ref)
    with pytest.raises(ValueError, match="different architecture"):
        W.load_model_checkpoint(W.init_model(pother), ref)


def test_reading_drops_archive_extras_and_casts(archives):
    paths, rounded = archives
    for kind in ("plain", "torchscript"):
        sd = W.read_torch_state_dict(paths[kind])
        assert sorted(sd) == sorted(rounded)
        assert all(v.dtype == torch.float32 and v.device.type == "cpu"
                   for v in sd.values())
        assert sd["logit_scale"].shape == ()
