"""The port's copies of two modules that need no device: the analytic FLOP
counts (utils/flops.py) against the JAX package's, exactly, and the
offline compression CLI (cli/compress_video.py) on the cases of
tests/test_compress_video.py, with ffmpeg gated the same way."""

import dataclasses as dc
import os
import shutil

import pytest

from neighborretr_tpu.core import config as jc
from neighborretr_tpu.utils import flops as jflops
from neighborretr_tpu_torch.cli.compress_video import (
    compress, prepare_input_output_pairs)
from neighborretr_tpu_torch.core import config as tc
from neighborretr_tpu_torch.utils import flops as tflops


def _config(mod, clip, words, frames, batch, mb_batch, **model):
    return mod.Config(
        model=mod.ModelConfig(clip=clip, max_words=words, max_frames=frames,
                              **model),
        train=mod.TrainConfig(batch_size=batch, mb_batch=mb_batch))


def _configs(mod):
    """tiny, the MSR-VTT recipe (and at batch 96 / bank 384), the long
    recipe, ViT-L/14@336px: the same fields from either package."""
    C = mod.ClipConfig
    return {
        "tiny": mod.Config(model=mod.ModelConfig.tiny(max_words=8,
                                                      max_frames=4),
                           train=mod.TrainConfig(batch_size=8, mb_batch=2)),
        "msrvtt": _config(mod, C(), 24, 12, 128, 15),
        "msrvtt_b96": _config(mod, C(), 24, 12, 96, 4),
        "long": _config(mod, C(), 64, 64, 128, 15),
        "vit_l_14_336": _config(mod, C.vit_l_14_336(), 24, 12, 16, 15),
    }


@pytest.mark.parametrize("name", ["tiny", "msrvtt", "msrvtt_b96", "long",
                                  "vit_l_14_336"])
def test_analytic_flops_equal_the_jax_package(name):
    jcfg, tcfg = _configs(jc)[name], _configs(tc)[name]
    assert tflops.analytic_step_phase_flops(tcfg) == \
        jflops.analytic_step_phase_flops(jcfg)
    assert tflops.analytic_step_flops(tcfg) == jflops.analytic_step_flops(jcfg)
    assert tflops.analytic_pair_flops(tcfg) == jflops.analytic_pair_flops(jcfg)
    if name == "msrvtt_b96":
        assert tcfg.train.memory_bank_capacity == 384
        assert round(tflops.analytic_step_flops(tcfg) / 1e12, 2) == 30.64
        assert round(tflops.analytic_pair_flops(tcfg) / 1e9, 1) == 319.2


def test_enumerate_mirrors_layout(tmp_path):
    (tmp_path / "in" / "sub").mkdir(parents=True)
    (tmp_path / "in" / "a.mp4").write_bytes(b"x")
    (tmp_path / "in" / "sub" / "b.avi").write_bytes(b"x")
    (tmp_path / "in" / "notes.txt").write_bytes(b"x")     # non-video: skipped
    pairs = prepare_input_output_pairs(str(tmp_path / "in"),
                                       str(tmp_path / "out"))
    dsts = sorted(d for _, d in pairs)
    assert dsts == [str(tmp_path / "out" / "a.mp4"),
                    str(tmp_path / "out" / "sub" / "b.avi")]


def test_existing_output_skipped(tmp_path):
    src = tmp_path / "a.mp4"
    dst = tmp_path / "out" / "a.mp4"
    src.write_bytes(b"x")
    dst.parent.mkdir()
    dst.write_bytes(b"already done")
    assert compress((str(src), str(dst), 3, 224)).startswith("skip")


@pytest.mark.skipif(shutil.which("ffmpeg") is None, reason="ffmpeg not on PATH")
def test_ffmpeg_reencode(tmp_path):
    import numpy as np
    try:
        import cv2
    except ImportError:
        pytest.skip("cv2 unavailable")
    src = str(tmp_path / "clip.mp4")
    w = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"mp4v"), 12, (64, 48))
    for i in range(24):
        w.write(np.full((48, 64, 3), i * 10, np.uint8))
    w.release()
    dst = str(tmp_path / "out" / "clip.mp4")
    msg = compress((src, dst, 3, 32))
    assert msg.startswith("ok"), msg
    cap = cv2.VideoCapture(dst)
    assert int(round(cap.get(cv2.CAP_PROP_FPS))) == 3
    assert min(cap.get(cv2.CAP_PROP_FRAME_WIDTH),
               cap.get(cv2.CAP_PROP_FRAME_HEIGHT)) == 32
    assert os.path.getsize(dst) > 0
