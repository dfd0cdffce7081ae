"""The port's trainer (run_training, the train CLI) on the CPU: two epochs
against the JAX package's run_training from the same weights, exact
mid-epoch resume, SIGTERM, and the CLI at smoke size.

Tiny config, fp32, `cluster_noise=False` (the two packages draw the
DPC-KNN tie-break noise from different generators).  Losses and parameters
are held to 1e-4, the bar of the JAX package's own trajectory tests; the
resume is bit-equal inside the port.
"""

import dataclasses as dc
import json
import os
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from neighborretr_tpu.core import checkpoint as jckpt
from neighborretr_tpu.core import config as jc
from neighborretr_tpu.data.datasets.synthetic import SyntheticDataset
from neighborretr_tpu.models import neighborretr as jm
from neighborretr_tpu.train import loop as jloop
from neighborretr_tpu_torch.core import checkpoint as tckpt
from neighborretr_tpu_torch.core import config as tc
from neighborretr_tpu_torch.data.datasets.synthetic import \
    SyntheticDataset as TSyntheticDataset
from neighborretr_tpu_torch.models import weights_io as W
from neighborretr_tpu_torch.train import loop as tloop

W_, F_, N = 8, 4, 16
LOSS_KEYS = ("loss", "centrality_loss", "uniform_loss", "neighbor_loss",
             "kl_loss", "grad_norm", "logit_scale")


def make_config(mod, out, epochs=2, resume=None, init=None, noise=False,
                **train):
    model = dc.replace(mod.ModelConfig.tiny(max_words=W_, max_frames=F_),
                       cluster_noise=noise)
    return mod.Config(
        model=model, loss=mod.LossConfig(num_neighbors=3),
        optim=mod.OptimizerConfig(lr=1e-2, coef_lr=0.1),
        data=mod.DataConfig(max_words=W_, max_frames=F_, workers=0),
        train=mod.TrainConfig(epochs=epochs, batch_size=8, batch_size_val=8,
                              mb_batch=1, n_display=1, output_dir=out,
                              resume_checkpoint=resume, init_checkpoint=init,
                              mid_epoch_eval=True, seed=0, **train))


def datasets(cls):
    kw = dict(n=N, max_words=W_, max_frames=F_, resolution=32, vocab_size=512)
    return cls(**kw), cls(seed=1, **kw)


def rows(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def out_dir(tmp_path, name):
    out = str(tmp_path / name)
    os.makedirs(out, exist_ok=True)
    return out


def test_two_epochs_match_jax_run_training(tmp_path):
    """Same weights (one npz as both runs' init_checkpoint), same seeded
    loaders: per-step losses and final parameters within 1e-4, the same
    R@K at every evaluation, the same files."""
    init = str(tmp_path / "init.npz")
    jckpt.save_params(init, jax.device_get(jm.init_params(
        jax.random.PRNGKey(5), jc.ModelConfig.tiny(max_words=W_,
                                                   max_frames=F_))))
    jout, tout = out_dir(tmp_path, "jax"), out_dir(tmp_path, "torch")
    jstate, jtracker = jloop.run_training(
        make_config(jc, jout, init=init), *datasets(SyntheticDataset))
    tstate, ttracker = tloop.run_training(
        make_config(tc, tout, init=init), *datasets(TSyntheticDataset),
        device="cpu")

    assert tstate.step == int(jstate.step) == 4
    jrows, trows = rows(jout), rows(tout)
    assert [(r["kind"], r["step"]) for r in trows] == \
        [(r["kind"], r["step"]) for r in jrows]
    n_train = n_eval = 0
    for t, j in zip(trows, jrows):
        if t["kind"] == "train":
            n_train += 1
            for k in LOSS_KEYS:
                assert np.isfinite(t[k]), k
                np.testing.assert_allclose(t[k], j[k], rtol=1e-4,
                                           err_msg=f"step {t['step']} {k}")
            assert t["data_wait_s"] >= 0
        else:
            n_eval += 1
            assert t["t2v"] == j["t2v"] and t["v2t"] == j["v2t"]
    assert n_train == 4 and n_eval >= 3
    assert ttracker.to_dict() == jtracker.to_dict()

    got = W.to_jax_params(tstate.model.state_dict(), tstate.model.cfg)
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = jax.tree_util.tree_flatten_with_path(
        jax.device_get(jstate.params))[0]
    assert len(flat_got) == len(flat_want)
    moved = 0
    for (pa, a), (pb, b) in zip(flat_got, flat_want):
        assert pa == pb and np.isfinite(a).all()
        assert np.abs(a - np.asarray(b)).max() <= 1e-4, \
            jax.tree_util.keystr(pa)
    with np.load(init) as start:
        moved = sum(not np.array_equal(start[k], v) for k, v in
                    tckpt.flatten_tree(got).items())
    assert moved > 100                   # training did change the weights
    for name in ("best.npz", "best_metrics.json", "state_epoch0.npz",
                 "state_epoch1.npz", "log.txt"):
        assert os.path.exists(os.path.join(tout, name)), name
        assert os.path.exists(os.path.join(jout, name)), name
    # the epoch-end bank is cleared, as in the JAX loop
    assert (tstate.bank.ind == -1).all()
    with np.load(os.path.join(tout, "state_epoch1.npz")) as a, \
            np.load(os.path.join(jout, "state_epoch1.npz")) as b:
        assert set(a.files) == set(b.files)
        np.testing.assert_array_equal(a["bank//ind"], b["bank//ind"])
        np.testing.assert_allclose(a["bank//feat_v"], b["bank//feat_v"],
                                   atol=1e-4)
    # the port resumes from the state the JAX run saved: nothing left to do
    resumed, _ = tloop.run_training(
        make_config(tc, tout, resume=os.path.join(jout, "state_epoch1.npz")),
        *datasets(TSyntheticDataset), device="cpu")
    assert resumed.step == 4


def interrupt_after(monkeypatch, n):
    """SIGTERM right after the n-th train step of the next run."""
    real, calls = tloop.train_step, {"n": 0}

    def stepper(*a, **k):
        out = real(*a, **k)
        calls["n"] += 1
        if calls["n"] == n:
            signal.raise_signal(signal.SIGTERM)
        return out

    monkeypatch.setattr(tloop, "train_step", stepper)
    return real


def test_run_training_takes_sim_dtype_bfloat16(tmp_path):
    """The trainer's loop with model.sim_dtype="bfloat16" (no CLI flag in
    either package: a config field): an epoch of finite steps and evals,
    whose losses move off the float32 run's from the same weights (the
    bank centralities round on the CPU under use_pallas="auto")."""
    got = {}
    for sim_dtype in ("float32", "bfloat16"):
        out = out_dir(tmp_path, sim_dtype)
        cfg = make_config(tc, out, epochs=1)
        cfg = dc.replace(cfg, model=dc.replace(cfg.model,
                                               sim_dtype=sim_dtype))
        state, _ = tloop.run_training(cfg, *datasets(TSyntheticDataset),
                                      device="cpu")
        assert state.step == 2
        got[sim_dtype] = [r for r in rows(out) if r["kind"] == "train"]
    for a, b in zip(got["bfloat16"], got["float32"]):
        assert all(np.isfinite(a[k]) for k in LOSS_KEYS)
    assert any(a["neighbor_loss"] != b["neighbor_loss"]
               for a, b in zip(got["bfloat16"], got["float32"]))


@pytest.mark.parametrize("noise", [False, True])
def test_mid_epoch_resume_is_exact(tmp_path, monkeypatch, noise):
    """Interrupted after step 3 of 4 (mid-epoch 1) and resumed with
    `latest_resumable`: the same loss at step 4 and bit-equal parameters,
    moments and bank as the uninterrupted run, with and without the
    tie-break noise (its generator is seeded from the global step)."""
    data = datasets(TSyntheticDataset)
    ref_out, out = out_dir(tmp_path, "ref"), out_dir(tmp_path, "cut")
    ref, _ = tloop.run_training(make_config(tc, ref_out, noise=noise), *data,
                                device="cpu")
    assert ref.step == 4

    real = interrupt_after(monkeypatch, 3)
    cut, _ = tloop.run_training(make_config(tc, out, noise=noise), *data,
                                device="cpu")
    assert cut.step == 3
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL
    monkeypatch.setattr(tloop, "train_step", real)
    path = tckpt.latest_resumable(out)
    assert path.endswith("state_preempt.npz")       # step 3 > state_epoch0's 2
    resumed, _ = tloop.run_training(make_config(tc, out, resume=path, noise=noise),
                                    *data, device="cpu")
    assert resumed.step == 4 and resumed.opt.step == 4

    def losses(d):
        return {r["step"]: r["loss"] for r in rows(d) if r["kind"] == "train"}

    # the interrupted run leaves before it logs step 3
    assert set(losses(ref_out)) == {1, 2, 3, 4}
    assert set(losses(out)) == {1, 2, 4}
    assert losses(out)[4] == losses(ref_out)[4]
    for (name, a), b in zip(ref.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    for name in ref.opt.m:
        assert torch.equal(ref.opt.m[name], resumed.opt.m[name]), name
        assert torch.equal(ref.opt.v[name], resumed.opt.v[name]), name
    for a, b in zip(ref.bank, resumed.bank):
        assert torch.equal(a, b)


def test_step_generator_depends_on_seed_and_step_only():
    a = torch.rand(4, generator=tloop.step_generator(3, 7, "cpu"))
    assert torch.equal(a, torch.rand(4, generator=tloop.step_generator(3, 7, "cpu")))
    assert not torch.equal(a, torch.rand(4, generator=tloop.step_generator(3, 8, "cpu")))
    assert not torch.equal(a, torch.rand(4, generator=tloop.step_generator(4, 7, "cpu")))


def test_preemption_during_the_first_epoch_and_unported_checkpoint(
        tmp_path, monkeypatch):
    """SIGTERM after step 1: a resumable state_preempt.npz, no final test;
    the resumed run takes the remaining steps.  A CLIP checkpoint in the
    config is read: a missing file raises."""
    data = datasets(TSyntheticDataset)
    out = out_dir(tmp_path, "preempt")
    real = interrupt_after(monkeypatch, 1)
    state, _ = tloop.run_training(make_config(tc, out, epochs=1), *data,
                                  device="cpu")
    assert state.step == 1
    ppath = os.path.join(out, "state_preempt.npz")
    assert os.path.exists(ppath)
    assert "Final test" not in open(os.path.join(out, "log.txt")).read()
    monkeypatch.setattr(tloop, "train_step", real)
    resumed, _ = tloop.run_training(make_config(tc, out, epochs=1,
                                                resume=ppath), *data,
                                    device="cpu")
    assert resumed.step == 2
    log = open(os.path.join(out, "log.txt")).read()
    assert "exact mid-epoch resume at batch 1/2" in log
    assert "Final test on best checkpoint" in log
    with pytest.raises(FileNotFoundError, match="ViT-B-32.pt"):
        tloop.run_training(make_config(tc, out, clip_checkpoint="ViT-B-32.pt"),
                           *data, device="cpu")


CLI = [sys.executable, "-m", "neighborretr_tpu_torch.cli.train", "--device",
       "cpu", "--datatype", "synthetic", "--batch_size", "8",
       "--batch_size_val", "8", "--max_words", "8", "--max_frames", "4",
       "--mb_batch", "2", "--synthetic_size", "16", "--n_display", "1",
       "--num_neighbors", "3", "--workers", "0", "--micro_batches", "2"]


def run_cli(*extra, **kw):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return subprocess.run(CLI + list(extra), cwd=root, capture_output=True,
                          text=True, timeout=600, **kw)


def test_train_cli_smoke_writes_the_files_and_resumes(tmp_path):
    out = str(tmp_path / "cli")
    done = run_cli("--epochs", "1", "--output_dir", out)
    assert done.returncode == 0, done.stdout[-2000:] + done.stderr[-2000:]
    for name in ("best.npz", "best_metrics.json", "state_epoch0.npz",
                 "log.txt", "metrics.jsonl"):
        assert os.path.exists(os.path.join(out, name)), name
    assert "memory bank filled" in done.stdout
    assert "Final test on best checkpoint" in done.stdout
    assert "R@1" in done.stdout
    train = [r for r in rows(out) if r["kind"] == "train"]
    assert [r["step"] for r in train] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in train)
    # the same command for one more epoch, resumed by itself
    again = run_cli("--epochs", "2", "--output_dir", out, "--resume", "auto")
    assert again.returncode == 0, again.stdout[-2000:] + again.stderr[-2000:]
    assert "--resume auto: resuming from" in again.stdout
    assert "at step 2 (epoch 1)" in again.stdout
    assert [r["step"] for r in rows(out) if r["kind"] == "train"] == \
        [1, 2, 3, 4]
    assert os.path.exists(os.path.join(out, "state_epoch1.npz"))
    # the eval CLI on the best weights gives the best evaluation's R@1 again
    from neighborretr_tpu_torch.cli import eval as eval_cli
    t2v, v2t = eval_cli.main([
        "--device", "cpu", "--datatype", "synthetic", "--tiny",
        "--checkpoint", os.path.join(out, "best.npz"), "--max_words", "8",
        "--max_frames", "4", "--batch_size_val", "8", "--workers", "0"])
    with open(os.path.join(out, "best_metrics.json")) as f:
        best = json.load(f)
    assert (t2v["R1"] + v2t["R1"]) / 2 == pytest.approx(best["best_mean_r1"])


def test_train_cli_refuses_unported_options_and_missing_gpu(tmp_path):
    out = str(tmp_path / "refused")
    # the host placements are ported and need an accelerator: on the CPU
    # the CLI exits with the JAX package's words for it
    from neighborretr_tpu.train import memory_bank as jmb
    with pytest.raises(ValueError) as jax_refusal:
        jmb.place_bank(jmb.create(4, 2, 2, 3), "host")
    jax_words = str(jax_refusal.value).split(" (")[0]
    # the model-sharded flags are ported: they exit as the JAX CLI does
    for flags, says in (
            (["--fsdp", "--tensor_parallel", "2"],
             "--fsdp applies to pure data-parallel meshes"),
            (["--tensor_parallel", "2"],
             "--tensor_parallel 2 must divide the device count 1"),
            (["--bank_placement", "host"], jax_words)):
        done = run_cli("--output_dir", out, *flags)
        assert done.returncode != 0
        assert says in done.stderr, done.stderr[-2000:]
    # a CLIP checkpoint is read now; a missing one fails before any output
    done = run_cli("--output_dir", out, "--clip_checkpoint", "ViT-B-32.pt")
    assert done.returncode != 0
    assert "--clip_checkpoint ViT-B-32.pt: no such file" in done.stderr
    assert not os.path.exists(out)
    if not torch.cuda.is_available():
        no_gpu = subprocess.run(
            [a for a in CLI if a not in ("--device", "cpu")]
            + ["--output_dir", out], capture_output=True, text=True,
            timeout=600, cwd=os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))
        assert no_gpu.returncode != 0
        assert "no CUDA device is visible" in no_gpu.stderr
