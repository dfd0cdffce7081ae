"""The port's multi-process entry points on the CPU, two gloo ranks of the
tiny config: the train CLI with `--num_devices 2` (gathered and explicit
forms) against `--num_devices 1`; a SIGTERM on one rank mid-epoch, the
sharded preempt set and the resume against an unbroken run; the sharded
set read by the JAX package and a JAX set read by the port; the flag
checks; the eval CLI over two ranks; the index CLI over two devices
against the JAX index on a 2-device mesh.

Tolerances: two ranks encode 4 rows each where one process encodes 8, so
the float sums of the towers may round otherwise; losses and parameters
are held to 1e-5 (relative for the losses, absolute for the parameters),
R@K to equality.  The resumed run is held to the unbroken one bit for bit,
and the sharded sets cross between the packages bit for bit.
"""

import argparse
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = ["--device", "cpu", "--datatype", "synthetic", "--batch_size", "8",
       "--batch_size_val", "8", "--max_words", "8", "--max_frames", "4",
       "--mb_batch", "2", "--synthetic_size", "16", "--n_display", "1",
       "--num_neighbors", "3", "--workers", "0", "--epochs", "2"]
SPAWN_TIMEOUT = 300
LOSS_KEYS = ("loss", "centrality_loss", "uniform_loss", "neighbor_loss",
             "kl_loss", "grad_norm")
SIGTERM_AFTER = 3          # mid-epoch 1 of 2 steps an epoch


def sigterm_worker(after: int, argv) -> None:
    """The train CLI as rank 0 of `--num_devices 2`, sending itself SIGTERM
    after global step `after`; rank 1 (a child process) is not signalled."""
    from neighborretr_tpu_torch.cli import train as cli
    from neighborretr_tpu_torch.train import loop

    real = loop.train_step

    def step(state, *a, **kw):
        state, met = real(state, *a, **kw)
        if state.step == after:
            os.kill(os.getpid(), signal.SIGTERM)
        return state, met

    loop.train_step = step
    cli.main(argv)


def _env():
    return dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")


def _start(cmd):
    return subprocess.Popen(cmd, cwd=ROOT, env=_env(), text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _finish(proc):
    try:
        out, _ = proc.communicate(timeout=SPAWN_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    return proc.returncode, out


def _train(out, *extra):
    return _start([sys.executable, "-m", "neighborretr_tpu_torch.cli.train",
                   *CLI, "--output_dir", out, *extra])


def _rows(out, kind):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["kind"] == kind]


def _npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


AUGMENT = ("--augment_backend", "device")
RUNS = {   # name → the train CLI's extra flags, in two waves of processes
    "one": ("--num_devices", "1"),
    "gathered": ("--num_devices", "2"),
    "explicit": ("--num_devices", "2", "--explicit_spmd"),
    "cut": None,                    # two ranks, SIGTERM on rank 0
    "micro": ("--num_devices", "2", "--micro_batches", "2"),
    "augment_one": ("--num_devices", "1") + AUGMENT,
    "augment": ("--num_devices", "2") + AUGMENT,
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The train CLI at one rank and at two ranks in the gathered form (with
    and without micro-batches), the explicit form and under the device
    augment, and at two ranks with a SIGTERM on rank 0 after step 3."""
    d = {k: str(tmp_path_factory.mktemp(k)) for k in RUNS}
    done = {}
    names = list(RUNS)
    for wave in (names[:4], names[4:]):
        procs = {k: (_train(d[k], *RUNS[k]) if RUNS[k] is not None else
                     _start([sys.executable, os.path.abspath(__file__),
                             "sigterm", str(SIGTERM_AFTER), *CLI,
                             "--output_dir", d[k], "--num_devices", "2"]))
                 for k in wave}
        done.update({k: _finish(p) for k, p in procs.items()})
    for k, (rc, out) in done.items():
        assert rc == 0, (k, out[-3000:])
    return d, done


@pytest.mark.parametrize("form, ref", [
    ("gathered", "one"), ("explicit", "one"), ("micro", "one"),
    ("augment", "augment_one")])
def test_train_cli_two_ranks_match_one(runs, form, ref):
    """Losses at every step, R@K at every evaluation, best.npz and the last
    epoch's state: two ranks against one (micro-batches cut each rank's
    rows; under the device augment each rank's clips get the draws they
    get in one process)."""
    d, done = runs
    assert "Data group: 2 rank(s) over gloo, " + (
        "explicit row-sharded" if form == "explicit" else "gathered") \
        in done[form][1]
    one, two = d[ref], d[form]
    want, got = _rows(one, "train"), _rows(two, "train")
    assert [r["step"] for r in got] == [r["step"] for r in want] == \
        [1, 2, 3, 4]
    for a, b in zip(got, want):
        for k in LOSS_KEYS:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)
    ev1, ev2 = _rows(one, "eval"), _rows(two, "eval")
    assert len(ev1) == len(ev2) > 0
    for a, b in zip(ev1, ev2):
        assert a["t2v"] == b["t2v"] and a["v2t"] == b["v2t"]
    for name in ("best.npz", "state_epoch1.npz"):
        a, b = _npz(os.path.join(one, name)), _npz(os.path.join(two, name))
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(b[k], a[k], atol=1e-5, err_msg=k)
    # rank 0 alone writes: no per-rank files, one metrics row per step
    assert not [f for f in os.listdir(two) if "shard" in f]


def test_sigterm_on_one_rank_then_sharded_resume_equals_unbroken(runs):
    """SIGTERM reaches rank 0 only, mid-epoch: both ranks stop at the same
    step boundary and each writes its file of the sharded set; `--resume
    auto` takes the set by its manifest and ends where the unbroken run
    ends, bit for bit."""
    from neighborretr_tpu_torch.core import checkpoint as ckpt
    d, done = runs
    cut = d["cut"]
    names = sorted(os.listdir(cut))
    assert "state_preempt.shard0.npz" in names
    assert "state_preempt.shard1.npz" in names
    assert "state_preempt.manifest.json" in names
    assert "state_preempt.npz" not in names
    assert "state_epoch1.npz" not in names
    # the stopped run leaves before it logs its last step
    assert [r["step"] for r in _rows(cut, "train")] == [1, 2]
    manifest = os.path.join(cut, "state_preempt.manifest.json")
    assert ckpt.latest_resumable(cut) == manifest
    with np.load(os.path.join(cut, "state_preempt.shard1.npz")) as f:
        assert sorted(f.files) == ["opt_step", "process_count", "step"]
        assert int(f["step"]) == SIGTERM_AFTER

    rc, out = _finish(_train(cut, "--num_devices", "2", "--resume", "auto"))
    assert rc == 0, out[-3000:]
    assert f"resuming from {manifest}" in out
    assert f"at step {SIGTERM_AFTER} (epoch 1, batch 1)" in out
    assert [r["step"] for r in _rows(cut, "train")] == [1, 2, 4]
    want = _npz(os.path.join(d["gathered"], "state_epoch1.npz"))
    got = _npz(os.path.join(cut, "state_epoch1.npz"))
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _tiny_states():
    """A JAX and a port train state of the train CLI's tiny model."""
    import dataclasses as dc

    import jax

    from neighborretr_tpu.core import config as jc
    from neighborretr_tpu.models import neighborretr as jm
    from neighborretr_tpu.train import memory_bank as jmb
    from neighborretr_tpu.train import step as jstep
    from neighborretr_tpu_torch.core import config as tc
    from neighborretr_tpu_torch.models import weights_io as W
    from neighborretr_tpu_torch.train import memory_bank as tmb
    from neighborretr_tpu_torch.train import step as tstep

    jm_cfg = jc.ModelConfig.tiny(max_words=8, max_frames=4)
    tm_cfg = tc.ModelConfig.tiny(max_words=8, max_frames=4)
    assert dc.asdict(jm_cfg) == dc.asdict(tm_cfg)
    cap = 16
    jstate = jstep.create_train_state(
        jm.init_params(jax.random.PRNGKey(9), jm_cfg),
        jmb.create(cap, 8, 4, jm_cfg.width))
    tstate = tstep.create_train_state(W.init_model(tm_cfg, 5, "cpu"),
                                      tmb.create(cap, 8, 4, tm_cfg.width))
    return jstate, tstate


def _port_flat(state):
    from neighborretr_tpu_torch.core import checkpoint as ckpt
    return ckpt.train_state_payload(state)


def test_jax_reads_the_ports_sharded_set(runs):
    from neighborretr_tpu.core import checkpoint as jckpt
    from neighborretr_tpu_torch.core import checkpoint as ckpt
    d, _ = runs
    manifest = os.path.join(d["cut"], "state_preempt.manifest.json")
    jstate, tstate = _tiny_states()
    want = _port_flat(ckpt.load_sharded_train_state(manifest, tstate))
    got = jckpt.load_sharded_train_state(manifest, jstate)
    flat = {}
    for name, tree in (("params", got.params), ("opt_m", got.opt.m),
                       ("opt_v", got.opt.v), ("bank", got.bank._asdict())):
        flat.update({f"{name}//{k}": v
                     for k, v in jckpt.flatten_tree(tree).items()})
    assert int(got.step) == int(want["step"]) == SIGTERM_AFTER
    assert int(got.opt.step) == int(want["opt_step"])
    assert flat.keys() == {k for k in want if "//" in k}
    for k, v in flat.items():
        np.testing.assert_array_equal(np.asarray(v), want[k], err_msg=k)


def test_port_reads_a_jax_sharded_set(tmp_path):
    """The JAX package's set with sharded leaves (FSDP placement on a
    2-device mesh, saved with force_sharded=True): the port reassembles it
    bit for bit."""
    import jax

    from neighborretr_tpu.core import checkpoint as jckpt
    from neighborretr_tpu.parallel import mesh as jmesh
    from neighborretr_tpu_torch.core import checkpoint as ckpt
    jstate, tstate = _tiny_states()
    mesh = jmesh.make_mesh(num_devices=2)
    jstate = jstate._replace(params=jmesh.place_params(jstate.params, mesh,
                                                       fsdp=True))
    jckpt.save_sharded_train_state(str(tmp_path), jstate, force_sharded=True)
    with np.load(tmp_path / "state_preempt.shard0.npz") as f:
        assert any(k.startswith("shdata") for k in f.files)
    got = _port_flat(ckpt.load_sharded_train_state(
        str(tmp_path / "state_preempt.manifest.json"), tstate))
    host = jax.device_get(jstate)
    for name, tree in (("params", host.params), ("opt_m", host.opt.m),
                       ("opt_v", host.opt.v), ("bank", host.bank._asdict())):
        for k, v in jckpt.flatten_tree(tree).items():
            np.testing.assert_array_equal(got[f"{name}//{k}"], np.asarray(v),
                                          err_msg=k)


def test_sharded_set_checks_and_stale_shards(tmp_path):
    """A set with a missing shard or skewed steps does not resume; a save
    by fewer processes removes the larger group's extra shard files."""
    from neighborretr_tpu_torch.core import checkpoint as ckpt
    from neighborretr_tpu_torch.parallel import mesh as pmesh
    _, tstate = _tiny_states()
    out = str(tmp_path)
    for rank in range(3):
        ckpt.save_sharded_train_state(out, tstate,
                                      mesh=pmesh.DataGroup(rank=rank, world=3))
    manifest = os.path.join(out, "state_preempt.manifest.json")
    assert ckpt.latest_resumable(out) == manifest
    os.remove(os.path.join(out, "state_preempt.shard2.npz"))
    assert ckpt.latest_resumable(out) is None
    with pytest.raises(ValueError, match="incomplete"):
        ckpt.load_sharded_train_state(manifest, tstate)
    tstate.step = 1
    ckpt.save_sharded_train_state(out, tstate,
                                  mesh=pmesh.DataGroup(rank=1, world=2))
    tstate.step = 2
    ckpt.save_sharded_train_state(out, tstate,
                                  mesh=pmesh.DataGroup(rank=0, world=2))
    assert ckpt.latest_resumable(out) is None          # steps 2 and 1
    ckpt.save_sharded_train_state(out, tstate,
                                  mesh=pmesh.DataGroup(rank=1, world=2))
    assert ckpt.latest_resumable(out) == manifest
    assert sorted(f for f in os.listdir(out) if "shard" in f) == [
        "state_preempt.shard0.npz", "state_preempt.shard1.npz"]


def test_init_distributed_flag_validation():
    """↔ tests/test_multiprocess.py: the three rendezvous flags together
    or not at all, the rank in range; all None is a no-op."""
    from neighborretr_tpu_torch.cli.common import init_distributed
    ns = argparse.Namespace(coordinator="localhost:1", num_processes=None,
                            process_id=0, device="cpu")
    with pytest.raises(SystemExit, match="together"):
        init_distributed(ns)
    ns = argparse.Namespace(coordinator="localhost:1", num_processes=2,
                            process_id=5, device="cpu")
    with pytest.raises(SystemExit, match="out of range"):
        init_distributed(ns)
    assert init_distributed(argparse.Namespace(
        coordinator=None, num_processes=None, process_id=None)) is False


@pytest.mark.parametrize("flags, says", [
    (["--num_devices", "2", "--batch_size", "7"],
     "batch_size 7 not divisible by device count 2"),
    (["--num_devices", "2", "--num_processes", "3"], "does not cover"),
    (["--num_devices", "0"], "requested 0 devices"),
    (["--num_devices", "2", "--explicit_spmd", "--micro_batches", "2"],
     "micro_batches applies to the GSPMD path"),
    (["--num_devices", "2", "--fsdp", "--tensor_parallel", "2"],
     "--fsdp applies to pure data-parallel meshes"),
    (["--num_devices", "2", "--tensor_parallel", "3"],
     "--tensor_parallel 3 must divide the device count 2"),
    (["--num_devices", "2", "--pipeline_parallel", "2", "--explicit_spmd"],
     "pipeline_parallel nests shard_map and cannot combine with "
     "explicit_spmd"),
])
def test_train_cli_flag_exits(tmp_path, flags, says):
    """Exits with the reason before any rank starts."""
    out = str(tmp_path / "refused")
    rc, text = _finish(_train(out, *flags))
    assert rc != 0 and says in text, text[-2000:]
    assert not os.path.exists(out)


def test_eval_cli_two_ranks_match_one(runs):
    """The eval CLI on the best weights over 28 pairs (the last batch
    padded): two ranks give one rank's R@K."""
    d, _ = runs
    got = []
    for n in ("1", "2"):
        rc, out = _finish(_start([
            sys.executable, "-m", "neighborretr_tpu_torch.cli.eval",
            "--device", "cpu", "--datatype", "synthetic", "--tiny",
            "--checkpoint", os.path.join(d["one"], "best.npz"),
            "--max_words", "8", "--max_frames", "4", "--batch_size_val", "8",
            "--synthetic_size", "28", "--workers", "0", "--num_devices", n]))
        assert rc == 0, out[-3000:]
        got.append([ln.split("INFO ")[1] for ln in out.splitlines()
                    if "R@1" in ln])
    assert len(got[0]) == 3 and got[0] == got[1]


def test_index_cli_two_devices_matches_jax_mesh(runs, tmp_path):
    """cli.index --num_devices 2 (each encode batch split over the CPU
    twice) against the JAX build_video_index over a 2-device mesh, from the
    same checkpoint: the ids equal, the fp16 features within 2e-3."""
    import dataclasses as dc

    import jax

    from neighborretr_tpu import serving as jserving
    from neighborretr_tpu.core import checkpoint as jckpt
    from neighborretr_tpu.core import config as jc
    from neighborretr_tpu.data.datasets.synthetic import SyntheticDataset
    from neighborretr_tpu.data.loader import BatchLoader
    from neighborretr_tpu.models import neighborretr as jm
    from neighborretr_tpu.parallel import mesh as jmesh
    d, _ = runs
    best = os.path.join(d["one"], "best.npz")
    out = str(tmp_path / "idx.npz")
    rc, text = _finish(_start([
        sys.executable, "-m", "neighborretr_tpu_torch.cli.index",
        "--datatype", "synthetic", "--tiny", "--device", "cpu",
        "--checkpoint", best, "--max_words", "8", "--max_frames", "4",
        "--batch_size", "4", "--synthetic_size", "10", "--workers", "0",
        "--num_devices", "2", "--out", out]))
    assert rc == 0, text[-3000:]
    assert "Encoding data-parallel over 2 devices" in text
    m = jc.ModelConfig.tiny(max_words=8, max_frames=4)
    with np.load(best) as f:
        m = dc.replace(m, clip=dc.replace(
            m.clip, vocab_size=int(f["clip//text//token_embedding"].shape[0])))
    params = jckpt.load_params(best, jax.device_get(
        jm.init_params(jax.random.PRNGKey(0), m)))
    ds = SyntheticDataset(n=10, seed=2, max_words=8, max_frames=4,
                          resolution=m.clip.image_resolution,
                          vocab_size=m.clip.vocab_size)
    want = jserving.build_video_index(
        params, jc.Config(model=m), BatchLoader(ds, 4, pad_to_batch=True,
                                                workers=1),
        mesh=jmesh.make_mesh(num_devices=2))
    with np.load(out) as f:
        got = {k: f[k] for k in f.files}
    assert list(got["video_ids"]) == list(want["video_ids"])
    np.testing.assert_allclose(got["v_feat"].astype(np.float32),
                               want["v_feat"].astype(np.float32), atol=2e-3)
    np.testing.assert_array_equal(got["v_mask"], want["v_mask"])


if __name__ == "__main__":
    if sys.argv[1] == "sigterm":
        torch.set_num_threads(1)
        sigterm_worker(int(sys.argv[2]), sys.argv[3:])
