"""The port's FSDP2 placement (parallel/mesh.py) against the JAX package,
and the model-sharded strategies through the CLIs, on the CPU.

Spawned once, all at the same time:
- four gloo ranks of this file: FSDP2 over 4 data ranks in the narrow fp32
  configuration of tests/torch_sharded_common.py (two heads a tower, the
  clip binding): the bank fill and three steps against the JAX
  `train_step` on the whole global batch on one device (loss terms 1e-4
  relative, every parameter 1e-4 absolute, the bank 1e-4), the replicated
  logit scale bit-equal on every rank, each rank's parameter and moment
  counts its dim-0 chunks'; then a JAX FSDP sharded set (written on a
  2-device mesh with its shard boxes) read into the FSDP-placed state,
  bit for bit;
- the train CLI over two ranks (`--num_devices 2`) under `--fsdp` and
  under `--pipeline_parallel 2`, and one rank, in the tiny configuration;
  and under `--fsdp` with a SIGTERM on rank 0 after step 3;
- the train CLI under `--tensor_parallel 2` over two ranks launched by
  hand (`--coordinator`), and one rank, in the narrow configuration (the
  tiny one has one head a tower, which tp = 2 cannot split: each process
  swaps `ModelConfig.tiny` for the narrow one before it runs the CLI);
  and, in the four ranks, a TP-placed state (data 2 x model 2, one step)
  saved as a sharded set.
Then: each CLI run's losses at every step against the one-rank run within
1e-4 relative, its R@K equal; `--resume auto` after the FSDP SIGTERM
equal to the unbroken FSDP run bit for bit; the JAX package's reader
reassembling the port's FSDP and TP sharded sets bit for bit (the port
reads them the same); `cli.eval --tensor_parallel 2` giving the one-rank
R@K.
"""

import dataclasses as dc
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_sharded_common as C  # noqa: E402

WORLD = 4
CLI = ["--device", "cpu", "--datatype", "synthetic", "--batch_size", "8",
       "--batch_size_val", "8", "--max_words", "8", "--max_frames", "4",
       "--mb_batch", "2", "--synthetic_size", "16", "--n_display", "1",
       "--num_neighbors", "3", "--workers", "0", "--epochs", "2",
       "--mid_epoch_eval", "0"]
SIGTERM_AFTER = 3          # mid-epoch 1 of 2 steps an epoch
CLI_LOSS_KEYS = C.LOSS_KEYS + ("grad_norm",)


def narrow_tiny(max_words: int = 8, max_frames: int = 4,
                temporal_layers: int = 2):
    """ModelConfig.tiny with two heads a tower (the narrow widths)."""
    from neighborretr_tpu_torch.core import config as tc
    return dc.replace(C.make_config(tc).model, max_words=max_words,
                      max_frames=max_frames, cluster_noise=True,
                      temporal_layers=min(temporal_layers, 2))


def cli_worker(module: str, sigterm: int, narrow: bool, argv) -> None:
    """A CLI's main in this process, with `narrow` the narrow tiny
    configuration in place; with `sigterm`, SIGTERM to itself after that
    global step."""
    import importlib

    from neighborretr_tpu_torch.core import config as tc
    from neighborretr_tpu_torch.train import loop
    if narrow:
        tc.ModelConfig.tiny = staticmethod(narrow_tiny)
    if sigterm:
        real = loop.train_step

        def step(state, *a, **kw):
            state, met = real(state, *a, **kw)
            if state.step == sigterm:
                os.kill(os.getpid(), signal.SIGTERM)
            return state, met

        loop.train_step = step
    out = importlib.import_module(f"neighborretr_tpu_torch.cli.{module}"
                                  ).main(argv)
    rank = argv[argv.index("--process_id") + 1] if "--process_id" in argv \
        else "0"
    if module == "eval" and rank == "0":
        with open(os.environ["EVAL_OUT"], "w") as f:
            json.dump(out, f)


def _jax_fsdp_set(out: str):
    """A JAX train state of the narrow model with FSDP placement on a
    2-device mesh, saved as a sharded set with its shard boxes → the flat
    arrays it holds."""
    import jax

    from neighborretr_tpu.core import checkpoint as jckpt
    from neighborretr_tpu.core import config as jc
    from neighborretr_tpu.models import neighborretr as jm
    from neighborretr_tpu.parallel import mesh as jmesh
    from neighborretr_tpu.train import memory_bank as jmb
    from neighborretr_tpu.train import step as jstep
    cfg = C.make_config(jc)
    m = cfg.model
    state = jstep.create_train_state(
        jm.init_params(jax.random.PRNGKey(7), m),
        jmb.create(cfg.train.memory_bank_capacity, m.max_words,
                   m.max_frames, m.width))
    state = state._replace(opt=state.opt._replace(m=jax.tree.map(
        lambda p: p * 0.5, state.params)), step=5)
    mesh = jmesh.make_mesh(num_devices=2)
    state = state._replace(params=jmesh.place_params(state.params, mesh,
                                                     fsdp=True))
    jckpt.save_sharded_train_state(out, state, force_sharded=True)
    host = jax.device_get(state)
    flat = {}
    for name, tree in (("params", host.params), ("opt_m", host.opt.m),
                       ("opt_v", host.opt.v)):
        flat.update({f"{name}//{k}": np.asarray(v)
                     for k, v in jckpt.flatten_tree(tree).items()})
    return flat


def worker(rank: int, world: int, port: int, work: str) -> None:
    from neighborretr_tpu_torch.core import checkpoint as ckpt
    from neighborretr_tpu_torch.core import config as tc
    from neighborretr_tpu_torch.models import weights_io as W
    from neighborretr_tpu_torch.parallel import mesh as pmesh
    from neighborretr_tpu_torch.train import memory_bank as tmb
    from neighborretr_tpu_torch.train import step as tstep

    C.init_rank(rank, world, port)
    init_sd = torch.load(os.path.join(work, "init.pt"))
    cfg = C.make_config(tc, fsdp=True)
    mesh = pmesh.make_mesh("cpu")
    out = {"fsdp": C.train_case(cfg, mesh, init_sd)}
    # the JAX FSDP set into an FSDP-placed state
    model = W.init_model(cfg.model, 0, "cpu")
    pmesh.place_params(model, mesh, fsdp=True)
    m = cfg.model
    state = tstep.create_train_state(model, tmb.create(
        cfg.train.memory_bank_capacity, m.max_words, m.max_frames, m.width))
    state = ckpt.load_sharded_train_state(
        os.path.join(work, "jax_set", "state_preempt.manifest.json"), state)
    out["jax_set"] = {k: v for k, v in ckpt.train_state_payload(
        state).items() if not k.startswith("bank")}
    # a TP sharded set: the narrow model on data 2 x model 2 after one step
    cfg = C.make_config(tc)
    model = W.init_model(cfg.model, 3, "cpu")
    tp = pmesh.make_mesh("cpu", (2, 2), ("data", "model"))
    pmesh.place_params(model, tp)
    state = tstep.create_train_state(model, tmb.create(
        cfg.train.memory_bank_capacity, m.max_words, m.max_frames, m.width))
    state, _ = tstep.train_step(state, tstep.to_device(pmesh.batch_block(
        C.batches(m, [30])[0], tp), "cpu"), cfg, C.T_TOTAL, mesh=tp)
    ckpt.save_sharded_train_state(os.path.join(work, "tp_set"), state,
                                  mesh=tp)
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    import torch.distributed as dist
    dist.destroy_process_group()


def _env(**extra):
    return dict(os.environ, PYTHONPATH=C.ROOT, OMP_NUM_THREADS="1", **extra)


def _start(cmd, **env):
    return subprocess.Popen(cmd, cwd=C.ROOT, env=_env(**env), text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _train(out, *extra):
    return [_start([sys.executable, "-m", "neighborretr_tpu_torch.cli.train",
                    *CLI, "--output_dir", out, *extra])]


def _by_hand(module, world, argv, sigterm=0, **env):
    """`world` ranks of a CLI launched by hand, each through cli_worker."""
    if world == 1:
        return [_start([sys.executable, os.path.abspath(__file__), "cli",
                        module, "0", "1", *argv], **env)]
    port = C.free_port()
    return [_start([sys.executable, os.path.abspath(__file__), "cli", module,
                    str(sigterm if r == 0 else 0), "1", *argv,
                    "--coordinator",
                    f"localhost:{port}", "--num_processes", str(world),
                    "--process_id", str(r)], **env) for r in range(world)]


def _finish(procs):
    outs = []
    for p in procs:
        try:
            text, _ = p.communicate(timeout=C.SPAWN_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, text))
    return outs


def _rows(out, kind):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["kind"] == kind]


def _npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("fsdp"))
    d = {k: str(tmp_path_factory.mktemp(k)) for k in (
        "one", "fsdp", "pp", "cut", "tp_one", "tp")}
    init, ref = C.jax_trajectory()
    torch.save(init, os.path.join(work, "init.pt"))
    jax_flat = _jax_fsdp_set(os.path.join(work, "jax_set"))
    narrow = lambda out: CLI + ["--output_dir", out]          # noqa: E731
    procs = {
        "ranks": C.spawn(os.path.abspath(__file__), WORLD, work),
        "one": _train(d["one"], "--num_devices", "1"),
        "fsdp": _train(d["fsdp"], "--num_devices", "2", "--fsdp"),
        "pp": _train(d["pp"], "--num_devices", "2", "--pipeline_parallel",
                     "2", "--pipeline_microbatches", "2"),
        "cut": [_start([sys.executable, os.path.abspath(__file__), "cli",
                        "train", str(SIGTERM_AFTER), "0", *CLI,
                        "--output_dir",
                        d["cut"], "--num_devices", "2", "--fsdp"])],
        "tp_one": _by_hand("train", 1, narrow(d["tp_one"])),
        "tp": _by_hand("train", 2, narrow(d["tp"]) + [
            "--tensor_parallel", "2"]),
    }
    done = {k: _finish(p) for k, p in procs.items()}
    for k, outs in done.items():
        for rc, text in outs:
            assert rc == 0, (k, text[-4000:])
    # after the runs: the FSDP resume, and the TP eval against one rank
    resumed = _finish(_train(d["cut"], "--num_devices", "2", "--fsdp",
                             "--resume", "auto"))
    evals = {}
    for name, world, extra in (("one", 1, []),
                               ("tp", 2, ["--tensor_parallel", "2"])):
        path = os.path.join(work, f"eval_{name}.json")
        argv = ["--device", "cpu", "--datatype", "synthetic", "--tiny",
                "--checkpoint", os.path.join(d["tp_one"], "best.npz"),
                "--max_words", "8", "--max_frames", "4", "--batch_size_val",
                "8", "--synthetic_size", "16", "--workers", "0", *extra]
        for rc, text in _finish(_by_hand("eval", world, argv,
                                         EVAL_OUT=path)):
            assert rc == 0, (name, text[-4000:])
        with open(path) as f:
            evals[name] = json.load(f)
    d["tp_set"] = os.path.join(work, "tp_set")
    return dict(work=work, d=d, done=done, resumed=resumed, evals=evals,
                ref=ref, jax_flat=jax_flat,
                ranks=C.load_ranks(work, WORLD))


def test_fsdp_steps_match_jax_train_step(runs):
    for r in runs["ranks"]:
        C.held_to_jax(r["fsdp"], runs["ref"])
        assert r["fsdp"]["steps"] == (C.STEPS, C.STEPS)


def test_fsdp_ranks_agree_and_hold_their_chunks(runs):
    """The replicated logit scale and the metrics bit-equal on every rank;
    each rank holds its dim-0 chunk of every other parameter
    (torch.chunk's sizes over 4 ranks) and moments of the same shapes —
    about a quarter of the model."""
    from neighborretr_tpu_torch.core import config as tc
    from neighborretr_tpu_torch.models import weights_io as W
    rs = [r["fsdp"] for r in runs["ranks"]]
    assert len({r["replicated_digest"] for r in rs}) == 1
    assert len({r["local_digest"] for r in rs}) == WORLD
    for r in rs[1:]:
        assert r["metrics"] == rs[0]["metrics"]
    model = W.init_model(C.make_config(tc).model, 0, "cpu")
    total = sum(p.numel() for p in model.parameters())
    for rank, r in enumerate(rs):
        want = sum(p.numel() if p.dim() == 0 else
                   (torch.chunk(p, WORLD, 0)[rank].numel()
                    if rank < len(torch.chunk(p, WORLD, 0)) else 0)
                   for p in model.parameters())
        assert r["param_count"] == want and r["moment_count"] == 2 * want
        assert abs(want / total - 1 / WORLD) < 0.02


def test_fsdp_state_reads_a_jax_fsdp_set(runs):
    for r in runs["ranks"]:
        got = r["jax_set"]
        for k, want in runs["jax_flat"].items():
            np.testing.assert_array_equal(got[k], want, err_msg=k)


@pytest.mark.parametrize("run, ref", [("fsdp", "one"), ("pp", "one"),
                                      ("tp", "tp_one")])
def test_train_cli_two_ranks_match_one(runs, run, ref):
    d = runs["d"]
    want, got = _rows(d[ref], "train"), _rows(d[run], "train")
    assert [r["step"] for r in got] == [r["step"] for r in want] == \
        [1, 2, 3, 4]
    for a, b in zip(got, want):
        for k in CLI_LOSS_KEYS:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)
    ev1, ev2 = _rows(d[ref], "eval"), _rows(d[run], "eval")
    assert len(ev1) == len(ev2) > 0
    for a, b in zip(ev1, ev2):
        assert a["t2v"] == b["t2v"] and a["v2t"] == b["v2t"]
    for name in ("best.npz", "state_epoch1.npz"):
        a, b = _npz(os.path.join(d[ref], name)), _npz(os.path.join(d[run],
                                                                   name))
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(b[k], a[k], atol=1e-4, err_msg=k)


def test_fsdp_sigterm_then_resume_equals_unbroken(runs):
    d = runs["d"]
    cut = d["cut"]
    manifest = os.path.join(cut, "state_preempt.manifest.json")
    assert [r["step"] for r in _rows(cut, "train")] == [1, 2, 4]
    rc, out = runs["resumed"][0]
    assert rc == 0, out[-3000:]
    assert f"resuming from {manifest}" in out
    want = _npz(os.path.join(d["fsdp"], "state_epoch1.npz"))
    got = _npz(os.path.join(cut, "state_epoch1.npz"))
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _jax_state_like(narrow: bool):
    import jax

    from neighborretr_tpu.core import config as jc
    from neighborretr_tpu.models import neighborretr as jm
    from neighborretr_tpu.train import memory_bank as jmb
    from neighborretr_tpu.train import step as jstep
    m = (dc.replace(C.make_config(jc).model, cluster_noise=True) if narrow
         else jc.ModelConfig.tiny(max_words=8, max_frames=4))
    return jstep.create_train_state(jm.init_params(jax.random.PRNGKey(9), m),
                                    jmb.create(16, 8, 4, m.width))


def _port_state_like(narrow: bool):
    from neighborretr_tpu_torch.core import config as tc
    from neighborretr_tpu_torch.models import weights_io as W
    from neighborretr_tpu_torch.train import memory_bank as tmb
    from neighborretr_tpu_torch.train import step as tstep
    m = narrow_tiny() if narrow else tc.ModelConfig.tiny(max_words=8,
                                                         max_frames=4)
    return tstep.create_train_state(W.init_model(m, 5, "cpu"),
                                    tmb.create(16, 8, 4, m.width))


@pytest.mark.parametrize("run, narrow, world, step", [
    ("cut", False, 2, SIGTERM_AFTER), ("tp_set", True, WORLD, 1)])
def test_jax_reads_the_ports_sharded_sets(runs, run, narrow, world, step):
    """The sets written under FSDP (the CLI's SIGTERM) and TP (data 2 x
    model 2, one step): the leaves gathered and written whole by process 0,
    the others' files holding the step, which reassemble in the JAX
    package's reader as in the port's, bit for bit."""
    from neighborretr_tpu.core import checkpoint as jckpt
    from neighborretr_tpu_torch.core import checkpoint as ckpt
    out = runs["d"][run]
    manifest = os.path.join(out, "state_preempt.manifest.json")
    for r in range(world):
        with np.load(os.path.join(out, f"state_preempt.shard{r}.npz")) as f:
            assert any(k.startswith("full//") for k in f.files) == (r == 0)
    want = ckpt.train_state_payload(ckpt.load_sharded_train_state(
        manifest, _port_state_like(narrow)))
    got = jckpt.load_sharded_train_state(manifest, _jax_state_like(narrow))
    flat = {}
    for name, tree in (("params", got.params), ("opt_m", got.opt.m),
                       ("opt_v", got.opt.v), ("bank", got.bank._asdict())):
        flat.update({f"{name}//{k}": v
                     for k, v in jckpt.flatten_tree(tree).items()})
    assert int(got.step) == int(want["step"]) == step
    assert flat.keys() == {k for k in want if "//" in k}
    for k, v in flat.items():
        np.testing.assert_array_equal(np.asarray(v), want[k], err_msg=k)


def test_eval_cli_tensor_parallel_gives_one_rank_recall(runs):
    assert runs["evals"]["tp"] == runs["evals"]["one"]


if __name__ == "__main__":
    if sys.argv[1] == "cli":
        cli_worker(sys.argv[2], int(sys.argv[3]), sys.argv[4] == "1",
                   sys.argv[5:])
    else:
        worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
               sys.argv[4])
