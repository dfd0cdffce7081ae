"""Shared by the port's model-sharded tests (test_torch_tensor_parallel.py,
test_torch_pipeline.py, test_torch_fsdp.py): the narrow configuration, the
batches, the JAX package's one-device trajectory, the gloo ranks, and one
strategy's bank fill and three steps in a rank.

The narrow configuration has two heads a tower (widths 128, head dim 64),
two layers in each of the three towers, fp32 and `cluster_noise=False`,
built identically from either package's dataclasses.  `max_grad_norm` is
0.05, far below the raw global norms (~10^3), so the clip binds at every
step and a wrong norm shows.
"""

import dataclasses as dc
import hashlib
import os
import socket
import subprocess
import sys

import numpy as np
import torch

B, MB_BATCH, T_TOTAL, STEPS = 8, 2, 10, 3
LOSS_KEYS = ("loss", "centrality_loss", "uniform_loss", "neighbor_loss",
             "kl_loss")
MAX_GRAD_NORM = 0.05
SPAWN_TIMEOUT = 400
FILL, STEP_SEEDS = range(10, 10 + MB_BATCH), range(20, 20 + STEPS)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_config(mod, width=128, **train):
    """The narrow configuration from either package's dataclasses (`width`
    / 64 heads a tower)."""
    clip = dc.replace(mod.ClipConfig.tiny(), vision_width=width,
                      transformer_width=width, embed_dim=width)
    model = mod.ModelConfig(clip=clip, max_words=8, max_frames=4,
                            temporal_layers=2, compute_dtype="float32",
                            cluster_noise=False)
    return mod.Config(
        model=model, loss=mod.LossConfig(num_neighbors=3),
        optim=mod.OptimizerConfig(lr=1e-2, coef_lr=0.1,
                                  max_grad_norm=MAX_GRAD_NORM),
        data=mod.DataConfig(max_words=8, max_frames=4),
        train=mod.TrainConfig(batch_size=B, mb_batch=MB_BATCH, **train))


def batches(m, seeds):
    from neighborretr_tpu_torch.data.datasets.synthetic import \
        make_synthetic_batch
    out = []
    for s in seeds:
        b = make_synthetic_batch(m, B, seed=s)
        b["video_mask"][1, 2:] = 0            # padded frames too
        b["idx"] = b["idx"] + 100 * s
        out.append(b)
    return out


def jax_trajectory(width=128, **train):
    """The JAX package's bank fill and three steps on one device → (the
    initial parameters as the port's state dict, the reference)."""
    import jax
    import jax.numpy as jnp

    from neighborretr_tpu.core import checkpoint as jckpt
    from neighborretr_tpu.core import config as jc
    from neighborretr_tpu.models import neighborretr as jm
    from neighborretr_tpu.train import memory_bank as jmb
    from neighborretr_tpu.train import step as jstep
    from neighborretr_tpu_torch.core import config as tc
    from neighborretr_tpu_torch.models import weights_io as W

    jcfg, tcfg = (make_config(jc, width, **train),
                  make_config(tc, width, **train))
    assert dc.asdict(jcfg.model) == dc.asdict(tcfg.model)
    params = jm.init_params(jax.random.PRNGKey(0), jcfg.model)
    init = W.from_jax_params(jax.device_get(params), tcfg.model).state_dict()
    m = jcfg.model
    bank = jmb.create(jcfg.train.memory_bank_capacity, m.max_words,
                      m.max_frames, m.width)
    for i, b in enumerate(batches(tcfg.model, FILL)):
        bank = jstep.fill_bank_step(params, bank,
                                    jax.tree.map(jnp.asarray, b), jcfg, i * B)
    filled = jax.device_get(bank)
    state = jstep.create_train_state(params, bank)
    metrics = []
    for i, b in enumerate(batches(tcfg.model, STEP_SEEDS)):
        state, met = jstep.train_step(state, jax.tree.map(jnp.asarray, b),
                                      jax.random.PRNGKey(i), jcfg, T_TOTAL)
        metrics.append(jax.device_get(met))
    state = jax.device_get(state)
    return init, dict(filled=filled, metrics=metrics, bank=state.bank,
                      params=jckpt.flatten_tree(state.params))


def held_to_jax(r, ref, loss_rtol=1e-4, param_atol=1e-4, bank_atol=1e-4):
    """A rank's bank fill, three steps' metrics, parameters and bank
    against the JAX trajectory."""
    for got, want in zip(r["filled"], ref["filled"]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert len(r["metrics"]) == len(ref["metrics"]) == STEPS
    for got, want in zip(r["metrics"], ref["metrics"]):
        assert float(want["grad_norm"]) > 100 * MAX_GRAD_NORM  # clip binds
        for k in LOSS_KEYS + ("grad_norm", "logit_scale"):
            assert np.isfinite(got[k]), k
            np.testing.assert_allclose(got[k], float(want[k]),
                                       rtol=loss_rtol, err_msg=k)
    assert r["params"].keys() == ref["params"].keys()
    for k, want in ref["params"].items():
        got = r["params"][k]
        assert np.isfinite(got).all(), k
        assert np.abs(got - want).max() <= param_atol, \
            (k, np.abs(got - want).max())
    for got, want in zip(r["bank"], ref["bank"]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=bank_atol)


def _digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def train_case(cfg, mesh, init_sd):
    """In a rank: place the model from `init_sd` on `mesh`, fill the bank
    and take three steps on this rank's blocks of the global batches →
    the rank's results (full parameters in the JAX layout, metrics, bank,
    digests of its replicated and of all its local tensors, its parameter
    and moment element counts)."""
    from neighborretr_tpu_torch.core import checkpoint as ckpt
    from neighborretr_tpu_torch.models import weights_io as W
    from neighborretr_tpu_torch.parallel import mesh as pmesh
    from neighborretr_tpu_torch.train import memory_bank as tmb
    from neighborretr_tpu_torch.train import step as tstep

    m = cfg.model
    model = W.init_model(m, 1 + mesh.rank, "cpu")   # differs until placed
    if mesh.rank == 0:
        model.load_state_dict(init_sd)
    pmesh.place_params(model, mesh, fsdp=cfg.train.fsdp)
    bank = tmb.create(cfg.train.memory_bank_capacity, m.max_words,
                      m.max_frames, m.width)
    for i, b in enumerate(batches(m, FILL)):
        bank = tstep.fill_bank_step(
            model, bank, tstep.to_device(pmesh.batch_block(b, mesh), "cpu"),
            cfg, i * B, mesh=mesh)
    out = {"filled": [t.clone() for t in bank], "metrics": []}
    state = tstep.create_train_state(model, bank)
    for b in batches(m, STEP_SEEDS):
        state, met = tstep.train_step(
            state, tstep.to_device(pmesh.batch_block(b, mesh), "cpu"), cfg,
            T_TOTAL, mesh=mesh)
        out["metrics"].append({k: v.item() for k, v in met.items()})
    placement = pmesh.placement_of(model)
    local = {n: pmesh.local(p) for n, p in model.named_parameters()}

    def replicated(n):
        pl = placement.params[n] if placement else None
        return pl is None or not (pl.tp or pl.fsdp or pl.stage is not None)

    out.update(
        params=ckpt.flatten_tree(ckpt.params_tree(model)),
        bank=[t.clone() for t in state.bank],
        steps=(state.step, state.opt.step),
        replicated_digest=_digest(t for n, t in local.items()
                                  if replicated(n)),
        local_digest=_digest(local.values()),
        coords={a: mesh.coord(a) for a in mesh.axis_names},
        param_count=sum(t.numel() for t in local.values()),
        moment_count=sum(t.numel() for t in state.opt.m.values())
        + sum(t.numel() for t in state.opt.v.values()))
    return out


def full_counts(cfg):
    """{parameter name: element count} of the unsharded model."""
    from neighborretr_tpu_torch.models import weights_io as W
    return {n: p.numel() for n, p in
            W.init_model(cfg.model, 0, "cpu").named_parameters()}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(script: str, world: int, *args):
    """`world` gloo ranks of `script` (run as a program: rank, world,
    port, args...)."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, script, str(r), str(world), str(port), *args],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def join(procs):
    for p in procs:
        try:
            out, _ = p.communicate(timeout=SPAWN_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, out[-4000:]


def init_rank(rank: int, world: int, port: int):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)


def once_per_session(tmp_path_factory, name: str, make):
    """`make()`'s result, computed once per test session.  Under
    pytest-xdist a module's tests may run on several workers, each of which
    would build the module's fixtures again; here the first worker to ask
    computes it under a file lock and saves it beside the workers'
    temporary directories, and the others load what it saved."""
    if os.environ.get("PYTEST_XDIST_WORKER") is None:
        return make()
    import filelock
    path = tmp_path_factory.getbasetemp().parent / f"{name}.pt"
    with filelock.FileLock(f"{path}.lock"):
        if path.exists():
            return torch.load(path, weights_only=False)
        out = make()
        torch.save(out, path)
        return out


def load_ranks(work: str, world: int):
    return [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]
