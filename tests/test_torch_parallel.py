"""The port's data parallelism (parallel/mesh.py, parallel/spmd.py, the
data-group train step, sharded serving) against the JAX package, on the CPU.

Two gloo processes of the port (this file run as a script, one process a
rank) take each its block of the same global batches, with the tiny config
in fp32 and `cluster_noise=False`:
- the gathered form: bank fill and three optimizer steps against the JAX
  `train_step` on the whole global batch in one device: every parameter
  within 1e-4 absolute, the loss terms within 1e-4 relative, the bank
  within 1e-4 (the bars of tests/test_torch_train_step.py);
- the explicit form: its losses and averaged gradients against the JAX
  `compute_losses_spmd` on a 2-device virtual mesh (loss terms 1e-4
  relative; gradients 1e-4 absolute + 1e-3 relative, as the two packages'
  fp32 sums order differently), then three steps against the JAX
  `train_step` at the gathered form's bars;
- the parameters after the steps bit-equal across the ranks;
- under sim_dtype="bfloat16" and use_pallas="on" (the port's plain bf16
  forms on the CPU) the explicit form against the JAX explicit form's
  steps on the 2-device mesh, its Pallas kernels in interpret mode, and
  against the port's gathered form, both at the gathered form's bars
  against JAX; both forms away from float32.
Sharded serving runs in one process over ["cpu", "cpu"] against the JAX
package's Searcher and index on a 2-device mesh.
"""

import dataclasses as dc
import hashlib
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

B, MB_BATCH, T_TOTAL, STEPS, WORLD = 8, 2, 10, 3, 2
LOSS_KEYS = ("loss", "centrality_loss", "uniform_loss", "neighbor_loss",
             "kl_loss")
SPAWN_TIMEOUT = 300


def make_config(mod, explicit=False, sim_dtype="float32"):
    """The same configuration from either package's dataclasses; in bf16
    with use_pallas="on" (the similarity kernels on both sides)."""
    model = dc.replace(mod.ModelConfig.tiny(max_words=8, max_frames=4),
                       cluster_noise=False, sim_dtype=sim_dtype,
                       use_pallas="on" if sim_dtype == "bfloat16"
                       else "auto")
    return mod.Config(
        model=model, loss=mod.LossConfig(num_neighbors=3),
        optim=mod.OptimizerConfig(lr=1e-2, coef_lr=0.1),
        data=mod.DataConfig(max_words=8, max_frames=4),
        train=mod.TrainConfig(batch_size=B, mb_batch=MB_BATCH,
                              explicit_spmd=explicit))


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


FILL, STEP_SEEDS = range(10, 10 + MB_BATCH), range(20, 20 + STEPS)


def _flat_jax_layout(sd, cfg):
    from neighborretr_tpu_torch.core import checkpoint as ckpt
    from neighborretr_tpu_torch.models import weights_io as W
    return ckpt.flatten_tree(W.to_jax_params(sd, cfg))


def worker(form: str, rank: int, port: int, work: str) -> None:
    """One rank: the all-gather check, the bank fill, (explicit form) one
    loss + gradient evaluation, three steps; results to work/rank{r}.pt."""
    import torch.distributed as dist

    from neighborretr_tpu_torch.core import config as tc
    from neighborretr_tpu_torch.models import weights_io as W
    from neighborretr_tpu_torch.parallel import mesh as pmesh
    from neighborretr_tpu_torch.parallel.spmd import compute_losses_spmd
    from neighborretr_tpu_torch.train import memory_bank as tmb
    from neighborretr_tpu_torch.train import step as tstep

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=WORLD, rank=rank)
    mesh = pmesh.make_mesh("cpu")
    out = {}
    # the gather and its backward: L = sum(c · gather(x)) on every rank
    x = (torch.arange(6.0).reshape(3, 2) + 10 * rank).requires_grad_(True)
    c = torch.arange(12.0).reshape(6, 2) ** 2
    y = pmesh.all_gather(x, mesh)
    (y * c).sum().backward()
    out["gather"], out["gather_grad"] = y.detach(), x.grad

    cfg = make_config(tc, explicit=form.startswith("explicit"),
                      sim_dtype="bfloat16" if form.endswith("bf16")
                      else "float32")
    m = cfg.model
    model = W.init_model(m, 1 + rank, "cpu")      # differs until replicated
    if rank == 0:
        model.load_state_dict(torch.load(os.path.join(work, "init.pt")))
    pmesh.replicate(model, mesh)
    bank = tmb.create(cfg.train.memory_bank_capacity, m.max_words,
                      m.max_frames, m.width)
    for i, b in enumerate(batches(m, FILL)):
        bank = tstep.fill_bank_step(
            model, bank, tstep.to_device(pmesh.batch_block(b, mesh), "cpu"),
            cfg, i * B, mesh=mesh)
    out["filled"] = [t.clone() for t in bank]
    steps = batches(m, STEP_SEEDS)
    state = tstep.create_train_state(model, bank)
    if form == "explicit":
        local = tstep.to_device(pmesh.batch_block(steps[0], mesh), "cpu")
        total, aux = compute_losses_spmd(model, cfg, local, bank, None, mesh)
        total.backward()
        params = dict(model.named_parameters())
        grads = pmesh.all_reduce_grads(params, mesh)
        out["spmd_losses"] = {k: aux[k].item() for k in LOSS_KEYS}
        out["spmd_grads"] = _flat_jax_layout(grads, m)
        model.zero_grad(set_to_none=True)
    out["metrics"] = []
    for b in steps:
        state, met = tstep.train_step(
            state, tstep.to_device(pmesh.batch_block(b, mesh), "cpu"), cfg,
            T_TOTAL, mesh=mesh)
        out["metrics"].append({k: v.item() for k, v in met.items()})
    out["params"] = _flat_jax_layout(model.state_dict(), m)
    out["hash"] = hashlib.sha256(b"".join(
        p.detach().numpy().tobytes() for p in model.parameters())).hexdigest()
    out["bank"] = [t.clone() for t in state.bank]
    out["steps"] = (state.step, state.opt.step)
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn_pair(form: str, work: str):
    port = _free_port()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), form, str(r), str(port),
         work], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]


def _join(procs):
    for p in procs:
        try:
            out, _ = p.communicate(timeout=SPAWN_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, out[-3000:]


def _interpret_pallas(mp):
    """The JAX package's similarity kernels in interpret mode (its model
    calls them without `interpret`, which only a TPU compiles)."""
    from neighborretr_tpu.ops import pallas_similarity as ps
    from neighborretr_tpu.ops import pallas_similarity_blocked as psb
    for mod, name in ((ps, "pallas_interaction_similarity"),
                      (ps, "pallas_interaction_mean"),
                      (psb, "pallas_interaction_similarity_blocked")):
        real = getattr(mod, name)

        def interpreted(*a, _real=real, **kw):
            return _real(*a, **dict(kw, interpret=True))
        mp.setattr(mod, name, interpreted)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both forms' rank pairs in float32 and bfloat16 (eight processes at
    once) and the JAX package's one-device trajectory, explicit-form
    gradients and explicit-form trajectory in bfloat16."""
    import jax
    import jax.numpy as jnp

    from neighborretr_tpu.core import config as jc
    from neighborretr_tpu.models import neighborretr as jm
    from neighborretr_tpu.parallel import mesh as jmesh
    from neighborretr_tpu.parallel.spmd import compute_losses_spmd
    from neighborretr_tpu.train import memory_bank as jmb
    from neighborretr_tpu.train import step as jstep
    from neighborretr_tpu_torch.core import config as tc
    from neighborretr_tpu_torch.models import weights_io as W

    jcfg, tcfg = make_config(jc), make_config(tc)
    params = jm.init_params(jax.random.PRNGKey(0), jcfg.model)
    model = W.from_jax_params(jax.device_get(params), tcfg.model)
    work = {}
    procs = []
    for form in ("gathered", "explicit", "gathered_bf16", "explicit_bf16"):
        work[form] = str(tmp_path_factory.mktemp(form))
        torch.save(model.state_dict(), os.path.join(work[form], "init.pt"))
        procs += _spawn_pair(form, work[form])

    m = jcfg.model
    fill = batches(tcfg.model, FILL)
    steps = batches(tcfg.model, STEP_SEEDS)
    jbank = jmb.create(jcfg.train.memory_bank_capacity, m.max_words,
                       m.max_frames, m.width)
    for i, b in enumerate(fill):
        jbank = jstep.fill_bank_step(params, jbank, jax.tree.map(
            jnp.asarray, b), jcfg, i * B)
    filled = jax.device_get(jbank)

    # the JAX explicit form on a 2-device mesh, at the filled bank
    mesh = jmesh.make_mesh(num_devices=WORLD)
    key = jax.random.PRNGKey(3)
    sharded = jmesh.shard_batch(jax.tree.map(jnp.asarray, steps[0]), mesh)
    bank_r = jmb.MemoryBank(*jmesh.replicate_tree(tuple(jbank), mesh))
    (_, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: compute_losses_spmd(p, jcfg, sharded, bank_r, key, mesh),
        has_aux=True))(jmesh.replicate_tree(params, mesh))

    # the JAX explicit form's steps in bfloat16 on the same mesh, from host
    # copies (the steps donate their state)
    bcfg = make_config(jc, explicit=True, sim_dtype="bfloat16")
    bstate = jstep.create_train_state(
        jmesh.replicate_tree(jax.device_get(params), mesh),
        jmb.MemoryBank(*jmesh.replicate_tree(filled, mesh)))
    bmetrics = []
    with pytest.MonkeyPatch.context() as mp:
        _interpret_pallas(mp)
        for i, b in enumerate(steps):
            bstate, met = jstep.train_step(
                bstate, jmesh.shard_batch(jax.tree.map(jnp.asarray, b), mesh),
                jax.random.PRNGKey(i), bcfg, T_TOTAL, mesh=mesh)
            bmetrics.append(jax.device_get(met))
    bstate = jax.device_get(bstate)

    jstate = jstep.create_train_state(params, jbank)
    jmetrics = []
    for i, b in enumerate(steps):
        jstate, met = jstep.train_step(jstate, jax.tree.map(jnp.asarray, b),
                                       jax.random.PRNGKey(i), jcfg, T_TOTAL)
        jmetrics.append(jax.device_get(met))
    _join(procs)
    ranks = {form: [torch.load(os.path.join(work[form], f"rank{r}.pt"),
                               weights_only=False) for r in range(WORLD)]
             for form in work}
    from neighborretr_tpu.core import checkpoint as jckpt
    jstate = jax.device_get(jstate)
    return dict(ranks=ranks, filled=filled,
                jax=dict(metrics=jmetrics, bank=jstate.bank,
                         params=jckpt.flatten_tree(jstate.params)),
                jax_explicit_bf16=dict(
                    metrics=bmetrics, bank=bstate.bank,
                    params=jckpt.flatten_tree(bstate.params)),
                jaux={k: float(jaux[k]) for k in LOSS_KEYS},
                jgrads=jckpt.flatten_tree(jax.device_get(jgrads)))


def _held_to_jax(r, runs, ref="jax"):
    """A rank's record against the JAX trajectory `runs[ref]`."""
    want_run = runs[ref]
    for got, want in zip(r["filled"], runs["filled"]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert len(r["metrics"]) == len(want_run["metrics"]) == STEPS
    for got, want in zip(r["metrics"], want_run["metrics"]):
        for k in LOSS_KEYS + ("grad_norm", "logit_scale"):
            assert np.isfinite(got[k]), k
            np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-4,
                                       err_msg=k)
    assert r["params"].keys() == want_run["params"].keys()
    for k, want in want_run["params"].items():
        got = r["params"][k]
        assert np.isfinite(got).all(), k
        assert np.abs(got - want).max() <= 1e-4, (k, np.abs(got - want).max())
    for got, want in zip(r["bank"], want_run["bank"]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert r["steps"] == (STEPS, STEPS)


def test_gathered_form_matches_jax_train_step(runs):
    _held_to_jax(runs["ranks"]["gathered"][0], runs)


def test_explicit_form_matches_jax_compute_losses_spmd(runs):
    r = runs["ranks"]["explicit"][0]
    for k in LOSS_KEYS:
        np.testing.assert_allclose(r["spmd_losses"][k], runs["jaux"][k],
                                   rtol=1e-4, err_msg=k)
    assert r["spmd_grads"].keys() == runs["jgrads"].keys()
    moved = 0
    for k, want in runs["jgrads"].items():
        got = r["spmd_grads"][k]
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4,
                                   err_msg=k)
        moved += bool(np.abs(want).max() > 0)
    assert moved > len(runs["jgrads"]) // 2


def test_explicit_form_steps_match_jax_train_step(runs):
    _held_to_jax(runs["ranks"]["explicit"][0], runs)


def test_explicit_form_in_bfloat16_matches_jax_explicit_steps(runs):
    """sim_dtype="bfloat16", use_pallas="on": the explicit form's bank rows
    (K2 and K5's plain bf16 forms) against the JAX explicit form's Pallas
    kernels in interpret mode with compute_dtype="bfloat16", three steps
    at the gathered form's bars against JAX."""
    _held_to_jax(runs["ranks"]["explicit_bf16"][0], runs, "jax_explicit_bf16")


def test_explicit_form_matches_gathered_form_in_bfloat16(runs):
    """sim_dtype="bfloat16": the explicit form's bank rows (K2 and K5's
    plain bf16 forms) against the gathered form's bank centralities (K4's),
    at the bars both forms meet against JAX in float32; both away from
    their float32 runs."""
    got = runs["ranks"]["explicit_bf16"][0]
    want = runs["ranks"]["gathered_bf16"][0]
    for a, b in zip(got["metrics"], want["metrics"]):
        for k in LOSS_KEYS + ("grad_norm",):
            assert np.isfinite(a[k]), k
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)
    for k, w in want["params"].items():
        assert np.abs(got["params"][k] - w).max() <= 1e-4, k
    for a, b in zip(got["bank"], want["bank"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4)
    for form in ("gathered", "explicit"):
        bf, f32 = (runs["ranks"][form + s][0]["metrics"][-1]
                   for s in ("_bf16", ""))
        assert bf["neighbor_loss"] != f32["neighbor_loss"], form


@pytest.mark.parametrize("form", ["gathered", "explicit"])
def test_ranks_end_bit_equal(runs, form):
    """The same all-reduced gradients into the same BertAdam: the ranks'
    parameters, bank and metrics agree to the bit."""
    r0, r1 = runs["ranks"][form]
    assert r0["hash"] == r1["hash"]
    for a, b in zip(r0["bank"], r1["bank"]):
        assert torch.equal(a, b)
    assert r0["metrics"] == r1["metrics"]


def test_all_gather_forward_and_backward_are_exact(runs):
    """Forward: the ranks' rows in rank order.  Backward: the cotangent
    summed over the ranks, then the rank's rows — W·c for L = sum(c·y) on
    every rank (the mean of the parameter gradients divides the W out)."""
    c = torch.arange(12.0).reshape(6, 2) ** 2
    want = torch.cat([torch.arange(6.0).reshape(3, 2) + 10 * r
                      for r in range(WORLD)])
    for rank, r in enumerate(runs["ranks"]["gathered"]):
        assert torch.equal(r["gather"], want)
        assert torch.equal(r["gather_grad"],
                           WORLD * c[3 * rank:3 * (rank + 1)])


def _one_rank_inputs():
    from neighborretr_tpu_torch.core import config as tc
    from neighborretr_tpu_torch.models import weights_io as W
    from neighborretr_tpu_torch.train import memory_bank as tmb
    from neighborretr_tpu_torch.train import step as tstep
    cfg = make_config(tc, explicit=True)
    m = cfg.model
    model = W.init_model(m, 0, "cpu")
    bank = tmb.create(cfg.train.memory_bank_capacity, m.max_words,
                      m.max_frames, m.width)
    return cfg, model, tstep.to_device(batches(m, [1])[0], "cpu"), bank


def test_explicit_spmd_rejects_multi_axis_mesh():
    """↔ tests/test_spmd.py: a hybrid (replica, data) group would encode
    the batch once per replica and sum the gradients over all of it."""
    from neighborretr_tpu_torch.parallel import mesh as pmesh
    from neighborretr_tpu_torch.parallel.spmd import compute_losses_spmd
    cfg, model, batch, bank = _one_rank_inputs()
    hybrid = pmesh.DataGroup(world=8, axis_names=("replica", "data"))
    with pytest.raises(ValueError, match="1-D"):
        compute_losses_spmd(model, cfg, batch, bank, None, hybrid)


def test_explicit_spmd_rejects_wrong_axis_name():
    from neighborretr_tpu_torch.parallel import mesh as pmesh
    from neighborretr_tpu_torch.parallel.spmd import compute_losses_spmd
    with pytest.raises(ValueError, match="data_axis"):
        compute_losses_spmd(None, None, {}, None, None, pmesh.DataGroup(),
                            axis="batch")


def test_one_process_group_is_the_single_device_step():
    """Without torch.distributed a data group is the identity: the step on
    it, explicit_spmd set or not, is the single-device step to the bit."""
    from neighborretr_tpu_torch.parallel import mesh as pmesh
    from neighborretr_tpu_torch.train import step as tstep
    cfg, model, batch, bank = _one_rank_inputs()
    start = {k: v.clone() for k, v in model.state_dict().items()}
    got = []
    for mesh in (None, pmesh.make_mesh("cpu")):
        model.load_state_dict(start)
        state = tstep.create_train_state(model, bank)
        for _ in range(2):
            state, met = tstep.train_step(state, batch, cfg, T_TOTAL,
                                          mesh=mesh)
        got.append(([v.clone() for v in model.state_dict().values()],
                    {k: v.item() for k, v in met.items()}))
    assert got[0][1] == got[1][1]
    assert all(torch.equal(a, b) for a, b in zip(got[0][0], got[1][0]))


def test_video_keep_refused_on_a_multi_process_group():
    """↔ the JAX extract_features: each process would keep other rows;
    evaluate() encodes every row and selects after instead."""
    from neighborretr_tpu_torch.parallel import mesh as pmesh
    from neighborretr_tpu_torch.train.evaluate import extract_features
    cfg, model, *_ = _one_rank_inputs()
    two = pmesh.DataGroup(world=2, collective=True)
    with pytest.raises(ValueError, match="single-process"):
        extract_features(model, cfg, [], video_keep=np.arange(3), mesh=two)


def test_fsdp_and_device_requests_raise():
    """place_params(fsdp=True) places (one data rank: nothing to shard,
    the model as it was); on a mesh with a `model` axis it raises as the
    JAX package's does."""
    from neighborretr_tpu_torch.models import weights_io as W
    from neighborretr_tpu_torch.parallel import mesh as pmesh
    cfg, *_ = _one_rank_inputs()
    model = W.init_model(cfg.model, 0, "cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert pmesh.place_params(model, pmesh.DataGroup(), fsdp=True) is model
    assert pmesh.placement_of(model) is None
    assert all(torch.equal(v, before[k])
               for k, v in model.state_dict().items())
    tp_mesh = pmesh.DataGroup(world=4, axis_names=("data", "model"),
                              shape=(2, 2))
    with pytest.raises(ValueError, match="pure data-parallel meshes"):
        pmesh.place_params(model, tp_mesh, fsdp=True)
    assert pmesh.take_devices(3, "cpu") == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="refusing to silently run"):
        pmesh.take_devices(torch.cuda.device_count() + 1, "cuda")
    one = pmesh.make_mesh("cpu")          # no process group: one rank
    assert (one.rank, one.world, one.collective) == (0, 1, False)


def test_device_augment_rank_blocks_take_the_global_draws():
    """Each rank's block of clips gets the draws it gets in one process
    over the whole batch: the blocks of two ranks, each drawing from a
    generator in the same state, concatenate to the one-process result."""
    from neighborretr_tpu_torch.ops.device_augment import augment_batch
    g = torch.Generator().manual_seed(3)
    video = torch.randint(0, 256, (4, 2, 16, 16, 3), generator=g,
                          dtype=torch.uint8)
    mask = torch.ones(4, 2)
    mask[1, 1] = 0
    policy = "rand-m7-n4-mstd0.5-inc1"

    def gen():
        return torch.Generator().manual_seed(11)

    whole = augment_batch(video, mask, gen(), policy)
    blocks = [augment_batch(video[2 * r:2 * r + 2], mask[2 * r:2 * r + 2],
                            gen(), policy, rank=r, world=2) for r in range(2)]
    assert torch.equal(torch.cat(blocks), whole)
    assert not torch.equal(whole, video)


def _serving_models():
    import jax

    from neighborretr_tpu.core import config as jc
    from neighborretr_tpu.models import neighborretr as jm
    from neighborretr_tpu_torch.core import config as tc
    from neighborretr_tpu_torch.models import weights_io as W
    jm_cfg = jc.ModelConfig.tiny(max_words=8, max_frames=4)
    tm_cfg = tc.ModelConfig.tiny(max_words=8, max_frames=4)
    params = jax.device_get(jm.init_params(jax.random.PRNGKey(0), jm_cfg))
    return (jc.Config(model=jm_cfg), params, tc.Config(model=tm_cfg),
            W.from_jax_params(params, tm_cfg))


class _Tok:
    """Whitespace tokens onto the tiny 512-entry vocabulary."""

    def tokenize(self, text):
        return text.split()

    def convert_tokens_to_ids(self, tokens):
        special = {"<|startoftext|>": 1, "<|endoftext|>": 2}
        return [special.get(t, 3 + sum(map(ord, t)) % 500) for t in tokens]


def test_sharded_index_and_searcher_match_jax_mesh():
    """build_video_index and the Searcher over ["cpu", "cpu"] against the
    JAX package's over a 2-device mesh: 11 videos (one pad row in the
    second shard), fp16 and int8.  Features within 2e-3 (an fp16 ulp at
    their size), scores within 1e-4 of the JAX ones and bit-equal to one
    shard's, the top-5 ids the JAX ones."""
    from neighborretr_tpu import serving as jserving
    from neighborretr_tpu.data.datasets.synthetic import \
        SyntheticDataset as JSynthetic
    from neighborretr_tpu.data.loader import BatchLoader as JLoader
    from neighborretr_tpu.parallel import mesh as jmesh
    from neighborretr_tpu_torch import serving as pserving
    from neighborretr_tpu_torch.data.datasets.synthetic import \
        SyntheticDataset
    from neighborretr_tpu_torch.data.loader import BatchLoader

    jcfg, params, tcfg, model = _serving_models()
    kw = dict(n=11, max_words=8, max_frames=4, resolution=32,
              vocab_size=jcfg.model.clip.vocab_size, seed=2)
    mesh = jmesh.make_mesh(num_devices=2)
    want = jserving.build_video_index(
        params, jcfg, JLoader(JSynthetic(**kw), 4, pad_to_batch=True,
                              workers=1), mesh=mesh)
    got = pserving.build_video_index(
        model, tcfg, BatchLoader(SyntheticDataset(**kw), 4, pad_to_batch=True,
                                 workers=1), devices=["cpu", "cpu"])
    assert list(got["video_ids"]) == list(want["video_ids"])
    np.testing.assert_allclose(got["v_feat"].astype(np.float32),
                               want["v_feat"].astype(np.float32), atol=2e-3)
    queries = ["a dog runs", "red car", "man cooking", "b"]
    for dtype in ("float16", "int8"):
        idx = dict(got)
        if dtype == "int8":
            idx["v_feat"], idx["v_scale"] = pserving.quantize_features(
                got["v_feat"].astype(np.float32))
        ref = jserving.Searcher(params, jcfg, idx, _Tok(), query_batch=2,
                                mesh=mesh)
        one = pserving.Searcher(model, tcfg, idx, _Tok(), query_batch=2)
        two = pserving.Searcher(model, tcfg, idx, _Tok(), query_batch=2,
                                devices=["cpu", "cpu"],
                                staged_upload_rows=2)
        assert len(two._shards) == 2 and two._shards[1][1].feat.shape[0] == 6
        assert (one.corpus_preparations, two.corpus_preparations) == (1, 2)
        np.testing.assert_array_equal(two.similarities(queries),
                                      one.similarities(queries))
        np.testing.assert_allclose(two.similarities(queries),
                                   ref.similarities(queries), atol=1e-4)
        hits, jhits = two.search(queries, topk=5), ref.search(queries, topk=5)
        assert hits == one.search(queries, topk=5)
        assert (one.corpus_preparations, two.corpus_preparations) == (1, 2)
        for h, j in zip(hits, jhits):
            assert [v for v, _ in h] == [v for v, _ in j]
            np.testing.assert_allclose([s for _, s in h], [s for _, s in j],
                                       atol=1e-4)


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
