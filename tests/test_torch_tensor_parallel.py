"""The port's Megatron tensor parallelism and hybrid mesh (parallel/mesh.py,
parallel/tensor.py) against the JAX package, on the CPU.

Four gloo processes of the port (this file run as a program, one process a
rank), spawned once, run in turn, each from the same initial weights as
the JAX package and on its blocks of the same global batches, in the
narrow fp32 configuration of tests/torch_sharded_common.py (two heads a
tower, the clip binding):
- TP on data 2 × model 2 (the plain einsum route: fp32 has no kernel
  route) and the hybrid (replica 2, data 2) mesh: the bank fill and three
  steps against the JAX `train_step` on the whole global batch on one
  device (loss terms 1e-4 relative, every parameter 1e-4 absolute, the
  bank 1e-4), and TP also against the JAX package's own TP form on its
  virtual (2, 2) CPU mesh; the replicated parameters bit-equal on all
  ranks, the split ones on the ranks of one model coordinate; each rank's
  parameter and moment counts those of its shards;
- the TP block on the block route (K10/K11's plain versions) and on the
  fused route (K8/K9's), in bf16, against the JAX package's unsplit
  block_apply on the same route (its Pallas kernels in interpret mode):
  output, input and parameter gradients within 2e-2 in norm, five bf16
  ulps; in fp32 the fused and einsum routes against its einsum route
  within 1e-5;
- the eval over the TP mesh: the one-process R@K;
- uneven heads: three gloo ranks on data 1 × model 3 with the narrow
  configuration (two heads a tower: model rank 2 holds none and launches
  no attention; the 512-wide MLP splits 171 / 171 / 170) against the same
  one-device JAX trajectory (the JAX package's own TP form refuses this
  placement: its device_put needs 128 divisible by 3), and its eval; two
  ranks on model 2 with a 192-wide configuration (three heads a tower:
  2 / 1; the MLP 384 / 384) against that width's one-device JAX
  trajectory and the JAX package's TP form on its (1, 2) mesh (GSPMD
  cuts the 192 columns 96 / 96 and reshards the split head), and its
  eval; an uneven checkpoint crossing
  both ways: a JAX-written train state loaded into the (1, 3) placement
  gives back the file's arrays, and the sharded set that placement writes
  after a step reads in the JAX package as in the port.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_sharded_common as C  # noqa: E402

WORLD = 4
TP = ("tp", (2, 2), ("data", "model"))
# the uneven cases: (world, mesh shape, width)
UNEVEN = {"uneven3": (3, (1, 3), 128), "uneven2": (2, (1, 2), 192)}
HYBRID = ("hybrid", (2, 2), ("replica", "data"))
BF16_RTOL = 2e-2


BLOCK_D, BLOCK_H = 128, 2
# the routes of the TP block, with the route of the JAX block_apply that
# holds each: in fp32 the JAX package's kernel routes round inside their
# Pallas kernels (3e-4 off its own einsum route here), so the fp32 function
# is held to the JAX einsum route
ROUTES = {"bfloat16 block": "block", "bfloat16 True": True,
          "float32 True": False, "float32 False": False}


def _block_case():
    """One 128-wide, two-head block's weights (torch layout), its input
    (bf16-representable), a per-sample bias and an output cotangent, from a
    seed: the same in every process."""
    from neighborretr_tpu_torch.models.layers import ResidualAttentionBlock

    g = torch.Generator().manual_seed(5)
    full = ResidualAttentionBlock(BLOCK_D, BLOCK_H)
    with torch.no_grad():
        for p in full.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
        full.ln_1.weight.add_(1.0)
        full.ln_2.weight.add_(1.0)
    x = torch.randn(4, 8, BLOCK_D, generator=g).bfloat16().float()
    bias = torch.where(torch.rand(4, 8, 8, generator=g) > 0.2, 0.0, -1e9)
    bias[:, :, 0] = 0.0
    dy = torch.randn(4, 8, BLOCK_D, generator=g)
    return full, x, bias, dy


def _block_routes(mesh):
    """The TP block and the unsplit one, on CPU tensors (the kernels' plain
    versions), with a per-sample bias: on the block and fused routes in
    bf16, on the fused and einsum routes in fp32 → per route, each one's
    output, input gradient and (local) parameter gradients."""
    from neighborretr_tpu_torch.models.layers import ResidualAttentionBlock
    from neighborretr_tpu_torch.parallel import mesh as pmesh
    from neighborretr_tpu_torch.parallel.tensor import shard_params_tp

    full, x, bias, dy = _block_case()
    box = torch.nn.Module()
    box.block = ResidualAttentionBlock(BLOCK_D, BLOCK_H)
    box.block.load_state_dict(full.state_dict())
    params = {n: pmesh.Placement(tuple(p.shape))
              for n, p in box.named_parameters()}
    shard_params_tp(box, mesh, params)
    out = {"coord": mesh.coord("model")}
    for key in ROUTES:
        dtype = getattr(torch, key.split()[0])
        route = {"block": "block", "True": True, "False": False}[
            key.split()[1]]
        for which, blk in (("unsplit", full), ("tp", box.block)):
            blk.zero_grad(set_to_none=True)
            xi = x.to(dtype).clone().requires_grad_(True)
            y = blk(xi, bias, dtype, fused_attention=route)
            y.float().backward(dy)
            out[key, which] = dict(
                y=y.detach().float(), gx=xi.grad.float(),
                gp={n: p.grad.float() for n, p in blk.named_parameters()})
    return out


def _jax_block_routes():
    """The JAX package's block_apply on the same weights, input, bias and
    cotangent, on each reference route of ROUTES (its Pallas kernels in
    interpret mode) → {(dtype name, route): (y, dx, {torch name:
    gradient})}."""
    import jax
    import jax.numpy as jnp

    from neighborretr_tpu.models import layers as JL
    from neighborretr_tpu_torch.models import weights_io as W

    full, x, bias, dy = _block_case()
    sd = {f"b.0.{k}": v.numpy() for k, v in full.state_dict().items()}
    p = jax.tree.map(lambda a: jnp.asarray(a[0]), W._blocks_tree(sd, "b", 1))
    jb = jnp.asarray(bias.numpy())[:, None]
    out = {}
    for key, route in ROUTES.items():
        name = key.split()[0]
        dtype = jnp.dtype(name)
        if (name, route) in out:
            continue

        def f(p, x):
            return JL.block_apply(p, x, BLOCK_H, jb, dtype,
                                  fused_attention=route).astype(jnp.float32)

        y, vjp = jax.vjp(f, p, jnp.asarray(x.numpy()).astype(dtype))
        gp, gx = vjp(jnp.asarray(dy.numpy()))
        grads = {}
        W._block_sd(jax.tree.map(lambda a: np.asarray(a, np.float32)[None],
                                 gp), 0, "b", grads)
        out[name, route] = (np.asarray(y), np.asarray(gx, np.float32),
                             {k[2:]: v for k, v in grads.items()})
    return out


def _tp_part(name, full, coord, tp=2):
    """A model rank's part of a full torch-layout block tensor, cut here
    independently of the port's placement code: rows of each of q, k and v
    for the packed in-projection, rows of c_fc, columns of out_proj and
    c_proj; the rest whole."""
    d = BLOCK_D // tp
    if name.startswith("attn.in_proj"):
        q = full.reshape(3, BLOCK_D, -1)[:, coord * d:(coord + 1) * d]
        return q.reshape((3 * d,) + full.shape[1:])
    if name.startswith("mlp.c_fc"):
        n = full.shape[0] // tp
        return full[coord * n:(coord + 1) * n]
    if name in ("attn.out_proj.weight", "mlp.c_proj.weight"):
        n = full.shape[1] // tp
        return full[:, coord * n:(coord + 1) * n]
    return full


def _eval_case(cfg, mesh, init_sd):
    """R@K of the eval over `mesh` with the TP placement, and of one
    process with the whole model, on the same synthetic test set."""
    from neighborretr_tpu_torch.data.datasets.synthetic import \
        SyntheticDataset
    from neighborretr_tpu_torch.data.loader import BatchLoader
    from neighborretr_tpu_torch.models import weights_io as W
    from neighborretr_tpu_torch.parallel import mesh as pmesh
    from neighborretr_tpu_torch.train.evaluate import evaluate

    m = cfg.model
    ds = SyntheticDataset(n=12, seed=2, max_words=m.max_words,
                          max_frames=m.max_frames,
                          resolution=m.clip.image_resolution,
                          vocab_size=m.clip.vocab_size)
    got = []
    for on_mesh in (True, False):
        model = W.init_model(m, 0, "cpu")
        model.load_state_dict(init_sd)
        if on_mesh:
            pmesh.place_params(model, mesh)
        loader = BatchLoader(ds, 4, shuffle=False, drop_last=False,
                             workers=0, pad_to_batch=True,
                             process_index=mesh.dp_rank if on_mesh else 0,
                             process_count=mesh.dp_size if on_mesh else 1)
        got.append(evaluate(model, cfg, loader, dataset=ds,
                            mesh=mesh if on_mesh else None))
    return got


def _checkpoint_case(cfg, mesh, work):
    """A JAX-written train state read into `mesh`'s placement (its payload
    gathered back), then one step and the sharded set the placement
    writes."""
    from neighborretr_tpu_torch.core import checkpoint as ckpt
    from neighborretr_tpu_torch.models import weights_io as W
    from neighborretr_tpu_torch.parallel import mesh as pmesh
    from neighborretr_tpu_torch.train import memory_bank as tmb
    from neighborretr_tpu_torch.train import step as tstep

    m = cfg.model
    model = W.init_model(m, 5, "cpu")
    pmesh.place_params(model, mesh)
    state = tstep.create_train_state(model, tmb.create(
        cfg.train.memory_bank_capacity, m.max_words, m.max_frames, m.width))
    state = ckpt.load_train_state(os.path.join(work, "jax_state.npz"), state)
    loaded = ckpt.train_state_payload(state)
    state, _ = tstep.train_step(state, tstep.to_device(pmesh.batch_block(
        C.batches(m, [30])[0], mesh), "cpu"), cfg, C.T_TOTAL, mesh=mesh)
    ckpt.save_sharded_train_state(os.path.join(work, "uneven_set"), state,
                                  mesh=mesh)
    return {"loaded": loaded, "stepped": ckpt.train_state_payload(state)}


def _rank_heads(cfg, mesh):
    """(n_head, this rank's heads, its c_fc rows) of every block."""
    from neighborretr_tpu_torch.models import weights_io as W
    from neighborretr_tpu_torch.models.layers import ResidualAttentionBlock
    from neighborretr_tpu_torch.parallel import mesh as pmesh
    model = pmesh.place_params(W.init_model(cfg.model, 0, "cpu"), mesh)
    return [(b.n_head, b.tp_heads, b.mlp.c_fc.weight.shape[0])
            for b in model.modules()
            if isinstance(b, ResidualAttentionBlock)]


def uneven_worker(rank: int, world: int, port: int, work: str,
                  mode: str) -> None:
    from neighborretr_tpu_torch.core import config as tc
    from neighborretr_tpu_torch.parallel import mesh as pmesh

    C.init_rank(rank, world, port)
    _, shape, width = UNEVEN[mode]
    init_sd = torch.load(os.path.join(work, "init.pt"))
    cfg = C.make_config(tc, width)
    mesh = pmesh.make_mesh("cpu", shape, ("data", "model"))
    out = {"train": C.train_case(cfg, mesh, init_sd),
           "eval": _eval_case(cfg, mesh, init_sd),
           "heads": _rank_heads(cfg, mesh)}
    if mode == "uneven3":
        out["checkpoint"] = _checkpoint_case(cfg, mesh, work)
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    import torch.distributed as dist
    dist.destroy_process_group()


def worker(rank: int, world: int, port: int, work: str) -> None:
    from neighborretr_tpu_torch.core import config as tc
    from neighborretr_tpu_torch.parallel import mesh as pmesh

    C.init_rank(rank, world, port)
    init_sd = torch.load(os.path.join(work, "init.pt"))
    cfg = C.make_config(tc)
    out = {}
    for name, shape, axes in (TP, HYBRID):
        out[name] = C.train_case(cfg, pmesh.make_mesh("cpu", shape, axes),
                                 init_sd)
    tp = pmesh.make_mesh("cpu", *TP[1:])
    out["routes"] = _block_routes(tp)
    out["eval"] = _eval_case(cfg, tp, init_sd)
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    import torch.distributed as dist
    dist.destroy_process_group()


def _jax_tp_trajectory(shape=(2, 2), width=128):
    """The JAX package's TP form: the same steps on its `shape` data ×
    model mesh of virtual CPU devices."""
    import jax
    import jax.numpy as jnp

    from neighborretr_tpu.core import checkpoint as jckpt
    from neighborretr_tpu.core import config as jc
    from neighborretr_tpu.models import neighborretr as jm
    from neighborretr_tpu.parallel import mesh as jmesh
    from neighborretr_tpu.train import memory_bank as jmb
    from neighborretr_tpu.train import step as jstep

    jcfg = C.make_config(jc, width)
    mesh = jmesh.make_tp_mesh(shape)
    params = jmesh.place_params(
        jm.init_params(jax.random.PRNGKey(0), jcfg.model), mesh)
    m = jcfg.model
    bank = jmb.MemoryBank(*jmesh.replicate_tree(tuple(jmb.create(
        jcfg.train.memory_bank_capacity, m.max_words, m.max_frames,
        m.width)), mesh))
    for i, b in enumerate(C.batches(m, C.FILL)):
        bank = jstep.fill_bank_step(params, bank, jmesh.shard_batch(
            jax.tree.map(jnp.asarray, b), mesh), jcfg, i * C.B)
    state = jstep.create_train_state(params, bank)
    metrics = []
    for i, b in enumerate(C.batches(m, C.STEP_SEEDS)):
        state, met = jstep.train_step(
            state, jmesh.shard_batch(jax.tree.map(jnp.asarray, b), mesh),
            jax.random.PRNGKey(i), jcfg, C.T_TOTAL, mesh=mesh)
        metrics.append(jax.device_get(met))
    host = jax.device_get(state)
    return dict(metrics=metrics,
                params=jckpt.flatten_tree(host.params))


def _jax_state_file(path: str):
    """A JAX train state of the narrow model (moments set apart from the
    parameters, step 5) saved as one npz → its flat arrays."""
    import jax

    from neighborretr_tpu.core import checkpoint as jckpt
    from neighborretr_tpu.core import config as jc
    from neighborretr_tpu.models import neighborretr as jm
    from neighborretr_tpu.train import memory_bank as jmb
    from neighborretr_tpu.train import step as jstep
    cfg = C.make_config(jc)
    m = cfg.model
    state = jstep.create_train_state(
        jm.init_params(jax.random.PRNGKey(9), m),
        jmb.create(cfg.train.memory_bank_capacity, m.max_words,
                   m.max_frames, m.width))
    state = state._replace(
        opt=state.opt._replace(
            m=jax.tree.map(lambda p: p * 0.5, state.params),
            v=jax.tree.map(lambda p: p * p, state.params)), step=5)
    jckpt.save_train_state(path, state)
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("tp"))
    init, ref = C.jax_trajectory()
    torch.save(init, os.path.join(work, "init.pt"))
    procs = C.spawn(os.path.abspath(__file__), WORLD, work)
    uneven = {}
    for mode, (world, _, width) in UNEVEN.items():
        d = str(tmp_path_factory.mktemp(mode))
        if width == 128:
            torch.save(init, os.path.join(d, "init.pt"))
            jax_file = _jax_state_file(os.path.join(d, "jax_state.npz"))
        else:
            wide_init, wide_ref = C.jax_trajectory(width)
            torch.save(wide_init, os.path.join(d, "init.pt"))
        uneven[mode] = (d, C.spawn(os.path.abspath(__file__), world, d,
                                   mode))
    jax_tp = _jax_tp_trajectory()
    jax_tp_wide = _jax_tp_trajectory((1, 2), 192)
    jax_blocks = _jax_block_routes()
    C.join(procs)
    for d, p in uneven.values():
        C.join(p)
    return dict(ranks=C.load_ranks(work, WORLD), ref=ref, jax_tp=jax_tp,
                jax_blocks=jax_blocks, jax_tp_wide=jax_tp_wide, wide_ref=wide_ref,
                jax_file=jax_file, uneven_set=os.path.join(
                    uneven["uneven3"][0], "uneven_set"),
                uneven={mode: C.load_ranks(d, UNEVEN[mode][0])
                        for mode, (d, _) in uneven.items()})


@pytest.mark.parametrize("case", ["tp", "hybrid"])
def test_steps_match_jax_train_step(runs, case):
    for r in runs["ranks"]:
        C.held_to_jax(r[case], runs["ref"])
        assert r[case]["steps"] == (C.STEPS, C.STEPS)


def test_tp_matches_jax_tp_form(runs):
    """The port's TP against the JAX package's GSPMD TP on (2, 2)."""
    want = runs["jax_tp"]
    got = runs["ranks"][0]["tp"]
    for a, b in zip(got["metrics"], want["metrics"]):
        for k in C.LOSS_KEYS + ("grad_norm",):
            np.testing.assert_allclose(a[k], float(b[k]), rtol=1e-4,
                                       err_msg=k)
    for k, v in want["params"].items():
        assert np.abs(got["params"][k] - v).max() <= 1e-4, k


@pytest.mark.parametrize("case", ["tp", "hybrid"])
def test_ranks_agree_bit_for_bit(runs, case):
    """Replicated parameters bit-equal on every rank; a split parameter's
    shard bit-equal on the ranks of one model coordinate; the metrics and
    the bank the same everywhere."""
    rs = [r[case] for r in runs["ranks"]]
    assert len({r["replicated_digest"] for r in rs}) == 1
    by_model = {}
    for r in rs:
        by_model.setdefault(r["coords"].get("model", 0), set()).add(
            r["local_digest"])
    assert all(len(d) == 1 for d in by_model.values())
    for r in rs[1:]:
        assert r["metrics"] == rs[0]["metrics"]
        assert all(torch.equal(a, b) for a, b in zip(r["bank"], rs[0]["bank"]))


def test_tp_shard_counts(runs):
    """Each rank holds half of every split matrix and bias and all of the
    rest: its parameter count is split/2 + replicated, and its moments
    twice that (↔ tests/test_sharding.py's per-device bytes); the hybrid
    mesh holds everything everywhere."""
    import re

    from neighborretr_tpu_torch.core import config as tc
    from neighborretr_tpu_torch.parallel.tensor import TP_SPLITS
    counts = C.full_counts(C.make_config(tc))
    total = sum(counts.values())
    split = sum(n for k, n in counts.items()
                if re.sub(r"^.*\.resblocks\.\d+\.", "", k) in TP_SPLITS
                and ".resblocks." in k)
    assert split > total / 2
    for r in runs["ranks"]:
        assert r["tp"]["param_count"] == total - split // 2
        assert r["tp"]["moment_count"] == 2 * (total - split // 2)
        assert r["hybrid"]["param_count"] == total


def _nrel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_tp_block_routes_match_unsplit(runs):
    """The TP block against the JAX package's unsplit block_apply on the
    same weights: on the block route (K10/K11's plain versions on the
    rank's heads, a zero b_o, the fp32 partial sums all-reduced) against
    JAX's fused_attention="block" (its Pallas sublayer kernel), and on the
    fused route (K8/K9's plain versions on H/tp heads) against JAX's
    fused_attention=True, both in bf16; in fp32 the fused and einsum routes
    against JAX's einsum route.  Output, input gradient and every
    parameter gradient (the rank's part), each in norm relative to JAX's:
    bf16 ≤ 2e-2, five bf16 ulps (2^-8), about twice what the port's
    unsplit block shows against JAX (up to 9e-3, a bias gradient), which
    is held to the same bar as the witness; a halved or misplaced gradient
    shows as ≥ 0.5.  fp32 ≤ 1e-5."""
    ref = runs["jax_blocks"]
    for r in runs["ranks"]:
        got = r["routes"]
        for key, route in ROUTES.items():
            dtype = key.split()[0]
            y, gx, gp = ref[dtype, route]
            tol = BF16_RTOL if dtype == "bfloat16" else 1e-5
            for which in ("unsplit", "tp"):
                d = got[key, which]
                coord = got["coord"] if which == "tp" else 0
                tp = 2 if which == "tp" else 1
                errs = {"y": _nrel(d["y"], y), "gx": _nrel(d["gx"], gx)}
                assert d["gp"].keys() == gp.keys()
                for n, g in gp.items():
                    want = _tp_part(n, torch.from_numpy(np.array(g)), coord, tp)
                    errs[n] = _nrel(d["gp"][n], want)
                for k, e in errs.items():
                    assert e <= tol, (key, which, k, e)


def test_eval_over_tp_mesh_gives_one_process_recall(runs):
    for r in runs["ranks"]:
        (t2v, v2t), (t2v1, v2t1) = r["eval"]
        assert t2v == t2v1 and v2t == v2t1


@pytest.mark.parametrize("mode", list(UNEVEN))
def test_uneven_heads_split_whole_heads_and_hidden_units(runs, mode):
    """Rank r takes ceil(H/tp) heads if r < H mod tp, else floor(H/tp),
    and the 4·D hidden units by the same rule: (1, 1, 0) heads and
    (171, 171, 170) units of the narrow config over three ranks, (2, 1)
    heads and (384, 384) units at width 192 over two."""
    world, _, width = UNEVEN[mode]
    want = {"uneven3": ((1, 1, 0), (171, 171, 170)),
            "uneven2": ((2, 1), (384, 384))}[mode]
    per_rank = [r["heads"] for r in runs["uneven"][mode]]
    assert len(per_rank) == world and per_rank[0]
    for blk in range(len(per_rank[0])):
        n_head = per_rank[0][blk][0]
        assert n_head == width // 64
        heads = tuple(r[blk][1] for r in per_rank)
        units = tuple(r[blk][2] for r in per_rank)
        assert (heads, units) == want, (blk, heads, units)


@pytest.mark.parametrize("mode", list(UNEVEN))
def test_uneven_steps_match_jax_train_step(runs, mode):
    """The bank fill and three steps over uneven heads against the
    one-device JAX trajectory at the even TP's bars, on every rank; the
    replicated parameters bit-equal across the ranks."""
    ref = runs["ref"] if mode == "uneven3" else runs["wide_ref"]
    rs = [r["train"] for r in runs["uneven"][mode]]
    for r in rs:
        C.held_to_jax(r, ref)
        assert r["steps"] == (C.STEPS, C.STEPS)
    assert len({r["replicated_digest"] for r in rs}) == 1
    for r in rs[1:]:
        assert r["metrics"] == rs[0]["metrics"]


def test_uneven_tp_matches_jax_tp_form(runs):
    """Three heads over two model ranks against the JAX package's
    make_tp_mesh((1, 2)) at width 192: loss terms and gradient norms 1e-4
    relative, parameters 1e-4."""
    want = runs["jax_tp_wide"]
    got = runs["uneven"]["uneven2"][0]["train"]
    for a, b in zip(got["metrics"], want["metrics"]):
        for k in C.LOSS_KEYS + ("grad_norm",):
            np.testing.assert_allclose(a[k], float(b[k]), rtol=1e-4,
                                       err_msg=k)
    for k, v in want["params"].items():
        assert np.abs(got["params"][k] - v).max() <= 1e-4, k


@pytest.mark.parametrize("mode", list(UNEVEN))
def test_uneven_eval_gives_one_process_recall(runs, mode):
    for r in runs["uneven"][mode]:
        (t2v, v2t), (t2v1, v2t1) = r["eval"]
        assert t2v == t2v1 and v2t == v2t1


def test_uneven_checkpoint_crosses_both_ways(runs):
    """A JAX-written train state read into the (1, 3) placement gives the
    file's parameters and moments back bit for bit on every rank; the
    sharded set that placement writes after a step reads in the JAX
    package as in the port, bit for bit."""
    from neighborretr_tpu.core import checkpoint as jckpt
    from neighborretr_tpu.core import config as jc
    from neighborretr_tpu.models import neighborretr as jm
    from neighborretr_tpu.train import memory_bank as jmb
    from neighborretr_tpu.train import step as jstep
    import jax

    want = runs["jax_file"]
    for r in runs["uneven"]["uneven3"]:
        got = r["checkpoint"]["loaded"]
        for k, v in want.items():
            if k.startswith(("params", "opt_")):
                np.testing.assert_array_equal(got[k], v, err_msg=k)
    stepped = runs["uneven"]["uneven3"][0]["checkpoint"]["stepped"]
    cfg = C.make_config(jc)
    m = cfg.model
    like = jstep.create_train_state(
        jm.init_params(jax.random.PRNGKey(0), m),
        jmb.create(cfg.train.memory_bank_capacity, m.max_words,
                   m.max_frames, m.width))
    got = jckpt.load_sharded_train_state(os.path.join(
        runs["uneven_set"], "state_preempt.manifest.json"), like)
    flat = {}
    for name, tree in (("params", got.params), ("opt_m", got.opt.m),
                       ("opt_v", got.opt.v)):
        flat.update({f"{name}//{k}": np.asarray(v)
                     for k, v in jckpt.flatten_tree(tree).items()})
    assert int(got.step) == int(stepped["step"]) == 6
    for k, v in flat.items():
        np.testing.assert_array_equal(v, stepped[k], err_msg=k)


if __name__ == "__main__":
    if len(sys.argv) > 5:
        uneven_worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                      sys.argv[4], sys.argv[5])
    else:
        worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
               sys.argv[4])
