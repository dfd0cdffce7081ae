"""The port's GPipe pipeline (parallel/pipeline.py) and pipeline × tensor
parallelism against the JAX package, on the CPU.

Six gloo processes of the port (this file run as a program), spawned once
as two groups, run in turn in the narrow fp32 configuration of
tests/torch_sharded_common.py (two heads, two layers a tower, the clip
binding), each from the JAX package's initial weights on its blocks of
the same global batches:
- four ranks: the pipeline on data 2 × stage 2 with M = 2, and pipeline ×
  tensor on data 1 × stage 2 × model 2 with M = 2;
- two ranks: the pipeline on data 1 × stage 2 with M = 4, and the tower
  level below.
Each strategy's bank fill and three steps are held to the JAX `train_step`
on the whole global batch on one device (loss terms 1e-4 relative, every
parameter 1e-4 absolute, the bank 1e-4); the replicated parameters are
bit-equal on every rank, a stage's on the ranks of its coordinates; each
rank's parameter and moment counts are its stage's (and model shard's).

The tower level, as tests/test_pipeline.py: a 4-layer tower (D = 32, four
heads) as `pipeline_transformer_apply` over two stages and four
microbatches, with a per-sample key-padding bias and with a constant
causal bias, against the JAX `pipeline_transformer_apply` on its
(1, 2) mesh and against the plain tower: forward within 1e-5, gradients of
the input and of every block within 2e-4 relative + 2e-5 absolute.  Then
the JAX package's errors (`pipeline.py:197-216`) and `supports`' silent
fallback for a depth that does not divide.
"""

import os
import re
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_sharded_common as C  # noqa: E402

CASES = {   # world → (name, mesh shape, axes, microbatches)
    4: [("pp", (2, 2), ("data", "stage"), 2),
        ("pptp", (1, 2, 2), ("data", "stage", "model"), 2)],
    2: [("pp_m4", (1, 2), ("data", "stage"), 4)],
}
D, HEADS, LAYERS, ROWS, LEN = 32, 4, 4, 16, 6
BIASES = ("per_sample", "constant")


def _tower_inputs():
    """x [16, 6, 32] and the three biases, from numpy seeds."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((ROWS, LEN, D)).astype(np.float32)
    mask = rng.uniform(size=(ROWS, LEN)) > 0.3
    mask[:, 0] = True
    per_sample = np.where(mask[:, None, None, :], 0.0, -1e6).astype(
        np.float32)
    i = np.arange(LEN)
    causal = np.where(i[None, :] > i[:, None], -1e9, 0.0).astype(
        np.float32)[None, None]
    return x, {"per_sample": per_sample, "constant": causal}


def _tower_case(mesh, work):
    """In a rank of the (1, 2) mesh: the port's pipelined tower and its
    plain tower, forward and the gradients of sum(y²)."""
    from neighborretr_tpu_torch.models.layers import Transformer
    from neighborretr_tpu_torch.parallel import pipeline as pp

    x_np, biases = _tower_inputs()
    sd = torch.load(os.path.join(work, "tower.pt"))
    ctx = pp.PipelineContext(mesh=mesh, stages=2, microbatches=4)
    out = {}
    for name, b in biases.items():
        bias = torch.as_tensor(b)
        res = {}
        for form in ("pipeline", "plain"):
            tower = Transformer(D, LAYERS, HEADS)
            tower.load_state_dict(sd)
            x = torch.as_tensor(x_np).requires_grad_(True)
            if form == "pipeline":
                y = pp.pipeline_transformer_apply(tower, x, bias,
                                                  torch.float32, ctx=ctx)
            else:
                y = tower(x, bias, torch.float32)
            (y ** 2).sum().backward()
            res[form] = dict(y=y.detach(), gx=x.grad, grads={
                n: p.grad for n, p in tower.named_parameters()
                if p.grad is not None})
        out[name] = res
    return out


def worker(rank: int, world: int, port: int, work: str) -> None:
    from neighborretr_tpu_torch.core import config as tc
    from neighborretr_tpu_torch.parallel import mesh as pmesh

    C.init_rank(rank, world, port)
    init_sd = torch.load(os.path.join(work, "init.pt"))
    out = {}
    for name, shape, axes, m in CASES[world]:
        cfg = C.make_config(tc, pipeline_parallel=2, pipeline_microbatches=m)
        out[name] = C.train_case(cfg, pmesh.make_mesh("cpu", shape, axes),
                                 init_sd)
    if world == 2:
        out["tower"] = _tower_case(
            pmesh.make_mesh("cpu", (1, 2), ("data", "stage")), work)
    torch.save(out, os.path.join(work, f"w{world}rank{rank}.pt"))
    import torch.distributed as dist
    dist.destroy_process_group()


def _jax_tower():
    """The JAX tower's weights (as the port's state dict) and its pipelined
    forward and gradients on the (1, 2) mesh, per bias."""
    import jax
    import jax.numpy as jnp

    from neighborretr_tpu.models import layers as JL
    from neighborretr_tpu.parallel import pipeline as jpp
    from neighborretr_tpu_torch.models import weights_io as W

    tree = jax.device_get(JL.transformer_init(jax.random.PRNGKey(0), D,
                                              LAYERS))
    sd = {}
    W._blocks_sd(tree, LAYERS, "resblocks", sd)
    ctx = jpp.PipelineContext(mesh=jpp.make_pp_mesh((1, 2)), stages=2,
                              microbatches=4)
    x_np, biases = _tower_inputs()
    out = {}
    for name, b in biases.items():
        bias = jnp.asarray(b)

        def loss(p, x):
            y = jpp.pipeline_transformer_apply(p, x, HEADS, ctx,
                                               attn_bias=bias)
            return jnp.sum(jnp.square(y)), y

        (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(tree, jnp.asarray(x_np))
        grads = {}
        W._blocks_sd(jax.device_get(gp), LAYERS, "resblocks", grads)
        out[name] = dict(y=np.asarray(y), gx=np.asarray(gx), grads=grads)
    return {k: torch.tensor(np.asarray(v)) for k, v in sd.items()}, out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("pp"))
    init, ref = C.jax_trajectory()
    torch.save(init, os.path.join(work, "init.pt"))
    tower_sd, jtower = _jax_tower()
    torch.save(tower_sd, os.path.join(work, "tower.pt"))
    procs = [p for world in CASES
             for p in C.spawn(os.path.abspath(__file__), world, work)]
    C.join(procs)
    ranks = {world: [torch.load(os.path.join(work, f"w{world}rank{r}.pt"),
                                weights_only=False) for r in range(world)]
             for world in CASES}
    return dict(ranks=ranks, ref=ref, jtower=jtower)


def _case_ranks(runs, name):
    for world, cases in CASES.items():
        if name in [c[0] for c in cases]:
            return [r[name] for r in runs["ranks"][world]]
    raise KeyError(name)


@pytest.mark.parametrize("case", ["pp", "pptp", "pp_m4"])
def test_steps_match_jax_train_step(runs, case):
    for r in _case_ranks(runs, case):
        C.held_to_jax(r, runs["ref"])
        assert r["steps"] == (C.STEPS, C.STEPS)


@pytest.mark.parametrize("case", ["pp", "pptp", "pp_m4"])
def test_ranks_agree_bit_for_bit(runs, case):
    """Replicated parameters bit-equal on every rank; a rank's local
    tensors bit-equal on the ranks of its stage and model coordinates; the
    metrics and the bank the same everywhere."""
    rs = _case_ranks(runs, case)
    assert len({r["replicated_digest"] for r in rs}) == 1
    by_place = {}
    for r in rs:
        key = (r["coords"].get("stage"), r["coords"].get("model"))
        by_place.setdefault(key, set()).add(r["local_digest"])
    assert len(by_place) > 1 and all(len(d) == 1 for d in by_place.values())
    for r in rs[1:]:
        assert r["metrics"] == rs[0]["metrics"]
        assert all(torch.equal(a, b) for a, b in zip(r["bank"], rs[0]["bank"]))


def test_stage_shard_counts(runs):
    """A stage holds half of each tower's blocks (all three towers have two
    layers), and under pipeline × tensor half of that block's split
    matrices; the moments follow (↔ tests/test_sharding.py)."""
    from neighborretr_tpu_torch.core import config as tc
    from neighborretr_tpu_torch.parallel.tensor import TP_SPLITS
    counts = C.full_counts(C.make_config(tc))
    total = sum(counts.values())
    blocks = {k: n for k, n in counts.items() if ".resblocks." in k}
    split = sum(n for k, n in blocks.items()
                if re.sub(r"^.*\.resblocks\.\d+\.", "", k) in TP_SPLITS)
    rest = total - sum(blocks.values())
    want = {"pp": rest + sum(blocks.values()) // 2,
            "pp_m4": rest + sum(blocks.values()) // 2,
            "pptp": rest + (sum(blocks.values()) - split) // 2 + split // 4}
    for case, n in want.items():
        for r in _case_ranks(runs, case):
            assert r["param_count"] == n, case
            assert r["moment_count"] == 2 * n, case


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("bias", BIASES)
def test_tower_matches_jax_pipeline_and_plain(runs, bias):
    """Forward 1e-5; the input's gradient and every block's within 2e-4
    relative + 2e-5 absolute (tests/test_pipeline.py's bars), against the
    JAX pipeline and against the plain tower.  A block's gradient comes
    from the rank of the stage that holds it; both ranks return the
    forward and the input's gradient."""
    want = runs["jtower"][bias]
    ranks = [r["tower"][bias] for r in runs["ranks"][2]]
    plain = ranks[0]["plain"]
    grads = {}
    for r in ranks:
        grads.update(r["pipeline"]["grads"])
        _close(r["pipeline"]["y"], want["y"], 1e-5, 1e-5, "y vs JAX")
        _close(r["pipeline"]["y"], plain["y"], 1e-5, 1e-5, "y vs plain")
        _close(r["pipeline"]["gx"], want["gx"], 2e-4, 2e-5, "gx vs JAX")
        _close(r["pipeline"]["gx"], plain["gx"], 2e-4, 2e-5, "gx vs plain")
    assert grads.keys() == want["grads"].keys() == plain["grads"].keys()
    for k in grads:
        _close(grads[k], want["grads"][k], 2e-4, 2e-5, k + " vs JAX")
        _close(grads[k], plain["grads"][k], 2e-4, 2e-5, k + " vs plain")
    # each stage computed the gradients of its own two blocks only
    held = [sorted({int(k.split(".")[1]) for k in r["pipeline"]["grads"]})
            for r in ranks]
    assert held == [[0, 1], [2, 3]]


def _fake_mesh(stage=0):
    """A (1, 2) data × stage mesh of rank `stage`, without a process group:
    the checks and the placement below run no collective."""
    from neighborretr_tpu_torch.parallel import mesh as pmesh
    return pmesh.DataGroup(rank=stage, world=2, collective=True,
                           axis_names=("data", "stage"), shape=(1, 2))


@pytest.mark.parametrize("change, says", [
    (dict(stages=3), "does not match the mesh's 'stage' axis of size 2"),
    (dict(layers=3), "3 layers do not divide into 2 stages"),
    (dict(microbatches=3), "rows 16 must divide by data×microbatches = 1×3"),
    (dict(bias_rows=5), "attn_bias leading dim 5 must be 1 or match rows 16"),
])
def test_pipeline_errors(change, says):
    """↔ pipeline.py:197-216."""
    from neighborretr_tpu_torch.models.layers import Transformer
    from neighborretr_tpu_torch.parallel import pipeline as pp
    tower = Transformer(D, change.get("layers", LAYERS), HEADS)
    ctx = pp.PipelineContext(mesh=_fake_mesh(),
                             stages=change.get("stages", 2),
                             microbatches=change.get("microbatches", 4))
    bias = (torch.zeros(change["bias_rows"], 1, 1, LEN)
            if "bias_rows" in change else None)
    with pytest.raises(ValueError, match=re.escape(says)):
        pp.pipeline_transformer_apply(tower, torch.zeros(ROWS, LEN, D), bias,
                                      torch.float32, ctx=ctx)


def test_depth_that_does_not_divide_falls_back():
    """↔ supports: a 3-layer tower under two stages keeps every block on
    every stage and runs the plain path (the same numbers as unplaced); a
    2-layer one keeps its stage's block only."""
    from neighborretr_tpu_torch.models.layers import Transformer
    from neighborretr_tpu_torch.parallel import mesh as pmesh
    from neighborretr_tpu_torch.parallel import pipeline as pp
    assert not pp.supports(2, 3) and pp.supports(2, 4)
    assert not pp.supports(1, 4)
    torch.manual_seed(0)
    box = torch.nn.Module()
    box.odd, box.even = Transformer(D, 3, HEADS), Transformer(D, 2, HEADS)
    for p in box.parameters():
        torch.nn.init.normal_(p, std=0.05)
    x = torch.randn(4, LEN, D)
    before = box.odd(x, None, torch.float32)
    params = {n: pmesh.Placement(tuple(p.shape))
              for n, p in box.named_parameters()}
    pp.shard_params_pp(box, _fake_mesh(stage=1), params)
    assert box.odd.stages is None and len(list(box.odd.parameters())) == \
        3 * 12
    assert torch.equal(box.odd(x, None, torch.float32), before)
    assert box.even.stages is not None
    assert isinstance(box.even.resblocks[0], torch.nn.Identity)
    assert not isinstance(box.even.resblocks[1], torch.nn.Identity)
    assert {params[n].stage for n in params if n.startswith("even.")} == \
        {0, 1}
    assert all(params[n].stage is None for n in params
               if n.startswith("odd."))


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
