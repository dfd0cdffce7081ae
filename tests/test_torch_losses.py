"""The port's four losses, Sinkhorn targets, memory bank and BertAdam
against the JAX package: the same numpy inputs through both, fp32, with the
tolerance stated at each comparison (1e-5 unless noted: elementwise fp32
math in another order)."""

import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neighborretr_tpu.core.config import OptimizerConfig as JOptimizerConfig
from neighborretr_tpu.losses import hubness as jh
from neighborretr_tpu.ops import sinkhorn as jsink
from neighborretr_tpu.train import bertadam as jba
from neighborretr_tpu.train import memory_bank as jmb
from neighborretr_tpu_torch.core.config import OptimizerConfig
from neighborretr_tpu_torch.losses import hubness as th
from neighborretr_tpu_torch.ops import sinkhorn as tsink
from neighborretr_tpu_torch.train import bertadam as tba
from neighborretr_tpu_torch.train import memory_bank as tmb

TOL = dict(atol=1e-5, rtol=1e-5)


def T(a):
    return torch.as_tensor(np.array(a))


def value_and_grads(jax_fn, torch_fn, *arrays):
    """Both losses and their gradients in every array argument."""
    want, gwant = jax.value_and_grad(jax_fn, argnums=tuple(range(len(arrays))))(
        *map(jnp.asarray, arrays))
    leaves = [T(a).requires_grad_(True) for a in arrays]
    got = torch_fn(*leaves)
    got.backward()
    return (got.item(), [np.zeros_like(a) if l.grad is None else l.grad.numpy()
                         for l, a in zip(leaves, arrays)],
            float(want), [np.asarray(g) for g in gwant])


def check(jax_fn, torch_fn, *arrays, tol=TOL):
    got, ggot, want, gwant = value_and_grads(jax_fn, torch_fn, *arrays)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, **tol)
    for a, b in zip(ggot, gwant):
        np.testing.assert_allclose(a, b, **tol)


@pytest.fixture
def sims():
    rng = np.random.default_rng(0)
    B = 12
    return (rng.normal(size=(B, B)).astype(np.float32),
            rng.normal(size=(B, B)).astype(np.float32))


def test_centrality_weighting_loss(sims):
    w = np.random.default_rng(1).uniform(0.5, 2, size=12).astype(np.float32)
    check(jh.centrality_weighting_loss, th.centrality_weighting_loss,
          sims[0] * 5, w)


@pytest.mark.parametrize("n1", [1, 3])    # several global tokens: averaged
def test_centrality_weights(n1):
    rng = np.random.default_rng(2)
    B, Tn, V, D = 6, 8, 4, 16
    arrays = [rng.normal(size=s).astype(np.float32)
              for s in ((B, Tn, D), (B, V, D), (B, n1, D), (B, n1, D))]
    for k in (0, 1):
        check(lambda *a: jnp.sum(jh.centrality_weights(*a, 0.3)[k]),
              lambda *a: th.centrality_weights(*a, 0.3)[k].sum(), *arrays)


def test_neighbor_masks_and_ties(sims):
    s = sims[0].copy()
    s[:, 3] = s[:, 5]            # tied columns: the lower one is taken first
    for k in (3, 20):            # 20 > B - 1: clamped
        want = jh.neighbor_masks(jnp.asarray(s), k)
        got = th.neighbor_masks(T(s), k)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("B,k", [(12, 3), (5, 3)])   # B = k + 2: the guard
def test_neighbor_adjusting_losses(B, k):
    rng = np.random.default_rng(B)
    s = rng.normal(size=(B, B)).astype(np.float32)
    bank = rng.normal(size=(B, 30)).astype(np.float32)
    check(lambda s, m: jh.neighbor_adjusting_loss(s, m, k, 3.0),
          lambda s, m: th.neighbor_adjusting_loss(s, m, k, 3.0), s, bank)
    check(lambda s, c: jh.neighbor_adjusting_loss_from_centrality(s, c, k, 3.0),
          lambda s, c: th.neighbor_adjusting_loss_from_centrality(s, c, k, 3.0),
          s, bank.mean(-1))


def test_sinkhorn_and_uniform_loss(sims):
    s = sims[0]
    np.testing.assert_allclose(
        tsink.sinkhorn_targets(T(s), 0.7, 50).numpy(),
        np.asarray(jsink.sinkhorn_targets(jnp.asarray(s), 0.7, 50)), **TOL)
    # the temperature flag is the logit scale here (argument aliasing)
    check(lambda s: jh.uniform_regularization_loss(s, 3.0, 0.7, 50),
          lambda s: th.uniform_regularization_loss(s, 3.0, 0.7, 50), s)


def test_kl_divergence_loss(sims):
    check(jh.kl_divergence_loss, th.kl_divergence_loss, *sims)


def test_memory_bank_fifo_and_fill():
    rng = np.random.default_rng(3)
    cap, W, F, E, B = 6, 4, 3, 8, 2
    jb = jmb.create(cap, W, F, E)
    tb = tmb.create(cap, W, F, E)

    def rows(i):
        return (np.arange(B, dtype=np.int32) + 10 * i,
                rng.normal(size=(B, W, E)).astype(np.float32),
                rng.normal(size=(B, F, E)).astype(np.float32),
                rng.integers(0, 2, size=(B, W)).astype(np.float32),
                rng.integers(0, 2, size=(B, F)).astype(np.float32))

    for i in range(3):
        r = rows(i)
        jb = jmb.write_slice(jb, i * B, *map(jnp.asarray, r))
        tb = tmb.write_slice(tb, i * B, *map(T, r))
    for i in range(4):           # more pushes than capacity: the tail drops
        r = rows(5 + i)
        jb = jmb.fifo_update(jb, *map(jnp.asarray, r))
        tb = tmb.fifo_update(tb, *map(T, r))
    for a, b in zip(tb, jb):
        assert a.dtype == (torch.int32 if a.ndim == 1 else torch.float32)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("moments_dtype,schedule", [
    ("float32", "warmup_cosine"), ("bfloat16", "warmup_linear"),
    ("float32", "warmup_constant")])
def test_bertadam_three_steps_match_jax(moments_dtype, schedule):
    """Three updates over a small tree that has every group: a frozen patch
    embedding, CLIP-branch and other parameters, biases (no decay) and a
    LayerNorm scale (decayed).  Gradients large enough that the global clip
    binds.  fp32 moments: 1e-6; bf16 moments round the carried state, and
    the two frameworks round the same fp32 values: 1e-5."""
    rng = np.random.default_rng(7)
    jparams = {
        "clip": {"visual": {"patch_embed": rng.normal(size=(12, 4)),
                            "ln_pre": {"scale": 1 + rng.normal(size=4),
                                       "bias": rng.normal(size=4)}},
                 "text": {"proj": {"w": rng.normal(size=(4, 4)),
                                   "b": rng.normal(size=4)}}},
        "temporal": {"w": rng.normal(size=(4, 4)), "bias": rng.normal(size=4)},
    }
    names = {   # the port's names for the same leaves
        ("clip", "visual", "patch_embed"): "clip.visual.conv1.weight",
        ("clip", "visual", "ln_pre", "scale"): "clip.visual.ln_pre.weight",
        ("clip", "visual", "ln_pre", "bias"): "clip.visual.ln_pre.bias",
        ("clip", "text", "proj", "w"): "clip.text_projection",
        ("clip", "text", "proj", "b"): "clip.in_proj_bias",
        ("temporal", "w"): "transformerClip.w",
        ("temporal", "bias"): "transformerClip.bias",
    }
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jparams)
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    keys = [tuple(k.key for k in path) for path, _ in flat]
    tparams = {names[k]: T(np.asarray(v)) for k, (_, v) in zip(keys, flat)}

    kw = dict(lr=1e-2, coef_lr=0.1, warmup_proportion=0.2, schedule=schedule,
              moments_dtype=moments_dtype)
    jcfg, tcfg = JOptimizerConfig(**kw), OptimizerConfig(**kw)
    jstate = jba.bert_adam_init(jparams, moments_dtype)
    tstate = tba.bert_adam_init(tparams, moments_dtype)
    treedef = jax.tree.structure(jparams)
    for step in range(3):
        grads = [rng.normal(size=v.shape).astype(np.float32) * 3
                 for _, v in flat]
        jgrads = jax.tree.unflatten(treedef, [jnp.asarray(g) for g in grads])
        tgrads = {names[k]: T(g) for k, g in zip(keys, grads)}
        want_norm = float(jba.clip_effective_norm(jgrads))
        np.testing.assert_allclose(tba.clip_effective_norm(tgrads).item(),
                                   want_norm, rtol=1e-6)
        assert want_norm > tcfg.max_grad_norm
        jparams, jstate = jba.bert_adam_update(jgrads, jstate, jparams, jcfg,
                                               t_total=10)
        tstate = tba.bert_adam_update(tgrads, tstate, tparams, tcfg,
                                      t_total=10)
    assert tstate.step == int(jstate.step) == 3
    tol = 1e-6 if moments_dtype == "float32" else 1e-5
    moved = 0
    for k, (_, init), a, m, v in zip(
            keys, flat, jax.tree.leaves(jparams), jax.tree.leaves(jstate.m),
            jax.tree.leaves(jstate.v)):
        n = names[k]
        np.testing.assert_allclose(tparams[n].numpy(), np.asarray(a),
                                   atol=tol, rtol=tol, err_msg=n)
        np.testing.assert_allclose(
            tstate.m[n].float().numpy(), np.asarray(m.astype(jnp.float32)),
            atol=1e-2 if moments_dtype == "bfloat16" else 1e-6, err_msg=n)
        np.testing.assert_allclose(
            tstate.v[n].float().numpy(), np.asarray(v.astype(jnp.float32)),
            atol=1e-2 if moments_dtype == "bfloat16" else 1e-6, err_msg=n)
        changed = not np.array_equal(np.asarray(a), np.asarray(init))
        assert changed == (n != "clip.visual.conv1.weight"), n
        moved += changed
    assert moved == len(keys) - 1


def test_bertadam_first_update_is_zero_and_clip_can_be_off():
    """schedule(0) = 0 for the warm-up schedules: the first step moves the
    moments, not the parameters; max_grad_norm <= 0 turns both clips off."""
    p = {"w": torch.ones(3)}
    g = {"w": torch.full((3,), 5.0)}
    cfg = OptimizerConfig()
    state = tba.bert_adam_update(g, tba.bert_adam_init(p), p, cfg, 100)
    assert torch.equal(p["w"], torch.ones(3)) and state.step == 1
    assert state.m["w"].abs().sum() > 0
    assert tba.current_lr(state, cfg, 100) == pytest.approx(1e-4 * 0.1)
    off = dc.replace(cfg, max_grad_norm=0.0)
    s2 = tba.bert_adam_update(g, tba.bert_adam_init(p), p, off, 100)
    np.testing.assert_allclose(s2.m["w"].numpy(), 0.1 * 5.0, rtol=1e-6)
