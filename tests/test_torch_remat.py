"""Rematerialisation and frame chunking in the port (models/layers.py,
models/neighborretr.py), on the CPU.

Per-layer remat under each policy runs the same operations on the same
values a second time, so loss and every parameter gradient equal the
run without remat bit for bit, on each attention route.  Frame chunking
runs the vision tower on other batch sizes and sums each weight gradient
chunk by chunk, which is another summation order: held to fp32 rounding.
One train step with `attention_impl="fused"`, bf16 and remat in both
packages (the Pallas kernels in interpret mode), and a weights round trip
at ViT-L/14@336px shapes.
"""

import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neighborretr_tpu.core import config as jc
from neighborretr_tpu.data.datasets.synthetic import make_synthetic_batch
from neighborretr_tpu.models import neighborretr as jm
from neighborretr_tpu.train import memory_bank as jmb
from neighborretr_tpu.train import step as jstep
from neighborretr_tpu_torch.core import config as tc
from neighborretr_tpu_torch.models import weights_io as W
from neighborretr_tpu_torch.ops import attention as A
from neighborretr_tpu_torch.train import memory_bank as tmb
from neighborretr_tpu_torch.train import step as tstep

B, MB_BATCH, T_TOTAL = 8, 2, 10
LOSS_KEYS = ("loss", "centrality_loss", "uniform_loss", "neighbor_loss",
             "kl_loss")
# attention route → (attention_impl, compute_dtype)
ROUTES = {"einsum": ("einsum", "float32"), "fused": ("fused", "bfloat16"),
          "fused_block": ("fused_block", "bfloat16")}


def make_config(mod, **model):
    m = dc.replace(mod.ModelConfig.tiny(max_words=8, max_frames=4),
                   cluster_noise=False, **model)
    return mod.Config(
        model=m, loss=mod.LossConfig(num_neighbors=3),
        optim=mod.OptimizerConfig(lr=1e-2, coef_lr=0.1),
        data=mod.DataConfig(max_words=8, max_frames=4),
        train=mod.TrainConfig(batch_size=B, mb_batch=MB_BATCH))


def batch(cfg, seed):
    b = make_synthetic_batch(cfg.model, B, seed=seed)
    b["video_mask"][1, 2:] = 0
    b["idx"] = b["idx"] + 100 * seed
    return b


def loss_and_grads(route, **model):
    """Loss terms and every parameter gradient of one compute_losses on the
    tiny model, from fixed weights, batch and bank."""
    impl, dtype = ROUTES[route]
    cfg = make_config(tc, attention_impl=impl, compute_dtype=dtype, **model)
    net = W.init_model(cfg.model, 0)
    m = cfg.model
    rng = np.random.default_rng(0)
    cap = cfg.train.memory_bank_capacity
    bank = tmb.create(cap, m.max_words, m.max_frames, m.width)._replace(
        feat_t=torch.as_tensor(rng.standard_normal(
            (cap, m.max_words, m.width)).astype(np.float32)),
        feat_v=torch.as_tensor(rng.standard_normal(
            (cap, m.max_frames, m.width)).astype(np.float32)),
        mask_t=torch.ones(cap, m.max_words),
        mask_v=torch.ones(cap, m.max_frames))
    tstep.create_train_state(net, bank)       # marks the trainable tensors
    total, aux = tstep.compute_losses(
        net, cfg, tstep.to_device(batch(cfg, 3), "cpu"), bank)
    total.backward()
    grads = {n: p.grad.clone() for n, p in net.named_parameters()
             if p.grad is not None}
    return {k: aux[k] for k in LOSS_KEYS}, grads


_baseline = {}


def baseline(route):
    if route not in _baseline:
        _baseline[route] = loss_and_grads(route)
    return _baseline[route]


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("name,remat", [
    ("full", dict(remat_policy="full")), ("attn", dict(remat_policy="attn")),
    ("dots", dict(remat_policy="dots")),
    ("full_skip_last", dict(remat_policy="full", remat_skip_last=1)),
    ("attn_unrolled", dict(remat_policy="attn", unroll_layers=True))])
def test_remat_equals_no_remat_bit_for_bit(route, name, remat):
    want_loss, want = baseline(route)
    got_loss, got = loss_and_grads(route, remat=True, **remat)
    for k in LOSS_KEYS:
        assert torch.isfinite(got_loss[k]) and torch.equal(got_loss[k],
                                                           want_loss[k]), k
    assert set(got) == set(want) and len(got) > 100
    for n in want:
        assert torch.equal(got[n], want[n]), n


@pytest.mark.parametrize("route", ["einsum", "fused"])
@pytest.mark.parametrize("chunk", [8, 12, 5])      # B·F = 32: 4 chunks whole,
def test_video_chunk_frames_equals_one_pass(route, chunk):    # 3 and 7 ragged
    """Forward values are the same operations per frame; a weight gradient
    is summed chunk by chunk instead of over all frames at once, so it is
    held to rounding (fp32: 1e-5 of the tensor's largest entry; bf16
    towers round each chunk's weight gradient once more: 2^-7)."""
    want_loss, want = baseline(route)
    got_loss, got = loss_and_grads(route, video_chunk_frames=chunk, remat=True)
    tol = 1e-5 if route == "einsum" else 2 ** -7
    for k in LOSS_KEYS:
        torch.testing.assert_close(got_loss[k], want_loss[k], atol=0,
                                   rtol=tol)
    assert set(got) == set(want)
    for n in want:
        scale = want[n].abs().max().item()
        assert (got[n] - want[n]).abs().max().item() <= tol * max(scale,
                                                                  1e-6), n


def test_video_chunk_larger_than_the_batch_is_one_pass():
    want_loss, want = baseline("einsum")
    got_loss, got = loss_and_grads("einsum", video_chunk_frames=32)
    assert all(torch.equal(got_loss[k], want_loss[k]) for k in LOSS_KEYS)
    assert all(torch.equal(got[n], want[n]) for n in want)


def test_chunked_encode_without_grad_matches_and_drops_pad_rows():
    cfg = make_config(tc)
    net = W.init_model(cfg.model, 0)
    b = tstep.to_device(batch(cfg, 4), "cpu")
    with torch.no_grad():
        want = net.get_video_feat(b["video"], b["video_mask"])
        net.cfg = dc.replace(cfg.model, video_chunk_frames=7)
        got = net.get_video_feat(b["video"], b["video_mask"])
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_remat_reruns_the_forward_and_attn_policy_does_not(monkeypatch):
    """What the launch counts show on the card, shown here on the plain
    versions: under `full` the attention forward runs again in the backward,
    under `attn` it does not."""
    calls = []
    real = A.attention_plain
    monkeypatch.setattr(A, "attention_plain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    n = {}
    for policy in (None, "full", "attn", "dots"):
        calls.clear()
        loss_and_grads("fused", **(dict(remat=True, remat_policy=policy)
                                   if policy else {}))
        n[policy] = len(calls)
    # tiny towers: 2 vision + 2 text layers are rematerialised, the temporal
    # tower (2 layers here) never is
    assert n[None] == n["attn"] == 6
    assert n["full"] == n["dots"] == 6 + 4


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="remat_policy"):
        loss_and_grads("einsum", remat=True, remat_policy="everything")


def test_train_step_fused_bf16_remat_matches_jax():
    """Bank fill and one optimizer step with attention_impl="fused", bf16
    and remat in both packages; the JAX side runs its Pallas attention
    kernels in interpret mode.  Both towers round to bf16 at their own
    places (XLA's CPU products, torch's), so loss terms are held to 2e-2
    relative and the gradient norm to 5e-2, the features the fill wrote to
    6e-2 (K1's slice bound, tests/test_torch_ops.py)."""
    kw = dict(attention_impl="fused", compute_dtype="bfloat16", remat=True,
              remat_policy="full")
    jcfg, tcfg = make_config(jc, **kw), make_config(tc, **kw)
    params = jm.init_params(jax.random.PRNGKey(0), jcfg.model)
    model = W.from_jax_params(jax.device_get(params), tcfg.model)
    m, cap = jcfg.model, jcfg.train.memory_bank_capacity
    fill = [batch(jcfg, s) for s in (10, 11)]
    step = batch(jcfg, 20)

    jbank = jmb.create(cap, m.max_words, m.max_frames, m.width)
    for i, b in enumerate(fill):
        jbank = jstep.fill_bank_step(params, jbank, jax.tree.map(
            jnp.asarray, b), jcfg, i * B)
    filled = jax.device_get(jbank)            # the step donates its state
    jstate = jstep.create_train_state(params, jbank)
    _, jmet = jstep.train_step(jstate, jax.tree.map(jnp.asarray, step),
                               jax.random.PRNGKey(0), jcfg, T_TOTAL)
    jmet = jax.device_get(jmet)

    tbank = tmb.create(cap, m.max_words, m.max_frames, m.width)
    for i, b in enumerate(fill):
        tbank = tstep.fill_bank_step(model, tbank, tstep.to_device(b, "cpu"),
                                     tcfg, i * B)
    np.testing.assert_allclose(tbank.feat_t.numpy(), np.asarray(filled.feat_t),
                               atol=6e-2, rtol=6e-2)
    np.testing.assert_allclose(tbank.feat_v.numpy(), np.asarray(filled.feat_v),
                               atol=6e-2, rtol=6e-2)
    tstate = tstep.create_train_state(model, tbank)
    tstate, tmet = tstep.train_step(tstate, tstep.to_device(step, "cpu"),
                                    tcfg, T_TOTAL)
    for k in LOSS_KEYS:
        assert np.isfinite(tmet[k].item()), k
        np.testing.assert_allclose(tmet[k].item(), float(jmet[k]), rtol=2e-2,
                                   err_msg=k)
    np.testing.assert_allclose(tmet["grad_norm"].item(),
                               float(jmet["grad_norm"]), rtol=5e-2)
    assert tstate.step == 1


def test_weights_round_trip_at_vit_l_14_336_shapes():
    """from_jax_params / to_jax_params are shape-driven: a ViT-L/14@336px
    parameter tree (1024-wide vision at 577 positions, 768-wide text and
    embedding; depth and vocabulary cut, which no shape rule reads) crosses
    both ways, key for key and shape for shape with the JAX package's own
    tree."""
    def cut(mod):
        clip = dc.replace(mod.ClipConfig.vit_l_14_336(), vision_layers=1,
                          transformer_layers=1, vocab_size=64)
        return mod.ModelConfig(clip=clip, temporal_layers=1)

    jcfg, tcfg = cut(jc), cut(tc)
    assert (tcfg.clip.vision_width, tcfg.clip.transformer_width,
            tcfg.clip.grid_size ** 2 + 1, tcfg.clip.vision_heads) == \
        (1024, 768, 577, 16)
    params = jax.device_get(jm.init_params(jax.random.PRNGKey(0), jcfg))
    model = W.from_jax_params(params, tcfg)
    sd = model.state_dict()
    assert sd["clip.visual.positional_embedding"].shape == (577, 1024)
    assert sd["clip.visual.conv1.weight"].shape == (1024, 3, 14, 14)
    assert sd["clip.visual.transformer.resblocks.0.attn.in_proj_weight"
              ].shape == (3072, 1024)
    assert sd["clip.transformer.resblocks.0.attn.in_proj_weight"].shape == \
        (2304, 768)
    assert sd["clip.visual.proj"].shape == (1024, 768)
    assert sd["transformerClip.resblocks.0.mlp.c_fc.weight"].shape == \
        (3072, 768)
    back = W.to_jax_params(sd, tcfg)
    flat_back = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_want = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(flat_back) == len(flat_want)
    for (pa, a), (pb, b) in zip(flat_back, flat_want):
        assert pa == pb
        np.testing.assert_array_equal(a, np.asarray(b),
                                      err_msg=jax.tree_util.keystr(pa))
    again = W.from_jax_params(back, tcfg).state_dict()
    assert set(again) == set(sd)
    assert all(torch.equal(again[k], sd[k]) for k in sd)
