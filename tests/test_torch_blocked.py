"""The port's blocked long-token similarity against the JAX package's
blocked Pallas kernel (interpret mode) on the CPU, and micro-batched
gradients against monolithic ones.

On the CPU the port's wrapper runs its plain chunked version with the
written-out first-index backward, the reference its CUDA kernels are held
to on the card (tests/test_torch_gpu.py).  Shapes and tolerances are those
of tests/test_pallas_similarity_blocked.py: forward 1e-5 (fp32 sums in
another order), gradients rtol 2e-4 / atol 2e-5; the tie tests, where both
sides route to the first index, rtol 1e-5 / atol 1e-6.
"""

import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neighborretr_tpu.ops import pallas_similarity_blocked as jblk
from neighborretr_tpu_torch.core import config as tc
from neighborretr_tpu_torch.data.datasets.synthetic import make_synthetic_batch
from neighborretr_tpu_torch.models import weights_io as W
from neighborretr_tpu_torch.ops import similarity as S
from neighborretr_tpu_torch.ops import similarity_blocked as SB
from neighborretr_tpu_torch.train import memory_bank as tmb
from neighborretr_tpu_torch.train import step as tstep


def make_inputs(seed, A, B, T, V, D, ragged=False):
    rng = np.random.default_rng(seed)
    t_feat = rng.normal(size=(A, T, D)).astype(np.float32)
    v_feat = rng.normal(size=(B, V, D)).astype(np.float32)
    t_mask = np.ones((A, T), np.float32)
    v_mask = np.ones((B, V), np.float32)
    if ragged:      # every caption and video its own length
        t_mask = (np.arange(T)[None] < rng.integers(1, T + 1, A)[:, None]
                  ).astype(np.float32)
        v_mask = (np.arange(V)[None] < rng.integers(1, V + 1, B)[:, None]
                  ).astype(np.float32)
    else:
        t_mask[0, T // 2:] = 0
        v_mask[-1, V - 1] = 0
    tw = rng.uniform(0.1, 1.0, size=(A, T)).astype(np.float32)
    tw /= tw.sum(-1, keepdims=True)
    vw = rng.uniform(0.1, 1.0, size=(B, V)).astype(np.float32)
    vw /= vw.sum(-1, keepdims=True)
    return t_feat, v_feat, t_mask, v_mask, tw, vw


def jax_forward(args):
    return np.asarray(jblk.pallas_interaction_similarity_blocked(
        *map(jnp.asarray, args), interpret=True))


def jax_grads(args, probe):
    tf, vf, tm, vm, tw, vw = map(jnp.asarray, args)

    def loss(tf, vf, tw, vw):
        return jnp.sum(jblk.pallas_interaction_similarity_blocked(
            tf, vf, tm, vm, tw, vw, interpret=True) * jnp.asarray(probe))

    return [np.asarray(g) for g in
            jax.grad(loss, argnums=(0, 1, 2, 3))(tf, vf, tw, vw)]


def torch_grads(args, probe):
    leaves = [torch.tensor(a, requires_grad=i in (0, 1, 4, 5))
              for i, a in enumerate(args)]
    out = SB.fused_interaction_similarity_blocked(*leaves)
    (out * torch.tensor(probe)).sum().backward()
    return out.detach().numpy(), [leaves[i].grad.numpy() for i in (0, 1, 4, 5)]


@pytest.mark.parametrize("A,B,T,V,D,ragged", [
    (8, 16, 24, 12, 32, False),    # default-recipe token shape
    (8, 16, 64, 64, 32, False),    # the 64w/64f long-token recipe shape
    (4, 24, 64, 64, 32, False),    # batch dims that pad on the TPU side
    (8, 16, 7, 5, 32, False),      # odd token counts
    (6, 10, 64, 32, 32, True),     # ragged masks, T·V = 2048
    (5, 9, 64, 64, 16, True)])     # ragged masks, T·V = 4096
def test_forward_matches_jax_blocked_kernel(A, B, T, V, D, ragged):
    args = make_inputs(A * B + T, A, B, T, V, D, ragged)
    got = SB.fused_interaction_similarity_blocked(*map(torch.tensor, args))
    assert got.shape == (A, B) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), jax_forward(args), rtol=1e-5,
                               atol=1e-5)
    # and the un-chunked plain form the flat kernel is held to
    np.testing.assert_allclose(
        got.numpy(), S.interaction_similarity(*map(torch.tensor, args)).numpy(),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("A,B,T,V,D,ragged", [(8, 16, 24, 12, 32, False),
                                              (8, 16, 64, 64, 16, False),
                                              (4, 24, 33, 16, 16, False),
                                              (6, 10, 64, 32, 16, True)])
def test_gradients_match_jax_blocked_kernel(A, B, T, V, D, ragged):
    args = make_inputs(A + B + V, A, B, T, V, D, ragged)
    probe = np.random.default_rng(1).normal(size=(A, B)).astype(np.float32)
    _, got = torch_grads(args, probe)
    for g, want, name in zip(got, jax_grads(args, probe),
                             ("t_feat", "v_feat", "t_weight", "v_weight")):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, want, rtol=2e-4, atol=2e-5,
                                   err_msg=name)


SIDES = {"text": (0, 4, 5), "video": (1, 4, 5), "both": (0, 1, 4, 5)}


@pytest.mark.parametrize("side", ["text", "video", "both"])
@pytest.mark.parametrize("A,B,T,V,D,ragged", [(8, 16, 64, 64, 16, False),
                                              (4, 24, 33, 16, 16, False),
                                              (6, 10, 64, 32, 16, True),
                                              (5, 7, 1, 64, 16, True),
                                              (5, 7, 64, 1, 16, True)])
def test_routed_backward_matches_jax_blocked_kernel(A, B, T, V, D, ragged,
                                                    side):
    """The backward from the forward's saved routing with one side of
    features asking for a gradient, or both: None for a side not asked
    for, the rest the Pallas kernel's VJP (tolerances as above)."""
    args = make_inputs(A + 2 * B + T, A, B, T, V, D, ragged)
    probe = np.random.default_rng(5).normal(size=(A, B)).astype(np.float32)
    leaves = [torch.tensor(a, requires_grad=i in SIDES[side])
              for i, a in enumerate(args)]
    (SB.fused_interaction_similarity_blocked(*leaves)
     * torch.tensor(probe)).sum().backward()
    want = jax_grads(args, probe)
    for k, i in enumerate((0, 1, 4, 5)):
        if i not in SIDES[side]:
            assert leaves[i].grad is None
            continue
        np.testing.assert_allclose(leaves[i].grad.numpy(), want[k],
                                   rtol=2e-4, atol=2e-5)


def test_routing_chunks_do_not_change_the_result():
    """The chunked routing is the whole routing, bit for bit; the chunked
    routed backward is the whole one within fp32 round-off, each side."""
    args = [torch.tensor(a) for a in make_inputs(19, 5, 11, 16, 8, 32, True)]
    tn, vn, tw, vw = S._prepare(*args, False)
    g = torch.randn(5, 11, generator=torch.Generator().manual_seed(3))
    cap = 5 * 16 * 8 * 4                        # one video per chunk
    whole_s, whole = S.similarity_routing_plain(tn, vn, tw, vw)
    got_s, got = SB.similarity_blocked_routing_plain(tn, vn, tw, vw, cap)
    assert torch.equal(got_s, whole_s)
    assert all(torch.equal(a, b) for a, b in zip(got, whole))
    for need_t, need_v in ((True, True), (True, False), (False, True)):
        a = SB.similarity_blocked_bwd_routed_plain(
            tn, vn, tw, vw, g, *got, need_t, need_v, cap)
        b = S.similarity_bwd_routed_plain(tn, vn, tw, vw, g, *whole, need_t,
                                          need_v)
        for x, y in zip(a, b):
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5,
                                           atol=1e-6)


def test_routing_hook_sees_and_replaces_the_plain_routing(monkeypatch):
    """The diagnostic hook gets the winners the backward routes by, all B
    videos at once; on the plain path what it returns is routed by."""
    args = make_inputs(21, 3, 5, 8, 6, 16, True)
    seen = []

    def grads(hook):
        monkeypatch.setattr(SB, "routing_hook", hook)
        leaves = [torch.tensor(a, requires_grad=i in (0, 1, 4, 5))
                  for i, a in enumerate(args)]
        SB.fused_interaction_similarity_blocked(*leaves).sum().backward()
        return [leaves[i].grad for i in (0, 1)]

    def record(i1, i2, videos, n):
        seen.append((i1.clone(), i2.clone(), videos, n))

    def shifted(i1, i2, videos, n):      # every text token to video token 0
        return torch.zeros_like(i1), i2

    base = grads(record)
    (i1, i2, videos, n), = seen
    assert i1.shape == (3, 5, 8) and i2.shape == (3, 5, 6)
    assert videos == slice(0, 5) and n == 5
    assert all(torch.equal(a, b) for a, b in zip(base, grads(None)))
    moved = grads(shifted)
    assert not torch.allclose(moved[0], base[0])


def test_gradient_ties_route_to_the_first_index():
    """Duplicated token features tie the max over v and over t: both sides
    send the gradient to the first index, where autograd of amax would
    split it."""
    A, B, T, V, D = 4, 8, 8, 6, 16
    rng = np.random.default_rng(3)
    t_feat = rng.normal(size=(A, T, D)).astype(np.float32)
    v_feat = rng.normal(size=(B, V, D)).astype(np.float32)
    v_feat[:, 3] = v_feat[:, 1]
    t_feat[:, 5] = t_feat[:, 2]
    args = (t_feat, v_feat, np.ones((A, T), np.float32),
            np.ones((B, V), np.float32), np.full((A, T), 1 / T, np.float32),
            np.full((B, V), 1 / V, np.float32))
    probe = np.ones((A, B), np.float32)
    _, got = torch_grads(args, probe)
    want = jax_grads(args, probe)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    # the later duplicate gets nothing from the max over v
    split = [torch.tensor(a, requires_grad=i == 1) for i, a in enumerate(args)]
    S.interaction_similarity(*split).sum().backward()
    assert not np.allclose(split[1].grad.numpy(), got[1], atol=1e-6)


def test_gradient_ties_across_jax_chunks(monkeypatch):
    """The TPU kernel walks the video tokens in chunks and must keep the
    first index across them (two chunks forced on the JAX side only); the
    port's plain version sees a video's tokens at once."""
    A, B, T, V, D = 4, 8, 8, 8, 16
    monkeypatch.setattr(jblk, "_choose_blocks", lambda *a: (4, 8, V // 2))
    rng = np.random.default_rng(4)
    t_feat = rng.normal(size=(A, T, D)).astype(np.float32)
    v_feat = rng.normal(size=(B, V, D)).astype(np.float32)
    v_feat[:, 6] = v_feat[:, 1]          # chunk 0 (v=1) ties chunk 1 (v=6)
    args = (t_feat, v_feat, np.ones((A, T), np.float32),
            np.ones((B, V), np.float32), np.full((A, T), 1 / T, np.float32),
            np.full((B, V), 1 / V, np.float32))
    probe = np.ones((A, B), np.float32)
    out, got = torch_grads(args, probe)
    np.testing.assert_allclose(out, jax_forward(args), rtol=1e-5, atol=1e-6)
    want = jax_grads(args, probe)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    assert not got[1][:, 6].any() or np.abs(got[1][:, 6]).max() < \
        np.abs(got[1][:, 1]).max()


def test_canonical_tokens_find_identical_vectors():
    """Each token's first bit-identical token in its row: duplicates and
    the zero rows of masked tokens share one; distinct vectors keep their
    own index."""
    x = torch.randn(3, 6, 32, generator=torch.Generator().manual_seed(1))
    x[0, 4] = x[0, 1]
    x[1, 3:] = 0
    x[2, 5] = x[2, 0] * (1 + 2 ** -20)        # close, but not identical
    got = S.canonical_tokens(x)
    assert got.dtype == torch.uint8
    assert got.tolist() == [[0, 1, 2, 3, 1, 5], [0, 1, 2, 3, 3, 3],
                            [0, 1, 2, 3, 4, 5]]


@pytest.mark.parametrize("T,V", [(7, 5), (64, 64)])
def test_resolve_near_ties_repicks_float64_first_argmax(T, V):
    """Flagged saved indices (the kernel's TIE_FLAG, whatever index they
    carry) become the first argmax of the float64 logits and lose the flag;
    unflagged ones are left alone; the count is the number flagged."""
    A, B, D = 3, 4, 24
    g = torch.Generator().manual_seed(T)
    tn = S.l2_normalize(torch.randn(A, T, D, generator=g))
    vn = S.l2_normalize(torch.randn(B, V, D, generator=g))
    vn[:, V - 1] = vn[:, 0]                 # ties of identical tokens
    _, (m1, i1, m2, i2) = SB.similarity_blocked_routing_plain(
        tn.double(), vn.double(), torch.ones(A, T, dtype=torch.float64) / T,
        torch.ones(B, V, dtype=torch.float64) / V)
    want = (i1.clone(), i2.clone())
    saved = []
    for idx, k in ((i1, T), (i2, V)):
        pad = torch.full(idx.shape[:2] + (S._pad16(k),), 7, dtype=torch.uint8)
        pad[..., :k] = idx
        flag = torch.rand(idx.shape, generator=g) < 0.3
        wrong = (idx.long() + 1 + torch.randint(0, k, idx.shape,
                                                generator=g)) % k
        pad[..., :k] = torch.where(flag, wrong.to(torch.uint8) | S.TIE_FLAG,
                                   idx)
        saved.append((pad, int(flag.sum())))
    (r1, n1), (r2, n2) = saved
    assert S.resolve_near_ties(tn, vn, m1.float(), r1, m2.float(), r2) == \
        n1 + n2
    assert torch.equal(r1[..., :T], want[0]) and torch.equal(r2[..., :V],
                                                             want[1])
    assert (r1[..., T:] == 7).all() and (r2[..., V:] == 7).all()


def test_plain_backward_chunks_do_not_change_the_result():
    args = [torch.tensor(a) for a in make_inputs(9, 5, 11, 16, 8, 32, True)]
    tn, vn, tw, vw = S._prepare(*args, False)
    g = torch.randn(5, 11, generator=torch.Generator().manual_seed(0))
    whole = S.similarity_bwd_plain(tn, vn, tw, vw, g)
    # a cap of one video's logits: 11 chunks
    cap = 5 * 16 * 8 * 4
    np.testing.assert_allclose(
        SB.similarity_blocked_plain(tn, vn, tw, vw, cap).numpy(),
        S._similarity_plain(tn, vn, tw, vw).numpy(), rtol=1e-6, atol=1e-7)
    for a, b in zip(SB.similarity_blocked_bwd_plain(tn, vn, tw, vw, g, cap),
                    whole):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


def test_local_similarity_routes_long_tokens_to_the_blocked_form():
    from neighborretr_tpu_torch.models import neighborretr as M
    m = tc.ModelConfig.tiny(max_words=64, max_frames=32)
    model = W.init_model(m, 0)
    assert not M.bank_fusion_supported(m)
    assert M.bank_fusion_supported(tc.ModelConfig.tiny(max_words=24,
                                                       max_frames=12))
    args = [torch.tensor(a) for a in make_inputs(2, 3, 5, 64, 32, m.width,
                                                 True)]
    tf, vf, tm, vm = args[:4]
    before = SB.fused_interaction_similarity_blocked.launches
    got = M.local_similarity(model, tf, vf, tm, vm)
    assert SB.fused_interaction_similarity_blocked.launches == before  # CPU
    tw = M.token_weights(model.text_weight_fc, tf, tm)
    vw = M.token_weights(model.video_weight_fc, vf, vm)
    np.testing.assert_allclose(
        got.detach().numpy(),
        S.interaction_similarity(tf, vf, tm, vm, tw, vw).detach().numpy(),
        rtol=1e-5, atol=1e-6)


def test_local_similarity_on_a_prepared_corpus_at_long_tokens(monkeypatch):
    """The blocked form on a corpus prepared once (`prepare_corpus`, in
    slabs of 2 videos) gives the per-call form's S within 1e-6."""
    from neighborretr_tpu_torch.models import neighborretr as M
    m = tc.ModelConfig.tiny(max_words=64, max_frames=32)
    model = W.init_model(m, 0)
    tf, vf, tm, vm = [torch.tensor(a) for a in make_inputs(
        3, 3, 5, 64, 32, m.width, True)[:4]]
    monkeypatch.setattr(M, "CORPUS_SLAB_ROWS", 2)
    corpus = M.prepare_corpus(model, vf, vm)
    got = M.local_similarity(model, tf, None, tm, None, corpus=corpus)
    np.testing.assert_allclose(
        got.detach().numpy(),
        M.local_similarity(model, tf, vf, tm, vm).detach().numpy(),
        rtol=0, atol=1e-6)


def micro_config(micro_batches, max_words=8, max_frames=4):
    model = tc.ModelConfig.tiny(max_words=max_words, max_frames=max_frames)
    return tc.Config(
        model=model, loss=tc.LossConfig(num_neighbors=3),
        data=tc.DataConfig(max_words=max_words, max_frames=max_frames),
        train=tc.TrainConfig(batch_size=8, mb_batch=2,
                             micro_batches=micro_batches))


@pytest.mark.parametrize("max_words,max_frames", [(8, 4), (64, 32)])
@pytest.mark.parametrize("n", [2, 4])
def test_microbatched_gradients_equal_monolithic(n, max_words, max_frames):
    """GradCache in two passes gives the gradients of the monolithic encode
    at a short and a long-token shape: the whole gradient within 1e-6
    relative L2 distance, each tensor within 1e-5 of its own norm (fp32
    matmuls block another batch size differently, and small tensors that
    are sums of cancelling terms keep ~2e-6 of that noise; the JAX
    package's own test allows rtol 2e-4)."""
    cfg1 = micro_config(1, max_words, max_frames)
    cfgn = micro_config(n, max_words, max_frames)
    m = cfg1.model
    model = W.init_model(m, 3)
    for name, p in model.named_parameters():
        p.requires_grad_(name != "clip.visual.conv1.weight")
    batch = make_synthetic_batch(m, 8, seed=4)
    batch["video_mask"][1, 2:] = 0
    batch = tstep.to_device(batch, "cpu")
    rng = np.random.default_rng(6)
    cap = 16
    bank = tmb.MemoryBank(
        torch.arange(cap, dtype=torch.int32),
        torch.tensor(rng.normal(size=(cap, max_words, m.width)), dtype=torch.float32),
        torch.tensor(rng.normal(size=(cap, max_frames, m.width)), dtype=torch.float32),
        torch.ones(cap, max_words), torch.ones(cap, max_frames))

    model.zero_grad(set_to_none=True)
    total, aux1 = tstep.compute_losses(model, cfg1, batch, bank)
    total.backward()
    want = {k: p.grad.clone() for k, p in model.named_parameters()
            if p.grad is not None}
    model.zero_grad(set_to_none=True)
    auxn = tstep._microbatched_backward(model, cfgn, batch, bank, None, True)
    got = {k: p.grad for k, p in model.named_parameters()
           if p.grad is not None}
    assert got.keys() == want.keys() and len(got) > 100
    np.testing.assert_allclose(auxn["loss"].item(), aux1["loss"].item(),
                               rtol=1e-6)
    whole = sum(w.norm().item() ** 2 for w in want.values()) ** 0.5
    sq_dist = 0.0
    for k in want:
        assert torch.isfinite(got[k]).all(), k
        dist = (got[k] - want[k]).norm().item()
        # the second term: a tensor whose gradient is analytically zero (a
        # softmax's shared bias) holds rounding noise only
        assert dist <= 1e-5 * want[k].norm().item() + 1e-7 * whole, (k, dist)
        sq_dist += dist ** 2
    assert sq_dist ** 0.5 <= 1e-6 * whole


def test_long_token_train_steps_match_jax():
    """The slice as a whole at a long-token shape (32 words x 64 frames,
    T·V = 2048, `micro_batches=2`, a bank of two batches): bank fill and two
    optimizer steps in both packages from the same weights; every loss term
    within 1e-4 relative and every parameter tensor within 1e-4 (the first
    update is zero under the completed-step schedule, hence two steps).  The
    JAX side runs its chunked plain form on the CPU; the in-batch matrix and
    both bank matrices go through the blocked form in the port."""
    import jax
    import jax.numpy as jnp

    from neighborretr_tpu.core import config as jc
    from neighborretr_tpu.models import neighborretr as jm
    from neighborretr_tpu.train import memory_bank as jmb
    from neighborretr_tpu.train import step as jstep

    WORDS, FRAMES, B = 32, 64, 8

    def config(mod):
        model = dc.replace(mod.ModelConfig.tiny(max_words=WORDS,
                                                max_frames=FRAMES),
                           cluster_noise=False)
        return mod.Config(
            model=model, loss=mod.LossConfig(num_neighbors=3),
            optim=mod.OptimizerConfig(lr=1e-2, coef_lr=0.1),
            data=mod.DataConfig(max_words=WORDS, max_frames=FRAMES),
            train=mod.TrainConfig(batch_size=B, mb_batch=2, micro_batches=2))

    jcfg, tcfg = config(jc), config(tc)
    m = jcfg.model
    params = jm.init_params(jax.random.PRNGKey(0), m)
    model = W.from_jax_params(jax.device_get(params), tcfg.model)
    start = model.clip.text_projection.detach().clone().numpy()
    batches = []
    for s in range(4):
        b = make_synthetic_batch(m, B, seed=40 + s)
        b["video_mask"][1, 20:] = 0
        b["idx"] = b["idx"] + 100 * s
        batches.append(b)
    cap = jcfg.train.memory_bank_capacity

    jbank = jmb.create(cap, WORDS, FRAMES, m.width)
    for i, b in enumerate(batches[:2]):
        jbank = jstep.fill_bank_step(params, jbank, jax.tree.map(
            jnp.asarray, b), jcfg, i * B)
    jstate = jstep.create_train_state(params, jbank)
    jmetrics = []
    for i, b in enumerate(batches[2:]):
        jstate, met = jstep.train_step(jstate, jax.tree.map(jnp.asarray, b),
                                       jax.random.PRNGKey(i), jcfg, 10)
        jmetrics.append(jax.device_get(met))

    before = SB.fused_interaction_similarity_blocked.launches
    tbank = tmb.create(cap, WORDS, FRAMES, m.width)
    for i, b in enumerate(batches[:2]):
        tbank = tstep.fill_bank_step(model, tbank, tstep.to_device(b, "cpu"),
                                     tcfg, i * B)
    tstate = tstep.create_train_state(model, tbank)
    for i, b in enumerate(batches[2:]):
        tstate, met = tstep.train_step(tstate, tstep.to_device(b, "cpu"),
                                       tcfg, 10)
        for k in ("loss", "centrality_loss", "uniform_loss", "neighbor_loss",
                  "kl_loss", "grad_norm"):
            assert np.isfinite(met[k].item()), k
            np.testing.assert_allclose(met[k].item(), float(jmetrics[i][k]),
                                       rtol=1e-4, err_msg=f"step {i + 1} {k}")
    assert SB.fused_interaction_similarity_blocked.launches == before  # CPU

    got = W.to_jax_params(tstate.model.state_dict(), tcfg.model)
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = jax.tree_util.tree_flatten_with_path(
        jax.device_get(jstate.params))[0]
    assert len(flat_got) == len(flat_want)
    for (pa, a), (pb, b) in zip(flat_got, flat_want):
        assert pa == pb and np.isfinite(a).all()
        assert np.abs(a - np.asarray(b)).max() <= 1e-4, \
            jax.tree_util.keystr(pa)
    assert not np.array_equal(got["clip"]["text"]["text_projection"], start)
    for a, b in zip(tstate.bank, jax.device_get(jstate.bank)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
