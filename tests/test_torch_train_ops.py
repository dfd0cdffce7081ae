"""The training kernels' plain versions, and the clustering and merging
modules, against the JAX package.

  * the plain attention-sublayer backward against the TPU kernel
    (`_ln_bwd_call`) in interpret mode, all seven outputs, with and without
    a bias;
  * the plain bank-centrality mean against `pallas_interaction_mean` in
    interpret mode, both axes, with padding;
  * the plain similarity backward (first-index routing written out) against
    `jax.grad` through `pallas_interaction_similarity` in interpret mode,
    on inputs built to tie;
  * DPC-KNN, `merge_tokens` and the CTM stack against their JAX functions,
    the tie-break noise fed to both as the same draws.

Inputs come from a numpy seed and go to both frameworks as numpy arrays.
The CUDA kernels are held to these plain versions in test_torch_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neighborretr_tpu.models import ctm as jctm
from neighborretr_tpu.ops import cluster as jcluster
from neighborretr_tpu.ops.pallas_attention import _pick_fb
from neighborretr_tpu.ops.pallas_block_attention import _ln_bwd_call
from neighborretr_tpu.ops.pallas_similarity import (
    pallas_interaction_mean, pallas_interaction_similarity)
from neighborretr_tpu_torch.models import ctm as tctm
from neighborretr_tpu_torch.ops import block_attention as BA
from neighborretr_tpu_torch.ops import cluster as tcluster
from neighborretr_tpu_torch.ops import similarity as S
from test_torch_ops import sim_inputs


def T(a, dtype=None):
    t = torch.as_tensor(np.array(a))
    return t if dtype is None else t.to(dtype)


# ---------------------------------------------------------------------------
# K3: attention-sublayer backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,L,D,H,biased", [(4, 10, 128, 2, False),
                                            (6, 7, 64, 1, True),
                                            (2, 24, 128, 2, True)])
def test_attention_backward_plain_matches_tpu_kernel(N, L, D, H, biased):
    """bf16 in both: the two round at the same points, so they differ only
    where differently ordered fp32 sums flip a bf16 rounding.  dx (bf16) is
    held to two bf16 steps elementwise; the summed gradients to 2^-7 of the
    tensor's largest entry (the TPU kernel returns the weight gradients in
    bf16: 2^-9 of rounding on top of the flips)."""
    rng = np.random.default_rng(N * L)
    x = rng.standard_normal((N, L, D)).astype(np.float32)
    g = rng.standard_normal((N, L, D)).astype(np.float32)
    ln_w = (1 + 0.3 * rng.standard_normal(D)).astype(np.float32)
    ln_b = (0.1 * rng.standard_normal(D)).astype(np.float32)
    w_qkv = (rng.standard_normal((3 * D, D)) * D ** -0.5).astype(np.float32)
    b_qkv = (0.1 * rng.standard_normal(3 * D)).astype(np.float32)
    w_out = (rng.standard_normal((D, D)) * D ** -0.5).astype(np.float32)
    b_out = (0.1 * rng.standard_normal(D)).astype(np.float32)
    bias = None
    if biased:
        lens = rng.integers(1, L + 1, size=N)
        j = np.arange(L)
        bias = (np.where(j[None, :] > j[:, None], -1e9, 0.0)[None]
                + np.where(j[None] < lens[:, None], 0.0, -1e9)[:, None, :]
                ).astype(np.float32)

    bf = jnp.bfloat16
    meta = (N, L, H, D // H, _pick_fb(N, L, 200), True)
    want = _ln_bwd_call(
        jnp.asarray(x, bf), None if bias is None else jnp.asarray(bias),
        jnp.asarray(ln_w)[None], jnp.asarray(ln_b)[None],
        jnp.asarray(w_qkv.T, bf), jnp.asarray(b_qkv)[None],
        jnp.asarray(w_out.T, bf), jnp.asarray(b_out)[None],
        jnp.asarray(g, bf), meta)
    want = [np.asarray(a.astype(jnp.float32)) for a in want]
    # the TPU kernel keeps input-major weights and [1, D] vectors
    want = [want[0], want[1][0], want[2][0], want[3].T, want[4][0],
            want[5].T, want[6][0]]

    b16 = torch.bfloat16
    got = BA.ln_attention_residual_bwd(
        T(x, b16), T(ln_w), T(ln_b), T(w_qkv, b16), T(b_qkv), T(w_out, b16),
        T(b_out), H, T(g, b16), None if bias is None else T(bias))
    assert got[0].dtype == b16
    got = [a.float().numpy() for a in got]
    np.testing.assert_allclose(got[0], want[0], atol=2 ** -6, rtol=2 ** -6)
    names = ("dln_w", "dln_b", "dw_qkv", "db_qkv", "dw_out", "db_out")
    for name, a, b in zip(names, got[1:], want[1:]):
        assert a.shape == b.shape, name
        assert np.isfinite(a).all(), name
        assert np.abs(a - b).max() <= 2 ** -7 * np.abs(b).max(), name


def test_attention_sublayer_autograd_is_the_plain_backward():
    """fp32 on the CPU: nothing is rounded, so the autograd node's written
    backward is the exact gradient of the plain forward (1e-5: fp32 sums in
    another order)."""
    rng = np.random.default_rng(5)
    N, L, D, H = 3, 6, 128, 2
    arrs = [rng.standard_normal((N, L, D)), 1 + 0.1 * rng.standard_normal(D),
            0.1 * rng.standard_normal(D),
            rng.standard_normal((3 * D, D)) * D ** -0.5,
            0.1 * rng.standard_normal(3 * D),
            rng.standard_normal((D, D)) * D ** -0.5,
            0.1 * rng.standard_normal(D)]
    bias = T(rng.standard_normal((N, L, L)).astype(np.float32))
    g = T(rng.standard_normal((N, L, D)).astype(np.float32))

    def leaves():
        return [T(a.astype(np.float32)).requires_grad_(True) for a in arrs]

    a, b = leaves(), leaves()
    before = BA.ln_attention_residual_bwd.launches
    BA.ln_attention_sublayer(*a, H, bias).backward(g)
    BA.ln_attention_residual_plain(*b, H, bias).backward(g)
    assert BA.ln_attention_residual_bwd.launches == before   # CPU: no launch
    for got, want in zip(a, b):
        np.testing.assert_allclose(got.grad.numpy(), want.grad.numpy(),
                                   atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# K4: bank-centrality mean
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("A,B,T_,V,D", [(10, 37, 6, 4, 32),
                                        (5, 130, 24, 12, 32)])
def test_interaction_mean_plain_matches_pallas(A, B, T_, V, D, axis):
    """fp32 against fp32; A and B off the TPU kernel's tiles, ragged masks
    (the JAX suite's tolerance for this kernel)."""
    args = sim_inputs(A + B + axis, A, B, T_, V, D)
    want = np.asarray(pallas_interaction_mean(*map(jnp.asarray, args),
                                              axis=axis, interpret=True))
    targs = [T(a) for a in args]
    got = S.interaction_mean(*targs, axis=axis).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
    before = S.fused_interaction_mean.launches
    wrapped = S.fused_interaction_mean(*targs, axis=axis).numpy()
    assert S.fused_interaction_mean.launches == before        # CPU: no launch
    np.testing.assert_allclose(wrapped, want, atol=2e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# K5: similarity backward, first-index routing
# ---------------------------------------------------------------------------

def tie_inputs(seed, A, B, T_, V, D):
    """Ragged masks (whole rows of zero logits) and, in every video, the
    last token a copy of the first (exact ties among live logits)."""
    tf, vf, tm, vm, tw, vw = sim_inputs(seed, A, B, T_, V, D)
    vf[:, V - 1] = vf[:, 0]
    vm[:, V - 1] = vm[:, 0] = 1
    return tf, vf, tm, vm, tw, vw


def port_similarity_grads(args, probe, axis=None):
    leaves = [T(a).requires_grad_(i in (0, 1, 4, 5))
              for i, a in enumerate(args)]
    if axis is None:
        out = S.fused_interaction_similarity(*leaves, kernels=False)
    else:
        out = S.fused_interaction_mean(*leaves, axis=axis)
    (out * T(probe)).sum().backward()
    return [leaves[i].grad.numpy() for i in (0, 1, 4, 5)]


@pytest.mark.parametrize("A,B,T_,V,D", [(6, 9, 5, 4, 32), (3, 20, 12, 6, 16)])
def test_similarity_backward_plain_matches_pallas_grad(A, B, T_, V, D,
                                                       monkeypatch):
    args = tie_inputs(A * B, A, B, T_, V, D)
    probe = np.random.default_rng(1).normal(size=(A, B)).astype(np.float32)
    tf, vf, tm, vm, tw, vw = map(jnp.asarray, args)

    def loss(tf, vf, tw, vw):
        return jnp.sum(pallas_interaction_similarity(
            tf, vf, tm, vm, tw, vw, interpret=True) * probe)

    want = [np.asarray(a) for a in
            jax.grad(loss, argnums=(0, 1, 2, 3))(tf, vf, tw, vw)]
    got = port_similarity_grads(args, probe)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=1e-4)

    # the case does tell first-index from last-index routing: sending each
    # max's gradient to the LAST index that attains it moves the video side
    first_argmax = S._first_argmax

    def last_argmax(x, dim):
        return x.shape[dim] - 1 - first_argmax(x.flip(dim), dim)

    monkeypatch.setattr(S, "_first_argmax", last_argmax)
    wrong = port_similarity_grads(args, probe)
    assert np.abs(wrong[1] - want[1]).max() > 1e-3


@pytest.mark.parametrize("axis", [0, 1])
def test_interaction_mean_gradient_matches_pallas(axis):
    A, B, T_, V, D = 6, 19, 8, 4, 32
    args = tie_inputs(3 + axis, A, B, T_, V, D)
    probe = np.random.default_rng(2).normal(
        size=(A if axis == 1 else B,)).astype(np.float32)
    tf, vf, tm, vm, tw, vw = map(jnp.asarray, args)

    def loss(tf, vf, tw, vw):
        return jnp.sum(pallas_interaction_mean(
            tf, vf, tm, vm, tw, vw, axis=axis, interpret=True) * probe)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(tf, vf, tw, vw)
    for a, b in zip(port_similarity_grads(args, probe, axis), want):
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-5, rtol=1e-4)


# The backward from the forward's saved routing, one feature side or both:
# the side autograd does not ask for gets no gradient (the memory bank's
# side is detached in the train step), the others are the Pallas VJP's.
SIDES = {"text": (0, 4, 5), "video": (1, 4, 5), "both": (0, 1, 4, 5)}


def jax_similarity_grads(args, probe, axis=None):
    tf, vf, tm, vm, tw, vw = map(jnp.asarray, args)

    def loss(tf, vf, tw, vw):
        if axis is None:
            out = pallas_interaction_similarity(tf, vf, tm, vm, tw, vw,
                                                interpret=True)
        else:
            out = pallas_interaction_mean(tf, vf, tm, vm, tw, vw, axis=axis,
                                          interpret=True)
        return jnp.sum(out * probe)

    return [np.asarray(g) for g in
            jax.grad(loss, argnums=(0, 1, 2, 3))(tf, vf, tw, vw)]


def port_side_grads(args, probe, side, axis=None):
    """The port's gradients of sum(out * probe) with only `side`'s features
    (and both weights) asking for one: None where none was asked."""
    leaves = [T(a).requires_grad_(i in SIDES[side])
              for i, a in enumerate(args)]
    if axis is None:
        out = S.fused_interaction_similarity(*leaves, kernels=False)
    else:
        out = S.fused_interaction_mean(*leaves, axis=axis)
    (out * T(probe)).sum().backward()
    return [None if leaves[i].grad is None else leaves[i].grad.numpy()
            for i in (0, 1, 4, 5)]


@pytest.mark.parametrize("side", ["text", "video", "both"])
@pytest.mark.parametrize("A,B,T_,V,D", [(6, 9, 5, 4, 32), (3, 20, 12, 6, 16),
                                        (4, 7, 1, 3, 16), (5, 6, 8, 1, 16)])
def test_routed_backward_plain_matches_pallas_vjp(A, B, T_, V, D, side):
    """Ties on purpose (masked rows, a duplicated video token); T = 1 and
    V = 1 included.  fp32: the JAX suite's tolerance for this kernel."""
    args = tie_inputs(A + 3 * B + T_, A, B, T_, V, D)
    probe = np.random.default_rng(4).normal(size=(A, B)).astype(np.float32)
    want = jax_similarity_grads(args, probe)
    got = port_side_grads(args, probe, side)
    for k, (g, w) in enumerate(zip(got, want)):
        if k < 2 and (0, 1)[k] not in SIDES[side]:
            assert g is None
            continue
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("side", ["text", "video"])
@pytest.mark.parametrize("axis", [0, 1])
def test_routed_mean_backward_matches_pallas_vjp(axis, side):
    """The bank centrality as the train step differentiates it: one side
    of features asks for a gradient (cent_t: the captions, cent_v: the
    videos), both weights do."""
    A, B, T_, V, D = 6, 19, 8, 4, 32
    args = tie_inputs(5 + axis, A, B, T_, V, D)
    probe = np.random.default_rng(6).normal(
        size=(A if axis == 1 else B,)).astype(np.float32)
    want = jax_similarity_grads(args, probe, axis)
    got = port_side_grads(args, probe, side, axis)
    k_none = 1 if side == "text" else 0
    assert got[k_none] is None
    for k, (g, w) in enumerate(zip(got, want)):
        if k != k_none:
            np.testing.assert_allclose(g, w, atol=2e-5, rtol=1e-4)


def test_routing_plain_is_the_first_argmax():
    """The saved routing is the first index of each max (ties included) and
    S is the plain S to the bit."""
    A, B, T_, V, D = 5, 7, 6, 4, 16
    args = [T(a) for a in tie_inputs(11, A, B, T_, V, D)]
    tn, vn, tw, vw = S._prepare(*args, False)
    sim, (m1, i1, m2, i2) = S.similarity_routing_plain(tn, vn, tw, vw)
    assert torch.equal(sim, S._similarity_plain(tn, vn, tw, vw))
    logits = np.einsum("atd,bvd->abtv", tn.numpy(), vn.numpy())
    assert i1.dtype == torch.uint8 and i2.dtype == torch.uint8
    np.testing.assert_array_equal(i1.numpy(), np.argmax(logits, axis=3))
    np.testing.assert_array_equal(i2.numpy(), np.argmax(logits, axis=2))
    np.testing.assert_allclose(m1.numpy(), logits.max(axis=3), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(m2.numpy(), logits.max(axis=2), rtol=1e-6,
                               atol=1e-7)
    # ties do occur: every masked token's logits are all 0
    assert (logits.max(axis=3) == 0).any()


def test_routed_backward_one_side_is_the_both_side_bits():
    A, B, T_, V, D = 4, 9, 7, 3, 16
    args = [T(a) for a in tie_inputs(12, A, B, T_, V, D)]
    tn, vn, tw, vw = S._prepare(*args, False)
    g = torch.randn(A, B, generator=torch.Generator().manual_seed(1))
    _, res = S.similarity_routing_plain(tn, vn, tw, vw)
    both = S.similarity_bwd_routed_plain(tn, vn, tw, vw, g, *res)
    text = S.similarity_bwd_routed_plain(tn, vn, tw, vw, g, *res,
                                         need_v=False)
    video = S.similarity_bwd_routed_plain(tn, vn, tw, vw, g, *res,
                                          need_t=False)
    none = S.similarity_bwd_routed_plain(tn, vn, tw, vw, g, *res,
                                         need_t=False, need_v=False)
    assert text[1] is None and video[0] is None
    assert none[0] is None and none[1] is None
    assert torch.equal(text[0], both[0]) and torch.equal(video[1], both[1])
    for one in (text, video, none):
        assert torch.equal(one[2], both[2]) and torch.equal(one[3], both[3])
    # the CPU wrapper of the kernel is this plain backward
    before = S.fused_similarity_bwd.launches
    wrapped = S.fused_similarity_bwd(tn, vn, tw, vw, g, *res, need_v=False)
    assert S.fused_similarity_bwd.launches == before
    assert wrapped[1] is None and torch.equal(wrapped[0], text[0])


@pytest.mark.parametrize("axis", [None, 0, 1])
def test_detached_partner_gets_no_gradient(axis):
    """A detached bank side: None for it, the needed gradients unchanged
    (bit for bit against the run that differentiates both sides)."""
    A, B, T_, V, D = 5, 8, 6, 4, 16
    args = tie_inputs(13, A, B, T_, V, D)
    probe = np.random.default_rng(2).normal(
        size=(A, B) if axis is None else
        ((A,) if axis == 1 else (B,))).astype(np.float32)
    both = port_side_grads(args, probe, "both", axis)
    one = port_side_grads(args, probe, "text", axis)
    assert one[1] is None and both[1] is not None
    for k in (0, 2, 3):
        np.testing.assert_array_equal(one[k], both[k])


# ---------------------------------------------------------------------------
# DPC-KNN, merge_tokens, CTM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,N,C,K,k,masked,noisy", [
    (4, 12, 16, 4, 3, True, True), (3, 8, 16, 3, 3, False, False),
    (5, 2, 16, 1, 3, False, True),     # fewer tokens than k: k is clamped
    (2, 4, 16, 6, 3, True, False)])    # more clusters asked than tokens
def test_cluster_dpc_knn_matches_jax(B, N, C, K, k, masked, noisy):
    rng = np.random.default_rng(N)
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    mask = None
    if masked:
        mask = (np.arange(N)[None] < rng.integers(2, N + 1, size=B)[:, None]
                ).astype(np.float32)
    key = jax.random.PRNGKey(3) if noisy else None
    # the draws cluster_dpc_knn makes from this key, fed to the port
    noise = (np.asarray(jax.random.uniform(key, (B, N), jnp.float32))
             if noisy else None)
    want = np.asarray(jcluster.cluster_dpc_knn(
        jnp.asarray(x), K, k, key,
        token_mask=None if mask is None else jnp.asarray(mask)))
    got = tcluster.cluster_dpc_knn(
        T(x), K, k, None if noise is None else T(noise),
        token_mask=None if mask is None else T(mask)).numpy()
    np.testing.assert_array_equal(got, want)


def test_pairwise_dist_and_merge_tokens_match_jax():
    rng = np.random.default_rng(0)
    B, N, C, K = 3, 9, 16, 4
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    idx = rng.integers(0, K, size=(B, N)).astype(np.int32)
    w = rng.uniform(0.1, 2.0, size=(B, N, 1)).astype(np.float32)
    # the |a|²+|b|²-2ab form cancels on the diagonal: true zeros come out
    # as ~1e-3 in both packages, in sums of another order
    off = ~np.eye(N, dtype=bool)
    d_got = tcluster.pairwise_dist(T(x)).numpy()
    d_want = np.asarray(jcluster.pairwise_dist(jnp.asarray(x)))
    np.testing.assert_allclose(d_got[:, off], d_want[:, off], atol=1e-5)
    np.testing.assert_allclose(d_got[:, ~off], d_want[:, ~off], atol=2e-3)
    want = jcluster.merge_tokens(jnp.asarray(x), jnp.asarray(idx), K,
                                 jnp.asarray(w))
    xt, wt = T(x).requires_grad_(True), T(w).requires_grad_(True)
    got = tcluster.merge_tokens(xt, T(idx), K, wt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-6, rtol=1e-5)
    # gradients through the merge weights and features (fp32, 1e-5)
    probe = rng.standard_normal((B, K, C)).astype(np.float32)
    gx, gw = jax.grad(lambda x, w: jnp.sum(jcluster.merge_tokens(
        x, jnp.asarray(idx), K, w) * probe), argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(w))
    (got * T(probe)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw), atol=1e-5)


def load_merge_stack(p, dim, heads):
    """The JAX package's merge-stack pytree in the port's four modules."""
    mods = []
    for i in (0, 1):
        c, b = tctm.CTM(dim), tctm.TCBlock(dim, heads)
        cp, bp = p[f"ctm{i}"], p[f"block{i}"]
        c.load_state_dict({
            "conv.conv.weight": T(np.asarray(cp["conv"]["w"]).transpose(2, 1, 0)),
            "norm.weight": T(cp["norm"]["scale"]),
            "norm.bias": T(cp["norm"]["bias"]),
            "score.weight": T(np.asarray(cp["score"]["w"]).T),
            "score.bias": T(cp["score"]["b"])})
        sd = {"norm1.weight": T(bp["norm1"]["scale"]),
              "norm1.bias": T(bp["norm1"]["bias"])}
        for lin in ("q", "kv", "proj"):
            sd[f"attn.{lin}.weight"] = T(np.asarray(bp[lin]["w"]).T)
            sd[f"attn.{lin}.bias"] = T(bp[lin]["b"])
        b.load_state_dict(sd)
        mods += [c, b]
    return mods


@pytest.mark.parametrize("noisy", [False, True])
def test_merge_to_global_matches_jax(noisy):
    """The two-stage CTM + TCBlock stack, forward and the gradient to its
    input (fp32; 1e-5 absolute on O(1) features)."""
    rng = np.random.default_rng(4)
    B, N, C, heads, sizes, k = 4, 12, 32, 4, (4, 2), 3
    p = jax.device_get(jctm.init_merge_stack(jax.random.PRNGKey(1), C))
    feat = rng.standard_normal((B, N, C)).astype(np.float32)
    mask = (np.arange(N)[None] < np.array([12, 7, 5, 9])[:, None]
            ).astype(np.float32)
    probe = rng.standard_normal((B, sizes[1], C)).astype(np.float32)
    key = jax.random.PRNGKey(7) if noisy else None
    noise = None
    if noisy:   # merge_to_global splits its key once, one half per stage
        k0, k1 = jax.random.split(key)
        noise = (T(jax.random.uniform(k0, (B, N), jnp.float32)),
                 T(jax.random.uniform(k1, (B, sizes[0]), jnp.float32)))

    def jax_out(f):
        return jctm.merge_to_global(p, f, jnp.asarray(mask), sizes, k, heads,
                                    key)

    want = np.asarray(jax_out(jnp.asarray(feat)))
    gwant = np.asarray(jax.grad(lambda f: jnp.sum(jax_out(f) * probe))(
        jnp.asarray(feat)))
    ft = T(feat).requires_grad_(True)
    got = tctm.merge_to_global(*load_merge_stack(p, C, heads), ft, T(mask),
                               sizes, k, noise)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5,
                               rtol=1e-5)
    (got * T(probe)).sum().backward()
    np.testing.assert_allclose(ft.grad.numpy(), gwant, atol=1e-5, rtol=1e-4)
