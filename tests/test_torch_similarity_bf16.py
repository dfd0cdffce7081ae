"""sim_dtype="bfloat16" in the similarity family (ops/similarity.py,
ops/similarity_blocked.py) against the JAX package's Pallas kernels in
interpret mode with compute_dtype="bfloat16", on the CPU.

The function is exact: products of the features rounded to bf16 (to
nearest even), summed in fp32; the backward is taken with respect to the
fp32 features, each routed coefficient rounded to bf16 before it
multiplies its partner row (the short kernels round the two directions
apart, the blocked one a logit's fp32 sum of both).  Covered: K2's
function (S), K4 on both axes (the bank centralities) and K6's (the
long-token S), forward and both feature gradients, with masked tails and
duplicated tokens so that ties occur.  Tolerances: forward atol 1e-6,
gradients rtol 1e-5 / atol 1e-6 (JAX's bf16 S lies 2.6e-8 from float64 of
its rounded operands, so the two differ only in fp32 summation order).
The feature rows are integers whose squares sum to 2048², so that both
packages' L2 normalisations are exact and the rounding to bf16 sees the
same fp32 values in both.  Also: bf16 and float32 differ (> 1e-5
somewhere), so a silently ignored setting fails.

Inputs come from a numpy seed and go to both frameworks as numpy arrays.
The CUDA kernels are held to these plain forms in test_torch_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neighborretr_tpu.ops.pallas_similarity import (
    pallas_interaction_mean, pallas_interaction_similarity)
from neighborretr_tpu.ops.pallas_similarity_blocked import \
    pallas_interaction_similarity_blocked
from neighborretr_tpu_torch.ops import similarity as S
from neighborretr_tpu_torch.ops import similarity_blocked as SB

D = 64
NORM2 = 2048 ** 2
FWD_ATOL = 1e-6
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
# (A, B, T, V): the short kernels' shapes (V <= 16), ragged; the blocked
# kernel's (T·V >= 2048), ragged
SHORT = [(6, 10, 24, 12), (5, 9, 13, 7)]
LONG = [(4, 6, 64, 48), (3, 5, 40, 64)]


def exact_rows(rng, n: int) -> np.ndarray:
    """n integer rows of D entries whose squares sum to 2048² exactly, as
    fp32: every partial sum of squares is an integer below 2^24, the norm
    is 2048, and x / 2048 is exact."""
    rows = []
    while len(rows) < n:
        x = rng.integers(-300, 301, size=D - 2)
        r = NORM2 - int((x * x).sum())
        if r < 0:
            continue
        a = np.arange(int(np.sqrt(r)) + 1)
        b = np.rint(np.sqrt(r - a * a)).astype(np.int64)
        hit = np.flatnonzero(a * a + b * b == r)
        if hit.size:
            row = np.concatenate([x, [a[hit[0]], b[hit[0]]]])
            rows.append(rng.permutation(row * rng.choice([-1, 1], D)))
    return np.asarray(rows, np.float32)


def inputs(seed: int, A: int, B: int, T: int, V: int):
    """(t_feat, v_feat, t_mask, v_mask, t_weight, v_weight) as numpy:
    ragged masks (at least one live token), duplicated live tokens in
    every caption and video, masked softmax weights."""
    rng = np.random.default_rng(seed)
    tf = exact_rows(rng, A * T).reshape(A, T, D)
    vf = exact_rows(rng, B * V).reshape(B, V, D)
    tm = (np.arange(T)[None] < rng.integers(2, T + 1, A)[:, None])
    vm = (np.arange(V)[None] < rng.integers(2, V + 1, B)[:, None])
    tf[:, 1] = tf[:, 0]
    vf[:, 1] = vf[:, 0]

    def weights(mask):
        logit = rng.normal(size=mask.shape).astype(np.float32)
        w = np.where(mask, np.exp(logit), 0.0)
        return (w / w.sum(-1, keepdims=True)).astype(np.float32)

    return (tf, vf, tm.astype(np.float32), vm.astype(np.float32),
            weights(tm), weights(vm))


def jax_fwd_grads(fn, args, probe):
    """fn(*args) and the gradients of sum(fn · probe) in the features."""
    a = [jnp.asarray(x) for x in args]

    def f(tf, vf):
        return jnp.sum(fn(tf, vf, *a[2:]) * probe)

    out = np.asarray(fn(*a))
    gt, gv = jax.grad(f, argnums=(0, 1))(a[0], a[1])
    return out, np.asarray(gt), np.asarray(gv)


def port_fwd_grads(fn, args, probe):
    tf, vf, *rest = [torch.as_tensor(x) for x in args]
    tf.requires_grad_(True)
    vf.requires_grad_(True)
    out = fn(tf, vf, *rest)
    (out * torch.as_tensor(np.asarray(probe))).sum().backward()
    return out.detach().numpy(), tf.grad.numpy(), vf.grad.numpy()


def held(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=FWD_ATOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, **GRAD_TOL)


def probe_for(shape, seed=11):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_exact_rows_normalise_exactly():
    x = torch.as_tensor(exact_rows(np.random.default_rng(0), 32))
    n = torch.linalg.vector_norm(x, dim=-1)
    assert torch.equal(n, torch.full_like(n, 2048.0))
    assert not torch.equal(S.round_bf16(x / 2048), x / 2048)


@pytest.mark.parametrize("A,B,T,V", SHORT)
def test_similarity_bf16_matches_pallas(A, B, T, V):
    """K2's function: S and both feature gradients."""
    args = inputs(1, A, B, T, V)
    probe = probe_for((A, B))
    want = jax_fwd_grads(lambda *a: pallas_interaction_similarity(
        *a, interpret=True, compute_dtype="bfloat16"), args, probe)
    got = port_fwd_grads(lambda *a: S.fused_interaction_similarity(
        *a, sim_dtype="bfloat16"), args, probe)
    held(got, want)
    f32 = port_fwd_grads(S.fused_interaction_similarity, args, probe)
    assert np.abs(f32[0] - got[0]).max() > 1e-5


@pytest.mark.parametrize("axis", [1, 0])
@pytest.mark.parametrize("A,B,T,V", SHORT)
def test_mean_bf16_matches_pallas(A, B, T, V, axis):
    """K4 on either axis (the bank centralities) and its gradients."""
    args = inputs(2, A, B, T, V)
    probe = probe_for((A if axis == 1 else B,))
    want = jax_fwd_grads(lambda *a: pallas_interaction_mean(
        *a, axis=axis, interpret=True, compute_dtype="bfloat16"), args,
        probe)
    got = port_fwd_grads(lambda *a: S.fused_interaction_mean(
        *a, axis=axis, sim_dtype="bfloat16"), args, probe)
    held(got, want)
    f32 = port_fwd_grads(lambda *a: S.fused_interaction_mean(
        *a, axis=axis), args, probe)
    assert np.abs(f32[0] - got[0]).max() > 1e-5


@pytest.mark.parametrize("A,B,T,V", LONG)
def test_blocked_bf16_matches_pallas(A, B, T, V):
    """K6's function at the long-token shapes, and its gradients (a
    logit routed both ways rounds its two coefficients' sum)."""
    args = inputs(3, A, B, T, V)
    probe = probe_for((A, B))
    want = jax_fwd_grads(lambda *a: pallas_interaction_similarity_blocked(
        *a, interpret=True, compute_dtype="bfloat16"), args, probe)
    got = port_fwd_grads(lambda *a: SB.fused_interaction_similarity_blocked(
        *a, sim_dtype="bfloat16"), args, probe)
    held(got, want)
    f32 = port_fwd_grads(SB.fused_interaction_similarity_blocked, args,
                         probe)
    assert np.abs(f32[0] - got[0]).max() > 1e-5


@pytest.mark.parametrize("rounding", ["each", "sum"])
def test_rounded_coefficients_differ_from_unrounded(rounding):
    """The routed backward's rounding modes move the gradients, and "sum"
    differs from "each" exactly where a logit is routed both ways."""
    args = inputs(4, 4, 5, 16, 8)
    tn, vn, tw, vw = S._prepare(*[torch.as_tensor(a) for a in args], False)
    tn, vn = S.operands(tn, vn, "bfloat16", False)
    _, res = S.similarity_routing_plain(tn, vn, tw, vw)
    g = torch.as_tensor(probe_for((4, 5)))
    plain = S.similarity_bwd_routed_plain(tn, vn, tw, vw, g, *res)
    got = S.similarity_bwd_routed_plain(tn, vn, tw, vw, g, *res,
                                        rounding=rounding)
    assert (got[0] - plain[0]).abs().max() > 0
    assert torch.equal(got[2], plain[2]) and torch.equal(got[3], plain[3])
    if rounding == "sum":
        each = S.similarity_bwd_routed_plain(tn, vn, tw, vw, g, *res,
                                             rounding="each")
        assert not torch.equal(got[0], each[0])


def test_bf16_nograd_equals_grad_forward_and_checks_dtype():
    args = [torch.as_tensor(a) for a in inputs(5, 3, 4, 10, 6)]
    with torch.no_grad():
        a = S.fused_interaction_similarity(*args, sim_dtype="bfloat16")
        b = S.fused_interaction_mean(*args, axis=0, sim_dtype="bfloat16")
    args[0].requires_grad_(True)
    assert torch.equal(a, S.fused_interaction_similarity(
        *args, sim_dtype="bfloat16").detach())
    assert torch.equal(b, S.fused_interaction_mean(
        *args, axis=0, sim_dtype="bfloat16").detach())
    with pytest.raises(ValueError, match="sim_dtype"):
        S.fused_interaction_similarity(*args, sim_dtype="float16")
