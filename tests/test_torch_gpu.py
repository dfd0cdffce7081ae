"""The port's CUDA kernels against their plain versions, on a card.

Every test here is marked `gpu` and skips without a CUDA device (the
kernels have no CPU mode).  This file imports no JAX, so it also runs where
JAX is not installed; the repository's conftest.py imports JAX, hence:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import contextlib
import dataclasses as dc
import os

import numpy as np
import pytest
import torch

from neighborretr_tpu_torch.ops import attention as A
from neighborretr_tpu_torch.ops import block_attention as BA
from neighborretr_tpu_torch.ops import similarity as S
from neighborretr_tpu_torch.ops import similarity_blocked as SB

pytestmark = pytest.mark.gpu

# kernel vs plain: K1 returns bf16 (two bf16 rounding steps); K2 is fp32
K1_TOL = dict(atol=2 ** -6, rtol=2 ** -6)
K2_TOL = dict(atol=2e-5, rtol=1e-4)
# K3's fp32 sums over all rows (weight and bias gradients): bf16 operands
# that flip by one ulp where differently ordered fp32 sums straddle a
# rounding boundary move single terms by 2^-8 of their size, so the bound
# is relative to the tensor's largest entry, not elementwise
K3_SUM_TOL = 2 ** -7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def sim_inputs(seed, A, B, T, V, D, device):
    rng = np.random.default_rng(seed)
    tm = (rng.uniform(size=(A, T)) > 0.25).astype(np.float32)
    vm = (rng.uniform(size=(B, V)) > 0.25).astype(np.float32)
    tm[:, 0] = 1
    vm[:, 0] = 1
    arrays = (rng.normal(size=(A, T, D)), rng.normal(size=(B, V, D)), tm, vm,
              rng.dirichlet(np.ones(T), size=A), rng.dirichlet(np.ones(V),
                                                               size=B))
    return [torch.as_tensor(np.asarray(a, np.float32), device=device)
            for a in arrays]


@pytest.mark.parametrize("A,B,T,V,D", [(5, 37, 7, 3, 64),
                                       (64, 1000, 24, 12, 512),
                                       (3, 129, 64, 16, 128)])
def test_similarity_kernel_matches_plain(cuda, A, B, T, V, D):
    args = sim_inputs(A + B, A, B, T, V, D, cuda)
    before = S.fused_interaction_similarity.launches
    got = S.fused_interaction_similarity(*args)
    torch.cuda.synchronize()
    assert S.fused_interaction_similarity.launches == before + 1
    torch.testing.assert_close(got, S.interaction_similarity(*args), **K2_TOL)


SIM_SHAPES = [(5, 37, 7, 3, 64), (64, 200, 24, 12, 512), (200, 64, 24, 12, 512),
              (3, 129, 64, 16, 128)]


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("A,B,T,V,D", SIM_SHAPES)
def test_mean_kernel_matches_plain(cuda, A, B, T, V, D, axis):
    args = sim_inputs(A + B, A, B, T, V, D, cuda)
    before = S.fused_interaction_mean.launches
    got = S.fused_interaction_mean(*args, axis=axis)
    torch.cuda.synchronize()
    assert S.fused_interaction_mean.launches == before + 1
    assert got.shape == ((A,) if axis == 1 else (B,))
    torch.testing.assert_close(got, S.interaction_mean(*args, axis=axis),
                               **K2_TOL)
    assert torch.equal(got, S.fused_interaction_mean(*args, axis=axis))


# the 3xTF32 tile kernel's edges: A off its query groups (1, 7, 9, 130), B
# off its 16-video tiles, T past a 64-row m-tile (25) and at its limits (1,
# 64), V at 1, 3, 12, 13, 16 (padded to 4, 4, 12, 16, 16), D = 32, 96, 512
EDGE_SHAPES = [(1, 17, 24, 12, 512), (7, 33, 7, 3, 96), (9, 15, 25, 13, 32),
               (130, 37, 1, 1, 96), (1, 5, 64, 16, 32), (9, 1000, 64, 12, 96),
               (130, 3, 24, 16, 512), (7, 100, 25, 1, 512),
               (2, 41, 64, 3, 32), (3, 18, 13, 13, 96)]


@pytest.mark.parametrize("form", ["similarity", "mean0", "mean1"])
@pytest.mark.parametrize("A,B,T,V,D", EDGE_SHAPES)
def test_similarity_kernel_tile_edges(cuda, A, B, T, V, D, form):
    args = sim_inputs(A * T + B * V, A, B, T, V, D, cuda)
    if form == "similarity":
        got = S.fused_interaction_similarity(*args)
        want = S.interaction_similarity(*args)
    else:
        axis = int(form[-1])
        got = S.fused_interaction_mean(*args, axis=axis)
        want = S.interaction_mean(*args, axis=axis)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **K2_TOL)


@pytest.mark.parametrize("Q", [1, 8, 64])
def test_similarity_kernel_at_serving_sizes(cuda, Q):
    """Q queries against a corpus of 10,000 videos, as a request sees it."""
    args = sim_inputs(Q, Q, 10_000, 24, 12, 512, cuda)
    got = S.fused_interaction_similarity(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, S.interaction_similarity(*args), **K2_TOL)


@pytest.mark.parametrize("form", ["similarity", "mean0", "mean1"])
def test_similarity_kernels_give_the_same_bits_twice(cuda, form):
    """No float atomics: two launches give the same output and residuals
    (the index rows' padding bytes past T and V are never written)."""
    T, V = 24, 12
    tn, vn, tw, vw = S._prepare(*sim_inputs(5, 70, 300, T, V, 512, cuda),
                                True)

    def run():
        if form == "similarity":
            return S._similarity_fwd(tn, vn, tw, vw, save=True)
        return S._mean_fwd(tn, vn, tw, vw, int(form[-1]), save=True)

    (out, res), (again, res2) = run(), run()
    assert torch.equal(out, again)
    for a, b, n in zip(res, res2, (T, T, V, V)):
        assert torch.equal(a[..., :n], b[..., :n])


def test_similarity_kernel_is_the_tf32x3_emulation(cuda):
    """The card's S and maxima against the CPU's written-out 3xTF32
    arithmetic (`similarity_tf32x3`): the two differ only in the order of
    their fp32 sums, an order of magnitude inside K2_TOL."""
    tn, vn, tw, vw = S._prepare(*sim_inputs(9, 9, 40, 24, 12, 512, cuda), True)
    out, (m1, _, m2, _) = S._similarity_fwd(tn, vn, tw, vw, save=True)
    torch.cuda.synchronize()
    want, (w1, _, w2, _) = S.similarity_tf32x3(tn.cpu(), vn.cpu(), tw.cpu(),
                                               vw.cpu())
    tight = dict(atol=2e-6, rtol=1e-5)
    torch.testing.assert_close(out.cpu(), want, **tight)
    torch.testing.assert_close(m1.cpu(), w1, **tight)
    torch.testing.assert_close(m2.cpu(), w2, **tight)


# sim_dtype="bfloat16": the kernels (bf16 wgmma, bf16 gathers) against
# their plain bf16 versions on the same inputs; the two take the same
# rounded operands and exact products, and differ only in the order of
# their fp32 sums
BF16_TOL = dict(atol=1e-6, rtol=1e-5)
BF16_SHAPES = [("short", 5, 37, 7, 3, 64), ("short", 64, 200, 24, 12, 512),
               ("short", 9, 15, 25, 13, 32), ("short", 3, 129, 64, 16, 128),
               ("long", 7, 9, 64, 64, 64), ("long", 5, 7, 33, 17, 48),
               ("long", 16, 40, 64, 48, 512)]


def bf16_inputs(kind, A, B, T, V, D, cuda):
    """sim_inputs with a duplicated live video token (ties among live
    logits) → the wrapper's arguments."""
    args = sim_inputs(A * T + B * V, A, B, T, V, D, cuda)
    if V > 1:
        args[1][:, V - 1] = args[1][:, 0]
        args[3][:, V - 1] = args[3][:, 0]
    return args


@pytest.mark.parametrize("form", ["similarity", "mean0", "mean1"])
@pytest.mark.parametrize("kind,A,B,T,V,D", BF16_SHAPES)
def test_bf16_forward_kernels_match_plain(cuda, kind, A, B, T, V, D, form):
    """K2, K4 (both axes) and K6 in bf16, no grad: launched (their bf16
    counts move), within BF16_TOL of the plain bf16 forms, and away from
    the float32 kernels' results (the setting is not ignored)."""
    if kind == "long" and form != "similarity":
        pytest.skip("the long shapes have no mean kernel")
    args = bf16_inputs(kind, A, B, T, V, D, cuda)
    if kind == "long":
        fn, wrapper = SB.fused_interaction_similarity_blocked, \
            SB.fused_interaction_similarity_blocked
    elif form == "similarity":
        fn = wrapper = S.fused_interaction_similarity
    else:
        wrapper = S.fused_interaction_mean

        def fn(*a, **kw):
            return S.fused_interaction_mean(*a, axis=int(form[-1]), **kw)
    before = wrapper.launches_bf16
    got = fn(*args, sim_dtype="bfloat16")
    torch.cuda.synchronize()
    assert wrapper.launches_bf16 == before + 1
    want = fn(*args, kernels=False, sim_dtype="bfloat16")
    torch.testing.assert_close(got, want, **BF16_TOL)
    # bf16 moves S by ~1e-4; a mean over the bank by ~1e-5
    assert (got - fn(*args)).abs().max() > 1e-6


@pytest.mark.parametrize("form", ["similarity", "mean0", "mean1"])
@pytest.mark.parametrize("kind,A,B,T,V,D", BF16_SHAPES)
def test_bf16_backward_kernels_match_plain_on_the_kernels_routing(
        cuda, kind, A, B, T, V, D, form):
    """K5 / K7 in bf16 from the bf16 forward's saved routing, both sides
    and each alone, against the plain routed backward fed that routing
    (the coefficients rounded each apart for K5, a logit's fp32 sum for
    K7); two runs give the same bits."""
    if kind == "long" and form != "similarity":
        pytest.skip("the long shapes have no mean kernel")
    args = bf16_inputs(kind, A, B, T, V, D, cuda)
    tn, vn, tw, vw = S._prepare(*args, False)
    tb, vb = S.operands(tn, vn, "bfloat16", True)
    if kind == "long":
        _, res = SB._blocked_fwd(tb, vb, tw, vw, save=True)
        bwd, rounding = SB.fused_blocked_similarity_bwd, "sum"
    elif form == "similarity":
        _, res = S._similarity_fwd(tb, vb, tw, vw, save=True)
        bwd, rounding = S.fused_similarity_bwd, "each"
    else:
        _, res = S._mean_fwd(tb, vb, tw, vw, int(form[-1]), save=True)
        bwd, rounding = S.fused_similarity_bwd, "each"
    g = torch.as_tensor(np.random.default_rng(3).standard_normal((A, B)),
                        dtype=torch.float32, device=cuda)
    before = bwd.launches_bf16
    got = bwd(tb, vb, tw, vw, g, *res)
    again = bwd(tb, vb, tw, vw, g, *res)
    t_only = bwd(tb, vb, tw, vw, g, *res, need_v=False)
    torch.cuda.synchronize()
    assert bwd.launches_bf16 == before + 3
    want = S.similarity_bwd_routed_plain(tb.float(), vb.float(), tw, vw, g,
                                         *res, rounding=rounding)
    for x, y, z in zip(got, want, again):
        assert x.dtype == torch.float32
        torch.testing.assert_close(x, y, **BF16_TOL)
        assert torch.equal(x, z)
    assert torch.equal(t_only[0], got[0]) and t_only[1] is None


def test_bf16_blocked_routing_is_float64s_first_argmax(cuda):
    """K6 in bf16 re-picks its near-ties in float64 of the rounded
    operands: its saved indices are the first argmax of those logits."""
    args = bf16_inputs("long", 6, 11, 64, 64, 128, cuda)
    tn, vn, tw, vw = S._prepare(*args, False)
    tb, vb = S.operands(tn, vn, "bfloat16", True)
    _, (m1, i1, m2, i2) = SB._blocked_fwd(tb, vb, tw, vw, save=True)
    _, (w1, j1, w2, j2) = SB.similarity_blocked_routing_plain(
        tb.double(), vb.double(), tw.double(), vw.double())
    assert torch.equal(i1[..., :64], j1) and torch.equal(i2[..., :64], j2)
    torch.testing.assert_close(m1.double(), w1, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("A,B,T,V,D", SIM_SHAPES)
def test_similarity_backward_kernel_matches_plain(cuda, A, B, T, V, D):
    """Masked tokens make whole rows of logits tie at 0; duplicated video
    tokens make ties among live logits too.  The backward routes by the
    forward kernel's residuals."""
    tf, vf, tm, vm, tw, vw = sim_inputs(A * B, A, B, T, V, D, cuda)
    vf[:, V - 1] = vf[:, 0]
    vm[:, V - 1] = vm[:, 0]
    tn, vn, tw, vw = S._prepare(tf, vf, tm, vm, tw, vw, True)
    g = torch.as_tensor(np.random.default_rng(7).standard_normal((A, B)),
                        dtype=torch.float32, device=cuda)
    _, res = S._similarity_fwd(tn, vn, tw, vw, save=True)
    before = S.fused_similarity_bwd.launches
    got = S.fused_similarity_bwd(tn, vn, tw, vw, g, *res)
    torch.cuda.synchronize()
    assert S.fused_similarity_bwd.launches == before + 1
    want = S.similarity_bwd_plain(tn, vn, tw, vw, g)
    for name, a, b in zip(("dtn", "dvn", "dtw", "dvw"), got, want):
        torch.testing.assert_close(a, b, atol=2e-5 * max(A, B) ** 0.5,
                                   rtol=1e-4, msg=lambda m: f"{name}: {m}")
    again = S.fused_similarity_bwd(tn, vn, tw, vw, g, *res)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# how close the plain version's logits of two candidates may lie where the
# kernel's routing picks the other one: at D = 512 the kernel's maxima lie
# within 9e-8 of float64 and cuBLAS's fp32 ones within 2.7e-7
# (tools/similarity_probe.py's accuracy report on an H100)
ROUTING_NEAR = 1e-6


@pytest.mark.parametrize("A,B,T,V,D", SIM_SHAPES)
def test_saved_routing_is_the_plain_one_off_near_ties(cuda, A, B, T, V, D):
    """Real-valued logits with the backward test's ties (masked tokens,
    duplicated video tokens): the saved maxima are the plain ones within
    K2_TOL, and each saved index is the plain first argmax unless the
    plain logits of the two candidates differ, by at most ROUTING_NEAR (at
    an exact tie the first index wins)."""
    tf, vf, tm, vm, tw, vw = sim_inputs(A * B, A, B, T, V, D, cuda)
    vf[:, V - 1] = vf[:, 0]
    vm[:, V - 1] = vm[:, 0]
    tn, vn, tw, vw = S._prepare(tf, vf, tm, vm, tw, vw, True)
    _, (m1, i1, m2, i2) = S._similarity_fwd(tn, vn, tw, vw, save=True)
    _, (p1, j1, p2, j2) = S.similarity_routing_plain(tn, vn, tw, vw)
    torch.testing.assert_close(m1, p1, **K2_TOL)
    torch.testing.assert_close(m2, p2, **K2_TOL)
    logits = (tn.reshape(A * T, D) @ vn.reshape(B * V, D).T).reshape(A, T, B,
                                                                      V)
    for lg, mine, plain in ((logits.permute(0, 2, 1, 3), i1[..., :T], j1),
                            (logits.permute(0, 2, 3, 1), i2[..., :V], j2)):
        gap = (lg.gather(3, plain.long()[..., None])
               - lg.gather(3, mine.long()[..., None]))[..., 0]
        near = (gap > 0) & (gap <= ROUTING_NEAR)
        assert bool(((mine == plain) | near).all())


def test_similarity_kernel_is_as_close_to_float64_as_fp32(cuda):
    """The 3xTF32 logits' accuracy: both maxima no further from their
    float64 values than the fp32 plain version's (cuBLAS) are, and S no
    further than 1.5x its distance (S's two weighted sums are the same fp32
    chains in both, and they dominate its error), on the backward test's
    kind of inputs at D = 512."""
    A, B, T, V, D = 64, 200, 24, 12, 512
    tn, vn, tw, vw = S._prepare(*sim_inputs(A * B, A, B, T, V, D, cuda), True)
    out, (m1, _, m2, _) = S._similarity_fwd(tn, vn, tw, vw, save=True)
    plain, (p1, _, p2, _) = S.similarity_routing_plain(tn, vn, tw, vw)
    logits = tn.reshape(A * T, D).double() @ vn.reshape(B * V, D).double().T
    exact, (e1, _, e2, _) = S._routing(logits.reshape(A, T, B, V),
                                       tw.double(), vw.double())
    for got, fp32, want, slack in ((out, plain, exact, 1.5), (m1, p1, e1, 1),
                                   (m2, p2, e2, 1)):
        err = (got.double() - want).abs().max().item()
        assert err <= slack * (fp32.double() - want).abs().max().item()


@pytest.mark.parametrize("axis", [None, 0, 1])
def test_similarity_autograd_kernels_match_plain(cuda, axis):
    args = sim_inputs(3, 9, 40, 7, 3, 64, cuda)

    def grads(kernels):
        leaves = [a.clone().requires_grad_(i in (0, 1, 4, 5))
                  for i, a in enumerate(args)]
        if axis is None:
            out = S.fused_interaction_similarity(*leaves, kernels=kernels)
        else:
            out = S.fused_interaction_mean(*leaves, axis=axis,
                                           kernels=kernels)
        out.square().sum().backward()
        return [leaves[i].grad for i in (0, 1, 4, 5)]

    for a, b in zip(grads(True), grads(False)):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=1e-4)


# the blocked kernels at small shapes (odd token counts, tiles with several
# captions and videos, ragged edges) and at the long-token train step's
# three: in-batch, text x bank videos, bank texts x videos
BLOCKED_SHAPES = [(5, 37, 7, 3, 64), (3, 9, 64, 64, 32), (9, 5, 33, 17, 48),
                  (130, 70, 64, 16, 128), (128, 128, 64, 64, 512),
                  (128, 1920, 64, 64, 512), (1920, 128, 64, 64, 512)]


def exact_inputs(seed, A, B, T, V, D, device):
    """Prepared inputs whose logits are exact in fp32 in any summation
    order (entries are multiples of 1/8 up to 1/2, D <= 512), so the kernel
    and the plain version see the same maxima and the same ties, of which
    there are many; masked tokens are zero rows."""
    rng = np.random.default_rng(seed)
    tm = np.arange(T)[None] < rng.integers(1, T + 1, A)[:, None]
    vm = np.arange(V)[None] < rng.integers(1, V + 1, B)[:, None]
    tn = rng.integers(-4, 5, (A, T, D)) / 8.0 * tm[..., None]
    vn = rng.integers(-4, 5, (B, V, D)) / 8.0 * vm[..., None]
    vn[:, V - 1] = vn[:, 0]                     # duplicated video tokens
    arrays = (tn, vn, rng.dirichlet(np.ones(T), size=A),
              rng.dirichlet(np.ones(V), size=B), rng.standard_normal((A, B)))
    return [torch.as_tensor(np.asarray(a, np.float32), device=device)
            for a in arrays]


@pytest.mark.parametrize("A,B,T,V,D", BLOCKED_SHAPES)
def test_blocked_similarity_kernel_matches_plain(cuda, A, B, T, V, D):
    args = sim_inputs(A + B, A, B, T, V, D, cuda)
    before = SB.fused_interaction_similarity_blocked.launches
    got = SB.fused_interaction_similarity_blocked(*args)
    torch.cuda.synchronize()
    assert SB.fused_interaction_similarity_blocked.launches == before + 1
    want = SB.fused_interaction_similarity_blocked(*args, kernels=False)
    torch.testing.assert_close(got, want, **K2_TOL)


@pytest.mark.parametrize("A,B,T,V,D", BLOCKED_SHAPES)
def test_blocked_backward_kernel_matches_plain(cuda, A, B, T, V, D):
    """On inputs with exact logits every gradient agrees elementwise, ties
    included, and two runs give the same bits."""
    tn, vn, tw, vw, g = exact_inputs(A * B, A, B, T, V, D, cuda)
    out, res = SB._blocked_fwd(tn, vn, tw, vw, save=True)
    torch.testing.assert_close(out, SB.similarity_blocked_plain(tn, vn, tw, vw),
                               **K2_TOL)
    before = SB.fused_blocked_similarity_bwd.launches
    got = SB.fused_blocked_similarity_bwd(tn, vn, tw, vw, g, *res)
    torch.cuda.synchronize()
    assert SB.fused_blocked_similarity_bwd.launches == before + 1
    want = SB.similarity_blocked_bwd_plain(tn, vn, tw, vw, g)
    for name, a, b in zip(("dtn", "dvn", "dtw", "dvw"), got, want):
        torch.testing.assert_close(a, b, atol=2e-5 * max(A, B) ** 0.5,
                                   rtol=1e-4, msg=lambda m: f"{name}: {m}")
    again = SB.fused_blocked_similarity_bwd(tn, vn, tw, vw, g, *res)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# K6's tile edges (csrc/interaction_similarity_blocked.cu): A = 1 and B
# under one block's videos, T = 1, 8 and 17 (1, 8 and 4 captions a block,
# one or two m-tiles), V = 5, 32, 33 and 48 (padded to 16, 32, 64, 64
# token slots: 8, 4, 2, 2 videos a warpgroup), D = 16 and 80 (a last
# k-chunk of 16 columns)
BLOCKED_EDGE_SHAPES = [(1, 3, 64, 64, 16), (2, 33, 1, 33, 32),
                       (9, 17, 17, 32, 80), (17, 9, 8, 5, 64),
                       (5, 6, 24, 48, 48)]


@pytest.mark.parametrize("A,B,T,V,D", BLOCKED_EDGE_SHAPES)
def test_blocked_similarity_kernel_tile_edges(cuda, A, B, T, V, D):
    """Exact logits: S the plain S, the residuals the plain routing, ties
    included; real-valued inputs: S the plain S."""
    tn, vn, tw, vw, _ = exact_inputs(A + B + T + V, A, B, T, V, D, cuda)
    out, (m1, i1, m2, i2) = SB._blocked_fwd(tn, vn, tw, vw, save=True)
    torch.cuda.synchronize()
    want_s, want = SB.similarity_blocked_routing_plain(tn, vn, tw, vw)
    torch.testing.assert_close(out, want_s, **K2_TOL)
    assert torch.equal(m1, want[0]) and torch.equal(m2, want[2])
    assert torch.equal(i1[..., :T], want[1])
    assert torch.equal(i2[..., :V], want[3])
    args = sim_inputs(A * B + D, A, B, T, V, D, cuda)
    torch.testing.assert_close(
        SB.fused_interaction_similarity_blocked(*args),
        SB.fused_interaction_similarity_blocked(*args, kernels=False),
        **K2_TOL)


@pytest.mark.parametrize("A,B,T,V,D", [(9, 40, 64, 64, 512),
                                       (5, 7, 33, 17, 48)])
def test_blocked_similarity_kernel_is_the_tf32x3_emulation(cuda, A, B, T, V,
                                                           D):
    """K6's S and maxima against the CPU's written-out 3xTF32 arithmetic:
    the two differ only in the order of their fp32 sums."""
    tn, vn, tw, vw = S._prepare(*sim_inputs(A + T, A, B, T, V, D, cuda),
                                False)
    out, (m1, _, m2, _) = SB._blocked_fwd(tn, vn, tw, vw, save=True)
    torch.cuda.synchronize()
    want, (w1, _, w2, _) = S.similarity_tf32x3(tn.cpu(), vn.cpu(), tw.cpu(),
                                               vw.cpu())
    tight = dict(atol=2e-6, rtol=1e-5)
    torch.testing.assert_close(out.cpu(), want, **tight)
    torch.testing.assert_close(m1.cpu(), w1, **tight)
    torch.testing.assert_close(m2.cpu(), w2, **tight)


def test_blocked_similarity_kernel_is_as_close_to_float64_as_fp32(cuda):
    """K6's 3xTF32 logits, as K2's: both maxima no further from their
    float64 values than the fp32 plain version's (cuBLAS) are, and S no
    further than 1.5x its distance (S's two weighted sums are fp32 chains
    in both, and they dominate its error), at T = V = 64, D = 512."""
    A, B, T, V, D = 48, 120, 64, 64, 512
    tn, vn, tw, vw = S._prepare(*sim_inputs(A * B, A, B, T, V, D, cuda),
                                False)
    out, (m1, _, m2, _) = SB._blocked_fwd(tn, vn, tw, vw, save=True)
    plain, (p1, _, p2, _) = SB.similarity_blocked_routing_plain(tn, vn, tw,
                                                                vw)
    logits = tn.reshape(A * T, D).double() @ vn.reshape(B * V, D).double().T
    exact, (e1, _, e2, _) = S._routing(logits.reshape(A, T, B, V),
                                       tw.double(), vw.double())
    for got, fp32, want, slack in ((out, plain, exact, 1.5), (m1, p1, e1, 1),
                                   (m2, p2, e2, 1)):
        err = (got.double() - want).abs().max().item()
        assert err <= slack * (fp32.double() - want).abs().max().item()


@pytest.mark.parametrize("T,V,D", [(64, 64, 512), (33, 17, 48)])
def test_blocked_similarity_kernel_gives_the_same_bits_twice(cuda, T, V, D):
    """No float atomics: two K6 forwards give the same S and residuals with
    the residual stores, the same S without them, and S the same bits
    either way."""
    tn, vn, tw, vw = S._prepare(*sim_inputs(T + V, 70, 130, T, V, D, cuda),
                                False)
    (out, res), (again, res2) = (SB._blocked_fwd(tn, vn, tw, vw, save=True)
                                 for _ in range(2))
    bare, bare2 = (SB._blocked_fwd(tn, vn, tw, vw, save=False)[0]
                   for _ in range(2))
    assert torch.equal(out, again) and torch.equal(bare, bare2)
    assert torch.equal(out, bare)
    for a, b, n in zip(res, res2, (T, T, V, V)):
        assert torch.equal(a[..., :n], b[..., :n])


# the routed backward (K5, K7) from the forward kernels' residuals, one side
# and both: T = 1, V = 1, the widest flat tokens (T = 64, V = 16) and
# blocked ones (64 x 64), A or B under 32, walks split into ranges (a short
# owner side against a long partner side), D off the 128-column slab
ROUTED_SHAPES = [("flat", 5, 37, 1, 3, 64), ("flat", 9, 40, 7, 1, 64),
                 ("flat", 3, 300, 64, 16, 128), ("flat", 200, 24, 24, 12, 96),
                 ("flat", 128, 1920, 24, 12, 512),
                 ("flat", 1920, 128, 24, 12, 512),
                 ("blocked", 3, 9, 64, 64, 32), ("blocked", 9, 5, 33, 17, 48),
                 ("blocked", 20, 600, 64, 64, 160),
                 ("blocked", 128, 1920, 64, 64, 512),
                 ("blocked", 1920, 128, 64, 64, 512)]


def routed_forward(kind, tn, vn, tw, vw):
    if kind == "flat":
        return S._similarity_fwd(tn, vn, tw, vw, save=True)
    return SB._blocked_fwd(tn, vn, tw, vw, save=True)


@pytest.mark.parametrize("kind,A,B,T,V,D", ROUTED_SHAPES)
def test_saved_routing_is_the_plain_first_argmax(cuda, kind, A, B, T, V, D):
    """Exact logits: the residuals equal the plain routing, ties included,
    and S the plain S."""
    tn, vn, tw, vw, _ = exact_inputs(A + B, A, B, T, V, D, cuda)
    out, res = routed_forward(kind, tn, vn, tw, vw)
    torch.cuda.synchronize()
    if A * B * T * V <= 2 ** 27:
        want_s, want = S.similarity_routing_plain(tn, vn, tw, vw)
    else:
        want_s, want = SB.similarity_blocked_routing_plain(tn, vn, tw, vw)
    torch.testing.assert_close(out, want_s, **K2_TOL)
    m1, i1, m2, i2 = res
    assert torch.equal(m1, want[0]) and torch.equal(m2, want[2])
    assert torch.equal(i1[..., :T], want[1])
    assert torch.equal(i2[..., :V], want[3])


@pytest.mark.parametrize("kind,A,B,T,V,D", ROUTED_SHAPES)
def test_routed_backward_one_side_and_both(cuda, kind, A, B, T, V, D):
    """Exact logits: both sides against the plain routed backward; each side
    alone gives the both-side call's bits for it; two runs give the same
    bits."""
    tn, vn, tw, vw, g = exact_inputs(A * B + T, A, B, T, V, D, cuda)
    _, res = routed_forward(kind, tn, vn, tw, vw)
    bwd = (S.fused_similarity_bwd if kind == "flat"
           else SB.fused_blocked_similarity_bwd)
    both = bwd(tn, vn, tw, vw, g, *res)
    torch.cuda.synchronize()
    if A * B * T * V <= 2 ** 27:
        want = S.similarity_bwd_routed_plain(tn, vn, tw, vw, g, *res)
    else:
        want = SB.similarity_blocked_bwd_routed_plain(tn, vn, tw, vw, g, *res)
    for name, a, b in zip(("dtn", "dvn", "dtw", "dvw"), both, want):
        torch.testing.assert_close(a, b, atol=2e-5 * max(A, B) ** 0.5,
                                   rtol=1e-4, msg=lambda m: f"{name}: {m}")
    text = bwd(tn, vn, tw, vw, g, *res, need_v=False)
    video = bwd(tn, vn, tw, vw, g, *res, need_t=False)
    assert text[1] is None and video[0] is None
    assert torch.equal(text[0], both[0]) and torch.equal(video[1], both[1])
    for one in (text, video):
        assert torch.equal(one[2], both[2]) and torch.equal(one[3], both[3])
    again = bwd(tn, vn, tw, vw, g, *res)
    assert all(torch.equal(a, b) for a, b in zip(both, again))


@pytest.mark.parametrize("kind,A,B,T,V,D", [("flat", 40, 200, 24, 12, 128),
                                            ("flat", 128, 1920, 24, 12, 512),
                                            ("blocked", 40, 200, 64, 64, 128)])
def test_one_side_launches_one_gather(cuda, kind, A, B, T, V, D):
    """A backward asked for one feature side launches one gather kernel, a
    both-side backward two: counted by the library where it launches them
    (`similarity.gather_launches`; torch.profiler's kernel records were
    lost now and then, tools/profiler_probe.py)."""
    tn, vn, tw, vw, g = exact_inputs(A + T, A, B, T, V, D, cuda)
    _, res = routed_forward(kind, tn, vn, tw, vw)
    bwd = (S.fused_similarity_bwd if kind == "flat"
           else SB.fused_blocked_similarity_bwd)
    lib = "interaction_similarity" + ("" if kind == "flat" else "_blocked")

    def gathers(**side):
        before = S.gather_launches(lib)
        bwd(tn, vn, tw, vw, g, *res, **side)
        torch.cuda.synchronize()
        return S.gather_launches(lib) - before

    assert [gathers(need_v=False), gathers(need_t=False), gathers()] == \
        [1, 1, 2]


@pytest.mark.parametrize("A,B,T,V,D", [(40, 300, 64, 64, 128),
                                       (128, 1920, 64, 64, 512)])
def test_blocked_routing_is_float64_first_argmax(cuda, A, B, T, V, D):
    """Real-valued inputs with ragged masks and identical tokens: K6's saved
    routing (its near-ties re-picked in float64) is the first argmax of
    float64 logits everywhere, its maxima and S unchanged by the re-pick."""
    args = sim_inputs(A + B + 1, A, B, T, V, D, cuda)
    args[0][:, 3] = args[0][:, 2]
    args[1][:, 1] = args[1][:, 0]
    prep = S._prepare(*args, False)
    out, res = SB._blocked_fwd(*prep, save=True)
    bare, _ = SB._blocked_fwd(*prep, save=False)
    assert torch.equal(out, bare)
    _, want = SB.similarity_blocked_routing_plain(*(x.double() for x in prep))
    assert torch.equal(res[1][..., :T], want[1])
    assert torch.equal(res[3][..., :V], want[3])
    torch.testing.assert_close(res[0], want[0].float(), atol=2e-7, rtol=0)
    torch.testing.assert_close(res[2], want[2].float(), atol=2e-7, rtol=0)


@pytest.mark.parametrize("form", ["similarity", "mean0", "mean1", "blocked"])
def test_autograd_forward_keeps_the_no_grad_bits(cuda, form):
    """The forward kernels with their residual stores (under autograd) give
    the bits of the forward without them."""
    T, V = (64, 64) if form == "blocked" else (24, 12)
    args = sim_inputs(11, 70, 300, T, V, 128, cuda)

    def run(grad):
        leaves = [a.clone().requires_grad_(grad and i in (0, 4))
                  for i, a in enumerate(args)]
        if form == "similarity":
            return S.fused_interaction_similarity(*leaves)
        if form == "blocked":
            return SB.fused_interaction_similarity_blocked(*leaves)
        return S.fused_interaction_mean(*leaves, axis=int(form[-1]))

    assert torch.equal(run(True).detach(), run(False))


@pytest.mark.parametrize("blocked", [False, True])
def test_detached_partner_gets_no_gradient_on_the_card(cuda, blocked):
    """The bank's side is detached in the train step: its features get no
    gradient, in one backward call; the rest equals the both-side run's
    bits."""
    T, V = (64, 64) if blocked else (24, 12)
    args = sim_inputs(12, 40, 200, T, V, 128, cuda)
    fwd = (SB.fused_interaction_similarity_blocked if blocked
           else lambda *x: S.fused_interaction_mean(*x, axis=1))
    bwd = (SB.fused_blocked_similarity_bwd if blocked
           else S.fused_similarity_bwd)

    def grads(need_v):
        leaves = [a.clone().requires_grad_(i in (0, 4, 5) or
                                           (need_v and i == 1))
                  for i, a in enumerate(args)]
        fwd(*leaves).square().sum().backward()
        return [leaves[i].grad for i in (0, 1, 4, 5)]

    both = grads(True)
    before = bwd.launches
    one = grads(False)
    assert bwd.launches == before + 1
    assert one[1] is None and both[1] is not None
    for a, b in zip((one[0], one[2], one[3]), (both[0], both[2], both[3])):
        assert torch.equal(a, b)


def test_blocked_autograd_kernels_match_plain(cuda):
    """Through the wrapper (masks, normalisation, residuals) at a small
    long-token shape; real-valued logits, where a near-tie may route
    otherwise in the two versions, so the features' gradients are held as a
    whole."""
    args = sim_inputs(5, 6, 20, 64, 32, 64, cuda)

    def grads(kernels):
        leaves = [a.clone().requires_grad_(i in (0, 1, 4, 5))
                  for i, a in enumerate(args)]
        out = SB.fused_interaction_similarity_blocked(*leaves, kernels=kernels)
        out.square().sum().backward()
        return [leaves[i].grad for i in (0, 1, 4, 5)]

    k, p = grads(True), grads(False)
    for a, b in zip(k[2:], p[2:]):              # the weights' gradients
        torch.testing.assert_close(a, b, atol=2e-5, rtol=1e-4)
    for a, b in zip(k[:2], p[:2]):
        assert ((a - b).norm() / b.norm()).item() <= 1e-3


def test_blocked_kernel_refuses_what_it_does_not_take(cuda):
    args = sim_inputs(0, 2, 3, 65, 32, 64, cuda)
    with pytest.raises(ValueError, match="T, V <= 64"):
        SB.fused_interaction_similarity_blocked(*args)
    args = sim_inputs(0, 2, 3, 64, 32, 24, cuda)
    with pytest.raises(ValueError, match="D % 16"):
        SB.fused_interaction_similarity_blocked(*args)


def attn_inputs(seed, N, L, D, bias_kind, device):
    rng = np.random.default_rng(seed)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a, np.float32), device=device
                               ).to(dtype)

    args = (t(rng.standard_normal((N, L, D)), torch.bfloat16),
            t(1 + 0.1 * rng.standard_normal(D)), t(0.1 * rng.standard_normal(D)),
            t(rng.standard_normal((3 * D, D)) * D ** -0.5, torch.bfloat16),
            t(0.1 * rng.standard_normal(3 * D)),
            t(rng.standard_normal((D, D)) * D ** -0.5, torch.bfloat16),
            t(0.1 * rng.standard_normal(D)))
    bias = None
    if bias_kind is not None:
        lens = rng.integers(1, L + 1, size=N)
        j = np.arange(L)
        fill = -1e9 if bias_kind == "causal" else -1e6
        pad = np.where(j[None] < lens[:, None], 0.0, fill)[:, None, :]
        b = np.broadcast_to(pad, (N, L, L))
        if bias_kind == "causal":
            b = b + np.where(j[None, :] > j[:, None], -1e9, 0.0)[None]
        bias = t(np.ascontiguousarray(b))
    return args, bias


@pytest.mark.parametrize("N,L,D,H,bias_kind", [
    (6, 50, 768, 12, None),          # vision
    (64, 24, 512, 8, "causal"),      # text
    (64, 12, 512, 8, "keypad"),      # temporal
    (3, 5, 64, 1, None),             # tiny tower, one m-tile
    (2, 64, 128, 2, "causal")])      # longest sequence the kernel takes
def test_attention_kernel_matches_plain(cuda, N, L, D, H, bias_kind):
    args, bias = attn_inputs(N * L, N, L, D, bias_kind, cuda)
    before = BA.ln_attention_residual.launches
    got = BA.ln_attention_residual(*args, H, bias)
    torch.cuda.synchronize()
    assert BA.ln_attention_residual.launches == before + 1
    want = BA.ln_attention_residual_plain(*args, H, bias)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), **K1_TOL)


@pytest.mark.parametrize("N,L,D,H,bias_kind", [
    (6, 50, 768, 12, None),          # vision
    (64, 24, 512, 8, "causal"),      # text
    (64, 12, 512, 8, "keypad"),      # temporal
    (3, 5, 64, 1, None),             # N·L not a multiple of 64, one m-tile
    (2, 64, 128, 2, "causal")])
def test_attention_backward_kernel_matches_plain(cuda, N, L, D, H, bias_kind):
    args, bias = attn_inputs(N * L, N, L, D, bias_kind, cuda)
    rng = np.random.default_rng(N + L)
    g = torch.as_tensor(rng.standard_normal((N, L, D)).astype(np.float32),
                        device=cuda).bfloat16()
    before = BA.ln_attention_residual_bwd.launches
    got = BA.ln_attention_residual_bwd(*args, H, g, bias)
    torch.cuda.synchronize()
    assert BA.ln_attention_residual_bwd.launches == before + 1
    want = BA.ln_attention_residual_bwd_plain(*args, H, g, bias)
    assert got[0].dtype == torch.bfloat16
    torch.testing.assert_close(got[0].float(), want[0].float(), **K1_TOL)
    names = ("dln_w", "dln_b", "dw_qkv", "db_qkv", "dw_out", "db_out")
    for name, a, b in zip(names, got[1:], want[1:]):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        err = (a - b).abs().max().item()
        assert err <= K3_SUM_TOL * b.abs().max().item(), (name, err)
    again = BA.ln_attention_residual_bwd(*args, H, g, bias)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_attention_sublayer_autograd_runs_both_kernels(cuda):
    args, bias = attn_inputs(1, 4, 12, 128, "keypad", cuda)
    leaves = [a.clone().requires_grad_(True) for a in args]
    f, b = BA.ln_attention_residual.launches, \
        BA.ln_attention_residual_bwd.launches
    y = BA.ln_attention_sublayer(*leaves, 2, bias)
    y.float().square().sum().backward()
    assert BA.ln_attention_residual.launches == f + 1
    assert BA.ln_attention_residual_bwd.launches == b + 1
    plain = [a.clone().requires_grad_(True) for a in args]
    BA.ln_attention_sublayer(*plain, 2, bias, kernels=False
                             ).float().square().sum().backward()
    for got, want in zip(leaves, plain):
        assert got.grad.dtype == got.dtype
        err = (got.grad.float() - want.grad.float()).abs().max().item()
        assert err <= 2 ** -5 * want.grad.float().abs().max().item()


def test_attention_kernel_refuses_what_it_does_not_take(cuda):
    args, _ = attn_inputs(0, 2, 12, 128, None, cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        BA.ln_attention_residual(args[0].float(), *args[1:], 2)
    with pytest.raises(ValueError, match="head dim 64"):
        BA.ln_attention_residual(*args, 4)
    with pytest.raises(ValueError, match="w_qkv"):
        BA.ln_attention_residual(args[0], args[1], args[2],
                                 args[3].float(), *args[4:], 2)
    g = torch.zeros_like(args[0])
    with pytest.raises(ValueError, match="bfloat16"):   # fp32 activations
        BA.ln_attention_residual_bwd(args[0].float(), *args[1:], 2, g)
    with pytest.raises(ValueError, match="g must be"):
        BA.ln_attention_residual_bwd(*args, 2, g.float())


SUBLAYER_SHAPES = [
    (6, 50, 768, 12, None),          # vision
    (64, 24, 512, 8, "causal"),      # text
    (64, 12, 512, 8, "keypad"),      # temporal
    (3, 5, 64, 1, None),             # N·L not a multiple of 64, one m-tile
    (2, 64, 128, 2, "causal")]       # longest sequence the kernels take


@pytest.mark.parametrize("N,L,D,H,bias_kind", SUBLAYER_SHAPES)
def test_sublayer_kernels_without_ln_match_plain(cuda, N, L, D, H, bias_kind):
    """K10 and K11 (no LayerNorm, no residual) against their plain
    versions; K11 twice, bit-equal."""
    (h, _, _, *w), bias = attn_inputs(N * L + 1, N, L, D, bias_kind, cuda)
    f, b = BA.attention_sublayer.launches, BA.attention_sublayer_bwd.launches
    got = BA.attention_sublayer(h, *w, H, bias)
    torch.cuda.synchronize()
    assert BA.attention_sublayer.launches == f + 1
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(
        got.float(), BA.attention_sublayer_plain(h, *w, H, bias).float(),
        **K1_TOL)
    rng = np.random.default_rng(N + L + 1)
    g = torch.as_tensor(rng.standard_normal((N, L, D)).astype(np.float32),
                        device=cuda).bfloat16()
    got = BA.attention_sublayer_bwd(h, *w, H, g, bias)
    torch.cuda.synchronize()
    assert BA.attention_sublayer_bwd.launches == b + 1
    want = BA.attention_sublayer_bwd_plain(h, *w, H, g, bias)
    assert got[0].dtype == torch.bfloat16
    torch.testing.assert_close(got[0].float(), want[0].float(), **K1_TOL)
    for name, a, p in zip(("dw_qkv", "db_qkv", "dw_out", "db_out"), got[1:],
                          want[1:]):
        assert a.dtype == torch.float32 and a.shape == p.shape, name
        err = (a - p).abs().max().item()
        assert err <= K3_SUM_TOL * p.abs().max().item(), (name, err)
    again = BA.attention_sublayer_bwd(h, *w, H, g, bias)
    assert all(torch.equal(a, p) for a, p in zip(got, again))


def test_fused_attention_sublayer_runs_both_kernels(cuda):
    """The public function on an fp32 h (cast to bf16 inside): one launch
    of K10 and one of K11, gradients in each input's dtype, held to the
    same through the plain versions."""
    (h, _, _, *w), bias = attn_inputs(2, 4, 12, 128, "keypad", cuda)
    args = [h.float()] + [t.float() for t in w]
    leaves = [a.clone().requires_grad_(True) for a in args]
    f, b = BA.attention_sublayer.launches, BA.attention_sublayer_bwd.launches
    y = BA.fused_attention_sublayer(*leaves, 2, bias)
    assert y.dtype == torch.float32
    y.square().sum().backward()
    assert BA.attention_sublayer.launches == f + 1
    assert BA.attention_sublayer_bwd.launches == b + 1
    plain = [a.clone().requires_grad_(True) for a in args]
    BA.fused_attention_sublayer(*plain, 2, bias, kernels=False
                                ).square().sum().backward()
    for got, want in zip(leaves, plain):
        assert got.grad.dtype == torch.float32
        err = (got.grad - want.grad).abs().max().item()
        assert err <= 2 ** -5 * want.grad.abs().max().item()


def test_sublayer_kernels_refuse_what_they_do_not_take(cuda):
    (h, _, _, *w), _ = attn_inputs(0, 2, 65, 128, None, cuda)
    with pytest.raises(ValueError, match="L <= 64"):
        BA.attention_sublayer(h, *w, 2)
    with pytest.raises(ValueError, match="L <= 64"):
        BA.attention_sublayer_bwd(h, *w, 2, torch.zeros_like(h))
    with pytest.raises(ValueError, match="head dim 64"):
        BA.attention_sublayer(h[:, :12].contiguous(), *w, 4)


# ---------------------------------------------------------------------------
# the sublayer kernels' stages (csrc/sublayer.cuh) and every L they take
# ---------------------------------------------------------------------------

# the GEMM stage's fp32 outputs: bf16 x bf16 products are exact in fp32, so
# the kernel differs from the float64 product by its fp32 additions only.
# A block adds its 16-row k-steps one after another into one accumulator
# (up to ~1,200 of them for the weight gradients' 38,407 rows), whose
# error grows like sqrt(K) fp32 ulps of the running sum: held to 8·sqrt(K)
# ulps (2^-24) of the largest entry.  (cuBLAS sums in a tree and lands
# closer: observed 4.2e-6 against the kernel's 1.2e-4 at K = 38,407, max
# entry 5.08, on an H100.)
GEMM32_ULPS = 8.0
@pytest.mark.parametrize("M", [1, 50, 38400 + 7])
@pytest.mark.parametrize("kind", list(BA.GEMM_KINDS))
def test_sublayer_gemm_matches_plain(cuda, kind, M):
    """Each epilogue and operand orientation at the vision width (D = 768):
    one row, one sequence, and the train step's 38,400 rows plus a ragged
    tile (M rows, or for the weight gradients M rows contracted)."""
    rng = np.random.default_rng(M)
    D = 768
    K, C = {"bias": (D, 3 * D), "bias_residual": (D, D), "bf16": (D, D),
            "fp32": (3 * D, D), "weight_grad": (3 * D, D)}[kind]

    def t(shape, std=1.0, dtype=torch.bfloat16):
        return torch.as_tensor((std * rng.standard_normal(shape)).astype(
            np.float32), device=cuda).to(dtype)

    if kind == "weight_grad":
        a, b = t((M, K)), t((M, C), M ** -0.5)
    else:
        a = t((M, K))
        b = t((C, K) if kind.startswith("bias") else (K, C), K ** -0.5)
    bias = t(C, 0.1, torch.float32)
    res = t((M, C))
    got = BA.sublayer_gemm(a, b, kind, bias, res)
    torch.cuda.synchronize()
    want = BA.sublayer_gemm_plain(a, b, kind, bias, res)
    assert got.dtype == want.dtype and got.shape == want.shape
    if want.dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), **K1_TOL)
    else:
        a64, b64 = a.double(), b.double()
        exact = a64.T @ b64 if kind == "weight_grad" else a64 @ b64
        depth = a.shape[0] if kind == "weight_grad" else a.shape[1]
        err = (got - exact).abs().max().item()
        bound = GEMM32_ULPS * depth ** 0.5 * 2 ** -24 * exact.abs().max()
        assert err <= bound.item(), (err, bound.item())
    assert torch.equal(got, BA.sublayer_gemm(a, b, kind, bias, res))


@pytest.mark.parametrize("L,bias_kind", [(1, None), (12, "keypad"),
                                         (24, "causal"), (50, None),
                                         (64, "causal")])
def test_sublayer_core_bwd_matches_plain(cuda, L, bias_kind):
    """The attention-backward stage: dqkv, and each sequence's fp32 column
    sums of the unrounded dqkv (held like K3's sums: a one-ulp flip of a
    bf16 dlogits moves single terms)."""
    qkv, g, bias = qkv_inputs(L, 5, L, 2, bias_kind, cuda)
    dqkv, part = BA.attention_core_bwd(qkv, 2, g, bias)
    torch.cuda.synchronize()
    want, want_part = BA.attention_core_bwd_plain(qkv, 2, g, bias)
    assert_dqkv_close(dqkv, want, 128)
    assert part.shape == want_part.shape == (5, 3 * 128)
    err = (part - want_part).abs().max().item()
    assert err <= K3_SUM_TOL * want_part.abs().max().item(), err
    again = BA.attention_core_bwd(qkv, 2, g, bias)
    assert torch.equal(dqkv, again[0]) and torch.equal(part, again[1])


EVERY_L = [(5, L, kind) for L in (1, 12, 24, 50, 64)
           for kind in (None, "causal")]


@pytest.mark.parametrize("ln", [True, False])
@pytest.mark.parametrize("N,L,bias_kind", EVERY_L)
def test_sublayer_kernels_at_every_length(cuda, N, L, bias_kind, ln):
    """K1/K3 (ln) and K10/K11 at every L they take, N·L ragged where L
    allows, with and without a bias: forward and all outputs of the
    backward against the plain versions, the backward twice bit-equal, and
    one launch of the sublayer's wrapper each, none of K8's or K9's (the
    core runs inside the sublayer's library)."""
    D, H = 128, 2
    args, bias = attn_inputs(7 * L + N, N, L, D, bias_kind, cuda)
    rng = np.random.default_rng(L)
    g = torch.as_tensor(rng.standard_normal((N, L, D)).astype(np.float32),
                        device=cuda).bfloat16()
    if ln:
        fwd, bwd = BA.ln_attention_residual, BA.ln_attention_residual_bwd
        fwd_p, bwd_p = (BA.ln_attention_residual_plain,
                        BA.ln_attention_residual_bwd_plain)
        names = ("dln_w", "dln_b", "dw_qkv", "db_qkv", "dw_out", "db_out")
    else:
        args = (args[0],) + args[3:]
        fwd, bwd = BA.attention_sublayer, BA.attention_sublayer_bwd
        fwd_p, bwd_p = BA.attention_sublayer_plain, \
            BA.attention_sublayer_bwd_plain
        names = ("dw_qkv", "db_qkv", "dw_out", "db_out")
    counters = (fwd, bwd, A.frame_attention, A.frame_attention_bwd)
    before = [c.launches for c in counters]
    y = fwd(*args, H, bias)
    got = bwd(*args, H, g, bias)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 0, 0]
    torch.testing.assert_close(y.float(), fwd_p(*args, H, bias).float(),
                               **K1_TOL)
    want = bwd_p(*args, H, g, bias)
    assert got[0].dtype == torch.bfloat16
    torch.testing.assert_close(got[0].float(), want[0].float(), **K1_TOL)
    for name, a, b in zip(names, got[1:], want[1:]):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        err = (a - b).abs().max().item()
        assert err <= K3_SUM_TOL * b.abs().max().item(), (name, err)
    again = bwd(*args, H, g, bias)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_serving_path_runs_through_both_kernels(cuda):
    """Tiny towers in bf16 on the card: index + search through the kernels,
    held to the same path through the plain versions."""
    from neighborretr_tpu_torch.core.config import Config, ModelConfig
    from neighborretr_tpu_torch.data.datasets.synthetic import SyntheticDataset
    from neighborretr_tpu_torch.data.loader import BatchLoader
    from neighborretr_tpu_torch import serving
    from neighborretr_tpu_torch.models.weights_io import init_model

    m = dc.replace(ModelConfig.tiny(max_words=8, max_frames=4),
                   compute_dtype="bfloat16")
    cfg = Config(model=m)
    model = init_model(m, seed=0, device=cuda)
    ds = SyntheticDataset(n=20, seed=3, max_words=8, max_frames=4,
                          resolution=m.clip.image_resolution,
                          vocab_size=m.clip.vocab_size)

    class Tok:   # whitespace ids onto the tiny vocab
        def tokenize(self, text):
            return text.split()

        def convert_tokens_to_ids(self, tokens):
            return [1 + sum(map(ord, t)) % 500 for t in tokens]

    def index(kernels):
        loader = BatchLoader(ds, 8, shuffle=False, drop_last=False,
                             workers=0, pad_to_batch=True)
        return serving.build_video_index(model, cfg, loader, dataset=ds,
                                         kernels=kernels)

    k1, k2 = BA.ln_attention_residual.launches, \
        S.fused_interaction_similarity.launches
    idx = index(True)
    queries = ["a dog runs", "cooking pasta", "x"]
    got = serving.Searcher(model, cfg, idx, Tok()).similarities(queries)
    torch.cuda.synchronize()
    # 3 index batches x (2 vision + 2 temporal blocks) + 2 text blocks
    assert BA.ln_attention_residual.launches - k1 == 3 * 4 + 2
    assert S.fused_interaction_similarity.launches - k2 == 1
    want = serving.Searcher(model, cfg, index(False), Tok(),
                            kernels=False).similarities(queries)
    assert got.shape == (3, 20) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=0)


def test_train_step_runs_through_the_training_kernels(cuda):
    """Tiny towers in bf16 on the card: one bank fill and two optimizer
    steps; launches counted per step, losses held to the plain run."""
    from neighborretr_tpu_torch.core import config as C
    from neighborretr_tpu_torch.data.datasets.synthetic import \
        make_synthetic_batch
    from neighborretr_tpu_torch.models.weights_io import init_model
    from neighborretr_tpu_torch.train import memory_bank as MB
    from neighborretr_tpu_torch.train import step as TS

    m = dc.replace(C.ModelConfig.tiny(max_words=8, max_frames=4),
                   compute_dtype="bfloat16")
    B = 8
    cfg = C.Config(model=m, loss=C.LossConfig(num_neighbors=3),
                   data=C.DataConfig(max_words=8, max_frames=4),
                   train=C.TrainConfig(batch_size=B, mb_batch=2))
    model = init_model(m, seed=0, device=cuda)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    batches = [TS.to_device(make_synthetic_batch(m, B, seed=s), cuda)
               for s in range(4)]
    fns = (BA.ln_attention_residual, BA.ln_attention_residual_bwd,
           S.fused_interaction_mean, S.fused_similarity_bwd,
           S.fused_interaction_similarity)
    layers = 2 + 2 + 2                 # vision, text, temporal blocks

    def run(kernels):
        model.load_state_dict(start)
        bank = MB.create(2 * B, 8, 4, m.width, device=cuda)
        for i in range(2):
            bank = TS.fill_bank_step(model, bank, batches[i], cfg, i * B,
                                     kernels)
        state = TS.create_train_state(model, bank)
        gen = torch.Generator(device=cuda).manual_seed(0)
        losses = []
        for batch in batches[2:]:
            before = [f.launches for f in fns]
            state, met = TS.train_step(state, batch, cfg, 10, gen, kernels)
            torch.cuda.synchronize()
            if kernels:
                assert [f.launches - b for f, b in zip(fns, before)] == \
                    [layers, layers, 2, 2, 0]
            losses.append(met["loss"].item())
        return losses, state

    got, state = run(True)
    assert np.isfinite(got).all()
    assert torch.equal(state.bank.ind[:B], batches[3]["idx"].to(torch.int32))
    assert not torch.equal(model.clip.text_projection,
                           start["clip.text_projection"])
    assert torch.equal(model.clip.visual.conv1.weight,
                       start["clip.visual.conv1.weight"])
    want, _ = run(False)
    np.testing.assert_allclose(got, want, rtol=2e-2)


def test_use_pallas_off_launches_no_similarity_kernel(cuda):
    """One bank fill and one train step on tiny bf16 towers under
    use_pallas="off", at the flagship shape and at a long-token one: the
    towers' kernels run, K2 and K4-K7 never launch."""
    from neighborretr_tpu_torch.core import config as C
    from neighborretr_tpu_torch.data.datasets.synthetic import \
        make_synthetic_batch
    from neighborretr_tpu_torch.models.weights_io import init_model
    from neighborretr_tpu_torch.train import memory_bank as MB
    from neighborretr_tpu_torch.train import step as TS

    sims = (S.fused_interaction_similarity, S.fused_interaction_mean,
            S.fused_similarity_bwd, SB.fused_interaction_similarity_blocked,
            SB.fused_blocked_similarity_bwd)
    for words, frames in ((8, 4), (64, 32)):
        m = dc.replace(C.ModelConfig.tiny(max_words=words, max_frames=frames),
                       compute_dtype="bfloat16", use_pallas="off")
        cfg = C.Config(model=m, loss=C.LossConfig(num_neighbors=3),
                       data=C.DataConfig(max_words=words, max_frames=frames),
                       train=C.TrainConfig(batch_size=8, mb_batch=2))
        model = init_model(m, seed=0, device=cuda)
        batches = [TS.to_device(make_synthetic_batch(m, 8, seed=s), cuda)
                   for s in range(3)]
        before = [f.launches for f in sims]
        k1 = BA.ln_attention_residual.launches
        bank = MB.create(16, words, frames, m.width, device=cuda)
        for i in range(2):
            bank = TS.fill_bank_step(model, bank, batches[i], cfg, i * 8)
        state = TS.create_train_state(model, bank)
        _, met = TS.train_step(state, batches[2], cfg, 10,
                               torch.Generator(device=cuda).manual_seed(0))
        torch.cuda.synchronize()
        assert np.isfinite(met["loss"].item())
        assert [f.launches for f in sims] == before, (words, frames)
        assert BA.ln_attention_residual.launches > k1


# ---------------------------------------------------------------------------
# the packed-qkv attention kernels (ops/attention.py)
# ---------------------------------------------------------------------------

def qkv_inputs(seed, N, L, H, bias_kind, device):
    """Packed qkv with unit-variance entries (what a qkv projection of a
    LayerNorm output gives), a cotangent, and the bias."""
    rng = np.random.default_rng(seed)
    D = 64 * H

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a, np.float32), device=device
                               ).to(dtype)

    qkv = t(rng.standard_normal((N, L, 3 * D)), torch.bfloat16)
    g = t(rng.standard_normal((N, L, D)), torch.bfloat16)
    bias = None
    if bias_kind is not None:
        lens = rng.integers(1, L + 1, size=N)
        j = np.arange(L)
        fill = -1e9 if bias_kind == "causal" else -1e6
        pad = np.where(j[None] < lens[:, None], 0.0, fill)[:, None, :]
        b = np.broadcast_to(pad, (N, L, L))
        if bias_kind == "causal":
            b = b + np.where(j[None, :] > j[:, None], -1e9, 0.0)[None]
        bias = t(np.ascontiguousarray(b), torch.float32)
    return qkv, g, bias


# every tower's sequence length (temporal 12, text 24, ViT-B/32 50, the long
# recipes' 64, ViT-B/16 197, ViT-L/14@336px 577), one row, and one past a
# 64-row tile, with each head count and bias kind
QKV_SHAPES = [(L, H, kind) for L in (1, 12, 24, 50, 64, 65, 197, 577)
              for H, kind in ((8, None), (12, "keypad"), (16, "causal"))]
QKV_SHAPES += [(1, 1, None), (65, 2, "causal"), (128, 1, None)]
# lse: fp32 sums in another order and the hardware's ex2/log
LSE_TOL = dict(atol=1e-4, rtol=1e-5)


def assert_dqkv_close(got, want, D):
    """K1's two bf16 roundings, against the largest entry for the entries
    near zero (dK and dV sum L terms of either sign)."""
    for name, a, b in zip(("dq", "dk", "dv"), got.float().split(D, -1),
                          want.float().split(D, -1)):
        assert torch.isfinite(a).all(), name
        err = (a - b).abs()
        bound = 2 ** -6 * b.abs() + 2 ** -7 * b.abs().max()
        assert (err <= bound).all(), (name, err.max().item())


@pytest.mark.parametrize("L,H,bias_kind", QKV_SHAPES)
def test_frame_attention_kernel_matches_plain(cuda, L, H, bias_kind):
    qkv, _, bias = qkv_inputs(L * H, 5, L, H, bias_kind, cuda)
    before = A.frame_attention.launches
    got = A.frame_attention(qkv, H, bias)
    torch.cuda.synchronize()
    assert A.frame_attention.launches == before + 1
    want = A.attention_plain(qkv, H, bias)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), **K1_TOL)
    assert torch.equal(got, A.frame_attention(qkv, H, bias))


@pytest.mark.parametrize("L,H,bias_kind", QKV_SHAPES)
def test_frame_attention_lse_matches_plain(cuda, L, H, bias_kind):
    qkv, _, bias = qkv_inputs(L * H + 1, 5, L, H, bias_kind, cuda)
    out, lse = A.frame_attention(qkv, H, bias, return_lse=True)
    torch.cuda.synchronize()
    want_out, want_lse = A.attention_plain(qkv, H, bias, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (5, H, L)
    torch.testing.assert_close(lse, want_lse, **LSE_TOL)
    assert torch.equal(out, A.frame_attention(qkv, H, bias))
    assert torch.equal(lse, A.frame_attention(qkv, H, bias,
                                              return_lse=True)[1])


@pytest.mark.parametrize("L,H,bias_kind", QKV_SHAPES)
def test_frame_attention_backward_kernel_matches_plain(cuda, L, H, bias_kind):
    """All of dqkv; sums over query tiles are taken in one block in a fixed
    order (no float atomics), so a second call gives the same bits.  Called
    directly, the wrapper runs the forward kernel for out and lse first."""
    qkv, g, bias = qkv_inputs(L + H, 5, L, H, bias_kind, cuda)
    before = (A.frame_attention.launches, A.frame_attention_bwd.launches)
    got = A.frame_attention_bwd(qkv, H, g, bias)
    torch.cuda.synchronize()
    assert (A.frame_attention.launches, A.frame_attention_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    want = A.attention_bwd_plain(qkv, H, g, bias)
    assert got.dtype == torch.bfloat16 and got.shape == qkv.shape
    assert_dqkv_close(got, want, 64 * H)
    assert torch.equal(got, A.frame_attention_bwd(qkv, H, g, bias))


@pytest.mark.parametrize("L,H,bias_kind", QKV_SHAPES)
def test_frame_attention_backward_from_saved_statistics(cuda, L, H,
                                                        bias_kind):
    """As the autograd node calls it: out and lse from the forward kernel,
    one backward launch and no forward; against the plain backward fed the
    plain forward's out and lse; bit-equal twice."""
    qkv, g, bias = qkv_inputs(L + 2 * H, 5, L, H, bias_kind, cuda)
    out, lse = A.frame_attention(qkv, H, bias, return_lse=True)
    before = (A.frame_attention.launches, A.frame_attention_bwd.launches)
    got = A.frame_attention_bwd(qkv, H, g, bias, out=out, lse=lse)
    torch.cuda.synchronize()
    assert (A.frame_attention.launches, A.frame_attention_bwd.launches) == \
        (before[0], before[1] + 1)
    p_out, p_lse = A.attention_plain(qkv, H, bias, return_lse=True)
    want = A.attention_bwd_plain(qkv, H, g, bias, out=p_out, lse=p_lse)
    assert_dqkv_close(got, want, 64 * H)
    assert torch.equal(got, A.frame_attention_bwd(qkv, H, g, bias, out=out,
                                                  lse=lse))


@pytest.mark.parametrize("bias_kind", [None, "keypad", "causal"])
def test_frame_attention_reads_no_row_of_the_next_sequence(cuda, bias_kind):
    """N=3, L=65: the second 64-row tile of sequence 0 holds one row; the
    rows after it in memory are sequence 1's, set to huge values.  A tile
    read past L that took them would move sequence 0's output, lse and
    gradient far outside the tolerance."""
    qkv, g, bias = qkv_inputs(11, 3, 65, 2, bias_kind, cuda)
    qkv[1:] = 200.0
    g[1:] = 200.0
    out, lse = A.frame_attention(qkv, 2, bias, return_lse=True)
    dqkv = A.frame_attention_bwd(qkv, 2, g, bias, out=out, lse=lse)
    torch.cuda.synchronize()
    b0 = None if bias is None else bias[:1].contiguous()
    want_out, want_lse = A.attention_plain(qkv[:1], 2, b0, return_lse=True)
    torch.testing.assert_close(out[:1].float(), want_out.float(), **K1_TOL)
    torch.testing.assert_close(lse[:1], want_lse, **LSE_TOL)
    assert_dqkv_close(dqkv[:1], A.attention_bwd_plain(qkv[:1], 2, g[:1], b0),
                      128)


def test_fused_frame_attention_autograd_runs_both_kernels(cuda):
    qkv, g, bias = qkv_inputs(3, 4, 24, 2, "causal", cuda)
    f, b = A.frame_attention.launches, A.frame_attention_bwd.launches
    x = qkv.clone().requires_grad_(True)
    A.fused_frame_attention(x, 2, bias).backward(g)
    assert (A.frame_attention.launches, A.frame_attention_bwd.launches) == \
        (f + 1, b + 1)
    y = qkv.clone().requires_grad_(True)
    A.fused_frame_attention(y, 2, bias, kernels=False).backward(g)
    assert (A.frame_attention.launches, A.frame_attention_bwd.launches) == \
        (f + 1, b + 1)
    err = (x.grad.float() - y.grad.float()).abs().max().item()
    assert err <= 2 ** -6 * y.grad.float().abs().max().item()


def test_frame_attention_kernel_refuses_what_it_does_not_take(cuda):
    qkv, g, bias = qkv_inputs(0, 2, 12, 2, "keypad", cuda)
    with pytest.raises(ValueError, match="bfloat16"):    # fp32 activations
        A.frame_attention(qkv.float(), 2)
    with pytest.raises(ValueError, match="bfloat16"):
        A.frame_attention_bwd(qkv.float(), 2, g)
    with pytest.raises(ValueError, match="head dim 64"):
        A.frame_attention(qkv, 4)
    with pytest.raises(ValueError, match="contiguous"):
        A.frame_attention(qkv.transpose(0, 1), 2)
    with pytest.raises(ValueError, match="bias"):
        A.frame_attention(qkv, 2, bias[:1])
    with pytest.raises(ValueError, match="g must be"):
        A.frame_attention_bwd(qkv, 2, g.float())
    with pytest.raises(ValueError, match="cpu"):
        A.frame_attention(qkv, 2, bias.cpu())
    out, lse = A.frame_attention(qkv, 2, bias, return_lse=True)
    with pytest.raises(ValueError, match="out must be"):
        A.frame_attention_bwd(qkv, 2, g, bias, out=out.float(), lse=lse)
    with pytest.raises(ValueError, match="lse has shape"):
        A.frame_attention_bwd(qkv, 2, g, bias, out=out, lse=lse[:, :1])
    with pytest.raises(ValueError, match="lse must be"):
        A.frame_attention_bwd(qkv, 2, g, bias, out=out, lse=lse.double())


@pytest.mark.parametrize("impl,policy,want", [
    # launches of (K1, K3, attention forward, attention backward) in one
    # compute_losses + backward on tiny towers of 2 + 2 + 2 blocks
    ("fused_block", None, (6, 6, 0, 0)), ("fused", None, (0, 0, 6, 6)),
    ("fused", "full", (0, 0, 10, 6)), ("fused", "attn", (0, 0, 6, 6)),
    ("fused", "dots", (0, 0, 10, 6)), ("fused_block", "full", (10, 6, 0, 0))])
def test_attention_impl_and_remat_change_what_launches(cuda, impl, policy,
                                                       want):
    from neighborretr_tpu_torch.core import config as C
    from neighborretr_tpu_torch.data.datasets.synthetic import \
        make_synthetic_batch
    from neighborretr_tpu_torch.models.weights_io import init_model
    from neighborretr_tpu_torch.train import memory_bank as MB
    from neighborretr_tpu_torch.train import step as TS

    def losses(kernels, **model):
        m = dc.replace(C.ModelConfig.tiny(max_words=8, max_frames=4),
                       compute_dtype="bfloat16", cluster_noise=False,
                       attention_impl=impl, **model)
        cfg = C.Config(model=m, loss=C.LossConfig(num_neighbors=3),
                       data=C.DataConfig(max_words=8, max_frames=4),
                       train=C.TrainConfig(batch_size=8, mb_batch=2))
        model = init_model(m, seed=0, device=cuda)
        bank = MB.create(16, 8, 4, m.width, device=cuda)._replace(
            feat_t=torch.randn(16, 8, m.width, device=cuda),
            feat_v=torch.randn(16, 4, m.width, device=cuda),
            mask_t=torch.ones(16, 8, device=cuda),
            mask_v=torch.ones(16, 4, device=cuda))
        TS.create_train_state(model, bank)
        total, _ = TS.compute_losses(
            model, cfg, TS.to_device(make_synthetic_batch(m, 8, seed=1), cuda),
            bank, kernels=kernels)
        total.backward()
        return total.item(), model.clip.text_projection.grad.clone()

    fns = (BA.ln_attention_residual, BA.ln_attention_residual_bwd,
           A.frame_attention, A.frame_attention_bwd)
    before = [f.launches for f in fns]
    remat = dict(remat=True, remat_policy=policy) if policy else {}
    got, grad = losses(True, **remat)
    torch.cuda.synchronize()
    assert tuple(f.launches - b for f, b in zip(fns, before)) == want
    plain, plain_grad = losses(False, **remat)
    assert np.isfinite(got) and abs(got - plain) <= 2e-2 * abs(plain)
    assert ((grad - plain_grad).norm() <= 0.1 * plain_grad.norm()).item()
    if policy:      # remat changes no value: the same kernels on the same
        # inputs.  Bit-equality is the CPU tests' to show; on the card
        # torch's float-atomic scatter-adds make one forward differ from its
        # own repeat (2e-5 to 2e-4 of this loss on an H100, where the noise
        # flips a DPC-KNN cluster id), so this holds the plain run's bounds
        same, same_grad = losses(True)
        assert abs(same - got) <= 2e-2 * abs(got)
        assert ((same_grad - grad).norm() <= 0.1 * grad.norm()).item()


def test_device_augment_on_the_card_matches_the_cpu(cuda):
    """The same draws, every op fired over 2 layers, 16 clips of 4 x 40 x 56
    structured frames: the same fp32 arithmetic on both devices, but cos/sin
    (rotations) may differ in their last bit, which moves a warped pixel by
    at most one level."""
    from neighborretr_tpu_torch.ops import device_augment as DA
    rng = np.random.default_rng(0)
    B, F, H, W = 16, 4, 40, 56
    yy, xx = np.mgrid[0:H, 0:W]
    ramp = np.stack([xx * 200 / W, yy * 200 / H, (xx + yy) * 100 / (H + W)],
                    axis=-1)[None, None] + 30
    ramp[:, :, 10:20, 12:30] = 90                      # a flat patch
    ramp[:, :, :, 40:] = np.where(yy[..., 40:, None] % 6 < 3, 220, 35)
    video = np.clip(ramp + rng.normal(0, 8, (B, F, H, W, 3)), 0, 255)
    video = torch.as_tensor(video.astype(np.uint8))
    op = torch.arange(2 * B).view(B, 2) % len(DA.OP_NAMES)
    fire = torch.ones(B, 2, dtype=torch.bool)
    level = torch.as_tensor(rng.uniform(0, 10, (B, 2)).astype(np.float32))
    neg = torch.as_tensor(rng.uniform(size=(B, 2)) < 0.5)
    pol = DA.DeviceAugmentPolicy()
    want = DA.apply_randaugment_draws(video, op, fire, level, neg, pol)
    got = DA.apply_randaugment_draws(
        video.to(cuda), *(t.to(cuda) for t in (op, fire, level, neg)), pol)
    assert got.is_cuda and got.dtype == torch.uint8
    d = (got.cpu().int() - want.int()).abs()
    assert d.max().item() <= 1 and (d > 0).float().mean().item() <= 0.005
    assert (want != video).any()


def _serving_setup(device, n_videos=300, seed=0):
    """A tiny fp32 model (K2 on the card; the towers' attention is plain in
    fp32) and an index of random fp16 features under its meta."""
    import json
    from neighborretr_tpu_torch import serving
    from neighborretr_tpu_torch.core.config import Config, ModelConfig
    from neighborretr_tpu_torch.models import weights_io
    cfg = Config(model=ModelConfig.tiny(max_words=8, max_frames=4))
    model = weights_io.init_model(cfg.model, seed, device)
    rng = np.random.default_rng(seed)
    E = cfg.model.clip.embed_dim
    index = {"video_ids": np.asarray([f"v{i}" for i in range(n_videos)]),
             "v_feat": rng.standard_normal((n_videos, 4, E)).astype(
                 np.float16),
             "v_mask": (np.arange(4)[None] < rng.integers(
                 1, 5, n_videos)[:, None]).astype(np.float32),
             "meta": np.frombuffer(json.dumps(
                 serving._config_meta(cfg, model)).encode(), dtype=np.uint8)}
    return cfg, model, index


class _Tok:
    def tokenize(self, text):
        return text.split()

    def convert_tokens_to_ids(self, tokens):
        import zlib
        special = {"<|startoftext|>": 1, "<|endoftext|>": 2}
        return [special.get(t, 3 + zlib.crc32(t.encode()) % 500)
                for t in tokens]


SERVE_QUERIES = [f"caption {w} number {i}" for i, w in
                 enumerate("red green blue cyan gold pink gray teal".split())]


@pytest.mark.parametrize("rows", [0, 7, 64, 300])
def test_staged_upload_on_card_equals_one_copy(cuda, rows):
    """The staged upload (pinned slabs on a side stream) gives one copy's
    bits, raw and through a Searcher, fp16 and int8."""
    from neighborretr_tpu_torch import serving
    cfg, model, index = _serving_setup(cuda)
    a = index["v_feat"]
    got = serving.staged_device_put(a, rows, cuda)
    assert got.is_cuda and torch.equal(got.cpu(), torch.from_numpy(a))
    q8 = dict(index)
    q8["v_feat"], q8["v_scale"] = serving.quantize_features(a)
    for idx in (index, q8):
        one = serving.Searcher(model, cfg, idx, _Tok(), query_batch=4)
        staged = serving.Searcher(model, cfg, idx, _Tok(), query_batch=4,
                                  staged_upload_rows=rows)
        assert all(torch.equal(a, b) for a, b in
                   zip(one._shards[0][1], staged._shards[0][1]))
        np.testing.assert_array_equal(one.similarities(SERVE_QUERIES),
                                      staged.similarities(SERVE_QUERIES))


def test_prepared_corpus_on_card_matches_the_per_call_path(cuda,
                                                           monkeypatch):
    """A Searcher over 10,000 videos, 64 queries: the corpus prepared once
    scores as `similarity_matrix_device` on the raw rows (the per-call
    path) within 1e-6, with the same top-10 ids; K2 once a call, one
    preparation in all; with `evaluate.local_similarity` lowered to
    bfloat16 as benchmark/controls/readings.py lowers it, the call reaches
    K2's bf16 entry."""
    from neighborretr_tpu_torch import serving
    from neighborretr_tpu_torch.train import evaluate as EV
    cfg, model, index = _serving_setup(cuda, n_videos=10_000)
    searcher = serving.Searcher(model, cfg, index, _Tok(), query_batch=8)
    queries = [f"{SERVE_QUERIES[i % 8]} take {i}" for i in range(64)]
    t_feat, t_mask = serving.encode_queries(model, cfg, _Tok(), queries)
    want = EV.similarity_matrix_device(
        model, t_feat, t_mask, torch.as_tensor(index["v_feat"], device=cuda),
        index["v_mask"])
    before = S.fused_interaction_similarity.launches
    hits = searcher.search(queries, topk=10)
    got = searcher.similarities(queries)
    torch.cuda.synchronize()
    assert S.fused_interaction_similarity.launches == before + 2
    assert searcher.corpus_preparations == 1
    np.testing.assert_allclose(got, want.cpu().numpy(), atol=1e-6, rtol=0)
    top = torch.topk(want, 10, dim=1).indices.cpu().numpy()
    assert [[v for v, _ in row] for row in hits] == \
        [[f"v{j}" for j in row] for row in top]

    orig = EV.local_similarity

    def lowered(*args, **kwargs):
        kwargs["sim_dtype"] = "bfloat16"
        return orig(*args, **kwargs)

    monkeypatch.setattr(EV, "local_similarity", lowered)
    bf16 = S.fused_interaction_similarity.launches_bf16
    low = searcher.similarities(queries)
    torch.cuda.synchronize()
    assert S.fused_interaction_similarity.launches_bf16 == bf16 + 1
    assert 0 < np.abs(low - got).max() < 1e-2
    assert searcher.corpus_preparations == 1


# serving scores on the card: a query's features may depend on the merged
# batch's size (cuBLAS picks a GEMM per shape); chip_smoke.py's SERVE_TOL
SERVE_TOL = 5e-3


def test_dispatcher_on_card_matches_sequential(cuda):
    """Concurrent requests through the dispatcher on the card: the hits of
    each query searched alone (ids, near-ties aside; scores within
    SERVE_TOL), K2 launched once per device call."""
    import threading
    from neighborretr_tpu_torch import serving
    cfg, model, index = _serving_setup(cuda)
    searcher = serving.Searcher(model, cfg, index, _Tok(), query_batch=4)
    searcher.warmup()
    want = [searcher.search([q], topk=5)[0] for q in SERVE_QUERIES]
    d = serving.BatchingDispatcher(searcher, max_batch=16, max_wait_ms=50.0)
    got = [None] * len(SERVE_QUERIES)
    try:
        before = S.fused_interaction_similarity.launches

        def one(i):
            got[i] = d.submit([SERVE_QUERIES[i]], 5)[0]

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(SERVE_QUERIES))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert S.fused_interaction_similarity.launches - before == d.batches
        assert d.batches < len(SERVE_QUERIES)
    finally:
        d.close()
    for g_row, w_row in zip(got, want):
        g_ids, g_s = zip(*g_row)
        w_ids, w_s = zip(*w_row)
        np.testing.assert_allclose(g_s, w_s, atol=SERVE_TOL, rtol=0)
        for r, (gi, wi) in enumerate(zip(g_ids, w_ids)):
            near = [abs(w_s[r] - s) <= SERVE_TOL for s in w_s]
            assert gi == wi or near.count(True) > 1, (r, gi, wi)


def test_bundle_exported_on_card_matches_plain_searcher(cuda, tmp_path):
    """A bundle exported on cuda runs there and gives the plain Searcher's
    top-k ids with scores within 1e-5."""
    from neighborretr_tpu_torch import deploy, serving
    from neighborretr_tpu_torch.data.text import encode_caption
    cfg, model, index = _serving_setup(cuda)
    deploy.save_bundle(str(tmp_path), model, cfg, index, query_batch=4,
                       topk=5)
    bundle = deploy.load_bundle(str(tmp_path))
    assert bundle.meta["platforms"] == ["cuda"] and bundle.device.type == \
        "cuda"
    plain = serving.Searcher(model, cfg, index, _Tok(), query_batch=4,
                             kernels=False)
    for s in range(0, len(SERVE_QUERIES), 4):
        qs = SERVE_QUERIES[s:s + 4]
        enc = [encode_caption(_Tok(), q, 8) for q in qs]
        vals, idx = bundle.search_tokens(
            np.stack([e[0] for e in enc]).astype(np.int32),
            np.stack([e[1] for e in enc]).astype(np.float32))
        for q, hits in enumerate(plain.search(qs, topk=5)):
            assert [bundle.video_ids[j] for j in idx[q]] == \
                [vid for vid, _ in hits]
            np.testing.assert_allclose(vals[q], [sc for _, sc in hits],
                                       rtol=0, atol=1e-5)


def test_all_gather_and_grads_at_world_one_over_nccl(cuda):
    """The data group's collectives over NCCL at world size 1 (the process
    group a one-card `--num_devices 1` run starts): the gather is the
    identity forward and its backward (all-reduce, slice) returns the
    cotangent; the gradient mean and the stop flag pass through."""
    import socket

    import torch.distributed as dist

    from neighborretr_tpu_torch.parallel import mesh as pmesh
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        mesh = pmesh.make_mesh("cuda")
        assert mesh.collective and mesh.world == 1 and mesh.device.index == 0
        x = torch.randn(5, 3, 7, device=cuda, requires_grad=True)
        c = torch.randn(5, 3, 7, device=cuda)
        y = pmesh.all_gather(x, mesh)
        assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()
        (y * c).sum().backward()
        assert torch.equal(x.grad, c)
        p = torch.nn.Parameter(torch.ones(4, device=cuda))
        p.grad = torch.arange(4.0, device=cuda)
        g = pmesh.all_reduce_grads({"p": p}, mesh)["p"]
        assert torch.equal(g, torch.arange(4.0, device=cuda))
        assert pmesh.any_rank(True, mesh) and not pmesh.any_rank(False, mesh)
    finally:
        dist.destroy_process_group()


def test_sharded_searcher_on_card_equals_one_shard(cuda):
    """301 videos in two shards on the one card (one pad row): scores
    bit-equal to one shard's, the same top-5, K2 once per shard a call."""
    from neighborretr_tpu_torch import serving
    cfg, model, index = _serving_setup(cuda, n_videos=301)
    one = serving.Searcher(model, cfg, index, _Tok(), query_batch=4)
    two = serving.Searcher(model, cfg, index, _Tok(), query_batch=4,
                           devices=[cuda, cuda])
    before = S.fused_interaction_similarity.launches
    hits = two.search(SERVE_QUERIES, topk=5)
    assert S.fused_interaction_similarity.launches - before == 2
    assert (one.corpus_preparations, two.corpus_preparations) == (1, 2)
    np.testing.assert_array_equal(two.similarities(SERVE_QUERIES),
                                  one.similarities(SERVE_QUERIES))
    assert hits == one.search(SERVE_QUERIES, topk=5)


@pytest.mark.parametrize("torchscript", [True, False])
def test_openai_archive_loads_on_the_card(cuda, tmp_path, torchscript):
    """An fp16 OpenAI-layout archive read onto a model on the card: the
    CLIP and the temporal tower it seeds equal the load on the CPU."""
    from neighborretr_tpu_torch.core.config import ClipConfig, ModelConfig
    from neighborretr_tpu_torch.models import weights_io as W
    from neighborretr_tpu_torch.tools import clip_archive as CA
    c = ClipConfig.tiny()
    path = str(tmp_path / "clip.pt")
    CA.save_openai_archive(CA.random_openai_state_dict(c, seed=3), c, path,
                           torchscript=torchscript)
    cfg = ModelConfig.tiny()
    on_card = W.load_openai_clip_into(W.init_model(cfg, device=cuda), path)
    on_cpu = W.load_openai_clip_into(W.init_model(cfg), path)
    want = on_cpu.state_dict()
    loaded = [n for n in want if n.startswith(
        ("clip.", "transformerClip.", "frame_position_embeddings."))]
    assert len(loaded) > len(on_cpu.clip.state_dict())
    for name in loaded:
        got = on_card.state_dict()[name]
        assert got.device.type == "cuda" and got.dtype == torch.float32
        assert torch.equal(got.cpu(), want[name]), name


# ---------------------------------------------------------------------------
# the trainer's host-memory paths: the prefetch, host moments and bank
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _deterministic():
    """torch's ordered forms of its scatter-adds (float atomics otherwise:
    two runs of one step differ by 0.4% of the gradient), so that two
    placements can be held to the bit."""
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env


def _tiny_train_setup(cuda, n_batches):
    from neighborretr_tpu_torch.core import config as C
    from neighborretr_tpu_torch.data.datasets.synthetic import \
        make_synthetic_batch

    m = dc.replace(C.ModelConfig.tiny(max_words=8, max_frames=4),
                   compute_dtype="bfloat16", cluster_noise=False)
    host = []
    for s in range(n_batches):
        b = make_synthetic_batch(m, 8, seed=s)
        b["idx"] = b["idx"] + 8 * s
        host.append(b)
    return C, m, host


@pytest.mark.parametrize("moments_dtype", ["float32", "bfloat16"])
def test_host_placements_are_bit_equal_to_the_device_placement(
        cuda, tmp_path, moments_dtype):
    """Bank fill and 3 steps under each placement from the same weights,
    the host ones through a checkpoint round trip before step 3: loss
    terms, parameters, moments and bank equal to the device placement's
    to the bit, and the host-placed state in pinned host memory."""
    from neighborretr_tpu_torch.core import checkpoint as CK
    from neighborretr_tpu_torch.models.weights_io import init_model
    from neighborretr_tpu_torch.train import bertadam as BAD
    from neighborretr_tpu_torch.train import memory_bank as MB
    from neighborretr_tpu_torch.train import step as TS
    from neighborretr_tpu_torch.utils import host_memory

    C, m, host = _tiny_train_setup(cuda, 5)
    batches = [TS.to_device(b, cuda) for b in host]
    terms = ("loss", "centrality_loss", "uniform_loss", "neighbor_loss",
             "kl_loss", "grad_norm")

    def run(bank_at, moments_at, round_trip):
        cfg = C.Config(
            model=m, loss=C.LossConfig(num_neighbors=3),
            optim=C.OptimizerConfig(lr=1e-2, coef_lr=0.1,
                                    moments_dtype=moments_dtype,
                                    moments_placement=moments_at),
            data=C.DataConfig(max_words=8, max_frames=4),
            train=C.TrainConfig(batch_size=8, mb_batch=2,
                                bank_placement=bank_at))

        def fresh(seed):
            model = init_model(m, seed=seed, device=cuda)
            bank = MB.place_bank(MB.create(16, 8, 4, m.width, device=cuda),
                                 bank_at, cuda)
            return TS.create_train_state(model, bank, moments_dtype,
                                         moments_at)

        with _deterministic():
            state = fresh(0)
            bank = state.bank
            for i in range(2):
                bank = TS.fill_bank_step(state.model, bank, batches[i], cfg,
                                         8 * i)
            state.bank = bank
            losses = []
            for i, batch in enumerate(batches[2:]):
                if round_trip and i == 2:
                    path = str(tmp_path / f"{bank_at}-{moments_at}.npz")
                    CK.save_train_state(path, state)
                    state = CK.load_train_state(path, fresh(1))
                    state.opt = BAD.place_moments(state.opt, moments_at, cuda)
                    state.bank = MB.place_bank(state.bank, bank_at, cuda)
                state, met = TS.train_step(state, batch, cfg, 10)
                losses.append([met[k].item() for k in terms])
        host_memory.wait_copies()
        if moments_at == "host":
            assert all(t.is_pinned() for t in state.opt.m.values())
        if bank_at == "host":
            assert all(t.is_pinned() for t in state.bank)
        return dict(
            losses=losses,
            params={k: v.cpu() for k, v in state.model.state_dict().items()},
            m={n: t.cpu() for n, t in state.opt.m.items()},
            v={n: t.cpu() for n, t in state.opt.v.items()},
            bank=[t.cpu() for t in state.bank])

    want = run("device", "device", False)
    assert np.isfinite(want["losses"]).all()
    for bank_at, moments_at in (("device", "host"), ("host", "device"),
                                ("host", "host")):
        got = run(bank_at, moments_at, True)
        where = f"bank {bank_at}, moments {moments_at}"
        assert got["losses"] == want["losses"], where
        for part in ("params", "m", "v"):
            for k, t in want[part].items():
                assert torch.equal(got[part][k], t), (where, part, k)
        for a, b in zip(got["bank"], want["bank"]):
            assert torch.equal(a, b), where


@pytest.mark.parametrize("size", [1, 2, 3])
def test_cuda_prefetch_matches_to_device_while_steps_run(cuda, size):
    """The prefetch's batches (pinned slots, the copy stream, an event the
    compute stream waits on) equal `to_device`'s while train steps keep the
    compute stream busy; the slots are refilled across 6 batches."""
    from neighborretr_tpu_torch.data.device_prefetch import \
        prefetch_to_device
    from neighborretr_tpu_torch.models.weights_io import init_model
    from neighborretr_tpu_torch.train import memory_bank as MB
    from neighborretr_tpu_torch.train import step as TS

    C, m, host = _tiny_train_setup(cuda, 6)
    cfg = C.Config(model=m, loss=C.LossConfig(num_neighbors=3),
                   data=C.DataConfig(max_words=8, max_frames=4),
                   train=C.TrainConfig(batch_size=8, mb_batch=2))
    state = TS.create_train_state(
        init_model(m, seed=0, device=cuda),
        MB.create(16, 8, 4, m.width, device=cuda))
    kept = []
    for batch in prefetch_to_device(iter(host), size, cuda):
        # the batch's first reader is the step's own first kernel
        state, _ = TS.train_step(state, batch, cfg, 10)
        kept.append({k: v.clone() for k, v in batch.items()})
    torch.cuda.synchronize()
    assert len(kept) == len(host)
    for got, b in zip(kept, host):
        want = TS.to_device(b, cuda)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].device == want[k].device
            assert torch.equal(got[k], want[k]), k
