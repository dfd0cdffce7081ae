"""The arithmetic of the similarity kernels (K2/K4 and the long-token K6,
3xTF32 on the tensor cores) written out in PyTorch, against the JAX package
on the CPU.

  * `split_tf32`: hi keeps 10 mantissa bits, rounded to nearest with ties
    away from zero, lo the rest, and x - hi - lo is below 2^-22 |x|;
  * `similarity_tf32x3` (S, the means over both axes, the routing's maxima)
    against `pallas_interaction_similarity` / `pallas_interaction_mean` in
    interpret mode and against the fp32 plain version, within K2_TOL, on
    the train step's kind of inputs (random features, ragged masks) at
    T = 24, V = 12, D = 512;
  * the same at the long-token shapes (T = V = 64, and a ragged T = 33 /
    V = 17 at D = 48, whose last 32-column k-chunk is half full) against
    `pallas_interaction_similarity_blocked` in interpret mode and the
    blocked plain version, `similarity_blocked_routing_plain`;
  * on inputs whose entries are multiples of 1/8 the split is exact (lo = 0)
    and the routing is `similarity_routing_plain`'s (and at the long-token
    shapes `similarity_blocked_routing_plain`'s) to the bit, ties included.

Inputs come from a numpy seed and go to both frameworks as numpy arrays.
The CUDA kernel is held to this emulation in test_torch_gpu.py.
"""

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
from test_torch_ops import sim_inputs

# the JAX suite's tolerance for the fp32 similarity kernel
K2_TOL = dict(atol=2e-5, rtol=1e-4)
SHAPES = [(3, 10, 24, 12, 512), (9, 17, 24, 12, 512)]
# K6's: T = V = 64, and ragged token counts with D off the 32-column k-chunk
BLOCKED_SHAPES = [(3, 5, 64, 64, 64), (5, 7, 33, 17, 48)]


def prepared(args):
    return S._prepare(*[torch.as_tensor(a) for a in args], False)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 3e4])
def test_split_tf32_keeps_ten_bits_and_the_rest(scale):
    x = torch.as_tensor(np.random.default_rng(7).normal(
        size=4096).astype(np.float32) * scale)
    hi, lo = S.split_tf32(x)
    for half in (hi, lo):
        assert half.dtype == torch.float32
        assert not (half.view(torch.int32) & 0x1FFF).any()
    # hi is x to the nearest of its 11 significant bits
    assert ((x - hi).abs() <= 2.0 ** -11 * x.abs()).all()
    assert ((x - hi - lo).abs() <= 2.0 ** -22 * x.abs()).all()
    assert (hi.double() + lo.double() - x.double()).abs().max() <= \
        2.0 ** -22 * x.abs().max()


def test_split_tf32_rounds_ties_away_from_zero():
    one_ulp = 2.0 ** -10
    x = torch.tensor([1 + one_ulp / 2, -(1 + one_ulp / 2),
                      1 + 3 * one_ulp / 2, 1 + one_ulp / 2 - 2 ** -20,
                      1 + one_ulp / 2 + 2 ** -20], dtype=torch.float32)
    hi, lo = S.split_tf32(x)
    want = torch.tensor([1 + one_ulp, -(1 + one_ulp), 1 + 2 * one_ulp, 1.0,
                         1 + one_ulp], dtype=torch.float32)
    assert torch.equal(hi, want)
    assert torch.equal(hi + lo, x)


@pytest.mark.parametrize("A,B,T_,V,D", SHAPES)
def test_tf32x3_similarity_matches_pallas_and_plain(A, B, T_, V, D):
    args = sim_inputs(A * B, A, B, T_, V, D)
    want = np.asarray(pallas_interaction_similarity(
        *map(jnp.asarray, args), interpret=True))
    got, (m1, _, m2, _) = S.similarity_tf32x3(*prepared(args))
    np.testing.assert_allclose(got.numpy(), want, **K2_TOL)
    plain_s, (p1, _, p2, _) = S.similarity_routing_plain(*prepared(args))
    torch.testing.assert_close(got, plain_s, **K2_TOL)
    torch.testing.assert_close(m1, p1, **K2_TOL)
    torch.testing.assert_close(m2, p2, **K2_TOL)
    # the split does change the logits' last bits on such inputs
    assert not torch.equal(m1, p1)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("A,B,T_,V,D", SHAPES)
def test_tf32x3_mean_matches_pallas(A, B, T_, V, D, axis):
    args = sim_inputs(A + B + axis, A, B, T_, V, D)
    want = np.asarray(pallas_interaction_mean(*map(jnp.asarray, args),
                                              axis=axis, interpret=True))
    got = S.similarity_tf32x3(*prepared(args))[0].mean(dim=axis)
    np.testing.assert_allclose(got.numpy(), want, **K2_TOL)
    plain = S.interaction_mean(*[torch.as_tensor(a) for a in args], axis=axis)
    torch.testing.assert_close(got, plain, **K2_TOL)


def exact_inputs(seed, A, B, T_, V, D):
    """Prepared inputs with entries in multiples of 1/8 up to 1/2, masked
    tokens as zero rows and each video's last token a copy of its first:
    every logit is exact in fp32, and ties are many."""
    rng = np.random.default_rng(seed)
    tm = np.arange(T_)[None] < rng.integers(1, T_ + 1, A)[:, None]
    vm = np.arange(V)[None] < rng.integers(1, V + 1, B)[:, None]
    tn = rng.integers(-4, 5, (A, T_, D)) / 8.0 * tm[..., None]
    vn = rng.integers(-4, 5, (B, V, D)) / 8.0 * vm[..., None]
    vn[:, V - 1] = vn[:, 0]
    arrays = (tn, vn, rng.dirichlet(np.ones(T_), size=A),
              rng.dirichlet(np.ones(V), size=B))
    return [torch.as_tensor(np.asarray(a, np.float32)) for a in arrays]


@pytest.mark.parametrize("A,B,T_,V,D", [(5, 11, 24, 12, 512),
                                        (7, 3, 9, 5, 64)])
def test_tf32x3_routing_on_exact_inputs_is_the_plain_routing(A, B, T_, V, D):
    tn, vn, tw, vw = exact_inputs(A * B + T_, A, B, T_, V, D)
    for x in (tn, vn):
        hi, lo = S.split_tf32(x)
        assert torch.equal(hi, x) and not lo.any()
    got_s, got = S.similarity_tf32x3(tn, vn, tw, vw)
    want_s, want = S.similarity_routing_plain(tn, vn, tw, vw)
    torch.testing.assert_close(got_s, want_s, **K2_TOL)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # ties decide indices here: masked tokens' logits are all 0, and a
    # video's last token ties its first, which the first index keeps
    assert (want[0] == 0).any() and not (want[1] == V - 1).any()


@pytest.mark.parametrize("A,B,T_,V,D", BLOCKED_SHAPES)
def test_tf32x3_blocked_similarity_matches_pallas_and_plain(A, B, T_, V, D):
    args = sim_inputs(A * B + T_, A, B, T_, V, D)
    want = np.asarray(pallas_interaction_similarity_blocked(
        *map(jnp.asarray, args), interpret=True))
    got, (m1, _, m2, _) = S.similarity_tf32x3(*prepared(args))
    np.testing.assert_allclose(got.numpy(), want, **K2_TOL)
    plain_s, (p1, _, p2, _) = SB.similarity_blocked_routing_plain(
        *prepared(args))
    torch.testing.assert_close(got, plain_s, **K2_TOL)
    torch.testing.assert_close(m1, p1, **K2_TOL)
    torch.testing.assert_close(m2, p2, **K2_TOL)
    assert not torch.equal(m1, p1)


@pytest.mark.parametrize("A,B,T_,V,D", BLOCKED_SHAPES)
def test_tf32x3_blocked_routing_on_exact_inputs_is_the_plain_routing(
        A, B, T_, V, D):
    tn, vn, tw, vw = exact_inputs(A * B * T_, A, B, T_, V, D)
    got_s, got = S.similarity_tf32x3(tn, vn, tw, vw)
    want_s, want = SB.similarity_blocked_routing_plain(tn, vn, tw, vw)
    torch.testing.assert_close(got_s, want_s, **K2_TOL)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (want[0] == 0).any() and not (want[1] == V - 1).any()
