"""The port's kernel modules against the JAX package.

ops/similarity.py (K2's module) against pallas_interaction_similarity in
interpret mode, and ops/block_attention.py (K1's module) against the JAX
package's layer_norm + mha + residual (fp32) and its fused Pallas
sublayer kernel in interpret mode (bf16).  Inputs come from a numpy seed
and go to both frameworks as numpy arrays.  The CUDA kernels themselves
are held to these plain versions on a card in test_torch_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neighborretr_tpu.models import layers as JL
from neighborretr_tpu.ops.pallas_block_attention import \
    fused_ln_attention_residual
from neighborretr_tpu.ops.pallas_similarity import \
    pallas_interaction_similarity
from neighborretr_tpu.ops.similarity import \
    interaction_similarity as jax_interaction_similarity
from neighborretr_tpu_torch.ops import block_attention as BA
from neighborretr_tpu_torch.ops import similarity as S


# ---------------------------------------------------------------------------
# K2: token-interaction similarity
# ---------------------------------------------------------------------------

def sim_inputs(seed, A, B, T, V, D):
    rng = np.random.default_rng(seed)
    tf = rng.normal(size=(A, T, D)).astype(np.float32)
    vf = rng.normal(size=(B, V, D)).astype(np.float32)
    tm = (rng.uniform(size=(A, T)) > 0.25).astype(np.float32)
    vm = (rng.uniform(size=(B, V)) > 0.25).astype(np.float32)
    tm[:, 0] = 1
    vm[:, 0] = 1
    tw = rng.dirichlet(np.ones(T), size=A).astype(np.float32)
    vw = rng.dirichlet(np.ones(V), size=B).astype(np.float32)
    return tf, vf, tm, vm, tw, vw


# A and B off the TPU kernel's tiles (8/16/.. rows, 128 columns)
@pytest.mark.parametrize("A,B,T,V,D", [(10, 37, 6, 4, 32),
                                       (3, 130, 5, 3, 16),
                                       (9, 20, 24, 12, 64)])
def test_similarity_plain_matches_pallas(A, B, T, V, D):
    args = sim_inputs(A * B, A, B, T, V, D)
    want = np.asarray(pallas_interaction_similarity(
        *map(jnp.asarray, args), interpret=True))
    got = S.interaction_similarity(*map(torch.as_tensor, args)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
    # the JAX package's einsum form agrees too
    xla = np.asarray(jax_interaction_similarity(*map(jnp.asarray, args)))
    np.testing.assert_allclose(got, xla, atol=2e-5, rtol=1e-4)


def test_similarity_masking_is_multiplicative():
    """A masked token's logit is 0 and still takes part in the max: with
    all-negative logits, masking a token RAISES the max to 0."""
    t = torch.tensor([[[1.0, 0.0]]])
    v = torch.tensor([[[-1.0, 0.0], [-1.0, 0.1]]])
    w = torch.ones(1, 1)
    vw = torch.tensor([[0.5, 0.5]])
    full = S.interaction_similarity(t, v, w, torch.ones(1, 2), w, vw)
    masked = S.interaction_similarity(t, v, w, torch.tensor([[1.0, 0.0]]),
                                      w, vw)
    assert full.item() < 0 and masked.item() > full.item()
    # t2v: max(-1, 0) = 0; v2t: 0.5·(-1) + 0.5·0
    assert masked.item() == pytest.approx(0.5 * (0.0 - 0.5), abs=1e-6)


def test_similarity_wrapper_on_cpu_is_the_plain_version():
    args = [torch.as_tensor(a) for a in sim_inputs(1, 5, 7, 4, 3, 16)]
    before = S.fused_interaction_similarity.launches
    got = S.fused_interaction_similarity(*args)
    assert torch.equal(got, S.interaction_similarity(*args))
    assert S.fused_interaction_similarity.launches == before


def test_kernel_inputs_are_masked_normalised_features():
    """What the wrapper hands the CUDA kernel: l2_normalize(x) · mask, with
    zero rows (norm clamped) staying zero."""
    tf, _, tm, *_ = (torch.as_tensor(a) for a in sim_inputs(5, 4, 3, 6, 2, 16))
    tf[1, 2] = 0
    torch.testing.assert_close(S._normalize_masked(tf, tm),
                               S.l2_normalize(tf) * tm[:, :, None],
                               atol=1e-7, rtol=1e-6)


def test_similarity_chunked_equals_one_shot():
    args = [torch.as_tensor(a) for a in sim_inputs(2, 4, 45, 5, 3, 16)]
    torch.testing.assert_close(S.interaction_similarity_chunked(*args, chunk=8),
                               S.interaction_similarity(*args))


def test_l2_normalize_matches_functional_normalize():
    x = torch.as_tensor(np.random.default_rng(3).normal(size=(4, 7, 16))
                        .astype(np.float32))
    x[0, 0] = 0
    torch.testing.assert_close(S.l2_normalize(x),
                               torch.nn.functional.normalize(x, dim=-1,
                                                             eps=1e-12))


# ---------------------------------------------------------------------------
# K1: fused pre-LN attention sublayer
# ---------------------------------------------------------------------------

D, H = 128, 2          # head dim 64, as in every CLIP tower


def attn_case(seed, N, L, bias_kind):
    """JAX block params with non-trivial LN + numpy inputs and bias."""
    rng = np.random.default_rng(seed)
    p = jax.device_get(JL.block_init(jax.random.PRNGKey(seed), D))
    p["ln_1"]["scale"] = (1 + 0.3 * rng.standard_normal(D)).astype(np.float32)
    p["ln_1"]["bias"] = (0.1 * rng.standard_normal(D)).astype(np.float32)
    p["attn"]["in_proj"]["b"] = (0.1 * rng.standard_normal((3, D))
                                 ).astype(np.float32)
    p["attn"]["out_proj"]["b"] = (0.1 * rng.standard_normal(D)
                                  ).astype(np.float32)
    x = rng.standard_normal((N, L, D)).astype(np.float32)
    bias = None
    if bias_kind is not None:
        lens = rng.integers(1, L + 1, size=N)
        j = np.arange(L)
        if bias_kind == "causal":      # text: causal ∧ padding
            bias = (np.asarray(JL.causal_bias(L))[:, 0]
                    + np.asarray(JL.padding_bias(
                        (j[None] < lens[:, None]).astype(np.float32)))[:, 0])
        else:                          # temporal: key padding, -1e6
            pad = np.where(j[None] < lens[:, None], 0.0, -1e6)
            bias = np.broadcast_to(pad[:, None, :], (N, L, L))
        bias = np.ascontiguousarray(bias, np.float32)
    return p, x, bias


def port_args(p):
    """JAX layouts → the port's torch layouts."""
    a = p["attn"]
    return (torch.as_tensor(p["ln_1"]["scale"]),
            torch.as_tensor(p["ln_1"]["bias"]),
            torch.as_tensor(np.asarray(a["in_proj"]["w"]).reshape(D, 3 * D).T
                            .copy()),
            torch.as_tensor(np.asarray(a["in_proj"]["b"]).reshape(-1)),
            torch.as_tensor(np.asarray(a["out_proj"]["w"]).T.copy()),
            torch.as_tensor(np.asarray(a["out_proj"]["b"])))


CASES = [("vision_like", 3, 50, None), ("text_like", 4, 24, "causal"),
         ("temporal_like", 4, 12, "keypad")]


@pytest.mark.parametrize("name,N,L,bias_kind", CASES)
def test_attention_plain_fp32_matches_jax_einsum(name, N, L, bias_kind):
    p, x, bias = attn_case(1, N, L, bias_kind)
    jb = None if bias is None else jnp.asarray(bias)[:, None]
    want = np.asarray(x + JL.mha(p["attn"], JL.layer_norm(p["ln_1"], x), H,
                                 jb, dtype=jnp.float32, fused=False))
    got = BA.ln_attention_residual_plain(
        torch.as_tensor(x), *port_args(p), H,
        None if bias is None else torch.as_tensor(bias))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name,N,L,bias_kind", CASES)
def test_attention_plain_bf16_matches_pallas_kernel(name, N, L, bias_kind):
    """The bf16 emulation against the TPU kernel in interpret mode; the
    bound is the JAX suite's kernel-vs-einsum bound (observed max error:
    a few bf16 ulps of the output)."""
    p, x, bias = attn_case(2, N, L, bias_kind)
    wqkv, bqkv = JL.packed_qkv_weights(p["attn"]["in_proj"])
    want = np.asarray(fused_ln_attention_residual(
        jnp.asarray(x, jnp.bfloat16), p["ln_1"]["scale"], p["ln_1"]["bias"],
        wqkv, bqkv, p["attn"]["out_proj"]["w"], p["attn"]["out_proj"]["b"],
        H, bias=None if bias is None else jnp.asarray(bias),
        interpret=True).astype(jnp.float32))
    got = BA.ln_attention_residual_plain(
        torch.as_tensor(x).bfloat16(), *port_args(p), H,
        None if bias is None else torch.as_tensor(bias))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=6e-2,
                               rtol=6e-2)


def test_attention_wrapper_on_cpu_is_the_plain_version():
    p, x, bias = attn_case(3, 2, 24, "causal")
    args = (torch.as_tensor(x).bfloat16(), *port_args(p), H,
            torch.as_tensor(bias))
    before = BA.ln_attention_residual.launches
    assert torch.equal(BA.ln_attention_residual(*args),
                       BA.ln_attention_residual_plain(*args))
    assert BA.ln_attention_residual.launches == before


def test_attention_plain_is_layer_norm_plus_mha():
    p, x, _ = attn_case(4, 2, 12, None)
    xt = torch.as_tensor(x)
    h = BA.layer_norm(xt, *port_args(p)[:2])
    torch.testing.assert_close(
        BA.ln_attention_residual_plain(xt, *port_args(p), H),
        xt + BA.mha(h, *port_args(p)[2:], H))
