"""K10/K11's module against the JAX package: the attention sublayer without
LayerNorm and residual, y = W_o · MHA(h · W_qkv + b_qkv) + b_o.

  * the port's `fused_attention_sublayer` in bf16 against the JAX one in
    interpret mode (the TPU kernels `_block_attention_core`,
    `_block_attention_biased_core` and their backwards): the forward and all
    five cotangents through `jax.vjp` with the same g;
  * the fp32 plain versions against `layers.mha(fused=False)` in fp32,
    forward and VJP;
  * the CPU wrappers are the plain versions, the autograd node's written
    backward is the exact gradient in fp32, and what the CUDA kernels do not
    take raises in the argument check.

Inputs come from a numpy seed and go to both frameworks as numpy arrays.
The CUDA kernels are held to these plain versions in test_torch_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neighborretr_tpu.models import layers as JL
from neighborretr_tpu.ops.pallas_block_attention import \
    fused_attention_sublayer as jax_sublayer
from neighborretr_tpu_torch.ops import block_attention as BA

D, H = 128, 2          # head dim 64, as in every CLIP tower
# (N, L, bias): the vision tower's L with no bias, text with causal∧padding,
# temporal with key padding
CASES = [(4, 50, None), (4, 24, "causal"), (4, 12, "keypad")]
# bf16 against bf16: the two round at the same points and differ only where
# differently ordered fp32 sums flip a bf16 rounding (two bf16 steps), as
# K1/K3's plain versions are held to the TPU kernels
BF16_TOL = dict(atol=2 ** -6, rtol=2 ** -6)


def sublayer_case(seed, N, L, bias_kind):
    """Numpy inputs in the port's layouts: h, w_qkv [3D, D], b_qkv [3D],
    w_out [D, D] (out, in), b_out [D], g, bias [N, L, L] or None."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    arrs = [rng.standard_normal((N, L, D)).astype(f32),
            (rng.standard_normal((3 * D, D)) * D ** -0.5).astype(f32),
            (0.1 * rng.standard_normal(3 * D)).astype(f32),
            (rng.standard_normal((D, D)) * D ** -0.5).astype(f32),
            (0.1 * rng.standard_normal(D)).astype(f32),
            rng.standard_normal((N, L, D)).astype(f32)]
    bias = None
    if bias_kind is not None:
        lens = rng.integers(1, L + 1, size=N)
        j = np.arange(L)
        if bias_kind == "causal":      # text: causal ∧ padding
            bias = (np.asarray(JL.causal_bias(L))[:, 0]
                    + np.asarray(JL.padding_bias(
                        (j[None] < lens[:, None]).astype(f32)))[:, 0])
        else:                          # temporal: key padding, -1e6
            pad = np.where(j[None] < lens[:, None], 0.0, -1e6)
            bias = np.broadcast_to(pad[:, None, :], (N, L, L))
        bias = np.ascontiguousarray(bias, f32)
    return arrs, bias


def jax_weights(w_qkv, b_qkv, w_out, b_out):
    """The port's layouts → the JAX kernel's input-major ones."""
    return w_qkv.T, b_qkv, w_out.T, b_out


@pytest.mark.parametrize("h_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("N,L,bias_kind", CASES)
def test_fused_sublayer_matches_the_tpu_kernel(N, L, bias_kind, h_dtype):
    """Forward and all five cotangents: h in bf16 or fp32 (cast to bf16
    inside, either way), fp32 weights and biases, the same g."""
    (h, w_qkv, b_qkv, w_out, b_out, g), bias = sublayer_case(N * L, N, L,
                                                             bias_kind)
    jdt = jnp.dtype(h_dtype)
    jb = None if bias is None else jnp.asarray(bias)

    def jfn(h, wq, bq, wo, bo):
        return jax_sublayer(h, wq, bq, wo, bo, H, bias=jb, interpret=True)

    jh = jnp.asarray(h, jdt)
    jy, vjp = jax.vjp(jfn, jh, *map(jnp.asarray, jax_weights(
        w_qkv, b_qkv, w_out, b_out)))
    jg = vjp(jnp.asarray(g, jdt))
    want = [np.asarray(jnp.asarray(a, jnp.float32)) for a in (jy, *jg)]
    want[2], want[4] = want[2].T, want[4].T          # back to torch layouts

    tdt = getattr(torch, h_dtype)
    leaves = [torch.as_tensor(h).to(tdt)] + [
        torch.as_tensor(a) for a in (w_qkv, b_qkv, w_out, b_out)]
    leaves = [t.requires_grad_(True) for t in leaves]
    y = BA.fused_attention_sublayer(
        *leaves, H, None if bias is None else torch.as_tensor(bias))
    y.backward(torch.as_tensor(g).to(tdt))
    assert y.dtype == tdt
    got = [y.detach()] + [t.grad for t in leaves]
    assert all(a.dtype == t.dtype for a, t in zip(got[1:], leaves))
    names = ("y", "dh", "dw_qkv", "db_qkv", "dw_out", "db_out")
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.float().numpy(), b, err_msg=name,
                                   **BF16_TOL)
    # the weights' gradients are bf16-rounded, the biases' are not
    for t in (leaves[1], leaves[3]):
        assert torch.equal(t.grad, t.grad.bfloat16().float())


@pytest.mark.parametrize("N,L,bias_kind", CASES)
def test_plain_fp32_is_the_einsum_composition(N, L, bias_kind):
    """With fp32 operands nothing is rounded: the plain forward and the
    written-out backward against layers.mha(fused=False) and its VJP."""
    (h, w_qkv, b_qkv, w_out, b_out, g), bias = sublayer_case(7 + L, N, L,
                                                             bias_kind)
    jb = None if bias is None else jnp.asarray(bias)[:, None]

    def jfn(h, wq, bq, wo, bo):
        p = {"in_proj": {"w": wq.reshape(D, 3, D), "b": bq.reshape(3, D)},
             "out_proj": {"w": wo, "b": bo}}
        return JL.mha(p, h, H, jb, dtype=jnp.float32, fused=False)

    jy, vjp = jax.vjp(jfn, jnp.asarray(h), *map(jnp.asarray, jax_weights(
        w_qkv, b_qkv, w_out, b_out)))
    want = [np.asarray(a) for a in (jy, *vjp(jnp.asarray(g)))]
    want[2], want[4] = want[2].T, want[4].T

    args = [torch.as_tensor(a) for a in (h, w_qkv, b_qkv, w_out, b_out)]
    tb = None if bias is None else torch.as_tensor(bias)
    got = [BA.attention_sublayer_plain(*args, H, tb), *BA.
           attention_sublayer_bwd_plain(*args, H, torch.as_tensor(g), tb)]
    names = ("y", "dh", "dw_qkv", "db_qkv", "dw_out", "db_out")
    for name, a, b in zip(names, got, want):
        assert a.dtype == torch.float32, name
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4, rtol=1e-4,
                                   err_msg=name)


def test_wrappers_on_cpu_are_the_plain_versions():
    (h, w_qkv, b_qkv, w_out, b_out, g), bias = sublayer_case(3, 2, 24,
                                                             "causal")
    b16 = torch.bfloat16
    args = (torch.as_tensor(h, dtype=b16), torch.as_tensor(w_qkv, dtype=b16),
            torch.as_tensor(b_qkv), torch.as_tensor(w_out, dtype=b16),
            torch.as_tensor(b_out), H)
    tb, tg = torch.as_tensor(bias), torch.as_tensor(g, dtype=b16)
    f, b = BA.attention_sublayer.launches, BA.attention_sublayer_bwd.launches
    assert torch.equal(BA.attention_sublayer(*args, tb),
                       BA.attention_sublayer_plain(*args, tb))
    for a, p in zip(BA.attention_sublayer_bwd(*args, tg, tb),
                    BA.attention_sublayer_bwd_plain(*args, tg, tb)):
        assert torch.equal(a, p)
    assert BA.attention_sublayer.launches == f
    assert BA.attention_sublayer_bwd.launches == b


def test_autograd_node_is_the_exact_gradient_in_fp32():
    """The autograd node with fp32 operands (nothing rounded) against
    autograd through the plain forward: the written backward is the
    gradient (1e-5: fp32 sums in another order)."""
    (h, w_qkv, b_qkv, w_out, b_out, g), _ = sublayer_case(5, 3, 6, None)
    bias = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (3, 6, 6)).astype(np.float32))

    def leaves():
        return [torch.as_tensor(a).requires_grad_(True)
                for a in (h, w_qkv, b_qkv, w_out, b_out)]

    a, b = leaves(), leaves()
    route = (BA.attention_sublayer, BA.attention_sublayer_bwd)
    BA._Sublayer.apply(route, H, bias, *a).backward(torch.as_tensor(g))
    BA.attention_sublayer_plain(*b, H, bias).backward(torch.as_tensor(g))
    for got, want in zip(a, b):
        np.testing.assert_allclose(got.grad.numpy(), want.grad.numpy(),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("change,match", [
    (dict(L=65), "L <= 64"),                   # longer than the kernel takes
    (dict(n_head=4), "head dim 64"),           # head dim 32
    (dict(h_dtype=torch.float32), "bfloat16"),
    (dict(bias_shape=(2, 24, 12)), "bias has shape")])
def test_what_the_kernels_do_not_take_raises(change, match):
    """The argument check that guards the CUDA path, run on CPU tensors."""
    N, L = 2, change.get("L", 24)
    b16 = torch.bfloat16
    h = torch.zeros(N, L, D, dtype=change.get("h_dtype", b16))
    bias = torch.zeros(change.get("bias_shape", (N, L, L)))
    with pytest.raises(ValueError, match=match):
        BA._check_cuda_args(h, None, None, torch.zeros(3 * D, D, dtype=b16),
                            torch.zeros(3 * D), torch.zeros(D, D, dtype=b16),
                            torch.zeros(D), change.get("n_head", H), bias)
