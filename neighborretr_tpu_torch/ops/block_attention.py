"""Fused pre-LN attention sublayer, forward (↔ neighborretr_tpu/ops/
pallas_block_attention.py::fused_ln_attention_residual).

    y = x + W_o · MHA(LN(x) · W_qkv + b_qkv) + b_o        per sequence

with an optional additive fp32 attention bias [N, L, L] (text causal∧padding,
temporal key padding).  Weights are the module's own tensors in torch's
layout: `w_qkv` is `in_proj_weight` [3D, D] (the transpose of the TPU
kernel's input-major [D, 3D]) and `w_out` is `out_proj.weight` [D, D].

`ln_attention_residual_plain` is the plain PyTorch version.  It rounds to
x's dtype at the TPU kernel's rounding points (h, qkv, scaled q, probs,
attn_out) and multiplies in fp32, so with a bf16 x it emulates the kernel's
bf16 operands with fp32 accumulation, and with an fp32 x it is exactly
layer_norm + fp32 attention + residual.  `ln_attention_residual` is the
kernel's wrapper: a CPU tensor takes the plain version; a CUDA tensor runs
csrc/ln_attention_residual.cu, which takes bf16 activations only.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

LN_EPS = 1e-5


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = LN_EPS) -> torch.Tensor:
    """LayerNorm as an fp32 island: computed in fp32, cast back to x's
    dtype (↔ models/layers.py::layer_norm)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    xc = x32 - mean
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    return (xc * rstd * weight.float() + bias.float()).to(x.dtype)


def mha(h, w_qkv, b_qkv, w_out, b_out, n_head: int,
        bias=None) -> torch.Tensor:
    """Plain multi-head self-attention, einsum form (↔ models/layers.py::mha
    with fused=False): h [N, L, D] post-LN, bias [N, L, L] or None.
    Operands are rounded to h's dtype at the TPU kernel's rounding points
    and multiplied in fp32; returns the fp32 sublayer output before the
    residual."""
    dt = h.dtype
    N, L, D = h.shape
    hd = D // n_head

    def rnd(t):                      # round to the operand dtype, keep fp32
        return t.to(dt).float()

    qkv = rnd(h.float() @ rnd(w_qkv).T + b_qkv.float())
    q, k, v = (t.reshape(N, L, n_head, hd) for t in qkv.split(D, dim=-1))
    q = rnd(q * hd ** -0.5)
    logits = torch.einsum("nqhd,nkhd->nhqk", q, k)
    if bias is not None:
        logits = logits + bias.float().reshape(N, 1, L, L)
    probs = rnd(torch.softmax(logits, dim=-1))
    out = rnd(torch.einsum("nhqk,nkhd->nqhd", probs, v).reshape(N, L, D))
    return out @ rnd(w_out).T + b_out.float()


def ln_attention_residual_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                                n_head: int, bias=None) -> torch.Tensor:
    """The kernel's plain version: x + mha(LN(x)), the residual added in
    fp32 and the result returned in x's dtype."""
    x32 = x.float()
    h = layer_norm(x32, ln_w, ln_b).to(x.dtype)
    y = mha(h, w_qkv, b_qkv, w_out, b_out, n_head, bias) + x32
    return y.to(x.dtype)


_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2
             + [ctypes.c_void_p])


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ln_attention_residual(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                          n_head: int, bias=None) -> torch.Tensor:
    """x [N, L, D]; LN params [D]; w_qkv [3D, D], b_qkv [3D]; w_out [D, D],
    b_out [D]; bias [N, L, L] fp32 or None.  Returns [N, L, D] in x's dtype.

    On CUDA: x and both weights bf16, LN params and biases fp32, all
    contiguous; head dim 64 and L <= 64.  Anything else raises."""
    if not x.is_cuda:
        return ln_attention_residual_plain(x, ln_w, ln_b, w_qkv, b_qkv,
                                           w_out, b_out, n_head, bias)
    N, L, D = x.shape
    if x.dtype != torch.bfloat16:
        raise ValueError(
            f"the attention-sublayer kernel computes in bfloat16; got {x.dtype}"
            " activations on CUDA (compute_dtype='float32' has no CUDA kernel "
            "in this port yet — use compute_dtype='bfloat16')")
    if D != 64 * n_head or L > 64:
        raise ValueError(f"attention-sublayer kernel takes head dim 64 and "
                         f"L <= 64; got D={D}, heads={n_head}, L={L}")
    dev = x.device
    f32, b16 = torch.float32, torch.bfloat16
    for name, t, dtype, shape in (
            ("x", x, b16, (N, L, D)), ("ln_w", ln_w, f32, (D,)),
            ("ln_b", ln_b, f32, (D,)), ("w_qkv", w_qkv, b16, (3 * D, D)),
            ("b_qkv", b_qkv, f32, (3 * D,)), ("w_out", w_out, b16, (D, D)),
            ("b_out", b_out, f32, (D,))):
        _check(name, t, dtype, shape, dev)
    if bias is not None:
        _check("bias", bias, f32, (N, L, L), dev)
    attn = torch.empty_like(x)
    y = torch.empty_like(x)
    fn = _build.function("ln_attention_residual",
                         "ln_attention_residual_fwd", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(_build.ptr(x),
                 None if bias is None else _build.ptr(bias),
                 _build.ptr(ln_w), _build.ptr(ln_b), _build.ptr(w_qkv),
                 _build.ptr(b_qkv), _build.ptr(w_out), _build.ptr(b_out),
                 _build.ptr(attn), _build.ptr(y), N, L, D, n_head,
                 LN_EPS, (D // n_head) ** -0.5, _build.stream())
    _build.check(err, "ln_attention_residual_fwd")
    ln_attention_residual.launches += 1
    return y


ln_attention_residual.launches = 0
