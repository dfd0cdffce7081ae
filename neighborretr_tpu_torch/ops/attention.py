"""Multi-head self-attention on packed qkv, forward and backward
(↔ neighborretr_tpu/ops/pallas_attention.py::fused_frame_attention and its
custom VJPs).

    out[n] = softmax(q_n k_nᵀ · hd^-0.5 + bias_n) v_n        per sequence, head

from the packed output of the qkv projection, qkv [N, L, 3D] (q, k, v of
head h at columns h·hd, D + h·hd, 2D + h·hd of a row: the order torch's
`in_proj_weight` [3D, D] gives), straight into [N, L, D], with an optional
additive fp32 bias [N, L, L] (text causal∧padding, temporal key padding).
The qkv and out projections stay outside, as in the JAX package.

The JAX package computes this function with six TPU kernels: several frames
per grid cell under a frame-block-diagonal mask, query rows in chunks for
long sequences, and a biased variant, each with its backward.  The frame
batching, the mask between frames and the row chunking are TPU tiling
devices, not semantics; here one forward and one backward kernel
(csrc/frame_attention.cu) serve every L, with or without bias.

A row whose every bias entry is the mask value has no defined answer (the
TPU kernel spreads it over the other frames of its grid cell, a
per-sequence softmax over the row's own L keys).  No configuration produces
one: a text row sees itself, and a video has at least one frame.

`attention_plain` / `attention_bwd_plain` are the plain PyTorch versions,
with the TPU kernels' rounding points: q·scale in fp32 then rounded, fp32
logits + bias, fp32 softmax, probabilities rounded before probs·V, output
in qkv's dtype; backward dV from the rounded probabilities, fp32 dprobs,
dlogits·scale rounded, dK against the unscaled q, dqkv in qkv's dtype.  With
fp32 inputs nothing is rounded and they are the exact function and
gradient.  ops/block_attention.py's plain versions share this arithmetic
(`attention_core`).  `frame_attention` / `frame_attention_bwd` are the
kernels' wrappers: a CPU tensor takes the plain version, a CUDA tensor
launches the kernel (bf16, head dim 64) or raises.

The forward also gives each row's log-sum-exp of its logits, lse [N, H, L]
fp32 (`return_lse=True`); the backward takes the forward's output and lse
(`out=`, `lse=`) and walks the keys once from them.  Past L = 64 (more than
one 64-key tile) the kernels move two rounding points against the TPU's
(csrc/frame_attention.cu): the forward rounds the unnormalised
probabilities and divides after probs·V, the backward takes sum_k
dprobs·probs as rowsum(g ∘ out) from the bf16 out; at L <= 64 they keep the
TPU's.
The plain backward takes its probabilities from a given lse (exp(logits -
lse) instead of the softmax: fp32 values a few ulps apart, which agree
within one bf16 rounding once rounded) and keeps the TPU's sum; it accepts
`out` for the kernel's signature.
`fused_frame_attention` joins forward and backward in one autograd
function that saves qkv, the bias, out and lse; it is what the model calls.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

HEAD_DIM = 64          # what csrc/frame_attention.cu is written for


def attention_core(qkv: torch.Tensor, n_head: int,
                   bias: Optional[torch.Tensor] = None,
                   g: Optional[torch.Tensor] = None,
                   lse: Optional[torch.Tensor] = None,
                   with_lse: bool = False):
    """The arithmetic every plain version shares.  qkv [N, L, 3D] and
    g [N, L, D] hold values of the operand dtype `qkv.dtype` → (out [N, L, D],
    dqkv [N, L, 3D] or None without g), both fp32: out rounded to the
    operand dtype, dqkv not yet (a caller may sum it first); with_lse: and
    the logits' log-sum-exp per row, [N, H, L] fp32.  lse: the probabilities
    as exp(logits - lse) instead of the softmax."""
    dt = qkv.dtype
    N, L, D3 = qkv.shape
    D = D3 // 3
    hd = D // n_head
    scale = hd ** -0.5

    def rnd(t):                      # round to the operand dtype, keep fp32
        return t.to(dt).float()

    q, k, v = (t.reshape(N, L, n_head, hd)
               for t in qkv.float().split(D, dim=-1))
    logits = torch.einsum("nqhd,nkhd->nhqk", rnd(q * scale), k)
    if bias is not None:
        logits = logits + bias.float().reshape(N, 1, L, L)
    if lse is None:
        probs = torch.softmax(logits, dim=-1)
    else:
        probs = torch.exp(logits - lse.float().reshape(N, n_head, L, 1))
    p16 = rnd(probs)
    out = rnd(torch.einsum("nhqk,nkhd->nqhd", p16, v).reshape(N, L, D))
    dqkv = None
    if g is not None:
        g3 = g.float().reshape(N, L, n_head, hd)
        dv = torch.einsum("nhqk,nqhd->nkhd", p16, g3)
        dprobs = torch.einsum("nqhd,nkhd->nhqk", g3, v)
        dlogits = probs * (dprobs
                           - (dprobs * probs).sum(dim=-1, keepdim=True))
        dl16 = rnd(dlogits * scale)
        dq = torch.einsum("nhqk,nkhd->nqhd", dl16, k)
        dk = torch.einsum("nhqk,nqhd->nkhd", dl16, q)        # unscaled q
        dqkv = torch.cat([t.reshape(N, L, D) for t in (dq, dk, dv)], dim=-1)
    if with_lse:
        return out, dqkv, torch.logsumexp(logits, dim=-1)
    return out, dqkv


def attention_plain(qkv: torch.Tensor, n_head: int,
                    bias: Optional[torch.Tensor] = None,
                    return_lse: bool = False):
    """The forward kernel's plain version: [N, L, 3D] → [N, L, D] in qkv's
    dtype; with return_lse also each row's log-sum-exp [N, H, L] fp32."""
    if not return_lse:
        return attention_core(qkv, n_head, bias)[0].to(qkv.dtype)
    out, _, lse = attention_core(qkv, n_head, bias, with_lse=True)
    return out.to(qkv.dtype), lse


def attention_bwd_plain(qkv: torch.Tensor, n_head: int, g: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        out: Optional[torch.Tensor] = None,
                        lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The backward kernel's plain version: g = dout [N, L, D] in qkv's dtype
    → dqkv [N, L, 3D] in qkv's dtype.  Recomputes the logits from qkv; the
    probabilities from `lse` where it is given, else the softmax.  `out` is
    accepted for the kernel's signature and not read (the TPU's
    sum_k dprobs·probs is kept)."""
    return attention_core(qkv, n_head, bias, g, lse)[1].to(qkv.dtype)


def _check_cuda_args(qkv, n_head, bias, g=None, out=None, lse=None):
    """What both kernels take: bf16 contiguous qkv (and g, out), head dim
    64, an fp32 contiguous [N, L, L] bias and [N, H, L] lse on the same
    device.  Anything else raises."""
    if qkv.dim() != 3 or qkv.shape[2] % 3:
        raise ValueError(f"qkv must be [N, L, 3D], got {tuple(qkv.shape)}")
    N, L, D3 = qkv.shape
    D = D3 // 3
    if qkv.dtype != torch.bfloat16:
        raise ValueError(
            f"the attention kernel computes in bfloat16; got {qkv.dtype} qkv "
            "on CUDA (with compute_dtype='float32' use "
            "attention_impl='einsum')")
    if D != HEAD_DIM * n_head:
        raise ValueError(f"the attention kernel takes head dim {HEAD_DIM}; "
                         f"got D={D}, heads={n_head}")
    if N < 1 or L < 1 or N > 65535:
        raise ValueError(f"the attention kernel takes 1 <= N <= 65535 and "
                         f"L >= 1; got N={N}, L={L}")
    tensors = [("qkv", qkv, torch.bfloat16, (N, L, D3))]
    if g is not None:
        tensors.append(("g", g, torch.bfloat16, (N, L, D)))
    if out is not None:
        tensors.append(("out", out, torch.bfloat16, (N, L, D)))
    if lse is not None:
        tensors.append(("lse", lse, torch.float32, (N, n_head, L)))
    if bias is not None:
        tensors.append(("bias", bias, torch.float32, (N, L, L)))
    for name, t, dtype, shape in tensors:
        if t.device != qkv.device:
            raise ValueError(f"{name} is on {t.device}, qkv on {qkv.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want "
                             f"{shape}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


_FWD_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def frame_attention(qkv: torch.Tensor, n_head: int,
                    bias: Optional[torch.Tensor] = None,
                    return_lse: bool = False):
    """qkv [N, L, 3D]; bias [N, L, L] fp32 or None → [N, L, D] in qkv's
    dtype, and with return_lse each row's log-sum-exp [N, H, L] fp32.  A CPU
    tensor takes the plain version.  On CUDA: bf16, contiguous, head dim
    64, any L; anything else raises."""
    if not qkv.is_cuda:
        return attention_plain(qkv, n_head, bias, return_lse)
    _check_cuda_args(qkv, n_head, bias)
    N, L, D3 = qkv.shape
    out = torch.empty((N, L, D3 // 3), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((N, n_head, L), dtype=torch.float32, device=qkv.device)
    fn = _build.function("frame_attention", "frame_attention_fwd",
                         _FWD_ARGTYPES)
    with torch.cuda.device(qkv.device):
        err = fn(_build.ptr(qkv), None if bias is None else _build.ptr(bias),
                 _build.ptr(out), _build.ptr(lse), N, L, D3 // 3, n_head,
                 _build.stream())
    _build.check(err, "frame_attention_fwd")
    frame_attention.launches += 1
    return (out, lse) if return_lse else out


frame_attention.launches = 0


def frame_attention_bwd(qkv: torch.Tensor, n_head: int, g: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        out: Optional[torch.Tensor] = None,
                        lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Backward of `frame_attention`: qkv, g = dout [N, L, D], and the
    forward's out and lse → dqkv [N, L, 3D] in qkv's dtype.  Without out or
    lse (a direct call) the forward kernel runs first for them.  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel under
    the forward's conditions.  Sums over query tiles are taken in a fixed
    order inside one block (no float atomics), so two calls give the same
    bits."""
    if not qkv.is_cuda:
        return attention_bwd_plain(qkv, n_head, g, bias, out, lse)
    _check_cuda_args(qkv, n_head, bias, g, out, lse)
    if out is None or lse is None:
        out, lse = frame_attention(qkv, n_head, bias, return_lse=True)
    N, L, _ = qkv.shape
    dqkv = torch.empty_like(qkv)
    # each query row's softmax offset, scale and sum_k dprobs·probs, from
    # the dQ kernel to the dK/dV kernel
    stats = torch.empty((N, n_head, 3, L), dtype=torch.float32,
                        device=qkv.device)
    fn = _build.function("frame_attention", "frame_attention_bwd",
                         _BWD_ARGTYPES)
    with torch.cuda.device(qkv.device):
        err = fn(_build.ptr(qkv), None if bias is None else _build.ptr(bias),
                 _build.ptr(g), _build.ptr(out), _build.ptr(lse),
                 _build.ptr(stats), _build.ptr(dqkv), N, L,
                 qkv.shape[2] // 3, n_head, _build.stream())
    _build.check(err, "frame_attention_bwd")
    frame_attention_bwd.launches += 1
    return dqkv


frame_attention_bwd.launches = 0


class _FrameAttention(torch.autograd.Function):
    """Forward and backward as one autograd node.  Saves qkv, the bias, the
    output (which the out projection keeps anyway) and lse; the backward
    recomputes the logits once from them.  The bias is a mask-derived
    constant and gets no gradient."""

    @staticmethod
    def forward(ctx, qkv, bias, n_head, kernels):
        fwd = frame_attention if kernels else attention_plain
        out, lse = fwd(qkv, n_head, bias, return_lse=True)
        ctx.save_for_backward(qkv, bias, out, lse)
        ctx.n_head, ctx.kernels = n_head, kernels
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, bias, out, lse = ctx.saved_tensors
        bwd = frame_attention_bwd if ctx.kernels else attention_bwd_plain
        return (bwd(qkv, ctx.n_head, g.to(qkv.dtype).contiguous(), bias,
                    out=out, lse=lse),
                None, None, None)


def fused_frame_attention(qkv: torch.Tensor, n_head: int,
                          bias: Optional[torch.Tensor] = None,
                          kernels: bool = True) -> torch.Tensor:
    """Self-attention over packed qkv [N, L, 3D] → [N, L, D], differentiable
    in qkv.  bias: per-sequence additive [N, L, L] fp32 or None.
    `kernels=True`: the CUDA kernels on a CUDA tensor, the plain versions on
    a CPU tensor.  `kernels=False`: the plain versions on any device."""
    return _FrameAttention.apply(qkv.contiguous(), bias, n_head, kernels)
