"""Token-interaction similarity at long-token shapes, T·V >= 2048: the
64-word / 64-frame recipes (↔ neighborretr_tpu/ops/pallas_similarity_blocked.py
::pallas_interaction_similarity_blocked).

The function is ops/similarity.py's; what differs is the size.  At T = V =
64 against a memory bank of 1,920 rows the [A, T, B, V] logits are 4 GB, so
neither version here builds them whole:

- `fused_interaction_similarity_blocked` is the kernels' wrapper.  A CUDA
  tensor runs csrc/interaction_similarity_blocked.cu: the forward is the
  short kernel's tile (csrc/similarity_tile.cuh: the logits on the TF32
  tensor cores in a 3xTF32 split, a fresh accumulator every 32 columns of
  D, the chunks summed in fp32, both max-reductions over a logits tile in
  shared memory) at 2 captions x 2 videos of 64 tokens a warpgroup, and
  writes S [A, B]; under autograd it also saves
  the routing, per (caption, video) the max over video tokens of each
  caption token's logits and its FIRST index (m1, i1) and the max over
  caption tokens of each video token's and its first index (m2, i2); an
  index whose max has a near-tie is re-picked in float64, so the routing
  is float64's first argmax.  The
  backward kernel recomputes nothing: it gathers, in a fixed order, the
  feature gradients autograd asks for by those saved indices (two runs give
  the same bits).  A CPU tensor, or `kernels=False` on any device, takes
- the plain PyTorch version: `similarity_blocked_plain` /
  `similarity_blocked_routing_plain` and `similarity_blocked_bwd_routed_plain`,
  the forward (with its routing) and the written-out backward of
  ops/similarity.py in video-side chunks that bound the logits.  The
  backward routes each max to the first index that attains it; ties are the
  normal case (masked tokens are zero rows), and autograd of `amax` would
  split them.

As in the TPU wrapper, the masks and the L2 normalisation sit outside the
kernels and get their gradients from autograd.  fp32 inputs and outputs;
the kernel's maxima are as close to float64 as cuBLAS's fp32 ones
(ops/similarity.py::similarity_tf32x3 writes its arithmetic out).  Under
`sim_dtype="bfloat16"` the features are rounded to bf16 first
(ops/similarity.py::operands): the kernels read bf16 copies, the float64
re-pick of near-ties takes the rounded values, and the backward rounds
the fp32 sum of a logit's two routed coefficients to bf16 (the TPU
kernel's `(d1 + d2).astype(dot_dtype)`).  Kernel limits: T, V <= 64, D %
16 == 0.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from . import similarity as S

MAX_TOKENS = 64
# A diagnostic's hook into the routing of both backwards: called as
# routing_hook(i1, i2, videos, B) with the winners the backward is about to
# route by, i1 [A, n, T] (over v, per text token) and i2 [A, n, V] (over t,
# per video token) for the `videos` slice of n of the B videos (all of
# them: slice(0, B)).  The plain version uses what the hook returns (None:
# its own); the kernel's is only shown.
# A kernel run and a plain run take these winners on features that differ
# by the towers' bf16 rounding, and near-ties then route to other tokens:
# handing the plain run the kernel run's winners separates that from a
# fault (scripts/torch_step_gap.py --long, chip_smoke.py's trainer phase).
routing_hook = None
_LIB = "interaction_similarity_blocked"
_FWD_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _video_chunk(tn, vn, max_logits_bytes: int) -> int:
    """Videos per chunk so that [A, T, chunk, V] fp32 stays under the cap."""
    A, T, _ = tn.shape
    return max(1, max_logits_bytes // (A * T * vn.shape[1] * 4))


def similarity_blocked_plain(tn, vn, tw, vw,
                             max_logits_bytes: int = 2 ** 28) -> torch.Tensor:
    """S [A, B] from prepared inputs (ops/similarity.py::_prepare), plain,
    in video-side chunks."""
    c = _video_chunk(tn, vn, max_logits_bytes)
    return torch.cat([S._similarity_plain(tn, vn[s:s + c], tw, vw[s:s + c])
                      for s in range(0, vn.shape[0], c)], dim=1)


def similarity_blocked_routing_plain(tn, vn, tw, vw,
                                     max_logits_bytes: int = 2 ** 28):
    """S [A, B] and its routing (m1, i1 [A, B, T]; m2, i2 [A, B, V]; see
    ops/similarity.py::similarity_routing_plain), plain, in video-side
    chunks: a video's logits are whole inside its chunk, so no max crosses
    chunks."""
    c = _video_chunk(tn, vn, max_logits_bytes)
    parts = [S.similarity_routing_plain(tn, vn[s:s + c], tw, vw[s:s + c])
             for s in range(0, vn.shape[0], c)]
    return (torch.cat([p[0] for p in parts], dim=1),
            tuple(torch.cat([p[1][k] for p in parts], dim=1)
                  for k in range(4)))


def similarity_blocked_bwd_routed_plain(tn, vn, tw, vw, g, m1, i1, m2, i2,
                                        need_t: bool = True,
                                        need_v: bool = True,
                                        max_logits_bytes: int = 2 ** 28,
                                        rounding: str = "none"):
    """Backward of `similarity_blocked_plain` for the cotangent g [A, B] from
    the forward's routing, written out, in the same chunks: (dtn or None,
    dvn or None, dtw, dvw).  `rounding` as in
    `similarity.similarity_bwd_routed_plain` (sim_dtype="bfloat16": "sum",
    each logit's routed coefficients summed, then rounded to bf16)."""
    c = _video_chunk(tn, vn, max_logits_bytes)
    dtn = torch.zeros_like(tn) if need_t else None
    dtw = torch.zeros_like(tw)
    dvn, dvw = [], []
    for s in range(0, vn.shape[0], c):
        cols = slice(s, s + c)
        a, b, d, e = S.similarity_bwd_routed_plain(
            tn, vn[cols], tw, vw[cols], g[:, cols], m1[:, cols], i1[:, cols],
            m2[:, cols], i2[:, cols], need_t, need_v, rounding)
        if need_t:
            dtn += a
        dtw += d
        dvn.append(b)
        dvw.append(e)
    return dtn, torch.cat(dvn) if need_v else None, dtw, torch.cat(dvw)


def similarity_blocked_bwd_plain(tn, vn, tw, vw, g,
                                 max_logits_bytes: int = 2 ** 28):
    """The backward with the routing recomputed: (dtn, dvn, dtw, dvw)."""
    _, res = similarity_blocked_routing_plain(tn, vn, tw, vw,
                                              max_logits_bytes)
    return similarity_blocked_bwd_routed_plain(tn, vn, tw, vw, g, *res,
                                               max_logits_bytes=
                                               max_logits_bytes)


def _check_kernel_inputs(tn, vn, tw, vw) -> None:
    """The kernels' limits on prepared fp32 inputs."""
    A, T, D = tn.shape
    B, V, _ = vn.shape
    if T > MAX_TOKENS or V > MAX_TOKENS or D % 16:
        raise ValueError(
            f"blocked similarity kernel takes T, V <= {MAX_TOKENS} and "
            f"D % 16 == 0; got T={T}, V={V}, D={D}")
    for name, t, shape in (("t_feat", tn, (A, T, D)), ("v_feat", vn, (B, V, D)),
                           ("t_weight", tw, (A, T)), ("v_weight", vw, (B, V))):
        S._check_cuda(name, t, torch.float32, shape)
    if tn.device != vn.device:
        raise ValueError("text and video features are on different devices")


def _blocked_fwd(tn, vn, tw, vw, save: bool):
    """The forward kernel on prepared CUDA inputs (fp32 features, or their
    bf16 `operands`: the bf16 form) → (S, residuals): the routing
    (ops/similarity.py::residual_buffers) if `save`, else ().  The kernel
    flags the indices of maxima with a near-tie; they are re-picked in
    float64 of the features it read here (`S.resolve_near_ties`), so the
    routing is float64's first argmax."""
    A, T, D = tn.shape
    B, V, _ = vn.shape
    dev = tn.device
    out = torch.empty((A, B), dtype=torch.float32, device=dev)
    res = S.residual_buffers(A, T, B, V, dev) if save else ()
    canon = ((S.canonical_tokens(tn.float()), S.canonical_tokens(vn.float()))
             if save else (None, None))
    lib, name = S.entry(_LIB, "interaction_similarity_blocked_fwd", tn)
    fn = _build.function(lib, name, _FWD_ARGTYPES)
    P = _build.ptr
    with torch.cuda.device(dev):
        err = fn(P(tn), P(vn), P(tw), P(vw), P(out),
                 *(map(P, res + canon) if save else [None] * 6),
                 A, B, T, V, D, _build.stream())
    _build.check(err, name)
    S.count_launch(fused_interaction_similarity_blocked, tn)
    if save:
        S.resolve_near_ties(tn, vn, *res)
    return out, res


def fused_blocked_similarity_bwd(tn, vn, tw, vw, g, m1, i1, m2, i2,
                                 need_t: bool = True, need_v: bool = True):
    """The backward kernel on prepared CUDA inputs (bf16 features: the
    bf16 form), g [A, B] and the forward's residuals: (dtn or None, dvn or
    None, dtw, dvw), fp32, every sum in a fixed order; a side not asked for
    launches nothing."""
    out = S.routed_bwd_call(_LIB, "interaction_similarity_blocked_bwd", tn,
                            vn, tw, vw, g, (m1, i1, m2, i2), need_t, need_v)
    S.count_launch(fused_blocked_similarity_bwd, tn)
    return out


fused_blocked_similarity_bwd.launches = 0
fused_blocked_similarity_bwd.launches_bf16 = 0


class _BlockedSimilarity(torch.autograd.Function):
    """S [A, B] on prepared inputs, the routing saved; the first-index
    backward from it, kernels or plain, for the features autograd asks
    for."""

    @staticmethod
    def forward(ctx, tn, vn, tw, vw, kernels, sim_dtype):
        ctx.kernels, ctx.bf16 = kernels, sim_dtype != "float32"
        tn, vn = S.operands(tn, vn, sim_dtype, kernels)
        if kernels:
            out, res = _blocked_fwd(tn, vn, tw, vw, save=True)
        else:
            out, res = similarity_blocked_routing_plain(tn, vn, tw, vw)
        ctx.save_for_backward(tn, vn, tw, vw, *res)
        return out

    @staticmethod
    def backward(ctx, g):
        tn, vn, tw, vw, m1, i1, m2, i2 = ctx.saved_tensors
        T, B, V = tn.shape[1], vn.shape[0], vn.shape[1]
        if routing_hook is not None:
            got = routing_hook(i1[..., :T], i2[..., :V], slice(0, B), B)
            if got is not None and not ctx.kernels:
                i1, i2 = (x.to(torch.uint8) for x in got)
        need_t, need_v = ctx.needs_input_grad[:2]
        if ctx.kernels:
            grads = fused_blocked_similarity_bwd(
                tn, vn, tw, vw, g, m1, i1, m2, i2, need_t=need_t,
                need_v=need_v)
        else:
            grads = similarity_blocked_bwd_routed_plain(
                tn, vn, tw, vw, g, m1, i1, m2, i2, need_t=need_t,
                need_v=need_v, rounding="sum" if ctx.bf16 else "none")
        return (*grads, None, None)


def fused_interaction_similarity_blocked(t_feat, v_feat, t_mask, v_mask,
                                         t_weight, v_weight,
                                         kernels: bool = True,
                                         sim_dtype: str = "float32",
                                         corpus: Optional[
                                             S.PreparedCorpus] = None
                                         ) -> torch.Tensor:
    """Similarity [A, B] in fp32 at long-token shapes, differentiable in
    features and weights, the products in `sim_dtype` (ops/similarity.py).
    CUDA tensors launch the kernels (or raise); CPU tensors, and any tensor
    under `kernels=False`, take the plain chunked version with the
    written-out backward.  `corpus`: the video side prepared once
    (`S.PreparedCorpus`) in place of v_feat, v_mask and v_weight."""
    S.check_sim_dtype(sim_dtype)
    kernels = kernels and t_feat.is_cuda
    tn, vn, tw, vw = S._prepare(t_feat, v_feat, t_mask, v_mask, t_weight,
                                v_weight, False, corpus)
    if kernels:
        _check_kernel_inputs(tn, vn, tw, vw)
    if S._wants_grad(tn, vn, tw, vw):
        return _BlockedSimilarity.apply(tn, vn, tw, vw, kernels, sim_dtype)
    tn, vn = S.operands(tn, vn, sim_dtype, kernels)
    if kernels:
        return _blocked_fwd(tn, vn, tw, vw, save=False)[0]
    return similarity_blocked_plain(tn, vn, tw, vw)


fused_interaction_similarity_blocked.launches = 0
fused_interaction_similarity_blocked.launches_bf16 = 0
