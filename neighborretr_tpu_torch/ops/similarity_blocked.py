"""Token-interaction similarity at long-token shapes, T·V >= 2048: the
64-word / 64-frame recipes (↔ neighborretr_tpu/ops/pallas_similarity_blocked.py
::pallas_interaction_similarity_blocked).

The function is ops/similarity.py's; what differs is the size.  At T = V =
64 against a memory bank of 1,920 rows the [A, T, B, V] logits are 4 GB, so
neither version here builds them whole:

- `fused_interaction_similarity_blocked` is the kernels' wrapper.  A CUDA
  tensor runs csrc/interaction_similarity_blocked.cu: the forward tiles the
  logits in shared memory and writes S [A, B]; under autograd it also saves
  the max over video tokens and its FIRST index per (caption, video, token)
  (m1 fp32, i1 one byte), and the backward kernel routes the text→video side
  by that saved index, recomputes the logits once for the video→text side,
  and gathers both feature gradients in a fixed order (two runs give the
  same bits).  A CPU tensor, or `kernels=False` on any device, takes
- the plain PyTorch version: `similarity_blocked_plain` and
  `similarity_blocked_bwd_plain`, the forward and the written-out backward
  of ops/similarity.py in video-side chunks that bound the logits.  The
  backward routes each max to the first index that attains it; ties are the
  normal case (masked tokens are zero rows), and autograd of `amax` would
  split them.

As in the TPU wrapper, the masks and the L2 normalisation sit outside the
kernels and get their gradients from autograd.  fp32 end to end, no TF32.
Kernel limits: T, V <= 64, D % 16 == 0.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from . import similarity as S

MAX_TOKENS = 64
# A diagnostic's hook into the routing of both backwards: called as
# routing_hook(i1, i2, videos, B) with the winners the backward is about to
# route by, i1 [A, n, T] (over v, per text token) and i2 [A, n, V] (over t,
# per video token) for the `videos` slice of n of the B videos.  The plain
# version uses what the hook returns (None: its own); the kernel's is only
# shown.
# A kernel run and a plain run take these winners on features that differ
# by the towers' bf16 rounding, and near-ties then route to other tokens:
# handing the plain run the kernel run's winners separates that from a
# fault (scripts/torch_step_gap.py --long, chip_smoke.py's trainer phase).
routing_hook = None
_LIB = "interaction_similarity_blocked"
_FWD_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


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


def similarity_blocked_bwd_plain(tn, vn, tw, vw, g,
                                 max_logits_bytes: int = 2 ** 28):
    """Backward of `similarity_blocked_plain` for the cotangent g [A, B],
    written out with first-index routing, in the same chunks: a video's
    logits are whole inside its chunk, so no max crosses chunks.  Returns
    (dtn, dvn, dtw, dvw)."""
    c = _video_chunk(tn, vn, max_logits_bytes)
    dtn, dtw = torch.zeros_like(tn), torch.zeros_like(tw)
    dvn, dvw = [], []
    for s in range(0, vn.shape[0], c):
        route = None
        if routing_hook is not None:
            def route(i1, i2, videos=slice(s, s + c)):
                # [A, T, n, 1] / [A, 1, n, V] ↔ the hook's [A, n, T] / [A, n, V]
                got = routing_hook(i1[..., 0].transpose(1, 2), i2[:, 0],
                                   videos, vn.shape[0])
                if got is None:
                    return i1, i2
                return (got[0].long().transpose(1, 2)[..., None].contiguous(),
                        got[1].long()[:, None].contiguous())
        a, b, d, e = S.similarity_bwd_plain(tn, vn[s:s + c], tw, vw[s:s + c],
                                            g[:, s:s + c], route)
        dtn += a
        dtw += d
        dvn.append(b)
        dvw.append(e)
    return dtn, torch.cat(dvn), dtw, torch.cat(dvw)


def _check_kernel_inputs(tn, vn, tw, vw) -> None:
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
    """The forward kernel on prepared CUDA inputs → (S, m1, i1); the
    residuals m1, i1 [A, B, T] are None unless `save`."""
    A, T, D = tn.shape
    B, V, _ = vn.shape
    dev = tn.device
    out = torch.empty((A, B), dtype=torch.float32, device=dev)
    m1 = i1 = None
    if save:
        m1 = torch.empty((A, B, T), dtype=torch.float32, device=dev)
        i1 = torch.empty((A, B, T), dtype=torch.uint8, device=dev)
    fn = _build.function(_LIB, "interaction_similarity_blocked_fwd",
                         _FWD_ARGTYPES)
    P = _build.ptr
    with torch.cuda.device(dev):
        err = fn(P(tn), P(vn), P(tw), P(vw), P(out),
                 P(m1) if save else None, P(i1) if save else None,
                 A, B, T, V, D, _build.stream())
    _build.check(err, "interaction_similarity_blocked_fwd")
    fused_interaction_similarity_blocked.launches += 1
    return out, m1, i1


def fused_blocked_similarity_bwd(tn, vn, tw, vw, g, m1, i1):
    """The backward kernel on prepared CUDA inputs, g [A, B] and the
    forward's residuals: (dtn, dvn, dtw, dvw), every sum in a fixed order."""
    A, T, D = tn.shape
    B, V, _ = vn.shape
    dev = tn.device
    g = g.float().contiguous()
    S._check_cuda("g", g, torch.float32, (A, B))
    S._check_cuda("m1", m1, torch.float32, (A, B, T))
    S._check_cuda("i1", i1, torch.uint8, (A, B, T))
    m2 = torch.empty((A, B, V), dtype=torch.float32, device=dev)
    i2 = torch.empty((A, B, V), dtype=torch.uint8, device=dev)
    n_part = _build.function(_LIB, "interaction_similarity_blocked_bwd_scratch",
                             [ctypes.c_int] * 5)(A, B, T, V, D)
    part = torch.empty((max(n_part, 1),), dtype=torch.float32, device=dev)
    dtn, dvn = torch.empty_like(tn), torch.empty_like(vn)
    dtw, dvw = torch.empty_like(tw), torch.empty_like(vw)
    fn = _build.function(_LIB, "interaction_similarity_blocked_bwd",
                         _BWD_ARGTYPES)
    P = _build.ptr
    with torch.cuda.device(dev):
        err = fn(P(tn), P(vn), P(tw), P(vw), P(g), P(m1), P(i1), P(m2), P(i2),
                 P(part), P(dtn), P(dtw), P(dvn), P(dvw), A, B, T, V, D,
                 _build.stream())
    _build.check(err, "interaction_similarity_blocked_bwd")
    fused_blocked_similarity_bwd.launches += 1
    if routing_hook is not None:
        routing_hook(i1, i2, slice(0, B), B)
    return dtn, dvn, dtw, dvw


fused_blocked_similarity_bwd.launches = 0


class _BlockedSimilarity(torch.autograd.Function):
    """S [A, B] on prepared inputs with the first-index backward, kernels
    or plain."""

    @staticmethod
    def forward(ctx, tn, vn, tw, vw, kernels):
        ctx.kernels = kernels
        if kernels:
            out, m1, i1 = _blocked_fwd(tn, vn, tw, vw, save=True)
            ctx.save_for_backward(tn, vn, tw, vw, m1, i1)
            return out
        ctx.save_for_backward(tn, vn, tw, vw)
        return similarity_blocked_plain(tn, vn, tw, vw)

    @staticmethod
    def backward(ctx, g):
        bwd = (fused_blocked_similarity_bwd if ctx.kernels
               else similarity_blocked_bwd_plain)
        tn, vn, tw, vw, *res = ctx.saved_tensors
        return (*bwd(tn, vn, tw, vw, g, *res), None)


def fused_interaction_similarity_blocked(t_feat, v_feat, t_mask, v_mask,
                                         t_weight, v_weight,
                                         kernels: bool = True) -> torch.Tensor:
    """Similarity [A, B] in fp32 at long-token shapes, differentiable in
    features and weights.  CUDA tensors launch the kernels (or raise); CPU
    tensors, and any tensor under `kernels=False`, take the plain chunked
    version with the written-out backward."""
    kernels = kernels and t_feat.is_cuda
    tn, vn, tw, vw = S._prepare(t_feat, v_feat, t_mask, v_mask, t_weight,
                                v_weight, False)
    if kernels:
        _check_kernel_inputs(tn, vn, tw, vw)
    if torch.is_grad_enabled() and any(x.requires_grad
                                       for x in (tn, vn, tw, vw)):
        return _BlockedSimilarity.apply(tn, vn, tw, vw, kernels)
    if kernels:
        return _blocked_fwd(tn, vn, tw, vw, save=False)[0]
    return similarity_blocked_plain(tn, vn, tw, vw)


fused_interaction_similarity_blocked.launches = 0
