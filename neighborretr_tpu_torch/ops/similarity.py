"""Token-interaction similarity (↔ neighborretr_tpu/ops/similarity.py and
ops/pallas_similarity.py::pallas_interaction_similarity).

    S[a,b] = 0.5 * ( Σ_t  max_v <t̂_a,t , v̂_b,v> · tw[a,t]
                   + Σ_v  max_t <t̂_a,t , v̂_b,v> · vw[b,v] )

with L2-normalised tokens and masked token logits ZEROED by multiplication
(not -inf) before the max — the reference's local_level semantics.

`interaction_similarity` is the plain PyTorch version (one [A·T, B·V]
matmul, then both reductions).  `fused_interaction_similarity` is the
kernel's wrapper: a CPU tensor takes the plain version; a CUDA tensor runs
csrc/interaction_similarity.cu, which never materialises the
[A, T, B, V] logits.  `fused_interaction_mean` (↔ pallas_interaction_mean)
is the same for the mean of S over one axis, the memory-bank centrality,
without S.  Both are differentiable: the mask and the L2 normalisation sit
outside the kernels and get their gradients from autograd, and the kernels'
backward (↔ _similarity_bwd) recomputes the logits and sends each max's
gradient to the FIRST index that attains it.  `similarity_bwd_plain` is that
backward written out, first-index routing included: ties are the normal
case (masked tokens are zero rows), and `torch.max` on CUDA does not promise
the first index, so autograd of the plain forward is no reference there.

`global_similarity` (↔ ops/similarity.py::global_similarity) is the
unmasked, unnormalised form over the merged global tokens.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """torch.nn.functional.normalize semantics (norm clamped below by eps)."""
    n = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    return x / torch.clamp(n, min=eps)


def interaction_similarity(t_feat, v_feat, t_mask, v_mask, t_weight,
                           v_weight) -> torch.Tensor:
    """Plain version: t_feat [A, T, D], v_feat [B, V, D], masks and softmax
    token weights [A, T] / [B, V] → fp32 [A, B]."""
    A, T, D = t_feat.shape
    B, V, _ = v_feat.shape
    tn = l2_normalize(t_feat.float())
    vn = l2_normalize(v_feat.float())
    logits = (tn.reshape(A * T, D) @ vn.reshape(B * V, D).T).reshape(A, T, B, V)
    logits = logits * t_mask.float()[:, :, None, None]
    logits = logits * v_mask.float()[None, None, :, :]
    sim_t = torch.einsum("atb,at->ab", logits.amax(dim=3), t_weight.float())
    sim_v = torch.einsum("abv,bv->ab", logits.amax(dim=1), v_weight.float())
    return 0.5 * (sim_t + sim_v)


def interaction_similarity_chunked(t_feat, v_feat, t_mask, v_mask, t_weight,
                                   v_weight, chunk: int = 128) -> torch.Tensor:
    """Plain version in video-side chunks, bounding the [A, T, chunk, V]
    logits (the long-token shapes, T·V ≥ 2048)."""
    cols = [interaction_similarity(t_feat, v_feat[s:s + chunk], t_mask,
                                   v_mask[s:s + chunk], t_weight,
                                   v_weight[s:s + chunk])
            for s in range(0, v_feat.shape[0], chunk)]
    return torch.cat(cols, dim=1)


def interaction_mean(t_feat, v_feat, t_mask, v_mask, t_weight, v_weight,
                     axis: int = 1) -> torch.Tensor:
    """Plain version of the bank centrality: mean of S over `axis` (1 → [A]
    row means, 0 → [B] column means)."""
    return interaction_similarity(t_feat, v_feat, t_mask, v_mask, t_weight,
                                  v_weight).mean(dim=axis)


def global_similarity(t_global, v_global, t_weight=None,
                      v_weight=None) -> torch.Tensor:
    """Similarity [A, B] over merged tokens [A, T1, D] / [B, V1, D]: no mask,
    no normalisation.  Single tokens reduce to a plain dot; otherwise the
    softmax token weights [A, T1] / [B, V1] are required."""
    A, T1, D = t_global.shape
    B, V1, _ = v_global.shape
    if T1 == 1 and V1 == 1:
        return t_global[:, 0].float() @ v_global[:, 0].float().T
    logits = (t_global.float().reshape(A * T1, D)
              @ v_global.float().reshape(B * V1, D).T).reshape(A, T1, B, V1)
    sim_t = torch.einsum("atb,at->ab", logits.amax(dim=3), t_weight.float())
    sim_v = torch.einsum("abv,bv->ab", logits.amax(dim=1), v_weight.float())
    return 0.5 * (sim_t + sim_v)


def _first_argmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The least index along `dim` that attains the max (kept dim)."""
    n = x.shape[dim]
    shape = [1] * x.ndim
    shape[dim] = n
    pos = torch.arange(n, device=x.device).reshape(shape)
    hit = x == x.amax(dim=dim, keepdim=True)
    return torch.where(hit, pos, n).amin(dim=dim, keepdim=True)


def similarity_bwd_plain(tn, vn, tw, vw, g):
    """Backward of S = kernel(tn, vn, tw, vw) for the cotangent g [A, B],
    written out: tn [A, T, D] and vn [B, V, D] are the normalised, masked
    features the kernels take.  Returns (dtn, dvn, dtw, dvw).  Each max
    routes to the first index that attains it."""
    A, T, D = tn.shape
    B, V, _ = vn.shape
    logits = (tn.reshape(A * T, D) @ vn.reshape(B * V, D).T).reshape(A, T, B, V)
    half_g = 0.5 * g.float()
    m1 = logits.amax(dim=3)                                   # [A, T, B]
    m2 = logits.amax(dim=1)                                   # [A, B, V]
    dtw = torch.einsum("ab,atb->at", half_g, m1)
    dvw = torch.einsum("ab,abv->bv", half_g, m2)
    c1 = half_g[:, None, :] * tw[:, :, None]                  # [A, T, B]
    c2 = half_g[:, :, None] * vw[None, :, :]                  # [A, B, V]
    dlogits = torch.zeros_like(logits)
    dlogits.scatter_(3, _first_argmax(logits, 3), c1[..., None])
    dlogits.scatter_add_(1, _first_argmax(logits, 1), c2[:, None])
    dl = dlogits.reshape(A * T, B * V)
    dtn = (dl @ vn.reshape(B * V, D)).reshape(A, T, D)
    dvn = (dl.T @ tn.reshape(A * T, D)).reshape(B, V, D)
    return dtn, dvn, dtw, dvw


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_MEAN_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_LIB = "interaction_similarity"


def _normalize_masked(x, mask, eps: float = 1e-12) -> torch.Tensor:
    """l2_normalize(x) * mask[..., None] in two passes over x (a norm, then
    one scaling): the video side is the whole corpus on every request."""
    x = x.float()
    scale = mask.float() / torch.linalg.vector_norm(x, dim=-1).clamp_min(eps)
    return (x * scale[..., None]).contiguous()


def _check_cuda(name, t, dtype, shape):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor like the others")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _prepare(t_feat, v_feat, t_mask, v_mask, t_weight, v_weight,
             kernels: bool):
    """What the kernels take: masks folded into the normalised fp32
    features and fp32 weights, contiguous (differentiable).  For a kernel
    launch also: one CUDA device, T <= 64, V <= 16, D % 32 == 0."""
    tn = _normalize_masked(t_feat, t_mask)
    vn = _normalize_masked(v_feat, v_mask)
    tw = t_weight.float().contiguous()
    vw = v_weight.float().contiguous()
    if not kernels:
        return tn, vn, tw, vw
    A, T, D = t_feat.shape
    B, V, _ = v_feat.shape
    if T > 64 or V > 16 or D % 32:
        raise ValueError(
            f"similarity kernel takes T <= 64, V <= 16 and D % 32 == 0; got "
            f"T={T}, V={V}, D={D}")
    for name, t, shape in (("t_feat", tn, (A, T, D)), ("v_feat", vn, (B, V, D)),
                           ("t_weight", tw, (A, T)), ("v_weight", vw, (B, V))):
        _check_cuda(name, t, torch.float32, shape)
    if tn.device != vn.device:
        raise ValueError("text and video features are on different devices")
    return tn, vn, tw, vw


def _similarity_plain(tn, vn, tw, vw) -> torch.Tensor:
    """S [A, B] from prepared inputs, plain."""
    A, T, D = tn.shape
    B, V, _ = vn.shape
    logits = (tn.reshape(A * T, D) @ vn.reshape(B * V, D).T).reshape(A, T, B, V)
    return 0.5 * (torch.einsum("atb,at->ab", logits.amax(dim=3), tw)
                  + torch.einsum("abv,bv->ab", logits.amax(dim=1), vw))


def _similarity_fwd(tn, vn, tw, vw) -> torch.Tensor:
    A, T, D = tn.shape
    B, V, _ = vn.shape
    out = torch.empty((A, B), dtype=torch.float32, device=tn.device)
    fn = _build.function(_LIB, "interaction_similarity_fwd", _ARGTYPES)
    with torch.cuda.device(tn.device):
        err = fn(_build.ptr(tn), _build.ptr(vn), _build.ptr(tw), _build.ptr(vw),
                 _build.ptr(out), A, B, T, V, D, _build.stream())
    _build.check(err, "interaction_similarity_fwd")
    fused_interaction_similarity.launches += 1
    return out


def _mean_fwd(tn, vn, tw, vw, axis: int) -> torch.Tensor:
    A, T, D = tn.shape
    B, V, _ = vn.shape
    rows = _build.function(_LIB, "interaction_mean_partial_rows",
                           [ctypes.c_int] * 4)(A, B, T, axis)
    n_out = A if axis == 1 else B
    part = torch.empty((rows, n_out), dtype=torch.float32, device=tn.device)
    out = torch.empty((n_out,), dtype=torch.float32, device=tn.device)
    fn = _build.function(_LIB, "interaction_mean_fwd", _MEAN_ARGTYPES)
    with torch.cuda.device(tn.device):
        err = fn(_build.ptr(tn), _build.ptr(vn), _build.ptr(tw), _build.ptr(vw),
                 _build.ptr(part), _build.ptr(out), A, B, T, V, D, axis,
                 _build.stream())
    _build.check(err, "interaction_mean_fwd")
    fused_interaction_mean.launches += 1
    return out


def fused_similarity_bwd(tn, vn, tw, vw, g):
    """The backward kernel on prepared inputs (see `_prepare`) and g [A, B]:
    (dtn, dvn, dtw, dvw), every sum in a fixed order, so two calls give the
    same bits.  A CPU tensor takes `similarity_bwd_plain`."""
    if not tn.is_cuda:
        return similarity_bwd_plain(tn, vn, tw, vw, g)
    A, T, D = tn.shape
    B, V, _ = vn.shape
    g = g.float().contiguous()
    _check_cuda("g", g, torch.float32, (A, B))
    dev = tn.device
    m1 = torch.empty((A, T, B), dtype=torch.float32, device=dev)
    m2 = torch.empty((A, B, V), dtype=torch.float32, device=dev)
    i1 = torch.empty((A, T, B), dtype=torch.uint8, device=dev)
    i2 = torch.empty((A, B, V), dtype=torch.uint8, device=dev)
    # partial sums of the gather kernels where a short side is walked in
    # several ranges
    n_part = _build.function(_LIB, "interaction_similarity_bwd_scratch",
                             [ctypes.c_int] * 5)(A, B, T, V, D)
    part = torch.empty((max(n_part, 1),), dtype=torch.float32, device=dev)
    dtn, dvn = torch.empty_like(tn), torch.empty_like(vn)
    dtw, dvw = torch.empty_like(tw), torch.empty_like(vw)
    fn = _build.function(_LIB, "interaction_similarity_bwd", _BWD_ARGTYPES)
    P = _build.ptr
    with torch.cuda.device(dev):
        err = fn(P(tn), P(vn), P(tw), P(vw), P(g), P(m1), P(m2), P(i1), P(i2),
                 P(part), P(dtn), P(dtw), P(dvn), P(dvw), A, B, T, V, D,
                 _build.stream())
    _build.check(err, "interaction_similarity_bwd")
    fused_similarity_bwd.launches += 1
    return dtn, dvn, dtw, dvw


fused_similarity_bwd.launches = 0


class _Similarity(torch.autograd.Function):
    """S [A, B] (axis None) or its mean over `axis`, on prepared inputs;
    the backward expands a mean's cotangent to its rank-1 [A, B] form and
    runs the one backward, kernel or plain."""

    @staticmethod
    def forward(ctx, tn, vn, tw, vw, axis, kernels):
        ctx.save_for_backward(tn, vn, tw, vw)
        ctx.axis, ctx.kernels = axis, kernels
        if not kernels:
            sim = _similarity_plain(tn, vn, tw, vw)
            return sim if axis is None else sim.mean(dim=axis)
        if axis is None:
            return _similarity_fwd(tn, vn, tw, vw)
        return _mean_fwd(tn, vn, tw, vw, axis)

    @staticmethod
    def backward(ctx, g):
        tn, vn, tw, vw = ctx.saved_tensors
        A, B = tn.shape[0], vn.shape[0]
        if ctx.axis == 1:
            g = (g.float() / B)[:, None].expand(A, B)
        elif ctx.axis == 0:
            g = (g.float() / A)[None, :].expand(A, B)
        bwd = fused_similarity_bwd if ctx.kernels else similarity_bwd_plain
        return (*bwd(tn, vn, tw, vw, g), None, None)


def fused_interaction_similarity(t_feat, v_feat, t_mask, v_mask, t_weight,
                                 v_weight, kernels: bool = True) -> torch.Tensor:
    """Similarity [A, B] in fp32, differentiable in features and weights.
    CPU tensors take the plain version; CUDA tensors launch the kernel (fp32
    end to end, no TF32) after the masks are folded into the normalised
    features, as the TPU wrapper does, with the backward kernel behind it.
    Kernel limits: T <= 64, V <= 16, D % 32 == 0.  `kernels=False` is the
    reference the backward kernel is held to, on any device: the plain
    forward on the same prepared inputs with the written-out first-index
    backward."""
    if kernels and not t_feat.is_cuda:
        return interaction_similarity(t_feat, v_feat, t_mask, v_mask,
                                      t_weight, v_weight)
    return _Similarity.apply(*_prepare(t_feat, v_feat, t_mask, v_mask,
                                       t_weight, v_weight, kernels),
                             None, kernels)


fused_interaction_similarity.launches = 0


def fused_interaction_mean(t_feat, v_feat, t_mask, v_mask, t_weight, v_weight,
                           axis: int = 1, sim_dtype: str = "float32",
                           kernels: bool = True) -> torch.Tensor:
    """Mean of the similarity matrix over `axis` without the matrix: axis 1
    → [A] row means, axis 0 → [B] column means; differentiable, the gradient
    routed through the first index of each max.  CPU tensors, and any
    tensor under `kernels=False`, take the plain version (which does build
    the matrix) with the written-out plain backward.  The kernel is fp32
    only (`sim_dtype="bfloat16"` raises on CUDA) and has the similarity
    kernel's limits: T <= 64, V <= 16, D % 32 == 0."""
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    kernels = kernels and t_feat.is_cuda
    if kernels and sim_dtype != "float32":
        raise ValueError(f"the bank-centrality kernel computes in float32; "
                         f"sim_dtype='{sim_dtype}' has no CUDA kernel yet")
    return _Similarity.apply(*_prepare(t_feat, v_feat, t_mask, v_mask,
                                       t_weight, v_weight, kernels),
                             axis, kernels)


fused_interaction_mean.launches = 0
