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
[A, T, B, V] logits.
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


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


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


def fused_interaction_similarity(t_feat, v_feat, t_mask, v_mask, t_weight,
                                 v_weight) -> torch.Tensor:
    """Similarity [A, B] in fp32.  CPU tensors take the plain version; CUDA
    tensors launch the kernel (fp32 end to end, no TF32) after the masks are
    folded into the normalised features, as the TPU wrapper does."""
    if not t_feat.is_cuda:
        return interaction_similarity(t_feat, v_feat, t_mask, v_mask,
                                      t_weight, v_weight)
    A, T, D = t_feat.shape
    B, V, _ = v_feat.shape
    if T > 64 or V > 16 or D % 32:
        raise ValueError(
            f"similarity kernel takes T <= 64, V <= 16 and D % 32 == 0; got "
            f"T={T}, V={V}, D={D}")
    tn = _normalize_masked(t_feat, t_mask)
    vn = _normalize_masked(v_feat, v_mask)
    tw = t_weight.float().contiguous()
    vw = v_weight.float().contiguous()
    for name, t, shape in (("t_feat", tn, (A, T, D)), ("v_feat", vn, (B, V, D)),
                           ("t_weight", tw, (A, T)), ("v_weight", vw, (B, V))):
        _check_cuda(name, t, torch.float32, shape)
    if tn.device != vn.device:
        raise ValueError("text and video features are on different devices")
    out = torch.empty((A, B), dtype=torch.float32, device=tn.device)
    fn = _build.function("interaction_similarity",
                         "interaction_similarity_fwd", _ARGTYPES)
    with torch.cuda.device(tn.device):
        err = fn(_build.ptr(tn), _build.ptr(vn), _build.ptr(tw), _build.ptr(vw),
                 _build.ptr(out), A, B, T, V, D, _build.stream())
    _build.check(err, "interaction_similarity_fwd")
    fused_interaction_similarity.launches += 1
    return out


fused_interaction_similarity.launches = 0
