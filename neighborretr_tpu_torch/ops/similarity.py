"""Token-interaction similarity (↔ neighborretr_tpu/ops/similarity.py and
ops/pallas_similarity.py::pallas_interaction_similarity).

    S[a,b] = 0.5 * ( Σ_t  max_v <t̂_a,t , v̂_b,v> · tw[a,t]
                   + Σ_v  max_t <t̂_a,t , v̂_b,v> · vw[b,v] )

with L2-normalised tokens and masked token logits ZEROED by multiplication
(not -inf) before the max — the reference's local_level semantics.

`interaction_similarity` is the plain PyTorch version (one [A·T, B·V]
fp32 matmul, then both reductions).  `fused_interaction_similarity` is the
kernel's wrapper: a CPU tensor takes the plain version; a CUDA tensor runs
csrc/interaction_similarity.cu, which never materialises the
[A, T, B, V] logits and computes them on the TF32 tensor cores in a 3xTF32
split (hi·lo + lo·hi + hi·hi of each operand's two TF32 halves, a fresh
accumulator every 32 columns of D, the chunks summed in fp32): at D = 512
its maxima lie within 9e-8 of float64, cuBLAS's fp32 ones within 2.7e-7
(tools/similarity_probe.py on an H100).  `split_tf32` and
`similarity_tf32x3` write that arithmetic out for the tests; nothing else
calls them.
`fused_interaction_mean` (↔ pallas_interaction_mean) is the same for the
mean of S over one axis, the memory-bank centrality, without S.  Both are
differentiable: the mask and the L2 normalisation sit
outside the kernels and get their gradients from autograd.  Under autograd
the forward kernels also save the routing: per (caption, video) the max
over v of each caption token's logits and its FIRST index (m1, i1), and
the max over t of each video token's and its first index (m2, i2).  The
backward kernel (↔ _similarity_bwd) recomputes nothing: it sends each max's
gradient to its saved index, and computes only the feature gradients
autograd asks for (the memory bank's side is detached in the train step).
`similarity_routing_plain` and `similarity_bwd_routed_plain` are the two
halves written out, first-index routing included: ties are the normal case
(masked tokens are zero rows), and `torch.max` on CUDA does not promise the
first index, so autograd of the plain forward is no reference there.

`sim_dtype="bfloat16"` (the train step's `model.sim_dtype`, ↔ the TPU
kernels' `compute_dtype`) is the operand dtype of the products: the
normalised, masked features are rounded to bf16 (to nearest even) and
multiplied with fp32 sums, so S is the float64 S of the rounded operands
up to fp32 summation order.  The kernels read bf16 copies (one bf16 wgmma
a k-step: csrc/similarity_tile.cuh); the plain versions multiply the
rounded values in fp32.  The backward is taken with respect to the fp32
features (straight through the rounding, as the TPU kernel's custom VJP):
each routed coefficient 0.5·g·w is rounded to bf16 before it multiplies
the rounded partner feature, the two directions apart
(`similarity_bwd_routed_plain(rounding="each")`; the blocked form rounds a
logit's two coefficients' fp32 sum, `rounding="sum"`, as the TPU kernels
do), and dtw / dvw come from the fp32 maxima.

`global_similarity` (↔ ops/similarity.py::global_similarity) is the
unmasked, unnormalised form over the merged global tokens.

These kernels give a warpgroup 8 videos' V tokens as the N = 8·V columns
of its wgmma tiles and take V <= 16 (T <= 64, D % 32 == 0); the
long-token shapes (T·V >= 2048, up to 64 x 64) run the same tile
(csrc/similarity_tile.cuh) at other widths through
ops/similarity_blocked.py, and models/neighborretr.py::local_similarity
routes by shape.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import _build


SIM_DTYPES = ("float32", "bfloat16")


def check_sim_dtype(sim_dtype: str) -> None:
    if sim_dtype not in SIM_DTYPES:
        raise ValueError(f"sim_dtype must be one of {SIM_DTYPES}; got "
                         f"{sim_dtype!r}")


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest even, as JAX's astype), in fp32."""
    return x.to(torch.bfloat16).float()


def operands(tn, vn, sim_dtype: str, kernels: bool):
    """The features the products take: the prepared fp32 ones, or under
    bf16 their rounded values: bf16 tensors for a kernel launch, fp32 ones
    for the plain version."""
    if sim_dtype == "float32":
        return tn, vn
    if kernels:
        return (tn.to(torch.bfloat16).contiguous(),
                vn.to(torch.bfloat16).contiguous())
    return round_bf16(tn), round_bf16(vn)


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


def similarity_routing_plain(tn, vn, tw, vw):
    """S [A, B] of prepared inputs (see `_prepare`) and the routing the
    backward needs: m1 [A, B, T] (per caption token the max over the video's
    tokens), i1 [A, B, T] (its first index, uint8), m2 [A, B, V] and
    i2 [A, B, V] (per video token the max over the caption's tokens)."""
    A, T, D = tn.shape
    B, V, _ = vn.shape
    logits = (tn.reshape(A * T, D) @ vn.reshape(B * V, D).T).reshape(A, T, B, V)
    return _routing(logits, tw, vw)


def _routing(logits, tw, vw):
    """S and the routing (see `similarity_routing_plain`) of the logits
    [A, T, B, V]."""
    m1 = logits.amax(dim=3)                                   # [A, T, B]
    m2 = logits.amax(dim=1)                                   # [A, B, V]
    sim = 0.5 * (torch.einsum("atb,at->ab", m1, tw)
                 + torch.einsum("abv,bv->ab", m2, vw))
    i1 = _first_argmax(logits, 3)[..., 0].transpose(1, 2)     # [A, B, T]
    i2 = _first_argmax(logits, 1)[:, 0]                       # [A, B, V]
    return sim, (m1.transpose(1, 2).contiguous(),
                 i1.to(torch.uint8).contiguous(), m2,
                 i2.to(torch.uint8).contiguous())


TIE_FLAG = 0x80   # bit 7 of a saved index: its max has a near-tie


def canonical_tokens(x: torch.Tensor) -> torch.Tensor:
    """x [N, L, D] → [N, L] uint8: for each token the index of the first
    token of its row (caption or video) whose vector is identical, bit for
    bit (its own index when none is).  Identical vectors are found by two
    fixed random projections in one product (identical rows give identical
    results); distinct vectors with equal projections would need equal
    fp32 sums along two random directions."""
    N, L, D = x.shape
    gen = torch.Generator(device=x.device).manual_seed(0x5EED)
    proj = torch.randn(D, 2, generator=gen, device=x.device, dtype=x.dtype)
    h = (x.reshape(N * L, D) @ proj).reshape(N, L, 2)
    same = (h[:, :, None, :] == h[:, None, :, :]).all(-1)      # [N, L, L]
    return same.to(torch.uint8).argmax(dim=2).to(torch.uint8)


def resolve_near_ties(tn, vn, m1, i1, m2, i2) -> int:
    """Re-pick every saved index the forward kernel flagged (TIE_FLAG: its
    max had a runner-up within the kernel's TIE_GAP, csrc/
    similarity_tile.cuh) as the first argmax of the float64 logits of that
    max, and clear the flags, in place: i1 [A, B, >= T] routes each caption
    token's max over the video's tokens, i2 [A, B, >= V] each video token's
    over the caption's.  Returns the number of indices re-picked."""
    T, V = tn.shape[1], vn.shape[1]
    n = 0
    for idx, k in ((i1, T), (i2, V)):
        view = idx[..., :k]
        a, b, j = (view >= TIE_FLAG).nonzero(as_tuple=True)
        if a.numel() == 0:
            continue
        # caption a's token j against video b's tokens, or video b's token
        # j against caption a's, 1,024 maxima at a time
        own, rows, other, partners = ((tn, a, vn, b) if idx is i1
                                      else (vn, b, tn, a))
        for s in range(0, a.numel(), 1024):
            c = slice(s, s + 1024)
            logits = torch.einsum("nd,nkd->nk",
                                  own[rows[c], j[c]].double(),
                                  other[partners[c]].double())
            view[a[c], b[c], j[c]] = _first_argmax(logits, 1)[:, 0].to(
                torch.uint8)
        n += a.numel()
    return n


def split_tf32(x: torch.Tensor):
    """The kernel's split of fp32 x into two TF32 halves (hi, lo), both fp32
    tensors with the low 13 bits zero: hi = x rounded to 10 mantissa bits,
    to nearest with ties away from zero (PTX `cvt.rna.tf32.f32`), lo = x -
    hi rounded the same way, so |x - hi - lo| <= 2^-22 |x|.  Test-only:
    the emulation of csrc/similarity_tile.cuh's arithmetic (K2, K4, K6)."""

    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    x = x.float()
    hi = rna(x)
    return hi, rna(x - hi)


def similarity_tf32x3(tn, vn, tw, vw):
    """S and the routing, as `similarity_routing_plain` returns them, from
    logits formed as the kernel forms them: hi·lo + lo·hi + hi·hi of
    `split_tf32`'s halves (each product exact in fp32, the sums fp32; the
    kernel's tensor cores add in another order).  Test-only."""
    A, T, D = tn.shape
    B, V, _ = vn.shape
    (th, tl), (vh, vl) = split_tf32(tn), split_tf32(vn)

    def mm(t, v):
        return t.reshape(A * T, D) @ v.reshape(B * V, D).T

    logits = (mm(th, vl) + mm(tl, vh)) + mm(th, vh)
    return _routing(logits.reshape(A, T, B, V), tw.float(), vw.float())


def similarity_bwd_routed_plain(tn, vn, tw, vw, g, m1, i1, m2, i2,
                                need_t: bool = True, need_v: bool = True,
                                rounding: str = "none"):
    """Backward of S for the cotangent g [A, B] from the forward's routing
    (`similarity_routing_plain`'s, or the kernels' residuals, whose index
    rows are padded): each max's gradient goes to its saved index.  Returns
    (dtn or None, dvn or None, dtw, dvw): a feature gradient not asked for
    is not computed.  `rounding` (sim_dtype="bfloat16", tn / vn holding the
    rounded features): "each" rounds every routed coefficient to bf16 (the
    short kernels' backward), "sum" the fp32 sum of a logit's two (the
    blocked ones'); "none" multiplies them as they are."""
    A, T, D = tn.shape
    B, V, _ = vn.shape
    half_g = 0.5 * g.float()
    dtw = torch.einsum("ab,abt->at", half_g, m1)
    dvw = torch.einsum("ab,abv->bv", half_g, m2)
    if not (need_t or need_v):
        return None, None, dtw, dvw
    c1 = half_g[:, None, :] * tw[:, :, None]                  # [A, T, B]
    c2 = half_g[:, :, None] * vw[None, :, :]                  # [A, B, V]
    r1 = i1[..., :T].long().transpose(1, 2)[..., None]        # [A, T, B, 1]
    r2 = i2[..., :V].long()[:, None]                          # [A, 1, B, V]
    zeros = torch.zeros((A, T, B, V), dtype=tn.dtype, device=tn.device)
    if rounding == "each":
        parts = (round_bf16(zeros.scatter(3, r1, c1[..., None])),
                 round_bf16(zeros.scatter(1, r2, c2[:, None])))
    else:
        dlogits = zeros.scatter_(3, r1, c1[..., None])
        dlogits.scatter_add_(1, r2, c2[:, None])
        parts = (round_bf16(dlogits) if rounding == "sum" else dlogits,)
    dtn = dvn = None
    for d in parts:
        dl = d.reshape(A * T, B * V)
        if need_t:
            x = (dl @ vn.reshape(B * V, D)).reshape(A, T, D)
            dtn = x if dtn is None else dtn + x
        if need_v:
            x = (dl.T @ tn.reshape(A * T, D)).reshape(B, V, D)
            dvn = x if dvn is None else dvn + x
    return dtn, dvn, dtw, dvw


def similarity_bwd_plain(tn, vn, tw, vw, g):
    """Backward of S = kernel(tn, vn, tw, vw) for the cotangent g [A, B],
    routing recomputed: (dtn, dvn, dtw, dvw)."""
    _, res = similarity_routing_plain(tn, vn, tw, vw)
    return similarity_bwd_routed_plain(tn, vn, tw, vw, g, *res)


# bf16 forms: the entry's name with `_bf16` (bf16 features, same
# arguments), in the library of the same name with `_bf16`
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_MEAN_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_LIB = "interaction_similarity"
# which outputs a backward call asks for (csrc/similarity_gather.cuh)
_NEED_DTN, _NEED_DVN, _NEED_DTW, _NEED_DVW = 1, 2, 4, 8


def _pad16(n: int) -> int:
    return (n + 15) // 16 * 16


def residual_buffers(A, T, B, V, device):
    """Empty routing residuals as the kernels write them: m1 [A, B, T],
    i1 [A, B, pad16(T)], m2 [A, B, V], i2 [A, B, pad16(V)] (indices one byte,
    rows padded to 16 bytes so that a pair's routing is one aligned copy)."""
    return (torch.empty((A, B, T), dtype=torch.float32, device=device),
            torch.empty((A, B, _pad16(T)), dtype=torch.uint8, device=device),
            torch.empty((A, B, V), dtype=torch.float32, device=device),
            torch.empty((A, B, _pad16(V)), dtype=torch.uint8, device=device))


def entry(lib: str, name: str, features: torch.Tensor):
    """(library, C entry) of `name` for `features`: the bf16 form, of the
    `_bf16` library, for bf16 features."""
    if features.dtype == torch.bfloat16:
        return lib + "_bf16", name + "_bf16"
    return lib, name


def count_launch(wrapper, features: torch.Tensor) -> None:
    """One launch on `wrapper`'s counts: `.launches`, and `.launches_bf16`
    for the bf16 form."""
    wrapper.launches += 1
    if features.dtype == torch.bfloat16:
        wrapper.launches_bf16 += 1


def routed_bwd_call(lib, name, tn, vn, tw, vw, g, res, need_t, need_v):
    """One call of a library's backward entry from the residuals `res`
    (the bf16 entry for bf16 features): (dtn or None, dvn or None, dtw,
    dvw), fp32."""
    A, T, D = tn.shape
    B, V, _ = vn.shape
    g = g.float().contiguous()
    _check_cuda("g", g, torch.float32, (A, B))
    for n, t, dtype, shape in zip(("m1", "i1", "m2", "i2"), res,
                                  (torch.float32, torch.uint8) * 2,
                                  ((A, B, T), (A, B, _pad16(T)),
                                   (A, B, V), (A, B, _pad16(V)))):
        _check_cuda(n, t, dtype, shape)
    need = (_NEED_DTN * need_t | _NEED_DVN * need_v | _NEED_DTW | _NEED_DVW)
    n_part = _build.function(lib, f"{name}_scratch", [ctypes.c_int] * 6,
                             ctypes.c_longlong)(A, B, T, V, D, need)
    dev = tn.device
    part = torch.empty((max(n_part, 1),), dtype=torch.float32, device=dev)
    dtn = torch.empty(tn.shape, device=dev) if need_t else None
    dvn = torch.empty(vn.shape, device=dev) if need_v else None
    dtw, dvw = torch.empty_like(tw), torch.empty_like(vw)
    P = _build.ptr
    lib, name = entry(lib, name, tn)
    fn = _build.function(lib, name, _BWD_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(P(tn), P(vn), P(tw), P(vw), P(g), *map(P, res), P(part),
                 P(dtn) if need_t else None, P(dtw),
                 P(dvn) if need_v else None, P(dvw), A, B, T, V, D,
                 _build.stream())
    _build.check(err, name)
    return dtn, dvn, dtw, dvw


def gather_launches(lib: str = _LIB) -> int:
    """routed_gather_kernel launches library `lib` has made in this process,
    counted in its C code where each launch is made (the gathers of K5 in
    this library, of K7 in interaction_similarity_blocked)."""
    return _build.function(lib, f"{lib}_gather_launches", [],
                           ctypes.c_longlong)()


def _normalize_masked(x, mask, eps: float = 1e-12) -> torch.Tensor:
    """l2_normalize(x) * mask[..., None] in two passes over x (a norm, then
    one scaling).  A fixed corpus's video side is made once
    (`PreparedCorpus`), not on every request."""
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


class PreparedCorpus(NamedTuple):
    """A video side already in the form `_prepare` makes: `feat` [B, V, D]
    the normalised, masked fp32 features (`_normalize_masked`), `weight`
    [B, V] the fp32 softmax token weights.  A corpus fixed across calls
    (the Searcher's index) is prepared once
    (models/neighborretr.py::prepare_corpus) and passed as `corpus=` in
    place of v_feat, v_mask and v_weight, which are then not read."""
    feat: torch.Tensor
    weight: torch.Tensor


def _prepare(t_feat, v_feat, t_mask, v_mask, t_weight, v_weight,
             kernels: bool, corpus: Optional[PreparedCorpus] = None):
    """What the kernels take: masks folded into the normalised fp32
    features and fp32 weights, contiguous (differentiable); the video side
    taken as it is from `corpus` when given.  For a kernel launch also: one
    CUDA device, T <= 64, V <= 16, D % 32 == 0.  Under bf16 the features
    are rounded after this (`operands`)."""
    tn = _normalize_masked(t_feat, t_mask)
    if corpus is None:
        vn = _normalize_masked(v_feat, v_mask)
        vw = v_weight.float().contiguous()
    else:
        vn, vw = corpus
    tw = t_weight.float().contiguous()
    if not kernels:
        return tn, vn, tw, vw
    A, T, D = tn.shape
    B, V, _ = vn.shape
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


def _similarity_fwd(tn, vn, tw, vw, save: bool = False):
    """K2 on prepared CUDA inputs (fp32 features, or their bf16
    `operands`) → (S, residuals or ())."""
    A, T, D = tn.shape
    B, V, _ = vn.shape
    out = torch.empty((A, B), dtype=torch.float32, device=tn.device)
    res = residual_buffers(A, T, B, V, tn.device) if save else ()
    P = _build.ptr
    lib, name = entry(_LIB, "interaction_similarity_fwd", tn)
    fn = _build.function(lib, name, _ARGTYPES)
    with torch.cuda.device(tn.device):
        err = fn(P(tn), P(vn), P(tw), P(vw), P(out),
                 *(map(P, res) if save else [None] * 4), A, B, T, V, D,
                 _build.stream())
    _build.check(err, name)
    count_launch(fused_interaction_similarity, tn)
    return out, res


def _mean_fwd(tn, vn, tw, vw, axis: int, save: bool = False):
    """K4 on prepared CUDA inputs (fp32 features, or their bf16
    `operands`) → (mean of S over axis, residuals/())."""
    A, T, D = tn.shape
    B, V, _ = vn.shape
    rows = _build.function(_LIB, "interaction_mean_partial_rows",
                           [ctypes.c_int] * 4)(A, B, T, axis)
    n_out = A if axis == 1 else B
    part = torch.empty((rows, n_out), dtype=torch.float32, device=tn.device)
    out = torch.empty((n_out,), dtype=torch.float32, device=tn.device)
    res = residual_buffers(A, T, B, V, tn.device) if save else ()
    P = _build.ptr
    lib, name = entry(_LIB, "interaction_mean_fwd", tn)
    fn = _build.function(lib, name, _MEAN_ARGTYPES)
    with torch.cuda.device(tn.device):
        err = fn(P(tn), P(vn), P(tw), P(vw), P(part), P(out),
                 *(map(P, res) if save else [None] * 4), A, B, T, V, D, axis,
                 _build.stream())
    _build.check(err, name)
    count_launch(fused_interaction_mean, tn)
    return out, res


def fused_similarity_bwd(tn, vn, tw, vw, g, m1, i1, m2, i2,
                         need_t: bool = True, need_v: bool = True):
    """The backward kernel on prepared inputs (see `_prepare`; bf16
    features: the bf16 form, each routed coefficient rounded to bf16), g
    [A, B] and the forward kernel's residuals (`residual_buffers`): (dtn or
    None, dvn or None, dtw, dvw), fp32.  A side not asked for launches
    nothing; every sum is in a fixed order, so two calls give the same bits
    and a one-side call its side of the both-side call's.  A CPU tensor
    takes `similarity_bwd_routed_plain`."""
    if not tn.is_cuda:
        return similarity_bwd_routed_plain(tn, vn, tw, vw, g, m1, i1, m2, i2,
                                           need_t, need_v)
    out = routed_bwd_call(_LIB, "interaction_similarity_bwd", tn, vn, tw, vw,
                          g, (m1, i1, m2, i2), need_t, need_v)
    count_launch(fused_similarity_bwd, tn)
    return out


fused_similarity_bwd.launches = fused_similarity_bwd.launches_bf16 = 0


def _wants_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def _similarity_nograd(tn, vn, tw, vw, axis, kernels,
                       sim_dtype: str = "float32") -> torch.Tensor:
    """The forward with nothing saved, as `_Similarity` computes it."""
    tn, vn = operands(tn, vn, sim_dtype, kernels)
    if not kernels:
        sim = _similarity_plain(tn, vn, tw, vw)
        return sim if axis is None else sim.mean(dim=axis)
    if axis is None:
        return _similarity_fwd(tn, vn, tw, vw)[0]
    return _mean_fwd(tn, vn, tw, vw, axis)[0]


class _Similarity(torch.autograd.Function):
    """S [A, B] (axis None) or its mean over `axis`, on prepared inputs,
    the routing saved (kernel or plain) for a backward that recomputes
    nothing; the backward expands a mean's cotangent to its rank-1 [A, B]
    form and computes the feature gradients autograd asks for.  Under bf16
    the rounded features are what is multiplied and saved, and the
    gradients are the fp32 features' (straight through the rounding)."""

    @staticmethod
    def forward(ctx, tn, vn, tw, vw, axis, kernels, sim_dtype):
        ctx.axis, ctx.kernels, ctx.bf16 = axis, kernels, sim_dtype != "float32"
        tn, vn = operands(tn, vn, sim_dtype, kernels)
        if not kernels:
            sim, res = similarity_routing_plain(tn, vn, tw, vw)
            out = sim if axis is None else sim.mean(dim=axis)
        elif axis is None:
            out, res = _similarity_fwd(tn, vn, tw, vw, save=True)
        else:
            out, res = _mean_fwd(tn, vn, tw, vw, axis, save=True)
        ctx.save_for_backward(tn, vn, tw, vw, *res)
        return out

    @staticmethod
    def backward(ctx, g):
        tn, vn, tw, vw, *res = ctx.saved_tensors
        A, B = tn.shape[0], vn.shape[0]
        if ctx.axis == 1:
            g = (g.float() / B)[:, None].expand(A, B)
        elif ctx.axis == 0:
            g = (g.float() / A)[None, :].expand(A, B)
        need_t, need_v = ctx.needs_input_grad[:2]
        if ctx.kernels:
            grads = fused_similarity_bwd(tn, vn, tw, vw, g, *res,
                                         need_t=need_t, need_v=need_v)
        else:
            grads = similarity_bwd_routed_plain(
                tn, vn, tw, vw, g, *res, need_t=need_t, need_v=need_v,
                rounding="each" if ctx.bf16 else "none")
        return (*grads, None, None, None, None)


def fused_interaction_similarity(t_feat, v_feat, t_mask, v_mask, t_weight,
                                 v_weight, kernels: bool = True,
                                 sim_dtype: str = "float32",
                                 corpus: Optional[PreparedCorpus] = None
                                 ) -> torch.Tensor:
    """Similarity [A, B] in fp32, differentiable in features and weights.
    CPU tensors take the plain version; CUDA tensors launch the kernel (fp32
    inputs and outputs, the products in a 3xTF32 split on the tensor cores,
    no further from float64 than cuBLAS's fp32 GEMM at D = 512; under
    `sim_dtype="bfloat16"` bf16 features and one bf16 product) after the
    masks are folded into the normalised features, as the TPU wrapper does,
    with the backward kernel behind it.  Kernel limits: T <= 64, V <= 16,
    D % 32 == 0 (longer videos: ops/similarity_blocked.py).
    `kernels=False` is the reference the backward kernel is held to, on
    any device: the plain forward on the same prepared inputs with the
    written-out first-index backward.  The eval and serving call it in
    float32.  `corpus`: the video side prepared once (`PreparedCorpus`);
    on the CPU it takes the plain version on prepared inputs."""
    check_sim_dtype(sim_dtype)
    if kernels and not t_feat.is_cuda:
        if sim_dtype == "float32" and corpus is None:
            return interaction_similarity(t_feat, v_feat, t_mask, v_mask,
                                          t_weight, v_weight)
        kernels = False
    prep = _prepare(t_feat, v_feat, t_mask, v_mask, t_weight, v_weight,
                    kernels, corpus)
    if _wants_grad(*prep):
        return _Similarity.apply(*prep, None, kernels, sim_dtype)
    return _similarity_nograd(*prep, None, kernels, sim_dtype)


fused_interaction_similarity.launches = 0
fused_interaction_similarity.launches_bf16 = 0


def fused_interaction_mean(t_feat, v_feat, t_mask, v_mask, t_weight, v_weight,
                           axis: int = 1, sim_dtype: str = "float32",
                           kernels: bool = True) -> torch.Tensor:
    """Mean of the similarity matrix over `axis` without the matrix: axis 1
    → [A] row means, axis 0 → [B] column means; differentiable, the gradient
    routed through the first index of each max.  CPU tensors, and any
    tensor under `kernels=False`, take the plain version (which does build
    the matrix) with the written-out plain backward.  The kernel takes fp32
    features (its 3xTF32 products as close to float64 as cuBLAS's fp32 ones
    at D = 512) or, under `sim_dtype="bfloat16"`, their bf16 rounding (one
    bf16 product); it has the similarity kernel's limits: T <= 64, V <= 16,
    D % 32 == 0."""
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    check_sim_dtype(sim_dtype)
    kernels = kernels and t_feat.is_cuda
    prep = _prepare(t_feat, v_feat, t_mask, v_mask, t_weight, v_weight,
                    kernels)
    if _wants_grad(*prep):
        return _Similarity.apply(*prep, axis, kernels, sim_dtype)
    return _similarity_nograd(*prep, axis, kernels, sim_dtype)


fused_interaction_mean.launches = fused_interaction_mean.launches_bf16 = 0
