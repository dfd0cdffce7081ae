"""Plain reference of NeighborRetr's math in float32: the CLIP towers, the
temporal tower, the token-weight nets, the token-interaction similarity, the
CTM token merging and the four hubness losses.

A frozen copy written from the published model (OpenAI CLIP; NeighborRetr's
modeling, cluster and loss code), over a dict of tensors keyed by the
reference checkpoint's state-dict names.  Every product of the towers goes
through a `Precision` (`precision.py`), so the same code is the reference
(float32) and its control (float8 operands).  Nothing here imports the
program under test.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from .precision import Precision

Params = Dict[str, torch.Tensor]

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
LN_EPS = 1e-5
ATTN_NEG = -1e9          # causal and key-padding bias of the text tower
TEMPORAL_NEG = -1e6      # key-padding bias of the temporal tower
WEIGHT_FILL = -9e15      # masked token weights
BIG = 9e15               # the neighbor loss's mask fill


# ---------------------------------------------------------------- towers

def layer_norm(x, w, b):
    mean = x.mean(dim=-1, keepdim=True)
    xc = x - mean
    return xc * torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + LN_EPS) \
        * w + b


def block(P: Params, pre: str, x, n_head: int, bias, prec: Precision):
    """Pre-LN residual block: x + MHA(LN1(x)), then + MLP(LN2(x)) with
    QuickGELU.  bias: additive [N, L, L] or broadcastable, or None."""
    N, L, D = x.shape
    hd = D // n_head
    h = layer_norm(x, P[pre + "ln_1.weight"], P[pre + "ln_1.bias"])
    qkv = prec.linear(h, P[pre + "attn.in_proj_weight"],
                      P[pre + "attn.in_proj_bias"])
    q, k, v = (t.reshape(N, L, n_head, hd) for t in qkv.split(D, dim=-1))
    logits = prec.einsum("nqhd,nkhd->nhqk", q * hd ** -0.5, k)
    if bias is not None:
        logits = logits + bias.reshape(-1, 1, L, L)
    probs = torch.softmax(logits, dim=-1)
    out = prec.einsum("nhqk,nkhd->nqhd", probs, v).reshape(N, L, D)
    x = x + prec.linear(out, P[pre + "attn.out_proj.weight"],
                        P[pre + "attn.out_proj.bias"])
    h = layer_norm(x, P[pre + "ln_2.weight"], P[pre + "ln_2.bias"])
    m = prec.linear(h, P[pre + "mlp.c_fc.weight"], P[pre + "mlp.c_fc.bias"])
    m = m * torch.sigmoid(1.702 * m)
    return x + prec.linear(m, P[pre + "mlp.c_proj.weight"],
                           P[pre + "mlp.c_proj.bias"])


def transformer(P: Params, pre: str, x, layers: int, n_head: int, bias,
                prec: Precision):
    for i in range(layers):
        x = block(P, f"{pre}resblocks.{i}.", x, n_head, bias, prec)
    return x


def encode_frames(P: Params, frames_u8, cfg: dict, prec: Precision):
    """uint8 frames [N, R, R, 3] → projected CLS features [N, E]."""
    dev = frames_u8.device
    mean = torch.tensor(CLIP_MEAN, device=dev)
    std = torch.tensor(CLIP_STD, device=dev)
    x = (frames_u8.float() / 255.0 - mean) / std
    x = x.permute(0, 3, 1, 2)
    p = cfg["vision_patch_size"]
    x = F.conv2d(prec.r(x), prec.r(P["clip.visual.conv1.weight"]), stride=p)
    x = x.flatten(2).transpose(1, 2)
    N = x.shape[0]
    cls = P["clip.visual.class_embedding"].expand(N, 1, -1)
    x = torch.cat([cls, x], dim=1) + P["clip.visual.positional_embedding"]
    x = layer_norm(x, P["clip.visual.ln_pre.weight"],
                   P["clip.visual.ln_pre.bias"])
    x = transformer(P, "clip.visual.transformer.", x, cfg["vision_layers"],
                    cfg["vision_width"] // 64, None, prec)
    c = layer_norm(x[:, 0], P["clip.visual.ln_post.weight"],
                   P["clip.visual.ln_post.bias"])
    return prec.mm(c, P["clip.visual.proj"])


def encode_text(P: Params, ids, mask, cfg: dict, prec: Precision):
    """ids [B, W] (0-padded), mask [B, W] → projected token features
    [B, W, E] under the causal and key-padding bias."""
    W = ids.shape[1]
    x = P["clip.token_embedding.weight"][ids.long()] \
        + P["clip.positional_embedding"][:W]
    i = torch.arange(W, device=ids.device)
    causal = torch.where(i[None, :] > i[:, None], ATTN_NEG, 0.0)
    pad = torch.where(mask[:, None, :] > 0, 0.0, ATTN_NEG)
    x = transformer(P, "clip.transformer.", x, cfg["transformer_layers"],
                    cfg["transformer_width"] // 64, causal[None] + pad, prec)
    x = layer_norm(x, P["clip.ln_final.weight"], P["clip.ln_final.bias"])
    return prec.mm(x, P["clip.text_projection"])


def temporal(P: Params, frame_feat, vmask, cfg: dict, prec: Precision):
    """Per-frame features [B, F, E] → temporal features [B, F, E]: frame
    position embeddings, a pre-LN transformer under a key-padding bias,
    and a residual back to the frame features."""
    Fn = frame_feat.shape[1]
    x = frame_feat + P["frame_position_embeddings.weight"][:Fn]
    bias = torch.where(vmask[:, None, :] > 0, 0.0, TEMPORAL_NEG)
    bias = bias.expand(-1, Fn, -1)
    x = transformer(P, "transformerClip.", x, cfg["temporal_layers"],
                    cfg["transformer_width"] // 64, bias, prec)
    return x + frame_feat


def encode_video(P: Params, video_u8, vmask, cfg: dict, prec: Precision):
    B, Fn = vmask.shape
    cls = encode_frames(P, video_u8.reshape((B * Fn,) + video_u8.shape[2:]),
                        cfg, prec)
    return temporal(P, cls.reshape(B, Fn, -1), vmask, cfg, prec)


# ------------------------------------------------------------ similarity

def weight_mlp(P: Params, pre: str, x):
    h = torch.relu(x @ P[pre + "0.weight"].T + P[pre + "0.bias"])
    return (h @ P[pre + "2.weight"].T + P[pre + "2.bias"]).squeeze(-1)


def token_weights(P: Params, pre: str, feat, mask):
    w = weight_mlp(P, pre, feat)
    if mask is not None:
        w = torch.where(mask > 0, w, torch.full_like(w, WEIGHT_FILL))
    return torch.softmax(w, dim=-1)


def l2n(x):
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def interaction(tn, vn, tmask, vmask, tw, vw):
    """Token-interaction similarity [A, B]: normalised, masked features,
    each text token's best video token weighted by the text weights, each
    video token's best text token weighted by the video weights, averaged."""
    A, T, D = tn.shape
    B, V, _ = vn.shape
    tn = tn * tmask[..., None]
    vn = vn * vmask[..., None]
    logits = (tn.reshape(A * T, D) @ vn.reshape(B * V, D).T
              ).reshape(A, T, B, V)
    s_t = torch.einsum("atb,at->ab", logits.amax(dim=3), tw)
    s_v = torch.einsum("abv,bv->ab", logits.amax(dim=1), vw)
    return 0.5 * (s_t + s_v)


def local_similarity(P: Params, t_feat, v_feat, tmask, vmask,
                     video_chunk: int = 0):
    """S [A, B] of text features against video features, the video side
    taken `video_chunk` rows at a time when that is > 0."""
    tw = token_weights(P, "text_weight_fc.", t_feat, tmask)
    vw = token_weights(P, "video_weight_fc.", v_feat, vmask)
    tn, vn = l2n(t_feat), l2n(v_feat)
    if not video_chunk:
        return interaction(tn, vn, tmask, vmask, tw, vw)
    return torch.cat([interaction(tn, vn[s:s + video_chunk], tmask,
                                  vmask[s:s + video_chunk], tw,
                                  vw[s:s + video_chunk])
                      for s in range(0, vn.shape[0], video_chunk)], dim=1)


# ------------------------------------------------------------------- CTM

def merge_sizes(n_tokens: int, ratios: Sequence[float]) -> Tuple[int, int]:
    n0 = max(math.ceil(n_tokens * ratios[0]), 1)
    return n0, max(math.ceil(n0 * ratios[1]), 1)


@torch.no_grad()
def cluster_dpc_knn(x, cluster_num: int, k: int, noise=None, mask=None):
    """DPC-KNN: k-NN density (with a 1e-6 tie-break noise), distance to the
    nearest denser token, the top `cluster_num` scores as centres, every
    token to its nearest centre (first on ties), centres to themselves."""
    x = x.detach()
    B, N, C = x.shape
    k, cluster_num = min(k, N), min(cluster_num, N)
    sq = (x * x).sum(-1)
    d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * torch.einsum(
        "bnc,bmc->bnm", x, x)
    dist = torch.sqrt(d2.clamp_min(0.0)) / C ** 0.5
    if mask is not None:
        dist = torch.where(mask[:, None, :] > 0, dist, dist.max() + 1.0)
    nearest = torch.topk(dist, k, dim=-1, largest=False).values
    density = torch.exp(-(nearest * nearest).mean(dim=-1))
    if noise is not None:
        density = density + noise * 1e-6
    if mask is not None:
        density = density * mask
    higher = density[:, None, :] > density[:, :, None]
    dmax = dist.reshape(B, -1).amax(dim=-1)[:, None, None]
    parent = torch.where(higher, dist, dmax).amin(dim=-1)
    centres = torch.sort(parent * density, dim=-1, descending=True,
                         stable=True).indices[:, :cluster_num]
    cdist = torch.gather(dist, 1, centres[:, :, None].expand(B, cluster_num,
                                                             N))
    ids = torch.arange(cluster_num, device=x.device)
    first = cdist == cdist.amin(dim=1, keepdim=True)
    idx = torch.where(first, ids[None, :, None], cluster_num).amin(dim=1)
    idx.scatter_(1, centres, ids[None, :].expand(B, cluster_num))
    return idx


def merge_tokens(x, idx, cluster_num: int, weight):
    B, N, C = x.shape
    flat = (idx + torch.arange(B, device=x.device)[:, None] * cluster_num
            ).reshape(B * N)
    w = weight.reshape(B * N, 1)
    total = w.new_zeros(B * cluster_num, 1).index_add_(0, flat, w) + 1e-6
    src = x.reshape(B * N, C) * (w / total[flat])
    return src.new_zeros(B * cluster_num, C).index_add_(0, flat, src) \
        .reshape(B, cluster_num, C)


def ctm(P: Params, pre: str, x, cluster_num: int, k: int, noise, mask):
    y = F.conv1d(x.transpose(1, 2), P[pre + "conv.conv.weight"], padding=1)
    x = layer_norm(x + y.transpose(1, 2), P[pre + "norm.weight"],
                   P[pre + "norm.bias"])
    score = (x @ P[pre + "score.weight"].T + P[pre + "score.bias"])[..., 0]
    if mask is not None:
        score = torch.where(mask > 0, score, torch.full_like(score,
                                                             -torch.inf))
    cluster_num = min(cluster_num, x.shape[1])
    idx = cluster_dpc_knn(x, cluster_num, k, noise, mask)
    merged = merge_tokens(x, idx, cluster_num, torch.exp(score)[..., None])
    return merged, x, score


def tc_block(P: Params, pre: str, q_tok, kv_tok, kv_score, heads: int):
    B, Nq, C = q_tok.shape
    hd = C // heads
    n1w, n1b = P[pre + "norm1.weight"], P[pre + "norm1.bias"]
    q = (layer_norm(q_tok, n1w, n1b) @ P[pre + "attn.q.weight"].T
         + P[pre + "attn.q.bias"]).reshape(B, Nq, heads, hd).transpose(1, 2)
    kv = layer_norm(kv_tok, n1w, n1b) @ P[pre + "attn.kv.weight"].T \
        + P[pre + "attn.kv.bias"]
    k, v = kv.split(C, dim=-1)
    k = k.reshape(B, -1, heads, hd).transpose(1, 2)
    v = v.reshape(B, -1, heads, hd).transpose(1, 2)
    a = torch.einsum("bhqd,bhkd->bhqk", q * hd ** -0.5, k) \
        + kv_score[:, None, None, :]
    out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(a, dim=-1), v)
    out = out.transpose(1, 2).reshape(B, Nq, C)
    return q_tok + out @ P[pre + "attn.proj.weight"].T + P[pre +
                                                          "attn.proj.bias"]


def merge_to_global(P: Params, modality: str, feat, mask, sizes, k: int,
                    heads: int, noise):
    n0, n1 = noise if noise is not None else (None, None)
    m0, kv0, s0 = ctm(P, f"{modality}_ctm0.", feat, sizes[0], k, n0, mask)
    x0 = tc_block(P, f"{modality}_block0.", m0, kv0, s0, heads)
    m1, kv1, s1 = ctm(P, f"{modality}_ctm1.", x0, sizes[1], k, n1, None)
    return tc_block(P, f"{modality}_block1.", m1, kv1, s1, heads)


def global_similarity(P: Params, g_t, g_v):
    if g_t.shape[1] == 1 and g_v.shape[1] == 1:
        return g_t[:, 0] @ g_v[:, 0].T
    tw = token_weights(P, "text_weight_fc1.", g_t, None)
    vw = token_weights(P, "video_weight_fc1.", g_v, None)
    A, T1, D = g_t.shape
    B, V1, _ = g_v.shape
    logits = (g_t.reshape(A * T1, D) @ g_v.reshape(B * V1, D).T
              ).reshape(A, T1, B, V1)
    return 0.5 * (torch.einsum("atb,at->ab", logits.amax(dim=3), tw)
                  + torch.einsum("abv,bv->ab", logits.amax(dim=1), vw))


# ---------------------------------------------------------------- losses

@torch.no_grad()
def sinkhorn_targets(scores, beta: float, iters: int):
    m, n = scores.shape
    norm = -math.log(float(m + n))
    u, v = scores.new_zeros(m), scores.new_zeros(n)
    for _ in range(iters):
        u = norm - torch.logsumexp(scores + v[None, :], dim=1)
        v = norm - torch.logsumexp(scores + u[:, None], dim=0)
    q = torch.exp(scores + u[:, None] + v[None, :] - norm)
    return beta * q + (1.0 - beta) * torch.eye(m, n, device=scores.device)


def uniform_loss(s, scale: float, beta: float, iters: int):
    t = sinkhorn_targets(s.detach(), beta, iters)
    return (-(torch.log_softmax(s * scale, dim=-1) * t).sum(-1)).mean()


def kl_loss(s_global, s_local):
    log_q = torch.log_softmax(s_global, dim=-1)
    p = torch.softmax(s_local, dim=-1)
    return (torch.xlogy(p, p) - p * log_q).mean()


def centrality_loss(s, w):
    return -(torch.diagonal(torch.log_softmax(s, dim=-1)) * w).mean()


def centrality_weights(t_feat, v_feat, g_t, g_v, scale: float):
    D = t_feat.shape[-1]
    t_tok = l2n(t_feat.reshape(-1, D)).mean(dim=0)
    v_tok = l2n(v_feat.reshape(-1, D)).mean(dim=0)
    return (torch.exp((l2n(g_t) @ t_tok).mean(dim=-1) * scale),
            torch.exp((l2n(g_v) @ v_tok).mean(dim=-1) * scale))


def _minmax(s, mask):
    free = mask == 0.0
    lo = torch.where(free, s, BIG).amin(dim=-1, keepdim=True)
    hi = torch.where(free, s, -BIG).amax(dim=-1, keepdim=True)
    d = hi - lo
    return (s - lo) / torch.where(d > 0.0, d, 1.0)


def neighbor_loss(s, centrality, num_neighbors: int, temperature: float):
    B = s.shape[0]
    k = min(num_neighbors, B - 1)
    eye = torch.eye(B, device=s.device)
    no_self = torch.where(eye == 0.0, s.detach(), -BIG)
    top = torch.sort(no_self, dim=-1, descending=True,
                     stable=True).indices[:, :k]
    nb = torch.zeros_like(eye).scatter_(1, top, 1.0)
    ext = torch.maximum(nb, eye)
    cent = centrality[None, :].expand(B, B)
    adj = torch.where(nb == 1.0, _minmax(s, ext) - _minmax(cent, ext), -BIG)
    pos = torch.where(nb == 1.0, torch.softmax(adj * temperature, dim=-1),
                      0.0)
    pos = torch.where(eye.bool(), 1.0, pos)
    logp = torch.log_softmax(torch.where(ext == 1.0, s, -BIG), dim=-1) * pos
    return (-logp.sum(dim=-1) / pos.sum(dim=-1)).mean()


def bank_centralities(P: Params, t_feat, v_feat, tmask, vmask, bank):
    """Each text's mean similarity against the bank's videos and each
    video's against the bank's texts: the neighbor loss's centralities."""
    cent_t = local_similarity(P, t_feat, bank["feat_v"], tmask,
                              bank["mask_v"], 256).mean(dim=1)
    cent_v = local_similarity(P, bank["feat_t"], v_feat, bank["mask_t"],
                              vmask).mean(dim=0)
    return cent_t, cent_v


def losses(P: Params, t_feat, v_feat, tmask, vmask, bank, noise,
           model_cfg: dict, loss_cfg: dict) -> Dict[str, torch.Tensor]:
    """The four losses of a batch's features against the bank (a dict of
    feat_t, feat_v, mask_t, mask_v) → every term and the total."""
    words, frames = t_feat.shape[1], v_feat.shape[1]
    s_local = local_similarity(P, t_feat, v_feat, tmask, vmask)
    n_t, n_v = noise if noise is not None else (None, None)
    k, heads = model_cfg["ctm_k"], model_cfg["ctm_heads"]
    g_t = merge_to_global(P, "text", t_feat, tmask,
                          merge_sizes(words, model_cfg["text_merge_ratios"]),
                          k, heads, n_t)
    g_v = merge_to_global(P, "video", v_feat, vmask,
                          merge_sizes(frames,
                                      model_cfg["video_merge_ratios"]),
                          k, heads, n_v)
    s_global = global_similarity(P, g_t, g_v)
    lc = loss_cfg
    uni = 0.5 * (uniform_loss(s_global, lc["temperature"], lc["beta"],
                              lc["sinkhorn_iterations"])
                 + uniform_loss(s_global.T, lc["temperature"], lc["beta"],
                                lc["sinkhorn_iterations"]))
    kl = 0.5 * (kl_loss(s_global, s_local) + kl_loss(s_global.T, s_local.T))
    t_w, v_w = centrality_weights(t_feat, v_feat, g_t, g_v,
                                  lc["centrality_scale"])
    scale = torch.exp(P["clip.logit_scale"])
    cent = 0.5 * (centrality_loss(s_local * scale, t_w)
                  + centrality_loss(s_local.T * scale, v_w))
    cent_t, cent_v = bank_centralities(P, t_feat, v_feat, tmask, vmask, bank)
    nbl = 0.5 * (neighbor_loss(s_local, cent_v, lc["num_neighbors"],
                               lc["temperature"])
                 + neighbor_loss(s_local.T, cent_t, lc["num_neighbors"],
                                 lc["temperature"]))
    total = (cent + uni * lc["uniform_weight"] + nbl * lc["neighbor_weight"]
             + kl * lc["kl_weight"])
    return {"loss": total, "centrality_loss": cent, "uniform_loss": uni,
            "neighbor_loss": nbl, "kl_loss": kl}


def cluster_noise(batch: int, words: int, frames: int, model_cfg: dict,
                  generator: torch.Generator):
    """The DPC-KNN tie-break draws of one step, U[0, 1), in the order the
    NeighborRetr step draws them: text (both stages), then video."""
    def rand(n):
        return torch.rand(batch, n, generator=generator,
                          device=generator.device)

    out = []
    for n, ratios in ((words, model_cfg["text_merge_ratios"]),
                      (frames, model_cfg["video_merge_ratios"])):
        out.append((rand(n), rand(min(merge_sizes(n, ratios)[0], n))))
    return tuple(out)
