"""The four hubness-aware training objectives (↔ neighborretr_tpu/losses/
hubness.py).  Each takes explicit tensors and returns a scalar fp32 loss.

Reference quirks kept, as the JAX package keeps them:
  * the uniform loss takes --temperature as its logit scale (argument
    aliasing at the reference's call site);
  * the neighbor loss's min-max normalisation takes min/max over positions
    OUTSIDE the extended mask, with the denominator guarded where only one
    such position is left;
  * the positive-weight diagonal is forced to 1 after masking;
  * with several global tokens the centralities are averaged over them.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.similarity import l2_normalize
from ..ops.sinkhorn import sinkhorn_targets

BIG = 9e15


def _log_softmax(x: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(x.float(), dim=-1)


def centrality_weighting_loss(similarity: torch.Tensor,
                              weights: torch.Tensor) -> torch.Tensor:
    """-mean(diag(log_softmax(S)) · w); S already carries the logit scale."""
    return -(torch.diagonal(_log_softmax(similarity)) * weights.float()).mean()


def centrality_weights(text_feat, video_feat, global_text_feat,
                       global_video_feat, centrality_scale: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """exp(scale · mean_j <ĝ_i, token_j>) over ALL tokens of the batch,
    averaged over the global tokens → two [B] weights."""
    D = text_feat.shape[-1]
    t_tokens = l2_normalize(text_feat.reshape(-1, D).float())
    v_tokens = l2_normalize(video_feat.reshape(-1, D).float())
    g_t = l2_normalize(global_text_feat.float())
    g_v = l2_normalize(global_video_feat.float())
    t_cent = (g_t @ t_tokens.mean(dim=0)).mean(dim=-1)
    v_cent = (g_v @ v_tokens.mean(dim=0)).mean(dim=-1)
    return (torch.exp(t_cent * centrality_scale),
            torch.exp(v_cent * centrality_scale))


def _minmax_normalize(similarity: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    free = mask == 0.0
    min_vals = torch.where(free, similarity, BIG).amin(dim=-1, keepdim=True)
    max_vals = torch.where(free, similarity, -BIG).amax(dim=-1, keepdim=True)
    denom = max_vals - min_vals
    return (similarity - min_vals) / torch.where(denom > 0.0, denom, 1.0)


def neighbor_masks(similarity: torch.Tensor, num_neighbors: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k neighbour mask (diagonal excluded) and extended mask (diagonal ∪
    top-k) of a square batch matrix; ties go to the lower column."""
    B = similarity.shape[0]
    num_neighbors = min(num_neighbors, B - 1)
    eye = torch.eye(B, device=similarity.device)
    sim_no_self = torch.where(eye == 0.0, similarity.detach(), -BIG)
    topk_idx = torch.sort(sim_no_self, dim=-1, descending=True,
                          stable=True).indices[:, :num_neighbors]
    neighbor = torch.zeros_like(eye).scatter_(1, topk_idx, 1.0)
    return neighbor, torch.maximum(neighbor, eye)


def neighbor_adjusting_loss(similarity, memory_bank_matrix,
                            num_neighbors: int, temperature: float):
    """similarity [B, B]; memory_bank_matrix [B, M], used only through its
    row mean, the column entities' centrality."""
    return neighbor_adjusting_loss_from_centrality(
        similarity, memory_bank_matrix.float().mean(dim=-1), num_neighbors,
        temperature)


def neighbor_adjusting_loss_from_centrality(similarity, centrality,
                                            num_neighbors: int,
                                            temperature: float):
    similarity = similarity.float()
    B = similarity.shape[0]
    neighbor, extended = neighbor_masks(similarity, num_neighbors)
    centrality = centrality.float()[None, :].expand(B, B)

    norm_sim = _minmax_normalize(similarity, extended)
    norm_cent = _minmax_normalize(centrality, extended)
    is_nb = neighbor == 1.0
    adjusted = torch.where(is_nb, norm_sim - norm_cent, -BIG)

    pos_w = torch.softmax(adjusted * temperature, dim=-1)
    pos_w = torch.where(is_nb, pos_w, 0.0)
    eye = torch.eye(B, dtype=torch.bool, device=similarity.device)
    pos_w = torch.where(eye, 1.0, pos_w)

    masked_sim = torch.where(extended == 1.0, similarity, -BIG)
    logp = _log_softmax(masked_sim) * pos_w
    return (-logp.sum(dim=-1) / pos_w.sum(dim=-1)).mean()


def uniform_regularization_loss(similarity, logit_scale: float, beta: float,
                                num_iterations: int = 50):
    targets = sinkhorn_targets(similarity, beta, num_iterations)
    logp = _log_softmax(similarity * logit_scale) * targets
    return (-logp.sum(dim=-1)).mean()


def kl_divergence_loss(global_similarity, local_similarity):
    """F.kl_div(log_softmax(global), softmax(local), reduction='mean'): the
    elementwise mean over B·B entries, not batchmean."""
    log_q = _log_softmax(global_similarity)
    p = torch.softmax(local_similarity.float(), dim=-1)
    return (torch.xlogy(p, p) - p * log_q).mean()
