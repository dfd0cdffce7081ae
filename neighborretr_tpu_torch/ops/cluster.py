"""DPC-KNN token clustering and weighted token merging (↔ neighborretr_tpu/
ops/cluster.py, the reference's cluster_dpc_knn / merge_tokens).

  * pairwise distances → k-NN local density, with the reference's
    U[0,1)·1e-6 tie-break noise passed IN as a tensor (drawn by the caller
    from an explicit torch.Generator), so a test can feed both packages the
    same draws;
  * density-peak scoring (min distance to any higher-density point × density);
  * top-`cluster_num` centres, nearest-centre assignment with the centres
    pinned to their own cluster;
  * exp-score-weighted cluster averaging through `index_add_`.

The assignment carries no gradient; gradients flow through the merge
weights and features only.  Ties break towards the lower index everywhere
(stable sort, first minimum), as `jax.lax.top_k` and `jnp.argmin` do.
"""

from __future__ import annotations

from typing import Optional

import torch


def pairwise_dist(x: torch.Tensor) -> torch.Tensor:
    """Euclidean distances over [B, N, C] → [B, N, N], scaled by 1/sqrt(C),
    through the |a|²+|b|²-2ab expansion in full fp32."""
    sq = (x * x).sum(dim=-1)
    inner = torch.einsum("bnc,bmc->bnm", x, x)
    d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * inner
    return torch.sqrt(d2.clamp_min(0.0)) / (x.shape[-1] ** 0.5)


@torch.no_grad()
def cluster_dpc_knn(x: torch.Tensor, cluster_num: int, k: int,
                    noise: Optional[torch.Tensor] = None,
                    token_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B, N, C] → idx_cluster [B, N] int64, the cluster id per token.

    noise: [B, N] draws from U[0, 1) for the density tie-break (scaled by
    1e-6 here), or None for fully deterministic clustering.  k and
    cluster_num are clamped to the N tokens the stage holds."""
    x = x.detach().float()
    B, N, _ = x.shape
    k = min(k, N)
    cluster_num = min(cluster_num, N)

    dist = pairwise_dist(x)
    if token_mask is not None:
        valid = token_mask > 0
        # distances TO empty tokens (columns only) go past the global max;
        # their rows keep true distances, their density is zeroed below
        far = dist.max() + 1.0
        dist = torch.where(valid[:, None, :], dist, far)

    nearest = torch.topk(dist, k, dim=-1, largest=False).values     # [B, N, k]
    density = torch.exp(-(nearest * nearest).mean(dim=-1))
    if noise is not None:
        density = density + noise.to(density) * 1e-6
    if token_mask is not None:
        density = density * token_mask.to(density)

    # min distance to any token of higher density
    higher = density[:, None, :] > density[:, :, None]
    dist_max = dist.reshape(B, -1).amax(dim=-1)[:, None, None]
    dist_to_parent = torch.where(higher, dist, dist_max).amin(dim=-1)

    score = dist_to_parent * density
    index_down = torch.sort(score, dim=-1, descending=True,
                            stable=True).indices[:, :cluster_num]    # [B, K]

    center_dist = torch.gather(
        dist, 1, index_down[:, :, None].expand(B, cluster_num, N))   # [B, K, N]
    ids = torch.arange(cluster_num, device=x.device)
    first_min = center_dist == center_dist.amin(dim=1, keepdim=True)
    idx_cluster = torch.where(first_min, ids[None, :, None],
                              cluster_num).amin(dim=1)               # [B, N]
    idx_cluster.scatter_(1, index_down, ids[None, :].expand(B, cluster_num))
    return idx_cluster


def merge_tokens(x: torch.Tensor, idx_cluster: torch.Tensor, cluster_num: int,
                 token_weight: torch.Tensor) -> torch.Tensor:
    """Weighted average of the tokens of each cluster: x [B, N, C],
    idx_cluster [B, N], token_weight [B, N, 1] ≥ 0 → [B, cluster_num, C]."""
    B, N, C = x.shape
    flat_idx = (idx_cluster.detach().long()
                + torch.arange(B, device=x.device)[:, None] * cluster_num
                ).reshape(B * N)
    w = token_weight.reshape(B * N, 1)
    all_weight = w.new_zeros(B * cluster_num, 1).index_add_(0, flat_idx, w) + 1e-6
    norm_w = w / all_weight[flat_idx]
    source = (x.reshape(B * N, C) * norm_w).to(x.dtype)
    merged = source.new_zeros(B * cluster_num, C).index_add_(0, flat_idx, source)
    return merged.reshape(B, cluster_num, C)
