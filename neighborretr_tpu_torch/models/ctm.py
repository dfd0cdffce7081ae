"""Hierarchical token merging: CTM + TC cross-attention (↔ neighborretr_tpu/
models/ctm.py; the reference's cluster.py CTM / TCBlock).

Two stages per modality of

    CTM:  residual 1-D token conv (k=3, no bias) → LayerNorm → score head →
          exp(masked score) merge weights → DPC-KNN clustering → weighted merge
    TCB:  cross-attention of the merged query tokens over the pre-merge
          tokens, with the pre-merge token scores added to the attention
          logits, residual from the pre-norm queries.

Stage 1 sees the padding mask; merged tokens are all valid, so stage 2 runs
unmasked.  Everything here is fp32 and small; none of it is a TPU kernel in
the JAX package.  Module names follow the reference's state dict
(`conv.conv.weight`, `norm`, `score`; `norm1`, `attn.q`, `attn.kv`,
`attn.proj`).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cluster import cluster_dpc_knn, merge_tokens
from . import layers as L


class TokenConv(nn.Module):
    """x + conv1d(x) over the token axis (kernel 3, no bias)."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.conv = L.skip_init(nn.Conv1d, dim, dim, kernel_size=3, padding=1,
                                bias=False, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv1d(x.float().transpose(1, 2), self.conv.weight, padding=1)
        return x + y.transpose(1, 2).to(x.dtype)


class CTM(nn.Module):
    def __init__(self, dim: int, device=None):
        super().__init__()
        self.conv = TokenConv(dim, device=device)
        self.norm = L.LayerNorm(dim, device=device)
        self.score = L.skip_init(nn.Linear, dim, 1, device=device)

    def forward(self, x: torch.Tensor, cluster_num: int, k: int,
                noise: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x [B, N, C] → (merged [B, cluster_num, C], kv tokens [B, N, C],
        token score [B, N], -inf at masked tokens)."""
        x = self.norm(self.conv(x))
        score = self.score(x).squeeze(-1)
        if mask is not None:
            score = torch.where(mask > 0, score,
                                torch.full_like(score, -torch.inf))
        token_weight = torch.exp(score)[..., None]
        cluster_num = min(cluster_num, x.shape[1])
        idx_cluster = cluster_dpc_knn(x, cluster_num, k, noise, token_mask=mask)
        return merge_tokens(x, idx_cluster, cluster_num, token_weight), x, score


class TCAttention(nn.Module):
    def __init__(self, dim: int, device=None):
        super().__init__()
        self.q = L.skip_init(nn.Linear, dim, dim, device=device)
        self.kv = L.skip_init(nn.Linear, dim, 2 * dim, device=device)
        self.proj = L.skip_init(nn.Linear, dim, dim, device=device)


class TCBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = L.LayerNorm(dim, device=device)
        self.attn = TCAttention(dim, device=device)

    def forward(self, q_tokens: torch.Tensor, kv_tokens: torch.Tensor,
                kv_score: torch.Tensor) -> torch.Tensor:
        """q_tokens [B, Nq, C] merged, kv_tokens [B, Nkv, C] pre-merge,
        kv_score [B, Nkv] added to the attention logits."""
        B, Nq, C = q_tokens.shape
        H, hd = self.num_heads, C // self.num_heads
        a = self.attn
        q = a.q(self.norm1(q_tokens)).reshape(B, Nq, H, hd).transpose(1, 2)
        k, v = a.kv(self.norm1(kv_tokens)).split(C, dim=-1)
        k = k.reshape(B, -1, H, hd).transpose(1, 2)
        v = v.reshape(B, -1, H, hd).transpose(1, 2)
        attn = torch.einsum("bhqd,bhkd->bhqk", q * hd ** -0.5, k).float()
        attn = attn + kv_score.float()[:, None, None, :]
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bhkd->bhqd", attn, v)
        out = out.transpose(1, 2).reshape(B, Nq, C)
        return q_tokens + a.proj(out)


def merge_to_global(ctm0: CTM, block0: TCBlock, ctm1: CTM, block1: TCBlock,
                    feat: torch.Tensor, mask: Optional[torch.Tensor],
                    sizes: Sequence[int], k: int,
                    noise: Optional[Sequence[torch.Tensor]] = None
                    ) -> torch.Tensor:
    """Two-stage merge of feat [B, N, C] to `sizes[1]` global tokens.
    noise: None (deterministic clustering) or the two stages' U[0,1) draws,
    [B, N] and [B, sizes[0]]."""
    n0, n1 = noise if noise is not None else (None, None)
    merged0, kv0, score0 = ctm0(feat, sizes[0], k, n0, mask)
    x0 = block0(merged0, kv0, score0)
    merged1, kv1, score1 = ctm1(x0, sizes[1], k, n1, None)
    return block1(merged1, kv1, score1)
