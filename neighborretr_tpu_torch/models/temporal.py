"""Temporal (frame-aggregation) transformer (↔ neighborretr_tpu/models/
temporal.py): frame position embeddings added to the per-frame CLIP
features, a pre-LN transformer under a key-padding bias of -1e6, then a
residual back to the frame features.

Its parameters live on the NeighborRetr module under the reference's names
(`frame_position_embeddings.weight`, `transformerClip.resblocks.{i}...`).
"""

from __future__ import annotations

import torch

KEY_PAD_BIAS = -1e6


def aggregate_video_features(model, video_feat: torch.Tensor,
                             video_mask: torch.Tensor, dtype: torch.dtype,
                             kernels: bool = True,
                             fused_attention="block") -> torch.Tensor:
    """[B, F, D] per-frame features + [B, F] mask → [B, F, D] temporal
    features, in video_feat's dtype.  The temporal tower is never
    rematerialised, as in the JAX package."""
    F = video_feat.shape[1]
    x = (video_feat.to(dtype)
         + model.frame_position_embeddings.weight[:F].to(dtype))
    bias = torch.where(video_mask[:, None, None, :] > 0, 0.0,
                       KEY_PAD_BIAS).float()
    x = model.transformerClip(x, bias, dtype, kernels, fused_attention)
    return (x + video_feat.to(dtype)).to(video_feat.dtype)
