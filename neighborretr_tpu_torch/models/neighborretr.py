"""NeighborRetr serving subset (↔ neighborretr_tpu/models/neighborretr.py):
the CLIP towers, the temporal transformer, the token-weight MLPs and the
local token-interaction similarity.

Training-only parts (CTM merge stacks, the `*_fc1` global-level nets, the
losses) are not on the serving path and are not ported yet.

Kernel dispatch: a CPU tensor runs the plain PyTorch versions; a CUDA
tensor runs the hand-written kernels (ops/block_attention.py,
ops/similarity.py), and the attention kernel raises under
compute_dtype='float32'.  `kernels=False` runs the plain versions on any
device: the reference a kernel run is held to.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from neighborretr_tpu.core.config import ModelConfig

from ..ops.similarity import (fused_interaction_similarity,
                              interaction_similarity,
                              interaction_similarity_chunked)
from ..ops.video import normalize_frames
from . import layers as L
from .clip import CLIP
from .temporal import aggregate_video_features

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _weight_mlp(dim: int, device=None) -> nn.Sequential:
    """Linear(d→2d) → ReLU → Linear(2d→1) (keys .0.* and .2.*)."""
    return nn.Sequential(
        L.skip_init(nn.Linear, dim, 2 * dim, device=device),
        nn.ReLU(),
        L.skip_init(nn.Linear, 2 * dim, 1, device=device))


class NeighborRetr(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        width = cfg.width
        self.clip = CLIP(cfg.clip, device=device)
        self.frame_position_embeddings = L.skip_init(
            nn.Embedding, cfg.clip.context_length, width, device=device)
        self.transformerClip = L.Transformer(
            width, cfg.temporal_layers, cfg.clip.transformer_heads,
            device=device)
        self.text_weight_fc = _weight_mlp(width, device=device)
        self.video_weight_fc = _weight_mlp(width, device=device)

    @property
    def compute_dtype(self) -> torch.dtype:
        return DTYPES[self.cfg.compute_dtype]

    def get_text_feat(self, text_ids: torch.Tensor, text_mask: torch.Tensor,
                      kernels: bool = True) -> torch.Tensor:
        """[B, W] ids/mask → [B, W, E] projected token hidden (fp32)."""
        return self.clip.encode_text(text_ids, text_mask, self.compute_dtype,
                                     kernels).float()

    def get_video_feat(self, video: torch.Tensor, video_mask: torch.Tensor,
                       kernels: bool = True) -> torch.Tensor:
        """[B, F, H, W, 3] frames + [B, F] mask → [B, F, E] temporal
        features (fp32).  uint8 pixels are CLIP-normalised on the device."""
        dtype = self.compute_dtype
        if video.dtype == torch.uint8:
            video = normalize_frames(video, dtype)
        B, F = video_mask.shape
        frames = video.reshape((B * F,) + tuple(video.shape[2:]))
        cls = self.clip.visual(frames, dtype, kernels)
        frame_feat = cls.reshape(B, F, -1).float()
        return aggregate_video_features(self, frame_feat, video_mask, dtype,
                                        kernels)


def token_weights(mlp: nn.Sequential, feat: torch.Tensor,
                  mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Masked softmax token weights (fp32, mask fill -9e15)."""
    w = mlp(feat.float()).squeeze(-1)
    if mask is not None:
        w = torch.where(mask > 0, w, torch.full_like(w, -9e15))
    return torch.softmax(w, dim=-1)


def local_similarity(model: NeighborRetr, t_feat, v_feat, t_mask, v_mask,
                     kernels: bool = True) -> torch.Tensor:
    """The reference's local_level: S [A, B] with v2t = S.T."""
    tw = token_weights(model.text_weight_fc, t_feat, t_mask)
    vw = token_weights(model.video_weight_fc, v_feat, v_mask)
    T, V = t_feat.shape[1], v_feat.shape[1]
    if T * V >= 2048:
        # long-token shapes: the TPU package runs its blocked kernel
        # (pallas_similarity_blocked.py) here, which is not ported yet
        if kernels and t_feat.is_cuda:
            raise NotImplementedError(
                f"T·V = {T * V} >= 2048 needs the blocked similarity kernel, "
                "which this port does not have yet")
        return interaction_similarity_chunked(t_feat, v_feat, t_mask, v_mask,
                                              tw, vw)
    sim = fused_interaction_similarity if kernels else interaction_similarity
    return sim(t_feat, v_feat, t_mask, v_mask, tw, vw)


@torch.no_grad()
def seed_temporal_from_clip(model: NeighborRetr) -> NeighborRetr:
    """Copy CLIP's text positional embedding into the frame position
    embeddings, and the first `temporal_layers` text resblocks into the
    temporal transformer (the reference's init)."""
    model.frame_position_embeddings.weight.copy_(
        model.clip.positional_embedding)
    for dst, src in zip(model.transformerClip.resblocks,
                        model.clip.transformer.resblocks):
        dst.load_state_dict(src.state_dict())
    return model
