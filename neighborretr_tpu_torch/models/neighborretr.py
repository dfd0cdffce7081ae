"""NeighborRetr model (↔ neighborretr_tpu/models/neighborretr.py): the CLIP
towers, the temporal transformer, the token-weight MLPs, the local
token-interaction similarity, and for training the CTM merge stacks, the
`*_fc1` global-level nets, the global similarity and the memory-bank
centrality.  Module names follow the reference's state dict
(`text_ctm0`, `text_block0`, ..., `text_weight_fc1`).

Kernel dispatch: a CPU tensor runs the plain PyTorch versions; a CUDA
tensor runs the hand-written kernels (ops/block_attention.py,
ops/similarity.py), and the attention kernel raises under
compute_dtype='float32'.  `kernels=False` runs the plain versions on any
device: the reference a kernel run is held to.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..core.config import ModelConfig
from ..ops.similarity import (fused_interaction_mean,
                              fused_interaction_similarity, global_similarity,
                              interaction_similarity,
                              interaction_similarity_chunked)
from ..ops.video import normalize_frames
from . import ctm
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
        # global level: weight nets over the merged tokens (forward no-ops
        # at one merged token, kept for the reference's parameter set) and
        # one two-stage CTM + TCBlock stack per modality
        self.text_weight_fc1 = _weight_mlp(width, device=device)
        self.video_weight_fc1 = _weight_mlp(width, device=device)
        for modality in ("text", "video"):
            for i in (0, 1):
                setattr(self, f"{modality}_ctm{i}", ctm.CTM(width, device=device))
                setattr(self, f"{modality}_block{i}",
                        ctm.TCBlock(width, cfg.ctm_heads, device=device))

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

    def get_text_video_feat(self, text_ids, text_mask, video, video_mask,
                            kernels: bool = True
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        return (self.get_text_feat(text_ids, text_mask, kernels),
                self.get_video_feat(video, video_mask, kernels))


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


def bank_fusion_supported(cfg: ModelConfig) -> bool:
    """The similarity→mean kernel covers the flat-kernel shapes; long-token
    configs (T·V ≥ 2048) wait for the blocked similarity kernel."""
    return cfg.max_words * cfg.max_frames < 2048


def bank_centrality(model: NeighborRetr, t_feat, v_feat, t_mask, v_mask,
                    axis: int = 1, sim_dtype: str = "float32",
                    kernels: bool = True) -> torch.Tensor:
    """Mean of the local similarity over `axis` (1 → per-text mean against a
    video bank, 0 → per-video mean against a text bank): the neighbor loss's
    only use of the bank matrices.  On CUDA the kernel never builds them."""
    tw = token_weights(model.text_weight_fc, t_feat, t_mask)
    vw = token_weights(model.video_weight_fc, v_feat, v_mask)
    return fused_interaction_mean(t_feat, v_feat, t_mask, v_mask, tw, vw,
                                  axis=axis, sim_dtype=sim_dtype,
                                  kernels=kernels)


def draw_cluster_noise(cfg: ModelConfig, batch: int,
                       generator: torch.Generator, device=None):
    """The DPC-KNN tie-break draws of one step, U[0, 1): for each modality
    its two stages' [B, N] tensors, in the order text, video."""
    def rand(n):
        return torch.rand(batch, n, generator=generator,
                          device=generator.device).to(device)

    return tuple((rand(n_tokens), rand(min(sizes[0], n_tokens)))
                 for n_tokens, sizes in ((cfg.max_words, cfg.text_merge_sizes),
                                         (cfg.max_frames,
                                          cfg.video_merge_sizes)))


def merge_global_features(model: NeighborRetr, t_feat, v_feat, t_mask, v_mask,
                          noise=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-stage CTM merge per modality → global tokens [B, n1, E].
    noise: None (deterministic DPC-KNN) or `draw_cluster_noise`'s pair."""
    cfg = model.cfg
    n_t, n_v = noise if noise is not None else (None, None)
    g_t = ctm.merge_to_global(model.text_ctm0, model.text_block0,
                              model.text_ctm1, model.text_block1, t_feat,
                              t_mask, cfg.text_merge_sizes, cfg.ctm_k, n_t)
    g_v = ctm.merge_to_global(model.video_ctm0, model.video_block0,
                              model.video_ctm1, model.video_block1, v_feat,
                              v_mask, cfg.video_merge_sizes, cfg.ctm_k, n_v)
    return g_t, g_v


def global_level(model: NeighborRetr, t_global, v_global) -> torch.Tensor:
    """Global similarity over the merged tokens: unmasked `*_fc1` softmax
    token weights, unnormalised token interaction; single tokens reduce to a
    plain dot."""
    if t_global.shape[1] == 1 and v_global.shape[1] == 1:
        return global_similarity(t_global, v_global)
    tw = token_weights(model.text_weight_fc1, t_global, None)
    vw = token_weights(model.video_weight_fc1, v_global, None)
    return global_similarity(t_global, v_global, tw, vw)


def logit_scale(model: NeighborRetr) -> torch.Tensor:
    """exp(logit_scale); the parameter is clamped after each optimizer step,
    not in the forward."""
    return torch.exp(model.clip.logit_scale)


@torch.no_grad()
def clamp_logit_scale(model: NeighborRetr, max_scale: float = 100.0) -> None:
    model.clip.logit_scale.clamp_(max=math.log(max_scale))


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
