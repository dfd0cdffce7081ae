"""NeighborRetr model (↔ neighborretr_tpu/models/neighborretr.py): the CLIP
towers, the temporal transformer, the token-weight MLPs, the local
token-interaction similarity, and for training the CTM merge stacks, the
`*_fc1` global-level nets, the global similarity and the memory-bank
centrality.  Module names follow the reference's state dict
(`text_ctm0`, `text_block0`, ..., `text_weight_fc1`).

Kernel dispatch: a CPU tensor runs the plain PyTorch versions; a CUDA
tensor runs the hand-written kernels (ops/block_attention.py,
ops/attention.py, ops/similarity.py, ops/similarity_blocked.py).
`kernels=False` runs the plain versions on any device: the reference a
kernel run is held to.  `cfg.attention_impl` picks the towers' attention
route (`resolve_fused_attention`); `cfg.remat*` and
`cfg.video_chunk_frames` trade a second forward for activation memory.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.config import ModelConfig
from ..ops.similarity import (fused_interaction_mean,
                              fused_interaction_similarity, global_similarity,
                              interaction_similarity)
from ..ops.similarity_blocked import fused_interaction_similarity_blocked
from ..ops.video import normalize_frames
from ..utils.spans import span
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

    def forward(self, fn, *args, **kwargs):
        """fn(self, *args, **kwargs) as this module's forward, so that hooks
        on the model wrap the whole computation: under FSDP2
        (parallel/mesh.py) the parameters outside the residual blocks are
        gathered before it and resharded after, and their gradients
        reduce-scattered in the backward.  The train step, the bank fill
        and the eval encode through it."""
        return fn(self, *args, **kwargs)

    def get_text_feat(self, text_ids: torch.Tensor, text_mask: torch.Tensor,
                      kernels: bool = True) -> torch.Tensor:
        """[B, W] ids/mask → [B, W, E] projected token hidden (fp32)."""
        cfg = self.cfg
        return self.clip.encode_text(
            text_ids, text_mask, self.compute_dtype, kernels,
            fused_attention=resolve_fused_attention(cfg, text_ids.device),
            remat=cfg.remat, remat_policy=cfg.remat_policy).float()

    def get_video_feat(self, video: torch.Tensor, video_mask: torch.Tensor,
                       kernels: bool = True) -> torch.Tensor:
        """[B, F, H, W, 3] frames + [B, F] mask → [B, F, E] temporal
        features (fp32).  uint8 pixels are CLIP-normalised on the device.

        cfg.video_chunk_frames: the vision tower runs on that many frames
        at a time, one chunk after another, each rematerialised as a whole
        in the backward, so activations are bounded by one chunk and only
        the chunks' inputs and outputs persist; per-layer remat is off
        inside a chunk.  A chunk that does not divide B·F pads the frame
        axis up to a multiple (the pad rows are dropped)."""
        cfg, dtype = self.cfg, self.compute_dtype
        fused = resolve_fused_attention(cfg, video.device)
        if video.dtype == torch.uint8:
            video = normalize_frames(video, dtype)
        B, F = video_mask.shape
        frames = video.reshape((B * F,) + tuple(video.shape[2:]))

        def encode_frames(fr, remat):
            return self.clip.visual(
                fr, dtype, kernels, fused_attention=fused, remat=remat,
                remat_policy=cfg.remat_policy,
                remat_skip_last=cfg.remat_skip_last)

        chunk, total = cfg.video_chunk_frames, B * F
        if chunk and total > chunk:
            pad = (-total) % chunk
            if pad:
                frames = torch.cat(
                    [frames, frames.new_zeros((pad,) + frames.shape[1:])])

            def encode_chunk(fr):
                if not torch.is_grad_enabled():
                    return encode_frames(fr, False)
                return checkpoint(encode_frames, fr, False,
                                  use_reentrant=False,
                                  preserve_rng_state=False)

            cls = torch.cat([encode_chunk(frames[s:s + chunk])
                             for s in range(0, total + pad, chunk)])[:total]
        else:
            cls = encode_frames(frames, cfg.remat)
        frame_feat = cls.reshape(B, F, -1).float()
        return aggregate_video_features(self, frame_feat, video_mask, dtype,
                                        kernels, fused)

    def get_text_video_feat(self, text_ids, text_mask, video, video_mask,
                            kernels: bool = True
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        return (self.get_text_feat(text_ids, text_mask, kernels),
                self.get_video_feat(video, video_mask, kernels))


def resolve_fused_attention(cfg: ModelConfig, device) -> Union[bool, str]:
    """cfg.attention_impl → what `layers.ResidualAttentionBlock` takes: False
    (the plain einsum form under autograd), True (the attention kernel on
    packed qkv, ops/attention.py) or "block" (the whole attention sublayer
    in one kernel, ops/block_attention.py; a sequence it cannot serve goes
    to the attention kernel, `layers.attention_route`).  'auto' → "block"
    on a CUDA device with bf16 compute, else False.

    Precision contract: both kernels multiply in bf16 by design (fp32
    softmax and LayerNorm islands).  Under compute_dtype='float32' the only
    faithful form is the einsum one: 'auto' falls back to it, and asking
    for a kernel route raises."""
    impl = cfg.attention_impl
    if impl in ("fused_block", "fused"):
        if cfg.compute_dtype != "bfloat16":
            raise ValueError(
                f"attention_impl='{impl}' computes its MXU "
                "dots in bfloat16 by design; with compute_dtype="
                f"'{cfg.compute_dtype}' use attention_impl='einsum' (or "
                "switch compute_dtype to 'bfloat16')")
        return "block" if impl == "fused_block" else True
    if impl == "einsum":
        return False
    if impl != "auto":
        raise ValueError(f"attention_impl must be one of auto, einsum, fused, "
                         f"fused_block; got {impl!r}")
    on_cuda = torch.device(device).type == "cuda"
    return "block" if on_cuda and cfg.compute_dtype == "bfloat16" else False


def token_weights(mlp: nn.Sequential, feat: torch.Tensor,
                  mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Masked softmax token weights (fp32, mask fill -9e15)."""
    w = mlp(feat.float()).squeeze(-1)
    if mask is not None:
        w = torch.where(mask > 0, w, torch.full_like(w, -9e15))
    return torch.softmax(w, dim=-1)


def similarity_kernels(cfg: ModelConfig, kernels: bool = True) -> bool:
    """Whether the similarity family (K2, K4–K7) may run its kernels:
    `use_pallas="off"` sends it to the plain forms on any device, as the
    JAX package's "off" sends it to XLA; "auto" and "on" leave the choice
    to the tensor's device.  The towers' attention kernels do not read it.

    `sim_dtype` follows the same rule (`similarity_dtype`): under "off" the
    family multiplies in float32, as JAX's XLA forms do whatever sim_dtype
    says; under "auto" and "on" its kernels on CUDA and their plain
    versions elsewhere round to `sim_dtype`.  So on the CPU the port's
    "auto" rounds where the JAX package's does not (its "auto" takes Pallas
    on a TPU only); the two agree under "on" (JAX in interpret mode) and
    under "off"."""
    if cfg.use_pallas not in ("auto", "on", "off"):
        raise ValueError(f"use_pallas must be one of auto, on, off; got "
                         f"{cfg.use_pallas!r}")
    return kernels and cfg.use_pallas != "off"


def similarity_dtype(cfg: ModelConfig) -> str:
    """The operand dtype of the similarity family on the training path:
    `cfg.sim_dtype`, or float32 under use_pallas="off" (see
    `similarity_kernels`)."""
    return cfg.sim_dtype if cfg.use_pallas != "off" else "float32"


def local_similarity(model: NeighborRetr, t_feat, v_feat, t_mask, v_mask,
                     kernels: bool = True,
                     sim_dtype: str = "float32") -> torch.Tensor:
    """The reference's local_level: S [A, B] with v2t = S.T.  Long-token
    shapes (T·V >= 2048, the 64-word / 64-frame recipes) take the blocked
    form, which never builds the whole [A, T, B, V] logits: its kernels on
    a CUDA tensor, its plain chunked version on the CPU or under
    `kernels=False`.  sim_dtype: the products' operand dtype (↔ the JAX
    package's, passed to its kernels): "bfloat16" on the training path,
    float32 in the eval and serving."""
    with span("nr::token_weights"):
        tw = token_weights(model.text_weight_fc, t_feat, t_mask)
        vw = token_weights(model.video_weight_fc, v_feat, v_mask)
    T, V = t_feat.shape[1], v_feat.shape[1]
    if T * V >= 2048:
        return fused_interaction_similarity_blocked(
            t_feat, v_feat, t_mask, v_mask, tw, vw, kernels=kernels,
            sim_dtype=sim_dtype)
    if kernels or sim_dtype != "float32":
        return fused_interaction_similarity(t_feat, v_feat, t_mask, v_mask,
                                            tw, vw, kernels, sim_dtype)
    return interaction_similarity(t_feat, v_feat, t_mask, v_mask, tw, vw)


def bank_fusion_supported(cfg: ModelConfig) -> bool:
    """The similarity→mean kernel covers the flat-kernel shapes; long-token
    configs (T·V >= 2048) build the full bank matrices with the blocked
    similarity (the JAX package's rule)."""
    return cfg.max_words * cfg.max_frames < 2048


def bank_centrality(model: NeighborRetr, t_feat, v_feat, t_mask, v_mask,
                    axis: int = 1, sim_dtype: str = "float32",
                    kernels: bool = True) -> torch.Tensor:
    """Mean of the local similarity over `axis` (1 → per-text mean against a
    video bank, 0 → per-video mean against a text bank): the neighbor loss's
    only use of the bank matrices.  On CUDA the kernel never builds them."""
    with span("nr::token_weights"):
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
