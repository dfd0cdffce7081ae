"""CLIP dual encoder (↔ neighborretr_tpu/models/clip.py).

Module and parameter names follow the reference's CLIP state dict
(`visual.conv1.weight`, `token_embedding.weight`, `transformer.resblocks.
{i}...`, `ln_final`, `text_projection`, `logit_scale`), so a reference
checkpoint loads without renaming.  Inputs keep the JAX layouts: frames
NHWC, token ids [B, L].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import ClipConfig

from . import layers as L


class VisionTransformer(nn.Module):
    def __init__(self, cfg: ClipConfig, device=None):
        super().__init__()
        width, P = cfg.vision_width, cfg.vision_patch_size
        self.patch_size = P
        # stride-P patch conv without bias (not a Pallas kernel in the JAX
        # package either: F.conv2d serves it)
        self.conv1 = L.skip_init(nn.Conv2d, 3, width, kernel_size=P,
                                 stride=P, bias=False, device=device)
        self.class_embedding = L.empty_param(width, device=device)
        self.positional_embedding = L.empty_param(
            cfg.grid_size ** 2 + 1, width, device=device)
        self.ln_pre = L.LayerNorm(width, device=device)
        self.transformer = L.Transformer(width, cfg.vision_layers,
                                         cfg.vision_heads, device=device)
        self.ln_post = L.LayerNorm(width, device=device)
        self.proj = L.empty_param(width, cfg.embed_dim, device=device)

    def forward(self, images: torch.Tensor, dtype: torch.dtype,
                kernels: bool = True, **tower) -> torch.Tensor:
        """images [N, H, W, 3] normalised (NHWC) → projected CLS [N, E]
        (the JAX package's `project_hidden=False`: only the CLS token goes
        through ln_post and proj).  tower: layers.Transformer.forward's
        route and remat arguments."""
        N = images.shape[0]
        x = F.conv2d(images.to(dtype).permute(0, 3, 1, 2),
                     self.conv1.weight.to(dtype), stride=self.patch_size)
        x = x.flatten(2).transpose(1, 2)                 # [N, gh·gw, width]
        cls = self.class_embedding.to(dtype).expand(N, 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dtype)
        x = self.ln_pre(x)
        x = self.transformer(x, None, dtype, kernels, **tower)
        cls_tok = self.ln_post(x[:, 0, :])
        return cls_tok.to(dtype) @ self.proj.to(dtype)


class CLIP(nn.Module):
    def __init__(self, cfg: ClipConfig, device=None):
        super().__init__()
        self.cfg = cfg
        width = cfg.transformer_width
        self.visual = VisionTransformer(cfg, device=device)
        self.token_embedding = L.skip_init(
            nn.Embedding, cfg.vocab_size, width, device=device)
        self.positional_embedding = L.empty_param(
            cfg.context_length, width, device=device)
        self.transformer = L.Transformer(width, cfg.transformer_layers,
                                         cfg.transformer_heads, device=device)
        self.ln_final = L.LayerNorm(width, device=device)
        self.text_projection = L.empty_param(width, cfg.embed_dim,
                                             device=device)
        self.logit_scale = nn.Parameter(torch.empty((), device=device))

    def encode_text(self, text_ids: torch.Tensor, text_mask: torch.Tensor,
                    dtype: torch.dtype, kernels: bool = True,
                    **tower) -> torch.Tensor:
        """text_ids [B, L] (0-padded), text_mask [B, L] {0,1} → projected
        hidden [B, L, E] under the causal ∧ key-padding bias.  (The EoT
        feature the JAX package also returns feeds only training.)  tower:
        layers.Transformer.forward's route and remat arguments."""
        Lq = text_ids.shape[1]
        x = (self.token_embedding.weight[text_ids.long()].to(dtype)
             + self.positional_embedding[:Lq].to(dtype))
        bias = L.causal_bias(Lq, x.device) + L.padding_bias(text_mask)
        x = self.transformer(x, bias, dtype, kernels, **tower)
        return self.ln_final(x).to(dtype) @ self.text_projection.to(dtype)
