"""Transformer building blocks (↔ neighborretr_tpu/models/layers.py).

Modules hold fp32 parameters under the reference's state-dict names
(`ln_1`, `attn.in_proj_weight`, `attn.out_proj`, `ln_2`, `mlp.c_fc`,
`mlp.c_proj`, `resblocks.{i}`); matmul-heavy compute runs in the compute
dtype the caller passes (bf16 on the card) with fp32 LayerNorm/softmax
islands, as in the JAX package.

The attention sublayer (LN1 + qkv + attention + out projection + residual)
is one call to `ops.block_attention.ln_attention_sublayer`, one autograd
node: the CUDA kernels (forward and backward) for a CUDA tensor, their
plain versions for a CPU tensor.  `kernels=False` calls the plain versions
on any device — the reference the kernels are held to on the card.  The
blocks save their activations for the backward (no rematerialisation).
Parameters are created uninitialised; see weights_io.init_model and
weights_io.from_jax_params.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.block_attention import layer_norm, ln_attention_sublayer, mha

__all__ = ["NEG_INF", "quick_gelu", "layer_norm", "mha", "LayerNorm",
           "MultiheadAttention", "ResidualAttentionBlock", "Transformer",
           "causal_bias", "padding_bias", "linear"]

NEG_INF = -1e9


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype):
    """x @ Wᵀ + b with operands cast to `dtype` (↔ layers.linear)."""
    b = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), b)


def empty_param(*shape, device=None) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, device=device))


def skip_init(module_cls, *args, device=None, **kwargs) -> nn.Module:
    """A torch module with uninitialised parameters on `device`."""
    return nn.utils.skip_init(module_cls, *args, **kwargs,
                              device=device if device is not None else "cpu")


class LayerNorm(nn.Module):
    """LayerNorm with an fp32 island (eps 1e-5)."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.weight = empty_param(dim, device=device)
        self.bias = empty_param(dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias)


class MultiheadAttention(nn.Module):
    """Parameters of torch.nn.MultiheadAttention (packed q|k|v rows)."""

    def __init__(self, d_model: int, device=None):
        super().__init__()
        self.in_proj_weight = empty_param(3 * d_model, d_model, device=device)
        self.in_proj_bias = empty_param(3 * d_model, device=device)
        self.out_proj = skip_init(nn.Linear, d_model, d_model, device=device)


class MLP(nn.Module):
    def __init__(self, d_model: int, device=None):
        super().__init__()
        self.c_fc = skip_init(nn.Linear, d_model, 4 * d_model, device=device)
        self.c_proj = skip_init(nn.Linear, 4 * d_model, d_model,
                                device=device)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return linear(quick_gelu(linear(x, self.c_fc, dtype)), self.c_proj,
                      dtype)


class ResidualAttentionBlock(nn.Module):
    """Pre-LN residual block (↔ layers.block_apply)."""

    def __init__(self, d_model: int, n_head: int, device=None):
        super().__init__()
        self.n_head = n_head
        self.ln_1 = LayerNorm(d_model, device=device)
        self.attn = MultiheadAttention(d_model, device=device)
        self.ln_2 = LayerNorm(d_model, device=device)
        self.mlp = MLP(d_model, device=device)

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor],
                dtype: torch.dtype, kernels: bool = True) -> torch.Tensor:
        """x [N, L, D]; bias [N, L, L] fp32 or None."""
        a = self.attn
        x = ln_attention_sublayer(
            x.to(dtype), self.ln_1.weight, self.ln_1.bias,
            a.in_proj_weight.to(dtype), a.in_proj_bias,
            a.out_proj.weight.to(dtype), a.out_proj.bias, self.n_head, bias,
            kernels)
        return x + self.mlp(self.ln_2(x), dtype)


class Transformer(nn.Module):
    """Stack of residual blocks (↔ layers.transformer_apply)."""

    def __init__(self, width: int, layers: int, heads: int, device=None):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, device=device)
            for _ in range(layers))

    def forward(self, x: torch.Tensor, attn_bias: Optional[torch.Tensor],
                dtype: torch.dtype, kernels: bool = True) -> torch.Tensor:
        """attn_bias: additive fp32 bias broadcastable to [N, 1, L, L]; it is
        expanded once to the per-sequence [N, L, L] the blocks take."""
        bias = None
        if attn_bias is not None:
            N, L = x.shape[0], x.shape[1]
            bias = attn_bias.float().expand(N, 1, L, L)[:, 0].contiguous()
        for block in self.resblocks:
            x = block(x, bias, dtype, kernels)
        return x


def causal_bias(L: int, device=None) -> torch.Tensor:
    """[1, 1, L, L] additive causal mask."""
    i = torch.arange(L, device=device)
    m = torch.where(i[None, :] > i[:, None], NEG_INF, 0.0)
    return m.float()[None, None]


def padding_bias(mask: torch.Tensor) -> torch.Tensor:
    """[B, L] {0,1} key-padding mask → [B, 1, 1, L] additive bias."""
    return torch.where(mask[:, None, None, :] > 0, 0.0, NEG_INF).float()
