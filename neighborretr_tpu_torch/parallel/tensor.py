"""Megatron tensor parallelism over the mesh's `model` axis (↔ what GSPMD
makes of neighborretr_tpu/models/layers.py::block_apply under
parallel/mesh.py::tp_param_shardings).

Placement (`shard_params_tp`), in torch's layout: `attn.in_proj_weight` is
the packed [3D, D] with the q, k and v rows stacked, so a rank's column
shard is its heads' rows of each of q, k and v (with the same rows of
`in_proj_bias`): whole heads of all three, never a contiguous 3D/tp
block.  `mlp.c_fc` takes output rows (weight and bias);
`attn.out_proj.weight` (its heads' columns) and `mlp.c_proj.weight`
take input columns, and their biases stay whole, added once after the
all-reduce.  Everything else is replicated.  Any n_head at any tp (↔
GSPMD's padding and resharding in the JAX package): model rank r takes
⌈H/tp⌉ whole heads if r < H mod tp, else ⌊H/tp⌋ (parallel/mesh.py::
tp_share), and the MLP's 4·D hidden units by the same rule; a rank with
no heads (H < tp) launches no attention kernel and adds a zero partial
sum.

Compute, per block on each rank (ResidualAttentionBlock routes here when
it holds `tp`):
  attention  LN1(x), replicated → copy-to-model → the rank's heads through
             the route's attention, with its q/k/v rows, its columns of
             W_o and a zero b_o: on the block route K10/K11
             (ops/block_attention.py::fused_attention_sublayer), whose
             output cannot be summed over ranks while it holds b_o and the
             residual (K1's); on the fused route packed qkv [N, L, 3E]
             through K8/K9 on the rank's E / 64 heads; else the
             plain einsum form → the fp32 partial sums all-reduced by
             reduce-from-model → + b_o + x;
  MLP        LN2(x) → copy-to-model → the rank's c_fc rows, QuickGELU →
             its c_proj columns without bias → reduce-from-model → + bias
             + x (plain F.linear, as the JAX package computes it outside
             any kernel).
copy-to-model is the identity forward and an all-reduce of the cotangent
backward (each rank's heads give a part of dLN(x)); reduce-from-model is an
all-reduce forward and the identity backward.  So a replicated parameter's
gradient is the same on every model rank and is never summed over them,
and a split one's stays with its shard.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops.attention import fused_frame_attention
from ..ops.block_attention import fused_attention_sublayer, mha


@dataclasses.dataclass(frozen=True)
class ModelGroup:
    """A block's `model` axis: its process group and size."""
    group: object
    size: int


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, tp: ModelGroup) -> torch.Tensor:
    return _CopyToModel.apply(x, tp.group)


def reduce_from_model(x: torch.Tensor, tp: ModelGroup) -> torch.Tensor:
    """The fp32 sum of the model ranks' partial results."""
    return _ReduceFromModel.apply(x.float(), tp.group)


def attention(block, x: torch.Tensor, bias, dtype: torch.dtype, route,
              kernels: bool = True) -> torch.Tensor:
    """x + Attn(LN1(x)) with this rank's heads (see the module docstring);
    `route`: layers.attention_route's answer for x."""
    a, tp = block.attn, block.tp
    heads = block.tp_heads
    x = x.to(dtype)
    h = copy_to_model(block.ln_1(x), tp)
    zero = torch.zeros_like(a.out_proj.bias)
    if heads == 0:              # no heads here; h · 0 keeps the backward's
        part = h.float() * 0    # all-reduce of dLN(x) on this rank too
    elif route == "block":
        part = fused_attention_sublayer(
            h, a.in_proj_weight, a.in_proj_bias, a.out_proj.weight, zero,
            heads, bias, kernels)
    elif route:
        qkv = F.linear(h, a.in_proj_weight.to(dtype),
                       a.in_proj_bias.to(dtype))
        out = fused_frame_attention(qkv, heads, bias, kernels)
        part = F.linear(out.to(dtype), a.out_proj.weight.to(dtype))
    else:
        part = mha(h, a.in_proj_weight, a.in_proj_bias, a.out_proj.weight,
                   zero, heads, bias)
    y = reduce_from_model(part, tp)
    return (x.float() + y + a.out_proj.bias.float()).to(dtype)


def mlp_hidden(block, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """QuickGELU(c_fc(LN2(x))) for this rank's hidden units."""
    return block.mlp.hidden(copy_to_model(block.ln_2(x), block.tp), dtype)


def mlp_out(block, x: torch.Tensor, hidden: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """x + c_proj(hidden), the partial products summed over the ranks."""
    proj = block.mlp.c_proj
    part = F.linear(hidden.to(dtype), proj.weight.to(dtype))
    y = reduce_from_model(part, block.tp)
    return (x.float() + y + proj.bias.float()).to(dtype)


# torch-layout parameter name (within a block) → its split over `model`
TP_SPLITS = {
    "attn.in_proj_weight": "qkv", "attn.in_proj_bias": "qkv",
    "mlp.c_fc.weight": "rows", "mlp.c_fc.bias": "rows",
    "attn.out_proj.weight": "cols", "mlp.c_proj.weight": "cols",
}


@torch.no_grad()
def shard_params_tp(model: nn.Module, mesh, params: Dict[str, object]
                    ) -> None:
    """The Megatron split of every residual block of the towers (↔
    tp_param_shardings + shard_params_tp): each split parameter replaced by
    this rank's part, the block given its `ModelGroup`, and `params` (name
    → mesh.Placement) marked, the attention's in units of a head."""
    from ..models.layers import ResidualAttentionBlock
    from .mesh import local_piece, tp_share
    tp = ModelGroup(mesh.group("model"), mesh.size("model"))
    for prefix, block in model.named_modules():
        if not isinstance(block, ResidualAttentionBlock):
            continue
        head_dim = block.attn.out_proj.weight.shape[1] // block.n_head
        for sub, kind in TP_SPLITS.items():
            name = f"{prefix}.{sub}"
            params[name] = dataclasses.replace(
                params[name], tp=kind,
                tp_unit=head_dim if sub.startswith("attn.") else 1)
            owner, leaf = block.get_submodule(sub.rsplit(".", 1)[0]), \
                sub.rsplit(".", 1)[1]
            full = getattr(owner, leaf)
            setattr(owner, leaf, nn.Parameter(
                local_piece(full.detach(), params[name], mesh),
                requires_grad=full.requires_grad))
        block.tp = tp
        block.tp_heads = tp_share(block.n_head, tp.size,
                                  mesh.coord("model"))[1]
