"""Transformer building blocks (↔ neighborretr_tpu/models/layers.py).

Modules hold fp32 parameters under the reference's state-dict names
(`ln_1`, `attn.in_proj_weight`, `attn.out_proj`, `ln_2`, `mlp.c_fc`,
`mlp.c_proj`, `resblocks.{i}`); matmul-heavy compute runs in the compute
dtype the caller passes (bf16 on the card) with fp32 LayerNorm/softmax
islands, as in the JAX package.

The attention sublayer has the JAX package's three routes, chosen by
`fused_attention` (models/neighborretr.py::resolve_fused_attention):
  "block"  LN1 + qkv + attention + out projection + residual as one call to
           `ops.block_attention.ln_attention_sublayer`, one autograd node
           (L <= 64 on the card; a longer sequence there takes the next
           route, see `attention_route`);
  True     layer_norm → F.linear (packed qkv) →
           `ops.attention.fused_frame_attention` → F.linear → residual: the
           attention kernel at any L;
  False    the plain `mha` under autograd, on any device and in any dtype.
A CUDA tensor runs the hand-written kernels (forward and backward), a CPU
tensor their plain versions; `kernels=False` calls the plain versions on
any device — the reference the kernels are held to on the card.

`Transformer` rematerialises its blocks under `remat` (torch.utils.
checkpoint, non-reentrant), by the JAX package's three policies; see
`ResidualAttentionBlock.forward`.  Parameters are created uninitialised; see
weights_io.init_model and weights_io.from_jax_params.

Model-sharded placements (parallel/mesh.py::place_params) hook in here: a
block given `tp` (a `model` axis) runs the Megatron split of its sublayers
(parallel/tensor.py), and a tower given `stages` (a `stage` axis) runs as a
GPipe pipeline (parallel/pipeline.py).
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import fused_frame_attention
from ..ops.block_attention import layer_norm, ln_attention_sublayer, mha
from ..parallel import pipeline, tensor

__all__ = ["NEG_INF", "quick_gelu", "layer_norm", "mha", "LayerNorm",
           "MultiheadAttention", "ResidualAttentionBlock", "Transformer",
           "causal_bias", "padding_bias", "linear", "attention_route",
           "REMAT_POLICIES", "BLOCK_KERNEL_MAX_L"]

REMAT_POLICIES = ("full", "attn", "dots")
# the longest sequence csrc/ln_attention_residual*.cu take
BLOCK_KERNEL_MAX_L = 64

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

    def hidden(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return quick_gelu(linear(x, self.c_fc, dtype))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return linear(self.hidden(x, dtype), self.c_proj, dtype)


class ResidualAttentionBlock(nn.Module):
    """Pre-LN residual block (↔ layers.block_apply)."""

    def __init__(self, d_model: int, n_head: int, device=None):
        super().__init__()
        self.n_head = n_head
        self.tp: Optional[tensor.ModelGroup] = None   # set by the TP split
        self.ln_1 = LayerNorm(d_model, device=device)
        self.attn = MultiheadAttention(d_model, device=device)
        self.ln_2 = LayerNorm(d_model, device=device)
        self.mlp = MLP(d_model, device=device)

    def attention(self, x: torch.Tensor, bias: Optional[torch.Tensor],
                  dtype: torch.dtype, kernels: bool = True,
                  fused_attention: Union[bool, str] = "block",
                  lean: bool = False) -> torch.Tensor:
        """The attention sublayer x + Attn(LN1(x)) → [N, L, D] in `dtype`.
        lean: keep for the backward only what the route cannot do without
        (its input; on the kernel route also qkv and the attention's
        output) and compute the rest again there."""
        a = self.attn
        route = attention_route(fused_attention, x.shape[1], x.is_cuda)
        if self.tp is not None:     # this rank's heads; lean changes nothing
            return tensor.attention(self, x, bias, dtype, route, kernels)
        x = x.to(dtype)
        if route == "block":        # saves its inputs only, as it is
            return ln_attention_sublayer(
                x, self.ln_1.weight, self.ln_1.bias,
                a.in_proj_weight.to(dtype), a.in_proj_bias,
                a.out_proj.weight.to(dtype), a.out_proj.bias, self.n_head,
                bias, kernels)
        if route:
            def packed_qkv(x):
                return F.linear(self.ln_1(x), a.in_proj_weight.to(dtype),
                                a.in_proj_bias.to(dtype))

            qkv = _checkpoint(packed_qkv, x) if lean else packed_qkv(x)
            out = fused_frame_attention(qkv, self.n_head, bias, kernels)
            return x + linear(out, a.out_proj, dtype)

        def einsum(x):
            out = mha(self.ln_1(x), a.in_proj_weight, a.in_proj_bias,
                      a.out_proj.weight, a.out_proj.bias, self.n_head, bias)
            return (x.float() + out).to(dtype)

        return _checkpoint(einsum, x) if lean else einsum(x)

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor],
                dtype: torch.dtype, kernels: bool = True,
                fused_attention: Union[bool, str] = "block",
                remat: Optional[str] = None) -> torch.Tensor:
        """x [N, L, D]; bias [N, L, L] fp32 or None.  remat: None saves
        every activation the backward wants; else one of REMAT_POLICIES
        (↔ layers.REMAT_POLICIES), which keep
          "full"  the block's input only: the whole block runs again in the
                  backward;
          "attn"  also the attention sublayer's output: the MLP runs again,
                  the attention kernel's forward does not;
          "dots"  the attention sublayer's output, the MLP's hidden
                  activation and its output: LayerNorms, the attention and
                  the first MLP product run again."""
        def attention(x, lean=False):
            return self.attention(x, bias, dtype, kernels, fused_attention,
                                  lean)

        def mlp_hidden(x):
            if self.tp is not None:
                return tensor.mlp_hidden(self, x, dtype)
            return self.mlp.hidden(self.ln_2(x), dtype)

        def mlp_out(x, hidden):
            if self.tp is not None:
                return tensor.mlp_out(self, x, hidden, dtype)
            return x + linear(hidden, self.mlp.c_proj, dtype)

        def mlp(x):
            return mlp_out(x, mlp_hidden(x))

        if remat is None:
            return mlp(attention(x))
        if remat == "full":
            return _checkpoint(lambda x: mlp(attention(x)), x)
        if remat == "attn":
            return _checkpoint(mlp, attention(x, lean=True))
        if remat == "dots":
            x = _checkpoint(attention, x)
            return mlp_out(x, _checkpoint(mlp_hidden, x))
        raise ValueError(f"remat policy {remat!r} is not one of "
                         f"{REMAT_POLICIES}")


def _checkpoint(fn, x):
    """fn(x) now, and again in the backward instead of keeping what it
    saved.  The towers draw no random numbers, so no generator state is
    kept."""
    return checkpoint(fn, x, use_reentrant=False, preserve_rng_state=False)


def attention_route(fused_attention: Union[bool, str], L: int,
                    on_cuda: bool) -> Union[bool, str]:
    """The route a sequence of length L takes: `fused_attention`, except
    that "block" past the sublayer kernel's longest sequence on the card
    goes one level down, to the attention kernel (↔ layers.block_apply past
    its own bound)."""
    if fused_attention not in (False, True, "block"):
        raise ValueError(f"fused_attention must be False, True or 'block', "
                         f"got {fused_attention!r}")
    if fused_attention == "block" and on_cuda and L > BLOCK_KERNEL_MAX_L:
        return True
    return fused_attention


class Transformer(nn.Module):
    """Stack of residual blocks (↔ layers.transformer_apply, its unrolled
    form: the loop over layers is always a Python loop here, so the JAX
    package's `unroll_layers` changes nothing)."""

    def __init__(self, width: int, layers: int, heads: int, device=None):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, device=device)
            for _ in range(layers))
        # this stage's slice, set by the pipeline placement
        self.stages: Optional[pipeline.StageSlice] = None

    def forward(self, x: torch.Tensor, attn_bias: Optional[torch.Tensor],
                dtype: torch.dtype, kernels: bool = True,
                fused_attention: Union[bool, str] = "block",
                remat: bool = False, remat_policy: str = "full",
                remat_skip_last: int = 0) -> torch.Tensor:
        """attn_bias: additive fp32 bias broadcastable to [N, 1, L, L]; it is
        expanded once to the per-sequence [N, L, L] the blocks take.
        remat: rematerialise each block in the backward by `remat_policy`,
        but for the last `remat_skip_last` blocks, which save everything
        (their activations die soonest in the backward)."""
        if remat and remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {remat_policy!r} is not one of "
                             f"{REMAT_POLICIES}")
        if self.stages is not None:
            return pipeline.pipeline_transformer_apply(
                self, x, attn_bias, dtype, kernels, fused_attention, remat,
                remat_policy, ctx=pipeline.current())
        bias = None
        if attn_bias is not None:
            N, L = x.shape[0], x.shape[1]
            bias = attn_bias.float().expand(N, 1, L, L)[:, 0].contiguous()
        remat = remat and torch.is_grad_enabled()
        n = len(self.resblocks)
        for i, block in enumerate(self.resblocks):
            policy = remat_policy if remat and i < n - remat_skip_last else None
            x = block(x, bias, dtype, kernels, fused_attention, policy)
        return x


def causal_bias(L: int, device=None) -> torch.Tensor:
    """[1, 1, L, L] additive causal mask."""
    i = torch.arange(L, device=device)
    m = torch.where(i[None, :] > i[:, None], NEG_INF, 0.0)
    return m.float()[None, None]


def padding_bias(mask: torch.Tensor) -> torch.Tensor:
    """[B, L] {0,1} key-padding mask → [B, 1, 1, L] additive bias."""
    return torch.where(mask[:, None, None, :] > 0, 0.0, NEG_INF).float()
