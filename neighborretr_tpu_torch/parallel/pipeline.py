"""GPipe pipeline parallelism over the mesh's `stage` axis (↔
neighborretr_tpu/parallel/pipeline.py).

A tower's blocks split into S contiguous slices, one a stage
(`shard_params_pp`, ↔ pp_param_shardings): a stage holds only its slice's
parameters (the other blocks are `nn.Identity` placeholders, so every held
parameter keeps its full-model name) and so only their moments.  A tower
whose depth does not divide S keeps all its blocks on every stage and runs
the plain path (↔ `supports`' silent fallback: the 4-layer temporal tower
under S = 3).  Under pipeline × tensor the slice's matrices are also split
over `model` (parallel/tensor.py).

The schedule (`pipeline_transformer_apply`, ↔ pipeline_transformer_apply):
the rank's rows split into M microbatches; stage 0 applies its slice to
each microbatch in turn and sends it on, every other stage takes it from
the stage before, applies its slice and sends it on, and the last stage
keeps the outputs, which a broadcast over `stage` then gives every stage
(↔ the psum that replicates them, `:277`).  One microbatch runs through
the stages in order, so the M + S − 1 ticks of GPipe are the overlap of
successive microbatches; a stage computes only the microbatches it holds
(the JAX program, one SPMD body, computes zeros in the bubble).  Each stage
holds the whole local bias, so a per-sample bias is cut with its
microbatch's rows and a constant one reaches every stage as it is.

The backward (`_Pipeline`) runs the reverse schedule: the last stage takes
the output cotangent it computed itself — every stage computes the same
loss, so the cotangents are already equal on every stage and the tower
gets one copy, not S — and each stage backpropagates each microbatch
through its slice (last microbatch first), sends the input cotangent to
the stage before, and returns its slice's parameter gradients; stage 0's
input cotangents are broadcast over `stage`, so the layers before the tower
get the same gradient on every stage (↔ the transpose of the replicated
input).  Each block rematerialises by the configured policy within a
microbatch (↔ `:228-233`); `remat_skip_last` shapes the plain path only.

Point-to-point transfers go through parallel/mesh.py's `isend` / `recv`
(through host memory over gloo, directly over NCCL).  Routing: a placed
tower (`Transformer.stages`) runs here; train/step.py activates the
context (`activated`) that sets M from `train.pipeline_microbatches`; other
callers (the bank fill, eval) run one microbatch.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional

import torch
from torch import nn

from . import mesh as pmesh


@dataclasses.dataclass(frozen=True)
class PipelineContext:
    mesh: pmesh.DataGroup
    stages: int
    microbatches: int
    stage_axis: str = "stage"


_ACTIVE: Optional[PipelineContext] = None


def current() -> Optional[PipelineContext]:
    return _ACTIVE


@contextlib.contextmanager
def activated(ctx: Optional[PipelineContext]):
    """Run placed towers with ctx's microbatches while inside."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = ctx
    try:
        yield
    finally:
        _ACTIVE = prev


@dataclasses.dataclass(frozen=True)
class StageSlice:
    """A placed tower's mesh and stage count."""
    mesh: pmesh.DataGroup
    stages: int


def supports(stages: int, n_layers: int) -> bool:
    """Whether a tower of n_layers runs the pipeline over `stages` stages
    (↔ supports): a depth that does not divide is a silent fallback to
    the plain path, with every block on every stage."""
    return stages > 1 and n_layers % stages == 0


def shard_params_pp(model: nn.Module, mesh: pmesh.DataGroup,
                    params: Dict[str, object]) -> None:
    """Each tower whose depth divides the stage count keeps only this
    stage's slice of blocks (↔ pp_param_shardings): the others become
    placeholders, and `params` (name → mesh.Placement) records the stage
    that holds each block's parameters."""
    from ..models.layers import Transformer
    S, s = mesh.size("stage"), mesh.coord("stage")
    for prefix, tower in list(model.named_modules()):
        if not isinstance(tower, Transformer):
            continue
        n = len(tower.resblocks)
        if not supports(S, n):
            continue
        per = n // S
        for i in range(n):
            for name in tower.resblocks[i].state_dict():
                key = f"{prefix}.resblocks.{i}.{name}"
                params[key] = dataclasses.replace(params[key], stage=i // per)
            if i // per != s:
                tower.resblocks[i] = nn.Identity()
        tower.stages = StageSlice(mesh, S)


def _check(tower, x, attn_bias, ctx: PipelineContext, M: int):
    """The JAX package's errors (`:197-216`)."""
    mesh = ctx.mesh
    S = ctx.stages
    if mesh.size(ctx.stage_axis) != S:
        raise ValueError(
            f"PipelineContext(stages={S}) does not match the mesh's "
            f"'{ctx.stage_axis}' axis of size {mesh.size(ctx.stage_axis)}")
    n_layers = len(tower.resblocks)
    if n_layers % S:
        raise ValueError(f"{n_layers} layers do not divide into {S} stages")
    N = x.shape[0]
    dp = mesh.dp_size
    if N % M:
        raise ValueError(
            f"rows {N * dp} must divide by data×microbatches = {dp}×{M} "
            f"(pipeline_microbatches; got N_local {N} per shard)")
    if attn_bias is not None and attn_bias.shape[0] not in (1, N):
        raise ValueError(f"attn_bias leading dim {attn_bias.shape[0]} must "
                         f"be 1 or match rows {N}")


class _Schedule:
    """One call's GPipe schedule on this stage: the forward keeps each
    microbatch's input and output (with its graph, under autograd) for the
    backward."""

    def __init__(self, blocks: List[nn.Module], bias, M: int, ctx, block_kw):
        mesh = ctx.mesh
        self.blocks, self.bias, self.M, self.kw = blocks, bias, M, block_kw
        self.mesh, self.S = mesh, ctx.stages
        self.s = mesh.coord(ctx.stage_axis)
        self.axis = ctx.stage_axis
        self.group = mesh.group(ctx.stage_axis)
        self.inputs, self.outputs = [], []

    def _peer(self, stage: int) -> int:
        return self.mesh.peer(self.axis, stage)

    def _apply(self, x, m: int, mb: int):
        bias = None if self.bias is None else self.bias[m * mb:(m + 1) * mb]
        for block in self.blocks:
            x = block(x, bias, **self.kw)
        return x

    def forward(self, x: torch.Tensor, keep: bool) -> torch.Tensor:
        S, s, M = self.S, self.s, self.M
        N = x.shape[0]
        mb = N // M
        dtype = self.kw["dtype"]
        shape = (mb,) + tuple(x.shape[1:])
        sends, outs = [], []
        for m in range(M):
            inp = (x[m * mb:(m + 1) * mb] if s == 0 else
                   pmesh.recv(shape, dtype, self._peer(s - 1), x.device,
                              self.group))
            if keep:
                inp = inp.detach().requires_grad_(True)
            y = self._apply(inp, m, mb)
            if keep:
                self.inputs.append(inp)
                self.outputs.append(y)
            if s < S - 1:
                sends.append(pmesh.isend(y, self._peer(s + 1), self.group))
            else:
                outs.append(y.detach())
        for work, _ in sends:
            work.wait()
        out = (torch.cat(outs) if s == S - 1 else
               torch.empty((N,) + tuple(x.shape[1:]), dtype=dtype,
                           device=x.device))
        torch.distributed.broadcast(out, src=self._peer(S - 1),
                                    group=self.group)
        return out

    def backward(self, g: torch.Tensor, x_like: torch.Tensor, params):
        S, s, M = self.S, self.s, self.M
        mb = g.shape[0] // M
        grads = [torch.zeros_like(p) for p in params]
        gx, sends = [None] * M, []
        for m in reversed(range(M)):
            gy = (g[m * mb:(m + 1) * mb] if s == S - 1 else
                  pmesh.recv(self.outputs[m].shape, self.outputs[m].dtype,
                             self._peer(s + 1), g.device, self.group))
            got = torch.autograd.grad(self.outputs[m],
                                      [self.inputs[m]] + list(params),
                                      gy.to(self.outputs[m].dtype),
                                      allow_unused=True)
            for acc, gp in zip(grads, got[1:]):
                if gp is not None:
                    acc.add_(gp)
            if s > 0:
                sends.append(pmesh.isend(got[0], self._peer(s - 1),
                                         self.group))
            else:
                gx[m] = got[0]
            self.inputs[m] = self.outputs[m] = None
        for work, _ in sends:
            work.wait()
        out = (torch.cat(gx) if s == 0 else torch.empty_like(x_like))
        torch.distributed.broadcast(out, src=self._peer(0), group=self.group)
        return out, grads


class _Pipeline(torch.autograd.Function):
    """The schedule as one autograd node: inputs x and the stage's
    parameters, gradients from the reverse schedule."""

    @staticmethod
    def forward(ctx, run: _Schedule, x, *params):
        ctx.run, ctx.params = run, params
        ctx.save_for_backward(x)
        with torch.enable_grad():
            return run.forward(x, keep=True)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        gx, grads = ctx.run.backward(g.contiguous(), x, ctx.params)
        ctx.run = ctx.params = None
        return (None, gx, *grads)


def pipeline_transformer_apply(tower, x: torch.Tensor, attn_bias,
                               dtype: torch.dtype, kernels: bool = True,
                               fused_attention="block", remat: bool = False,
                               remat_policy: str = "full",
                               ctx: Optional[PipelineContext] = None
                               ) -> torch.Tensor:
    """Run a tower (layers.Transformer: placed, or holding every block) as
    an S-stage GPipe pipeline on this rank's rows.

    x: [N, L, D] this rank's rows, the same on every stage; attn_bias:
    None, [1, 1, L, L] (constant) or [N, 1, *, L] (per sample).  ctx:
    stages and microbatches; None → the tower's placement with one
    microbatch.  Returns the tower's output [N, L, D] in `dtype` on every
    stage; semantics of Transformer.forward modulo fp reordering."""
    if ctx is None:
        sl = tower.stages
        ctx = PipelineContext(mesh=sl.mesh, stages=sl.stages, microbatches=1)
    M = ctx.microbatches
    _check(tower, x, attn_bias, ctx, M)
    N, L = x.shape[0], x.shape[1]
    bias = None
    if attn_bias is not None:
        bias = attn_bias.float().expand(N, 1, L, L)[:, 0].contiguous()
    per = len(tower.resblocks) // ctx.stages
    s = ctx.mesh.coord(ctx.stage_axis)
    blocks = list(tower.resblocks)[s * per:(s + 1) * per]
    keep = torch.is_grad_enabled()
    kw = dict(dtype=dtype, kernels=kernels, fused_attention=fused_attention,
              remat=remat_policy if remat and keep else None)
    run = _Schedule(blocks, bias, M, ctx, kw)
    if not keep:
        return run.forward(x, keep=False)
    params = [p for b in blocks for p in b.parameters() if p.requires_grad]
    return _Pipeline.apply(run, x, *params)
