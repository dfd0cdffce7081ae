"""The data-parallel group over `torch.distributed` (↔ neighborretr_tpu/
parallel/mesh.py, its `data` axis).

The JAX package runs one SPMD program over a 1-D `data` mesh.  The port
runs one process per device, PyTorch's idiom: every rank holds the whole
model, takes a contiguous block of each global batch (the loader cuts it,
data/loader.py `process_index` / `process_count`) and meets the others in
collectives: the differentiable all-gather of features (`all_gather`, the
counterpart of `jax.lax.all_gather(tiled=True)`, whose transpose is a
psum-scatter), the gradient all-reduce (`all_reduce_grads`), a broadcast
from rank 0 at start (`replicate`).

Gradient convention: every rank computes the global loss on gathered
tensors, so the gather's backward sums the cotangent over ranks before it
takes the rank's slice, and the parameter gradients are then averaged.  A
parameter behind the gather (CTM, the weight nets, the logit scale) gets
the same full gradient on every rank; a parameter before it (the towers)
gets W times its rank's share; the mean over ranks is the one-process
gradient in both cases.

Only the data axis is ported: FSDP, tensor and pipeline parallelism and
the hybrid mesh hold the model sharded and are slice 13 of ROADMAP.md's
queue 1 (`place_params(fsdp=True)` raises).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """This rank's place in the data-parallel group (the default process
    group).  `collective` is False for a one-process group made without
    `torch.distributed`: every collective below is then the identity, and
    the step takes the single-device path.  `axis_names` mirrors the JAX
    mesh's axes (the port's group is 1-D)."""
    rank: int = 0
    world: int = 1
    device: torch.device = torch.device("cpu")
    collective: bool = False
    axis_names: Tuple[str, ...] = ("data",)


def take_devices(n: int, kind: str = "cuda") -> List[torch.device]:
    """The first n devices of `kind` (n CPU "devices" are the CPU n times),
    with a clear error instead of running on fewer than asked."""
    if n < 1:
        raise ValueError(f"requested {n} devices")
    if kind == "cpu":
        return [torch.device("cpu")] * n
    count = torch.cuda.device_count()
    if n > count:
        raise ValueError(f"requested {n} devices but only {count} are "
                         "visible — refusing to silently run on fewer")
    return [torch.device(kind, i) for i in range(n)]


def rank_device(device, rank: int) -> torch.device:
    """A rank's device: `cuda` without an index is the rank's own card
    (rank modulo the visible cards, one process per card on a host); an
    explicit device is kept."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))
    return dev


def make_mesh(device=None) -> DataGroup:
    """The group of this process: the initialised process group's rank and
    world size, or a one-process group without `torch.distributed`."""
    collective = dist.is_available() and dist.is_initialized()
    rank = dist.get_rank() if collective else 0
    world = dist.get_world_size() if collective else 1
    dev = rank_device(device if device is not None else "cuda", rank)
    return DataGroup(rank=rank, world=world, device=dev,
                     collective=collective)


def batch_block(batch: Dict[str, Any], mesh: DataGroup) -> Dict[str, Any]:
    """This rank's contiguous block of a GLOBAL batch (↔ shard_batch); the
    host-only `global_*` keys are dropped."""
    out = {}
    for k, v in batch.items():
        if k.startswith("global_"):
            continue
        per = v.shape[0] // mesh.world
        out[k] = v[mesh.rank * per:(mesh.rank + 1) * per]
    return out


@torch.no_grad()
def replicate(model: torch.nn.Module, mesh: DataGroup) -> torch.nn.Module:
    """Every parameter and buffer broadcast from rank 0 (↔ replicate_tree):
    the ranks start from the same bits whatever each one initialised."""
    if mesh.collective:
        for t in list(model.parameters()) + list(model.buffers()):
            dist.broadcast(t.data, src=0)
    return model


def place_params(model: torch.nn.Module, mesh: DataGroup,
                 fsdp: bool = False) -> torch.nn.Module:
    """Parameter placement on the data group: replicated (↔ place_params
    on a data mesh).  Sharded placements are not ported."""
    if fsdp:
        raise NotImplementedError(
            "not ported to PyTorch yet: fsdp (parameters sharded over the "
            "data axis; FSDP2, tensor and pipeline parallelism are slice 13 "
            "of ROADMAP.md's queue 1)")
    return replicate(model, mesh)


def fetch_to_host(tree):
    """Host (numpy) copy of a nested dict of tensors (↔ fetch_to_host).
    The port's state is replicated, so every leaf reads locally; bf16
    leaves widen to fp32, which holds them exactly (npz has no bf16)."""
    if isinstance(tree, dict):
        return {k: fetch_to_host(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy().copy()
    return np.array(tree, copy=True)


def _gather_raw(x: torch.Tensor, mesh: DataGroup) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(mesh.world)]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


class _AllGather(torch.autograd.Function):
    """Tiled all-gather along axis 0; backward: the cotangent summed over
    ranks (all-reduce), then this rank's rows — the transpose of the
    gather, as JAX's psum_scatter is (an all-reduce and a slice, because
    gloo lacks reduce-scatter in many builds)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _gather_raw(x, mesh)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        g = g.contiguous().clone()
        dist.all_reduce(g)
        per = g.shape[0] // mesh.world
        return g[mesh.rank * per:(mesh.rank + 1) * per], None


def all_gather(x: torch.Tensor, mesh: DataGroup) -> torch.Tensor:
    """[n, ...] on each rank → [world·n, ...] in rank order, differentiable
    (see `_AllGather`); the identity without collectives."""
    if not mesh.collective:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllGather.apply(x, mesh)
    return _gather_raw(x, mesh)


def all_reduce_grads(params: Dict[str, torch.Tensor], mesh: DataGroup
                     ) -> Dict[str, torch.Tensor]:
    """The mean over ranks of each parameter's `.grad` (a zero where the
    loss did not reach it), in one all-reduce over a flat fp32 buffer;
    every rank gets the same bits back."""
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in params.items()}
    if not mesh.collective:
        return grads
    names = list(grads)
    flat = torch.cat([grads[n].reshape(-1).float() for n in names])
    dist.all_reduce(flat)
    flat.div_(mesh.world)
    out, off = {}, 0
    for n in names:
        g = grads[n]
        out[n] = flat[off:off + g.numel()].view_as(g).to(g.dtype)
        off += g.numel()
    return out


def any_rank(flag: bool, mesh: DataGroup) -> bool:
    """True on every rank if it is True on any (an all-reduce MAX): a stop
    that one rank sees reaches all of them at the same step boundary."""
    if not mesh.collective:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def broadcast_object(obj, mesh: DataGroup):
    """Rank 0's `obj` on every rank (a picklable value)."""
    if not mesh.collective:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, device=mesh.device)
    return box[0]
