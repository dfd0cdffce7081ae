"""The device mesh over `torch.distributed` (↔ neighborretr_tpu/parallel/
mesh.py, and the mesh builders of its pipeline.py).

The JAX package runs one SPMD program over a mesh with named axes.  The
port runs one process per device, PyTorch's idiom, and gives each process
its coordinates on the same named axes:
  data, replica  the data axes: each rank takes a contiguous block of each
                 global batch (the loader cuts it, data/loader.py
                 `process_index` / `process_count` = `dp_rank` / `dp_size`),
                 and batches replicate over the other axes (↔
                 batch_sharding);
  model          Megatron tensor parallelism (parallel/tensor.py): each
                 block's matrices split by heads and hidden units;
  stage          GPipe pipeline parallelism (parallel/pipeline.py): each
                 tower's blocks split into contiguous slices.
Each axis has one process group per line of ranks along it, and `dp` one
per line along all data axes together; the ranks meet in collectives over
them: the differentiable all-gather of features over `dp` (`all_gather`,
the counterpart of `jax.lax.all_gather(tiled=True)`, whose transpose is a
psum-scatter), the gradient mean over `dp` (`all_reduce_grads`), a
broadcast from rank 0 at start (`replicate`).

Gradient convention: every rank computes the global loss on gathered
tensors, so the gather's backward sums the cotangent over the data ranks
before it takes the rank's slice, and the parameter gradients are then
averaged over the data axes.  A parameter behind the gather (CTM, the
weight nets, the logit scale) gets the same full gradient on every rank; a
parameter before it (the towers) gets dp times its rank's share; the mean
over the data ranks is the one-process gradient in both cases.  A rank of
another `model` or `stage` coordinate computes the same loss from the same
features, so a replicated parameter's gradient is never summed over those
axes (its mean over them changes no value: `all_reduce_grads`).

Placement (`place_params`, ↔ place_params): replicated on a data mesh;
FSDP2 (`fsdp=True`, torch.distributed.fsdp.fully_shard on every residual
block and on the model, over the data axes); the Megatron split on a mesh
with a `model` axis; stage slices on a mesh with a `stage` axis (both on a
data × stage × model mesh).  FSDP2 shards dimension 0 of each parameter in
the port's layout where the JAX rule takes its largest divisible dimension:
that is placement only, the arithmetic is the same.  Each parameter's
placement is recorded on the model (`ModelPlacement`), and the gathers and
cuts between full and local tensors (`gather_full`, `local_piece`) follow
it: checkpoints are written and read in the full JAX layout whatever the
placement.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

NON_DATA_AXES = ("model", "stage")


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """This rank's place in the mesh of processes.  `collective` is False
    for a one-process group made without `torch.distributed`: every
    collective below is then the identity, and the step takes the
    single-device path.  `axis_names` and `shape` name and size the mesh's
    axes (row-major over the ranks; an empty shape is the 1-D (world,));
    `groups` holds this rank's process group along every combination of
    axes (a missing entry is the default group)."""
    rank: int = 0
    world: int = 1
    device: torch.device = torch.device("cpu")
    collective: bool = False
    axis_names: Tuple[str, ...] = ("data",)
    shape: Tuple[int, ...] = ()
    groups: Dict[str, Any] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape or (self.world,)))

    def size(self, axis: str) -> int:
        return self.sizes.get(axis, 1)

    def coord(self, axis: str) -> int:
        """This rank's index along `axis` (0 off the mesh)."""
        if axis not in self.axis_names:
            return 0
        sizes = list(self.sizes.values())
        i = self.axis_names.index(axis)
        return self.rank // math.prod(sizes[i + 1:]) % sizes[i]

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.axis_names if a not in NON_DATA_AXES)

    @property
    def dp_size(self) -> int:
        return math.prod(self.size(a) for a in self.dp_axes)

    @property
    def dp_rank(self) -> int:
        r = 0
        for a in self.dp_axes:
            r = r * self.size(a) + self.coord(a)
        return r

    def group(self, axes: Union[str, Tuple[str, ...]]):
        """The process group of this rank's line along `axes` (one axis
        name, "dp" for every data axis, or a tuple of names in mesh
        order); None for the default group."""
        if axes == "dp":
            axes = self.dp_axes
        elif isinstance(axes, str):
            axes = (axes,)
        return self.groups.get(tuple(axes))

    def peer(self, axis: str, index: int) -> int:
        """The global rank at `index` along `axis`, every other coordinate
        this rank's."""
        sizes = list(self.sizes.values())
        stride = math.prod(sizes[self.axis_names.index(axis) + 1:])
        return self.rank + (index - self.coord(axis)) * stride


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


def _axis_groups(shape: Tuple[int, ...], axes: Tuple[str, ...]
                 ) -> Dict[Tuple[str, ...], Any]:
    """This rank's group along every combination of axes (keyed by the axis
    names in mesh order).  Every rank creates every group, in the same
    order."""
    ranks = np.arange(math.prod(shape)).reshape(shape)
    out = {}
    for k in range(1, len(axes) + 1):
        for along in itertools.combinations(range(len(axes)), k):
            rest = [i for i in range(len(axes)) if i not in along]
            lines = np.transpose(ranks, rest + list(along)).reshape(
                -1, math.prod(shape[i] for i in along))
            out[tuple(axes[i] for i in along)], _ = \
                dist.new_subgroups_by_enumeration(lines.tolist())
    return out


def make_mesh(device=None, shape: Optional[Tuple[int, ...]] = None,
              axis_names: Tuple[str, ...] = ("data",)) -> DataGroup:
    """The mesh of this process over the initialised process group (a
    one-process group without `torch.distributed`): `shape` sizes
    `axis_names` (default: the 1-D data axis over every rank).  The JAX
    package's builders are this with their axes: make_tp_mesh ("data",
    "model"), make_hybrid_mesh ("replica", "data": data parallelism over
    both, the outer axis the one meant to cross the slower interconnect),
    make_pp_mesh ("data", "stage"), make_pp_tp_mesh ("data", "stage",
    "model": `model` innermost, so a stage's model ranks are
    neighbours)."""
    collective = dist.is_available() and dist.is_initialized()
    rank = dist.get_rank() if collective else 0
    world = dist.get_world_size() if collective else 1
    shape = tuple(shape) if shape is not None else (world,)
    if len(shape) != len(axis_names) or math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} over axes {axis_names} does "
                         f"not cover the {world} ranks")
    dev = rank_device(device if device is not None else "cuda", rank)
    groups = (_axis_groups(shape, tuple(axis_names))
              if collective and len(shape) > 1 else {})
    return DataGroup(rank=rank, world=world, device=dev,
                     collective=collective, axis_names=tuple(axis_names),
                     shape=shape if len(shape) > 1 else (),
                     groups=groups)


def batch_block(batch: Dict[str, Any], mesh: DataGroup) -> Dict[str, Any]:
    """This rank's contiguous block of a GLOBAL batch over the data axes
    (↔ shard_batch); the host-only `global_*` keys are dropped."""
    out = {}
    for k, v in batch.items():
        if k.startswith("global_"):
            continue
        per = v.shape[0] // mesh.dp_size
        out[k] = v[mesh.dp_rank * per:(mesh.dp_rank + 1) * per]
    return out


@torch.no_grad()
def replicate(model: torch.nn.Module, mesh: DataGroup) -> torch.nn.Module:
    """Every parameter and buffer broadcast from rank 0 (↔ replicate_tree):
    the ranks start from the same bits whatever each one initialised."""
    if mesh.collective:
        for t in list(model.parameters()) + list(model.buffers()):
            dist.broadcast(t.data, src=0)
    return model


# ---------------------------------------------------------------------------
# Placement: where each parameter lives, and the moves between full and
# local tensors
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Placement:
    """One parameter of the full model: its full shape, its split over
    `model` ("qkv": rows of each of q, k and v; "rows": dim 0; "cols":
    dim 1; "": none) in whole units of `tp_unit` rows or columns (a head's
    width for the attention's, 1 for the MLP's; see `tp_share`), the stage
    that holds it (None: every stage), and whether FSDP2 cuts its dim 0
    over the data axes."""
    shape: Tuple[int, ...]
    tp: str = ""
    stage: Optional[int] = None
    fsdp: bool = False
    tp_unit: int = 1


@dataclasses.dataclass
class ModelPlacement:
    """The mesh a model is placed on and each parameter's Placement, in
    the full model's parameter order (the order of every collective over
    them)."""
    mesh: DataGroup
    params: Dict[str, Placement]


def placement_of(model) -> Optional[ModelPlacement]:
    return getattr(model, "placement", None)


def local(t: torch.Tensor) -> torch.Tensor:
    """A parameter's local tensor: an FSDP2 DTensor's shard, else itself."""
    return t.to_local() if hasattr(t, "to_local") else t


def _dim0_chunk(t: torch.Tensor, n: int, i: int) -> torch.Tensor:
    """Chunk i of n along dim 0 as FSDP2 cuts it (torch.chunk's sizes,
    empty past the last chunk)."""
    chunks = torch.chunk(t, n, dim=0)
    return chunks[i] if i < len(chunks) else t[:0]


def tp_share(units: int, n: int, i: int) -> Tuple[int, int]:
    """(first unit, units) of model rank i of n over `units` whole units
    (heads, hidden units): ⌈units/n⌉ for the first units mod n ranks,
    ⌊units/n⌋ for the rest (a rank may get none)."""
    per, extra = divmod(units, n)
    return i * per + min(i, extra), per + (i < extra)


def _tp_view(t: torch.Tensor, kind: str) -> Tuple[torch.Tensor, int]:
    """The view of a split tensor that the ranks cut and its cut
    dimension: [3, E, ...] along dim 1 for "qkv", else the tensor along
    dim 0 ("rows") or 1 ("cols")."""
    if kind == "qkv":
        return t.reshape(3, t.shape[0] // 3, *t.shape[1:]), 1
    return t, 0 if kind == "rows" else 1


def _tp_cut(t: torch.Tensor, kind: str, n: int, i: int,
            unit: int = 1) -> torch.Tensor:
    if kind not in ("qkv", "rows", "cols"):
        return t
    v, dim = _tp_view(t, kind)
    start, size = tp_share(v.shape[dim] // unit, n, i)
    piece = v.narrow(dim, start * unit, size * unit)
    return piece.reshape(-1, *t.shape[1:]) if kind == "qkv" else piece


def local_piece(full: torch.Tensor, pl: Placement,
                mesh: DataGroup) -> torch.Tensor:
    """This rank's part of a full tensor under `pl` (contiguous)."""
    t = _tp_cut(full, pl.tp, mesh.size("model"), mesh.coord("model"),
                pl.tp_unit)
    if pl.fsdp:
        t = _dim0_chunk(t, mesh.dp_size, mesh.dp_rank)
    return t.contiguous()


def _local_shape(pl: Placement, mesh: DataGroup) -> Tuple[int, ...]:
    return tuple(local_piece(torch.empty(pl.shape, device="meta"), pl,
                             mesh).shape)


def _gather_tp(t: torch.Tensor, pl: Placement,
               mesh: DataGroup) -> torch.Tensor:
    """The full tensor from the model ranks' pieces, which may differ in
    size (`tp_share`): each padded to the largest along the cut dimension,
    one all-gather, each trimmed back."""
    n = mesh.size("model")
    v, dim = _tp_view(t, pl.tp)
    full, _ = _tp_view(torch.empty(pl.shape, device="meta"), pl.tp)
    units = full.shape[dim] // pl.tp_unit
    sizes = [tp_share(units, n, i)[1] * pl.tp_unit for i in range(n)]
    pad = [0, 0] * (v.ndim - 1 - dim) + [0, max(sizes) - v.shape[dim]]
    buf = torch.nn.functional.pad(v, pad).contiguous()
    parts = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(parts, buf, group=mesh.group("model"))
    return torch.cat([p.narrow(dim, 0, k) for p, k in zip(parts, sizes)],
                     dim=dim).reshape(pl.shape)


def _gather_dim0(t: torch.Tensor, rows: int, mesh: DataGroup) -> torch.Tensor:
    """The inverse of FSDP2's dim-0 chunks: each rank's chunk padded to
    the first chunk's size, one all-gather, the padding dropped."""
    n = mesh.dp_size
    per = -(-rows // n)
    buf = t.new_zeros((per,) + tuple(t.shape[1:]))
    buf[:t.shape[0]] = t
    out = t.new_empty((n * per,) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, buf.contiguous(), group=mesh.group("dp"))
    return out[:rows]


@torch.no_grad()
def gather_full(named: Dict[str, torch.Tensor], placement: ModelPlacement,
                to_host: bool = True) -> Dict[str, torch.Tensor]:
    """The full tensors of a placed model's per-parameter tensors (its
    parameters, their moments or gradients, by parameter name): stage
    slices broadcast from the stage that holds them, `model` splits
    all-gathered and reassembled, FSDP2 chunks all-gathered.  A collective:
    every rank calls it, and every rank gets every tensor (on the host when
    `to_host`, fp32 widened from bf16 there as npz needs)."""
    mesh = placement.mesh
    out = {}
    for name, pl in placement.params.items():
        t = named.get(name)
        t = local(t).detach() if t is not None else None
        if pl.stage is not None and mesh.size("stage") > 1:
            held = mesh.coord("stage") == pl.stage
            buf = t.contiguous() if held else torch.empty(
                _local_shape(pl, mesh), dtype=_dtype_like(named),
                device=mesh.device)
            dist.broadcast(buf, src=mesh.peer("stage", pl.stage),
                           group=mesh.group("stage"))
            t = buf
        if pl.fsdp:
            t = _gather_dim0(t, pl.shape[0] if pl.shape else 1, mesh)
        if pl.tp and mesh.size("model") > 1:
            t = _gather_tp(t, pl, mesh)
        t = t.reshape(pl.shape)
        if to_host:
            t = t.cpu()
            if t.dtype == torch.bfloat16:
                t = t.float()
        out[name] = t
    return out


def _dtype_like(named: Dict[str, torch.Tensor]) -> torch.dtype:
    return next(iter(named.values())).dtype


def full_state_dict(model) -> Dict[str, torch.Tensor]:
    """The model's full parameters by name, on the host: gathered under a
    placement (a collective, every rank calls it), else its own."""
    pl = placement_of(model)
    if pl is None:
        return {k: v.detach() for k, v in model.state_dict().items()}
    return gather_full(dict(model.named_parameters()), pl)


@torch.no_grad()
def load_full_state_dict(model, sd: Dict[str, Any]) -> None:
    """Copy full tensors (by parameter name) into the model: each rank's
    part under its placement, or the whole tensor without one."""
    pl = placement_of(model)
    for name, p in model.named_parameters():
        full = torch.as_tensor(sd[name])
        piece = full if pl is None else local_piece(full, pl.params[name],
                                                    pl.mesh)
        local(p).copy_(piece)


def local_like(named_full: Dict[str, Any], like: Dict[str, torch.Tensor],
               placement: Optional[ModelPlacement]
               ) -> Dict[str, torch.Tensor]:
    """Each tensor of `like` (by parameter name) from the full tensors:
    the rank's part, on like's device and in its dtype."""
    out = {}
    for name, t in like.items():
        full = torch.as_tensor(named_full[name])
        if placement is not None:
            full = local_piece(full, placement.params[name], placement.mesh)
        out[name] = full.to(device=t.device, dtype=t.dtype)
    return out


def place_params(model: torch.nn.Module, mesh: DataGroup,
                 fsdp: bool = False) -> torch.nn.Module:
    """Parameter placement on the mesh (↔ place_params): the ranks first
    take rank 0's parameters, then FSDP2 over the data axes when `fsdp`,
    the Megatron split when the mesh has a `model` axis, the stage slices
    when it has a `stage` axis, replication otherwise.  Records each
    parameter's placement on the model (`model.placement`) when any is
    sharded."""
    sharding_axes = [a for a in NON_DATA_AXES if mesh.size(a) > 1]
    if fsdp and sharding_axes:
        raise ValueError("fsdp applies to pure data-parallel meshes "
                         "(tensor/pipeline parallelism shard params "
                         "through their own rules)")
    replicate(model, mesh)
    if not (sharding_axes or (fsdp and mesh.dp_size > 1)):
        return model
    params = {n: Placement(tuple(p.shape))
              for n, p in model.named_parameters()}
    if fsdp:
        _shard_fsdp(model, mesh, params)
    if "model" in sharding_axes:
        from .tensor import shard_params_tp
        shard_params_tp(model, mesh, params)
    if "stage" in sharding_axes:
        from .pipeline import shard_params_pp
        shard_params_pp(model, mesh, params)
    model.placement = ModelPlacement(mesh, params)
    return model


def _shard_fsdp(model, mesh: DataGroup, params: Dict[str, Placement]):
    """FSDP2 over the data axes: `fully_shard` on every residual block
    (unsharded just before its forward and again in the backward, the
    remat policies' recomputation included) and on the model, whose
    forward (models/neighborretr.py::NeighborRetr.forward) wraps each
    step's computation.  The scalar logit scale, which fully_shard does
    not take, stays replicated and is averaged as on a data mesh.  FSDP2
    gets a process group of its own, so that its collectives, issued from
    its own streams, never interleave with the step's.  Over gloo on CUDA
    tensors FSDP2's own all-gathers and reduce-scatters work (tools/
    collectives_probe.py); DTensor's `full_tensor` does not, and the port
    never calls it (`gather_full` gathers instead)."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.fsdp import fully_shard

    from ..models.layers import ResidualAttentionBlock
    group = dist.new_group(list(range(mesh.world)))
    dm = DeviceMesh.from_group(group, mesh.device.type)
    blocks = [m for m in model.modules()
              if isinstance(m, ResidualAttentionBlock)]
    for module in blocks:
        fully_shard(module, mesh=dm)
    scalars = {p for p in model.parameters() if p.dim() == 0}
    fully_shard(model, mesh=dm, reshard_after_forward=True,
                ignored_params=scalars)

    for name, p in model.named_parameters():
        if p.dim() > 0:
            params[name] = dataclasses.replace(params[name], fsdp=True)


def fetch_to_host(tree):
    """Host (numpy) copy of a nested dict of full tensors (↔
    fetch_to_host); a placed model's shards are gathered into full tensors
    first by `gather_full` (its own collectives: DTensor's `full_tensor`
    over gloo on CUDA tensors ends the process, seen with torch 2.11).
    bf16 leaves widen to fp32, which holds them exactly (npz has no
    bf16)."""
    if isinstance(tree, dict):
        return {k: fetch_to_host(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy().copy()
    return np.array(tree, copy=True)


# ---------------------------------------------------------------------------
# Collectives over the data axes
# ---------------------------------------------------------------------------

def _gather_raw(x: torch.Tensor, mesh: DataGroup) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(mesh.dp_size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group("dp"))
    return torch.cat(parts)


class _AllGather(torch.autograd.Function):
    """Tiled all-gather along axis 0 over the data axes; backward: the
    cotangent summed over the data ranks (all-reduce), then this rank's
    rows — the transpose of the gather, as JAX's psum_scatter is (an
    all-reduce and a slice, one collective every backend has)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _gather_raw(x, mesh)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        g = g.contiguous().clone()
        dist.all_reduce(g, group=mesh.group("dp"))
        per = g.shape[0] // mesh.dp_size
        return g[mesh.dp_rank * per:(mesh.dp_rank + 1) * per], None


def all_gather(x: torch.Tensor, mesh: DataGroup) -> torch.Tensor:
    """[n, ...] on each data rank → [dp·n, ...] in data-rank order,
    differentiable (see `_AllGather`); the identity without collectives."""
    if not mesh.collective:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllGather.apply(x, mesh)
    return _gather_raw(x, mesh)


def all_reduce_grads(params: Dict[str, torch.Tensor], mesh: DataGroup,
                     placement: Optional[ModelPlacement] = None
                     ) -> Dict[str, torch.Tensor]:
    """The mean over the data ranks of each parameter's `.grad` (a zero
    where the loss did not reach it), in an all-reduce over a flat fp32
    buffer; every rank gets the same bits back.  An FSDP2 parameter's
    gradient arrives reduce-scattered (its shard of the mean already) and
    is taken as it is.  Every other gradient is averaged over the ranks
    that hold the same tensor: the data ranks, and those of other `model`
    coordinates unless it is split over `model`, and of other stages
    unless one stage holds it.  Those of other `model` and `stage`
    coordinates hold the same gradient up to the order of the loss code's
    float atomics (torch's scatter-adds on the card), and the mean over
    them keeps the replicas bit-equal; over the data ranks it is the mean
    above.  The local tensors are returned."""
    grads = {n: local(p.grad) if p.grad is not None
             else torch.zeros_like(local(p)) for n, p in params.items()}
    if not mesh.collective:
        return grads
    pls = placement.params if placement is not None else {}

    def replicas(n):
        """The axes along which the ranks hold this very tensor: the data
        axes, `model` unless it is split there, `stage` unless one stage
        holds it."""
        pl = pls.get(n)
        return tuple(a for a in mesh.axis_names if pl is None or not (
            (a == "model" and pl.tp) or (a == "stage"
                                         and pl.stage is not None)))

    buckets: Dict[Tuple[str, ...], List[str]] = {}
    for n, p in params.items():
        if not hasattr(p, "to_local"):
            buckets.setdefault(replicas(n), []).append(n)
    for axes, names in buckets.items():
        size = math.prod(mesh.size(a) for a in axes)
        group = mesh.group(axes) if len(axes) < len(mesh.axis_names) \
            else None
        if size == 1:
            continue
        flat = torch.cat([grads[n].reshape(-1).float() for n in names])
        dist.all_reduce(flat, group=group)
        flat.div_(size)
        off = 0
        for n in names:
            g = grads[n]
            grads[n] = flat[off:off + g.numel()].view_as(g).to(g.dtype)
            off += g.numel()
    return grads


def squares_over_shards(names: List[str], sq: torch.Tensor,
                        placement: Optional[ModelPlacement]):
    """(each leaf's sum of squares over its whole tensor, the sum over
    all leaves) from each leaf's local sum `sq` [len(names)] fp32: a leaf
    split over `model` or by FSDP2 is summed over its shards, each exactly
    once; the leaves of one stage are summed over the stages for the
    total; a replicated leaf counts once.  Every rank gets the same
    values."""
    if placement is None:
        return sq, sq.sum()
    mesh, pls = placement.mesh, placement.params
    full = sq.clone()
    for axis, split in (("model", lambda p: bool(p.tp)),
                        ("dp", lambda p: p.fsdp)):
        idx = [i for i, n in enumerate(names) if split(pls[n])]
        if idx and (mesh.size(axis) if axis != "dp" else mesh.dp_size) > 1:
            part = full[idx].contiguous()
            dist.all_reduce(part, group=mesh.group(axis))
            full[idx] = part
    staged = torch.tensor([pls[n].stage is not None for n in names],
                          device=sq.device)
    total = full[~staged].sum()
    if mesh.size("stage") > 1:
        part = full[staged].sum().reshape(1)
        dist.all_reduce(part, group=mesh.group("stage"))
        total = total + part[0]
    else:
        total = total + full[staged].sum()
    return full, total


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


def host_staged(t: torch.Tensor, group=None) -> bool:
    """Whether a point-to-point transfer of `t` over `group` goes through
    host memory: gloo's send and recv take CPU tensors only (a CUDA tensor
    aborts the process), so over gloo a CUDA tensor is copied to the host
    and back, all compute staying on the card; NCCL sends it directly.
    Decided by the backend's name."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def isend(t: torch.Tensor, dst: int, group=None):
    """Start sending `t` to global rank `dst` → (work, the buffer to keep
    alive until work.wait())."""
    buf = t.detach().contiguous()
    if host_staged(buf, group):
        buf = buf.cpu()
    return dist.isend(buf, dst=dst, group=group), buf


def recv(shape, dtype: torch.dtype, src: int, device, group=None
         ) -> torch.Tensor:
    """A tensor from global rank `src`, on `device`."""
    buf = torch.empty(shape, dtype=dtype, device=device)
    if host_staged(buf, group):
        host = torch.empty(shape, dtype=dtype)
        dist.recv(host, src=src, group=group)
        return host.to(device)
    dist.recv(buf, src=src, group=group)
    return buf
