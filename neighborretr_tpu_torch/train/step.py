"""The training step: forward, the four losses, BertAdam, the logit-scale
clamp and the memory-bank refresh (↔ neighborretr_tpu/train/step.py), on one
explicit device with explicit random generators.

    total = centrality + w_u·uniform + w_n·neighbor + w_kl·KL

The entry points are the ones the JAX package's bench drives:
`create_train_state`, `fill_bank_step`, `train_step`.  Where the tensors lie
on a CUDA device the attention sublayers (forward and backward) and the two
memory-bank centralities run the hand-written kernels; on the CPU they run
the plain versions.  `kernels=False` runs the plain versions on any device.
The in-batch B×B similarity is the plain matmul form by design at the short
shapes, as in the JAX package; at the long-token shapes (T·V >= 2048) it and
the two bank matrices run the blocked similarity (ops/similarity_blocked.py).
`train.micro_batches > 1` encodes the batch in that many sequential
micro-batches with exact gradients (see `_microbatched_backward`);
`model.remat*` and `model.video_chunk_frames` rematerialise the towers
(models/layers.py, models/neighborretr.py); `model.attention_impl` picks the
attention route.  `data.augment_backend="device"` runs the RandAugment
policy on the batch's device at the top of the step (ops/device_augment.py),
its draws from an explicit generator.

With a mesh (`mesh=`, parallel/mesh.py; one process per device) the batch
is this rank's block of the global batch over the data axes.  Without
`train.explicit_spmd` the step takes the gathered form (↔ the JAX
package's GSPMD path): each rank encodes its rows, gathers the features
and masks over the data axes, and runs the single-device loss code on the
global batch.  With it, and more than one rank, the explicit form
(parallel/spmd.py) computes each rank's row block of the similarity
matrices.  The gradients are then averaged over the data axes (a
replicated parameter's over every rank, which changes no value and keeps
its replicas bit-equal: parallel/mesh.py::all_reduce_grads), so BertAdam
steps identically on every rank, and the FIFO refresh takes the gathered
rows.  On a model-sharded placement (parallel/mesh.py::
place_params: FSDP2, the Megatron split, the stage slices) a split
parameter's gradient stays with its shard, BertAdam's norms are taken over
the full model, and the computation runs as the model's forward
(`NeighborRetr.forward`, where FSDP2's hooks sit); with
`train.pipeline_parallel > 1` on a mesh with a `stage` axis the pipeline
context is active (↔ the JAX step), so the placed towers stream
`train.pipeline_microbatches` microbatches (0 → 4 × stages).

`train.bank_placement="host"` keeps the bank in pinned host memory between
steps: the step brings it to the card before the losses and sends the
refreshed bank back after the FIFO update (train/memory_bank.py::
bank_to_memory), and the bank fill does the same around each write.
`optim.moments_placement="host"` keeps the moments there
(train/bertadam.py).  Neither changes a bit of the step.  Under
`debug_nans` (the train CLI's --debug_nans, ↔ `jax_debug_nans`, which
checks the compiled step's outputs and re-runs op by op only after a NaN
shows) the step raises FloatingPointError at the first non-finite value:
a parameter or moment it starts from; then, before the optimizer update,
a loss term or gradient, in which case the step's backward is replayed
from the same state, batch, noise and bank under autograd's anomaly mode
to name the op (the parameters, moments and bank are left as they were);
then a parameter or moment it leaves.  A clean step runs no anomaly mode:
three fused finiteness reductions and their three reads.

While a profile records, the step runs inside the span `nr::step` and its
phases inside `nr::step.towers`, `.losses`, `.backward` and `.update`
(utils/spans.py).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterable, Optional, Tuple

import torch

from ..core.config import Config
from ..data.device_prefetch import to_device  # noqa: F401 (re-exported)
from ..losses import hubness
from ..models import neighborretr as M
from ..ops.device_augment import augment_batch
from ..parallel import mesh as pmesh
from ..parallel import pipeline
from ..utils import host_memory
from ..utils.spans import span
from . import bertadam
from .memory_bank import MemoryBank, bank_to_memory, fifo_update, write_slice


@dataclasses.dataclass
class TrainState:
    model: M.NeighborRetr          # parameters, updated in place
    opt: bertadam.BertAdamState
    bank: MemoryBank
    step: int = 0


def create_train_state(model: M.NeighborRetr, bank: MemoryBank,
                       moments_dtype: str = "float32",
                       moments_placement: str = "device") -> TrainState:
    """Marks every parameter trainable but the frozen patch embedding and
    starts the optimizer's moments at zero, in `moments_placement`'s home
    (bertadam.place_moments)."""
    for name, p in model.named_parameters():
        p.requires_grad_(not bertadam.is_frozen(name))
    opt = bertadam.bert_adam_init(dict(model.named_parameters()),
                                  moments_dtype)
    device = pmesh.local(next(model.parameters())).device
    opt = bertadam.place_moments(opt, moments_placement, device)
    return TrainState(model=model, opt=opt, bank=bank, step=0)


_DEBUG_NANS = [False]


def set_debug_nans(enabled: bool) -> None:
    """Process-wide, as JAX's `jax_debug_nans` (the train CLI's
    --debug_nans): train_step raises FloatingPointError at the first
    non-finite value."""
    _DEBUG_NANS[0] = bool(enabled)


@contextlib.contextmanager
def debug_nans(enabled: bool = True):
    """`set_debug_nans` for the duration of a block (↔ `jax.debug_nans`)."""
    prev = _DEBUG_NANS[0]
    _DEBUG_NANS[0] = bool(enabled)
    try:
        yield
    finally:
        _DEBUG_NANS[0] = prev


def first_non_finite(named: Iterable[Tuple[str, torch.Tensor]]
                     ) -> Optional[str]:
    """The label of the first of `named` (label, tensor) that holds a NaN
    or an Inf, with its count, or None: per device one multi-tensor max-
    norm (NaN and Inf carry through a max) reduced to one flag, and one
    read of all the flags; the tensors are looked at one by one only when
    a flag is down."""
    named = [(n, t) for n, t in named if t.numel()]
    if any(host_memory.is_host_resident(t) for _, t in named):
        host_memory.wait_copies()
    groups: Dict[torch.device, list] = {}
    for i, (_, t) in enumerate(named):
        groups.setdefault(t.device, []).append(i)
    flags = [torch.isfinite(torch.stack(torch._foreach_norm(
        [named[i][1] for i in idx], float("inf")))).all().cpu()
        for idx in groups.values()]
    if all(bool(f) for f in flags):
        return None
    for label, t in named:
        bad = int((~torch.isfinite(t)).sum())
        if bad:
            return f"{label} ({bad} of {t.numel()} entries)"
    return None


def check_finite(named: Iterable[Tuple[str, torch.Tensor]]) -> None:
    """Raises FloatingPointError naming the first of `named` (label,
    tensor) that holds a NaN or an Inf (`first_non_finite`)."""
    bad = first_non_finite(named)
    if bad is not None:
        raise FloatingPointError(f"debug_nans: non-finite value in {bad}")


def _state_leaves(model, opt: bertadam.BertAdamState):
    for n, p in model.named_parameters():
        yield f"parameter {n}", pmesh.local(p).detach()
    for n in opt.m:
        yield f"moment m of {n}", opt.m[n]
        yield f"moment v of {n}", opt.v[n]


def _check_supported(cfg: Config, model: Optional[M.NeighborRetr] = None
                     ) -> None:
    """Raises for a model built from another ModelConfig than `cfg.model`
    (the towers read the model's own: attention route, remat, frame
    chunks)."""
    if model is not None and model.cfg != cfg.model:
        raise ValueError(
            "the model was built from another ModelConfig than cfg.model; "
            "build it from cfg.model, or set model.cfg")


def _maybe_device_augment(cfg: Config, batch: Dict[str, torch.Tensor],
                          generator: Optional[torch.Generator],
                          mesh: Optional[pmesh.DataGroup] = None
                          ) -> Dict[str, torch.Tensor]:
    """RandAugment on the batch's device, ahead of the model's frame
    normalisation, under data.augment_backend="device" (↔ the JAX step's
    _maybe_device_augment): the whole batch at once, before any
    micro-batching, the draws from `generator`; padding frames stay zero.
    On a data group the draws are the global batch's and each rank applies
    its block's.  Any other backend: the batch as it is (the loader
    augmented it)."""
    d = cfg.data
    if d.augment_backend != "device" or not d.train_augment or not d.augment:
        return batch
    if generator is None:
        raise ValueError("data.augment_backend='device' needs a "
                         "torch.Generator for the augment draws")
    if batch["video"].dtype != torch.uint8:
        raise TypeError(
            "--augment_backend device needs uint8 frames from the loader "
            f"(got {batch['video'].dtype}); the host pipeline must not "
            "normalize or augment first")
    rank, world = (mesh.dp_rank, mesh.dp_size) if mesh is not None else (0, 1)
    video = augment_batch(batch["video"], batch["video_mask"], generator,
                          d.augment, rank, world)
    return dict(batch, video=video)


def global_rows(batch: Dict[str, torch.Tensor],
                mesh: Optional[pmesh.DataGroup] = None):
    """(idx int32, text_mask, video_mask fp32) of the global batch: this
    rank's rows gathered over the data group (the batch's own without
    one)."""
    rows = (batch["idx"].to(torch.int32), batch["text_mask"].float(),
            batch["video_mask"].float())
    if mesh is None:
        return rows
    return tuple(pmesh.all_gather(x, mesh) for x in rows)


def encode(model, batch, kernels: bool, rows=slice(None)):
    """The (text, video) features of `rows` of the batch, through the
    model's forward (`NeighborRetr.forward`)."""
    keys = ("text_ids", "text_mask", "video", "video_mask")
    return model(lambda m: m.get_text_video_feat(
        *(batch[k][rows] for k in keys), kernels))


def _encode_microbatches(model, batch, n: int, kernels: bool):
    """Features of the whole batch, encoded `n` rows-slices at a time."""
    B = batch["text_ids"].shape[0]
    if B % n:
        raise ValueError(f"batch {B} is not divisible by micro_batches={n}")
    feats = [encode(model, batch, kernels, slice(s, s + B // n))
             for s in range(0, B, B // n)]
    return (torch.cat([f[0] for f in feats]),
            torch.cat([f[1] for f in feats]))


def composed_losses(model: M.NeighborRetr, cfg: Config, text_feat, video_feat,
                    t_mask, v_mask, s_local, noise, neighbor_loss_fn
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The four losses over the global batch's features and its local
    similarity S → (total, aux); `neighbor_loss_fn()` gives the
    neighbor-adjusting loss (from the bank centralities or the bank
    matrices), called after the global level as in the reference, so the
    discrete decisions (DPC-KNN clusters, then the top-k masks) keep their
    order."""
    lcfg = cfg.loss
    g_t, g_v = M.merge_global_features(model, text_feat, video_feat, t_mask,
                                       v_mask, noise)
    s_global = M.global_level(model, g_t, g_v)

    def uniform(s):
        return hubness.uniform_regularization_loss(
            s, lcfg.temperature, lcfg.beta, lcfg.sinkhorn_iterations)

    uniform_loss = 0.5 * (uniform(s_global) + uniform(s_global.T))
    kl_loss = 0.5 * (hubness.kl_divergence_loss(s_global, s_local)
                     + hubness.kl_divergence_loss(s_global.T, s_local.T))

    t_w, v_w = hubness.centrality_weights(text_feat, video_feat, g_t, g_v,
                                          lcfg.centrality_scale)
    scale = M.logit_scale(model)
    centrality_loss = 0.5 * (
        hubness.centrality_weighting_loss(s_local * scale, t_w)
        + hubness.centrality_weighting_loss(s_local.T * scale, v_w))
    neighbor_loss = neighbor_loss_fn()

    total = (centrality_loss + uniform_loss * lcfg.uniform_weight
             + neighbor_loss * lcfg.neighbor_weight
             + kl_loss * lcfg.kl_weight)
    aux = {"loss": total.detach(),
           "centrality_loss": centrality_loss.detach(),
           "uniform_loss": uniform_loss.detach(),
           "neighbor_loss": neighbor_loss.detach(),
           "kl_loss": kl_loss.detach(),
           "text_feat": text_feat.detach(),
           "video_feat": video_feat.detach()}
    return total, aux


def compute_losses(model: M.NeighborRetr, cfg: Config,
                   batch: Dict[str, torch.Tensor], bank: MemoryBank,
                   noise=None, kernels: bool = True, features=None,
                   mesh: Optional[pmesh.DataGroup] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Global-batch loss → (total, aux with every term and the fresh
    features).  noise: `models.neighborretr.draw_cluster_noise`'s draws, or
    None for deterministic clustering.  features: the batch's (text, video)
    features where the caller has encoded them already (micro-batching);
    otherwise the towers run here, in `train.micro_batches` slices.  With a
    data group, `batch` and `features` are this rank's rows and are
    gathered (differentiably) before the loss: the gathered form."""
    if features is not None:
        text_feat, video_feat = features
    else:
        with span("nr::step.towers"):
            if cfg.train.micro_batches > 1:
                text_feat, video_feat = _encode_microbatches(
                    model, batch, cfg.train.micro_batches, kernels)
            else:
                text_feat, video_feat = model.get_text_video_feat(
                    batch["text_ids"], batch["text_mask"], batch["video"],
                    batch["video_mask"], kernels)
    with span("nr::step.losses"):
        return _losses(model, cfg, batch, bank, noise, kernels, text_feat,
                       video_feat, mesh)


def _losses(model: M.NeighborRetr, cfg: Config,
            batch: Dict[str, torch.Tensor], bank: MemoryBank, noise,
            kernels: bool, text_feat, video_feat,
            mesh: Optional[pmesh.DataGroup]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """`compute_losses` past the towers, from this rank's features."""
    mcfg, lcfg = cfg.model, cfg.loss
    t_mask = batch["text_mask"].float()
    v_mask = batch["video_mask"].float()
    if mesh is not None:
        text_feat, video_feat, t_mask, v_mask = (
            pmesh.all_gather(x, mesh)
            for x in (text_feat, video_feat, t_mask, v_mask))

    # in-batch local similarity: the plain fp32 form at the short shapes;
    # the long-token shapes (T·V >= 2048) run the blocked kernel in
    # sim_dtype, as the bank matrices do (↔ the JAX step)
    # use_pallas="off": the plain fp32 forms of the similarity family
    sim_kernels = M.similarity_kernels(mcfg, kernels)
    sim_dtype = M.similarity_dtype(mcfg)
    long_tokens = text_feat.shape[1] * video_feat.shape[1] >= 2048
    s_local = M.local_similarity(model, text_feat, video_feat, t_mask, v_mask,
                                 kernels=sim_kernels and long_tokens,
                                 sim_dtype=sim_dtype if long_tokens
                                 else "float32")

    # neighbor adjusting against the memory bank: the bank matrices feed the
    # loss only through a mean over the bank axis, which the centrality
    # kernel computes without building them
    def neighbor_loss():
        if M.bank_fusion_supported(mcfg):
            cent_t = M.bank_centrality(model, text_feat, bank.feat_v, t_mask,
                                       bank.mask_v, axis=1,
                                       sim_dtype=sim_dtype,
                                       kernels=sim_kernels)
            cent_v = M.bank_centrality(model, bank.feat_t, video_feat,
                                       bank.mask_t, v_mask, axis=0,
                                       sim_dtype=sim_dtype,
                                       kernels=sim_kernels)
            return 0.5 * (
                hubness.neighbor_adjusting_loss_from_centrality(
                    s_local, cent_v, lcfg.num_neighbors, lcfg.temperature)
                + hubness.neighbor_adjusting_loss_from_centrality(
                    s_local.T, cent_t, lcfg.num_neighbors, lcfg.temperature))
        bank_t2v = M.local_similarity(model, text_feat, bank.feat_v, t_mask,
                                      bank.mask_v, sim_kernels, sim_dtype)
        bank_v2t = M.local_similarity(model, bank.feat_t, video_feat,
                                      bank.mask_t, v_mask, sim_kernels,
                                      sim_dtype).T
        return 0.5 * (
            hubness.neighbor_adjusting_loss(
                s_local, bank_v2t, lcfg.num_neighbors, lcfg.temperature)
            + hubness.neighbor_adjusting_loss(
                s_local.T, bank_t2v, lcfg.num_neighbors, lcfg.temperature))

    return composed_losses(model, cfg, text_feat, video_feat, t_mask, v_mask,
                           s_local, noise, neighbor_loss)


def _microbatched_backward(model, cfg: Config, batch, bank: MemoryBank, noise,
                           kernels: bool,
                           mesh: Optional[pmesh.DataGroup] = None
                           ) -> Dict[str, torch.Tensor]:
    """Exact large-batch gradients with the towers' activations of one
    micro-batch at a time (GradCache, Gao et al. 2021; ↔ the JAX package's
    `_microbatched_features`, there a map over checkpointed encodes).  The
    contrastive losses need the full B×B matrix, so the loss is not split:
    pass 1 encodes the micro-batches without a graph; the loss runs on those
    features as leaves and its backward leaves their cotangents (and the
    gradients of everything behind the towers); pass 2 encodes each
    micro-batch again with a graph and backpropagates its slice of the
    cotangents.  Gradients accumulate in `.grad` and equal the monolithic
    ones; the price is one extra forward of the towers.  On a data group
    the micro-batches cut this rank's rows and the leaves are gathered in
    the loss, so their cotangents come back through the gather's backward
    (summed over ranks), as in the form without micro-batches.  Returns
    aux."""
    n = cfg.train.micro_batches
    with torch.no_grad(), span("nr::step.towers"):
        feats = _encode_microbatches(model, batch, n, kernels)
    leaves = tuple(f.requires_grad_(True) for f in feats)
    total, aux = model(lambda m: compute_losses(
        m, cfg, batch, bank, noise, kernels, features=leaves, mesh=mesh))
    total.backward()
    B = leaves[0].shape[0]
    for s in range(0, B, B // n):
        rows = slice(s, s + B // n)
        out = encode(model, batch, kernels, rows)
        torch.autograd.backward(out, [leaf.grad[rows] for leaf in leaves])
    return aux


def pipeline_context(cfg: Config, mesh: Optional[pmesh.DataGroup]
                     ) -> Optional[pipeline.PipelineContext]:
    """The pipeline context of a step (↔ the JAX step's): on a mesh with a
    `stage` axis under train.pipeline_parallel > 1, else None."""
    pp = cfg.train.pipeline_parallel
    if mesh is None or pp <= 1 or "stage" not in mesh.axis_names:
        return None
    return pipeline.PipelineContext(
        mesh=mesh, stages=pp,
        microbatches=cfg.train.pipeline_microbatches or 4 * pp)


def _backward(model, cfg: Config, batch, bank: MemoryBank, noise,
              kernels: bool, mesh) -> Dict[str, torch.Tensor]:
    """The losses and their backward on the step's form (the explicit
    row-sharded one, GradCache micro-batches, or one pass) → aux.  The
    explicit form's towers span nests inside its losses span, GradCache's
    towers and losses spans inside its backward span."""
    if mesh is not None and mesh.world > 1 and cfg.train.explicit_spmd:
        from ..parallel.spmd import compute_losses_spmd
        with span("nr::step.losses"):
            total, aux = model(lambda m: compute_losses_spmd(
                m, cfg, batch, bank, noise, mesh, kernels,
                cfg.train.data_axis))
    elif cfg.train.micro_batches > 1:
        with span("nr::step.backward"):
            return _microbatched_backward(model, cfg, batch, bank, noise,
                                          kernels, mesh)
    else:
        total, aux = model(lambda m: compute_losses(
            m, cfg, batch, bank, noise, kernels, mesh=mesh))
    with span("nr::step.backward"):
        total.backward()
    return aux


def train_step(state: TrainState, batch: Dict[str, torch.Tensor], cfg: Config,
               t_total: int, generator: Optional[torch.Generator] = None,
               kernels: bool = True,
               augment_generator: Optional[torch.Generator] = None,
               mesh: Optional[pmesh.DataGroup] = None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step on `batch` (tensors on the model's device, see
    `to_device`).  `generator` draws the DPC-KNN tie-break noise when
    cfg.model.cluster_noise is set; `augment_generator` the RandAugment
    draws under data.augment_backend="device" (required there); on a mesh
    both draw for the global batch, the same on every rank.  `mesh`: the
    mesh (parallel/mesh.py), `batch` then being this rank's rows.
    Updates the model in place and returns the state with the new optimizer
    state, bank and step count, and the metrics (every loss term,
    grad_norm, logit_scale)."""
    with span("nr::step"):
        return _train_step(state, batch, cfg, t_total, generator, kernels,
                           augment_generator, mesh)


def _train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                cfg: Config, t_total: int,
                generator: Optional[torch.Generator], kernels: bool,
                augment_generator: Optional[torch.Generator],
                mesh: Optional[pmesh.DataGroup]
                ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    model = state.model
    _check_supported(cfg, model)
    if mesh is not None and not mesh.collective:
        mesh = None          # one process without torch.distributed
    batch = _maybe_device_augment(cfg, batch, augment_generator, mesh)
    noise = None
    if cfg.model.cluster_noise:
        if generator is None:
            raise ValueError("cfg.model.cluster_noise needs a torch.Generator "
                             "for the DPC-KNN tie-break draws")
        world = mesh.dp_size if mesh is not None else 1
        noise = M.draw_cluster_noise(cfg.model,
                                     batch["text_ids"].shape[0] * world,
                                     generator, batch["text_ids"].device)

    debug = _DEBUG_NANS[0]
    if debug:
        check_finite(_state_leaves(model, state.opt))
    device = batch["text_ids"].device
    host_bank = cfg.train.bank_placement == "host"
    bank = (bank_to_memory(state.bank, "device", device) if host_bank
            else state.bank)
    params = dict(model.named_parameters())
    placement = pmesh.placement_of(model)
    # a parameter the loss does not reach (the `*_fc1` nets at one merged
    # token) has a zero gradient, and is still weight-decayed; on a mesh
    # every rank gets the mean over the data ranks
    live = {n: p for n, p in params.items() if not bertadam.is_frozen(n)}

    def backward(anomaly: bool = False):
        model.zero_grad(set_to_none=True)
        with pipeline.activated(pipeline_context(cfg, mesh)), \
                torch.autograd.set_detect_anomaly(anomaly):
            aux = _backward(model, cfg, batch, bank, noise, kernels, mesh)
        with span("nr::step.backward"):
            return aux, pmesh.all_reduce_grads(
                live, mesh or pmesh.DataGroup(), placement)

    aux, grads = backward()
    if debug:
        bad = first_non_finite(
            [(f"loss term {k}", v) for k, v in aux.items() if v.ndim == 0]
            + [(f"gradient of {n}", g) for n, g in grads.items()])
        if mesh is not None and pmesh.any_rank(bad is not None, mesh):
            bad = bad or "another rank's loss term or gradient"
        if bad is not None:      # nothing updated yet: replay, name the op
            try:
                backward(anomaly=True)
            except RuntimeError as e:
                if "nan values" in str(e):       # anomaly mode's verdict
                    raise FloatingPointError(f"debug_nans: {e}") from e
                raise
            finally:
                model.zero_grad(set_to_none=True)
            raise FloatingPointError(f"debug_nans: non-finite value in {bad}")
    with span("nr::step.update"):
        opt = bertadam.bert_adam_update(grads, state.opt, params, cfg.optim,
                                        t_total, placement)
        M.clamp_logit_scale(model, cfg.loss.max_logit_scale)
        if debug:
            check_finite(_state_leaves(model, opt))

        idx, t_mask, v_mask = global_rows(batch, mesh)
        bank = fifo_update(bank, idx, aux.pop("text_feat"),
                           aux.pop("video_feat"), t_mask, v_mask)
        if host_bank:
            bank = bank_to_memory(bank, "host")
        metrics = dict(aux)
        metrics["grad_norm"] = bertadam.clip_effective_norm(grads, placement)
        metrics["logit_scale"] = M.logit_scale(model).detach()
        model.zero_grad(set_to_none=True)
    return TrainState(model=model, opt=opt, bank=bank,
                      step=state.step + 1), metrics


@torch.no_grad()
def fill_bank_step(model: M.NeighborRetr, bank: MemoryBank,
                   batch: Dict[str, torch.Tensor], cfg: Config, offset: int,
                   kernels: bool = True,
                   augment_generator: Optional[torch.Generator] = None,
                   mesh: Optional[pmesh.DataGroup] = None) -> MemoryBank:
    """Epoch-start bank fill: encode one batch and write it at `offset`.
    With `augment_generator` the batch is augmented first under
    data.augment_backend="device" (the bank loader is a train loader).  On
    a data group each rank encodes its rows and the gathered global batch
    is written, the same on every rank.  A host-placed bank
    (train.bank_placement="host") comes to the card for the write and goes
    back after it."""
    _check_supported(cfg, model)
    if mesh is not None and not mesh.collective:
        mesh = None
    if augment_generator is not None:
        batch = _maybe_device_augment(cfg, batch, augment_generator, mesh)
    host_bank = cfg.train.bank_placement == "host"
    if host_bank:
        bank = bank_to_memory(bank, "device", batch["text_ids"].device)
    text_feat, video_feat = encode(model, batch, kernels)
    if mesh is not None:
        text_feat, video_feat = (pmesh.all_gather(x, mesh)
                                 for x in (text_feat, video_feat))
    idx, t_mask, v_mask = global_rows(batch, mesh)
    out = write_slice(bank, offset, idx, text_feat, video_feat, t_mask,
                      v_mask)
    return bank_to_memory(out, "host") if host_bank else out
