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
micro-batches with exact gradients (see `_microbatched_backward`).
On-device augmentation, remat, the explicit-SPMD and pipeline forms and the
host-resident bank are not ported: asking for one raises.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..core.config import Config
from ..losses import hubness
from ..models import neighborretr as M
from . import bertadam
from .memory_bank import MemoryBank, fifo_update, write_slice


@dataclasses.dataclass
class TrainState:
    model: M.NeighborRetr          # parameters, updated in place
    opt: bertadam.BertAdamState
    bank: MemoryBank
    step: int = 0


def create_train_state(model: M.NeighborRetr, bank: MemoryBank,
                       moments_dtype: str = "float32") -> TrainState:
    """Marks every parameter trainable but the frozen patch embedding and
    starts the optimizer's moments at zero."""
    for name, p in model.named_parameters():
        p.requires_grad_(not bertadam.is_frozen(name))
    opt = bertadam.bert_adam_init(dict(model.named_parameters()),
                                  moments_dtype)
    return TrainState(model=model, opt=opt, bank=bank, step=0)


def _check_supported(cfg: Config) -> None:
    t = cfg.train
    unported = {
        "train.explicit_spmd": t.explicit_spmd,
        "train.pipeline_parallel > 1": t.pipeline_parallel > 1,
        "train.fsdp": t.fsdp,
        "train.bank_placement='host'": t.bank_placement != "device",
        "optim.moments_placement='host'":
            cfg.optim.moments_placement != "device",
        "data.augment_backend='device'": cfg.data.augment_backend == "device",
        "model.remat": cfg.model.remat,
        "model.video_chunk_frames": cfg.model.video_chunk_frames > 0,
    }
    asked = [k for k, v in unported.items() if v]
    if asked:
        raise NotImplementedError(
            "not ported to PyTorch yet: " + ", ".join(asked))


def to_device(batch: Dict[str, object], device) -> Dict[str, torch.Tensor]:
    """A loader batch (numpy arrays or tensors) on `device`."""
    keys = ("text_ids", "text_mask", "video", "video_mask", "idx")
    return {k: torch.as_tensor(batch[k]).to(device) for k in keys}


def _encode_microbatches(model, batch, n: int, kernels: bool):
    """Features of the whole batch, encoded `n` rows-slices at a time."""
    B = batch["text_ids"].shape[0]
    if B % n:
        raise ValueError(f"batch {B} is not divisible by micro_batches={n}")
    feats = [model.get_text_video_feat(
        *(batch[k][s:s + B // n]
          for k in ("text_ids", "text_mask", "video", "video_mask")), kernels)
        for s in range(0, B, B // n)]
    return (torch.cat([f[0] for f in feats]),
            torch.cat([f[1] for f in feats]))


def compute_losses(model: M.NeighborRetr, cfg: Config,
                   batch: Dict[str, torch.Tensor], bank: MemoryBank,
                   noise=None, kernels: bool = True, features=None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Global-batch loss → (total, aux with every term and the fresh
    features).  noise: `models.neighborretr.draw_cluster_noise`'s draws, or
    None for deterministic clustering.  features: the batch's (text, video)
    features where the caller has encoded them already (micro-batching);
    otherwise the towers run here, in `train.micro_batches` slices."""
    mcfg, lcfg = cfg.model, cfg.loss
    if features is not None:
        text_feat, video_feat = features
    elif cfg.train.micro_batches > 1:
        text_feat, video_feat = _encode_microbatches(
            model, batch, cfg.train.micro_batches, kernels)
    else:
        text_feat, video_feat = model.get_text_video_feat(
            batch["text_ids"], batch["text_mask"], batch["video"],
            batch["video_mask"], kernels)
    t_mask = batch["text_mask"].float()
    v_mask = batch["video_mask"].float()

    # in-batch local similarity: the plain form at the short shapes; the
    # long-token shapes (T·V >= 2048) run the blocked kernel
    long_tokens = text_feat.shape[1] * video_feat.shape[1] >= 2048
    s_local = M.local_similarity(model, text_feat, video_feat, t_mask, v_mask,
                                 kernels=kernels and long_tokens)

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

    # neighbor adjusting against the memory bank: the bank matrices feed the
    # loss only through a mean over the bank axis, which the centrality
    # kernel computes without building them
    if M.bank_fusion_supported(mcfg):
        cent_t = M.bank_centrality(model, text_feat, bank.feat_v, t_mask,
                                   bank.mask_v, axis=1,
                                   sim_dtype=mcfg.sim_dtype, kernels=kernels)
        cent_v = M.bank_centrality(model, bank.feat_t, video_feat, bank.mask_t,
                                   v_mask, axis=0,
                                   sim_dtype=mcfg.sim_dtype, kernels=kernels)
        neighbor_loss = 0.5 * (
            hubness.neighbor_adjusting_loss_from_centrality(
                s_local, cent_v, lcfg.num_neighbors, lcfg.temperature)
            + hubness.neighbor_adjusting_loss_from_centrality(
                s_local.T, cent_t, lcfg.num_neighbors, lcfg.temperature))
    else:
        bank_t2v = M.local_similarity(model, text_feat, bank.feat_v, t_mask,
                                      bank.mask_v, kernels)
        bank_v2t = M.local_similarity(model, bank.feat_t, video_feat,
                                      bank.mask_t, v_mask, kernels).T
        neighbor_loss = 0.5 * (
            hubness.neighbor_adjusting_loss(
                s_local, bank_v2t, lcfg.num_neighbors, lcfg.temperature)
            + hubness.neighbor_adjusting_loss(
                s_local.T, bank_t2v, lcfg.num_neighbors, lcfg.temperature))

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


def _microbatched_backward(model, cfg: Config, batch, bank: MemoryBank, noise,
                           kernels: bool) -> Dict[str, torch.Tensor]:
    """Exact large-batch gradients with the towers' activations of one
    micro-batch at a time (GradCache, Gao et al. 2021; ↔ the JAX package's
    `_microbatched_features`, there a map over checkpointed encodes).  The
    contrastive losses need the full B×B matrix, so the loss is not split:
    pass 1 encodes the micro-batches without a graph; the loss runs on those
    features as leaves and its backward leaves their cotangents (and the
    gradients of everything behind the towers); pass 2 encodes each
    micro-batch again with a graph and backpropagates its slice of the
    cotangents.  Gradients accumulate in `.grad` and equal the monolithic
    ones; the price is one extra forward of the towers.  Returns aux."""
    n = cfg.train.micro_batches
    with torch.no_grad():
        feats = _encode_microbatches(model, batch, n, kernels)
    leaves = tuple(f.requires_grad_(True) for f in feats)
    total, aux = compute_losses(model, cfg, batch, bank, noise, kernels,
                                features=leaves)
    total.backward()
    B = leaves[0].shape[0]
    keys = ("text_ids", "text_mask", "video", "video_mask")
    for s in range(0, B, B // n):
        rows = slice(s, s + B // n)
        out = model.get_text_video_feat(*(batch[k][rows] for k in keys),
                                        kernels)
        torch.autograd.backward(out, [leaf.grad[rows] for leaf in leaves])
    return aux


def train_step(state: TrainState, batch: Dict[str, torch.Tensor], cfg: Config,
               t_total: int, generator: Optional[torch.Generator] = None,
               kernels: bool = True
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step on `batch` (tensors on the model's device, see
    `to_device`).  `generator` draws the DPC-KNN tie-break noise when
    cfg.model.cluster_noise is set.  Updates the model in place and returns
    the state with the new optimizer state, bank and step count, and the
    metrics (every loss term, grad_norm, logit_scale)."""
    _check_supported(cfg)
    model = state.model
    noise = None
    if cfg.model.cluster_noise:
        if generator is None:
            raise ValueError("cfg.model.cluster_noise needs a torch.Generator "
                             "for the DPC-KNN tie-break draws")
        noise = M.draw_cluster_noise(cfg.model, batch["text_ids"].shape[0],
                                     generator, batch["text_ids"].device)

    model.zero_grad(set_to_none=True)
    if cfg.train.micro_batches > 1:
        aux = _microbatched_backward(model, cfg, batch, state.bank, noise,
                                     kernels)
    else:
        total, aux = compute_losses(model, cfg, batch, state.bank, noise,
                                    kernels)
        total.backward()

    params = dict(model.named_parameters())
    # a parameter the loss does not reach (the `*_fc1` nets at one merged
    # token) has a zero gradient, and is still weight-decayed
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in params.items() if not bertadam.is_frozen(n)}
    opt = bertadam.bert_adam_update(grads, state.opt, params, cfg.optim,
                                    t_total)
    M.clamp_logit_scale(model, cfg.loss.max_logit_scale)

    bank = fifo_update(state.bank, batch["idx"].to(torch.int32),
                       aux.pop("text_feat"), aux.pop("video_feat"),
                       batch["text_mask"].float(), batch["video_mask"].float())
    metrics = dict(aux)
    metrics["grad_norm"] = bertadam.clip_effective_norm(grads)
    metrics["logit_scale"] = M.logit_scale(model).detach()
    model.zero_grad(set_to_none=True)
    return TrainState(model=model, opt=opt, bank=bank,
                      step=state.step + 1), metrics


@torch.no_grad()
def fill_bank_step(model: M.NeighborRetr, bank: MemoryBank,
                   batch: Dict[str, torch.Tensor], cfg: Config, offset: int,
                   kernels: bool = True) -> MemoryBank:
    """Epoch-start bank fill: encode one batch and write it at `offset`."""
    _check_supported(cfg)
    text_feat, video_feat = model.get_text_video_feat(
        batch["text_ids"], batch["text_mask"], batch["video"],
        batch["video_mask"], kernels)
    return write_slice(bank, offset, batch["idx"].to(torch.int32), text_feat,
                       video_feat, batch["text_mask"].float(),
                       batch["video_mask"].float())
