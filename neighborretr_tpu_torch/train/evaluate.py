"""Evaluation harness: feature cache → similarity matrix → R@K, on one
device (↔ neighborretr_tpu/train/evaluate.py).

  1. Feature cache: one pass over the test loader, text and video encoded
     batch by batch; the trailing partial batch is padded by the loader and
     trimmed by its `valid` flags.  For the multi-sentence protocol (MSVD)
     only one video per caption group is encoded, the rows at
     `cut_off_points - 1`.  Features stay on the device.
  2. Similarity: the kernels never build the [N, T, N, V] logits, so a CUDA
     run takes the whole matrix in one call; the plain version is blocked
     over text rows when its logits would pass `max_logits_bytes`.
  3. Metrics: rank of the diagonal on the device, or the 3-D multi-sentence
     forms with -inf padding per caption group; only rank vectors leave the
     device.

The JAX package's mesh and multi-process branches are not ported.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.config import Config
from ..models.neighborretr import NeighborRetr, local_similarity
from . import metrics as M


def _device(model: NeighborRetr) -> torch.device:
    return model.clip.logit_scale.device


@torch.no_grad()
def encode_text_batch(model: NeighborRetr, text_ids, text_mask,
                      kernels: bool = True) -> torch.Tensor:
    """[B, W] ids/mask (numpy or tensors) → [B, W, E] fp32 on the model's
    device."""
    dev = _device(model)
    ids = torch.as_tensor(np.asarray(text_ids), device=dev)
    mask = torch.as_tensor(np.asarray(text_mask, np.float32), device=dev)
    return model.get_text_feat(ids, mask, kernels)


@torch.no_grad()
def encode_video_batch(model: NeighborRetr, video, video_mask,
                       kernels: bool = True) -> torch.Tensor:
    """[B, F, H, W, 3] uint8 frames + [B, F] mask → [B, F, E] fp32 on the
    model's device (the host ships raw bytes)."""
    dev = _device(model)
    v = torch.as_tensor(np.asarray(video), device=dev)
    m = torch.as_tensor(np.asarray(video_mask, np.float32), device=dev)
    return model.get_video_feat(v, m, kernels)


@torch.no_grad()
def similarity_matrix_device(model: NeighborRetr, t_feat, t_mask, v_feat,
                             v_mask, block: int = 128,
                             max_logits_bytes: int = 2 * 1024 ** 3,
                             kernels: bool = True) -> torch.Tensor:
    """Full [N_text, N_video] similarity on the model's device.  The kernel
    never materialises the [N, T, N, V] logits, so a CUDA run takes the
    whole matrix in one call; the plain version is row-blocked when its
    logits would exceed `max_logits_bytes`."""
    dev = _device(model)
    t_feat, t_mask, v_feat, v_mask = (
        (a if torch.is_tensor(a) else torch.tensor(np.asarray(a)))
        .to(dev).float()
        for a in (t_feat, t_mask, v_feat, v_mask))
    n_t, T = t_feat.shape[:2]
    logits_bytes = n_t * T * v_feat.shape[0] * v_feat.shape[1] * 4
    if (kernels and dev.type == "cuda") or logits_bytes <= max_logits_bytes:
        return local_similarity(model, t_feat, v_feat, t_mask, v_mask, kernels)
    return torch.cat([local_similarity(model, t_feat[s:s + block], v_feat,
                                       t_mask[s:s + block], v_mask, kernels)
                      for s in range(0, n_t, block)])


def similarity_matrix(model: NeighborRetr, t_feat, t_mask, v_feat, v_mask,
                      **kw) -> np.ndarray:
    """Host-array wrapper around similarity_matrix_device."""
    return similarity_matrix_device(model, t_feat, t_mask, v_feat, v_mask,
                                    **kw).cpu().numpy()


@torch.no_grad()
def extract_features(model: NeighborRetr, cfg: Config, loader,
                     video_keep: Optional[np.ndarray] = None,
                     kernels: bool = True):
    """Cache all text/video features → (t_feat, t_mask, v_feat, v_mask):
    features as tensors on the model's device, masks as numpy, padded rows
    dropped and dataset order restored.

    video_keep: dataset-order row indices whose videos to encode (the
    multi-sentence protocol: one video per caption group).  Only those
    rows' videos run through the vision tower, batched back to the loader's
    batch size; v_feat / v_mask then follow video_keep's order."""
    keep_pos = None
    if video_keep is not None:
        keep_pos = {int(r): j for j, r in enumerate(np.asarray(video_keep))}

    t_feats, t_masks, v_feats, v_masks, ids, valids = [], [], [], [], [], []
    pend_v, pend_m, kept_chunks, kept_masks = [], [], [], []
    n_kept_seen = 0
    batch_size = None

    def flush_kept(pad_to=None):
        v, m = np.stack(pend_v), np.stack(pend_m)
        if pad_to and len(v) < pad_to:
            pad = pad_to - len(v)
            v = np.concatenate([v, np.repeat(v[-1:], pad, 0)])
            m = np.concatenate([m, np.repeat(m[-1:], pad, 0)])
        kept_chunks.append(encode_video_batch(model, v, m, kernels))
        pend_v.clear()
        pend_m.clear()

    for batch in loader:
        batch_size = len(batch["idx"])
        t_feats.append(encode_text_batch(model, batch["text_ids"],
                                         batch["text_mask"], kernels))
        t_masks.append(np.asarray(batch["text_mask"]))
        if keep_pos is None:
            v_feats.append(encode_video_batch(model, batch["video"],
                                              batch["video_mask"], kernels))
            v_masks.append(np.asarray(batch["video_mask"]))
        else:
            for i, (gid, ok) in enumerate(zip(batch["idx"], batch["valid"])):
                j = keep_pos.get(int(gid)) if ok else None
                if j is None:
                    continue
                if j != n_kept_seen:
                    raise ValueError(
                        "video_keep rows must arrive in keep order (sorted "
                        "keep indices over an unshuffled eval loader)")
                n_kept_seen += 1
                pend_v.append(np.asarray(batch["video"][i]))
                kept_masks.append(np.asarray(batch["video_mask"][i]))
                pend_m.append(kept_masks[-1])
                if len(pend_v) == batch_size:
                    flush_kept()
        ids.append(np.asarray(batch["idx"]))
        valids.append(np.asarray(batch["valid"]))

    ids, valid = np.concatenate(ids), np.concatenate(valids)
    row_index = np.nonzero(valid)[0][np.argsort(ids[valid])]
    gather = torch.as_tensor(row_index, device=_device(model))
    t_feat = torch.cat(t_feats)[gather]
    t_mask = np.concatenate(t_masks)[row_index]
    if keep_pos is None:
        return (t_feat, t_mask, torch.cat(v_feats)[gather],
                np.concatenate(v_masks)[row_index])
    K = len(video_keep)
    if n_kept_seen != K:
        raise ValueError(f"missing kept video rows: {K - n_kept_seen}")
    if pend_v:
        flush_kept(pad_to=batch_size)
    return t_feat, t_mask, torch.cat(kept_chunks)[:K], np.stack(kept_masks)


def reshape_multi_sentence_device(sim: torch.Tensor,
                                  cut_off_points) -> torch.Tensor:
    """[N_caps, V] → [V, max_caps, V] with -inf padding per caption group
    (cut_off_points are exclusive end indices): one gather with a -inf
    sentinel row."""
    ends = list(cut_off_points)
    starts = [0] + ends[:-1]
    max_len = max(e - s for s, e in zip(starts, ends))
    n_caps, n_vid = sim.shape
    idx = np.full((len(ends), max_len), n_caps, np.int64)    # the sentinel
    for v, (s, e) in enumerate(zip(starts, ends)):
        idx[v, : e - s] = np.arange(s, e)
    ext = torch.cat([sim, sim.new_full((1, n_vid), float("-inf"))])
    return ext[torch.as_tensor(idx, device=sim.device)]


def evaluate(model: NeighborRetr, cfg: Config, loader, dataset=None,
             logger=None, kernels: bool = True
             ) -> Tuple[Dict[str, float], Dict[str, float]]:
    """Full evaluation → (t2v metrics, v2t metrics)."""
    dataset = dataset if dataset is not None else loader.dataset
    multi = getattr(dataset, "multi_sentence_per_video", False)
    dev = _device(model)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    tic = time.time()
    keep = (np.asarray(dataset.cut_off_points) - 1) if multi else None
    t_feat, t_mask, v_feat, v_mask = extract_features(
        model, cfg, loader, video_keep=keep, kernels=kernels)
    sync()
    feat_time = time.time() - tic

    tic = time.time()
    sim = similarity_matrix_device(model, t_feat, t_mask, v_feat, v_mask,
                                   kernels=kernels)
    if multi:
        sim_3d = reshape_multi_sentence_device(sim, dataset.cut_off_points)
        ranks, valid = M.device_multi_sentence_ranks(sim_3d)
        t2v = M.metrics_from_ranks(ranks[valid].cpu().numpy())
        v2t = M.metrics_from_ranks(
            M.device_video_to_text_ranks(sim_3d).cpu().numpy())
        M.log_tie_counts(logger, M.device_multi_sentence_ties(sim_3d).item(),
                         M.device_video_to_text_ties(sim_3d).item())
    else:
        r_t2v, r_v2t = M.device_ranks_both(sim)
        t2v = M.metrics_from_ranks(r_t2v.cpu().numpy())
        v2t = M.metrics_from_ranks(r_v2t.cpu().numpy())
        ties = M.device_ties_both(sim)
        M.log_tie_counts(logger, ties[0].item(), ties[1].item())
    sim_time = time.time() - tic

    if logger is not None:
        logger.info("Eval timing: features %.1fs, similarity %.1fs "
                    "(%d texts x %d videos)", feat_time, sim_time,
                    sim.shape[0], sim.shape[1])
        logger.info("Mean R@1: %.4f", (t2v["R1"] + v2t["R1"]) / 2)
        logger.info(M.format_metrics(t2v, "Text-to-Video: "))
        logger.info(M.format_metrics(v2t, "Video-to-Text: "))
    return t2v, v2t
