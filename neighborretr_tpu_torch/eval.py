"""Batched feature encoding and the device-resident similarity matrix
(↔ the serving subset of neighborretr_tpu/train/evaluate.py)."""

from __future__ import annotations

import numpy as np
import torch

from .models.neighborretr import NeighborRetr, local_similarity


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
