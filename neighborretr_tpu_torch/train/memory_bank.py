"""Device-resident memory bank (↔ neighborretr_tpu/train/memory_bank.py):
fixed capacity M = mb_batch × batch, FIFO refresh (the current batch is
prepended and the tail dropped) and an epoch-start fill written slice by
slice.  Functional like the JAX package's: each update returns a new bank;
the bank carries no gradient.  The JAX package's host placement is not
ported (it measured negative there for a reason that holds on any device:
the bank is live across the whole step).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class MemoryBank(NamedTuple):
    ind: torch.Tensor      # [M] int32 sample ids
    feat_t: torch.Tensor   # [M, T, E]
    feat_v: torch.Tensor   # [M, F, E]
    mask_t: torch.Tensor   # [M, T]
    mask_v: torch.Tensor   # [M, F]


def create(capacity: int, max_words: int, max_frames: int, embed_dim: int,
           feat_dtype: torch.dtype = torch.float32, device=None) -> MemoryBank:
    """`feat_dtype` is the storage dtype of the features (every write casts
    to it); masks and ids keep exact dtypes."""
    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return MemoryBank(
        ind=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        feat_t=z(capacity, max_words, embed_dim, dtype=feat_dtype),
        feat_v=z(capacity, max_frames, embed_dim, dtype=feat_dtype),
        mask_t=z(capacity, max_words), mask_v=z(capacity, max_frames))


def _new_rows(bank: MemoryBank, rows):
    return [new.detach().to(device=old.device, dtype=old.dtype)
            for old, new in zip(bank, rows)]


def fifo_update(bank: MemoryBank, ind, feat_t, feat_v, mask_t,
                mask_v) -> MemoryBank:
    """Prepend the current batch, drop the tail."""
    cap = bank.ind.shape[0]
    rows = _new_rows(bank, (ind, feat_t, feat_v, mask_t, mask_v))
    return MemoryBank(*(torch.cat([new, old], dim=0)[:cap]
                        for old, new in zip(bank, rows)))


def write_slice(bank: MemoryBank, offset: int, ind, feat_t, feat_v, mask_t,
                mask_v) -> MemoryBank:
    """Epoch-start fill: one encoded batch written at `offset`."""
    out = []
    for old, new in zip(bank, _new_rows(bank, (ind, feat_t, feat_v, mask_t,
                                                mask_v))):
        old = old.clone()
        old[offset:offset + new.shape[0]] = new
        out.append(old)
    return MemoryBank(*out)
