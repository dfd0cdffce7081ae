"""Training batches made on the card from the seed: a pool of distinct
batches that the steps take in turn.

Per batch: `batch` captions of start token, a drawn number of word tokens
(uniform in `caption_tokens`, drawn from the vocabulary's word ids), end
token and zero padding to `max_words`, with their masks; `batch` videos of
`max_frames` uint8 frames at the configuration's resolution, of which a
drawn number (uniform in `frames`) are valid and the rest zero, as the
loader pads; each video a smooth random scene (an 8 x 8 colour field
widened to the frame size) that drifts from frame to frame, so that frames
and videos differ in what they show rather than in pixel noise; unique
sample ids.  Every size and every draw follows from the seed alone.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from ..harness import core

VOCAB_WORDS = 49406      # ids 1 .. 49405 are words; 49406/49407 start/end
SOT, EOT = 49406, 49407


def make_batch(t: dict, resolution: int, seed: int, first_id: int,
               device) -> Dict[str, torch.Tensor]:
    g = torch.Generator(device=device).manual_seed(seed)
    B, W, Fr = t["batch"], t["max_words"], t["max_frames"]
    lo, hi = t["caption_tokens"]
    n_tok = torch.randint(lo, hi + 1, (B,), generator=g, device=device)
    words = torch.randint(1, VOCAB_WORDS, (B, W), generator=g, device=device)
    pos = torch.arange(W, device=device)[None]
    ids = torch.where(pos <= n_tok[:, None], words, 0)
    ids[:, 0] = SOT
    ids.scatter_(1, (n_tok + 1)[:, None], EOT)
    text_mask = (pos <= (n_tok + 1)[:, None]).float()

    flo, fhi = t["frames"]
    n_fr = torch.randint(flo, fhi + 1, (B,), generator=g, device=device)
    video_mask = (torch.arange(Fr, device=device)[None]
                  < n_fr[:, None]).float()
    base = torch.rand(B, 1, 3, 8, 8, generator=g, device=device)
    drift = 0.25 * torch.randn(B, Fr, 3, 8, 8, generator=g, device=device)
    field = (base + drift.cumsum(dim=1) / Fr ** 0.5).reshape(B * Fr, 3, 8, 8)
    frames = F.interpolate(field, size=(resolution, resolution),
                           mode="bilinear", align_corners=False)
    frames = (frames.clamp(0, 1) * 255).round().to(torch.uint8)
    video = frames.reshape(B, Fr, 3, resolution, resolution) \
        .permute(0, 1, 3, 4, 2).contiguous()
    video *= video_mask.to(torch.uint8)[:, :, None, None, None]
    return {"text_ids": ids.to(torch.int32), "text_mask": text_mask,
            "video": video, "video_mask": video_mask,
            "idx": torch.arange(first_id, first_id + B, device=device,
                                dtype=torch.int32)}


def make_pool(t: dict, resolution: int, seed: int, device
              ) -> List[Dict[str, torch.Tensor]]:
    """The traffic's pool of `pool` distinct batches."""
    return [make_batch(t, resolution, core.derive(seed, f"batch{i}"),
                       i * t["batch"], device) for i in range(t["pool"])]
