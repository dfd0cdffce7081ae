"""Device-side frame normalisation (↔ neighborretr_tpu/data/video.py::
normalize_frames): uint8 [..., R, R, 3] → CLIP-normalised pixels."""

from __future__ import annotations

import numpy as np
import torch

# OpenAI CLIP's pixel statistics (the same constants as data/video.py)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
_SCALE = (1.0 / (255.0 * CLIP_STD)).astype(np.float32)
_BIAS = (CLIP_MEAN / CLIP_STD).astype(np.float32)


def normalize_frames(frames_u8: torch.Tensor,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x · 1/(255·std) − mean/std, computed in `dtype` on the frames'
    device (the host ships raw bytes)."""
    scale = torch.as_tensor(_SCALE, device=frames_u8.device).to(dtype)
    bias = torch.as_tensor(_BIAS, device=frames_u8.device).to(dtype)
    return frames_u8.to(dtype) * scale - bias
