"""Synthetic in-memory dataset for tests and benchmarks — no video files.

Generates deterministic caption/video pairs where caption i is paired with a
structured random video i (so retrieval is learnable), matching the item
contract of RetrievalDataset.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


class SyntheticDataset:
    multi_sentence_per_video = False
    cut_off_points: list = []

    def __init__(self, n: int = 64, max_words: int = 24, max_frames: int = 12,
                 resolution: int = 224, vocab_size: int = 49408, seed: int = 0):
        self.n = n
        self.max_words = max_words
        self.max_frames = max_frames
        self.resolution = resolution
        self.vocab_size = vocab_size
        self.seed = seed

    def __len__(self) -> int:
        return self.n

    @property
    def sentence_num(self) -> int:
        return self.n

    @property
    def video_num(self) -> int:
        return self.n

    def item(self, i: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed * 1_000_003 + i)
        W, F, R = self.max_words, self.max_frames, self.resolution

        n_words = int(rng.integers(min(4, W), W + 1))  # W<4 stays valid
        ids = np.zeros((W,), np.int32)
        ids[:n_words] = rng.integers(1, self.vocab_size - 2, size=n_words)
        ids[n_words - 1] = self.vocab_size - 1          # EoT = max id
        mask = np.zeros((W,), np.float32)
        mask[:n_words] = 1

        video = rng.integers(0, 256, size=(F, R, R, 3)).astype(np.uint8)
        vmask = np.ones((F,), np.float32)

        return {
            "text_ids": ids,
            "text_mask": mask,
            "video": video,
            "video_mask": vmask,
            "idx": np.int32(i),
            "video_hash": np.int64(i),
        }


def make_synthetic_batch(model_cfg, batch: int, seed: int = 0,
                         variable_lengths: bool = True) -> Dict[str, np.ndarray]:
    """One fixed-shape global batch of synthetic pairs as HOST arrays — shared
    by the benchmarks and smoke runs (callers move them to the device).

    variable_lengths=True places a per-row caption length in [min(4,W), W]
    with the EOT token at its end (exercises the masking path);
    False keeps all-ones masks with EOT in the last slot (the bench's
    stable-shape measurement convention)."""
    rng = np.random.default_rng(seed)
    m = model_cfg
    W, F, R = m.max_words, m.max_frames, m.clip.image_resolution
    vocab = m.clip.vocab_size
    text_ids = rng.integers(1, vocab - 1, size=(batch, W)).astype(np.int32)
    text_mask = np.ones((batch, W), np.float32)
    if variable_lengths:
        text_mask[:] = 0
        for i in range(batch):
            n = int(rng.integers(min(4, W), W + 1))
            text_mask[i, :n] = 1
            text_ids[i, n - 1] = vocab - 1
            text_ids[i, n:] = 0
    else:
        text_ids[:, -1] = vocab - 1
    video = rng.integers(0, 256, size=(batch, F, R, R, 3)).astype(np.uint8)
    return {
        "text_ids": text_ids,
        "text_mask": text_mask,
        "video": video,
        "video_mask": np.ones((batch, F), np.float32),
        "idx": np.arange(batch, dtype=np.int32),
    }
