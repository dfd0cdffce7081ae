"""A video index and free-text queries made from the seed.

The index: `videos` rows of `max_frames` temporal features of width
`embed_dim`, each video a random direction plus a smaller random part per
frame (frames of one video alike, videos unlike), drawn on the card and
kept in float16 as an index file keeps them; a drawn number of valid frames
per video (uniform in `frames`).  The queries: `queries` distinct captions,
each a drawn number of words (uniform in `words`) from the traffic's word
list, lower-case and separated by spaces; a client takes them in turn.
"""

from __future__ import annotations

import random
from typing import List, Tuple

import torch

from ..harness import core


def make_index(t: dict, embed_dim: int, seed: int, device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(features [N, F, E] float16, masks [N, F] float32) on `device`."""
    g = torch.Generator(device=device).manual_seed(core.derive(seed, "index"))
    N, Fr = t["videos"], t["max_frames"]
    feat = torch.empty((N, Fr, embed_dim), dtype=torch.float16, device=device)
    step = 16384
    for s in range(0, N, step):
        n = min(step, N - s)
        v = torch.randn(n, 1, embed_dim, generator=g, device=device) \
            + t["frame_spread"] * torch.randn(n, Fr, embed_dim, generator=g,
                                              device=device)
        feat[s:s + n] = v.half()
    lo, hi = t["frames"]
    n_fr = torch.randint(lo, hi + 1, (N,), generator=g, device=device)
    mask = (torch.arange(Fr, device=device)[None] < n_fr[:, None]).float()
    return feat, mask


def make_queries(t: dict, seed: int) -> List[str]:
    rng = random.Random(core.derive(seed, "queries"))
    lo, hi = t["words"]
    vocab = t["vocabulary"]
    return [" ".join(rng.choice(vocab) for _ in range(rng.randint(lo, hi)))
            for _ in range(t["queries"])]
