"""Plain reference of text-to-video search: the text tower over a query's
tokens, the token-interaction similarity against every video of the index,
and the top k."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from . import model as R
from .precision import Precision
from .tokenizer import Tokenizer


def query_features(P, tok: Tokenizer, queries: Sequence[str], cfg: dict,
                   prec: Precision):
    """[A, W, E] text features and [A, W] masks of the queries."""
    dev = P["clip.logit_scale"].device
    enc = [tok.caption(q, cfg["max_words"]) for q in queries]
    ids = torch.as_tensor(np.stack([e[0] for e in enc]), device=dev)
    mask = torch.as_tensor(np.stack([e[1] for e in enc]), device=dev)
    return R.encode_text(P, ids, mask, cfg, prec), mask


@torch.no_grad()
def scores(P, t_feat, t_mask, v_feat, v_mask, chunk: int = 8192):
    """S [A, N] of the queries against every indexed video (fp32 features
    [N, V, E] and masks [N, V]), the videos `chunk` at a time."""
    tw = R.token_weights(P, "text_weight_fc.", t_feat, t_mask)
    tn = R.l2n(t_feat)
    cols = []
    for s in range(0, v_feat.shape[0], chunk):
        v, m = v_feat[s:s + chunk], v_mask[s:s + chunk]
        vw = R.token_weights(P, "video_weight_fc.", v, m)
        cols.append(R.interaction(tn, R.l2n(v), t_mask, m, tw, vw))
    return torch.cat(cols, dim=1)


@torch.no_grad()
def pair_scores(P, t_feat, t_mask, v_feat, v_mask, dtype=torch.float64):
    """One query's scores [k] against k videos (features [W, E] and [k, F,
    E], masks [W] and [k, F]), in `dtype`: the similarity stage from given
    text features."""
    def c(x):
        return x.to(dtype)
    Q = {n: c(t) for n, t in P.items()
         if n.startswith(("text_weight_fc.", "video_weight_fc."))}
    return R.local_similarity(Q, c(t_feat[None]), c(v_feat),
                              c(t_mask[None]), c(v_mask))[0]
