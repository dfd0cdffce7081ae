"""Caption → fixed-shape token ids + mask.

Mirrors the reference text pipeline (dataloader_retrieval.py:208-263):
<|startoftext|> + BPE tokens truncated to max_words-1 + <|endoftext|>,
zero-padded to max_words with a {0,1} mask.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .tokenizer import ClipTokenizer, EOT, SOT


def encode_caption(tokenizer: ClipTokenizer, text: str,
                   max_words: int) -> Tuple[np.ndarray, np.ndarray]:
    words = tokenizer.tokenize(text)
    words = [SOT] + words
    if len(words) > max_words - 1:
        words = words[: max_words - 1]
    words = words + [EOT]

    ids = tokenizer.convert_tokens_to_ids(words)
    mask = [1] * len(ids)
    while len(ids) < max_words:
        ids.append(0)
        mask.append(0)
    return (np.asarray(ids, np.int32), np.asarray(mask, np.float32))
