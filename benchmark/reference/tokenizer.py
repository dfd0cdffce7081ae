"""CLIP's byte-pair encoding, enough of it for the benchmark's queries, and
the caption layout the NeighborRetr text pipeline feeds the text tower.

A frozen copy of the published scheme (OpenAI CLIP's simple_tokenizer):
the GPT-2 byte-to-unicode table, an end-of-word marker on each word's last
symbol, merges applied by rank, and the 49,408-entry vocabulary that ends
in <|startoftext|> and <|endoftext|>.  The merges are CLIP's own
`bpe_simple_vocab_16e6.txt.gz`, read as a raw file from the JAX package's
data directory (the repo's frozen copy; nothing of that package is
imported) and held to its SHA-256, so that the yardstick cannot move with
a later change to the file.  Queries are lower-case words separated by
spaces; any other character raises.
"""

from __future__ import annotations

import gzip
import hashlib
import os
from typing import Dict, List, Tuple

import numpy as np

VOCAB = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "neighborretr_tpu", "data",
    "bpe_simple_vocab_16e6.txt.gz")
VOCAB_SHA256 = ("924691ac288e54409236115652ad4aa2"
                "50f48203de50a9e4722a6ecd48d6804a")
N_MERGES = 49152 - 256 - 2


def bytes_to_unicode() -> Dict[int, str]:
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


class Tokenizer:
    def __init__(self, path: str = VOCAB):
        with open(path, "rb") as f:
            raw = f.read()
        if hashlib.sha256(raw).hexdigest() != VOCAB_SHA256:
            raise ValueError(f"{path} is not CLIP's bpe_simple_vocab_16e6 "
                             "(SHA-256 differs)")
        lines = gzip.decompress(raw).decode("utf-8").split("\n")
        merges = [tuple(m.split()) for m in lines[1:N_MERGES + 1] if m]
        self.byte_encoder = bytes_to_unicode()
        vocab = list(self.byte_encoder.values())
        vocab += [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.encoder = {t: i for i, t in enumerate(vocab)}
        self.ranks = {m: i for i, m in enumerate(merges)}
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]

    def bpe(self, word: str) -> List[str]:
        sym = list(word[:-1]) + [word[-1] + "</w>"]
        while len(sym) > 1:
            pairs = [(sym[i], sym[i + 1]) for i in range(len(sym) - 1)]
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            out, i = [], 0
            while i < len(sym):
                if i < len(sym) - 1 and (sym[i], sym[i + 1]) == best:
                    out.append(sym[i] + sym[i + 1])
                    i += 2
                else:
                    out.append(sym[i])
                    i += 1
            sym = out
        return sym

    def ids(self, text: str) -> List[int]:
        out = []
        for word in text.lower().split():
            if not word.isascii() or not word.isalpha():
                raise ValueError(f"query word {word!r} is not lower-case "
                                 "ASCII letters")
            w = "".join(self.byte_encoder[b] for b in word.encode())
            out.extend(self.encoder[t] for t in self.bpe(w))
        return out

    def caption(self, text: str, max_words: int) -> Tuple[np.ndarray,
                                                          np.ndarray]:
        """Start token, the words' tokens cut to max_words - 2, end token,
        zero padding to max_words; and the {0, 1} mask."""
        ids = [self.sot] + self.ids(text)[:max_words - 2] + [self.eot]
        mask = [1.0] * len(ids) + [0.0] * (max_words - len(ids))
        ids += [0] * (max_words - len(ids))
        return np.asarray(ids, np.int64), np.asarray(mask, np.float32)
