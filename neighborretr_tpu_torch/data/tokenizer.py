"""CLIP byte-pair-encoding tokenizer.

A from-scratch implementation of the standard CLIP BPE scheme used by the
reference (models/tokenization_clip.py:16-261): GPT-2 byte↔unicode table,
lowercased + whitespace-normalized input, regex pre-tokenization, BPE merges
with an end-of-word marker, and the 49408-token vocabulary ending in
<|startoftext|> / <|endoftext|>.

The merges vocabulary (`bpe_simple_vocab_16e6.txt.gz`) is DATA, not code; it is
located at runtime rather than vendored:
  1. $NEIGHBORRETR_BPE_VOCAB (explicit path),
  2. alongside this module (`neighborretr_tpu/data/bpe_simple_vocab_16e6.txt.gz`),
  3. common install locations.
Tests use a tiny synthetic merges table (see tests/test_tokenizer.py), so the
full vocab file is only needed for real-checkpoint runs.

ftfy (used by the reference for mojibake fixing) is not in this image; the
cleaner degrades gracefully to html-unescape + whitespace normalization, which
is equivalent for ASCII captions (all four benchmark datasets).
"""

from __future__ import annotations

import functools
import gzip
import html
import os
from typing import Dict, List, Optional

import regex as re

try:
    import ftfy  # type: ignore
    _HAS_FTFY = True
except ImportError:
    _HAS_FTFY = False

SOT = "<|startoftext|>"
EOT = "<|endoftext|>"

_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
    re.IGNORECASE,
)


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2 reversible byte→unicode map (printable chars preserved)."""
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
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text: str) -> str:
    if _HAS_FTFY:
        text = ftfy.fix_text(text)
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def default_vocab_path() -> Optional[str]:
    candidates = [
        os.environ.get("NEIGHBORRETR_BPE_VOCAB", ""),
        os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "bpe_simple_vocab_16e6.txt.gz"),
        os.path.expanduser("~/.cache/clip/bpe_simple_vocab_16e6.txt.gz"),
    ]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    return None


def _read_merges(vocab_path: str) -> List[tuple]:
    opener = gzip.open if vocab_path.endswith(".gz") else open
    with opener(vocab_path, "rb") as f:
        lines = f.read().decode("utf-8").split("\n")
    # header line 0; CLIP uses merges[1 : 49152-256-2+1]
    merges = lines[1: 49152 - 256 - 2 + 1]
    return [tuple(m.split()) for m in merges if m]


class ClipTokenizer:
    """BPE tokenizer producing CLIP token ids.

    Args:
      vocab_path: merges file (possibly gzipped). None → auto-discover.
      merges: pre-parsed merge list (overrides vocab_path; used in tests).
    """

    def __init__(self, vocab_path: Optional[str] = None,
                 merges: Optional[List[tuple]] = None):
        if merges is None:
            vocab_path = vocab_path or default_vocab_path()
            if vocab_path is None:
                raise FileNotFoundError(
                    "CLIP BPE merges file not found; set NEIGHBORRETR_BPE_VOCAB "
                    "or place bpe_simple_vocab_16e6.txt.gz next to this module")
            merges = _read_merges(vocab_path)

        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend([SOT, EOT])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {SOT: SOT, EOT: EOT}

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    @property
    def sot_id(self) -> int:
        return self.encoder[SOT]

    @property
    def eot_id(self) -> int:
        return self.encoder[EOT]

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word) if len(word) > 1 else None
        if not pairs:
            return token + "</w>"

        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)

        result = " ".join(word)
        self.cache[token] = result
        return result

    def tokenize(self, text: str) -> List[str]:
        """Text → list of BPE token strings (reference tokenize())."""
        tokens: List[str] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for piece in re.findall(_PAT, text):
            piece = "".join(self.byte_encoder[b] for b in piece.encode("utf-8"))
            tokens.extend(self.bpe(piece).split(" "))
        return tokens

    def convert_tokens_to_ids(self, tokens: List[str]) -> List[int]:
        return [self.encoder[t] for t in tokens]

    def encode(self, text: str) -> List[int]:
        return self.convert_tokens_to_ids(self.tokenize(text))

    def decode(self, ids: List[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text
                        if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")
