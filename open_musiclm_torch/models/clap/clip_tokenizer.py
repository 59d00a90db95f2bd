"""The CLIP BPE tokenizer of the ``transformer`` text branch (a copy of
open_musiclm_tpu/models/clap/clip_tokenizer.py).

Byte-level BPE with lowercasing, HTML unescaping, whitespace collapse and
word-final ``</w>`` markers over a gzipped merge list the caller supplies
(the standard ``bpe_simple_vocab_16e6.txt.gz``; its first 48,894 merges):
fixed-length [B, context_length] int32 arrays, each row
``<start_of_text>`` ids ``<end_of_text>`` then zeros. Pure Python, on the
host.
"""

from __future__ import annotations

import gzip
import html
import re
from typing import Dict, List

import numpy as np

from .tokenizer import bytes_to_unicode

_PAT = re.compile(
    r"<start_of_text>|<end_of_text>|'s|'t|'re|'ve|'m|'ll|'d|[A-Za-z]+|[0-9]|[^\sA-Za-z0-9]+",
    re.IGNORECASE,
)
NUM_MERGES = 49152 - 256 - 2


def _basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class ClipTokenizer:
    def __init__(self, bpe_path: str, context_length: int = 77):
        self.context_length = context_length
        self.byte_encoder = bytes_to_unicode()
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")[1:NUM_MERGES + 1]
        merges = [tuple(m.split()) for m in merges if m]
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab] + ["".join(m) for m in merges]
        vocab += ["<start_of_text>", "<end_of_text>"]
        self.encoder: Dict[str, int] = {v: i for i, v in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {"<start_of_text>": "<start_of_text>", "<end_of_text>": "<end_of_text>"}
        self.sot = self.encoder["<start_of_text>"]
        self.eot = self.encoder["<end_of_text>"]

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = [(word[i], word[i + 1]) for i in range(len(word) - 1)]
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            a, b = best
            new, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    new.append(a + b)
                    i += 2
                else:
                    new.append(word[i])
                    i += 1
            word = tuple(new)
        self.cache[token] = " ".join(word)
        return self.cache[token]

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in _PAT.findall(_whitespace_clean(_basic_clean(text)).lower()):
            mapped = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[p] for p in self._bpe(mapped).split(" ") if p in self.encoder)
        return ids

    def __call__(self, texts: List[str]) -> np.ndarray:
        """[B] strings -> [B, context_length] int32."""
        out = np.zeros((len(texts), self.context_length), np.int32)
        for i, t in enumerate(texts):
            ids = [self.sot] + self.encode(t)[: self.context_length - 2] + [self.eot]
            out[i, : len(ids)] = ids
        return out
