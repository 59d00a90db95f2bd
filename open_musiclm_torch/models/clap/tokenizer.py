"""Host-side byte-level BPE tokenizer of the RoBERTa / GPT-2 family (a copy
of open_musiclm_tpu/models/clap/tokenizer.py).

A dependency-free pure-Python tokenizer over ``vocab.json`` + ``merges.txt``
that gives the fixed-length [B, 77] ``input_ids`` / ``attention_mask``
numpy arrays the RoBERTa tower takes. It follows the reference exactly,
quirks included: an ASCII-subset pretokenizer pattern (non-ASCII text is
split into byte runs by the catch-all class) and BPE pieces that are not in
the vocab silently dropped. Falls back to a cached ``transformers``
tokenizer when one is available locally.
"""

from __future__ import annotations

import functools
import json
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

# GPT-2's pretokenizer over ASCII classes (the original needs the regex
# module's \p classes); non-ASCII text falls to the catch-all class and is
# encoded bytewise below
_PAT = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d| ?[A-Za-z]+| ?[0-9]+| ?[^\sA-Za-z0-9]+|\s+(?!\S)|\s+"
)


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class ByteLevelBPE:
    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]]):
        self.vocab = vocab
        self.ranks = {m: i for i, m in enumerate(merges)}
        self.byte_enc = bytes_to_unicode()
        self.cache: Dict[str, List[str]] = {}

    @classmethod
    def from_files(cls, vocab_path: str, merges_path: str) -> "ByteLevelBPE":
        with open(vocab_path) as f:
            vocab = json.load(f)
        merges = []
        with open(merges_path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                a, b = line.split()
                merges.append((a, b))
        return cls(vocab, merges)

    def _bpe(self, token: str) -> List[str]:
        if token in self.cache:
            return self.cache[token]
        word = list(token)
        while len(word) > 1:
            pairs = [(word[i], word[i + 1]) for i in range(len(word) - 1)]
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            a, b = best
            new_word, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    new_word.append(a + b)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = new_word
        self.cache[token] = word
        return word

    def encode(self, text: str) -> List[int]:
        out: List[int] = []
        for tok in _PAT.findall(text):
            mapped = "".join(self.byte_enc[b] for b in tok.encode("utf-8"))
            for piece in self._bpe(mapped):
                if piece in self.vocab:
                    out.append(self.vocab[piece])
        return out


class RobertaTokenizer:
    """Minimal RoBERTa tokenizer: <s> ... </s>, pad to max_length.

    Special ids (roberta-base): <s>=0, <pad>=1, </s>=2, <unk>=3.
    """

    def __init__(self, bpe: ByteLevelBPE, bos: int = 0, eos: int = 2, pad: int = 1):
        self.bpe = bpe
        self.bos, self.eos, self.pad = bos, eos, pad

    @classmethod
    def from_dir(cls, path: str) -> "RobertaTokenizer":
        p = Path(path)
        return cls(ByteLevelBPE.from_files(str(p / "vocab.json"), str(p / "merges.txt")))

    def __call__(
        self, texts: List[str], max_length: int = 77
    ) -> Dict[str, np.ndarray]:
        ids_list, mask_list = [], []
        for t in texts:
            ids = [self.bos] + self.bpe.encode(t)[: max_length - 2] + [self.eos]
            mask = [1] * len(ids)
            ids = ids + [self.pad] * (max_length - len(ids))
            mask = mask + [0] * (max_length - len(mask))
            ids_list.append(ids)
            mask_list.append(mask)
        return {
            "input_ids": np.asarray(ids_list, dtype=np.int32),
            "attention_mask": np.asarray(mask_list, dtype=np.int32),
        }


def load_tokenizer(path: Optional[str] = None) -> "RobertaTokenizer":
    """Load from a local vocab dir, or fall back to a cached HF tokenizer."""
    if path is not None:
        return RobertaTokenizer.from_dir(path)
    try:  # only works if the HF cache already has roberta-base (no egress)
        from transformers import RobertaTokenizer as HFTok

        hf = HFTok.from_pretrained("roberta-base", local_files_only=True)

        class _Wrap:
            def __call__(self, texts, max_length=77):
                enc = hf(
                    texts,
                    padding="max_length",
                    truncation=True,
                    max_length=max_length,
                    return_tensors="np",
                )
                return {
                    "input_ids": enc["input_ids"].astype(np.int32),
                    "attention_mask": enc["attention_mask"].astype(np.int32),
                }

        return _Wrap()  # type: ignore[return-value]
    except Exception as exc:  # pragma: no cover
        raise FileNotFoundError(
            "No tokenizer vocab available: pass a directory containing "
            "vocab.json + merges.txt (roberta-base)."
        ) from exc
