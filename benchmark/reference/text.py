"""Plain reference of the text conditioning: byte-level BPE over the demo
vocabulary, RoBERTa-base, the CLAP text projection and the residual VQ,
written from the published architectures and independent of the program.

``bpe_ids``: the GPT-2 byte-level BPE for prompts of lowercase ASCII words
separated by single spaces (the only prompts the benchmark sends): each
word, with a leading space after the first ("Ġ"), is split into byte
symbols and merged by rank; ``<s>`` ids ``</s>``, padded with ``<pad>`` to
77. RoBERTa: post-LayerNorm BERT layers (eps 1e-5, exact GELU), positions
``cumsum(mask) * mask + 1``, the pooler ``tanh(dense(h[:, 0]))``; the
projection Linear, ReLU, Linear, then L2 normalisation. The RVQ picks, per
quantizer, the code maximising ``2 r.c - |c|^2`` and subtracts it.

``tf32=True`` rounds every product's operands to TF32 (10 mantissa bits,
to nearest), the control of a float32 tower run with TF32 off.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

BOS, PAD, EOS = 0, 1, 2
MAX_LEN = 77


def _byte_symbols() -> Dict[int, str]:
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    cs, n = bs[:], 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def bpe_ids(text: str, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]]) -> Tuple[List[int], List[int]]:
    if not all(w.isascii() and w.isalpha() and w.islower() for w in text.split(" ")):
        raise ValueError(f"the reference tokenizes lowercase ASCII words only: {text!r}")
    sym = _byte_symbols()
    rank = {m: i for i, m in enumerate(merges)}
    ids: List[int] = []
    for k, word in enumerate(text.split(" ")):
        parts = [sym[b] for b in ((" " if k else "") + word).encode()]
        while len(parts) > 1:
            pairs = [(rank.get((a, b), math.inf), i) for i, (a, b) in enumerate(zip(parts, parts[1:]))]
            r, i = min(pairs)
            if r == math.inf:
                break
            a, b = parts[i], parts[i + 1]
            out, j = [], 0
            while j < len(parts):
                if j < len(parts) - 1 and parts[j] == a and parts[j + 1] == b:
                    out.append(a + b)
                    j += 2
                else:
                    out.append(parts[j])
                    j += 1
            parts = out
        ids += [vocab[p] for p in parts if p in vocab]
    ids = [BOS] + ids[: MAX_LEN - 2] + [EOS]
    mask = [1] * len(ids) + [0] * (MAX_LEN - len(ids))
    return ids + [PAD] * (MAX_LEN - len(ids)), mask


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (to nearest)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class TextReference:
    def __init__(self, weights: Dict[str, torch.Tensor], codebooks: torch.Tensor, layers: int = 12,
                 heads: int = 12, tf32_products: bool = False):
        self.w = {k: v.detach().float() for k, v in weights.items()}
        self.books = codebooks.float()
        self.layers, self.heads = layers, heads
        self.round = tf32 if tf32_products else (lambda x: x)

    def _lin(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return self.round(x) @ self.round(self.w[name + ".weight"]).t() + self.w[name + ".bias"]

    def _ln(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.w[name + ".weight"], self.w[name + ".bias"], 1e-5)

    @torch.no_grad()
    def embedding(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """[b, 77] ids and mask -> [b, 512] unit joint embeddings."""
        p = "text_branch."
        pos = torch.cumsum(mask, dim=-1) * mask + PAD
        x = (self.w[p + "embeddings.word_embeddings.weight"][ids]
             + self.w[p + "embeddings.position_embeddings.weight"][pos]
             + self.w[p + "embeddings.token_type_embeddings.weight"][0])
        x = self._ln(x, p + "embeddings.LayerNorm")
        b, n, hid = x.shape
        keep = mask.bool()[:, None, None, :]
        for i in range(self.layers):
            q = f"{p}encoder.layer.{i}."

            def heads(name):
                return self._lin(x, q + name).reshape(b, n, self.heads, -1).transpose(1, 2)

            qh, kh, vh = heads("attention.self.query"), heads("attention.self.key"), heads("attention.self.value")
            s = self.round(qh / math.sqrt(qh.shape[-1])) @ self.round(kh).transpose(-1, -2)
            s = s.masked_fill(~keep, -math.inf).softmax(dim=-1)
            ctx = (self.round(s) @ self.round(vh)).transpose(1, 2).reshape(b, n, hid)
            x = self._ln(x + self._lin(ctx, q + "attention.output.dense"), q + "attention.output.LayerNorm")
            ff = F.gelu(self._lin(x, q + "intermediate.dense"))
            x = self._ln(x + self._lin(ff, q + "output.dense"), q + "output.LayerNorm")
        pooled = torch.tanh(self._lin(x[:, 0], p + "pooler.dense"))
        z = self._lin(F.relu(self._lin(pooled, "text_projection.0")), "text_projection.2")
        return z / z.norm(dim=-1, keepdim=True).clamp(min=1e-12)

    @torch.no_grad()
    def rvq_codes(self, emb: torch.Tensor) -> torch.Tensor:
        """[b, joint] -> [b, Q] the nearest-code choices, in float64."""
        r, books, codes = emb.double(), self.books.double(), []
        for book in books:
            c = (2.0 * r @ book.t() - (book * book).sum(-1)[None]).argmax(dim=-1)
            codes.append(c)
            r = r - book[c]
        return torch.stack(codes, dim=1)

    @torch.no_grad()
    def codes_exact(self, emb: torch.Tensor, codes: torch.Tensor) -> bool:
        """Whether ``codes`` are the nearest-code choices of ``emb`` (the
        residual following ``codes``), up to the float32 rounding of the
        scores: a chosen code may lie below the best by at most 1e-6 of the
        scores' magnitude (|best| + 2 |r| |c|), float32's is ~6e-8 a term."""
        r, books = emb.double(), self.books.double()
        for q, book in enumerate(books):
            score = 2.0 * r @ book.t() - (book * book).sum(-1)[None]
            c = codes[:, q]
            best = score.max(dim=-1).values
            scale = best.abs() + 2.0 * r.norm(dim=-1) * book.norm(dim=-1).max()
            if bool(((best - score.gather(-1, c[:, None])[:, 0]) > 1e-6 * scale).any()):
                return False
            r = r - book[c]
        return True
