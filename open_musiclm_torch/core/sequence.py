"""Token-sequence specifications and static sequence layouts.

Port of open_musiclm_tpu/core/sequence.py (pure Python + numpy there too):
the multi-sequence stream is ``[start_0, tokens_0, start_1, tokens_1, ...]``
with every offset known from the shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenSequenceSpec:
    """One token sequence of a token-conditioned stage.

    ``codebook_size`` real codes per quantizer (EOS id == codebook_size),
    ``num_quantizers`` interleaved per timestep.
    """

    codebook_size: int
    num_quantizers: int = 1
    unique_consecutive: bool = False

    @property
    def eos_id(self) -> int:
        return self.codebook_size

    @property
    def vocab_with_eos(self) -> int:
        return self.codebook_size + 1

    @property
    def embed_vocab(self) -> int:
        """Rows of the flattened embedding table: ``(codebook_size + 1) * Q``
        while quantizer offsets are ``q * codebook_size``, so quantizer q's EOS
        row aliases code 0 of quantizer q+1 (kept for checkpoint parity)."""
        return self.vocab_with_eos * self.num_quantizers


@dataclasses.dataclass(frozen=True)
class SequenceLayout:
    """Layout of a concatenated multi-sequence stream; ``lengths`` are the
    per-sequence flattened token counts (after any EOS append)."""

    specs: Tuple[TokenSequenceSpec, ...]
    lengths: Tuple[int, ...]

    def __post_init__(self):
        if len(self.specs) != len(self.lengths):
            raise ValueError("one length per spec")

    @property
    def start_positions(self) -> Tuple[int, ...]:
        pos, out = 0, []
        for n in self.lengths:
            out.append(pos)
            pos += n + 1
        return tuple(out)

    def pred_slice(self, i: int) -> Tuple[int, int]:
        """(begin, length) of the outputs that predict sequence i's tokens:
        the window starting at its start token."""
        return self.start_positions[i], self.lengths[i]


def quantizer_offsets(spec: TokenSequenceSpec, length: int) -> np.ndarray:
    """offset[t] = (t % Q) * codebook_size (codebook_size, not +1)."""
    return (np.arange(length) % spec.num_quantizers) * spec.codebook_size
