"""Token batches for the trainer (port of ``accumulate_token_batches`` of
open_musiclm_tpu/data/pipeline.py; the audio-tokenizing path is not ported)."""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch


def accumulate_token_batches(
    token_batches: Iterator[Tuple[np.ndarray, ...]], accum: int
) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Stack ``accum`` token batches into ``torch.long`` tensors [accum, B, n]."""
    while True:
        micro = [next(token_batches) for _ in range(accum)]
        yield tuple(
            torch.from_numpy(np.stack([np.asarray(m[i], np.int64) for m in micro]))
            for i in range(len(micro[0]))
        )
