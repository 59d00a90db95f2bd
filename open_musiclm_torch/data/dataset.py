"""Preprocessed-token crops and a threaded batch iterator (port of the
token half of open_musiclm_tpu/data/dataset.py).

``PreprocessedDataset`` cuts aligned whole-second windows from the token
store: an outer (CLAP + semantic) window and, for the coarse and fine
stages, an inner acoustic window inside it, with the same draws as the JAX
package for the same seed. ``SoundDataset`` and audio I/O are not ported.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import random
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .tokenstore import ShardedTokenStore


@dataclasses.dataclass
class PreprocessedDataset:
    """Aligned random window crops from the token store."""

    folder: str
    stage: str  # semantic | coarse | fine
    semantic_window_seconds: int = 10
    coarse_window_seconds: int = 4
    fine_window_seconds: int = 2
    semantic_steps_per_second: int = 50
    acoustic_steps_per_second: int = 75
    seed: int = 0

    def __post_init__(self):
        self.store = ShardedTokenStore(self.folder)
        self._rng = random.Random(self.seed)

    def __len__(self):
        return len(self.store)

    def _audio_length(self, clap=None, semantic=None, coarse=None, fine=None) -> int:
        lengths = []
        if clap is not None:
            lengths.append(clap.shape[0] + self.semantic_window_seconds - 1)
        if semantic is not None:
            lengths.append((semantic.shape[1] + 1) // self.semantic_steps_per_second)
        if coarse is not None:
            lengths.append(coarse.shape[1] // self.acoustic_steps_per_second)
        if fine is not None:
            lengths.append(fine.shape[1] // self.acoustic_steps_per_second)
        lengths = [int(n) for n in lengths]
        if len(set(lengths)) != 1:
            raise ValueError(f"audio lengths are not equal: {lengths}")
        return lengths[0]

    def _crop_semantic(self, ids, s, e):
        return ids[:, s * self.semantic_steps_per_second: e * self.semantic_steps_per_second - 1]

    def _crop_acoustic(self, ids, s, e):
        return ids[:, s * self.acoustic_steps_per_second: e * self.acoustic_steps_per_second]

    def __getitem__(self, i: int):
        if self.stage == "semantic":
            clap, semantic = (a.astype(np.int32) for a in self.store.get(i, ("clap", "semantic")))
            length = self._audio_length(clap=clap, semantic=semantic)
            s = self._rng.randint(0, length - self.semantic_window_seconds)
            e = s + self.semantic_window_seconds
            return (clap[s][None], self._crop_semantic(semantic, s, e))
        if self.stage not in ("coarse", "fine"):
            raise ValueError(self.stage)
        fields = ("clap", "semantic", "coarse") if self.stage == "coarse" else ("clap", "coarse", "fine")
        clap, mid, last = (a.astype(np.int32) for a in self.store.get(i, fields))
        if self.stage == "coarse":
            length = self._audio_length(clap=clap, semantic=mid, coarse=last)
            window = self.coarse_window_seconds
        else:
            length = self._audio_length(clap=clap, coarse=mid, fine=last)
            window = self.fine_window_seconds
        os_ = self._rng.randint(0, length - self.semantic_window_seconds)
        oe = os_ + self.semantic_window_seconds
        is_ = self._rng.randint(os_, oe - window)
        ie = is_ + window
        crop_mid = self._crop_semantic if self.stage == "coarse" else self._crop_acoustic
        return (clap[os_][None], crop_mid(mid, is_, ie), self._crop_acoustic(last, is_, ie))


def pad_to_longest(batch: List[Tuple[np.ndarray, ...]]) -> Tuple[np.ndarray, ...]:
    """Stack per-example tuples, right-padding dim 0 to the longest."""
    out = []
    for col in zip(*batch):
        maxlen = max(x.shape[0] for x in col)
        out.append(np.stack(
            [np.pad(x, [(0, maxlen - x.shape[0])] + [(0, 0)] * (x.ndim - 1)) for x in col]))
    return tuple(out)


def batch_iterator(
    dataset,
    batch_size: int,
    *,
    seed: int = 0,
    num_workers: int = 4,
    indices: Optional[Sequence[int]] = None,
) -> Iterator[Tuple[np.ndarray, ...]]:
    """Infinite threaded prefetching batch iterator over shuffled epochs.
    Token tuples from PreprocessedDataset are padded to the longest and
    flattened to [B, n] per sequence."""
    idxs = list(indices if indices is not None else range(len(dataset)))
    rng = random.Random(seed)

    def sample_indices():
        while True:
            order = idxs[:]
            rng.shuffle(order)
            yield from order

    index_stream = sample_indices()
    with concurrent.futures.ThreadPoolExecutor(num_workers) as pool:
        pending = []
        while True:
            while len(pending) < batch_size * 2:
                pending.append(pool.submit(dataset.__getitem__, next(index_stream)))
            items, pending = pending[:batch_size], pending[batch_size:]
            results = [r for r in (f.result() for f in items) if r is not None]
            while len(results) < batch_size:
                results.append(dataset[next(index_stream)])
            yield tuple(b.reshape(b.shape[0], -1) if b.ndim > 2 else b
                        for b in pad_to_longest(results))


def train_valid_split(n: int, valid_frac: float, seed: int = 42):
    """Random split of range(n) into (train, valid) index lists."""
    idxs = list(range(n))
    random.Random(seed).shuffle(idxs)
    n_valid = int(n * valid_frac)
    return idxs[n_valid:], idxs[:n_valid]
