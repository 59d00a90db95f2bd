"""Audio crops, preprocessed-token crops and a threaded batch iterator
(port of open_musiclm_tpu/data/dataset.py).

``SoundDataset`` cuts nested multi-rate random crops of audio files.
``PreprocessedDataset`` cuts aligned whole-second windows from the token
store: an outer (CLAP + semantic) window and, for the coarse and fine
stages, an inner acoustic window inside it. Both draw their crops from one
``random.Random(seed)`` in the JAX package's order, and both can ``skip``
an item: draw its crops from its length alone, so that a data-parallel
rank keeps the one-process draws while it reads only its own rows
(``batch_iterator``).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import random
from pathlib import Path
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .audio_io import audio_info, read_audio, resample_np
from .tokenstore import ShardedTokenStore

AUDIO_EXTS = ("wav", "flac", "mp3")


def zero_mean_unit_var_np(x: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """Each row to zero mean and unit (unbiased) variance."""
    n = x.shape[-1]
    var = x.var(axis=-1, keepdims=True) * n / max(n - 1, 1)
    return (x - x.mean(axis=-1, keepdims=True)) / np.sqrt(var + eps)


def int16_round_trip_np(x: np.ndarray) -> np.ndarray:
    return ((np.clip(x, -1.0, 1.0) * 32767.0).astype(np.int16)).astype(np.float32) / 32767.0


def _cast_tuple(v, n):
    return v if isinstance(v, tuple) else (v,) * n


@dataclasses.dataclass
class SoundDataset:
    """Nested multi-rate views of random crops of the audio files under
    ``folder``: one view per entry of ``target_sample_hz``."""

    folder: str
    max_length_seconds: Tuple[Optional[float], ...] = (1.0,)
    normalize: Tuple[bool, ...] = (False,)
    target_sample_hz: Tuple[Optional[int], ...] = (None,)
    seq_len_multiple_of: Tuple[Optional[int], ...] = (None,)
    ignore_files: Optional[List[str]] = None
    ignore_load_errors: bool = True
    random_crop: bool = True
    exts: Tuple[str, ...] = AUDIO_EXTS
    seed: int = 0

    def __post_init__(self):
        n = len(self.target_sample_hz)
        self.max_length_seconds = _cast_tuple(self.max_length_seconds, n)
        self.normalize = _cast_tuple(self.normalize, n)
        self.seq_len_multiple_of = _cast_tuple(self.seq_len_multiple_of, n)
        ignore = {f.split("/")[-1] for f in (self.ignore_files or [])}
        files: List[Path] = []
        for ext in self.exts:
            files.extend(f for f in Path(self.folder).glob(f"**/*.{ext}") if f.name not in ignore)
        if not files:
            raise FileNotFoundError(f"no sound files found in {self.folder}")
        self.files = sorted(files)
        self._rng = random.Random(self.seed)

    def __len__(self) -> int:
        return len(self.files)

    def _load(self, idx: int) -> Tuple[np.ndarray, int]:
        data, sr = read_audio(str(self.files[idx]))
        return data[None, :], sr  # [1, T] mono

    def __getitem__(self, idx: int):
        try:
            data, sr = self._load(idx)
        except Exception:
            if self.ignore_load_errors:
                return self[self._rng.randrange(len(self))]
            raise
        return self.process_audio(data, sr, pad_to_target_length=True)

    def skip(self, idx: int) -> None:
        """The crop draws of ``self[idx]``, from the file's length alone
        (``audio_info``: headers, no samples decoded)."""
        try:
            frames, sr = audio_info(str(self.files[idx]))
        except Exception:
            if self.ignore_load_errors:
                return self.skip(self._rng.randrange(len(self)))
            raise
        self._crop_plan(frames, sr, pad_to_target_length=True)

    def _crop_plan(self, audio_len: int, sample_hz: int, pad_to_target_length: bool):
        """Per view, longest first: (view index, ("crop", start, length) or
        ("pad", samples) or None), drawing the crop starts."""
        plan = []
        order = sorted(enumerate(self.max_length_seconds), key=lambda t: (t[1] is not None, t[1]))
        for unsorted_i, max_len_s in order:
            op = None
            if max_len_s is not None:
                target = int(max_len_s * sample_hz)
                if audio_len > target:
                    start = self._rng.randrange(audio_len - target) if self.random_crop else 0
                    op, audio_len = ("crop", start, target), target
                elif pad_to_target_length:
                    op, audio_len = ("pad", target - audio_len), target
            plan.append((unsorted_i, op))
        return plan

    def process_audio(self, data: np.ndarray, sample_hz: int, pad_to_target_length: bool = True):
        """[1, T] at ``sample_hz`` -> one float32 [T_i] view per target rate
        (a bare array when there is one view). Longest view first: a view
        shorter than the audio so far is a random crop of it, a longer one
        is zero-padded when ``pad_to_target_length``."""
        temp, temp_norm = data, zero_mean_unit_var_np(data)
        n = len(self.target_sample_hz)
        views: List[Optional[np.ndarray]] = [None] * n
        for unsorted_i, op in self._crop_plan(temp.shape[1], sample_hz, pad_to_target_length):
            if op is not None and op[0] == "crop":
                _, start, target = op
                temp = temp[:, start: start + target]
                temp_norm = temp_norm[:, start: start + target]
            elif op is not None:
                temp = np.pad(temp, ((0, 0), (0, op[1])))
                temp_norm = np.pad(temp_norm, ((0, 0), (0, op[1])))
            views[unsorted_i] = temp_norm if self.normalize[unsorted_i] else temp

        out = []
        for i, (view, tsr, mult) in enumerate(zip(views, self.target_sample_hz, self.seq_len_multiple_of)):
            v = view
            if tsr is not None and tsr != sample_hz:
                v = resample_np(v[0], sample_hz, tsr)[None]
            if not self.normalize[i]:
                v = int16_round_trip_np(v)
            v = v[0]
            if mult is not None:
                v = v[: (len(v) // mult) * mult]
            out.append(v.astype(np.float32))
        return out[0] if n == 1 else tuple(out)


@dataclasses.dataclass
class SoundDatasetForPreprocessing(SoundDataset):
    """Whole tracks: a track shorter than ``pad_to_seconds`` is repeated
    and zero-padded up to it, a longer one zero-padded to a whole second
    (a whole second more when it already is one), then cut into views as
    ``SoundDataset`` does without padding. An unreadable file gives None."""

    pad_to_seconds: int = 10

    def __getitem__(self, idx: int):
        try:
            data, sr = self._load(idx)
        except Exception:
            if self.ignore_load_errors:
                return None
            raise
        max_len = self.pad_to_seconds * sr
        T = data.shape[1]
        if T < max_len:
            data = np.tile(data, (1, max_len // T))
            data = np.pad(data, ((0, 0), (0, max_len - data.shape[1])))
        else:
            data = np.pad(data, ((0, 0), (0, sr - T % sr)))
        return {"idx": idx, "data": self.process_audio(data, sr, pad_to_target_length=False),
                "file_path": str(self.files[idx])}


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

    def _rows(self, i: int):
        fields = {"semantic": ("clap", "semantic"), "coarse": ("clap", "semantic", "coarse"),
                  "fine": ("clap", "coarse", "fine")}.get(self.stage)
        if fields is None:
            raise ValueError(self.stage)
        return tuple(a.astype(np.int32) for a in self.store.get(i, fields))

    def _windows(self, rows):
        """The crop draws of one row: (outer start, outer end, inner start,
        inner end) in seconds (the inner window is the outer one for the
        semantic stage)."""
        if self.stage == "semantic":
            clap, semantic = rows
            length = self._audio_length(clap=clap, semantic=semantic)
            s = self._rng.randint(0, length - self.semantic_window_seconds)
            return s, s + self.semantic_window_seconds, s, s + self.semantic_window_seconds
        clap, mid, last = rows
        if self.stage == "coarse":
            length = self._audio_length(clap=clap, semantic=mid, coarse=last)
            window = self.coarse_window_seconds
        else:
            length = self._audio_length(clap=clap, coarse=mid, fine=last)
            window = self.fine_window_seconds
        os_ = self._rng.randint(0, length - self.semantic_window_seconds)
        oe = os_ + self.semantic_window_seconds
        is_ = self._rng.randint(os_, oe - window)
        return os_, oe, is_, is_ + window

    def __getitem__(self, i: int):
        rows = self._rows(i)
        os_, oe, is_, ie = self._windows(rows)
        if self.stage == "semantic":
            clap, semantic = rows
            return (clap[os_][None], self._crop_semantic(semantic, os_, oe))
        clap, mid, last = rows
        crop_mid = self._crop_semantic if self.stage == "coarse" else self._crop_acoustic
        return (clap[os_][None], crop_mid(mid, is_, ie), self._crop_acoustic(last, is_, ie))

    def skip(self, i: int) -> None:
        """The crop draws of ``self[i]`` (the row's token arrays are read for
        their lengths; nothing is cut)."""
        self._windows(self._rows(i))


def pad_to_longest(batch: List[Tuple[np.ndarray, ...]]) -> Tuple[np.ndarray, ...]:
    """Stack per-example tuples, right-padding dim 0 to the longest. A bare
    array (a one-view ``SoundDataset``) is a tuple of one."""
    batch = [(x,) if isinstance(x, np.ndarray) else x for x in batch]
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
    shuffle: bool = True,
    seed: int = 0,
    num_workers: int = 4,
    collate=pad_to_longest,
    indices: Optional[Sequence[int]] = None,
    flatten_token_batches: bool = True,
    rank: int = 0,
    world: int = 1,
) -> Iterator[Tuple[np.ndarray, ...]]:
    """Infinite threaded prefetching batch iterator over (shuffled) epochs,
    two batches ahead. With ``flatten_token_batches`` the token tuples of
    PreprocessedDataset are flattened to [B, n] per sequence; audio views
    stay [B, T].

    ``batch_size`` is the global batch: every rank walks the same shuffled
    order (the same ``seed``) and this rank gets rows ``[rank * B / world,
    (rank + 1) * B / world)`` of each, so the ranks' batches put together
    are the one-process batch. The other rows go through the dataset's
    ``skip``, which draws their crops without reading their samples, so
    that the dataset's crop draws stay in the one-process order (at one
    worker). An item that comes back None is an error."""
    if batch_size % world or not 0 <= rank < world:
        raise ValueError(f"a global batch of {batch_size} does not split over {world} ranks (rank {rank})")
    per = batch_size // world
    mine = range(rank * per, (rank + 1) * per)
    idxs = list(indices if indices is not None else range(len(dataset)))
    index_stream = _index_stream(idxs, shuffle, seed)
    with concurrent.futures.ThreadPoolExecutor(num_workers) as pool:
        def submit():
            # the skips go through the pool too, so that at one worker every
            # crop is drawn in the one-process order
            return [pool.submit(dataset.__getitem__ if j in mine else dataset.skip, next(index_stream))
                    for j in range(batch_size)]

        pending = [submit(), submit()]
        while True:
            futures = pending.pop(0)
            pending.append(submit())
            results = [f.result() for f in futures]
            rows = [results[j] for j in mine]
            if any(r is None for r in rows):
                raise ValueError("batch_iterator needs a dataset whose items are never None")
            batch = collate(rows)
            if flatten_token_batches:
                batch = tuple(b.reshape(b.shape[0], -1) if b.ndim > 2 else b for b in batch)
            yield batch


def _index_stream(idxs: List[int], shuffle: bool, seed: int) -> Iterator[int]:
    rng = random.Random(seed)
    while True:
        order = idxs[:]
        if shuffle:
            rng.shuffle(order)
        yield from order


def train_valid_split(n: int, valid_frac: float, seed: int = 42):
    """Random split of range(n) into (train, valid) index lists."""
    idxs = list(range(n))
    random.Random(seed).shuffle(idxs)
    n_valid = int(n * valid_frac)
    return idxs[n_valid:], idxs[:n_valid]
