"""Offline dataset tokenization (port of open_musiclm_tpu/data/preprocess.py).

Each track (repeat-padded to at least the semantic window, padded to a whole
second, cut to at most ``max_audio_length_seconds``) gives:
  1) CLAP conditioning tokens of every 10 s window at a 1 s hop, in batches
     of ``clap_batch_size`` windows through the frozen CLAP;
  2) semantic ids over the whole track (HuBERT + k-means);
  3) Encodec codes over the whole track, split into coarse and fine.
The tokenizers run on their device; the tokens go to the uint16 token store.
A rank takes the tracks ``i`` with ``i % world == rank`` and writes its own
shard (``tokenstore.writer_for_rank``). A track already in the shard is
skipped unless ``replace_existing``, so a restarted run picks up where it
stopped.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..models.clap.clap import ClapQuantized
from ..models.encodec import EncodecModel
from ..models.hubert import HubertWithKmeans
from .dataset import SoundDatasetForPreprocessing
from .pipeline import wave_on
from .tokenstore import writer_for_rank


@dataclasses.dataclass
class DataPreprocessor:
    clap: ClapQuantized
    wav2vec: HubertWithKmeans
    codec: EncodecModel
    folder: str
    results_folder: str
    num_coarse_quantizers: int = 3
    max_audio_length_seconds: int = 30
    clap_audio_length_seconds: int = 10
    semantic_audio_length_seconds: int = 10
    clap_batch_size: int = 32
    random_crop: bool = True
    num_crops: int = 1
    replace_existing: bool = False
    rank: int = 0
    world: int = 1
    ignore_files: Optional[list] = None

    def __post_init__(self):
        if self.clap_audio_length_seconds != self.semantic_audio_length_seconds:
            raise ValueError("the CLAP and semantic windows must be equal")
        self.ds = SoundDatasetForPreprocessing(
            folder=self.folder,
            pad_to_seconds=self.semantic_audio_length_seconds,
            max_length_seconds=(self.max_audio_length_seconds,) * 3,
            random_crop=self.random_crop,
            normalize=(False, True, False),
            target_sample_hz=(self.clap.sample_rate, self.wav2vec.target_sample_hz, self.codec.sample_rate),
            seq_len_multiple_of=(None, self.wav2vec.seq_len_multiple_of, None),
            ignore_files=self.ignore_files,
        )
        self.store = writer_for_rank(self.results_folder, self.rank, self.world)

    @torch.no_grad()
    def tokenize_track(self, wave_clap, wave_semantic, wave_acoustic):
        """Float32 views of one track -> numpy (clap [W, Q], semantic [1, T],
        coarse [1, T', q_c], fine [1, T', q_f]); stored 3-D as the JAX
        package stores them (crops index time on axis 1)."""
        device = self.codec.codebooks.device
        sr = self.clap.sample_rate
        win = self.clap_audio_length_seconds * sr
        n_windows = (len(wave_clap) - win) // sr + 1
        clap_tokens = []
        for i in range(0, n_windows, self.clap_batch_size):
            rows = [wave_clap[j * sr: j * sr + win] for j in range(i, min(i + self.clap_batch_size, n_windows))]
            clap_tokens.append(self.clap.tokenize_audio(wave_on(np.stack(rows), device))[..., 0].cpu().numpy())
        clap_ids = np.concatenate(clap_tokens, axis=0)
        sem = self.wav2vec(wave_on(wave_semantic[None], device)).cpu().numpy()
        codes = self.codec.encode(wave_on(wave_acoustic[None], device)).cpu().numpy()
        q = self.num_coarse_quantizers
        return clap_ids, sem, codes[..., :q], codes[..., q:]

    def process(self, progress=None) -> int:
        """Tokenize this rank's share of the dataset. Returns the rows written."""
        written = 0
        n_iters = self.num_crops * len(self.ds)
        for i in range(n_iters):
            if self.world > 1 and i % self.world != self.rank % self.world:
                continue
            item = self.ds[i % len(self.ds)]
            if item is None:
                continue
            if not self.replace_existing and self.store.has(i):
                continue
            clap_ids, sem, coarse, fine = self.tokenize_track(*item["data"])
            self.store.put(i, item["file_path"], clap_ids, sem, coarse, fine)
            written += 1
            if progress is not None:
                progress(i, n_iters)
        return written
