"""Token batches for the trainer (port of open_musiclm_tpu/data/pipeline.py).

``stage_ds_config`` gives the ``SoundDataset`` views a stage trains on;
``tokenizing_iterator`` turns those audio batches into token batches with
the frozen tokenizers (the CLAP audio tower and its RVQ, HuBERT with its
k-means codebook, the Encodec encoder) on their device, and
``accumulate_token_batches`` stacks batches a token store already holds.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

from ..models.clap.clap import ClapQuantized
from ..models.encodec import EncodecModel
from ..models.hubert import HubertWithKmeans


def stage_ds_config(stage: str, clap, wav2vec, codec, global_cfg) -> dict:
    """The ``SoundDataset`` fields of a stage's views: a semantic window at
    the CLAP's rate, then the semantic (HuBERT, normalized) and / or acoustic
    (Encodec) view of the stage's own window."""
    sem_s = global_cfg.semantic_audio_length_seconds
    coarse_s = global_cfg.coarse_audio_length_seconds
    fine_s = global_cfg.fine_audio_length_seconds
    if stage == "semantic":
        return dict(
            max_length_seconds=(sem_s, sem_s),
            target_sample_hz=(clap.sample_rate, wav2vec.target_sample_hz),
            normalize=(False, True),
            seq_len_multiple_of=(None, wav2vec.seq_len_multiple_of),
        )
    if stage == "coarse":
        return dict(
            max_length_seconds=(sem_s, coarse_s, coarse_s),
            target_sample_hz=(clap.sample_rate, wav2vec.target_sample_hz, codec.sample_rate),
            normalize=(False, True, False),
            seq_len_multiple_of=(None, wav2vec.seq_len_multiple_of, None),
        )
    if stage == "fine":
        return dict(
            max_length_seconds=(sem_s, fine_s),
            target_sample_hz=(clap.sample_rate, codec.sample_rate),
            normalize=(False, False),
            seq_len_multiple_of=(None, None),
        )
    raise ValueError(stage)


def wave_on(x, device) -> torch.Tensor:
    """An audio array (numpy, or a tensor on the CPU) as float32 on ``device``."""
    return torch.as_tensor(np.asarray(x, np.float32)).to(device)


def tokenize_audio_batch(stage: str, batch, clap: ClapQuantized, wav2vec: HubertWithKmeans,
                         codec: EncodecModel, num_coarse_quantizers: int = 3) -> Tuple[torch.Tensor, ...]:
    """One batch of a stage's views ([B, T_i] float32 each) -> its int64
    token sequences [B, n_i] on the tokenizers' device: the CLAP tokens,
    then the semantic ids and / or the coarse and fine codes, flattened
    time-major."""
    device = codec.codebooks.device
    with torch.no_grad():
        clap_ids = clap.tokenize_audio(wave_on(batch[0], device))[..., 0]
        if stage == "semantic":
            return clap_ids, wav2vec(wave_on(batch[1], device))
        codes = codec.encode(wave_on(batch[-1], device))
        b, q = codes.shape[0], num_coarse_quantizers
        if stage == "coarse":
            return clap_ids, wav2vec(wave_on(batch[1], device)), codes[..., :q].reshape(b, -1)
        if stage == "fine":
            return clap_ids, codes[..., :q].reshape(b, -1), codes[..., q:].reshape(b, -1)
    raise ValueError(stage)


def tokenizing_iterator(
    stage: str,
    audio_batches: Iterator[Tuple[np.ndarray, ...]],
    clap: ClapQuantized,
    wav2vec: HubertWithKmeans,
    codec: EncodecModel,
    num_coarse_quantizers: int = 3,
    accum: int = 1,
) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Token batches for StageTrainer: ``accum`` audio batches tokenized
    and stacked into int64 tensors [accum, B, n_i] on the tokenizers'
    device."""
    while True:
        micro = [tokenize_audio_batch(stage, next(audio_batches), clap, wav2vec, codec, num_coarse_quantizers)
                 for _ in range(accum)]
        yield tuple(torch.stack([m[i] for m in micro]) for i in range(len(micro[0])))


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
