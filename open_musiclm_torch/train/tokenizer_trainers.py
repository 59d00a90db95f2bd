"""Tokenizer fitting: the CLAP RVQ's EMA codebooks and the semantic k-means
(port of open_musiclm_tpu/train/tokenizer_trainers.py).

* ``ClapRVQTrainer``: each step embeds ``accumulate_batches`` audio batches
  with the frozen CLAP, then takes one EMA codebook step (``rvq_update``)
  over all of them and logs the quantization MSE. Embeddings and updates run
  on the CLAP's device. Checkpoints are ``clap.rvq.{step}.ckpt`` holding the
  whole ``RVQState``.
* ``HubertKmeansTrainer``: phase 1 extracts HuBERT features of
  ``feature_extraction_num_steps`` audio batches on the card and gathers
  them on the host (rows with a NaN dropped); phase 2 fits count-weighted
  minibatch k-means on the card over host-shuffled batches, and writes
  ``kmeans.ckpt`` (centroids and inertia).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from ..checkpoint import save_checkpoint
from ..data.pipeline import wave_on as _on
from ..models.clap.clap import ClapQuantized
from ..models.hubert import HubertWithKmeans
from ..models.kmeans import KMeansState, kmeans_inertia, minibatch_kmeans_init, minibatch_kmeans_update
from ..models.rvq import RVQState


@dataclasses.dataclass
class ClapRVQTrainer:
    """audio batches -> CLAP embeddings -> EMA residual-VQ codebooks."""

    clap: ClapQuantized
    results_folder: str
    num_train_steps: int
    accumulate_batches: int = 32
    rq_ema_decay: float = 0.95
    threshold_ema_dead_code: float = 0.0
    save_model_every: int = 10
    save_results_every: int = 5

    def __post_init__(self):
        Path(self.results_folder).mkdir(parents=True, exist_ok=True)

    def checkpoint_path(self, step: int) -> str:
        return str(Path(self.results_folder) / f"clap.rvq.{step}.ckpt")

    def train(self, audio_iter: Iterator[np.ndarray], generator: Optional[torch.Generator] = None,
              log: Optional[Callable] = None) -> RVQState:
        """``num_train_steps`` steps over [B, T] audio batches at the CLAP's
        rate; ``generator`` (on the CLAP's device) draws the k-means seeds
        and the dead-code samples. Leaves the new RVQ on ``self.clap``."""
        clap = self.clap
        device = clap.rvq.codebooks.device
        for step in range(self.num_train_steps):
            x = torch.cat([clap.audio_embedding(_on(next(audio_iter), device))
                           for _ in range(self.accumulate_batches)])
            clap, mse = clap.learn_rvq_step(
                x, generator, decay=self.rq_ema_decay, threshold_ema_dead_code=self.threshold_ema_dead_code)
            if log is not None and step % self.save_results_every == 0:
                log(step=step, rvq_mse=float(mse))
            if step % self.save_model_every == 0 or step == self.num_train_steps - 1:
                save_checkpoint(self.checkpoint_path(step), clap.rvq._asdict())
        self.clap.rvq = clap.rvq
        return clap.rvq


@dataclasses.dataclass
class HubertKmeansTrainer:
    """HuBERT features -> the semantic k-means codebook."""

    hubert_kmeans: HubertWithKmeans
    results_folder: str
    feature_extraction_num_steps: int = 320
    n_clusters: int = 1024
    fit_batch_size: int = 10000

    def __post_init__(self):
        Path(self.results_folder).mkdir(parents=True, exist_ok=True)

    def extract_features(self, audio_iter: Iterator[np.ndarray]) -> np.ndarray:
        """Phase 1: [N, H] float32 features on the host, rows with a NaN dropped."""
        device = self.hubert_kmeans.centroids.device
        feats = []
        for _ in range(self.feature_extraction_num_steps):
            emb = self.hubert_kmeans.features(_on(next(audio_iter), device)).cpu().numpy()
            emb = emb.reshape(-1, emb.shape[-1])
            feats.append(emb[~np.isnan(emb).any(axis=-1)])
        return np.concatenate(feats, axis=0)

    def fit(self, features: np.ndarray, generator: Optional[torch.Generator] = None,
            epochs: int = 3) -> KMeansState:
        """Phase 2: k-means++ on the first max(K, fit_batch_size) rows, then
        minibatch Lloyd's over ``epochs`` shuffles (numpy seed 0) in batches
        of ``fit_batch_size``, on the centroids' device."""
        device = self.hubert_kmeans.centroids.device
        state = minibatch_kmeans_init(
            _on(features[: max(self.n_clusters, self.fit_batch_size)], device), self.n_clusters, generator)
        n = len(features)
        rs = np.random.RandomState(0)
        for _ in range(epochs):
            order = rs.permutation(n)
            for i in range(0, n - self.fit_batch_size + 1, self.fit_batch_size):
                state = minibatch_kmeans_update(state, _on(features[order[i: i + self.fit_batch_size]], device))
        return state

    def train(self, audio_iter: Iterator[np.ndarray], generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Both phases; writes ``kmeans.ckpt`` and sets the codebook of
        ``hubert_kmeans``. Returns the [K, H] centroids on the host."""
        features = self.extract_features(audio_iter)
        state = self.fit(features, generator)
        inertia = kmeans_inertia(_on(features[:10000], state.centroids.device), state.centroids)
        centroids = state.centroids.cpu()
        save_checkpoint(str(Path(self.results_folder) / "kmeans.ckpt"),
                        {"centroids": centroids, "inertia": inertia.float().cpu()})
        self.hubert_kmeans.centroids = state.centroids.to(self.hubert_kmeans.centroids)
        return centroids
