"""MusicLM hierarchy from text to waveform
(port of open_musiclm_tpu/models/musiclm.py).

text -> BPE tokenizer -> CLAP text tower -> RVQ -> 12 conditioning tokens
(or precomputed tokens) -> semantic stage (sliding windows with 50 %
overlap) -> coarse stage over 4 s semantic windows (continuing from the
previous window's last coarse tokens) -> fine stage over 2 s coarse windows
(non-overlapping windows decode as one batched call) -> Encodec decode.
Sampling draws come from a generator or from per-row keys.

Audio-prompt continuation: a prime wave's HuBERT + k-means semantic ids and
Encodec codes seed the first window of each stage; the outputs' fronts are
trimmed and the prime's codes prepended. ``generate_top_match`` reranks
``num_samples`` generations a prompt by CLAP audio-text similarity.

Multi-card layouts: ``serving_mesh`` (a ``parallel.mesh.Mesh``) serves the
prompts in parallel over its ``dp`` axis: every stage call decodes each
rank's rows and gathers them (``Stage.generate(mesh=)``), and each rank
decodes its own rows through Encodec and gathers the waves. It needs
``per_row_keys``, and every rank calls ``generate`` with the same arguments
(SPMD). ``to_pipelined(devices)`` puts the semantic, coarse and fine stages
and the codec each on its own device; the segments move between them at
the JAX package's ``_put`` call sites.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from typing import Any, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..core.sampling import fold_in_rows
from ..ops.audio import int16_round_trip, prepare_audio, resample
from ..parallel.mesh import Mesh, shard_batch
from .clap.clap import ClapQuantized
from .encodec import EncodecModel
from .hubert import HubertWithKmeans
from .stages import Stage

# Encodec decodes at most this many rows * frames per head call; the stem
# runs once for the whole batch. Chunking is value-identical.
# $OPEN_MUSICLM_MAX_DECODE_FRAMES overrides it at call time, as in the JAX package.
MAX_DECODE_FRAMES = 36000
# at most this many rows (prompts x fine windows) per batched fine decode;
# $OPEN_MUSICLM_MAX_FINE_ROWS overrides it at call time
MAX_FINE_ROWS = 256


def max_decode_frames() -> int:
    """``$OPEN_MUSICLM_MAX_DECODE_FRAMES``, else ``MAX_DECODE_FRAMES``."""
    return int(os.environ.get("OPEN_MUSICLM_MAX_DECODE_FRAMES", MAX_DECODE_FRAMES))


def max_fine_rows() -> int:
    """``$OPEN_MUSICLM_MAX_FINE_ROWS``, else ``MAX_FINE_ROWS``."""
    return int(os.environ.get("OPEN_MUSICLM_MAX_FINE_ROWS", MAX_FINE_ROWS))


def unfold_windows(x: torch.Tensor, window: int, step: int) -> torch.Tensor:
    """[b, L, q] -> [n, b, window, q] sliding windows, n = (L - window) // step + 1."""
    return x.unfold(1, window, step).permute(1, 0, 3, 2)


def _gather_span(segments: Sequence[torch.Tensor], start: int, length: int) -> torch.Tensor:
    """``torch.cat(segments, 1)[:, start:start + length]`` without building
    the full concatenation."""
    parts, off = [], 0
    for seg in segments:
        L = seg.shape[1]
        lo, hi = max(start, off), min(start + length, off + L)
        if lo < hi:
            parts.append(seg[:, lo - off: hi - off])
        off += L
    if not parts or sum(p.shape[1] for p in parts) != length:
        raise ValueError(f"span [{start}, {start + length}) outside segments (total {off})")
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def _put(x: Optional[torch.Tensor], device: Optional[torch.device]) -> Optional[torch.Tensor]:
    """``x`` on a stage's device when the stages are placed; as it is
    otherwise or for None."""
    return x if x is None or device is None else x.to(device)


def _module_on(module: nn.Module, device: torch.device) -> nn.Module:
    """``module`` itself when it lies on ``device``, else a copy there."""
    tensors = list(module.parameters()) + list(module.buffers())
    if all(t.device == device for t in tensors):
        return module
    return copy.deepcopy(module).to(device)


@dataclasses.dataclass
class MusicLM:
    """``clap`` and ``tokenizer`` (any callable giving numpy ``input_ids``
    and ``attention_mask`` for a list of texts) serve text prompts; without
    them ``generate`` takes precomputed CLAP tokens only. ``wav2vec``
    (HuBERT + k-means) serves audio prompts. ``stage_devices`` (semantic,
    coarse, fine, codec) is set by ``to_pipelined``; ``serving_mesh`` shards
    every stage's prompts over its ``dp`` axis (the module docstring)."""

    codec: EncodecModel
    semantic_stage: Stage
    coarse_stage: Stage
    fine_stage: Stage
    clap: Optional[ClapQuantized] = None
    tokenizer: Any = None
    wav2vec: Optional[HubertWithKmeans] = None
    stage_devices: Optional[Tuple[torch.device, torch.device, torch.device, torch.device]] = None
    serving_mesh: Optional[Mesh] = None

    def to_pipelined(self, devices: Sequence[Any]) -> "MusicLM":
        """A copy with the semantic, coarse and fine stages and the codec on
        ``devices[i % len(devices)]`` (i = 0..3), each stage's module copied
        there; one device gives the unpipelined layout. Values equal the
        unpipelined path's: only the placement changes."""
        devs = tuple(torch.device(devices[i % len(devices)]) for i in range(4))

        def stage_on(stage: Stage, dev: torch.device) -> Stage:
            model = _module_on(stage.model, dev)
            return stage if model is stage.model else dataclasses.replace(stage, model=model)

        return dataclasses.replace(
            self, semantic_stage=stage_on(self.semantic_stage, devs[0]),
            coarse_stage=stage_on(self.coarse_stage, devs[1]), fine_stage=stage_on(self.fine_stage, devs[2]),
            codec=_module_on(self.codec, devs[3]), stage_devices=devs)

    def clap_tokens_from_text(self, text: List[str]) -> torch.Tensor:
        """Texts -> [b, Q, 1] CLAP tokens on the CLAP's device."""
        if self.tokenizer is None or self.clap is None:
            raise ValueError("text prompts need a tokenizer and a CLAP: pass both, or "
                             "precomputed clap_token_ids")
        enc = self.tokenizer(text)
        return self.clap.tokenize_text(enc["input_ids"], enc["attention_mask"])

    @torch.no_grad()
    def _decode(self, codes: torch.Tensor) -> torch.Tensor:
        """Encodec decode; with a ``serving_mesh`` each ``dp`` rank decodes
        its rows and the waves are gathered."""
        codes = codes.to(self.codec.codebooks.device)
        mesh = self.serving_mesh
        if mesh is None:
            return self._decode_rows(codes)
        return mesh.all_gather_rows(self._decode_rows(shard_batch(mesh, codes)))

    def _decode_rows(self, codes: torch.Tensor) -> torch.Tensor:
        """Encodec decode with the batch chunked under ``max_decode_frames()``; on
        the card a row at a time: cuDNN picks its convolution and LSTM
        algorithms by the batch's size, and a row's wave would move by ~1e-6
        with its companions (``chip_smoke.py --probe``)."""
        b, T = codes.shape[0], codes.shape[1]
        if codes.is_cuda and b > 1:
            return torch.cat([self._decode_rows(codes[i:i + 1]) for i in range(b)])
        rows = max(1, max_decode_frames() // max(T, 1))
        if b <= rows:
            return self.codec.decode(codes)
        if rows > 8:
            rows -= rows % 8
        h = self.codec.decode_stem(codes)
        return torch.cat(
            [self.codec.decode_head(h[i: i + rows]) for i in range(0, b, rows)], dim=0
        )

    def _prime_tokens(self, prime_wave, sample_hz: Optional[int], batch: int, seconds: float):
        """The prime's first ``seconds``: semantic ids [1, t, 1] (HuBERT +
        k-means) and Encodec codes [1, t', n_q]."""
        if sample_hz is None or self.wav2vec is None:
            raise ValueError("a prime wave needs prime_wave_sample_hz and a wav2vec (HuBERT + k-means)")
        prime = torch.as_tensor(prime_wave, dtype=torch.float32)
        if prime.ndim == 1:
            prime = prime[None]
        wav_sem = prepare_audio(prime.to(self.wav2vec.centroids.device), sample_hz,
                                self.wav2vec.target_sample_hz, target_length_seconds=seconds)
        if wav_sem.shape[0] != batch:
            raise ValueError(
                f"continuation takes one prime for one prompt row: the prepared prime has "
                f"{wav_sem.shape[0]} row(s) (a [C, T] prime is mixed to mono), the prompts {batch}")
        wav_enc = prepare_audio(prime.to(self.codec.codebooks.device), sample_hz, self.codec.sample_rate,
                                normalize=False, target_length_seconds=seconds)
        return self.wav2vec(wav_sem)[..., None], self.codec.encode(wav_enc)

    @torch.no_grad()
    def generate(
        self,
        *,
        text: Optional[List[str]] = None,
        clap_token_ids: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        per_row_keys: Optional[torch.Tensor] = None,
        prime_wave: Optional[torch.Tensor] = None,
        prime_wave_sample_hz: Optional[int] = None,
        output_seconds: float = 8,
        semantic_window_seconds: int = 10,
        coarse_window_seconds: int = 4,
        fine_window_seconds: int = 2,
        semantic_steps_per_second: int = 50,
        acoustic_steps_per_second: int = 75,
        return_coarse_generated_wave: bool = False,
        semantic_sliding_window_step_percent: float = 0.5,
        coarse_sliding_window_step_percent: float = 0.5,
        fine_sliding_window_step_percent: float = 1.0,
        semantic_temperature: float = 1.0,
        coarse_temperature: float = 0.95,
        fine_temperature: float = 0.4,
        semantic_filter_thres: float = 0.9,
        coarse_filter_thres: float = 0.9,
        fine_filter_thres: float = 0.9,
    ) -> torch.Tensor:
        """``text`` (b prompts) or ``clap_token_ids`` [b, n_clap(, 1)] ->
        waveform [b, samples]. The sampling draws come from ``generator``
        (the stages' device) or, given ``per_row_keys`` ([b] keys of
        ``core.sampling``), row i's from its own key only, whatever the batch
        around it; ``generator`` is then ignored. Each window folds (stage,
        window) into the keys.

        ``prime_wave`` ([T], or [C, T] mixed to mono, at
        ``prime_wave_sample_hz``) continues a clip: one prime, so one prompt
        row. The returned wave starts with the prime's first
        ``semantic_window_seconds`` as Encodec codes. With
        ``return_coarse_generated_wave`` the coarse windows are decoded
        alone, untrimmed.

        With a ``serving_mesh`` every rank of the mesh makes this call with
        the same arguments, ``per_row_keys`` among them, and gets every row's
        wave."""
        if output_seconds < coarse_window_seconds:
            raise ValueError(
                f"output_seconds={output_seconds} is shorter than the coarse "
                f"window ({coarse_window_seconds} s): generate at least one coarse window."
            )
        if clap_token_ids is None:
            if text is None:
                raise ValueError("generate needs text or clap_token_ids")
            clap_token_ids = self.clap_tokens_from_text(text)
        b = clap_token_ids.shape[0]
        clap = clap_token_ids.reshape(b, -1)

        def row_keys(stage: int, window: int) -> Optional[torch.Tensor]:
            return None if per_row_keys is None else fold_in_rows(per_row_keys, stage, window)

        dev_sem, dev_coarse, dev_fine, _ = self.stage_devices or (None,) * 4
        mesh = self.serving_mesh

        # audio-prompt continuation: the prime's tokens seed each stage's
        # first window, and the front trims drop what the prime covers
        cond_semantic = cond_coarse = cond_fine = prime_codes = None
        semantic_adj = coarse_adj = fine_adj = 0
        if prime_wave is not None:
            sem_ids, prime_codes = self._prime_tokens(prime_wave, prime_wave_sample_hz, b,
                                                      semantic_window_seconds)
            n_coarse = self.coarse_stage.model.specs[-1].num_quantizers
            sem_carry = int(semantic_steps_per_second * semantic_window_seconds
                            * (1 - semantic_sliding_window_step_percent))
            coarse_carry = int(acoustic_steps_per_second * coarse_window_seconds
                               * (1 - coarse_sliding_window_step_percent))
            fine_carry = int(acoustic_steps_per_second * fine_window_seconds
                             * (1 - fine_sliding_window_step_percent))
            cond_semantic = _put(sem_ids[:, -sem_carry:] if sem_ids.shape[1] >= sem_carry else sem_ids, dev_sem)
            cond_coarse = _put(prime_codes[:, -coarse_carry:, :n_coarse], dev_coarse)
            cond_fine = _put(prime_codes[:, -fine_carry:, n_coarse:] if fine_carry > 0 else None, dev_fine)
            semantic_adj = sem_carry - int(semantic_steps_per_second * coarse_window_seconds
                                           * (1 - coarse_sliding_window_step_percent))
            coarse_adj = coarse_carry - int(acoustic_steps_per_second * fine_window_seconds
                                            * (1 - fine_sliding_window_step_percent))
            fine_adj = fine_carry

        def front(total: int, adj: int) -> int:
            """Where a trimmed output starts: ``x[:, adj:]`` for either sign."""
            return adj if adj >= 0 else max(total + adj, 0)

        clap_sem, clap_coarse, clap_fine = _put(clap, dev_sem), _put(clap, dev_coarse), _put(clap, dev_fine)

        # ---- semantic stage: sliding-window AR ----
        first_T = int(min(output_seconds, semantic_window_seconds) * semantic_steps_per_second)
        sem_kw = dict(temperature=semantic_temperature, filter_thres=semantic_filter_thres, mesh=mesh)
        sem_segments = [
            self.semantic_stage.generate([clap_sem], generator, max_time_steps=first_T,
                                         init_pred_ids=cond_semantic,
                                         per_row_keys=row_keys(0, 0), **sem_kw)
        ]
        sem_total = first_T
        target_sem = int(output_seconds * semantic_steps_per_second)
        cond_len = int(semantic_window_seconds * semantic_steps_per_second
                       * (1 - semantic_sliding_window_step_percent))
        while sem_total < target_sem:
            cont = self.semantic_stage.generate(
                [clap_sem], generator,
                max_time_steps=int(semantic_window_seconds * semantic_steps_per_second),
                init_pred_ids=_gather_span(sem_segments, sem_total - cond_len, cond_len),
                per_row_keys=row_keys(0, len(sem_segments)), **sem_kw,
            )
            sem_segments.append(cont[:, cond_len:])
            sem_total += cont.shape[1] - cond_len
        sem_start = front(sem_total, semantic_adj)

        # ---- coarse stage over semantic windows ----
        window = int(coarse_window_seconds * semantic_steps_per_second - 1)
        step = int(window * coarse_sliding_window_step_percent)
        n_coarse_windows = (sem_total - sem_start - window) // step + 1
        coarse_T = int(coarse_window_seconds * acoustic_steps_per_second)
        coarse_cond_len = int(coarse_window_seconds * acoustic_steps_per_second
                              * (1 - coarse_sliding_window_step_percent))
        coarse_segments = []
        prev_pred = None
        for wi in range(n_coarse_windows):
            init = cond_coarse
            if prev_pred is not None:
                init = prev_pred[:, -coarse_cond_len:] if coarse_cond_len > 0 else None
            prev_pred = self.coarse_stage.generate(
                [clap_coarse, _put(_gather_span(sem_segments, sem_start + wi * step, window), dev_coarse)],
                generator, max_time_steps=coarse_T, init_pred_ids=init, per_row_keys=row_keys(1, wi),
                temperature=coarse_temperature, filter_thres=coarse_filter_thres, mesh=mesh,
            )  # [b, coarse_T, n_coarse]
            coarse_segments.append(prev_pred if wi == 0 else prev_pred[:, coarse_cond_len:])
        coarse_total = sum(s.shape[1] for s in coarse_segments)
        if return_coarse_generated_wave:
            return self._decode(torch.cat(coarse_segments, dim=1))
        coarse_start = front(coarse_total, coarse_adj)
        coarse_len = coarse_total - coarse_start

        # ---- fine stage over coarse windows ----
        fine_window = int(fine_window_seconds * acoustic_steps_per_second)
        fine_step = int(fine_window * fine_sliding_window_step_percent)
        n_windows = (coarse_len - fine_window) // fine_step + 1
        fine_cond_len = int(fine_window * (1 - fine_sliding_window_step_percent))
        fine_kw = dict(max_time_steps=fine_window, temperature=fine_temperature,
                       filter_thres=fine_filter_thres, mesh=mesh)

        def coarse_win(wj: int) -> torch.Tensor:
            return _gather_span(coarse_segments, coarse_start + wj * fine_step, fine_window)

        if fine_cond_len == 0 and cond_fine is None and n_windows > 1:
            # non-overlapping windows are independent given coarse + clap: one
            # batched decode of [windows * b] rows, capped at max_fine_rows()
            win_per_call = max(1, max_fine_rows() // max(b, 1))
            chunks = []
            for g0 in range(0, n_windows, win_per_call):
                g1 = min(g0 + win_per_call, n_windows)
                nw = g1 - g0
                keys = None if per_row_keys is None else torch.cat(
                    [row_keys(2, w) for w in range(g0, g1)])
                pred = self.fine_stage.generate(
                    [clap_fine.repeat(nw, 1), _put(torch.cat([coarse_win(w) for w in range(g0, g1)], dim=0), dev_fine)],
                    generator, per_row_keys=keys, **fine_kw,
                )  # [nw * b, T, q]
                chunks.append(pred.reshape(nw, b, fine_window, pred.shape[-1]))
            pred = torch.cat(chunks, dim=0)
            fine = torch.cat([pred[w] for w in range(n_windows)], dim=1)
        else:
            fine = None
            prev_fine = None
            for wi in range(n_windows):
                init = cond_fine
                if prev_fine is not None:
                    init = prev_fine[:, -fine_cond_len:] if fine_cond_len > 0 else None
                prev_fine = self.fine_stage.generate(
                    [clap_fine, _put(coarse_win(wi), dev_fine)], generator, init_pred_ids=init,
                    per_row_keys=row_keys(2, wi), **fine_kw
                )
                fine = prev_fine if fine is None else torch.cat(
                    [fine, prev_fine[:, fine_cond_len:]], dim=1)

        codec_dev = self.codec.codebooks.device
        fine = fine[:, fine_adj:].to(codec_dev)
        coarse = _gather_span(coarse_segments, coarse_start, coarse_len).to(codec_dev)
        if prime_codes is not None:  # the prime's own codes come first
            n_coarse = coarse.shape[-1]
            fine = torch.cat([prime_codes[..., n_coarse:].to(codec_dev), fine], dim=1)
            coarse = torch.cat([prime_codes[..., :n_coarse].to(codec_dev), coarse], dim=1)
        T = min(coarse.shape[1], fine.shape[1])  # unfold may drop a partial window
        acoustic = torch.cat([coarse[:, :T], fine[:, :T]], dim=-1)
        return self._decode(acoustic)

    @torch.no_grad()
    def generate_top_match(
        self,
        *,
        text: List[str],
        num_samples: int = 4,
        num_top_matches: int = 1,
        generator: Optional[torch.Generator] = None,
        per_row_keys: Optional[torch.Tensor] = None,
        **kwargs,
    ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """Per prompt, ``num_samples`` generations ranked by the cosine
        similarity of their CLAP audio embedding to the prompt's text
        embedding: ([num_top_matches, samples] waves, [num_top_matches]
        similarities) a prompt, best first (ties: the lower sample index).
        ``per_row_keys`` holds ``len(text) * num_samples`` keys, prompt i's
        samples at rows ``i * num_samples`` on; ``kwargs`` go to ``generate``."""
        if self.clap is None or self.tokenizer is None:
            raise ValueError("generate_top_match needs a CLAP with its audio tower and a tokenizer")
        if per_row_keys is not None and per_row_keys.shape[0] != len(text) * num_samples:
            raise ValueError(f"per_row_keys: {per_row_keys.shape[0]} keys for "
                             f"{len(text)} prompts x {num_samples} samples")
        all_samples, all_sims = [], []
        for pi, prompt in enumerate(text):
            enc = self.tokenizer([prompt])
            text_latent = self.clap.text_embedding(enc["input_ids"], enc["attention_mask"])  # [1, joint]
            clap_tokens = self.clap.quantize(text_latent).repeat_interleave(num_samples, dim=0)
            keys = None if per_row_keys is None else per_row_keys[pi * num_samples:(pi + 1) * num_samples]
            waves = self.generate(clap_token_ids=clap_tokens, generator=generator, per_row_keys=keys,
                                  **kwargs)  # [num_samples, T]
            clap_in = int16_round_trip(resample(waves.float(), self.codec.sample_rate, self.clap.sample_rate))
            audio_latents = self.clap.audio_embedding(clap_in)  # [num_samples, joint]
            text_latent = text_latent.to(audio_latents.device)
            sim = (audio_latents * text_latent).sum(-1) / (
                torch.linalg.vector_norm(audio_latents, dim=-1)
                * torch.linalg.vector_norm(text_latent, dim=-1) + 1e-12)
            top = torch.sort(sim, descending=True, stable=True).indices[:num_top_matches]
            all_sims.append(sim[top])
            all_samples.append(waves[top.to(waves.device)])
        return all_samples, all_sims
