"""MusicLM hierarchy from text to waveform
(port of open_musiclm_tpu/models/musiclm.py).

text -> BPE tokenizer -> CLAP text tower -> RVQ -> 12 conditioning tokens
(or precomputed tokens) -> semantic stage (sliding windows with 50 %
overlap) -> coarse stage over 4 s semantic windows (continuing from the
previous window's last coarse tokens) -> fine stage over 2 s coarse windows
(non-overlapping windows decode as one batched call) -> Encodec decode.
Sampling draws come from a generator or from per-row keys. Audio-prompt
continuation, reranking and multi-device pipelining are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

import torch

from ..core.sampling import fold_in_rows
from .clap.clap import ClapQuantized
from .encodec import EncodecModel
from .stages import Stage

# Encodec decodes at most this many rows * frames per head call; the stem
# runs once for the whole batch. Chunking is value-identical.
MAX_DECODE_FRAMES = 36000
# at most this many rows (prompts x fine windows) per batched fine decode
MAX_FINE_ROWS = 256


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


@dataclasses.dataclass
class MusicLM:
    """``clap`` and ``tokenizer`` (any callable giving numpy ``input_ids``
    and ``attention_mask`` for a list of texts) serve text prompts; without
    them ``generate`` takes precomputed CLAP tokens only."""

    codec: EncodecModel
    semantic_stage: Stage
    coarse_stage: Stage
    fine_stage: Stage
    clap: Optional[ClapQuantized] = None
    tokenizer: Any = None

    def clap_tokens_from_text(self, text: List[str]) -> torch.Tensor:
        """Texts -> [b, Q, 1] CLAP tokens on the CLAP's device."""
        if self.tokenizer is None or self.clap is None:
            raise ValueError("text prompts need a tokenizer and a CLAP: pass both, or "
                             "precomputed clap_token_ids")
        enc = self.tokenizer(text)
        return self.clap.tokenize_text(enc["input_ids"], enc["attention_mask"])

    @torch.no_grad()
    def _decode(self, codes: torch.Tensor) -> torch.Tensor:
        """Encodec decode with the batch chunked under MAX_DECODE_FRAMES."""
        b, T = codes.shape[0], codes.shape[1]
        rows = max(1, MAX_DECODE_FRAMES // max(T, 1))
        if b <= rows:
            return self.codec.decode(codes)
        if rows > 8:
            rows -= rows % 8
        h = self.codec.decode_stem(codes)
        return torch.cat(
            [self.codec.decode_head(h[i: i + rows]) for i in range(0, b, rows)], dim=0
        )

    @torch.no_grad()
    def generate(
        self,
        *,
        text: Optional[List[str]] = None,
        clap_token_ids: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        per_row_keys: Optional[torch.Tensor] = None,
        output_seconds: float = 8,
        semantic_window_seconds: int = 10,
        coarse_window_seconds: int = 4,
        fine_window_seconds: int = 2,
        semantic_steps_per_second: int = 50,
        acoustic_steps_per_second: int = 75,
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
        window) into the keys."""
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

        # ---- semantic stage: sliding-window AR ----
        first_T = int(min(output_seconds, semantic_window_seconds) * semantic_steps_per_second)
        sem_kw = dict(temperature=semantic_temperature, filter_thres=semantic_filter_thres)
        sem_segments = [
            self.semantic_stage.generate([clap], generator, max_time_steps=first_T,
                                         per_row_keys=row_keys(0, 0), **sem_kw)
        ]
        sem_total = first_T
        target_sem = int(output_seconds * semantic_steps_per_second)
        cond_len = int(semantic_window_seconds * semantic_steps_per_second
                       * (1 - semantic_sliding_window_step_percent))
        while sem_total < target_sem:
            cont = self.semantic_stage.generate(
                [clap], generator,
                max_time_steps=int(semantic_window_seconds * semantic_steps_per_second),
                init_pred_ids=_gather_span(sem_segments, sem_total - cond_len, cond_len),
                per_row_keys=row_keys(0, len(sem_segments)), **sem_kw,
            )
            sem_segments.append(cont[:, cond_len:])
            sem_total += cont.shape[1] - cond_len

        # ---- coarse stage over semantic windows ----
        window = int(coarse_window_seconds * semantic_steps_per_second - 1)
        step = int(window * coarse_sliding_window_step_percent)
        n_coarse_windows = (sem_total - window) // step + 1
        coarse_T = int(coarse_window_seconds * acoustic_steps_per_second)
        coarse_cond_len = int(coarse_window_seconds * acoustic_steps_per_second
                              * (1 - coarse_sliding_window_step_percent))
        coarse_segments = []
        prev_pred = None
        for wi in range(n_coarse_windows):
            init = None
            if prev_pred is not None and coarse_cond_len > 0:
                init = prev_pred[:, -coarse_cond_len:]
            prev_pred = self.coarse_stage.generate(
                [clap, _gather_span(sem_segments, wi * step, window)], generator,
                max_time_steps=coarse_T, init_pred_ids=init, per_row_keys=row_keys(1, wi),
                temperature=coarse_temperature, filter_thres=coarse_filter_thres,
            )  # [b, coarse_T, n_coarse]
            coarse_segments.append(prev_pred if wi == 0 else prev_pred[:, coarse_cond_len:])
        coarse_len = sum(s.shape[1] for s in coarse_segments)

        # ---- fine stage over coarse windows ----
        fine_window = int(fine_window_seconds * acoustic_steps_per_second)
        fine_step = int(fine_window * fine_sliding_window_step_percent)
        n_windows = (coarse_len - fine_window) // fine_step + 1
        fine_cond_len = int(fine_window * (1 - fine_sliding_window_step_percent))
        fine_kw = dict(max_time_steps=fine_window, temperature=fine_temperature,
                       filter_thres=fine_filter_thres)

        def coarse_win(wj: int) -> torch.Tensor:
            return _gather_span(coarse_segments, wj * fine_step, fine_window)

        if fine_cond_len == 0 and n_windows > 1:
            # non-overlapping windows are independent given coarse + clap: one
            # batched decode of [windows * b] rows, capped at MAX_FINE_ROWS
            win_per_call = max(1, MAX_FINE_ROWS // max(b, 1))
            chunks = []
            for g0 in range(0, n_windows, win_per_call):
                g1 = min(g0 + win_per_call, n_windows)
                nw = g1 - g0
                keys = None if per_row_keys is None else torch.cat(
                    [row_keys(2, w) for w in range(g0, g1)])
                pred = self.fine_stage.generate(
                    [clap.repeat(nw, 1), torch.cat([coarse_win(w) for w in range(g0, g1)], dim=0)],
                    generator, per_row_keys=keys, **fine_kw,
                )  # [nw * b, T, q]
                chunks.append(pred.reshape(nw, b, fine_window, pred.shape[-1]))
            pred = torch.cat(chunks, dim=0)
            fine = torch.cat([pred[w] for w in range(n_windows)], dim=1)
        else:
            fine = None
            prev_fine = None
            for wi in range(n_windows):
                init = None
                if prev_fine is not None and fine_cond_len > 0:
                    init = prev_fine[:, -fine_cond_len:]
                prev_fine = self.fine_stage.generate(
                    [clap, coarse_win(wi)], generator, init_pred_ids=init,
                    per_row_keys=row_keys(2, wi), **fine_kw
                )
                fine = prev_fine if fine is None else torch.cat(
                    [fine, prev_fine[:, fine_cond_len:]], dim=1)

        coarse = _gather_span(coarse_segments, 0, coarse_len).to(fine.device)
        T = min(coarse.shape[1], fine.shape[1])  # unfold may drop a partial window
        acoustic = torch.cat([coarse[:, :T], fine[:, :T]], dim=-1)
        return self._decode(acoustic.to(self.codec.codebooks.device))
