"""Qualitative training artifacts (port of open_musiclm_tpu/train/artifacts.py).

* ``save_predicted_tokens``: ground-truth and argmax-predicted token rows of
  the final sequence, with each row's accuracy, as a step-stamped text file;
* ``save_reconstructed_wave``: teacher-forced Encodec reconstructions, the
  coarse stage decoding its predicted coarse codes and the fine stage the
  ground-truth coarse codes with its predicted fine codes, at most 4
  examples, decoded on the codec's device.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..data.audio_io import write_wav
from ..models.encodec import EncodecModel

MAX_ARTIFACT_EXAMPLES = 4


def save_predicted_tokens(logits: torch.Tensor, labels: torch.Tensor, results_folder: str, stage: str,
                          step: int) -> str:
    """logits [B, n, vocab] and labels [B, n] of the final sequence ->
    ``{stage}.tokens.{step}.txt``; returns its path."""
    path = Path(results_folder) / f"{stage}.tokens.{step}.txt"
    pred = logits.argmax(dim=-1).cpu().numpy()
    lab = labels.cpu().numpy()
    with open(path, "w") as f:
        for b in range(min(pred.shape[0], MAX_ARTIFACT_EXAMPLES)):
            f.write(f"# example {b}\n")
            f.write("target:    " + " ".join(map(str, lab[b])) + "\n")
            f.write("predicted: " + " ".join(map(str, pred[b])) + "\n")
            acc = float((pred[b] == lab[b]).mean())
            f.write(f"accuracy:  {acc:.4f}\n\n")
    return str(path)


@torch.no_grad()
def save_reconstructed_wave(stage: str, pred_tokens: torch.Tensor, cond_tokens: Optional[torch.Tensor],
                            codec: EncodecModel, num_coarse_quantizers: int, num_fine_quantizers: int,
                            results_folder: str, step: int):
    """pred_tokens [B, n]: the flattened predicted final-sequence tokens;
    cond_tokens: the fine stage's ground-truth coarse tokens [B, n'].
    Writes ``{stage}.recon.{step}.{i}.wav`` and returns (their paths, the
    waves [b, T] on the codec's device), or None for the semantic stage."""
    if stage == "semantic":
        return None
    device = codec.codebooks.device
    top = codec.codebooks.shape[1] - 1
    b = min(pred_tokens.shape[0], MAX_ARTIFACT_EXAMPLES)
    if stage == "coarse":
        codes = pred_tokens[:b].to(device).reshape(b, -1, num_coarse_quantizers)
    else:
        coarse = cond_tokens[:b].to(device).reshape(b, -1, num_coarse_quantizers)
        fine = pred_tokens[:b].to(device).reshape(b, -1, num_fine_quantizers)
        T = min(coarse.shape[1], fine.shape[1])
        codes = torch.cat([coarse[:, :T], fine[:, :T]], dim=-1)
    waves = codec.decode(codes.clamp(0, top))
    host = waves.float().cpu().numpy()
    paths = []
    for i in range(b):
        p = Path(results_folder) / f"{stage}.recon.{step}.{i}.wav"
        write_wav(str(p), np.asarray(host[i]), codec.sample_rate)
        paths.append(str(p))
    return paths, waves
