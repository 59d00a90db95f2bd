"""Model FLOPs of stage training: a frozen copy of the arithmetic of
``open_musiclm_torch/train/flops.py:38-71`` (every matmul 2 m n k, forward
once and backward twice; per layer to_q, the shared to_kv, dense scores and
attention over the stream, to_out, the conv-FF's projections and taps; the
logit heads of every sequence; the relative-position MLP once a forward),
with the MLP counted at its width, dim / 2."""

from __future__ import annotations

from typing import Dict, Sequence


def stream_positions(token_lens: Sequence[int]) -> int:
    """A start token before and an EOS after each sequence."""
    return sum(int(n) + 2 for n in token_lens)


def stage_forward_flops(dims: Dict, token_lens: Sequence[int], batch: int) -> float:
    D, h, dh, F = dims["dim"], dims["heads"], dims["dim_head"], dims["inner"]
    inner = h * dh
    n = stream_positions(token_lens)
    per_layer = (2 * n * D * inner + 2 * n * D * (2 * dh) + 4 * h * dh * n * n + 2 * n * inner * D
                 + 2 * n * D * (2 * F) + 12 * n * F + 2 * n * F * D)
    logit = sum(2 * (int(ln) + 2) * D * (cb + 1) for (cb, _), ln in zip(dims["specs"], token_lens))
    w = D // 2
    relpos = (2 * n - 1) * (2 * w + 2 * w * w * 2 + 2 * w * h)
    return float(batch) * (dims["depth"] * per_layer + logit) + relpos


def stage_train_flops(dims: Dict, token_lens: Sequence[int], batch: int, accum: int) -> float:
    return 3.0 * stage_forward_flops(dims, token_lens, batch) * accum
