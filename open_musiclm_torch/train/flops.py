"""Analytic FLOPs of stage training (port of open_musiclm_tpu/train/flops.py).

Model FLOPs in the PaLM sense: the matmul FLOPs the model needs (forward
once, backward twice), over the card's peak dense rate at the training
dtype:

    model FLOP/s share = train_flops_per_step / step_seconds / peak_flops

Forward FLOPs of one microbatch [B, n] (every matmul 2*m*n*k): per layer
to_q 2nD(h*dh), to_kv 2nD(2dh) (one shared K/V head), scores and attn@v
2*h*dh*n^2 each (counted dense), to_out 2n(h*dh)D, FF proj_in 2nD(2*ffi),
the 3-tap conv ~12n*ffi, proj_out 2n*ffi*D; per position the logit head
over its codebook (+1 EOS); the rel-pos MLP once per forward.
"""

from __future__ import annotations

from typing import Sequence

# Peak dense bf16 rate, TFLOP/s, from NVIDIA's H100 data sheet (SXM part,
# dense, without sparsity; at the full 700 W power limit). A data-sheet
# figure, not a measurement.
_PEAK_BF16_TFLOPS = {"NVIDIA H100 80GB HBM3": 989.0}


def peak_flops(device_name: str) -> float:
    """Peak dense bf16 FLOP/s of one card by its ``torch.cuda.get_device_name``;
    an unknown card raises."""
    if device_name not in _PEAK_BF16_TFLOPS:
        raise KeyError(f"no peak rate on record for {device_name!r}")
    return _PEAK_BF16_TFLOPS[device_name] * 1e12


def stream_positions(token_lens: Sequence[int]) -> int:
    """Training-stream length: a start token before and an EOS after each
    sequence (models/token_cond.py:stage_training_loss)."""
    return sum(int(n) + 2 for n in token_lens)


def stage_forward_flops(model, token_lens: Sequence[int], batch: int) -> float:
    """Forward matmul FLOPs of ONE microbatch at the given per-sequence token
    lengths (before the EOS, as fed to the trainer)."""
    D, h, dh = model.dim, model.heads, model.dim_head
    inner = h * dh
    n = stream_positions(token_lens)
    ffi = model.transformer.ffs[0].inner_dim
    per_layer = (
        2 * n * D * inner  # to_q
        + 2 * n * D * (2 * dh)  # to_kv (shared single head)
        + 2 * h * dh * n * n  # scores
        + 2 * h * dh * n * n  # attn @ v
        + 2 * n * inner * D  # to_out
        + 2 * n * D * (2 * ffi)  # ff proj_in
        + 12 * n * ffi  # depthwise conv taps
        + 2 * n * ffi * D  # ff proj_out
    )
    logit = sum(2 * (int(ln) + 2) * D * (spec.codebook_size + 1)
                for spec, ln in zip(model.specs, token_lens))
    relpos = (2 * n - 1) * (2 * D + 2 * D * D * 2 + 2 * D * h)
    return float(batch) * (model.depth * per_layer + logit) + relpos


def stage_train_flops(model, token_lens: Sequence[int], batch: int, grad_accum: int) -> float:
    """Model FLOPs of one optimizer step (fwd + 2x bwd, times accumulation)."""
    return 3.0 * stage_forward_flops(model, token_lens, batch) * grad_accum
