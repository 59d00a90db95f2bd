"""The H100's data-sheet peaks and the least time of a piece of work.

Peaks: NVIDIA H100 SXM data sheet, dense, at the 700 W limit (as
``chip_smoke.py:267-268`` holds them): 3.35 TB/s of HBM, 989 TFLOP/s bf16
on the tensor cores, 67 TFLOP/s float32 outside them. ``bound_s`` is
``chip_smoke.py:321`` ``bound_ms`` in seconds: the larger of bytes over the
memory rate and FLOPs over the peak.

``stage_work`` counts a stage call's work from its shapes, whatever kernel
runs it: per decode step every layer's weights and the logit head read once
at the configuration's weight width (int8 with float32 column scales for a
served stage), the live cache rows read once and the new rows and conv
state rows moved once (two read, one written), and the FLOPs of 2 x (weights a token passes through)
plus the attention over the live cache; per prefill the weights in the
activations' width read once, the cache rows written once, and the FLOPs of
every prefilled token with its causal attention.
"""

from __future__ import annotations

from typing import Dict, Tuple

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def bound_s(n_bytes: float, flops: float, dtype: str = "bfloat16") -> float:
    return max(n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def layer_matrix_params(dim: int, heads: int, dim_head: int, inner: int) -> int:
    """to_q, to_kv (one K/V head), to_out, the conv-FF's proj_in and proj_out."""
    hd = heads * dim_head
    return dim * hd + dim * 2 * dim_head + hd * dim + dim * 2 * inner + inner * dim


def layer_columns(dim: int, heads: int, dim_head: int, inner: int) -> int:
    """Output columns of those matrices (one float32 scale each when int8)."""
    return heads * dim_head + 2 * dim_head + dim + 2 * inner + dim


def stage_work(dims: Dict[str, int], batch: int, prefill_len: int, n_new: int,
               weight_bytes: float = 1.0, act_bytes: float = 2.0) -> Tuple[float, float, float, float]:
    """(prefill FLOPs, prefill bytes, decode FLOPs, decode bytes) of one call.

    ``dims``: dim, depth, heads, dim_head, inner, vocab (logit columns)."""
    D, L, h, dh, F, C = (dims[k] for k in ("dim", "depth", "heads", "dim_head", "inner", "vocab"))
    P = layer_matrix_params(D, h, dh, F)
    cols = layer_columns(D, h, dh, F)
    n = prefill_len
    pairs = n * (n + 1) // 2  # causal (query, key) pairs
    pre_flops = batch * (L * (2 * n * P + 4 * h * dh * pairs + 12 * n * F) + 2 * D * C)
    pre_bytes = L * P * act_bytes + batch * L * n * 2 * dh * act_bytes + D * C * act_bytes
    step_weights = L * (P * weight_bytes + cols * 4) + D * C * weight_bytes + C * 4
    row = 2 * dh * weight_bytes + 2 * 4  # a cache row (K|V) and its scales
    dec_flops = dec_bytes = 0.0
    for s in range(n_new):
        live = n + s  # keys before the fresh one
        dec_flops += batch * (L * (2 * P + 4 * h * dh * (live + 1) + 12 * F) + 2 * D * C)
        dec_bytes += (step_weights + batch * L * (live * row + row + 3 * 2 * F * act_bytes))
    return float(pre_flops), float(pre_bytes), float(dec_flops), float(dec_bytes)
