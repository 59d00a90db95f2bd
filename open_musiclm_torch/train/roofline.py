"""The bytes and FLOPs roofline of a stage training step (port of
open_musiclm_tpu/train/roofline.py), against one H100's data-sheet peaks.

    step_time >= max(flops / peak_flops, bytes / peak_bandwidth)

``bytes`` is split into terms, each a derived lower bound (every
elementwise chain fused into its producer, no re-reads beyond the
structural ones), counted as the JAX package counts them:

  * ``weights``     every weight read three times a micro-batch (forward,
                    backward dx, backward dw) at the parameter dtype, plus
                    the gradient's write and read;
  * ``optimizer``   AdamW reads p, m, v, g and writes p, m, v;
  * ``attn_scores`` the [b, h, n, n] scores. Kernels 1, 5 and 6 never write
                    them to memory, so the port's term is the JAX package's
                    ``pallas_attention=True`` one: no pass (the default
                    here). Kernel 6's dbias [h, n, m] write a micro-batch is
                    not counted (as in the JAX package);
  * ``ff_stream``   the [b, n, 2 * inner] conv-FF stream: 4 passes forward,
                    6 backward, 8 under remat;
  * ``residual``    the [b, n, D] stream: 6 passes forward, 8 backward;
  * ``logits``      the heads' outputs and the cross-entropy's backward.

The FLOPs are ``train/flops.py``'s model FLOPs (remat's re-forwards are not
credited). The peaks are looked up by ``torch.cuda.get_device_name()``; an
unknown card raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

from .flops import peak_flops, stage_train_flops, stream_positions

# HBM bandwidth, bytes/s, NVIDIA's H100 data sheet (SXM part): a data-sheet
# figure, not a measurement.
_PEAK_HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def peak_hbm_bytes_per_s(device_name: str) -> float:
    """Peak memory bandwidth of one card by its ``torch.cuda.get_device_name``;
    an unknown card raises."""
    if device_name not in _PEAK_HBM_BYTES_PER_S:
        raise KeyError(f"no memory bandwidth on record for {device_name!r}")
    return _PEAK_HBM_BYTES_PER_S[device_name]


@dataclass
class Roofline:
    """A step's FLOPs and bytes by term, the card's peaks, and the bound."""

    flops: float
    bytes_by_term: Dict[str, float]
    peak_flops: float
    peak_bw: float

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_term.values())

    @property
    def compute_s(self) -> float:
        return self.flops / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.total_bytes / self.peak_bw

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s)

    @property
    def bound(self) -> str:
        return "memory" if self.memory_s > self.compute_s else "compute"

    @property
    def mfu_ceiling(self) -> float:
        """The model FLOP/s share of the peak if the step ran at its bound."""
        return self.flops / self.bound_s / self.peak_flops

    def summary(self, measured_step_s: Optional[float] = None) -> Dict:
        out = {
            "compute_ms": round(self.compute_s * 1e3, 2),
            "memory_ms": round(self.memory_s * 1e3, 2),
            "bound": self.bound,
            "bound_ms": round(self.bound_s * 1e3, 2),
            "mfu_ceiling": round(self.mfu_ceiling, 3),
            "bytes_gb_by_term": {k: round(v / 1e9, 2) for k, v in self.bytes_by_term.items()},
            "model_tflops": round(self.flops / 1e12, 3),
        }
        if measured_step_s:
            out["measured_ms"] = round(measured_step_s * 1e3, 2)
            out["roofline_fraction"] = round(self.bound_s / measured_step_s, 5)
        return out


def stage_train_roofline(
    model,
    token_lens: Sequence[int],
    batch: int,
    grad_accum: int,
    *,
    device_name: str,
    compute_dtype_bytes: int = 2,
    param_dtype_bytes: int = 4,
    pallas_attention: bool = True,
    remat: bool = False,
) -> Roofline:
    """The roofline of one optimizer step of ``model`` (a
    TokenConditionedTransformer) at ``batch`` x ``grad_accum`` examples of
    ``token_lens`` (the per-sequence lengths before the EOS, as the trainer
    takes them). ``pallas_attention=False`` counts the score passes of an
    attention that writes its scores out (the JAX package's XLA path)."""
    D, h, dh, L = model.dim, model.heads, model.dim_head, model.depth
    n = stream_positions(token_lens)
    b = batch * grad_accum
    a, p = compute_dtype_bytes, param_dtype_bytes
    ffi = model.transformer.ffs[0].inner_dim

    per_layer_params = (D * (h * dh) + D * (2 * dh) + (h * dh) * D  # to_q, to_kv, to_out
                        + D * (2 * ffi) + ffi * D + 3 * (2 * ffi))  # proj_in, proj_out, conv taps
    head_params = sum(D * (s.codebook_size + 1) for s in model.specs)
    embed_params = sum(D * (s.codebook_size + 2) for s in model.specs)
    relpos_params = 2 * D + 2 * D * D + D * h
    P = L * per_layer_params + head_params + embed_params + relpos_params

    weights_bytes = (3.0 * grad_accum + 2.0) * P * p
    optimizer_bytes = 7.0 * P * p
    passes = 0.0 if pallas_attention else (2.0 + 4.0)
    if remat and not pallas_attention:
        passes += 2.0  # the re-forward writes and reads the scores again
    attn_scores_bytes = passes * b * h * n * n * a * L
    ff_passes = 4.0 + (6.0 if not remat else 8.0)
    ff_stream_bytes = ff_passes * b * n * (2 * ffi) * a * L
    residual_bytes = (6.0 + 8.0) * b * n * D * a * L
    V = sum(s.codebook_size + 1 for s in model.specs)
    logits_bytes = 4.0 * b * n * (V / len(model.specs)) * a

    return Roofline(
        flops=stage_train_flops(model, token_lens, batch, grad_accum),
        bytes_by_term={
            "weights": weights_bytes,
            "optimizer": optimizer_bytes,
            "attn_scores": attn_scores_bytes,
            "ff_stream": ff_stream_bytes,
            "residual": residual_bytes,
            "logits": logits_bytes,
        },
        peak_flops=peak_flops(device_name, "bf16" if a == 2 else "f32"),
        peak_bw=peak_hbm_bytes_per_s(device_name),
    )
