"""Stage definitions (port of open_musiclm_tpu/models/stages.py).

The three stage factories, and ``Stage``: a TokenConditionedTransformer
with its decode mode, the JAX package's full mode matrix: the fp decode
(``quantized=False``) or the int8 serving decode (``quantized=True``) with
``flash_kv`` None, "bf16", "f32", "int8" or "fused", with a generator or
per-row sampling keys. The mesh-sharded decode is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch

from ..core.sequence import TokenSequenceSpec
from .quant_decode import generate_quantized, quantize_stage_params
from .token_cond import TokenConditionedTransformer, generate


def create_semantic_transformer(
    dim: int = 1024, depth: int = 6, clap_codebook_size: int = 1024,
    semantic_codebook_size: int = 1024, num_clap_quantizers: int = 12, **kwargs,
) -> TokenConditionedTransformer:
    specs = (
        TokenSequenceSpec(clap_codebook_size, num_clap_quantizers, False),
        TokenSequenceSpec(semantic_codebook_size, 1, False),
    )
    return TokenConditionedTransformer(specs=specs, dim=dim, depth=depth, **kwargs)


def create_coarse_transformer(
    dim: int = 1024, depth: int = 6, clap_codebook_size: int = 1024,
    semantic_codebook_size: int = 1024, acoustic_codebook_size: int = 1024,
    num_clap_quantizers: int = 12, num_coarse_quantizers: int = 3, **kwargs,
) -> TokenConditionedTransformer:
    specs = (
        TokenSequenceSpec(clap_codebook_size, num_clap_quantizers, False),
        TokenSequenceSpec(semantic_codebook_size, 1, False),
        TokenSequenceSpec(acoustic_codebook_size, num_coarse_quantizers, False),
    )
    return TokenConditionedTransformer(specs=specs, dim=dim, depth=depth, **kwargs)


def create_fine_transformer(
    dim: int = 1024, depth: int = 6, clap_codebook_size: int = 1024,
    acoustic_codebook_size: int = 1024, num_clap_quantizers: int = 12,
    num_coarse_quantizers: int = 3, num_fine_quantizers: int = 5, **kwargs,
) -> TokenConditionedTransformer:
    specs = (
        TokenSequenceSpec(clap_codebook_size, num_clap_quantizers, False),
        TokenSequenceSpec(acoustic_codebook_size, num_coarse_quantizers, False),
        TokenSequenceSpec(acoustic_codebook_size, num_fine_quantizers, False),
    )
    return TokenConditionedTransformer(specs=specs, dim=dim, depth=depth, **kwargs)


@dataclasses.dataclass
class Stage:
    """A stage model and its decode mode. ``quantized=False`` is the fp
    decode (``token_cond.generate``); ``quantized=True`` the int8 serving
    decode (``quant_decode.generate_quantized``), whose ``flash_kv`` picks
    the step: None (per-step attention in plain torch), the flash-decode
    kernel over "bf16" (activation-dtype), "f32" or "int8" cache rows, or
    "fused" (one kernel launch per layer)."""

    model: TokenConditionedTransformer
    name: str = "stage"
    quantized: bool = False
    flash_kv: Optional[str] = None

    def __post_init__(self):
        self._qparams: Optional[Any] = None

    def qparams(self):
        if self._qparams is None:
            self._qparams = quantize_stage_params(self.model, fused=self.flash_kv == "fused")
        return self._qparams

    def generate(
        self,
        conditioning_token_ids: Sequence[torch.Tensor],
        generator: Optional[torch.Generator] = None,
        *,
        max_time_steps: int,
        init_pred_ids: Optional[torch.Tensor] = None,
        filter_thres: float = 0.9,
        temperature: float = 1.0,
        allow_eos_in_output: bool = False,
        include_eos_in_output: bool = False,
        teacher_forced_ids: Optional[torch.Tensor] = None,
        return_logits: bool = False,
        per_row_keys: Optional[torch.Tensor] = None,
    ):
        """``per_row_keys``: optional [b] keys (``core.sampling``) making row
        i's sampling a function of its own key only; ``generator`` is then
        ignored."""
        if self.flash_kv and not self.quantized:
            # the flash-KV cache lives in the quantized decode; ignoring it
            # would silently run another path than the one asked for
            raise ValueError(
                f"flash_kv={self.flash_kv!r} requires quantized=True: the flash "
                "decode kernel is part of the int8 serving decode."
            )
        kw = dict(
            max_time_steps=int(max_time_steps), init_pred_ids=init_pred_ids,
            filter_thres=filter_thres, temperature=temperature,
            allow_eos_in_output=allow_eos_in_output, include_eos_in_output=include_eos_in_output,
            teacher_ids=teacher_forced_ids, return_logits=return_logits,
            per_row_keys=per_row_keys,
        )
        if not self.quantized:
            return generate(self.model, list(conditioning_token_ids), generator, **kw)
        return generate_quantized(
            self.model, self.qparams(), list(conditioning_token_ids), generator,
            flash_kv=self.flash_kv, **kw)
