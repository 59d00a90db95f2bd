"""Stage definitions (port of open_musiclm_tpu/models/stages.py).

The three stage factories, and ``Stage``: a TokenConditionedTransformer
with its decode mode, the JAX package's full mode matrix: the fp decode
(``quantized=False``) or the int8 serving decode (``quantized=True``) with
``flash_kv`` None, "bf16", "f32", "int8" or "fused", with a generator or
per-row sampling keys, in one process or prompt-parallel over a mesh's
``dp`` axis (``generate(mesh=)``). A stage whose model was split over
``tp`` (``parallel/sharding.py:shard_module``) runs the fp decode on its
shard; the int8 decodes take the whole model and run replicated over ``tp``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Optional, Sequence

import torch

from ..core.sequence import TokenSequenceSpec
from ..parallel.mesh import Mesh, shard_batch
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
    "fused" (one kernel launch per layer). ``flash_kv`` defaults to
    ``$OPEN_MUSICLM_FLASH_KV`` (read at construction), as in the JAX
    package."""

    model: TokenConditionedTransformer
    name: str = "stage"
    quantized: bool = False
    flash_kv: Optional[str] = dataclasses.field(
        default_factory=lambda: os.environ.get("OPEN_MUSICLM_FLASH_KV") or None)

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
        mesh: Optional[Mesh] = None,
    ):
        """``per_row_keys``: optional [b] keys (``core.sampling``) making row
        i's sampling a function of its own key only; ``generator`` is then
        ignored.

        ``mesh``: prompt-parallel serving over its ``dp`` axis, as the JAX
        package's shard_map over ``dp``: each ``dp`` rank decodes its rows of
        the prompts (conditioning, prefix, teacher and keys) on this stage's
        path, then every rank gathers all rows (tokens, and logits with
        ``return_logits``). The call is SPMD: every rank of the mesh makes
        it with the same arguments. It needs ``per_row_keys`` (a row's draws
        must not depend on the shard layout) and a batch that divides by
        ``dp``."""
        if self.flash_kv and not self.quantized:
            # the flash-KV cache lives in the quantized decode; ignoring it
            # would silently run another path than the one asked for
            raise ValueError(
                f"flash_kv={self.flash_kv!r} requires quantized=True: the flash "
                "decode kernel is part of the int8 serving decode. Construct the "
                "stage with quantized=True, or unset $OPEN_MUSICLM_FLASH_KV / pass "
                "flash_kv=None for the fp decode."
            )
        cond = list(conditioning_token_ids)
        if mesh is not None:
            if per_row_keys is None:
                raise ValueError("mesh-sharded generate requires per_row_keys (row i's sampling must "
                                 "not depend on the shard layout)")
            batch = cond[0].shape[0]
            if batch % mesh.world:
                raise ValueError(f"a batch of {batch} prompts does not split over dp={mesh.world}")
            cond = shard_batch(mesh, cond)
            init_pred_ids, teacher_forced_ids, per_row_keys = (
                None if x is None else shard_batch(mesh, x)
                for x in (init_pred_ids, teacher_forced_ids, per_row_keys))
        kw = dict(
            max_time_steps=int(max_time_steps), init_pred_ids=init_pred_ids,
            filter_thres=filter_thres, temperature=temperature,
            allow_eos_in_output=allow_eos_in_output, include_eos_in_output=include_eos_in_output,
            teacher_ids=teacher_forced_ids, return_logits=return_logits,
            per_row_keys=per_row_keys,
        )
        # the kernels launch on the current device: make it the stage's own
        # (a stage placed by MusicLM.to_pipelined on another card)
        device = self.model.start_tokens.device
        with torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext():
            if not self.quantized:
                out = generate(self.model, cond, generator, **kw)
            else:
                out = generate_quantized(self.model, self.qparams(), cond, generator, flash_kv=self.flash_kv, **kw)
        if mesh is None:
            return out
        if return_logits:
            return tuple(mesh.all_gather_rows(x) for x in out)
        return mesh.all_gather_rows(out)
