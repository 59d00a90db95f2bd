"""Launch counts of the hand-written kernels, by name.

Each kernel's wrapper adds one to its counter (an attribute of the wrapper)
where it launches the kernel on the card, and nowhere else; on the CPU the
plain versions run and the counts stay 0. Kernels 5 and 6 are one wrapper
with two counters.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

from . import attention, decode_attention, fused_ff, fused_layer, quant

# name -> (wrapper, counter attribute), in the order of the TPU kernels they replace
KERNELS: Dict[str, Tuple[Callable, str]] = {
    "prefill_attention": (attention.shared_kv_attention_fused, "launches"),
    "flash_decode_step": (decode_attention.flash_decode_step, "launches"),
    "fused_ff_apply": (fused_ff.fused_ff_apply, "launches"),
    "int8_matmul": (quant.int8_matmul, "launches"),
    "attention_bwd": (attention.shared_kv_attention_bwd, "launches"),
    "attention_dbias": (attention.shared_kv_attention_bwd, "dbias_launches"),
    "fused_layer_decode_step": (fused_layer.fused_layer_decode_step, "launches"),
}


def counts() -> Dict[str, int]:
    """Every kernel's launches so far."""
    return {name: getattr(fn, attr) for name, (fn, attr) in KERNELS.items()}


def since(before: Dict[str, int], nonzero: bool = False) -> Dict[str, int]:
    """Launches of each kernel since ``before`` (an earlier ``counts()``);
    with ``nonzero`` only the kernels that launched."""
    out = {name: n - before[name] for name, n in counts().items()}
    return {name: n for name, n in out.items() if n} if nonzero else out
