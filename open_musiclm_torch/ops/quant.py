"""Weight-only int8 quantization (port of open_musiclm_tpu/ops/quant.py).

``quantize_weight``/``dequantize_weight`` define the numerics on the JAX
package's ``[in, out]`` layout (per-output-column symmetric scales).
``int8_matmul`` is the wrapper of kernel 4 (``csrc/int8_matmul.cu``,
replacing the Pallas kernel ``ops/quant.py:int8_matmul``);
``int8_matmul_plain`` is its plain version. Kernel 4 is the weight stream
(``int8_stream_grid``) at every row count, so a row's products are summed
in one order and its logits do not change with the rows beside it
(``chip_smoke.py --probe``).
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from . import cuda_lib
from .weight_stream import STREAM_RECORD, STREAM_ROWS, TARGET_BLOCKS, cdiv, stream_grid

def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[in, out] float -> (int8 [in, out], scale f32 [out]), both contiguous
    (the kernels read them so) whatever the layout of ``w``."""
    wf = w.float()
    scale = torch.clamp(wf.abs().amax(dim=0) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q.contiguous(), scale


def dequantize_weight(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def int8_matmul_plain(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x @ dequant(w_q) in float32, returned in x's dtype."""
    acc = x.float() @ w_q.float()
    return (acc * scale[None, :]).to(x.dtype)


@functools.lru_cache(maxsize=None)
def int8_stream_grid(k_rows: int, n_cols: int, aligned: bool) -> Tuple[int, int, int, int]:
    """``stream_grid`` of kernel 4's stream route over int8 [k_rows, n_cols]
    whose rows start 4-byte aligned or not."""
    return stream_grid(k_rows, n_cols, TARGET_BLOCKS, aligned)


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Kernel 4: x [B, in] @ int8 w_q [in, out] * scale [out] -> [B, out] in
    x's dtype, by the weight stream (8 rows a pass, at any B)."""
    if not x.is_cuda:
        return int8_matmul_plain(x, w_q, scale)
    name = "int8_matmul"
    B, K = x.shape
    N = w_q.shape[1]
    cuda_lib.require(w_q.dtype == torch.int8 and w_q.shape == (K, N), f"{name}: w_q int8 [{K}, N]")
    cuda_lib.require(scale.dtype == torch.float32 and scale.shape == (N,), f"{name}: scale f32 [N]")
    cuda_lib.require_cuda(name, x, w_q, scale)
    out = torch.empty((B, N), dtype=x.dtype, device=x.device)
    if B == 0 or N == 0:
        return out
    w_off = w_q.data_ptr() % 4  # the kernel reads W by aligned words from w_q - w_off
    col_blocks, cols, splits, per = int8_stream_grid(K, N, N % 4 == 0 and w_off == 0)
    tickets, part = cuda_lib.stream_scratch(name, x, col_blocks, cdiv(B, STREAM_ROWS) * col_blocks * splits
                                            * STREAM_RECORD)
    rc = cuda_lib.lib().omt_int8_matmul(
        x.data_ptr(), w_q.data_ptr() - w_off, w_off, scale.data_ptr(), out.data_ptr(), part.data_ptr(),
        tickets.data_ptr(), B, K, N, cols, col_blocks, splits, per, cuda_lib.dtype_code(x.dtype),
        cuda_lib.stream(x),
    )
    cuda_lib.check(rc, name)
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0
