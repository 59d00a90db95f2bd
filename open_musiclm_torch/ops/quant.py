"""Weight-only int8 quantization (port of open_musiclm_tpu/ops/quant.py).

``quantize_weight``/``dequantize_weight`` define the numerics on the JAX
package's ``[in, out]`` layout (per-output-column symmetric scales).
``int8_matmul`` is the wrapper of kernel 4 (``csrc/int8_matmul.cu``,
replacing the Pallas kernel ``ops/quant.py:int8_matmul``);
``int8_matmul_plain`` is its plain version.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import cuda_lib


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[in, out] float -> (int8 [in, out], scale f32 [out])."""
    wf = w.float()
    scale = torch.clamp(wf.abs().amax(dim=0) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_weight(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def int8_matmul_plain(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x @ dequant(w_q) in float32, returned in x's dtype."""
    acc = x.float() @ w_q.float()
    return (acc * scale[None, :]).to(x.dtype)


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Kernel 4: x [B, in] @ int8 w_q [in, out] * scale [out] -> [B, out] in x's dtype."""
    if not x.is_cuda:
        return int8_matmul_plain(x, w_q, scale)
    name = "int8_matmul"
    B, K = x.shape
    N = w_q.shape[1]
    cuda_lib.require(w_q.dtype == torch.int8 and w_q.shape == (K, N), f"{name}: w_q int8 [{K}, N]")
    cuda_lib.require(scale.dtype == torch.float32 and scale.shape == (N,), f"{name}: scale f32 [N]")
    cuda_lib.require_cuda(name, x, w_q, scale)
    out = torch.empty((B, N), dtype=x.dtype, device=x.device)
    rc = cuda_lib.lib().omt_int8_matmul(
        x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        B, K, N, cuda_lib.dtype_code(x.dtype), cuda_lib.stream(x),
    )
    cuda_lib.check(rc, name)
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0
