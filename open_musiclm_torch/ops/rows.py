"""Products whose rows keep their bits whatever batch they ride in.

cuBLAS picks a product's algorithm (tile shape, how K is split) from its
shape (M, N, K), so on the card a row of ``x @ W^T`` can round differently
when the batch around it has another number of rows, and a request's
tokens would then change with the server's bucket or its companions
(``chip_smoke.py --probe``, on the H100: bf16 ``proj_in`` [1024 -> 5460]
differs at every row count from 2 up, every float32 projection too). At one
shape, a row's result does not depend on the other rows or on where it lies
among them (the same probe). So the inference paths run their products
through ``row_linear``: on the card the rows are cut into tiles of a fixed
row count, the last padded with zeros, and each tile is one cuBLAS call of
that one shape. On the CPU the product runs as it is. Training does not
come through here.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

DECODE_TILE = 64  # rows of a decode step's products (batch rows, or batch x fine windows)
PREFILL_TILE = 256  # rows of a prefill's products (batch x prompt positions)


def _tiled_linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], tile: int) -> torch.Tensor:
    """``F.linear`` over rows x [M, K] in calls of exactly ``tile`` rows."""
    m = x.shape[0]
    pad = -m % tile
    if pad:
        x = torch.cat([x, x.new_zeros((pad, x.shape[1]))])
    return torch.cat([F.linear(x[i:i + tile], weight, bias) for i in range(0, m + pad, tile)])[:m]


def row_linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
               tile: int = DECODE_TILE) -> torch.Tensor:
    """``F.linear(x, weight, bias)`` over x [..., K], its rows in ``tile``-row
    calls on the card."""
    if not x.is_cuda:
        return F.linear(x, weight, bias)
    lead = x.shape[:-1]
    y = _tiled_linear(x.reshape(-1, x.shape[-1]), weight, bias, tile)
    return y.reshape(*lead, y.shape[-1])
