"""Weight-only int8 quantization (port of open_musiclm_tpu/ops/quant.py).

``quantize_weight``/``dequantize_weight`` define the numerics on the JAX
package's ``[in, out]`` layout (per-output-column symmetric scales).
``int8_matmul`` is the wrapper of kernel 4 (``csrc/int8_matmul.cu``,
replacing the Pallas kernel ``ops/quant.py:int8_matmul``);
``int8_matmul_plain`` is its plain version. ``int8_route`` picks the
kernel's route for a row count, ``int8_stream_grid`` and
``int8_tiled_grid`` the two routes' grids.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from . import cuda_lib
from .weight_stream import STREAM_RECORD, STREAM_ROWS, TARGET_BLOCKS, cdiv, stream_grid

# rows above which kernel 4 takes its tiled route: up to two 8-row passes
# the weight stream is as fast as the tiles or faster on the H100 (one pass
# a third faster); each further pass re-reads the weights and adds a
# partial to every fold (chip_smoke.py times both routes from 14 rows)
INT8_STREAM_MAX_ROWS = 16
INT8_TILE = 64  # rows, columns and k rows a step of an output tile of the tiled route
INT8_TILED_BLOCKS = 2 * TARGET_BLOCKS  # two tiled blocks an SM (128 threads, <= 32 KB shared)


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


def int8_route(rows: int) -> str:
    """Kernel 4's route for ``rows`` rows of x: "stream" (kernel 3's weight
    stream, 8 rows a pass) up to ``INT8_STREAM_MAX_ROWS``, "tiled" above."""
    return "stream" if rows <= INT8_STREAM_MAX_ROWS else "tiled"


@functools.lru_cache(maxsize=None)
def int8_stream_grid(k_rows: int, n_cols: int, aligned: bool) -> Tuple[int, int, int, int]:
    """``stream_grid`` of kernel 4's stream route over int8 [k_rows, n_cols]
    whose rows start 4-byte aligned or not."""
    return stream_grid(k_rows, n_cols, TARGET_BLOCKS, aligned)


@functools.lru_cache(maxsize=None)
def int8_tiled_grid(rows: int, k_rows: int, n_cols: int) -> Tuple[int, int, int, int]:
    """(row tiles, column tiles, splits, k rows a split) of kernel 4's tiled
    route: 64 x 64 output tiles, k split into ranges of whole 64-row steps,
    two steps a split at the least, so that the blocks reach
    ``INT8_TILED_BLOCKS`` where k allows. Block (x, y, z) takes rows [64 y,
    64 y + 64), columns [64 x, 64 x + 64) and k rows [z * per, min((z + 1) *
    per, k_rows)); a tile's splits are summed in split order."""
    row_tiles, col_tiles = cdiv(rows, INT8_TILE), cdiv(n_cols, INT8_TILE)
    steps = cdiv(k_rows, INT8_TILE)
    want = max(1, min(cdiv(steps, 2), INT8_TILED_BLOCKS // (row_tiles * col_tiles)))
    per = cdiv(steps, want) * INT8_TILE
    return row_tiles, col_tiles, cdiv(k_rows, per), per


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                route: Optional[str] = None) -> torch.Tensor:
    """Kernel 4: x [B, in] @ int8 w_q [in, out] * scale [out] -> [B, out] in
    x's dtype. ``route`` ("stream" or "tiled") overrides ``int8_route``."""
    if not x.is_cuda:
        return int8_matmul_plain(x, w_q, scale)
    name = "int8_matmul"
    B, K = x.shape
    N = w_q.shape[1]
    cuda_lib.require(w_q.dtype == torch.int8 and w_q.shape == (K, N), f"{name}: w_q int8 [{K}, N]")
    cuda_lib.require(scale.dtype == torch.float32 and scale.shape == (N,), f"{name}: scale f32 [N]")
    cuda_lib.require_cuda(name, x, w_q, scale)
    route = route or int8_route(B)
    cuda_lib.require(route in ("stream", "tiled"), f"{name}: route must be stream or tiled, got {route}")
    out = torch.empty((B, N), dtype=x.dtype, device=x.device)
    if B == 0 or N == 0:
        return out
    w_off = w_q.data_ptr() % 4  # the kernel reads W by aligned words from w_q - w_off
    cols = col_blocks = splits = per = 0
    tickets = part = None
    if route == "stream":
        col_blocks, cols, splits, per = int8_stream_grid(K, N, N % 4 == 0 and w_off == 0)
        n_tickets = col_blocks
        n_floats = cdiv(B, STREAM_ROWS) * col_blocks * splits * STREAM_RECORD
    else:
        row_tiles, col_blocks, splits, per = int8_tiled_grid(B, K, N)
        n_tickets = row_tiles * col_blocks
        n_floats = splits * n_tickets * INT8_TILE * INT8_TILE if splits > 1 else 0
    if n_floats:
        tickets, part = cuda_lib.stream_scratch(name, x, n_tickets, n_floats)
    x_vec = K % 8 == 0 and x.data_ptr() % 16 == 0
    rc = cuda_lib.lib().omt_int8_matmul(
        x.data_ptr(), w_q.data_ptr() - w_off, w_off, scale.data_ptr(), out.data_ptr(),
        part.data_ptr() if part is not None else None,
        tickets.data_ptr() if tickets is not None else None, B, K, N, cols, col_blocks, splits,
        per, int(route == "tiled"), int(x_vec), cuda_lib.dtype_code(x.dtype), cuda_lib.stream(x),
    )
    cuda_lib.check(rc, name)
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0
