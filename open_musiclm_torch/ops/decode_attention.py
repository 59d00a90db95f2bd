"""Flash-decode attention over the packed K|V cache
(port of open_musiclm_tpu/ops/decode_attention.py).

The cache is ``[b, N, 2d]`` with K in lanes 0:d and V in d:2d, either in
float32 or bfloat16 (whatever the activations' dtype) or in int8 with
per-row float32 scales ``[2, b, N]`` (K row 0, V row 1). ``N`` is a multiple of ``CHUNK``, as in the JAX
package, so a decode step's rel-pos bias row is the same slice of the
decode-layout table in both packages.

``flash_decode_step`` is the wrapper of kernel 2
(``csrc/flash_decode.cu``, replacing the Pallas kernel
``ops/decode_attention.py:flash_decode_step``); ``flash_decode_step_plain``
is the plain version (the JAX ``flash_decode_step_xla`` twin).
``decode_splits`` chooses how kernel 2 splits the live cache across blocks.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import cuda_lib

NEG_INF = -1e9
CHUNK = 256  # cache buffers are padded to a multiple of this many rows
KV_INT8 = 2  # kernel 2's row-dtype code for int8 rows (0 and 1: cuda_lib.dtype_code)
SPLIT_ROWS = 64  # cache rows a chunk of kernel 2 (csrc/flash_decode.cu: CH)
# splits of the live cache at most: what fills two blocks on each of the
# H100's 132 SMs at b 8 (264 / 8); a function of the cache alone, so that a
# row's partials fold in one order whatever the batch's size
MAX_SPLITS = 33
PART_WIDTH = 2 + 64  # a split's record per head: max, denominator, 64 accumulators


def round_up_chunk(n: int) -> int:
    return ((n + CHUNK - 1) // CHUNK) * CHUNK


def quantize_kv_row(row: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., d] -> (int8 [..., d], scale f32 [...]) per-row symmetric."""
    rf = row.float()
    s = torch.clamp(rf.abs().amax(dim=-1) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(rf / s[..., None]), -127, 127).to(torch.int8)
    return q, s


def flash_decode_step_plain(
    q_t: torch.Tensor,  # [b, h, d]
    kv_cache: torch.Tensor,  # [b, N, 2d]
    pos: int,
    bias_row: torch.Tensor,  # [N, h]
    add_mask: torch.Tensor,  # [b, N] f32 additive (0 / NEG_INF)
    kv_scale: Optional[torch.Tensor] = None,  # [2, b, N] f32 for an int8 cache
    *,
    scale: float = 8.0,
) -> torch.Tensor:
    """Returns [b, h*d] in q_t's dtype; float32 math over the whole buffer."""
    b, h, d = q_t.shape
    N = kv_cache.shape[1]
    kvf = kv_cache.float()
    kf, vf = kvf[:, :, :d], kvf[:, :, d:]
    if kv_scale is not None:
        kf = kf * kv_scale[0][:, :, None]
        vf = vf * kv_scale[1][:, :, None]
    sim = torch.einsum("bhd,bnd->bhn", q_t.float(), kf) * scale
    sim = sim + bias_row.float().t()[None]
    sim = sim + add_mask.float()[:, None, :]
    j = torch.arange(N, device=q_t.device)
    sim = sim.masked_fill(j[None, None, :] > pos, NEG_INF)
    attn = torch.softmax(sim, dim=-1)
    out = torch.einsum("bhn,bnd->bhd", attn, vf)
    return out.reshape(b, h * d).to(q_t.dtype)


def decode_splits(pos: int, N: int) -> Tuple[int, int]:
    """(splits, chunks per split) of kernel 2's grid for a decode step at
    ``pos``: the live rows 0..pos form ``pos // 64 + 1`` chunks of 64, and
    split s covers chunks [s * per, min((s + 1) * per, chunks)). A chunk a
    split up to ``MAX_SPLITS`` splits, so that no split is empty and a step
    with pos < 64 is one block a batch row. The batch's size does not enter:
    a row's result is the same in any batch."""
    if not 0 <= pos < N:
        raise ValueError(f"pos {pos} outside the {N}-row cache")
    chunks = pos // SPLIT_ROWS + 1
    per = -(-chunks // min(chunks, MAX_SPLITS))
    return -(-chunks // per), per


def flash_decode_step(
    q_t: torch.Tensor,
    kv_cache: torch.Tensor,
    pos: int,
    bias_row: torch.Tensor,
    add_mask: torch.Tensor,
    kv_scale: Optional[torch.Tensor] = None,
    *,
    scale: float = 8.0,
) -> torch.Tensor:
    """Kernel 2. Same contract as ``flash_decode_step_plain``; reads only
    cache rows ``<= pos``, split across blocks as ``decode_splits`` says, in
    one launch."""
    if not q_t.is_cuda:
        return flash_decode_step_plain(
            q_t, kv_cache, pos, bias_row, add_mask, kv_scale, scale=scale
        )
    name = "flash_decode_step"
    b, h, d = q_t.shape
    N = kv_cache.shape[1]
    int8 = kv_scale is not None
    cuda_lib.require(d == 64, f"{name}: kernel takes dim_head 64, got {d}")
    cuda_lib.require(1 <= h <= 16, f"{name}: kernel takes 1..16 heads, got {h}")
    cuda_lib.require(kv_cache.shape == (b, N, 2 * d), f"{name}: kv_cache [b, N, 2d]")
    cuda_lib.require(0 <= pos < N, f"{name}: pos {pos} outside the {N}-row cache")
    cuda_lib.require(
        (kv_cache.dtype == torch.int8) == int8,
        f"{name}: cache dtype {kv_cache.dtype} (int8 rows need kv_scale, other rows none)",
    )
    cuda_lib.require(bias_row.dtype == torch.float32 and bias_row.shape == (N, h), f"{name}: bias_row f32 [N, h]")
    cuda_lib.require(add_mask.dtype == torch.float32 and add_mask.shape == (b, N), f"{name}: add_mask f32 [b, N]")
    tensors = [q_t, kv_cache, bias_row, add_mask]
    if int8:
        cuda_lib.require(kv_scale.dtype == torch.float32 and kv_scale.shape == (2, b, N), f"{name}: kv_scale f32 [2, b, N]")
        tensors.append(kv_scale)
    cuda_lib.require_cuda(name, *tensors)
    cuda_lib.require(kv_cache.data_ptr() % 16 == 0, f"{name}: kv_cache must be 16-byte aligned")
    splits, per = decode_splits(pos, N)
    out = torch.empty((b, h * d), dtype=q_t.dtype, device=q_t.device)
    # a ticket a batch row; the partials of b x splits blocks, [b, splits, h, PART_WIDTH]
    tickets, part = cuda_lib.stream_scratch("flash_decode", q_t, b, b * splits * h * PART_WIDTH)
    rc = cuda_lib.lib().omt_flash_decode(
        q_t.data_ptr(), kv_cache.data_ptr(), kv_scale.data_ptr() if int8 else None,
        bias_row.data_ptr(), add_mask.data_ptr(), out.data_ptr(),
        part.data_ptr() if splits > 1 else None, tickets.data_ptr(),
        b, h, N, int(pos), splits, per, float(scale), cuda_lib.dtype_code(q_t.dtype),
        KV_INT8 if int8 else cuda_lib.dtype_code(kv_cache.dtype), cuda_lib.stream(q_t),
    )
    cuda_lib.check(rc, name)
    flash_decode_step.launches += 1
    return out


flash_decode_step.launches = 0
