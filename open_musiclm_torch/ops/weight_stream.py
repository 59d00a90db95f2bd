"""Grids of the int8 weight stream shared by kernels 3 and 4
(``csrc/weight_stream.cuh``).

A block of the stream owns up to 128 consecutive output columns of an int8
``[in, out]`` matrix and one split of its k rows; a column block's splits
are summed in split order by the last of them to finish. ``stream_grid``
chooses the cut, so that the blocks fill the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

STREAM_ROWS = 8  # activation rows a pass (csrc/weight_stream.cuh: RB)
STREAM_SEG = 128  # columns a block at most: a row's 128 bytes over 8 lanes (SEG)
STREAM_STEP = 16  # k rows a warp takes at a time (KS)
STREAM_RECORD = STREAM_ROWS * STREAM_SEG  # floats of a block's partial of one matrix
TARGET_BLOCKS = 132  # one block for each of the H100's SMs
MIN_SPLIT_ROWS = 64  # k rows a split at the least, so that a partial is small beside its weights


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def stream_grid(k_rows: int, n_cols: int, target: int,
                aligned: Optional[bool] = None) -> Tuple[int, int, int, int]:
    """(column blocks, columns a block, splits, k rows a split) of a weight
    stream over an int8 [k_rows, n_cols] matrix.

    A warp reads ``cols`` consecutive columns of 16 rows at a time as
    aligned 4-byte words: up to 128 columns when rows start 4-byte aligned
    (``aligned``, by default when ``n_cols`` is a multiple of 4), 124 when
    not (the words start up to 3 bytes before the columns). Column blocks
    are as few as that allows, with the columns spread evenly over them; k
    is split so that the blocks reach ``target`` where k allows,
    ``MIN_SPLIT_ROWS`` rows a split at the least, in whole 16-row steps.
    Block (c, s) takes columns [c * cols, (c + 1) * cols) and k rows
    [s * per, min((s + 1) * per, k_rows)); a column block's splits are
    summed in split order."""
    if aligned is None:
        aligned = n_cols % 4 == 0
    max_cols = STREAM_SEG if aligned else STREAM_SEG - 4
    cols = cdiv(cdiv(n_cols, cdiv(n_cols, max_cols)), 4) * 4
    blocks = cdiv(n_cols, cols)
    want = max(1, min(cdiv(k_rows, MIN_SPLIT_ROWS), target // blocks))
    per = cdiv(cdiv(k_rows, want), STREAM_STEP) * STREAM_STEP
    return blocks, cols, cdiv(k_rows, per), per
