"""A row's result independent of its batch, on the CPU: the fixed row
tiles of ``ops/rows.py`` (the card's route, run here on CPU tensors)
against F.linear, the kernels' grids that no longer take the batch's
size, and, as tests/test_serve.py holds the JAX package, a row's greedy
and per-row-key tokens equal alone and in batches of 2, 4 and 8, in every
decode mode. The
bits themselves are held on the card (``chip_smoke.py``,
tests/test_torch_cuda.py), where the tiles run: the CPU's own products and
reductions round a row by the batch's size.
"""

import inspect

import pytest
import torch
import torch.nn.functional as F

from open_musiclm_torch.core.sampling import seed_keys
from open_musiclm_torch.models.stages import create_semantic_transformer
from open_musiclm_torch.ops import decode_attention, fused_layer, rows

from tests.test_torch_serve import CB, MODE_IDS, MODES, N_CLAP_Q, tiny_stage
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("m", [1, 5, 64, 65, 300])
@pytest.mark.parametrize("tile", [rows.DECODE_TILE, rows.PREFILL_TILE])
def test_row_linear_tiles_equal_f_linear(m, tile):
    """The card's tiles (run here on CPU tensors): [m, K] with and without a
    bias, within float32 rounding of one F.linear; ``row_linear`` on CPU
    tensors is the product itself, bit for bit, on [m, K] and [2, m, K]."""
    g = torch.Generator().manual_seed(m + tile)
    x, w, b = torch.randn(2, m, 96, generator=g), torch.randn(40, 96, generator=g), torch.randn(40, generator=g)
    for bias in (None, b):
        want = F.linear(x, w, bias)
        for i in range(2):
            got = rows._tiled_linear(x[i], w, bias, tile)
            assert got.shape == want[i].shape
            torch.testing.assert_close(got, want[i], atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(rows.row_linear(x, w, bias, tile=tile), want, atol=0, rtol=0)
        torch.testing.assert_close(rows.row_linear(x[0], w, bias, tile=tile), F.linear(x[0], w, bias), atol=0, rtol=0)


def test_row_tiles_calls_fn_on_whole_tiles(monkeypatch):
    """Each product call of the card's tiles sees exactly ``tile`` rows (the
    last padded with zeros), and the rows come back in order."""
    seen = []

    def linear(t, w, bias=None):
        seen.append(t.shape[0])
        return t * 2

    monkeypatch.setattr(rows.F, "linear", linear)
    x = torch.arange(10.0)[:, None].repeat(1, 3)
    out = rows._tiled_linear(x, None, None, 4)
    assert seen == [4, 4, 4]
    torch.testing.assert_close(out, x * 2, atol=0, rtol=0)


def test_kernel_grids_take_no_batch_size():
    """Kernel 2's splits and kernel 7's attention chunks are functions of
    the cache position alone (kernel 4 has the one route, the stream), so
    a row's partial sums fold in one order in any batch."""
    assert list(inspect.signature(decode_attention.decode_splits).parameters) == ["pos", "N"]
    assert list(inspect.signature(fused_layer.attn_chunk).parameters) == ["pos", "n_blocks"]
    assert decode_attention.decode_splits(1279, 1280) == (20, 1)
    assert fused_layer.attn_chunk(1279, 132) == (80, 16)


def _tokens(stage, cond, **kw):
    return stage.generate([cond], max_time_steps=5, filter_thres=0.5, **kw)


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_row_tokens_equal_at_batch_1_2_4_8(mode):
    """Row 1's greedy tokens and its per-row-key tokens (temperature 1) are
    the same alone and at batch 2, 4 and 8, where it sits in slots 1, 3 and
    6 beside other prompts."""
    stage = tiny_stage(create_semantic_transformer, 31, mode, semantic_codebook_size=CB)
    g = torch.Generator().manual_seed(32)
    cond = torch.randint(0, CB, (8, N_CLAP_Q), generator=g)
    keys = seed_keys(range(40, 48))
    slots = {1: 0, 2: 1, 4: 3, 8: 6}
    runs = {}
    for b, slot in slots.items():
        order = [i for i in range(8) if i != 1]
        order = order[:slot] + [1] + order[slot:b - 1]
        c, k = cond[order], keys[order]
        greedy = _tokens(stage, c, temperature=0.0)
        sampled = _tokens(stage, c, per_row_keys=k, temperature=1.0)
        runs[b] = (greedy[slot], sampled[slot])
    assert not torch.equal(sampled[slot], sampled[0])  # the rows' draws differ
    for b in (2, 4, 8):
        torch.testing.assert_close(runs[b][0], runs[1][0], atol=0, rtol=0)
        torch.testing.assert_close(runs[b][1], runs[1][1], atol=0, rtol=0)
