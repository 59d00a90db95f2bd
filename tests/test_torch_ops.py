"""Port parity, ops level: each module of open_musiclm_torch that holds a
kernel, and its helpers, against the JAX package on the same numpy inputs.

The port's plain versions (what its kernel wrappers run for CPU tensors) are
held against the JAX ``*_xla`` twins and against the Pallas kernels in
interpret mode, in float32 at atol = rtol = 1e-5 unless stated. The CUDA
kernels themselves are held against the plain versions on the card by the
``cuda``-marked tests in test_torch_cuda.py and by chip_smoke.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_musiclm_tpu.config import load_model_config as jax_load_model_config
from open_musiclm_tpu.core import sequence as jsequence
from open_musiclm_tpu.core import sampling as jsampling
from open_musiclm_tpu.ops import attention as jattn
from open_musiclm_tpu.ops import decode_attention as jdec
from open_musiclm_tpu.ops import fused_ff as jff
from open_musiclm_tpu.ops import fused_layer as jfl
from open_musiclm_tpu.ops import quant as jquant
from open_musiclm_tpu.ops import relpos as jrelpos
from open_musiclm_tpu.ops.pallas_attention import shared_kv_attention_pallas

from open_musiclm_torch import config as tconfig
from open_musiclm_torch.core import sampling as tsampling
from open_musiclm_torch.core import sequence as tsequence
from open_musiclm_torch.ops import cuda_lib
from open_musiclm_torch.ops import attention as tattn
from open_musiclm_torch.ops import decode_attention as tdec
from open_musiclm_torch.ops import fused_ff as tff
from open_musiclm_torch.ops import fused_layer as tfl
from open_musiclm_torch.ops import quant as tquant
from open_musiclm_torch.ops import relpos as trelpos
from open_musiclm_torch.convert import stage_state_dict

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), **(tol or TOL))


# ---------------------------------------------------------------------------
# kernel 1: prefill attention
# ---------------------------------------------------------------------------


def _attn_inputs(seed, b, h, n, m, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, n, d)).astype(np.float32)
    k = rng.standard_normal((b, m, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    k /= np.linalg.norm(k, axis=-1, keepdims=True)
    v = rng.standard_normal((b, m, d)).astype(np.float32)
    bias = rng.standard_normal((h, n, m)).astype(np.float32)
    key_mask = rng.random((b, m)) > 0.3
    key_mask[:, 0] = True  # every row keeps a key the Pallas kernel agrees on
    return q, k, v, bias, key_mask


@pytest.mark.parametrize(
    "n,m,with_bias,with_mask,ncp",
    [
        (37, 37, True, False, 0),  # prefill shape: ragged n, bias, causal
        (20, 29, True, True, 0),  # queries are the last n of m keys, key mask
        (33, 33, False, False, 5),  # bidirectional prefix, no bias
    ],
)
def test_prefill_attention_plain_matches_jax(n, m, with_bias, with_mask, ncp):
    q, k, v, bias, key_mask = _attn_inputs(n + m, 2, 4, n, m, 16)
    bias = bias if with_bias else None
    key_mask = key_mask if with_mask else None
    want_xla = jattn.shared_kv_attention(
        q, k, v, scale=8.0, attn_bias=bias, key_mask=key_mask, causal=True,
        non_causal_prefix=ncp,
    )
    want_kernel = shared_kv_attention_pallas(
        q, k, v, bias, key_mask, scale=8.0, causal=True, non_causal_prefix=ncp,
        block_n=16, interpret=True,
    )
    args = (_t(q), _t(k), _t(v), None if bias is None else _t(bias),
            None if key_mask is None else _t(key_mask))
    got = tattn.shared_kv_attention(
        *args[:3], scale=8.0, attn_bias=args[3], key_mask=args[4], causal=True,
        non_causal_prefix=ncp,
    )
    _close(got, want_xla)
    _close(got, want_kernel)
    launches = tattn.shared_kv_attention_fused.launches
    wrapped = tattn.shared_kv_attention_fused(*args, scale=8.0, causal=True, non_causal_prefix=ncp)
    assert tattn.shared_kv_attention_fused.launches == launches  # CPU: plain version
    _close(wrapped, got.numpy(), atol=0, rtol=0)


def test_prefill_attention_fully_masked_row_is_uniform():
    """-1e9 masking (not -inf): a row whose every key is masked averages v
    over all m keys, like the JAX plain version."""
    q, k, v, bias, key_mask = _attn_inputs(7, 1, 2, 6, 6, 8)
    key_mask[:] = False
    want = jattn.shared_kv_attention(q, k, v, key_mask=key_mask, causal=True)
    got = tattn.shared_kv_attention(_t(q), _t(k), _t(v), key_mask=_t(key_mask), causal=True)
    _close(got, want)
    np.testing.assert_allclose(got[0, :, :8].numpy(), np.broadcast_to(v[0].mean(0), (6, 8)), atol=1e-6)


def test_l2norm_matches_jax():
    x = np.random.default_rng(3).standard_normal((4, 5, 16)).astype(np.float32)
    x[0, 0] = 0.0  # eps branch
    _close(tattn.l2norm(_t(x)), jattn.l2norm(x))


# ---------------------------------------------------------------------------
# kernel 2: flash decode
# ---------------------------------------------------------------------------

N_CACHE = 2 * tdec.CHUNK


def _decode_inputs(seed, b=3, h=4, d=16, N=N_CACHE):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    k = rng.standard_normal((b, N, d)).astype(np.float32)
    k /= np.linalg.norm(k, axis=-1, keepdims=True)
    v = rng.standard_normal((b, N, d)).astype(np.float32)
    bias_row = rng.standard_normal((N, h)).astype(np.float32)
    add_mask = np.where(rng.random((b, N)) > 0.2, 0.0, -1e9).astype(np.float32)
    add_mask[:, 0] = 0.0
    return q, k, v, bias_row, add_mask


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("pos", [0, 100, tdec.CHUNK - 1, tdec.CHUNK, tdec.CHUNK + 17, N_CACHE - 1])
def test_flash_decode_plain_matches_jax(mode, pos):
    """"bf16" is the unquantized cache mode (float32 rows in this test);
    batch 3 is ragged for the TPU kernel's 8-row tiling."""
    q, k, v, bias_row, add_mask = _decode_inputs(pos)
    if mode == "int8":
        kq, ks = jdec.quantize_kv_row(k.reshape(-1, k.shape[-1]))
        vq, vs = jdec.quantize_kv_row(v.reshape(-1, v.shape[-1]))
        b, N = k.shape[:2]
        kv = np.concatenate([np.asarray(kq), np.asarray(vq)], -1).reshape(b, N, -1)
        sc = np.stack([np.asarray(ks).reshape(b, N), np.asarray(vs).reshape(b, N)])
        tkq, tks = tdec.quantize_kv_row(_t(k))
        tvq, tvs = tdec.quantize_kv_row(_t(v))
        np.testing.assert_array_equal(torch.cat([tkq, tvq], -1).numpy(), kv)
        np.testing.assert_array_equal(torch.stack([tks, tvs]).numpy(), sc)
    else:
        kv, sc = np.concatenate([k, v], -1), None
    jpos = jnp.int32(pos)
    want_xla = jdec.flash_decode_step_xla(q, kv, jpos, bias_row, add_mask, sc)
    want_kernel = jdec.flash_decode_step(q, kv, jpos, bias_row, add_mask, sc, interpret=True)
    args = (_t(q), _t(kv), pos, _t(bias_row), _t(add_mask), None if sc is None else _t(sc))
    got = tdec.flash_decode_step_plain(*args)
    _close(got, want_xla)
    _close(got, want_kernel)
    launches = tdec.flash_decode_step.launches
    _close(tdec.flash_decode_step(*args), got.numpy(), atol=0, rtol=0)
    assert tdec.flash_decode_step.launches == launches


def test_round_up_chunk():
    assert [tdec.round_up_chunk(n) for n in (1, 256, 257, 1116)] == [
        jdec.round_up_chunk(n) for n in (1, 256, 257, 1116)
    ] == [256, 256, 512, 1280]


@pytest.mark.parametrize("b", [1, 2, 3, 8, 14, 16])
def test_decode_splits_cover_every_row(b):
    """Kernel 2's split of the live cache, at every position of a 1280-row
    cache: the splits cover rows 0..pos exactly once, in order, none empty;
    a step with pos < 64 is one block a batch row, and b rows' grid reaches
    132 blocks (one an SM) wherever the live chunks allow. The splits are a
    function of pos and N alone (the batch's size does not enter, so a row's
    partials fold in one order in any batch), a chunk a split at N 1280."""
    N, chunk = 1280, tdec.SPLIT_ROWS
    for pos in range(N):
        splits, per = tdec.decode_splits(pos, N)
        assert per == 1 and splits == pos // chunk + 1
        # split s reads chunks [s * per, (s + 1) * per) of rows <= pos (csrc/flash_decode.cu)
        rows = [(s * per * chunk, min((s + 1) * per * chunk, pos + 1)) for s in range(splits)]
        assert rows[0][0] == 0 and rows[-1][1] == pos + 1
        assert all(start < stop for start, stop in rows)
        assert all(a[1] == c[0] for a, c in zip(rows, rows[1:]))
        assert b * splits >= min(132, b * (pos // chunk + 1))
        if pos < chunk:
            assert splits == 1
    with pytest.raises(ValueError):
        tdec.decode_splits(N, N)
    # musiclm_large's 2,816-row coarse cache: 44 chunks at its last pos, two a split
    assert tdec.decode_splits(2815, 2816) == (22, 2)


def test_decode_scratch_kept_per_stream():
    """Kernel 2's scratch (tickets, partials): one pair per (device, stream),
    tickets zeroed, each grown when a call needs more, kept otherwise."""
    cpu = torch.device("cpu")
    tickets, part = cuda_lib.scratch("flash_decode", cpu, 101, 8, 1000)
    assert tickets.dtype == torch.int32 and not tickets.any() and part.dtype == torch.float32
    assert cuda_lib.scratch("flash_decode", cpu, 101, 4, 500) == (tickets, part)
    other = cuda_lib.scratch("flash_decode", cpu, 102, 8, 1000)
    assert other[0] is not tickets and other[1] is not part
    grown = cuda_lib.scratch("flash_decode", cpu, 101, tickets.numel() + 1, 1000)
    assert grown[0].numel() > tickets.numel() and not grown[0].any() and grown[1] is part
    grown = cuda_lib.scratch("flash_decode", cpu, 101, 8, 2000)
    assert grown[1].numel() == 2000
    for stream in (101, 102):
        cuda_lib._scratch.pop(("flash_decode", cpu, stream))


# ---------------------------------------------------------------------------
# kernel 3: fused conv-FF
# ---------------------------------------------------------------------------


def _ff_params(seed, dim, inner):
    rng = np.random.default_rng(seed)
    return {
        "norm_in": {"gamma": rng.standard_normal(dim).astype(np.float32)},
        "proj_in": {"kernel": (rng.standard_normal((dim, 2 * inner)) / 8).astype(np.float32)},
        "conv_w": (rng.standard_normal((3, 2 * inner)) / 8).astype(np.float32),
        "norm_mid": {"gamma": rng.standard_normal(inner).astype(np.float32)},
        "proj_out": {"kernel": (rng.standard_normal((inner, dim)) / 8).astype(np.float32)},
    }


def _port_ff(f_params):
    from open_musiclm_torch.models.transformer import ConvFeedForward

    dim = f_params["norm_in"]["gamma"].shape[0]
    ff = ConvFeedForward(dim)
    ff.load_state_dict({
        "norm_in.gamma": _t(f_params["norm_in"]["gamma"]),
        "proj_in.weight": _t(f_params["proj_in"]["kernel"].T.copy()),
        "conv_w": _t(f_params["conv_w"]),
        "norm_mid.gamma": _t(f_params["norm_mid"]["gamma"]),
        "proj_out.weight": _t(f_params["proj_out"]["kernel"].T.copy()),
    })
    return ff


@pytest.mark.parametrize("b", [5, 70])
def test_fused_ff_plain_matches_jax(b):
    """dim 36 gives inner = int(36 * 8 / 3) = 96, ragged against the TPU
    kernel's 128-lane padding; b = 70 spans two of its 64-row blocks."""
    dim = 36
    inner = int(dim * 8 / 3)
    f_params = _ff_params(b, dim, inner)
    ff = _port_ff(f_params)
    jpacked = jff.pack_ff_weights(f_params)
    tpacked = tff.pack_ff_weights(ff)
    # quantization is per output column: the port's values are the JAX ones
    # without the 128-lane padding
    for key in ("wv", "wg", "sv", "sg", "gmid"):
        np.testing.assert_array_equal(
            tpacked[key].numpy(), np.asarray(jpacked[key])[..., :inner], err_msg=key
        )
    np.testing.assert_array_equal(tpacked["wo"].numpy(), np.asarray(jpacked["wo"])[:inner])
    np.testing.assert_array_equal(tpacked["so"].numpy(), np.asarray(jpacked["so"]))
    rng = np.random.default_rng(b + 1)
    x = rng.standard_normal((b, dim)).astype(np.float32)
    state = (rng.standard_normal((b, 2, 2 * inner)) / 4).astype(np.float32)
    y_xla, st_xla = jff.fused_ff_apply_xla(x, jpacked, state)
    y_k, st_k = jff.fused_ff_apply(x, jpacked, state, interpret=True)
    y, st = tff.fused_ff_apply_plain(_t(x), tpacked, _t(state))
    _close(y, y_xla)
    _close(st, st_xla)
    _close(y, y_k)
    _close(st, st_k)
    launches = tff.fused_ff_apply.launches
    y2, st2 = tff.fused_ff_apply(_t(x), tpacked, _t(state))
    assert tff.fused_ff_apply.launches == launches
    _close(y2, y.numpy(), atol=0, rtol=0)
    _close(st2, st.numpy(), atol=0, rtol=0)


# ---------------------------------------------------------------------------
# kernel 7: one whole decode layer
# ---------------------------------------------------------------------------

# dim 80 gives inner = int(80 * 8 / 3) = 213: off the port's 16-wide and the
# TPU kernel's 128-lane padding of the FF out-projection
FL_DIM, FL_HEADS, FL_D = 80, 2, 8
FL_INNER = int(FL_DIM * 8 / 3)


def _layer_params(seed):
    rng = np.random.default_rng(seed)
    dim, hd, d = FL_DIM, FL_HEADS * FL_D, FL_D
    a_params = {
        "norm": {"gamma": (1 + 0.1 * rng.standard_normal(dim)).astype(np.float32)},
        "to_q": {"kernel": (0.1 * rng.standard_normal((dim, hd))).astype(np.float32)},
        "to_kv": {"kernel": (0.1 * rng.standard_normal((dim, 2 * d))).astype(np.float32)},
        "to_out": {"kernel": (0.1 * rng.standard_normal((hd, dim))).astype(np.float32)},
        "q_scale": (1.1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
        "k_scale": (0.9 + 0.1 * rng.standard_normal(d)).astype(np.float32),
    }
    return a_params, _ff_params(seed + 1, dim, FL_INNER)


def _port_attn(a_params):
    from open_musiclm_torch.models.transformer import Attention

    attn = Attention(FL_DIM, FL_HEADS, FL_D)
    attn.load_state_dict({
        "norm.gamma": _t(a_params["norm"]["gamma"]),
        "to_q.weight": _t(a_params["to_q"]["kernel"].T.copy()),
        "to_kv.weight": _t(a_params["to_kv"]["kernel"].T.copy()),
        "q_scale": _t(a_params["q_scale"]), "k_scale": _t(a_params["k_scale"]),
        "to_out.weight": _t(a_params["to_out"]["kernel"].T.copy()),
    })
    return attn


def test_pack_layer_weights_matches_jax():
    """The port stores the int8 weights output-major ([out, in]) and pads
    inner to 16 (not 128): the same values and scales in another layout."""
    a_params, f_params = _layer_params(0)
    jp = jfl.pack_layer_weights(a_params, f_params)
    tp = tfl.pack_layer_weights(_port_attn(a_params), _port_ff(f_params))
    jf, inner = jp["ff"], FL_INNER
    int8_pairs = {
        "wqT": jp["wqT"], "wkvT": jp["wkvT"], "woT": np.asarray(jp["wo_attn"]).T,
        "wvT": np.asarray(jf["wv"])[:, :inner].T, "wgT": np.asarray(jf["wg"])[:, :inner].T,
        "ff_woT": np.asarray(jf["wo"])[:inner].T,
    }
    for key, want in int8_pairs.items():
        got = tp[key].numpy()
        if key == "ff_woT":
            assert got.shape == (FL_DIM, 224) and not got[:, inner:].any()
            got = got[:, :inner]
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=key)
    scale_pairs = {
        "sq": np.asarray(jp["sqh"]).reshape(-1), "skv": np.asarray(jp["skv2"]).reshape(-1),
        "so": jp["so_attn"], "sv": np.asarray(jf["sv"])[:inner], "sg": np.asarray(jf["sg"])[:inner],
        "ff_so": jf["so"], "gamma": jp["attn_gamma"], "q_scale": jp["q_scale"],
        "k_scale": jp["k_scale"], "gin": jf["gin"], "gmid": np.asarray(jf["gmid"])[:inner],
        "conv_v": np.asarray(jf["conv_v"])[:3, :inner], "conv_g": np.asarray(jf["conv_g"])[:3, :inner],
    }
    for key, want in scale_pairs.items():
        _close(tp[key], want, atol=0, rtol=1e-6)


def _layer_state(seed, b):
    rng = np.random.default_rng(seed)
    N, d = 2 * tdec.CHUNK, FL_D
    k = rng.standard_normal((b, N, d)).astype(np.float32)
    k /= np.linalg.norm(k, axis=-1, keepdims=True)
    kq, ks = tdec.quantize_kv_row(_t(k))
    vq, vs = tdec.quantize_kv_row(_t(rng.standard_normal((b, N, d)).astype(np.float32)))
    return dict(
        x=rng.standard_normal((b, FL_DIM)).astype(np.float32),
        kv_cache=torch.cat([kq, vq], -1).numpy(),
        kv_scale=torch.stack([ks, vs]).numpy(),
        ff_state=(rng.standard_normal((b, 2, 2 * FL_INNER)) / 4).astype(np.float32),
        bias_row=rng.standard_normal((N, FL_HEADS)).astype(np.float32),
        add_mask=np.where(rng.random((b, N)) > 0.2, 0.0, -1e9).astype(np.float32),
    )


@pytest.mark.parametrize("b", [3, 4])
@pytest.mark.parametrize("pos", [0, 5, tdec.CHUNK, tdec.CHUNK + 33])
def test_fused_layer_plain_matches_jax(pos, b):
    """The plain version against the Pallas kernel in interpret mode and
    the XLA twin, float32, atol 2e-4 (the JAX test's own tolerance); batch
    3 is ragged for the TPU kernel's blocks. Beyond the JAX contract it
    writes the fresh row, quantized, into the cache at pos and the new conv
    state in place: held against the JAX caller's (fused_layer_step) write."""
    a_params, f_params = _layer_params(pos + b)
    jpacked = jfl.pack_layer_weights(a_params, f_params)
    tpacked = tfl.pack_layer_weights(_port_attn(a_params), _port_ff(f_params))
    st = _layer_state(pos * 7 + b, b)
    args = [st[k] for k in ("x", "kv_cache", "kv_scale", "ff_state")]
    jargs = (args[0], jpacked, *args[1:], jnp.int32(pos), st["bias_row"], st["add_mask"])
    want_xla = jfl.fused_layer_decode_step_xla(*jargs, heads=FL_HEADS)
    want_kernel = jfl.fused_layer_decode_step(*jargs, heads=FL_HEADS, interpret=True)
    kv, sc, state = (_t(a) for a in args[1:])
    got = tfl.fused_layer_decode_step_plain(
        _t(st["x"]), tpacked, kv, sc, state, pos, _t(st["bias_row"]), _t(st["add_mask"]),
        heads=FL_HEADS)
    for g, wx, wk in zip(got, want_xla, want_kernel):
        _close(g, wx, atol=2e-4, rtol=0)
        _close(g, wk, atol=2e-4, rtol=0)
    assert got[2] is state  # the conv state is updated in place
    # the cache row pos, quantized as the JAX caller does it
    d = FL_D
    krow = np.asarray(want_xla[1])
    jkq, jks = jdec.quantize_kv_row(krow[:, :d])
    jvq, jvs = jdec.quantize_kv_row(krow[:, d:])
    np.testing.assert_array_equal(kv[:, pos].numpy(), np.concatenate([jkq, jvq], -1))
    _close(sc[:, :, pos], np.stack([jks, jvs]), atol=0, rtol=1e-5)
    untouched = np.arange(kv.shape[1]) != pos
    np.testing.assert_array_equal(kv[:, untouched].numpy(), args[1][:, untouched])
    launches = tfl.fused_layer_decode_step.launches
    again = tfl.fused_layer_decode_step(
        _t(st["x"]), tpacked, _t(args[1]), _t(args[2]), _t(args[3]), pos,
        _t(st["bias_row"]), _t(st["add_mask"]), heads=FL_HEADS)
    assert tfl.fused_layer_decode_step.launches == launches  # CPU: plain version
    for a, g in zip(again, got):
        _close(a, g.numpy(), atol=0, rtol=0)


# ---------------------------------------------------------------------------
# kernel 4: int8 matmul
# ---------------------------------------------------------------------------


def test_quantize_weight_matches_jax():
    w = np.random.default_rng(0).standard_normal((64, 97)).astype(np.float32)
    w[:, 3] = 0.0  # all-zero column hits the 1e-12 scale floor
    jq, js = jquant.quantize_weight(w)
    tq, ts = tquant.quantize_weight(_t(w))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    _close(tquant.dequantize_weight(tq, ts), jquant.dequantize_weight(jq, js), atol=0, rtol=0)


@pytest.mark.parametrize("B,K,N", [(3, 64, 129), (8, 32, 1025)])
def test_int8_matmul_plain_matches_jax(B, K, N):
    """Odd output widths, as the 1025-way logit head."""
    rng = np.random.default_rng(N)
    x = rng.standard_normal((B, K)).astype(np.float32)
    wq, s = jquant.quantize_weight(rng.standard_normal((K, N)).astype(np.float32))
    want_xla = jquant.int8_matmul_xla(x, wq, s)
    want_kernel = jquant.int8_matmul(x, wq, s, block_out=128, interpret=True)
    args = (_t(x), _t(np.asarray(wq)), _t(np.asarray(s)))
    got = tquant.int8_matmul_plain(*args)
    _close(got, want_xla)
    _close(got, want_kernel)
    launches = tquant.int8_matmul.launches
    _close(tquant.int8_matmul(*args), got.numpy(), atol=0, rtol=0)
    assert tquant.int8_matmul.launches == launches


# ---------------------------------------------------------------------------
# rel-pos bias
# ---------------------------------------------------------------------------


def test_toeplitz_from_table_matches_jax():
    table = np.random.default_rng(1).standard_normal((2 * 9 - 1, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        trelpos.toeplitz_from_table(_t(table), 9).numpy(),
        np.asarray(jrelpos.toeplitz_from_table(table, 9)),
    )


def test_continuous_position_bias_matches_jax():
    mod = jrelpos.ContinuousPositionBias(dim=16, heads=3)
    dummy = jnp.zeros((1, 1))
    params = mod.init(jax.random.PRNGKey(0), dummy, method=jrelpos.ContinuousPositionBias.mlp)
    port = trelpos.ContinuousPositionBias(16, 3)
    sd = stage_state_dict(
        {"params": {"transformer": {"rel_pos_bias": params["params"], "final_norm": {"gamma": np.ones(1)}},
                    "start_tokens": np.zeros(1)}},
        num_specs=0, depth=0,
    )
    port.load_state_dict({
        k[len("transformer.rel_pos_bias."):]: v for k, v in sd.items()
        if k.startswith("transformer.rel_pos_bias.")
    })
    n = 11
    _close(port(n), mod.apply(params, n))
    _close(port.distance_table(20), mod.apply(params, 20, method=jrelpos.ContinuousPositionBias.distance_table))


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vocab", [17, 1025])
def test_top_k_filter_matches_jax(vocab):
    logits = np.random.default_rng(vocab).standard_normal((4, vocab)).astype(np.float32)
    logits[0, :5] = logits[0].max()  # ties at the k-th value are kept
    want = jsampling.top_k_filter(logits, 0.9, approx=False)
    np.testing.assert_array_equal(tsampling.top_k_filter(_t(logits), 0.9).numpy(), np.asarray(want))


@pytest.mark.parametrize("temperature", [1.0, 0.4])
def test_gumbel_sample_with_jax_uniforms(temperature):
    logits = np.random.default_rng(2).standard_normal((6, 1025)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = jsampling.sample_top_k_gumbel(key, logits, temperature, 0.9, approx=False)
    u = np.asarray(jax.random.uniform(key, logits.shape, dtype=jnp.float32))
    got = tsampling.sample_top_k_gumbel(_t(logits), temperature, 0.9, uniforms=_t(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_temperature_zero_is_greedy():
    logits = np.random.default_rng(4).standard_normal((5, 33)).astype(np.float32)
    got = tsampling.sample_top_k_gumbel(_t(logits), 0.0, 0.9, generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(got.numpy(), logits.argmax(-1))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jsampling.sample_top_k_gumbel(jax.random.PRNGKey(0), logits, 0.0, 0.9))
    )


def test_eos_helpers_match_jax():
    ids = np.array([[1, 2, 5, 3, 5], [5, 1, 1, 1, 1], [0, 1, 2, 3, 4]], np.int64)
    for keep in (True, False):
        np.testing.assert_array_equal(
            tsampling.mask_out_after_eos_id(_t(ids), 5, -1, keep).numpy(),
            np.asarray(jsampling.mask_out_after_eos_id(ids, 5, -1, keep)),
        )
    np.testing.assert_array_equal(
        tsampling.append_eos_id(_t(ids), 9).numpy(), np.asarray(jsampling.append_eos_id(ids, 9))
    )


# ---------------------------------------------------------------------------
# sequence layout, config
# ---------------------------------------------------------------------------


def test_sequence_layout_matches_jax():
    shapes = [(1024, 12), (1024, 1), (1024, 3)]
    jspecs = tuple(jsequence.TokenSequenceSpec(c, q) for c, q in shapes)
    tspecs = tuple(tsequence.TokenSequenceSpec(c, q) for c, q in shapes)
    lengths = (13, 200, 450)
    jl, tl = jsequence.SequenceLayout(jspecs, lengths), tsequence.SequenceLayout(tspecs, lengths)
    assert tl.start_positions == jl.start_positions
    assert [tl.pred_slice(i) for i in range(3)] == [jl.pred_slice(i) for i in range(3)]
    for js, ts, n in zip(jspecs, tspecs, lengths):
        assert (ts.eos_id, ts.vocab_with_eos, ts.embed_vocab) == (js.eos_id, js.vocab_with_eos, js.embed_vocab)
        np.testing.assert_array_equal(tsequence.quantizer_offsets(ts, n), jsequence.quantizer_offsets(js, n))


@pytest.mark.parametrize("name", ["musiclm_small", "musiclm_large"])
def test_config_loader_matches_jax(name):
    path = f"configs/model/{name}.json"
    assert dataclasses.asdict(tconfig.load_model_config(path)) == dataclasses.asdict(
        jax_load_model_config(path)
    )
