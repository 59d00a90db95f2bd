"""Port parity, decode modes: every mode of Stage.generate in
open_musiclm_torch against the JAX package, at small sizes in float32 with
the weights carried over by open_musiclm_torch.convert.

The fp decode (``quantized=False``: ``shared_kv_decode_step``,
``Transformer.decode_step``, ``token_cond.generate``) and the int8 serving
decode (``quantized=True``) with ``flash_kv`` None (``fused_ff`` True and
False), "f32" and "fused" are held to the JAX package's teacher-forced
per-step logits within 1e-4; "int8" and "bf16" are in test_torch_slice.py.
On the JAX side the Pallas kernels run through their XLA twins, as the JAX
package runs them on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_musiclm_tpu.models.musiclm import MusicLM as JMusicLM
from open_musiclm_tpu.models.quant_decode import generate_quantized as j_generate_quantized
from open_musiclm_tpu.models.quant_decode import quantize_stage_params as j_quantize_stage_params
from open_musiclm_tpu.models.token_cond import _tfm_bias_table, _tfm_decode_step, _tfm_init_cache, _tfm_prefill
from open_musiclm_tpu.models.token_cond import generate as j_generate
from open_musiclm_tpu.ops import attention as jattn
from open_musiclm_tpu.testing import CB, TINY_GEN_KW

from open_musiclm_torch.models import musiclm as tmusiclm_mod
from open_musiclm_torch.models import quant_decode as tqd
from open_musiclm_torch.models import token_cond as ttc
from open_musiclm_torch.models.stages import Stage
from open_musiclm_torch.ops import attention as tattn

from tests.test_torch_slice import _close, _stage_pair, _t, jax_tiny_musiclm, port_codec, port_model
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("pos", [0, 9, 23])
def test_shared_kv_decode_step_matches_jax(pos):
    """One query against the cache: the decode-layout bias row of this pos,
    keys j > pos and masked keys hidden, float32 scores."""
    rng = np.random.default_rng(pos)
    b, h, N, d = 3, 4, 24, 16
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, N, d)).astype(np.float32)
    v = rng.standard_normal((b, N, d)).astype(np.float32)
    table = rng.standard_normal((2 * N - 1, h)).astype(np.float32)
    key_mask = rng.random((b, N)) > 0.2
    key_mask[:, 0] = True
    want = jattn.shared_kv_decode_step(q, k, v, jnp.int32(pos), bias_table=table, key_mask=key_mask)
    got = tattn.shared_kv_decode_step(_t(q), _t(k), _t(v), pos, bias_table=_t(table), key_mask=_t(key_mask))
    _close(got, want)


def test_transformer_decode_step_matches_jax():
    """Three fp decode steps after an 11-token prefill: outputs, K/V rows
    and conv state."""
    jmodel, jparams, model = _stage_pair(4)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 11, 32)).astype(np.float32)
    steps = rng.standard_normal((3, 2, 32)).astype(np.float32)
    N = 16

    @jax.jit
    def run(p, x, steps):
        table = jmodel.apply(p, N, method=_tfm_bias_table)
        h, cache = jmodel.apply(p, x, jmodel.apply(p, 2, N, method=_tfm_init_cache), method=_tfm_prefill)
        hs = [h[:, -1]]
        for i in range(3):
            h_t, cache = jmodel.apply(p, steps[i], cache, 11 + i, table, method=_tfm_decode_step)
            hs.append(h_t)
        return jnp.stack(hs), cache

    jh, jcache = run(jparams, jnp.asarray(x), jnp.asarray(steps))
    tfm = model.transformer
    with torch.no_grad():
        cache = tfm.init_cache(2, N)
        table = tfm.bias_table(N)
        h, cache = tfm.prefill(_t(x), cache)
        hs = [h[:, -1]] + [tfm.decode_step(_t(steps[i]), cache, 11 + i, table) for i in range(3)]
    _close(torch.stack(hs), jh)
    for key in ("k", "v", "ff"):
        _close(cache[key], jcache[key])


def _prompt(seed, with_init, T=7):
    rng = np.random.default_rng(seed)
    cond = rng.integers(0, CB, (3, 8)).astype(np.int32)
    teacher = rng.integers(0, CB, (3, T, 3)).astype(np.int32)
    return cond, teacher, (teacher[:, :2] if with_init else None)


def _opt(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("with_init", [False, True])
def test_generate_teacher_forced_logits_match_jax(with_init):
    """The fp decode's per-step logits under a shared teacher prefix."""
    jmodel, jparams, model = _stage_pair(5)
    cond, teacher, init = _prompt(6, with_init)
    jgen = jax.jit(lambda p, c, i, t: j_generate(
        jmodel, p, [c], jax.random.PRNGKey(0), max_time_steps=7, init_pred_ids=i,
        teacher_ids=t, return_logits=True))
    _, jlogits = jgen(jparams, jnp.asarray(cond), _opt(init), jnp.asarray(teacher))
    _, logits = ttc.generate(
        model, [_t(cond)], torch.Generator().manual_seed(0), max_time_steps=7,
        init_pred_ids=None if init is None else _t(init), teacher_ids=_t(teacher), return_logits=True)
    assert logits.shape == jlogits.shape == (3, 21 - (6 if with_init else 0), CB + 1)
    _close(logits, jlogits)


@pytest.mark.parametrize("with_init", [False, True])
def test_generate_greedy_tokens_match_jax(with_init):
    """The fp decode sampling greedily from its own tokens: the same ids,
    the given prefix kept."""
    jmodel, jparams, model = _stage_pair(7)
    cond, _, init = _prompt(8, with_init)
    want = jax.jit(lambda p, c, i: j_generate(
        jmodel, p, [c], jax.random.PRNGKey(0), max_time_steps=7, init_pred_ids=i,
        temperature=0.0))(jparams, jnp.asarray(cond), _opt(init))
    got = ttc.generate(model, [_t(cond)], max_time_steps=7,
                       init_pred_ids=None if init is None else _t(init), temperature=0.0)
    assert got.shape == (3, 7, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if init is not None:
        np.testing.assert_array_equal(got[:, :2].numpy(), init)


@pytest.mark.parametrize(
    "flash_kv,fused_ff,with_init",
    [(None, True, False), (None, False, False), (None, True, True), ("f32", True, False),
     ("fused", True, False), ("fused", True, True)],
)
def test_generate_quantized_modes_teacher_forced_logits_match_jax(flash_kv, fused_ff, with_init):
    """Per-step logits of the int8 decode modes under a shared teacher
    prefix (the JAX side through its XLA twins, use_pallas=False)."""
    jmodel, jparams, model = _stage_pair(9)
    fused = flash_kv == "fused"
    jq = j_quantize_stage_params(jmodel, jparams, fused=fused)
    tq = tqd.quantize_stage_params(model, fused=fused)
    cond, teacher, init = _prompt(10, with_init)
    jgen = jax.jit(lambda p, q, c, i, t: j_generate_quantized(
        jmodel, p, q, [c], jax.random.PRNGKey(0), max_time_steps=7, init_pred_ids=i,
        use_pallas=False, fused_ff=fused_ff, flash_kv=flash_kv, teacher_ids=t, return_logits=True))
    _, jlogits = jgen(jparams, jq, jnp.asarray(cond), _opt(init), jnp.asarray(teacher))
    _, logits = tqd.generate_quantized(
        model, tq, [_t(cond)], torch.Generator().manual_seed(0), max_time_steps=7,
        init_pred_ids=None if init is None else _t(init), fused_ff=fused_ff, flash_kv=flash_kv,
        teacher_ids=_t(teacher), return_logits=True)
    assert logits.shape == jlogits.shape
    _close(logits, jlogits)


@pytest.mark.parametrize(
    "quantized,flash_kv",
    [(False, None), (True, None), (True, "bf16"), (True, "f32"), (True, "int8"), (True, "fused")],
)
def test_stage_runs_every_mode(quantized, flash_kv):
    """Stage.generate routes each mode to its decode: the same logits as
    calling that decode directly."""
    _, _, model = _stage_pair(11)
    cond, teacher, _ = _prompt(12, False, T=3)
    kw = dict(max_time_steps=3, temperature=0.0, return_logits=True)
    toks, logits = Stage(model, quantized=quantized, flash_kv=flash_kv).generate(
        [_t(cond)], teacher_forced_ids=_t(teacher), **kw)
    if quantized:
        qp = tqd.quantize_stage_params(model, fused=flash_kv == "fused")
        want = tqd.generate_quantized(model, qp, [_t(cond)], flash_kv=flash_kv, teacher_ids=_t(teacher), **kw)
    else:
        want = ttc.generate(model, [_t(cond)], teacher_ids=_t(teacher), **kw)
    assert toks.shape == (3, 3, 3)
    torch.testing.assert_close(logits, want[1], atol=0, rtol=0)


@pytest.mark.parametrize(
    "quantized,flash_kv", [(False, None), (True, None), (True, "fused")], ids=["fp", "int8-none", "fused"])
def test_musiclm_generate_modes_match_jax(quantized, flash_kv):
    """The doll-house MusicLM through both packages with the stages in one
    decode mode, greedy: the same codes and waveform (the int8 and bf16
    flash modes: test_torch_slice.py)."""
    jm: JMusicLM = jax_tiny_musiclm(quantized=quantized, flash_kv=flash_kv)
    tm = tmusiclm_mod.MusicLM(
        codec=port_codec(jm.codec, jm.codec_params),
        **{
            name: Stage(port_model(st.model, st.params), quantized=quantized, flash_kv=flash_kv)
            for name, st in (("semantic_stage", jm.semantic_stage),
                             ("coarse_stage", jm.coarse_stage), ("fine_stage", jm.fine_stage))
        },
    )
    clap = np.random.default_rng(13).integers(0, CB, (2, 4)).astype(np.int32)
    greedy = dict(semantic_temperature=0.0, coarse_temperature=0.0, fine_temperature=0.0)
    codes = {}

    def capture(name, decode):
        def wrapped(*args):
            codes[name] = np.asarray(args[-1])
            return decode(*args)
        return wrapped

    jm._decode = capture("jax", jm._decode)
    tm._decode = capture("torch", tm._decode)
    want = jm.generate(key=jax.random.PRNGKey(0), clap_token_ids=jnp.asarray(clap), **greedy, **TINY_GEN_KW)
    got = tm.generate(clap_token_ids=_t(clap), generator=torch.Generator().manual_seed(0), **greedy, **TINY_GEN_KW)
    assert codes["torch"].shape == codes["jax"].shape == (2, 45, 4)
    np.testing.assert_array_equal(codes["torch"], codes["jax"])
    _close(got, want)


@pytest.mark.parametrize("batch,seconds,max_fine_rows", [(1, 3, 256), (2, 6, 2)])
def test_chip_smoke_decode_steps_are_generates(monkeypatch, batch, seconds, max_fine_rows):
    """chip_smoke.expected_decode_steps, which holds musiclm_large's kernel-7
    launches on the card, counts the decode steps (logit-head calls) each
    stage of the doll-house MusicLM.generate runs in "fused": semantic
    continuations, several coarse windows, fine windows in one call or
    split over MAX_FINE_ROWS."""
    import chip_smoke

    jm = jax_tiny_musiclm(quantized=True, flash_kv="fused")
    stages = {name: Stage(port_model(st.model, st.params), quantized=True, flash_kv="fused")
              for name, st in (("semantic", jm.semantic_stage), ("coarse", jm.coarse_stage),
                               ("fine", jm.fine_stage))}
    calls, steps = [0], {}
    head = tqd.int8_matmul

    def counted(*args, **kw):
        calls[0] += 1
        return head(*args, **kw)

    def per_stage(name, st):
        inner = st.generate

        def run(*args, **kw):
            before = calls[0]
            out = inner(*args, **kw)
            steps[name] = steps.get(name, 0) + calls[0] - before
            return out

        st.generate = run
        return st

    monkeypatch.setattr(tqd, "int8_matmul", counted)
    monkeypatch.setattr(tmusiclm_mod, "MAX_FINE_ROWS", max_fine_rows)
    tm = tmusiclm_mod.MusicLM(codec=port_codec(jm.codec, jm.codec_params),
                              **{f"{n}_stage": per_stage(n, st) for n, st in stages.items()})
    windows = {k: v for k, v in TINY_GEN_KW.items() if k.endswith("window_seconds")}
    rates = {k: TINY_GEN_KW[k] for k in ("semantic_steps_per_second", "acoustic_steps_per_second")}
    clap = np.random.default_rng(13).integers(0, CB, (batch, 4))
    tm.generate(clap_token_ids=_t(clap), generator=torch.Generator().manual_seed(0), output_seconds=seconds,
                **windows, **rates)
    quantizers = {n: st.model.specs[-1].num_quantizers for n, st in stages.items()}
    assert steps == chip_smoke.expected_decode_steps(seconds, windows, quantizers, *rates.values(), batch)
