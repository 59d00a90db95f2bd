"""Port parity, slice level: the int8 serving path of open_musiclm_torch
(prefill, quantized decode, Encodec decode, MusicLM.generate) against the
JAX package at small sizes in float32, with the weights carried over by
open_musiclm_torch.convert. On the JAX side the Pallas kernels run through
their XLA twins, as the JAX package runs them on the CPU.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_musiclm_tpu.core.sequence import TokenSequenceSpec as JSpec
from open_musiclm_tpu.models import stages as jstages
from open_musiclm_tpu.models.encodec import EncodecModel as JEncodec
from open_musiclm_tpu.models.musiclm import MusicLM as JMusicLM
from open_musiclm_tpu.models.quant_decode import generate_quantized as j_generate_quantized
from open_musiclm_tpu.models.quant_decode import quantize_stage_params as j_quantize_stage_params
from open_musiclm_tpu.models.token_cond import (
    StageLossConfig,
    TokenConditionedTransformer as JTCT,
    _tfm_init_cache,
    _tfm_prefill,
)
from open_musiclm_tpu.testing import CB, N_CLAP_Q, TINY_GEN_KW

from open_musiclm_torch.convert import codec_state_dict, stage_state_dict
from open_musiclm_torch.core.sequence import TokenSequenceSpec
from open_musiclm_torch.models import musiclm as tmusiclm_mod
from open_musiclm_torch.models.encodec import EncodecModel
from open_musiclm_torch.models.quant_decode import generate_quantized, quantize_stage_params
from open_musiclm_torch.models.stages import Stage
from open_musiclm_torch.models.token_cond import TokenConditionedTransformer

from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


def port_model(jmodel, jparams) -> TokenConditionedTransformer:
    specs = tuple(TokenSequenceSpec(s.codebook_size, s.num_quantizers) for s in jmodel.specs)
    model = TokenConditionedTransformer(
        specs, jmodel.dim, jmodel.depth, heads=jmodel.heads, dim_head=jmodel.dim_head,
        grad_shrink_alpha=jmodel.grad_shrink_alpha,
        non_causal_prefix_size=jmodel.non_causal_prefix_size,
    )
    model.load_state_dict(stage_state_dict(jax.device_get(jparams), len(specs), jmodel.depth))
    return model.eval()


def port_codec(jcodec, jparams) -> EncodecModel:
    codec = EncodecModel(
        sample_rate=jcodec.sample_rate, num_quantizers=jcodec.num_quantizers,
        codebook_size=jcodec.codebook_size, dimension=jcodec.dimension,
        n_filters=jcodec.n_filters, ratios=jcodec.ratios,
    )
    missing, unexpected = codec.load_state_dict(
        codec_state_dict(jax.device_get(jparams), len(jcodec.ratios)), strict=False)
    # params initialised through decode alone have no encoder
    assert not unexpected and all(k.startswith("encoder.") for k in missing)
    return codec.eval()


@functools.lru_cache(maxsize=None)
def _jitted_init(model):
    """``model.init`` under jit, once per model: the params flax's op-by-op
    init gives, in about a third of the time."""
    return jax.jit(model.init)


def _stage_pair(seed=0):
    jmodel = JTCT(specs=(JSpec(CB, 2), JSpec(CB, 3)), dim=32, depth=2, heads=2, dim_head=8)
    ids = [jnp.zeros((1, 4), jnp.int32), jnp.zeros((1, 6), jnp.int32)]
    jparams = _jitted_init(jmodel)(jax.random.PRNGKey(seed), ids)
    return jmodel, jparams, port_model(jmodel, jparams)


def test_transformer_prefill_matches_jax():
    jmodel, jparams, model = _stage_pair()
    x = np.random.default_rng(0).standard_normal((2, 11, 32)).astype(np.float32)
    prefill = jax.jit(lambda p, x: jmodel.apply(
        p, x, jmodel.apply(p, 2, 16, method=_tfm_init_cache), method=_tfm_prefill))
    jh, jcache = prefill(jparams, jnp.asarray(x))
    with torch.no_grad():
        h, tcache = model.transformer.prefill(_t(x), model.transformer.init_cache(2, 16))
    _close(h, jh)
    for key in ("k", "v", "ff"):
        _close(tcache[key], jcache[key])


def test_token_conditioned_forward_matches_jax():
    """Embeddings (PAD = -1 zeroed, quantizer offsets), start tokens, the
    full causal forward and the per-quantizer logit heads."""
    jmodel, jparams, model = _stage_pair(1)
    rng = np.random.default_rng(1)
    ids = [rng.integers(0, CB, (2, 8)), rng.integers(0, CB, (2, 7))]
    ids[0][0, -2:] = -1
    jlogits = jax.jit(jmodel.apply)(jparams, [jnp.asarray(i, jnp.int32) for i in ids])
    with torch.no_grad():
        tlogits = model([_t(i) for i in ids])
    for got, want in zip(tlogits, jlogits):
        _close(got, want)


@pytest.mark.parametrize("flash_kv", ["int8", "bf16"])
@pytest.mark.parametrize("with_init", [False, True])
def test_generate_quantized_teacher_forced_logits_match_jax(flash_kv, with_init):
    """Per-step logits of the int8 serving decode under a shared teacher
    prefix; with_init continues from a given prefix as the coarse windows do."""
    jmodel, jparams, model = _stage_pair(2)
    jq = j_quantize_stage_params(jmodel, jparams)
    tq = quantize_stage_params(model)
    rng = np.random.default_rng(3)
    cond = rng.integers(0, CB, (3, 8)).astype(np.int32)
    T = 7
    teacher = rng.integers(0, CB, (3, T, 3)).astype(np.int32)
    init = teacher[:, :2] if with_init else None
    jgen = jax.jit(lambda p, q, c, i, t: j_generate_quantized(
        jmodel, p, q, [c], jax.random.PRNGKey(0), max_time_steps=T, init_pred_ids=i,
        use_pallas=False, flash_kv=flash_kv, teacher_ids=t, return_logits=True,
    ))
    jtok, jlogits = jgen(jparams, jq, jnp.asarray(cond),
                         None if init is None else jnp.asarray(init), jnp.asarray(teacher))
    tok, logits = generate_quantized(
        model, tq, [_t(cond)], torch.Generator().manual_seed(0), max_time_steps=T,
        init_pred_ids=None if init is None else _t(init), flash_kv=flash_kv,
        teacher_ids=_t(teacher), return_logits=True,
    )
    assert logits.shape == jlogits.shape == (3, T * 3 - (6 if with_init else 0), CB + 1)
    _close(logits, jlogits)
    assert tok.shape == jtok.shape


def _init_decoder(jcodec, seed):
    """Decoder and codebook params only (the port has no encoder)."""
    codes = jnp.zeros((1, 2, jcodec.num_quantizers), jnp.int32)
    init = jax.jit(lambda key, c: jcodec.init(key, c, method=JEncodec.decode))
    return init(jax.random.PRNGKey(seed), codes)


@pytest.mark.parametrize(
    "geom",
    [
        dict(sample_rate=24000, ratios=(8, 5, 4, 2), num_quantizers=8, codebook_size=CB, dimension=16, n_filters=2),
    ],
)
def test_encodec_decode_matches_jax(geom):
    jcodec = JEncodec(**geom)
    jparams = _init_decoder(jcodec, 3)
    codec = port_codec(jcodec, jparams)
    codes = np.random.default_rng(4).integers(0, CB, (2, 10, geom["num_quantizers"])).astype(np.int32)
    decode = jax.jit(lambda p, c: jcodec.apply(p, c, method=JEncodec.decode))
    decode_stem = jax.jit(lambda p, c: jcodec.apply(p, c, method=JEncodec.decode_stem))
    want = decode(jparams, jnp.asarray(codes))
    with torch.no_grad():
        got = codec.decode(_t(codes).long())
        stem = codec.decode_stem(_t(codes).long())
    assert got.shape == want.shape == (2, 10 * jcodec.hop_length)
    _close(got, want)
    _close(stem, decode_stem(jparams, jnp.asarray(codes)))


@pytest.mark.parametrize(
    "quantized,flash_kv,error",
    [
        (False, "int8", ValueError),  # the JAX package's check, kept
        (True, "nonsense", ValueError),  # an unknown mode, as the JAX package raises
    ],
)
def test_stage_rejects_modes_it_does_not_run(quantized, flash_kv, error):
    _, _, model = _stage_pair()
    with pytest.raises(error):
        Stage(model, quantized=quantized, flash_kv=flash_kv).generate(
            [torch.zeros((1, 4), dtype=torch.long)], max_time_steps=2
        )


def make_tiny_stage(factory, key, **kw):
    """open_musiclm_tpu.testing.make_tiny_stage with the init under jit
    (the same params)."""
    model = factory(dim=32, depth=1, heads=2, dim_head=8, clap_codebook_size=CB, num_clap_quantizers=N_CLAP_Q,
                    **kw)
    ids = [jnp.zeros((1, 4 * s.num_quantizers), jnp.int32) for s in model.specs]
    weights = tuple(0.0 for _ in model.specs[:-1]) + (1.0,)
    return jstages.Stage(model, _jitted_init(model)(key, ids),
                         StageLossConfig(cross_entropy_loss_weights=weights))


def jax_tiny_musiclm(quantized=True, flash_kv="int8") -> JMusicLM:
    """open_musiclm_tpu.testing.tiny_musiclm's doll-house stages and codec,
    as stages of the given decode mode (by default int8 serving), without
    its CLAP towers: both packages condition on the same CLAP tokens, and
    the towers take a minute to initialise."""
    codec = JEncodec(sample_rate=60, ratios=(2, 2), num_quantizers=4, codebook_size=CB,
                     dimension=8, n_filters=2)
    acoustic = dict(acoustic_codebook_size=CB, num_coarse_quantizers=2)
    stages = [
        make_tiny_stage(jstages.create_semantic_transformer, jax.random.PRNGKey(4),
                        semantic_codebook_size=CB),
        make_tiny_stage(jstages.create_coarse_transformer, jax.random.PRNGKey(5),
                        semantic_codebook_size=CB, **acoustic),
        make_tiny_stage(jstages.create_fine_transformer, jax.random.PRNGKey(6),
                        num_fine_quantizers=2, **acoustic),
    ]
    stages = [dataclasses.replace(st, quantized=quantized, flash_kv=flash_kv) for st in stages]
    return JMusicLM(
        clap=None, codec=codec, codec_params=_init_decoder(codec, 3),
        semantic_stage=stages[0], coarse_stage=stages[1], fine_stage=stages[2],
    )


@pytest.mark.parametrize("small_caps", [False, True])
def test_musiclm_generate_end_to_end_matches_jax(small_caps, monkeypatch):
    """The doll-house MusicLM through both packages, int8 serving stages,
    greedy sampling: two semantic windows, six coarse windows, three batched
    fine windows. ``small_caps`` also drives the chunked Encodec decode and
    the row-capped fine batches."""
    if small_caps:
        monkeypatch.setenv("OPEN_MUSICLM_MAX_DECODE_FRAMES", "20")
        monkeypatch.setenv("OPEN_MUSICLM_MAX_FINE_ROWS", "4")
        monkeypatch.setattr(tmusiclm_mod, "MAX_DECODE_FRAMES", 20)
        monkeypatch.setattr(tmusiclm_mod, "MAX_FINE_ROWS", 4)
    jm = jax_tiny_musiclm()
    tm = tmusiclm_mod.MusicLM(
        codec=port_codec(jm.codec, jm.codec_params),
        **{
            name: Stage(port_model(st.model, st.params), quantized=True, flash_kv="int8")
            for name, st in (("semantic_stage", jm.semantic_stage),
                             ("coarse_stage", jm.coarse_stage), ("fine_stage", jm.fine_stage))
        },
    )
    clap = np.random.default_rng(5).integers(0, CB, (2, 4)).astype(np.int32)
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
    assert got.shape == want.shape == (2, 45 * jm.codec.hop_length)
    _close(got, want)
