"""Port parity, audio prompts: resampling and prompt preparation, k-means,
HuBERT (HubertWithKmeans), the Encodec encoder, and the slice as a whole,
``MusicLM.generate(prime_wave=...)`` on the doll-house MusicLM, against the
JAX package on the CPU in float32, with the weights carried over by
open_musiclm_torch.convert.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_musiclm_tpu.import_torch import import_hubert
from open_musiclm_tpu.models.encodec import EncodecModel as JEncodec
from open_musiclm_tpu.models.hubert import HubertConfig as JHubertConfig
from open_musiclm_tpu.models.hubert import HubertModel as JHubert
from open_musiclm_tpu.models.hubert import HubertWithKmeans as JHubertWithKmeans
from open_musiclm_tpu.models.kmeans import kmeans_predict as j_kmeans_predict
from open_musiclm_tpu.ops import audio as jaudio
from open_musiclm_tpu.testing import CB, TINY_GEN_KW

from open_musiclm_torch.convert import codec_state_dict, hubert_state_dict, kmeans_centroids
from open_musiclm_torch.models.encodec import EncodecModel
from open_musiclm_torch.models.hubert import HubertConfig, HubertModel, HubertWithKmeans
from open_musiclm_torch.models.kmeans import kmeans_predict
from open_musiclm_torch.models.musiclm import MusicLM
from open_musiclm_torch.models.stages import Stage
from open_musiclm_torch.ops import audio

from tests.test_torch_slice import _close, _t, jax_tiny_musiclm, port_model
from tests.torch_threads import one_torch_thread  # noqa: F401

GREEDY = dict(semantic_temperature=0.0, coarse_temperature=0.0, fine_temperature=0.0)

# the doll-house HuBERT of tests/test_musiclm.py: 16x downsample, 10 Hz
# tokens at 160 Hz
TINY_HUBERT = dict(
    conv_dim=(16,) * 7, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
    intermediate_size=64, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
    conv_kernel=(4, 3, 2, 2, 1, 1, 1), conv_stride=(2, 2, 2, 2, 1, 1, 1),
)


def _wave(seed, *shape, scale=0.3):
    """Sines plus noise, float32."""
    rng = np.random.default_rng(seed)
    n = shape[-1]
    t = np.arange(n) / n
    tone = sum(np.sin(2 * np.pi * f * t + p) for f, p in zip(rng.uniform(3, 40, 3), rng.uniform(0, 6, 3)))
    return (scale * (tone / 3 + 0.3 * rng.standard_normal(shape))).astype(np.float32)


@pytest.mark.parametrize("orig,new,n", [(48000, 16000, 4800), (24000, 16000, 2400), (24000, 48000, 2400),
                                        (48000, 24000, 4801), (160, 60, 320), (60, 8000, 240),
                                        (160, 160, 50)])
def test_resample_matches_jax(orig, new, n):
    """[3, n] rows (and a [2, 1, n] batch) within 1e-6 absolute, length
    ceil(n * new / orig)."""
    x = _wave(orig + new, 3, n)
    want = np.asarray(jaudio.resample(jnp.asarray(x), orig, new))
    got = audio.resample(_t(x), orig, new)
    assert got.shape == want.shape == (3, -(-n * new // orig))
    _close(got, want, atol=1e-6, rtol=0)
    _close(audio.resample(_t(x[:2, None]), orig, new), want[:2, None], atol=1e-6, rtol=0)


def test_resample_kernel_is_numpy_copy():
    for rates in ((3, 1), (1, 2), (8, 3), (1, 200)):
        want, wwidth = jaudio._resample_kernel(*rates)
        got, width = audio._resample_kernel(*rates)
        assert width == wwidth
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("shape,seconds", [((2, 960), None), ((1, 960), 2.5), ((2, 960), 2.5), ((960,), None)])
def test_prepare_audio_matches_jax(shape, seconds, normalize):
    """A [2, T] input is one stereo clip (mixed to mono); crop, normalize on
    and off, 320 Hz -> 120 Hz; the int16 round trip within one int16 step."""
    x = _wave(len(shape) + int(normalize), *shape)
    kw = dict(normalize=normalize, target_length_seconds=seconds)
    want = np.asarray(jaudio.prepare_audio(jnp.asarray(x), 320, 120, **kw))
    got = audio.prepare_audio(_t(x), 320, 120, **kw)
    assert got.shape == want.shape
    assert got.dtype == torch.float32
    _close(got, want, atol=1.01 / 32767, rtol=0)
    # off the rounding boundaries the int16 values are equal
    assert (np.abs(got.numpy() - want) < 1e-7).mean() > 0.99


def test_zero_mean_unit_var_and_int16_match_jax():
    x = _wave(9, 4, 333) * 5
    _close(audio.zero_mean_unit_var_norm(_t(x)), jaudio.zero_mean_unit_var_norm(jnp.asarray(x)),
           atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(audio.int16_round_trip(_t(x)).numpy(),
                                  np.asarray(jaudio.int16_round_trip(jnp.asarray(x))))


def test_kmeans_predict_matches_jax():
    """Index-equal on random rows, and a planted tie goes to the lower index."""
    rng = np.random.default_rng(0)
    cents = rng.standard_normal((64, 24)).astype(np.float32)
    x = rng.standard_normal((5, 40, 24)).astype(np.float32)
    want = np.asarray(j_kmeans_predict(jnp.asarray(x), jnp.asarray(cents)))
    got = kmeans_predict(_t(x), _t(cents))
    assert got.shape == (5, 40) and got.dtype == torch.long
    np.testing.assert_array_equal(got.numpy(), want)
    tie = np.array([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0], [-1.0, 0.0]], np.float32)
    row = np.array([[0.5, 0.5], [2.0, 0.0]], np.float32)  # equidistant from 0 and 1; then 0 and 2
    want = np.asarray(j_kmeans_predict(jnp.asarray(row), jnp.asarray(tie)))
    assert kmeans_predict(_t(row), _t(tie)).tolist() == want.tolist() == [0, 0]


def _hubert_pair(seed=0, **over):
    geom = {**TINY_HUBERT, **over}
    jmodel = JHubert(cfg=JHubertConfig(**geom))
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(seed), jnp.zeros((1, 64)))
    model = HubertModel(HubertConfig(**geom))
    model.load_state_dict(hubert_state_dict(jax.device_get(jparams)))
    return jmodel, jparams, model.eval()


@pytest.mark.parametrize("over", [{}, dict(feat_extract_norm="layer", conv_bias=True),
                                  dict(num_conv_pos_embeddings=15)], ids=["group", "layer", "odd_pos_conv"])
def test_hubert_hidden_states_match_jax(over):
    """Every hidden state (HF indexing) within 1e-5 x max|h|, the group
    norm and layer norm feature extractors, even and odd positional convs."""
    jmodel, jparams, model = _hubert_pair(1, **over)
    x = _wave(2, 2, 1000)
    _, want = jax.jit(jmodel.apply)(jparams, jnp.asarray(x))
    with torch.no_grad():
        got = model(_t(x))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape == (2, 62, 32)
        _close(g, w, atol=1e-5 * np.abs(w).max(), rtol=0)
    with torch.no_grad():
        _close(model.extract_features(_t(x), 1), want[1], atol=1e-5 * np.abs(want[1]).max(), rtol=0)


def test_hubert_state_dict_is_hf_layout():
    """The port's keys follow HF HubertModel: its state dict, with the
    positional conv as weight_g (the per-tap norm) and weight_v (the folded
    weight), goes through import_torch.import_hubert back to the JAX params."""
    for over in ({}, dict(feat_extract_norm="layer", conv_bias=True)):
        _, jparams, model = _hubert_pair(2, **over)
        sd = {k: v.numpy() for k, v in model.state_dict().items()}
        w = sd.pop("encoder.pos_conv_embed.conv.weight")
        sd["encoder.pos_conv_embed.conv.weight_g"] = np.sqrt((w ** 2).sum(axis=(0, 1), keepdims=True))
        sd["encoder.pos_conv_embed.conv.weight_v"] = w
        back = import_hubert(sd, JHubertConfig(**{**TINY_HUBERT, **over}))["params"]
        flat = jax.tree_util.tree_leaves_with_path(jax.device_get(jparams)["params"])
        back_flat = dict(jax.tree_util.tree_leaves_with_path(back))
        assert len(flat) == len(back_flat)
        for path, leaf in flat:
            np.testing.assert_allclose(np.asarray(back_flat[path]), np.asarray(leaf), atol=1e-7, rtol=1e-6)


def _wav2vec_pair(seed=0):
    jmodel, jparams, model = _hubert_pair(seed)
    cents = np.asarray(jax.random.normal(jax.random.PRNGKey(seed + 1), (CB, 32)))
    kw = dict(embed_layer=1, target_sample_hz=160, seq_len_multiple_of=16, output_hz=10)
    jw = JHubertWithKmeans(jmodel, jparams, jnp.asarray(cents), **kw)
    return jw, HubertWithKmeans(model, kmeans_centroids(cents), **kw).eval()


def test_hubert_with_kmeans_matches_jax():
    """Trim to a multiple of 16, tap layer 1, normalize, k-means: the
    features within 1e-5 and the ids equal."""
    jw, tw = _wav2vec_pair(3)
    x = _wave(4, 3, 700)
    want = np.asarray(jw(jnp.asarray(x)))
    got = tw(_t(x))
    assert got.shape == want.shape == (3, 42) and got.dtype == torch.long
    np.testing.assert_array_equal(got.numpy(), want)
    _close(tw.features(_t(x)), jw.features(jnp.asarray(x)), atol=1e-5, rtol=1e-5)
    assert tw.codebook_size == CB


def _codec_pair(seed=3, **geom):
    geom = dict(sample_rate=60, ratios=(2, 2), num_quantizers=4, codebook_size=CB, dimension=8,
                n_filters=2, **geom) if not geom else geom
    jcodec = JEncodec(**geom)
    jparams = jax.jit(jcodec.init)(jax.random.PRNGKey(seed), jnp.zeros((1, 240)))
    codec = EncodecModel(**{k: getattr(jcodec, k) for k in (
        "sample_rate", "num_quantizers", "codebook_size", "dimension", "n_filters", "ratios")})
    codec.load_state_dict(codec_state_dict(jax.device_get(jparams), len(jcodec.ratios)))
    return jcodec, jparams, codec.eval()


@pytest.mark.parametrize("geom", [
    {},
    dict(sample_rate=24000, ratios=(8, 5, 4, 2), num_quantizers=8, codebook_size=CB, dimension=16, n_filters=2),
], ids=["doll_house", "hop_320"])
def test_encodec_encode_matches_jax(geom):
    """embed within 1e-5 x max|z|; quantize_embedding and encode codes
    equal; encode then decode has JAX's shapes and values."""
    jcodec, jparams, codec = _codec_pair(**geom)
    hop = jcodec.hop_length
    x = _wave(5, 2, 23 * hop + 3)  # a partial last frame
    want_z = np.asarray(jax.jit(lambda p, w: jcodec.apply(p, w, method=JEncodec.embed))(jparams, jnp.asarray(x)))
    with torch.no_grad():
        z = codec.embed(_t(x))
        assert z.shape == want_z.shape == (2, 24, jcodec.dimension)
        _close(z, want_z, atol=1e-5 * np.abs(want_z).max(), rtol=0)
        want_codes = np.asarray(jcodec.apply(jparams, jnp.asarray(want_z), method=JEncodec.quantize_embedding))
        np.testing.assert_array_equal(codec.quantize_embedding(_t(want_z)).numpy(), want_codes)
        codes = codec.encode(_t(x))
        np.testing.assert_array_equal(codes.numpy(), want_codes)
        wave = codec.decode(codes)
    want_wave = jcodec.apply(jparams, jnp.asarray(want_codes), method=JEncodec.decode)
    assert wave.shape == want_wave.shape == (2, 24 * hop)
    _close(wave, want_wave)


def jax_prime_musiclm(**mode):
    """jax_tiny_musiclm's stages with a codec that has its encoder (params
    from an init through the encode + decode round trip) and the doll-house
    HubertWithKmeans of tests/test_musiclm.py."""
    jm = jax_tiny_musiclm(**mode)
    jw, _ = _wav2vec_pair(0)
    return dataclasses.replace(jm, codec_params=jax.jit(jm.codec.init)(jax.random.PRNGKey(3), jnp.zeros((1, 240))),
                               wav2vec=jw)


def port_prime_musiclm(jm, **mode) -> MusicLM:
    codec = EncodecModel(sample_rate=60, ratios=(2, 2), num_quantizers=4, codebook_size=CB, dimension=8, n_filters=2)
    codec.load_state_dict(codec_state_dict(jax.device_get(jm.codec_params), 2))
    jw = jm.wav2vec
    model = HubertModel(HubertConfig(**TINY_HUBERT))
    model.load_state_dict(hubert_state_dict(jax.device_get(jw.params)))
    wav2vec = HubertWithKmeans(model, kmeans_centroids(jw.centroids), embed_layer=jw.embed_layer,
                               target_sample_hz=jw.target_sample_hz, seq_len_multiple_of=jw.seq_len_multiple_of,
                               output_hz=jw.output_hz)
    return MusicLM(
        codec=codec.eval(), wav2vec=wav2vec.eval(),
        **{name: Stage(port_model(st.model, st.params), **mode)
           for name, st in (("semantic_stage", jm.semantic_stage), ("coarse_stage", jm.coarse_stage),
                            ("fine_stage", jm.fine_stage))},
    )


@pytest.fixture(scope="module")
def prime_pair():
    mode = dict(quantized=True, flash_kv="int8")
    jm = jax_prime_musiclm(**mode)
    return jm, port_prime_musiclm(jm, **mode)


def _capture(model, store):
    decode = model._decode

    def wrapped(*args):
        store.append(np.asarray(args[-1]))
        return decode(*args)

    model._decode = wrapped


@pytest.mark.parametrize("stereo", [False, True])
def test_prime_wave_continuation_matches_jax(prime_pair, stereo):
    """The slice: a 2 s prime at 160 Hz (HuBERT at 160 Hz, Encodec at 60 Hz)
    continued greedily through the int8 serving stages: the codes equal
    JAX's, the prime's 30 frames first, and the wave within 1e-4. A [2, T]
    prime is one stereo clip."""
    jm, tm = prime_pair
    prime = _wave(6, 2 if stereo else 1, 320)
    clap = np.random.default_rng(7).integers(0, CB, (1, 4)).astype(np.int32)
    codes_j, codes_t = [], []
    _capture(jm, codes_j)
    _capture(tm, codes_t)
    try:
        want = jm.generate(key=jax.random.PRNGKey(0), clap_token_ids=jnp.asarray(clap), prime_wave=jnp.asarray(prime),
                           prime_wave_sample_hz=160, **GREEDY, **TINY_GEN_KW)
        got = tm.generate(clap_token_ids=_t(clap), prime_wave=_t(prime), prime_wave_sample_hz=160,
                          **GREEDY, **TINY_GEN_KW)
    finally:
        del jm._decode, tm._decode
    assert codes_t[0].shape == codes_j[0].shape == (1, 60, 4)
    np.testing.assert_array_equal(codes_t[0], codes_j[0])
    wav_enc = jaudio.prepare_audio(jnp.asarray(prime), 160, 60, normalize=False, target_length_seconds=2)
    prime_codes = np.asarray(jm._encode(jm.codec_params, wav_enc))
    np.testing.assert_array_equal(codes_t[0][:, :30], prime_codes)
    assert got.shape == want.shape == (1, 60 * 4)
    _close(got, want)


def test_prime_wave_coarse_only_matches_jax(prime_pair):
    """return_coarse_generated_wave: the coarse windows decoded alone,
    untrimmed, equal to JAX's."""
    jm, tm = prime_pair
    prime = _wave(8, 1, 320)
    clap = np.random.default_rng(9).integers(0, CB, (1, 4)).astype(np.int32)
    codes_j, codes_t = [], []
    _capture(jm, codes_j)
    _capture(tm, codes_t)
    try:
        want = jm.generate(key=jax.random.PRNGKey(0), clap_token_ids=jnp.asarray(clap), prime_wave=jnp.asarray(prime),
                           prime_wave_sample_hz=160, return_coarse_generated_wave=True, **GREEDY, **TINY_GEN_KW)
        got = tm.generate(clap_token_ids=_t(clap), prime_wave=_t(prime), prime_wave_sample_hz=160,
                          return_coarse_generated_wave=True, **GREEDY, **TINY_GEN_KW)
    finally:
        del jm._decode, tm._decode
    assert codes_t[0].shape == codes_j[0].shape == (1, 47, 2)
    np.testing.assert_array_equal(codes_t[0], codes_j[0])
    assert got.shape == want.shape == (1, 47 * 4)
    _close(got, want)


def test_prime_wave_needs_one_prompt_row(prime_pair):
    """One prime continues one prompt row: a 2-row prompt batch raises (the
    JAX package would split the prime's tokens across the rows), and so
    does a prime without its rate or a MusicLM without wav2vec."""
    _, tm = prime_pair
    clap = torch.zeros((2, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="one prime"):
        tm.generate(clap_token_ids=clap, prime_wave=_t(_wave(0, 1, 320)), prime_wave_sample_hz=160, **TINY_GEN_KW)
    with pytest.raises(ValueError, match="one prime"):
        tm.generate(clap_token_ids=clap, prime_wave=_t(_wave(0, 2, 320)), prime_wave_sample_hz=160, **TINY_GEN_KW)
    with pytest.raises(ValueError, match="prime_wave_sample_hz"):
        tm.generate(clap_token_ids=clap[:1], prime_wave=_t(_wave(0, 1, 320)), **TINY_GEN_KW)
    with pytest.raises(ValueError, match="wav2vec"):
        dataclasses.replace(tm, wav2vec=None).generate(
            clap_token_ids=clap[:1], prime_wave=_t(_wave(0, 1, 320)), prime_wave_sample_hz=160, **TINY_GEN_KW)


def test_build_hubert(monkeypatch):
    """build_hubert: the configured k-means codebook (1024 x 768, seeded)
    and hubert_kmeans_cfg's fields; the card by default, refused without one."""
    import inspect

    from open_musiclm_torch import config as tconfig

    mc = tconfig.load_model_config(str(Path(__file__).resolve().parents[1] / "configs/model/musiclm_small.json"))
    monkeypatch.setattr(tconfig, "HubertConfig", lambda: HubertConfig(**{**TINY_HUBERT, "hidden_size": 768}))
    w2v = tconfig.build_hubert(mc, torch.Generator().manual_seed(0), device="cpu")
    again = tconfig.build_hubert(mc, torch.Generator().manual_seed(0), device="cpu")
    hk = mc.hubert_kmeans_cfg
    assert w2v.centroids.shape == (hk.codebook_size, 768) and not w2v.training
    assert (w2v.embed_layer, w2v.target_sample_hz, w2v.seq_len_multiple_of, w2v.output_hz) == (7, 16000, 320, 50)
    torch.testing.assert_close(w2v.centroids, again.centroids, atol=0, rtol=0)
    for a, b in zip(w2v.state_dict().values(), again.state_dict().values()):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert inspect.signature(tconfig.build_hubert).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tconfig.build_hubert(mc)


def test_build_encodec_has_encoder(monkeypatch):
    """build_encodec draws the encoder after the decoder and the codebooks:
    those keep the draws they had without it."""
    import inspect

    from open_musiclm_torch import config as tconfig
    from open_musiclm_torch.models import encodec as tencodec

    mc = tconfig.load_model_config(str(Path(__file__).resolve().parents[1] / "configs/model/musiclm_small.json"))
    codec = tconfig.build_encodec(mc, torch.Generator().manual_seed(4), device="cpu")
    monkeypatch.setattr(tencodec, "SEANetEncoder", lambda *a, **k: torch.nn.Identity())
    without = tconfig.build_encodec(mc, torch.Generator().manual_seed(4), device="cpu")
    for key, value in without.state_dict().items():
        torch.testing.assert_close(codec.state_dict()[key], value, atol=0, rtol=0)
    assert any(k.startswith("encoder.lstm.") for k in codec.state_dict())
    with torch.no_grad():
        codes = codec.encode(torch.zeros(1, 3200))
    assert codes.shape == (1, 10, 8)
    assert inspect.signature(tconfig.build_encodec).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tconfig.build_encodec(mc)


def test_audio_path_imports_no_jax():
    """The audio prompt and reranking modules import with jax, flax and the
    JAX package blocked."""
    blocked = ("jax", "jaxlib", "flax", "optax", "orbax", "open_musiclm_tpu")
    code = (
        "import sys\n"
        f"for name in {blocked!r}: sys.modules[name] = None\n"
        "import open_musiclm_torch.ops.audio, open_musiclm_torch.models.hubert, open_musiclm_torch.models.kmeans\n"
        "import open_musiclm_torch.models.clap.mel, open_musiclm_torch.models.clap.htsat\n"
        "import open_musiclm_torch.models.clap.model_configs, open_musiclm_torch.models.musiclm\n"
        "import open_musiclm_torch.config, open_musiclm_torch.convert\n"
        f"assert not any(sys.modules.get(n) for n in {blocked!r})\n"
    )
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
