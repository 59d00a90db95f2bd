"""Port parity, reranking: the log-mel front end, HTSAT (the CLAP audio
tower, without fusion), CLAP.get_audio_embedding and
ClapQuantized.audio_embedding, and the slice as a whole,
``MusicLM.generate_top_match`` on the doll-house MusicLM, against the JAX
package on the CPU in float32, with the weights carried over by
open_musiclm_torch.convert.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_musiclm_tpu.import_torch import import_htsat
from open_musiclm_tpu.models.clap import htsat as jhtsat
from open_musiclm_tpu.models.clap import mel as jmel
from open_musiclm_tpu.models.clap.clap import CLAP as JCLAP
from open_musiclm_tpu.models.clap.clap import ClapQuantized as JClapQuantized
from open_musiclm_tpu.models.clap.clap import prepare_clap_audio as j_prepare_clap_audio
from open_musiclm_tpu.models.rvq import rvq_init as j_rvq_init
from open_musiclm_tpu.ops import audio as jaudio
from open_musiclm_tpu.testing import CB, N_CLAP_Q, TINY_AUDIO, TINY_GEN_KW, TINY_TEXT, FakeTokenizer

from open_musiclm_torch.convert import clap_audio_state_dict, clap_text_state_dict, htsat_state_dict, rvq_state
from open_musiclm_torch.models.clap import htsat, mel
from open_musiclm_torch.models.clap.clap import CLAP, ClapQuantized, prepare_clap_audio
from open_musiclm_torch.models.clap.htsat import HTSAT, HTSATConfig
from open_musiclm_torch.models.musiclm import MusicLM
from open_musiclm_torch.models.stages import Stage
from open_musiclm_torch.ops import audio

from tests.test_torch_clap import TEXT_CFG
from tests.test_torch_slice import _close, _t, jax_tiny_musiclm, port_codec, port_model
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
# sims apart where int16 samples straddle a step between the packages: a
# few steps of 3e-5 each move a tiny tower's sims by ~1e-4, so 10x room
SIM_FLIP_TOL = 1e-3
GREEDY = dict(semantic_temperature=0.0, coarse_temperature=0.0, fine_temperature=0.0)
FIELDS = [f.name for f in dataclasses.fields(HTSATConfig)]

# two blocks a stage over a 16 x 16 grid with window 4: shifted windows and
# their mask in stages 0 and 1, no shift at 4 x 4, the window shrunk to 2 at
# 2 x 2; 101 mel frames resized to 128, 24 mel bins to 32 (freq_ratio 2)
SHIFTED_AUDIO = jhtsat.HTSATConfig(
    spec_size=64, patch_size=4, patch_stride=(4, 4), embed_dim=8, depths=(2, 2, 2, 2),
    num_heads=(1, 2, 2, 4), window_size=4, num_classes=6, mel_bins=24, sample_rate=8000,
    window_size_fft=64, hop_size=40, fmin=50.0, fmax=3500.0, clip_samples=4000,
)
GEOMETRIES = {"tiny_audio": TINY_AUDIO, "shifted": SHIFTED_AUDIO}


def port_cfg(jcfg) -> HTSATConfig:
    return HTSATConfig(**{name: getattr(jcfg, name) for name in FIELDS})


def _wave(seed, *shape, scale=0.3):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def test_mel_filterbank_and_window_are_numpy_copies():
    for args in ((48000, 1024, 64, 50.0, 14000.0), (8000, 64, 24, 50.0, 3500.0)):
        np.testing.assert_array_equal(mel.mel_filterbank(*args), jmel.mel_filterbank(*args))
    np.testing.assert_array_equal(mel.hann_window(1024), jmel.hann_window(1024))
    f = np.array([0.0, 500.0, 1000.0, 7000.0])
    np.testing.assert_array_equal(mel.hz_to_mel_slaney(f), jmel.hz_to_mel_slaney(f))
    np.testing.assert_array_equal(mel.mel_to_hz_slaney(f / 100), jmel.mel_to_hz_slaney(f / 100))


@pytest.mark.parametrize("sr,n_fft,hop,n_mels,fmax,T", [(48000, 1024, 480, 64, 14000.0, 9600),
                                                        (8000, 64, 40, 8, 3500.0, 5080)])
def test_stft_and_logmel_match_jax(sr, n_fft, hop, n_mels, fmax, T):
    """The power STFT within 1e-5 x its max, the log-mel within 1e-4 dB."""
    x = _wave(0, 2, T)
    want = np.asarray(jmel.stft_power(jnp.asarray(x), n_fft, hop))
    got = mel.stft_power(_t(x), n_fft, hop)
    assert got.shape == want.shape == (2, 1 + T // hop, 1 + n_fft // 2)
    _close(got, want, atol=1e-5 * want.max(), rtol=0)
    kw = dict(sr=sr, n_fft=n_fft, hop=hop, n_mels=n_mels, fmin=50.0, fmax=fmax)
    want = np.asarray(jmel.logmel(jnp.asarray(x), **kw))
    got = mel.logmel(_t(x), **kw)
    assert got.shape == want.shape == (2, 1 + T // hop, n_mels)
    _close(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("old,new,axis", [(101, 128, 1), (1001, 1024, 1), (24, 32, 2), (7, 3, 1), (5, 5, 2)])
def test_bicubic_resize_matches_jax(old, new, axis):
    shape = [2, 6, 6]
    shape[axis] = old
    x = _wave(1, *shape, scale=3.0)
    want = np.asarray(jhtsat.bicubic_resize_axis_align_corners(jnp.asarray(x), new, axis))
    got = htsat.bicubic_resize_axis_align_corners(_t(x), new, axis)
    assert got.shape == want.shape
    _close(got, want, atol=1e-5, rtol=0)


def test_swin_geometry_helpers_are_numpy_copies():
    for wh, ww in ((4, 4), (8, 8), (2, 2)):
        np.testing.assert_array_equal(htsat.relative_position_index(wh, ww), jhtsat.relative_position_index(wh, ww))
    for args in ((16, 16, 4, 2), (8, 8, 4, 2), (64, 64, 8, 4)):
        np.testing.assert_array_equal(htsat.shifted_window_mask(*args), jhtsat.shifted_window_mask(*args))
    x = _wave(2, 2, 8, 12, 3)
    win = htsat.window_partition(_t(x), 4)
    np.testing.assert_array_equal(win.numpy(), np.asarray(jhtsat.window_partition(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(htsat.window_reverse(win, 4, 8, 12).numpy(), x)


def _perturbed_htsat_variables(jcfg, seed):
    """HTSAT flax variables with bn0's scale, bias and running statistics
    away from their init."""
    jmodel = jhtsat.HTSAT(cfg=jcfg)
    v = jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(seed), jnp.zeros((1, jcfg.clip_samples))))
    rng = np.random.default_rng(seed)
    F = jcfg.mel_bins
    v["params"]["bn0"] = {"scale": rng.uniform(0.5, 1.5, F).astype(np.float32),
                          "bias": rng.normal(0, 0.3, F).astype(np.float32)}
    v["batch_stats"]["bn0"] = {"mean": rng.normal(-20, 5, F).astype(np.float32),
                               "var": rng.uniform(20, 80, F).astype(np.float32)}
    return jmodel, v


@pytest.fixture(scope="module", params=sorted(GEOMETRIES))
def htsat_pair(request):
    jcfg = GEOMETRIES[request.param]
    jmodel, v = _perturbed_htsat_variables(jcfg, 3)
    model = HTSAT(port_cfg(jcfg))
    model.load_state_dict(htsat_state_dict(v))
    return jcfg, jmodel, v, model.eval()


def test_htsat_matches_jax(htsat_pair):
    """embedding, clipwise and framewise outputs within 1e-5 (the shifted
    geometry runs the window mask, the roll and the window shrink)."""
    jcfg, jmodel, v, model = htsat_pair
    x = _wave(4, 3, jcfg.clip_samples)
    want = jax.jit(jmodel.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        got = model(_t(x))
    assert got["embedding"].shape == (3, port_cfg(jcfg).num_features)
    for key in ("embedding", "clipwise_output", "framewise_output"):
        assert got[key].shape == want[key].shape
        _close(got[key], want[key], **TOL)


def test_htsat_shifted_geometry_runs_every_branch(htsat_pair):
    jcfg, _, _, model = htsat_pair
    blocks = [(blk.window, blk.shift, blk.resolution) for layer in model.layers for blk in layer.blocks]
    if jcfg is SHIFTED_AUDIO:
        assert blocks == [(4, 0, (16, 16)), (4, 2, (16, 16)), (4, 0, (8, 8)), (4, 2, (8, 8)),
                          (4, 0, (4, 4)), (4, 0, (4, 4)), (2, 0, (2, 2)), (2, 0, (2, 2))]
        assert model.layers[3].blocks[0].attn.relative_position_bias_table.shape == (9, 4)
    else:
        assert all(shift == 0 for _, shift, _ in blocks)


def test_htsat_state_dict_is_laion_layout(htsat_pair):
    """The port's HTSAT keys follow the laion audio_branch: its state dict
    goes through import_torch.import_htsat back to the JAX variables."""
    jcfg, _, v, model = htsat_pair
    sd = {k: v_.numpy() for k, v_ in model.state_dict().items()}
    back = import_htsat(sd, jcfg)
    for coll in ("params", "batch_stats"):
        flat = jax.tree_util.tree_leaves_with_path(v[coll])
        back_flat = dict(jax.tree_util.tree_leaves_with_path(back[coll]))
        assert len(flat) == len(back_flat)
        for path, leaf in flat:
            np.testing.assert_array_equal(np.asarray(back_flat[path]), np.asarray(leaf))


def _clap_pair(seed=1, jcfg=TINY_AUDIO, joint=16):
    """The JAX CLAP with both towers (bn0 perturbed) and the port's CLAP
    carrying its weights."""
    jmodel = JCLAP(audio_cfg=jcfg, text_cfg=TINY_TEXT, joint_embed_shape=joint)
    ids = jnp.zeros((1, 8), jnp.int32)
    v = jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(seed), jnp.zeros((1, jcfg.clip_samples)),
                                            ids, jnp.ones_like(ids)))
    _, hv = _perturbed_htsat_variables(jcfg, seed)
    v["params"]["audio_branch"]["bn0"] = hv["params"]["bn0"]
    v["batch_stats"]["audio_branch"]["bn0"] = hv["batch_stats"]["bn0"]
    model = CLAP(TEXT_CFG, joint_embed_shape=joint, audio_cfg=port_cfg(jcfg))
    # the JAX *_transform heads are 512 wide whatever the joint width (the
    # port's follow it); they are off the embedding paths
    sd = {k: v_ for k, v_ in {**clap_text_state_dict(v), **clap_audio_state_dict(v)}.items()
          if "_transform." not in k}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert not unexpected and all("_transform." in k for k in missing)
    return jmodel, v, model.eval()


@pytest.fixture(scope="module")
def clap_pair():
    return _clap_pair()


@pytest.mark.parametrize("T", [5080, 2000, 7000, 1693], ids=["clip", "repeat_pad", "crop", "odd_repeat"])
def test_audio_embedding_matches_jax(clap_pair, T):
    """CLAP.get_audio_embedding on clip-length audio and
    ClapQuantized.audio_embedding / tokenize_audio on the repeat-pad and crop
    branches: embeddings within 1e-5, unit norm, tokens equal."""
    jmodel, v, model = clap_pair
    jstate = j_rvq_init(N_CLAP_Q, CB, 16, jax.random.PRNGKey(6))
    kw = dict(num_quantizers=N_CLAP_Q, codebook_size=CB, sample_rate=TINY_AUDIO.sample_rate,
              clip_samples=TINY_AUDIO.clip_samples)
    jclap = JClapQuantized(model=jmodel, params=v, rvq=jstate, **kw)
    clap = ClapQuantized(model=model, rvq=rvq_state(jstate), **kw)
    x = _wave(T, 2, T)
    np.testing.assert_array_equal(prepare_clap_audio(_t(x), 5080).numpy(),
                                  np.asarray(j_prepare_clap_audio(jnp.asarray(x), 5080)))
    want = np.asarray(jclap.audio_embedding(jnp.asarray(x)))
    got = clap.audio_embedding(_t(x))
    assert got.shape == want.shape == (2, 16)
    _close(got, want, **TOL)
    np.testing.assert_allclose(torch.linalg.vector_norm(got, dim=-1).numpy(), 1.0, atol=1e-6)
    np.testing.assert_array_equal(clap.tokenize_audio(_t(x)).numpy(), np.asarray(jclap.tokenize_audio(jnp.asarray(x))))
    if T == 5080:
        direct = jax.jit(lambda p, w: jmodel.apply(p, w, method=JCLAP.get_audio_embedding))(v, jnp.asarray(x))
        with torch.no_grad():
            _close(model.get_audio_embedding(_t(x)), direct, **TOL)


def jax_rerank_musiclm(clap_pair, **mode):
    """jax_tiny_musiclm's stages and codec with a tiny CLAP (both towers;
    ``clap_pair``, as ``_clap_pair`` gives it), RVQ and FakeTokenizer."""
    jm = jax_tiny_musiclm(**mode)
    jmodel, v, model = clap_pair
    jstate = j_rvq_init(N_CLAP_Q, CB, 16, jax.random.PRNGKey(2))
    kw = dict(num_quantizers=N_CLAP_Q, codebook_size=CB, sample_rate=TINY_AUDIO.sample_rate,
              clip_samples=TINY_AUDIO.clip_samples)
    jm = dataclasses.replace(jm, clap=JClapQuantized(model=jmodel, params=v, rvq=jstate, **kw),
                             tokenizer=FakeTokenizer())
    tm = MusicLM(
        codec=port_codec(jm.codec, jm.codec_params), tokenizer=jm.tokenizer,
        clap=ClapQuantized(model=model, rvq=rvq_state(jstate), **kw),
        **{name: Stage(port_model(st.model, st.params), **mode)
           for name, st in (("semantic_stage", jm.semantic_stage), ("coarse_stage", jm.coarse_stage),
                            ("fine_stage", jm.fine_stage))},
    )
    return jm, tm


@pytest.fixture(scope="module")
def rerank_pair(clap_pair):
    return jax_rerank_musiclm(clap_pair, quantized=True, flash_kv="int8")


def test_generate_top_match_matches_jax(rerank_pair, monkeypatch):
    """The slice: 2 prompts x 2 greedy samples through generate, 60 Hz ->
    8 kHz, the int16 round trip and the audio tower (the crop branch): the
    samples within 1e-4 of JAX's, sims in [-1, 1], the same samples chosen.
    Greedy rows of one prompt are equal, so the order of distinct samples
    is held by test_generate_top_match_ranks_like_jax.

    The int16 round trip truncates: where the two packages' resampled waves
    (float32 rounding apart, ~1e-7) straddle an int16 step, the tower sees
    inputs one step (3e-5) apart, and the sims move by ~1e-4. So the waves
    must agree within 1e-6 before truncation and each differing int16
    sample must straddle a step; the sims are then held within 1e-5 end to
    end when no sample straddles one, and within SIM_FLIP_TOL (1e-3) when
    some do; the port's ranking on JAX's samples gives JAX's sims within
    1e-5 (the flips are counted and printed)."""
    jm, tm = rerank_pair
    kw = dict(text=["piano", "guitar"], num_samples=2, num_top_matches=2, **GREEDY, **TINY_GEN_KW)
    jax_waves = []
    jgenerate = jm.generate

    def recording(**k):
        jax_waves.append(jgenerate(**k))
        return jax_waves[-1]

    monkeypatch.setattr(jm, "generate", recording)
    want_samples, want_sims = jm.generate_top_match(key=jax.random.PRNGKey(2), **kw)
    samples, sims = tm.generate_top_match(**kw)
    assert len(samples) == len(sims) == 2
    flips, worst = 0, 0.0
    for s, w, sim, wsim, jw in zip(samples, want_samples, sims, want_sims, jax_waves):
        assert s.shape == w.shape == (2, 180) and sim.shape == (2,)
        _close(s, w)
        assert float(sim.abs().max()) <= 1.0 + 1e-6
        got_in = audio.resample(s, 60, TINY_AUDIO.sample_rate)
        want_in = np.asarray(jaudio.resample(jnp.asarray(jw), 60, TINY_AUDIO.sample_rate))
        _close(got_in, want_in, atol=1e-6, rtol=0)
        differ = audio.int16_round_trip(got_in).numpy() != np.asarray(jaudio.int16_round_trip(jnp.asarray(want_in)))
        steps = np.trunc(np.clip(got_in.numpy(), -1, 1) * 32767) != np.trunc(np.clip(want_in, -1, 1) * 32767)
        np.testing.assert_array_equal(differ, steps)
        flips += int(differ.sum())
        worst = max(worst, float(np.abs(sim.numpy() - np.asarray(wsim)).max()))
        _close(sim, wsim, **(TOL if not differ.any() else dict(atol=SIM_FLIP_TOL, rtol=0)))
    print(f"int16 samples straddling a step between the packages: {flips}; sims at most {worst:.2e} apart")
    # the port's ranking of JAX's own samples
    monkeypatch.setattr(tm, "generate", lambda **k: _t(jax_waves.pop(0)))
    _, sims = tm.generate_top_match(**kw)
    for sim, wsim in zip(sims, want_sims):
        _close(sim, wsim, **TOL)


def test_generate_top_match_ranks_like_jax(rerank_pair, monkeypatch):
    """Distinct samples (the same 4 waves given to both packages' generate):
    sims within 1e-5 and the same order; then audio embeddings with an
    exact tie (rows 1 and 3 equal): the tie goes to the lower index, as
    jnp.argsort(-sim) breaks it."""
    jm, tm = rerank_pair
    rng = np.random.default_rng(11)
    waves = (0.3 * rng.standard_normal((2, 4, 180))).astype(np.float32)
    calls = {"jax": 0, "torch": 0}

    def fake(name, to):
        def generate(**kw):
            i = calls[name] % 2
            calls[name] += 1
            assert kw["clap_token_ids"].shape[0] == 4
            return to(waves[i])
        return generate

    monkeypatch.setattr(jm, "generate", fake("jax", jnp.asarray))
    monkeypatch.setattr(tm, "generate", fake("torch", _t))
    kw = dict(text=["a", "b"], num_samples=4, num_top_matches=4)
    want_samples, want_sims = jm.generate_top_match(key=jax.random.PRNGKey(0), **kw)
    samples, sims = tm.generate_top_match(**kw)
    for i in range(2):
        _close(sims[i], want_sims[i], **TOL)
        assert len(set(np.round(np.asarray(want_sims[i]), 4))) == 4  # four distinct ranks
        np.testing.assert_array_equal(samples[i].numpy(), np.asarray(want_samples[i]))

    latents = rng.standard_normal((4, 16)).astype(np.float32)
    latents[3] = latents[1]
    monkeypatch.setattr(jm.clap, "audio_embedding", lambda w: jnp.asarray(latents))
    monkeypatch.setattr(tm.clap, "audio_embedding", lambda w: _t(latents))
    want_samples, want_sims = jm.generate_top_match(key=jax.random.PRNGKey(0), **kw)
    samples, sims = tm.generate_top_match(**kw)
    for i in range(2):
        _close(sims[i], want_sims[i], **TOL)
        np.testing.assert_array_equal(samples[i].numpy(), np.asarray(want_samples[i]))
        chosen = [int(np.nonzero((waves[i] == s).all(-1))[0][0]) for s in samples[i].numpy()]
        assert sorted(chosen) == [0, 1, 2, 3] and chosen.index(1) == chosen.index(3) - 1
    with pytest.raises(ValueError, match="per_row_keys"):
        tm.generate_top_match(text=["a", "b"], num_samples=4, per_row_keys=torch.zeros(4, dtype=torch.long))


def test_generate_top_match_passes_each_prompts_row_keys(rerank_pair, monkeypatch):
    """per_row_keys holds len(text) x num_samples keys: prompt i's generate
    gets rows i * num_samples on, and its CLAP tokens repeated per sample."""
    _, tm = rerank_pair
    seen = []

    def generate(**kw):
        seen.append((kw["per_row_keys"].tolist(), kw["clap_token_ids"]))
        return torch.zeros(3, 180)

    monkeypatch.setattr(tm, "generate", generate)
    keys = torch.arange(6, dtype=torch.long) * 11
    samples, sims = tm.generate_top_match(text=["a", "b"], num_samples=3, per_row_keys=keys)
    assert [k for k, _ in seen] == [[0, 11, 22], [33, 44, 55]]
    for _, clap in seen:
        assert clap.shape == (3, N_CLAP_Q, 1) and bool((clap == clap[:1]).all())
    assert [tuple(x.shape) for x in samples] == [(1, 180)] * 2 and [tuple(x.shape) for x in sims] == [(1,)] * 2
