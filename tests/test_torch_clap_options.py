"""Port parity, the CLAP options no shipped config sets and the profiling
hooks: every CLAP preset by name, PANN (Cnn14 / Cnn10 / Cnn6, eval and
training forwards) and a PANN CLAP, import_pann, the CLIP text tower and
its tokenizer, ClapModule, the Wav2Vec / NeuralCodec protocols, StepTimer,
trace / annotate / device_memory_stats, and the small public helpers,
against the JAX package on the CPU in float32, with the weights carried over
by open_musiclm_torch.convert.
"""

import dataclasses
import gzip
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_musiclm_tpu import import_torch as jit_
from open_musiclm_tpu import model_types as jmodel_types
from open_musiclm_tpu import profiling as jprofiling
from open_musiclm_tpu.core import sampling as jsampling
from open_musiclm_tpu.data import audio_io as jaudio_io
from open_musiclm_tpu.models import musiclm as jmusiclm
from open_musiclm_tpu.models.clap import model_configs as jmc
from open_musiclm_tpu.models.clap.clap import CLAP as JCLAP
from open_musiclm_tpu.models.clap.clip_text import ClipTextConfig as JClipTextConfig
from open_musiclm_tpu.models.clap.clip_text import ClipTextTransformer as JClipTextTransformer
from open_musiclm_tpu.models.clap.clip_tokenizer import ClipTokenizer as JClipTokenizer
from open_musiclm_tpu.models.clap.hook import ClapModule as JClapModule
from open_musiclm_tpu.models.clap.pann import PANN as JPANN
from open_musiclm_tpu.models.encodec import EncodecModel as JEncodec
from open_musiclm_tpu.models.hubert import HubertWithKmeans as JHubertWithKmeans
from open_musiclm_tpu.testing import TINY_AUDIO, TINY_TEXT

from open_musiclm_torch import convert, model_types, profiling
from open_musiclm_torch import import_torch as it
from open_musiclm_torch.core import sampling
from open_musiclm_torch.data import audio_io
from open_musiclm_torch.models import musiclm
from open_musiclm_torch.models.clap import model_configs
from open_musiclm_torch.models.clap.clap import CLAP
from open_musiclm_torch.models.clap.clip_text import ClipTextConfig, ClipTextTransformer
from open_musiclm_torch.models.clap.clip_tokenizer import ClipTokenizer
from open_musiclm_torch.models.clap.hook import ClapModule
from open_musiclm_torch.models.clap.pann import PANN
from open_musiclm_torch.models.encodec import EncodecModel
from open_musiclm_torch.models.hubert import HubertConfig, HubertModel, HubertWithKmeans

from tests.test_torch_clap import TEXT_CFG
from tests.test_torch_htsat import port_cfg
from tests.test_torch_slice import _close, _t
from tests.torch_threads import one_torch_thread  # noqa: F401

PRESETS = jmc.list_audio_presets()


def _same_config(got, want) -> bool:
    """The port's dataclass against JAX's config (a dataclass, or HTSATConfig's
    plain object that also stores freq_ratio and num_features)."""
    fields = dataclasses.asdict(got)
    if hasattr(got, "num_features"):
        fields.update(freq_ratio=got.freq_ratio, num_features=got.num_features)
    return type(got).__name__ == type(want).__name__ and fields == (
        dataclasses.asdict(want) if dataclasses.is_dataclass(want) else dict(vars(want)))


@pytest.mark.parametrize("name", PRESETS)
def test_presets_match_jax(name):
    """Each preset resolved field by field as JAX resolves it: the audio
    tower (with and without fusion for HTSAT), the CLIP text tower and the
    joint width."""
    assert model_configs.list_audio_presets() == PRESETS
    for kw in ({}, {"enable_fusion": True, "fusion_type": "iaff_2d"}):
        got, want = model_configs.audio_config_from_name(name, **kw), jmc.audio_config_from_name(name, **kw)
        assert _same_config(got, want)
        full, jfull = model_configs.clap_config_from_name(name, **kw), jmc.clap_config_from_name(name, **kw)
        assert full.name == name and full.embed_dim == jfull.embed_dim
        assert _same_config(full.audio_cfg, jfull.audio_cfg)
        assert dataclasses.asdict(full.text_cfg) == dataclasses.asdict(jfull.text_cfg)
    with pytest.raises(KeyError):
        model_configs.audio_config_from_name(name + "-nonsense")


def _variables(init, *args, seed):
    """Flax variables drawn with numpy in the shapes ``init(key, *args)``
    gives (traced, not run): kernels uniform of variance 1 / fan-in, scales
    and variances in [0.5, 1.5], every other leaf N(0, 0.1^2), so BatchNorm
    statistics and biases are away from their init."""
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":  # uniform, of variance 1 / fan-in
            bound = np.float32(np.sqrt(3.0 / np.prod(s.shape[:-1])))
            k = rng.random(s.shape, np.float32)
            k *= 2 * bound
            k -= bound
            return k
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _loaded(make, state_dict) -> torch.nn.Module:
    """The port's module built without drawing its weights (a PANN's
    seeded draw of up to 80M values is slower than the test) and given
    ``state_dict`` (every entry it holds)."""
    with torch.device("meta"):
        model = make()
    model.load_state_dict(state_dict, assign=True)
    return model


@pytest.mark.parametrize("arch", ["Cnn14", "Cnn10", "Cnn6"])
def test_pann_matches_jax(arch):
    """b2 x 0.5 s at the presets' 48 kHz geometry: the eval forward's
    embedding and clipwise output within 1e-4 x max|x|; one training
    forward's updated running statistics (the biased batch variance) within
    1e-5 x max|x| of flax's mutable=["batch_stats"], and its outputs within
    2e-5 x max|x|: Cnn14's last block normalizes over 4 values a channel, and
    flax's variance, E[x^2] - E[x]^2, is itself 0.8e-5 x max from a float64
    forward there (the port's 0.3e-5)."""
    cfg = dataclasses.replace(model_configs.audio_config_from_name({"Cnn14": "PANN-14", "Cnn10": "PANN-10",
                                                                     "Cnn6": "PANN-6"}[arch]), num_classes=16)
    jmodel = JPANN(**{k: v for k, v in dataclasses.asdict(cfg).items() if k not in (
        "clip_samples", "enable_fusion", "fusion_type")})
    x = (0.3 * np.random.default_rng(1).standard_normal((2, 24000))).astype(np.float32)
    v = _variables(jmodel.init, jnp.asarray(x), seed=2)
    model = _loaded(lambda: PANN(cfg), convert.pann_state_dict(v))
    assert model.embed_dim == jmodel.embed_dim and model.channels == jmodel.channels
    want, (train_want, stats) = jax.jit(lambda v, x: (jmodel.apply(v, x), jmodel.apply(
        v, x, train=True, mutable=["batch_stats"])))(v, jnp.asarray(x))
    before = {k: t.clone() for k, t in model.state_dict().items() if "running_" in k}
    with torch.no_grad():
        got = model.eval()(_t(x))
        train_got = model(_t(x), train=True)
    for key in ("embedding", "clipwise_output"):
        w, tw = np.asarray(want[key]), np.asarray(train_want[key])
        assert got[key].shape == train_got[key].shape == w.shape
        _close(got[key], w, atol=1e-4 * np.abs(w).max(), rtol=0)
        _close(train_got[key], tw, atol=2e-5 * np.abs(tw).max(), rtol=0)
    sd = model.state_dict()
    for path, w in jax.tree_util.tree_leaves_with_path(jax.device_get(stats["batch_stats"])):
        key = ".".join(p.key for p in path[:-1]) + {"mean": ".running_mean", "var": ".running_var"}[path[-1].key]
        _close(sd[key], w, atol=1e-5 * np.abs(w).max(), rtol=0)
        assert not torch.equal(sd[key], before[key]), key
    assert len(before) == len(jax.tree_util.tree_leaves(stats["batch_stats"]))


def test_pann_clap_audio_embedding_matches_jax():
    """A PANN-6 CLAP (0.5 s clips): CLAP.get_audio_embedding within 1e-5
    and of unit norm; the joint projection takes PANN's 512 wide embedding."""
    cfg = dataclasses.replace(model_configs.audio_config_from_name("PANN-6"), clip_samples=24000)
    jcfg = dataclasses.replace(jmc.audio_config_from_name("PANN-6"), clip_samples=24000)
    jmodel = JCLAP(audio_cfg=jcfg, joint_embed_shape=16)
    x = (0.3 * np.random.default_rng(3).standard_normal((2, 24000))).astype(np.float32)
    v = _variables(lambda k, w: jmodel.init(k, w, method=JCLAP.get_audio_embedding), jnp.asarray(x), seed=4)
    model = CLAP(TEXT_CFG, joint_embed_shape=16, audio_cfg=cfg)
    assert model.audio_projection[0].in_features == 512
    missing, unexpected = model.load_state_dict(convert.clap_audio_state_dict(v), strict=False)
    assert not unexpected and all(k.startswith(("text_", "logit_scale_t", "audio_transform")) for k in missing)
    want = jax.jit(lambda v, w: jmodel.apply(v, w, method=JCLAP.get_audio_embedding))(v, jnp.asarray(x))
    with torch.no_grad():
        got = model.eval().get_audio_embedding(_t(x))
    _close(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(torch.linalg.vector_norm(got, dim=-1).numpy(), 1.0, atol=1e-6)


def _laion_pann_sd(arch: str, seed: int) -> dict:
    """A laion pann_model.py state dict of ``arch`` with seeded values."""
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in PANN(model_configs.PANNConfig(arch=arch)).state_dict().items()
                  if not k.endswith("num_batches_tracked")}
    rng = np.random.default_rng(seed)
    return {k: rng.random(s, np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("arch", ["Cnn10", "Cnn6"])
def test_import_pann_round_trip(arch):
    """import_pann keeps laion's keys: a synthetic laion-layout state dict
    loads strictly into the port's PANN and comes back unchanged, and equals
    the JAX importer's variables passed through convert.pann_state_dict."""
    sd = _laion_pann_sd(arch, 5)
    cfg = model_configs.PANNConfig(arch=arch)
    got = it.import_pann(sd, cfg)
    model = _loaded(lambda: PANN(cfg), got)
    for k, v in sd.items():
        np.testing.assert_array_equal(model.state_dict()[k].numpy(), v)
    via_jax = convert.pann_state_dict(jit_.import_pann(sd, JPANN(arch=arch)))
    assert sorted(via_jax) == sorted(got)
    for k in got:
        assert torch.equal(got[k], via_jax[k]), k


CLIP_CFG = dict(context_length=16, vocab_size=64, width=32, heads=2, layers=2)


@pytest.mark.parametrize("quick", [False, True], ids=["gelu", "quick_gelu"])
def test_clip_text_matches_jax(quick):
    """ClipTextTransformer within 1e-5 of JAX's (the feature at each row's
    first highest id, a tie included; rows shorter than the context)."""
    jmodel = JClipTextTransformer(JClipTextConfig(**CLIP_CFG, quick_gelu=quick), joint_embed_shape=24)
    ids = np.random.default_rng(6).integers(1, 60, (3, 12)).astype(np.int32)
    ids[0, 3] = ids[0, 7] = 63  # two highest ids: the first wins
    ids[1, 5], ids[1, 6:] = 62, 0
    v = _variables(jmodel.init, jnp.asarray(ids), seed=7)
    model = ClipTextTransformer(ClipTextConfig(**CLIP_CFG, quick_gelu=quick), joint_embed_shape=24)
    model.load_state_dict(convert.clip_text_state_dict(v))
    want = jax.jit(jmodel.apply)(v, jnp.asarray(ids))
    with torch.no_grad():
        got = model.eval()(_t(ids))
    assert got.shape == want.shape == (3, 24)
    _close(got, want, atol=1e-5, rtol=1e-5)


MERGES = ["t h", "th e</w>", "a n", "an d</w>", "i n", "in g</w>", "Ġ a", "p i", "pi an", "o </w>", "1 2",
          "d r", "dr u", "dru m", "s </w>"]
CLIP_TEXTS = ["The Piano and the drums", "  Playing   &amp;amp; singing\tloudly!!  ", "café ñandú ♪ 12 bpm",
              "it's we've they'll", "", " ".join(f"w{i}" for i in range(30))]


def test_clip_tokenizer_matches_jax(tmp_path):
    """Ids equal to JAX's on a gzipped merge list written here (its first
    line a version header): HTML unescaping, case, whitespace, contractions,
    digits, non-ASCII, an empty prompt and truncation at the context."""
    path = tmp_path / "bpe.txt.gz"
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(MERGES) + "\n")
    got, want = ClipTokenizer(str(path), 16), JClipTokenizer(str(path), 16)
    assert got.encoder == want.encoder and (got.sot, got.eot) == (want.sot, want.eot)
    out = got(CLIP_TEXTS)
    assert out.dtype == np.int32 and out.shape == (len(CLIP_TEXTS), 16)
    np.testing.assert_array_equal(out, want(CLIP_TEXTS))
    assert out[-1, -1] == got.eot and out[4, :3].tolist() == [got.sot, got.eot, 0]


def _tokenize(texts):
    """A stand-in text tokenizer over the tiny RoBERTa's 64 ids."""
    ids = np.ones((len(texts), 8), np.int32)
    mask = np.zeros((len(texts), 8), np.int32)
    for i, t in enumerate(texts):
        row = [0] + [4 + ord(c) % 60 for c in t[:6]] + [2]
        ids[i, :len(row)], mask[i, :len(row)] = row, 1
    return {"input_ids": ids, "attention_mask": mask}


def test_clap_module_matches_jax(tmp_path):
    """ClapModule's entry points against JAX's on the tiny CLAP of
    tests/test_clap.py: text embeddings within 1e-5, audio from data on the
    clip, repeat-pad and crop branches, and from two seeded WAV files (8 and
    16 kHz, resampled to the tower's 8 kHz) within 1e-4, cosine similarity."""
    jmodel = JCLAP(audio_cfg=TINY_AUDIO, text_cfg=TINY_TEXT, joint_embed_shape=16)
    ids = jnp.zeros((1, 8), jnp.int32)
    v = _variables(jmodel.init, jnp.zeros((1, TINY_AUDIO.clip_samples)), ids, jnp.ones_like(ids), seed=1)
    model = CLAP(TEXT_CFG, joint_embed_shape=16, audio_cfg=port_cfg(TINY_AUDIO))
    model.load_state_dict({k: t for k, t in {**convert.clap_text_state_dict(v), **convert.clap_audio_state_dict(v)}
                           .items() if "_transform." not in k}, strict=False)
    model.eval()
    kw = dict(sample_rate=TINY_AUDIO.sample_rate, clip_samples=TINY_AUDIO.clip_samples)
    jhook = JClapModule(model=jmodel, params=v, tokenizer=_tokenize, **kw)
    hook = ClapModule(model=model, tokenizer=_tokenize, **kw)
    assert hook.device == torch.device("cpu")
    texts = ["warm pad", "a drum loop", "x"]
    text = hook.get_text_embedding(texts)
    _close(text, jhook.get_text_embedding(texts), atol=1e-5, rtol=1e-5)
    rng = np.random.default_rng(8)
    for T in (TINY_AUDIO.clip_samples, 2000, 7000):
        x = (0.3 * rng.standard_normal((2, T))).astype(np.float32)
        _close(hook.get_audio_embedding_from_data(x), jhook.get_audio_embedding_from_data(jnp.asarray(x)),
               atol=1e-4, rtol=0)
    paths = []
    for i, (sr, n) in enumerate(((8000, 3000), (16000, 12000))):
        paths.append(str(tmp_path / f"clip{i}.wav"))
        audio_io.write_wav(paths[-1], (0.3 * rng.standard_normal(n)).astype(np.float32), sr)
    audio = hook.get_audio_embedding_from_filelist(paths)
    _close(audio, jhook.get_audio_embedding_from_filelist(paths), atol=1e-4, rtol=0)
    _close(hook.cosine_similarity(audio, text[:2]),
           jhook.cosine_similarity(jnp.asarray(audio.numpy()), jnp.asarray(text[:2].numpy())), atol=1e-6, rtol=0)


def test_protocols_hold_where_jax_holds():
    """The port's HubertWithKmeans and Encodec model satisfy Wav2Vec and
    NeuralCodec wherever JAX's counterparts satisfy JAX's; neither protocol
    takes the other's object."""
    hubert = HubertWithKmeans(HubertModel(HubertConfig(conv_dim=(8,) * 7, hidden_size=8, num_hidden_layers=1,
                                                       num_attention_heads=2, intermediate_size=8,
                                                       num_conv_pos_embeddings=4, num_conv_pos_embedding_groups=2)),
                              torch.zeros(4, 8))
    codec = EncodecModel(sample_rate=60, ratios=(2, 2), num_quantizers=4, codebook_size=16, dimension=8,
                         n_filters=2)
    jhubert = JHubertWithKmeans(None, None, np.zeros((4, 8), np.float32))
    jcodec = JEncodec(sample_rate=60, ratios=(2, 2), num_quantizers=4, codebook_size=16, dimension=8, n_filters=2)
    for (obj, jobj) in ((hubert, jhubert), (codec, jcodec)):
        for proto, jproto in ((model_types.Wav2Vec, jmodel_types.Wav2Vec),
                              (model_types.NeuralCodec, jmodel_types.NeuralCodec)):
            assert isinstance(obj, proto) == isinstance(jobj, jproto)
    assert isinstance(hubert, model_types.Wav2Vec) and isinstance(codec, model_types.NeuralCodec)
    assert (codec.num_quantizers, codec.codebook_size, hubert.codebook_size) == (4, 16, 4)


def test_step_timer_records_match_jax(tmp_path):
    """StepTimer's JSONL records carry JAX's field names, and its average is
    JAX's EMA of the recorded times."""
    paths = [tmp_path / "port" / "t.jsonl", tmp_path / "jax" / "t.jsonl"]
    for timer in (profiling.StepTimer(str(paths[0]), ema=0.5), jprofiling.StepTimer(str(paths[1]), ema=0.5)):
        assert timer.avg_s is None
        for step in range(3):
            with timer:
                torch.ones(8).sum()
            timer.log(step, loss=0.5)
    got, want = ([json.loads(line) for line in p.read_text().splitlines()] for p in paths)
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert [r["step"] for r in got] == [0, 1, 2] and all(r["loss"] == 0.5 for r in got)
    avg = got[0]["step_time_s"]
    for r in got:
        avg = avg if r is got[0] else 0.5 * avg + 0.5 * r["step_time_s"]
        assert r["avg_step_time_s"] == pytest.approx(avg, rel=1e-12)
    profiling.StepTimer().log(0)  # without a path: no record, no error


def test_trace_annotate_and_memory_stats(tmp_path):
    """trace writes a Chrome trace that holds the annotated ranges, the
    inner one inside the outer; device_memory_stats gives None for the CPU,
    where the JAX package gives None or its CPU statistics."""
    with profiling.trace(str(tmp_path / "trace")) as prof:
        with profiling.annotate("outer_range"):
            with profiling.annotate("inner_range"):
                torch.randn(64, 64) @ torch.randn(64, 64)
    events = json.loads(open(prof.trace_path).read())["traceEvents"]
    assert prof.trace_path.startswith(str(tmp_path / "trace"))
    spans = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events if e.get("name", "").endswith("_range")}
    assert spans["outer_range"][0] <= spans["inner_range"][0] <= spans["inner_range"][1] <= spans["outer_range"][1]
    assert profiling.device_memory_stats() == {"cpu": None}
    assert len(jprofiling.device_memory_stats()) == len(jax.devices())


def test_small_helpers_match_jax():
    """have_mp3, unfold_windows, gumbel_noise and all_rows_have_eos_id."""
    assert audio_io.have_mp3() == jaudio_io.have_mp3()
    x = np.random.default_rng(9).integers(0, 99, (2, 23, 3))
    for window, step in ((9, 4), (5, 5), (23, 1)):
        np.testing.assert_array_equal(musiclm.unfold_windows(_t(x), window, step).numpy(),
                                      np.asarray(jmusiclm.unfold_windows(jnp.asarray(x), window, step)))
    noise = sampling.gumbel_noise((4, 5), generator=torch.Generator().manual_seed(3))
    u = torch.rand((4, 5), generator=torch.Generator().manual_seed(3))
    _close(noise, jsampling.log(-jsampling.log(jnp.asarray(u.numpy()))) * -1, atol=1e-6, rtol=1e-6)
    for ids in ([[1, 2, 0], [0, 3, 3]], [[1, 2, 3], [0, 3, 3]], [[0, 0, 0], [0, 4, 0]]):
        ids = np.asarray(ids)
        assert bool(sampling.all_rows_have_eos_id(_t(ids), 0)) == bool(jsampling.all_rows_have_eos_id(ids, 0))
