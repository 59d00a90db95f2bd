"""Port parity, loading: open_musiclm_torch.import_torch against the JAX
importer followed by open_musiclm_torch.convert (every state dict bit for
bit, on reference-layout files built from seeded draws), the port's own
checkpoints round-tripping through open_musiclm_torch.load, and the
doll-house MusicLM built from the same files through both packages'
load_stage / load_rvq / load_kmeans giving JAX's greedy codes.
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import flax.linen
import jax
import jax.numpy as jnp
import joblib
import numpy as np
import pytest
import torch

from open_musiclm_tpu import import_torch as jit_
from open_musiclm_tpu import load as jload
from open_musiclm_tpu.config import load_model_config as j_load_model_config
from open_musiclm_tpu.core.sequence import TokenSequenceSpec as JSpec
from open_musiclm_tpu.models.clap.clap import CLAP as JCLAP
from open_musiclm_tpu.models.clap.clap import ClapQuantized as JClapQuantized
from open_musiclm_tpu.models.encodec import EncodecModel as JEncodec
from open_musiclm_tpu.models.hubert import HubertConfig as JHubertConfig
from open_musiclm_tpu.models.musiclm import MusicLM as JMusicLM
from open_musiclm_tpu.models.token_cond import TokenConditionedTransformer as JTCT
from open_musiclm_tpu.testing import CB, N_CLAP_Q, TINY_AUDIO, TINY_GEN_KW, TINY_TEXT, FakeTokenizer

from open_musiclm_torch import config as tconfig
from open_musiclm_torch import convert
from open_musiclm_torch import import_torch as it
from open_musiclm_torch import load as tload
from open_musiclm_torch.checkpoint import save_checkpoint
from open_musiclm_torch.models.clap.clap import CLAP, ClapQuantized
from open_musiclm_torch.models.clap import model_configs
from open_musiclm_torch.models.clap.tokenizer import bytes_to_unicode
from open_musiclm_torch.models.clap.htsat import HTSAT
from open_musiclm_torch.models.clap.pann import PANN
from open_musiclm_torch.models.clap.roberta import RobertaConfig, RobertaModel
from open_musiclm_torch.models.encodec import EncodecModel
from open_musiclm_torch.models.hubert import HubertConfig, HubertModel
from open_musiclm_torch.models.musiclm import MusicLM

from tests.test_import_torch import make_reference_shaped_stage_sd
from tests.test_torch_htsat import port_cfg
from tests.test_torch_slice import _init_decoder, port_codec
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
TEXT_CFG = RobertaConfig(**dataclasses.asdict(TINY_TEXT))
TINY_HUBERT = dict(conv_dim=(16,) * 7, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                   intermediate_size=64, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
GREEDY = dict(semantic_temperature=0.0, coarse_temperature=0.0, fine_temperature=0.0)


def tiny_model_config(folder: Path, **global_cfg) -> str:
    """A model config of the doll-house geometry (stages of dim 32, depth 1,
    2 heads; 16-entry codebooks; 4 CLAP quantizers; Encodec at 3 kbps: 2
    coarse + 2 fine quantizers) written as JSON; returns its path."""
    stage = {"dim": 32, "depth": 1, "heads": 2, "ff_dropout": 0.0}
    cfg = {
        "global_cfg": {"semantic_audio_length_seconds": 2.0, "coarse_audio_length_seconds": 1.0,
                       "fine_audio_length_seconds": 1.0, "clap_audio_length_seconds": 1.0,
                       "num_coarse_quantizers": 2, "num_fine_quantizers": 2, **global_cfg},
        "clap_rvq_cfg": {"rq_num_quantizers": N_CLAP_Q, "codebook_size": CB},
        "hubert_kmeans_cfg": {"model_name": "m-a-p/MERT-v0", "normalize_embeds": True, "embed_layer": 1,
                              "codebook_size": CB},
        "encodec_cfg": {"bandwidth": 3.0, "codebook_size": CB},
        "semantic_cfg": stage, "coarse_cfg": stage, "fine_cfg": stage,
    }
    path = folder / "tiny_model.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


def _np_sd(module) -> dict:
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


# ---------------------------------------------------------------------------
# import_torch: bit for bit against the JAX importer + convert.py
# ---------------------------------------------------------------------------

STAGE_SPECS = {
    "semantic": (JSpec(CB, N_CLAP_Q), JSpec(CB, 1)),
    "coarse": (JSpec(CB, N_CLAP_Q), JSpec(CB, 1), JSpec(CB, 2)),
    "fine": (JSpec(CB, N_CLAP_Q), JSpec(CB, 2), JSpec(CB, 2)),
}


@pytest.mark.parametrize("stage", sorted(STAGE_SPECS))
def test_import_stage_matches_jax(stage):
    specs = STAGE_SPECS[stage]
    sd = make_reference_shaped_stage_sd(specs, depth=2)
    jmodel = JTCT(specs=specs, dim=32, depth=2, heads=2, dim_head=8)
    want = convert.stage_state_dict(jit_.import_stage_transformer(sd, jmodel), len(specs), 2)
    _equal(it.import_stage_transformer(sd, len(specs), 2), want)


def test_import_stage_raises_on_unported_variants():
    """The variants that raised before they were ported (the plain
    FeedForward, the T5 bias, absolute positions) now map as the JAX
    importer followed by convert.py maps them, each alone and all three
    together; a plain-FF file without its mid norm still raises (KeyError),
    in both packages."""
    specs = STAGE_SPECS["semantic"]
    sd = make_reference_shaped_stage_sd(specs)
    rs = np.random.RandomState(1)
    inner = 32 * 4
    plain = {k: v for k, v in sd.items() if not k.startswith("transformer.layers.0.2.")}
    plain.update({"transformer.layers.0.2.0.gamma": rs.randn(32).astype(np.float32),
                  "transformer.layers.0.2.1.weight": rs.randn(2 * inner, 32).astype(np.float32),
                  "transformer.layers.0.2.3.gamma": rs.randn(inner).astype(np.float32),
                  "transformer.layers.0.2.5.weight": rs.randn(32, inner).astype(np.float32)})
    t5 = {k: v for k, v in sd.items() if ".rel_pos_bias.net." not in k}
    t5["transformer.rel_pos_bias.relative_attention_bias.weight"] = rs.randn(32, 2).astype(np.float32)
    pos = {f"absolute_position_embeddings.{i}.weight": rs.randn(20, 32).astype(np.float32) for i in range(2)}
    every = {**{k: v for k, v in plain.items() if ".rel_pos_bias.net." not in k}, **pos,
             "transformer.rel_pos_bias.relative_attention_bias.weight":
                 t5["transformer.rel_pos_bias.relative_attention_bias.weight"]}
    cases = [(plain, dict(use_conv_ff=False)), (t5, dict(relative_position_bias_type="t5")),
             ({**sd, **pos}, dict(use_absolute_position_embeddings=True, max_absolute_position_embeddings=20)),
             (every, dict(use_conv_ff=False, relative_position_bias_type="t5",
                          use_absolute_position_embeddings=True, max_absolute_position_embeddings=20))]
    for file, kw in cases:
        jmodel = JTCT(specs=specs, dim=32, depth=1, heads=2, dim_head=8, **kw)
        want = convert.stage_state_dict(jit_.import_stage_transformer(file, jmodel), len(specs), 1)
        _equal(it.import_stage_transformer(file, len(specs), 1), want)
    broken = {k: v for k, v in plain.items() if k != "transformer.layers.0.2.3.gamma"}
    with pytest.raises(KeyError):
        jit_.import_stage_transformer(broken, JTCT(specs=specs, dim=32, depth=1, heads=2, dim_head=8,
                                                   use_conv_ff=False))
    with pytest.raises(KeyError):
        it.import_stage_transformer(broken, len(specs), 1)


ENCODEC_GEOM = dict(sample_rate=240, ratios=(4, 2), num_quantizers=3, codebook_size=16, dimension=8, n_filters=2)


@pytest.fixture(scope="module")
def jax_codec():
    jcodec = JEncodec(**ENCODEC_GEOM)
    decode = jax.jit(lambda p, codes: jcodec.apply(p, codes, method=JEncodec.decode))
    return decode, jax.device_get(jax.jit(jcodec.init)(jax.random.PRNGKey(0), jnp.zeros((1, 240))))["params"]


def _encodec_package_sd(p, weight_norm: bool):
    """The encodec package's layout of a doll-house JAX codec's params ``p``
    (inverting the JAX importer), every conv but block_conv2 and conv_out
    weight-normed when ``weight_norm``."""
    rng = np.random.default_rng(0)
    sd = {}

    def conv(node, prefix, wn):
        w = np.transpose(np.asarray(node["kernel"]), (2, 1, 0))
        if weight_norm and wn:
            sd[prefix + ".weight_g"] = np.sqrt((w ** 2).sum(axis=(1, 2), keepdims=True))
            sd[prefix + ".weight_v"] = w * rng.uniform(0.5, 3.0)
        else:
            sd[prefix + ".weight"] = w
        sd[prefix + ".bias"] = np.asarray(node["bias"])

    def convtr(node, prefix):
        w = np.transpose(np.asarray(node["kernel"])[::-1], (1, 2, 0)).copy()
        if weight_norm:
            sd[prefix + ".weight_g"] = np.sqrt((w ** 2).sum(axis=(1, 2), keepdims=True))
            sd[prefix + ".weight_v"] = w * 2.0
        else:
            sd[prefix + ".weight"] = w
        sd[prefix + ".bias"] = np.asarray(node["bias"])

    def res(node, prefix):
        conv(node["block_conv1"]["conv"], prefix + "block.1.conv.conv", True)
        conv(node["block_conv2"]["conv"], prefix + "block.3.conv.conv", False)
        conv(node["shortcut"]["conv"], prefix + "shortcut.conv.conv", True)

    def lstm(node, prefix):
        for l in range(2):
            for kind in ("ih", "hh"):
                sd[prefix + f"lstm.weight_{kind}_l{l}"] = np.asarray(node[f"w_{kind}_{l}"])
                sd[prefix + f"lstm.bias_{kind}_l{l}"] = np.asarray(node[f"b_{kind}_{l}"])

    enc, dec = p["encoder"], p["decoder"]
    conv(enc["conv_in"]["conv"], "encoder.model.0.conv.conv", True)
    for s in range(2):
        res(enc[f"res_{s}_0"], f"encoder.model.{3 * s + 1}.")
        conv(enc[f"down_{s}"]["conv"], f"encoder.model.{3 * s + 3}.conv.conv", True)
    lstm(enc["lstm"], "encoder.model.7.")
    conv(enc["conv_out"]["conv"], "encoder.model.9.conv.conv", False)
    conv(dec["conv_in"]["conv"], "decoder.model.0.conv.conv", True)
    lstm(dec["lstm"], "decoder.model.1.")
    for s in range(2):
        convtr(dec[f"up_{s}"]["convtr"], f"decoder.model.{3 * s + 3}.convtr.convtr")
        res(dec[f"res_{s}_0"], f"decoder.model.{3 * s + 4}.")
    conv(dec["conv_out"]["conv"], "decoder.model.8.conv.conv", True)
    for q in range(3):
        sd[f"quantizer.vq.layers.{q}._codebook.embed"] = np.asarray(p["codebooks"][q])
    return sd


@pytest.mark.parametrize("weight_norm", [True, False], ids=["weight_g_v", "plain"])
def test_import_encodec_matches_jax(jax_codec, weight_norm):
    """The encodec package layout, weight-normed (weight_g / weight_v, the
    transposed convs too) or plain: bit for bit, and the imported codec
    decodes within 1e-5 of the JAX codec on the same file."""
    decode, geom = jax_codec[0], ENCODEC_GEOM
    sd = _encodec_package_sd(jax_codec[1], weight_norm)
    jparams = jit_.import_encodec(sd, JEncodec(**geom))
    got = it.import_encodec(sd, len(geom["ratios"]), geom["num_quantizers"])
    _equal(got, convert.codec_state_dict(jparams, len(geom["ratios"])))
    codec = EncodecModel(**geom)
    codec.load_state_dict(got)
    codes = np.random.default_rng(1).integers(0, 16, (2, 7, 3))
    want = decode(jparams, jnp.asarray(codes))
    np.testing.assert_allclose(codec.eval().decode(torch.from_numpy(codes)).detach().numpy(), np.asarray(want),
                               atol=1e-5)


@pytest.mark.parametrize("layout", ["weight_g_v", "parametrizations"])
def test_import_hubert_matches_jax(layout):
    """The Hugging Face layout (the positional conv weight-normed over dim
    2 in either of its two layouts; the HF buffers the port does not hold)."""
    model = HubertModel(HubertConfig(**TINY_HUBERT), generator=torch.Generator().manual_seed(0))
    sd = _np_sd(model)
    w = sd.pop("encoder.pos_conv_embed.conv.weight")
    g = np.sqrt((w ** 2).sum(axis=(0, 1), keepdims=True)) * 1.5
    names = (("weight_g", "weight_v") if layout == "weight_g_v"
             else ("parametrizations.weight.original0", "parametrizations.weight.original1"))
    sd["encoder.pos_conv_embed.conv." + names[0]] = g
    sd["encoder.pos_conv_embed.conv." + names[1]] = w * 0.7
    sd["masked_spec_embed"] = np.zeros(32, np.float32)
    want = convert.hubert_state_dict(jit_.import_hubert(sd, JHubertConfig(**TINY_HUBERT)))
    _equal(it.import_hubert(sd, HubertConfig(**TINY_HUBERT)), want)


def test_import_roberta_matches_jax():
    sd = _np_sd(RobertaModel(TEXT_CFG, generator=torch.Generator().manual_seed(1)))
    sd["embeddings.position_ids"] = np.arange(TEXT_CFG.max_position_embeddings)[None]
    _equal(it.import_roberta(sd, TEXT_CFG), convert.roberta_state_dict(jit_.import_roberta(sd, TINY_TEXT)))


def test_import_htsat_matches_jax():
    """HTSAT-tiny's laion layout at TINY_AUDIO, with laion keys the port
    does not hold (the STFT / mel front end, the head)."""
    sd = _np_sd(HTSAT(port_cfg(TINY_AUDIO), generator=torch.Generator().manual_seed(2)))
    sd["bn0.running_mean"] = np.random.default_rng(2).normal(size=TINY_AUDIO.mel_bins).astype(np.float32)
    sd["spectrogram_extractor.stft.conv_real.weight"] = np.zeros((3, 1, 4), np.float32)
    sd["head.weight"] = np.zeros((10, 32), np.float32)
    _equal(it.import_htsat(sd, TINY_AUDIO), convert.htsat_state_dict(jit_.import_htsat(sd, TINY_AUDIO)))


@pytest.mark.parametrize("prefix", ["", "module."], ids=["plain", "module"])
def test_import_clap_matches_jax(prefix):
    """The laion bundle, with and without the ``module.`` prefix of a
    DataParallel save."""
    model = CLAP(TEXT_CFG, generator=torch.Generator().manual_seed(3), audio_cfg=port_cfg(TINY_AUDIO))
    sd = {prefix + k: v for k, v in _np_sd(model).items()}
    sd[prefix + "text_branch.embeddings.position_ids"] = np.arange(32)[None]
    jv = jit_.import_clap(sd, TINY_AUDIO, TINY_TEXT)
    want = {**convert.clap_text_state_dict(jv), **convert.clap_audio_state_dict(jv)}
    got = it.import_clap(sd, port_cfg(TINY_AUDIO), TEXT_CFG)
    _equal(got, want)
    CLAP(TEXT_CFG, audio_cfg=port_cfg(TINY_AUDIO)).load_state_dict(got)  # every key the port holds


def _rvq_sd(three_d: bool):
    rng = np.random.default_rng(4)
    sd = {}
    for q in range(3):
        e = rng.standard_normal((8, 4)).astype(np.float32)
        sd[f"layers.{q}._codebook.embed"] = e[None] if three_d else e
        sd[f"layers.{q}._codebook.cluster_size"] = np.ones((1, 8) if three_d else 8, np.float32)
        sd[f"layers.{q}._codebook.embed_avg"] = sd[f"layers.{q}._codebook.embed"].copy()
    return sd


@pytest.mark.parametrize("three_d", [False, True], ids=["2d", "3d"])
def test_import_rvq_matches_jax(three_d):
    sd = _rvq_sd(three_d)
    got = it.import_rvq(sd).codebooks
    want = convert.rvq_state(jax.device_get(jit_.import_rvq(sd))).codebooks
    assert got.shape == (3, 8, 4) and torch.equal(got, want)


@pytest.fixture(scope="module")
def kmeans_dump(tmp_path_factory):
    from sklearn.cluster import MiniBatchKMeans

    x = np.random.default_rng(5).standard_normal((200, 8)).astype(np.float32)
    path = tmp_path_factory.mktemp("km") / "kmeans.joblib"
    joblib.dump(MiniBatchKMeans(n_clusters=CB, n_init=1, random_state=0, batch_size=64).fit(x), path)
    return str(path)


def test_import_kmeans_joblib_matches_jax(kmeans_dump):
    got = it.import_kmeans_joblib(kmeans_dump)
    want = convert.kmeans_centroids(jit_.import_kmeans_joblib(kmeans_dump))
    assert got.shape == (CB, 8) and got.dtype == torch.float32 and torch.equal(got, want)


# ---------------------------------------------------------------------------
# load.py
# ---------------------------------------------------------------------------


def test_model_configs_of_musiclm_large_load():
    """musiclm_large (fusion CLAP) and its small-context variant: 24 layers
    x 16 heads x dim 1024 in every stage; the coarse stage's example
    lengths as JAX's (the cache of a 10 s coarse window)."""
    for name, fusion, coarse_len in (("musiclm_large", True, (12, 499, 2250)),
                                     ("musiclm_large_small_context", False, (12, 199, 900))):
        path = str(ROOT / "configs/model" / f"{name}.json")
        mc = tconfig.load_model_config(path)
        assert mc.clap_rvq_cfg.enable_fusion is fusion
        for st in (mc.semantic_cfg, mc.coarse_cfg, mc.fine_cfg):
            assert (st.dim, st.depth, st.heads) == (1024, 24, 16)
        assert tconfig.stage_example_lengths(mc, "coarse") == coarse_len
        from open_musiclm_tpu.config import stage_example_lengths as j_lengths

        for stage in ("semantic", "coarse", "fine"):
            assert tconfig.stage_example_lengths(mc, stage) == j_lengths(j_load_model_config(path), stage)


def test_port_checkpoints_round_trip(tmp_path, kmeans_dump):
    """The port's own files load back unchanged: a stage's state dict and a
    trainer checkpoint ({"model", "optimizer", "step"}), an RVQ's
    {"codebooks"} and k-means {"centroids"}; a reference stage .pt goes
    through the importer instead."""
    mc = tconfig.load_model_config(tiny_model_config(tmp_path))
    st = tload.load_stage(mc, "coarse", None, 7, device="cpu")
    save_checkpoint(str(tmp_path / "coarse.ckpt"), st.model.state_dict())
    save_checkpoint(str(tmp_path / "coarse.train.ckpt"), {"model": st.model.state_dict(), "optimizer": {}, "step": 3})
    for name in ("coarse.ckpt", "coarse.train.ckpt"):
        back = tload.load_stage(mc, "coarse", str(tmp_path / name), 8, device="cpu")
        _equal(back.model.state_dict(), st.model.state_dict())
    other = tload.load_stage(mc, "coarse", None, 8, device="cpu")
    assert not torch.equal(other.model.start_tokens, st.model.start_tokens)

    ref = tmp_path / "coarse_reference.pt"
    sd = make_reference_shaped_stage_sd(STAGE_SPECS["coarse"], dim_head=64)
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, ref)
    read = it.load_torch_state_dict(str(ref))
    assert sorted(read) == sorted(sd) and all(np.array_equal(read[k], sd[k]) for k in sd)
    _equal(tload.load_stage(mc, "coarse", str(ref), 8, device="cpu").model.state_dict(),
           it.import_stage_transformer(sd, 3, 1))

    g = torch.Generator().manual_seed(0)
    rvq = tload.load_rvq(None, mc, g, device="cpu")
    save_checkpoint(str(tmp_path / "rvq.ckpt"), {"codebooks": rvq.codebooks})
    assert torch.equal(tload.load_rvq(str(tmp_path / "rvq.ckpt"), mc, g, device="cpu").codebooks, rvq.codebooks)
    km = tload.load_kmeans(kmeans_dump, mc, g)
    save_checkpoint(str(tmp_path / "km.ckpt"), {"centroids": km})
    assert torch.equal(tload.load_kmeans(str(tmp_path / "km.ckpt"), mc, g), km)


def test_dollhouse_from_files_matches_jax(tmp_path, kmeans_dump, monkeypatch):
    """The doll-house MusicLM's stages, RVQ and k-means built from the same
    reference-layout files through both packages' load_stage, load_rvq and
    load_kmeans (the CLAP text tower and the codec are the doll-house's):
    greedy generate(text=...) codes equal to JAX's, waves within 1e-4."""
    # flax initialises op by op; the same init under jit (load_stage inits
    # each stage before it reads the file) takes a third of the time
    monkeypatch.setattr(JTCT, "init", lambda self, key, ids: jax.jit(
        lambda k, i: flax.linen.Module.init(self, k, i))(key, ids))
    cfg_path = tiny_model_config(tmp_path)
    jmc, tmc = j_load_model_config(cfg_path), tconfig.load_model_config(cfg_path)
    stages = {}
    for i, (stage, specs) in enumerate(sorted(STAGE_SPECS.items())):
        path = tmp_path / f"{stage}.pt"
        sd = make_reference_shaped_stage_sd(specs, dim_head=64)
        rng = np.random.default_rng(10 + i)
        sd = {k: (v * 0.3 if v.ndim > 1 else rng.uniform(0.8, 1.2, v.shape).astype(np.float32) * v)
              for k, v in sd.items()}
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
        stages[stage] = str(path)
    rvq_path = tmp_path / "rvq.pt"
    rng = np.random.default_rng(20)
    rvq_sd = {}
    for q in range(N_CLAP_Q):  # the ResidualVQ's 3-D layout over the doll-house's 16-d joint space
        e = torch.from_numpy(rng.standard_normal((1, CB, 16)).astype(np.float32))
        rvq_sd.update({f"layers.{q}._codebook.embed": e, f"layers.{q}._codebook.embed_avg": e.clone(),
                       f"layers.{q}._codebook.cluster_size": torch.ones(1, CB)})
    torch.save(rvq_sd, rvq_path)

    key = jax.random.PRNGKey(0)
    jclap_model = JCLAP(audio_cfg=TINY_AUDIO, text_cfg=TINY_TEXT, joint_embed_shape=16)
    ids = jnp.zeros((1, 8), jnp.int32)
    clap_params = jax.device_get(jax.jit(lambda k: jclap_model.init(
        k, ids, jnp.ones_like(ids), method=JCLAP.get_text_embedding))(jax.random.PRNGKey(1)))
    jcodec = JEncodec(sample_rate=60, ratios=(2, 2), num_quantizers=4, codebook_size=CB, dimension=8, n_filters=2)
    jm = JMusicLM(
        clap=JClapQuantized(model=jclap_model, params=clap_params, rvq=jload.load_rvq(str(rvq_path), jmc, key),
                            num_quantizers=N_CLAP_Q, codebook_size=CB),
        codec=jcodec, codec_params=_init_decoder(jcodec, 3), tokenizer=FakeTokenizer(),
        **{f"{s}_stage": jload.load_stage(jmc, s, stages[s], key) for s in stages})
    clap_model = CLAP(TEXT_CFG, joint_embed_shape=16)
    clap_model.load_state_dict(convert.clap_text_state_dict(clap_params), strict=False)
    tm = MusicLM(
        codec=port_codec(jcodec, jm.codec_params), tokenizer=jm.tokenizer,
        clap=ClapQuantized(model=clap_model.eval(), rvq=tload.load_rvq(str(rvq_path), tmc, None, device="cpu"),
                           num_quantizers=N_CLAP_Q, codebook_size=CB),
        **{f"{s}_stage": tload.load_stage(tmc, s, stages[s], 0, device="cpu") for s in stages})
    np.testing.assert_array_equal(tload.load_kmeans(kmeans_dump, tmc, None).numpy(),
                                  np.asarray(jload.load_kmeans(kmeans_dump, jmc, key)))

    codes = {}

    def capture(name, decode):
        def wrapped(*args):
            codes[name] = np.asarray(args[-1])
            return decode(*args)
        return wrapped

    jm._decode = capture("jax", jm._decode)
    tm._decode = capture("torch", tm._decode)
    texts = ["warm synth chords", "drum loop"]
    want = jm.generate(key=key, text=texts, **GREEDY, **TINY_GEN_KW)
    got = tm.generate(text=texts, **GREEDY, **TINY_GEN_KW)
    assert codes["torch"].shape == codes["jax"].shape == (2, 45, 4)
    np.testing.assert_array_equal(codes["torch"], codes["jax"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def _tiny_towers(monkeypatch):
    """The towers of create_musiclm_from_config at doll-house widths (the
    k-means stays 768-wide, as the loader draws it)."""
    audio = dataclasses.replace(port_cfg(TINY_AUDIO))
    monkeypatch.setattr(tconfig, "RobertaConfig", lambda: RobertaConfig(
        vocab_size=300, hidden_size=32, num_hidden_layers=1, num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=80))
    monkeypatch.setattr(tconfig, "HubertConfig", lambda: HubertConfig(
        conv_dim=(16,) * 7, hidden_size=768, num_hidden_layers=1, num_attention_heads=2, intermediate_size=64,
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=16))
    monkeypatch.setattr(tconfig, "audio_config_from_name", lambda name, enable_fusion=False: dataclasses.replace(
        audio, enable_fusion=enable_fusion))


def test_create_musiclm_from_config(tmp_path, monkeypatch):
    """Seeded: the same seed gives the same weights, a part's weights do
    not depend on which other paths are given; the port's checkpoints of
    the towers load back unchanged; no tokenizer leaves tokenizer None and
    generate(text=...) raises; bf16 is the stages' parameter dtype and the
    towers' compute dtype; the card by default."""
    _tiny_towers(monkeypatch)
    mc = tconfig.load_model_config(tiny_model_config(tmp_path))
    a = tload.create_musiclm_from_config(mc, seed=3, device="cpu")
    sem = tmp_path / "semantic.ckpt"
    save_checkpoint(str(sem), a.semantic_stage.model.state_dict())
    paths = {}
    for name, module in (("clap", a.clap.model), ("hubert", a.wav2vec.model), ("encodec", a.codec)):
        paths[f"{name}_path"] = str(tmp_path / f"{name}.ckpt")
        save_checkpoint(paths[f"{name}_path"], module.state_dict())
    b = tload.create_musiclm_from_config(mc, seed=4, device="cpu", semantic_path=str(sem), **paths)
    c = tload.create_musiclm_from_config(mc, seed=4, device="cpu")
    for x, y in ((a.semantic_stage.model, b.semantic_stage.model), (a.clap.model, b.clap.model),
                 (a.wav2vec.model, b.wav2vec.model), (a.codec, b.codec)):
        _equal(y.state_dict(), x.state_dict())
    _equal(b.coarse_stage.model.state_dict(), c.coarse_stage.model.state_dict())
    assert torch.equal(b.clap.rvq.codebooks, c.clap.rvq.codebooks)
    assert not torch.equal(a.coarse_stage.model.start_tokens, c.coarse_stage.model.start_tokens)
    assert a.tokenizer is None
    with pytest.raises(ValueError, match="tokenizer"):
        a.generate(text=["a prompt"], output_seconds=1, semantic_window_seconds=2, coarse_window_seconds=1,
                   fine_window_seconds=1)
    assert tload.load_stage(mc, "fine", None, 1, device="cpu", dtype=torch.bfloat16).model.start_tokens.dtype \
        == torch.bfloat16
    codec = tconfig.build_encodec(mc, None, device="cpu", dtype=torch.bfloat16)
    assert codec.compute_dtype == torch.bfloat16 and codec.codebooks.dtype == torch.float32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tload.create_musiclm_from_config(mc)


def test_create_musiclm_from_config_with_pann(tmp_path, monkeypatch):
    """musiclm_small with clap_rvq_cfg.amodel_type "PANN-14" (its stages
    narrowed to dim 32 / depth 1, RoBERTa and HuBERT at doll-house widths):
    a Cnn14 CLAP at the preset's 48 kHz x 10 s with a 2048-wide projection,
    read back from a laion-layout bundle ("module." keys) by the loader
    unchanged, and generate_top_match runs on the CPU (sims within [-1, 1])."""
    _tiny_towers(monkeypatch)
    monkeypatch.setattr(tconfig, "audio_config_from_name", model_configs.audio_config_from_name)
    cfg = json.loads((ROOT / "configs/model/musiclm_small.json").read_text())
    cfg["clap_rvq_cfg"]["amodel_type"] = "PANN-14"
    for stage in ("semantic_cfg", "coarse_cfg", "fine_cfg"):
        cfg[stage].update(dim=32, depth=1, heads=2)
    (tmp_path / "small_pann.json").write_text(json.dumps(cfg))
    mc = tconfig.load_model_config(str(tmp_path / "small_pann.json"))
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    vocab.update({c: 4 + i for i, c in enumerate(sorted(set(bytes_to_unicode().values())))})
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("#version: demo\n")
    m = tload.create_musiclm_from_config(mc, seed=5, device="cpu", tokenizer_path=str(tmp_path))
    tower = m.clap.model.audio_branch
    assert isinstance(tower, PANN) and tower.cfg.arch == "Cnn14"
    assert m.clap.model.audio_projection[0].in_features == 2048
    assert (m.clap.sample_rate, m.clap.clip_samples) == (48000, 480000)
    bundle, want = tmp_path / "clap.pt", {k: v.clone() for k, v in m.clap.model.state_dict().items()}
    torch.save({f"module.{k}": v for k, v in want.items()}, bundle)
    with torch.no_grad():
        for p in m.clap.model.parameters():
            p.zero_()
    tload._load_into(m.clap.model, str(bundle), lambda sd: it.import_clap(sd, tower.cfg, m.clap.model.text_branch.cfg))
    _equal(m.clap.model.state_dict(), want)
    samples, sims = m.generate_top_match(text=["a prompt"], num_samples=2, num_top_matches=2, **GREEDY, **TINY_GEN_KW)
    assert tuple(samples[0].shape) == (2, 45 * m.codec.hop_length) and sims[0].shape == (2,)
    assert bool(torch.isfinite(sims[0]).all()) and float(sims[0].abs().max()) <= 1.0 + 1e-6


def test_fusion_clap_checkpoint_import_raises(tmp_path, monkeypatch):
    """A fusion CLAP's checkpoint cannot be imported (no fusion weights are
    mapped, as in JAX): a clear error, not a half-loaded tower."""
    _tiny_towers(monkeypatch)
    mc = tconfig.load_model_config(tiny_model_config(tmp_path))
    mc = dataclasses.replace(mc, clap_rvq_cfg=dataclasses.replace(mc.clap_rvq_cfg, enable_fusion=True))
    (tmp_path / "clap.pt").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="fusion"):
        tload.create_musiclm_from_config(mc, device="cpu", clap_path=str(tmp_path / "clap.pt"))


def test_load_path_imports_no_jax():
    """The loader, the importer, audio I/O and the CLIs import with jax,
    flax and the JAX package blocked."""
    blocked = ("jax", "jaxlib", "flax", "optax", "orbax", "open_musiclm_tpu")
    code = (
        "import sys\n"
        f"for name in {blocked!r}: sys.modules[name] = None\n"
        "import open_musiclm_torch.load, open_musiclm_torch.import_torch, open_musiclm_torch.data.audio_io\n"
        "import open_musiclm_torch.models.clap.fusion\n"
        "import open_musiclm_torch.cli.infer, open_musiclm_torch.cli.infer_top_match\n"
        "import open_musiclm_torch.cli.infer_coarse, open_musiclm_torch.cli.infer_fine\n"
        f"assert not any(sys.modules.get(n) for n in {blocked!r})\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
