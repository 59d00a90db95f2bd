"""Port parity, the fusion CLAP of musiclm_large: open_musiclm_torch's DAF,
AFF, iAFF, build_mel_fusion, the fusion HTSAT and the CLAP audio embedding
against the JAX package on the CPU in float32 (TINY_AUDIO geometry with
fusion), the weights carried over by open_musiclm_torch.convert; and the
bf16 compute of the towers bounded by JAX's own bf16 distance.
"""

import copy
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_musiclm_tpu.models.clap import clap as jclap
from open_musiclm_tpu.models.clap import fusion as jfusion
from open_musiclm_tpu.models.clap.htsat import HTSAT as JHTSAT
from open_musiclm_tpu.models.encodec import EncodecModel as JEncodec
from open_musiclm_tpu.models.hubert import HubertConfig as JHubertConfig
from open_musiclm_tpu.models.hubert import HubertModel as JHubert
from open_musiclm_tpu.testing import TINY_AUDIO, TINY_TEXT

from open_musiclm_torch.convert import codec_state_dict, fusion_state_dict, htsat_state_dict, hubert_state_dict
from open_musiclm_torch.models.clap import fusion
from open_musiclm_torch.models.clap.clap import CLAP, ClapQuantized, wav_to_mel_fusion
from open_musiclm_torch.models.clap.roberta import RobertaConfig
from open_musiclm_torch.models.encodec import EncodecModel
from open_musiclm_torch.models.hubert import HubertConfig, HubertModel
from open_musiclm_torch.models.rvq import rvq_init

from tests.test_torch_htsat import port_cfg
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
# the fused patch embed runs bicubic folds, 1x1 convs, BatchNorms and a
# sigmoid blend before the Swin stages: embeddings within 1e-5 of JAX's
TINY_FUSION = copy.copy(TINY_AUDIO)
TINY_FUSION.enable_fusion = True
CHUNK = TINY_FUSION.clip_samples // TINY_FUSION.hop_size + 1  # 128 frames


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _perturb_bn_stats(v, seed):
    """Every BatchNorm's scale, bias and running statistics away from init."""
    rng = np.random.default_rng(seed)

    def walk(p, s):
        for k in p:
            if k.startswith("bn") and "scale" in p[k]:
                n = p[k]["scale"].shape[0]
                p[k] = {"scale": rng.uniform(0.5, 1.5, n).astype(np.float32),
                        "bias": rng.normal(0, 0.3, n).astype(np.float32)}
                s[k] = {"mean": rng.normal(0, 0.5, n).astype(np.float32),
                        "var": rng.uniform(0.5, 2.0, n).astype(np.float32)}
            elif isinstance(p[k], dict) and k in s:
                walk(p[k], s[k])

    walk(v["params"], v["batch_stats"])
    return v


@pytest.mark.parametrize("kind", ["daf", "aff", "iaff"])
def test_fusion_modules_match_jax(kind):
    """DAF, AFF and iAFF on [B, C, H, W] (the JAX modules on [B, H, W, C])
    within 1e-5, BatchNorms from their (perturbed) running statistics."""
    x, r = _np(0, 2, 6, 5, 16), _np(1, 2, 6, 5, 16)
    jmod = jfusion.make_fusion(f"{kind}_2d", 16)
    v = jax.device_get(jmod.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(r)))
    v = _perturb_bn_stats({"params": dict(v.get("params", {})), "batch_stats": dict(v.get("batch_stats", {}))}, 4)
    want = jmod.apply(v, jnp.asarray(x), jnp.asarray(r))
    mod = fusion.make_fusion(f"{kind}_2d", 16)
    # flax creates no parameters for iAFF's global_att2, which its forward
    # never calls; the port holds it for the checkpoint's layout
    missing, unexpected = mod.load_state_dict(fusion_state_dict(v["params"], v["batch_stats"]), strict=False)
    assert not unexpected and all(k.startswith("global_att2.") for k in missing)
    assert bool(missing) == (kind == "iaff")
    with torch.no_grad():
        got = mod.eval()(_t(x).permute(0, 3, 1, 2), _t(r).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("T", [100, CHUNK, CHUNK + 1, 301, 3001 // 8])
def test_build_mel_fusion_matches_jax(T):
    """The four views of a track shorter than, equal to and longer than a
    clip (the shrink antialiased when it shrinks) within 1e-5 of JAX."""
    mel = _np(T, T, 8, scale=10.0)
    want = jfusion.build_mel_fusion(jnp.asarray(mel), CHUNK)
    got = fusion.build_mel_fusion(_t(mel), CHUNK)
    assert got.shape == want.shape == (4, CHUNK, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_linear_resize_matrix_is_jax_resize():
    """The resize weights applied to the identity are JAX's linear resize
    of the identity: one 3,001 -> 1,001 shrink (a 30 s clip's frames)."""
    eye = np.eye(3001, dtype=np.float32)[:, :16]
    want = np.asarray(jax.image.resize(jnp.asarray(eye), (1001, 16), method="linear"))
    got = fusion.linear_resize_matrix(3001, 1001).T @ eye
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.fixture(scope="module")
def fusion_pair():
    """The JAX fusion HTSAT (every BatchNorm perturbed) and projection, and
    the port's CLAP audio side carrying their weights."""
    jmodel = JHTSAT(cfg=TINY_FUSION)
    mf = jnp.zeros((1, 4, CHUNK, TINY_FUSION.mel_bins))
    v = jax.device_get(jax.jit(lambda k, m: jmodel.init(k, mel_fusion=m, longer=jnp.ones((1,), bool)))(
        jax.random.PRNGKey(5), mf))
    v = _perturb_bn_stats({"params": dict(v["params"]), "batch_stats": dict(v["batch_stats"])}, 6)
    jproj = jclap.Projection(16)
    pv = jax.device_get(jproj.init(jax.random.PRNGKey(7), jnp.zeros((1, TINY_FUSION.num_features))))
    model = CLAP(RobertaConfig(**dataclasses.asdict(TINY_TEXT)), joint_embed_shape=16,
                 audio_cfg=port_cfg(TINY_FUSION))
    sd = {f"audio_branch.{k}": t for k, t in htsat_state_dict(v).items()}
    for j, name in ((0, "fc1"), (2, "fc2")):
        sd[f"audio_projection.{j}.weight"] = _t(np.asarray(pv["params"][name]["kernel"]).T)
        sd[f"audio_projection.{j}.bias"] = _t(pv["params"][name]["bias"])
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert not unexpected and all(k.startswith(("text_", "audio_transform.", "logit_scale")) for k in missing)
    apply = jax.jit(lambda v, m, l: jmodel.apply(v, mel_fusion=m, longer=l))  # one trace for every b2 stack
    return apply, v, jproj, pv, model.eval()


def test_fusion_htsat_matches_jax(fusion_pair):
    """The fusion tower on a view stack with ``longer`` set and unset:
    embedding, clipwise and framewise outputs within 1e-5."""
    apply, v, _, _, model = fusion_pair
    mf = _np(8, 2, 4, CHUNK, TINY_FUSION.mel_bins, scale=10.0) - 20.0
    longer = np.array([True, False])
    want = apply(v, jnp.asarray(mf), jnp.asarray(longer))
    with torch.no_grad():
        got = model.audio_branch(mel_fusion=_t(mf), longer=_t(longer))
    for key in ("embedding", "clipwise_output", "framewise_output"):
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **TOL)


@pytest.mark.parametrize("T", [TINY_FUSION.clip_samples, 2000, 3 * TINY_FUSION.clip_samples + 7],
                         ids=["clip", "short", "long"])
def test_fusion_audio_embedding_matches_jax(fusion_pair, T):
    """ClapQuantized.audio_embedding of a fusion CLAP (int16 round trip;
    repeat-pad below a clip, the whole track above it with ``longer`` set)
    against JAX's steps: wav_to_mel_fusion, the tower, the projection and the
    L2 norm (JAX's CLAP.get_audio_embedding), within 1e-5."""
    apply, v, jproj, pv, model = fusion_pair
    wav = _np(T, 2, T, scale=0.3)
    jwav = jclap.int16_round_trip(jnp.asarray(wav))
    if T <= TINY_FUSION.clip_samples:
        jwav = jclap.prepare_clap_audio(jwav, TINY_FUSION.clip_samples)
    mf, longer = jclap.wav_to_mel_fusion(TINY_FUSION, jwav)
    assert bool(longer[0]) == (T > TINY_FUSION.clip_samples)
    emb = apply(v, mf, longer)["embedding"]
    want = jclap.l2_normalize(jproj.apply(pv, emb))
    clap = ClapQuantized(model=model, rvq=rvq_init(2, 4, 16, torch.Generator().manual_seed(0)),
                         sample_rate=TINY_FUSION.sample_rate, clip_samples=TINY_FUSION.clip_samples)
    got = clap.audio_embedding(_t(wav))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    stack, longer_t = wav_to_mel_fusion(model.audio_branch.cfg, _t(np.asarray(jwav)))
    np.testing.assert_allclose(stack.numpy(), np.asarray(mf), **TOL)
    assert longer_t.tolist() == np.asarray(longer).tolist()


def test_build_clap_on_musiclm_large(monkeypatch):
    """build_clap on musiclm_large.json no longer raises: a fusion HTSAT-tiny
    (mel_conv2d, an AFF fusion model) that embeds a 10 s clip and a 12 s one."""
    from open_musiclm_torch import config as tconfig

    mc = tconfig.load_model_config(str(Path(__file__).resolve().parents[1] / "configs/model/musiclm_large.json"))
    assert mc.clap_rvq_cfg.enable_fusion
    monkeypatch.setattr(tconfig, "RobertaConfig", lambda: RobertaConfig(**dataclasses.asdict(TINY_TEXT)))
    clap = tconfig.build_clap(mc, torch.Generator().manual_seed(0), device="cpu")
    tower = clap.model.audio_branch
    assert tower.cfg.enable_fusion and isinstance(tower.patch_embed.fusion_model, fusion.AFF)
    assert tower.patch_embed.mel_conv2d.weight.shape == (96, 1, 4, 12)
    wav = torch.from_numpy(_np(9, 2, 48000 * 12, scale=0.1))
    emb = clap.audio_embedding(wav[:, :480000])
    emb_long = clap.audio_embedding(wav)
    assert emb.shape == emb_long.shape == (2, 512)
    assert torch.isfinite(emb).all() and torch.isfinite(emb_long).all()
    assert not torch.allclose(emb, emb_long)


# ---------------------------------------------------------------------------
# bf16 compute: each tower's bf16 output no farther from JAX's float32
# output than twice the distance of JAX's own bf16 output
# ---------------------------------------------------------------------------


def _dist(a, b):
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


def test_fusion_htsat_bf16_bounded(fusion_pair):
    apply, v, _, _, model = fusion_pair
    mf = _np(10, 2, 4, CHUNK, TINY_FUSION.mel_bins, scale=10.0) - 20.0
    longer = jnp.asarray([True, False])
    want = apply(v, jnp.asarray(mf), longer)["embedding"]
    jbf16 = jax.jit(lambda v, m, l: JHTSAT(cfg=TINY_FUSION, dtype=jnp.bfloat16).apply(v, mel_fusion=m, longer=l))(
        v, jnp.asarray(mf), longer)
    tower = copy.deepcopy(model.audio_branch)
    tower.compute_dtype = torch.bfloat16
    with torch.no_grad():
        got = tower(mel_fusion=_t(mf), longer=_t(np.asarray(longer)))["embedding"]
    assert got.dtype == torch.bfloat16
    assert _dist(got.float(), want) <= 2 * _dist(jbf16["embedding"], want)


def test_roberta_bf16_bounded():
    from open_musiclm_tpu.models.clap.roberta import RobertaModel as JRoberta

    from open_musiclm_torch.convert import roberta_state_dict
    from open_musiclm_torch.models.clap.roberta import RobertaModel

    rng = np.random.default_rng(14)
    ids = rng.integers(4, TINY_TEXT.vocab_size, (3, 10)).astype(np.int32)
    mask = np.ones((3, 10), np.int32)
    mask[1, 6:] = 0
    v = jax.device_get(jax.jit(JRoberta(cfg=TINY_TEXT).init)(jax.random.PRNGKey(2), jnp.asarray(ids), jnp.asarray(mask)))
    want = jax.jit(JRoberta(cfg=TINY_TEXT).apply)(v, ids, mask)["pooler_output"]
    jbf16 = jax.jit(JRoberta(cfg=TINY_TEXT, dtype=jnp.bfloat16).apply)(v, ids, mask)["pooler_output"]
    model = RobertaModel(RobertaConfig(**dataclasses.asdict(TINY_TEXT)), compute_dtype=torch.bfloat16)
    model.load_state_dict(roberta_state_dict(v))
    with torch.no_grad():
        got = model.eval()(_t(ids), _t(mask))["pooler_output"]
    assert got.dtype == torch.bfloat16
    assert _dist(got.float(), want) <= 2 * _dist(jbf16, want)


def test_hubert_bf16_bounded():
    geom = dict(conv_dim=(16,) * 7, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                intermediate_size=64, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
                conv_kernel=(4, 3, 2, 2, 1, 1, 1), conv_stride=(2, 2, 2, 2, 1, 1, 1))
    jcfg = JHubertConfig(**geom)
    jmodel = JHubert(cfg=jcfg)
    wav = _np(11, 2, 1000, scale=0.3)
    v = jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(wav)))
    want = jax.jit(jmodel.apply)(v, jnp.asarray(wav))[0]
    jbf16 = jax.jit(JHubert(cfg=jcfg, dtype=jnp.bfloat16).apply)(v, jnp.asarray(wav))[0]
    model = HubertModel(HubertConfig(**geom), compute_dtype=torch.bfloat16)
    model.load_state_dict(hubert_state_dict(v))
    with torch.no_grad():
        got = model.eval()(_t(wav))[-1]
    assert got.dtype == torch.bfloat16
    assert _dist(got.float(), want) <= 2 * _dist(jbf16, want)


def test_encodec_bf16_bounded():
    geom = dict(sample_rate=240, ratios=(4, 2), num_quantizers=3, codebook_size=16, dimension=8, n_filters=4)
    jcodec = JEncodec(**geom)
    wav = _np(12, 2, 480, scale=0.3)
    v = jax.device_get(jax.jit(jcodec.init)(jax.random.PRNGKey(1), jnp.asarray(wav)))
    codes = np.random.default_rng(13).integers(0, 16, (2, 30, 3))
    model = EncodecModel(**geom, compute_dtype=torch.bfloat16)
    model.load_state_dict(codec_state_dict(v, len(geom["ratios"])))
    model.eval()
    for method, x, port in ((JEncodec.embed, wav, model.embed), (JEncodec.decode, codes, model.decode)):
        want = jax.jit(lambda v, x: jcodec.apply(v, x, method=method))(v, jnp.asarray(x))
        jbf16 = jax.jit(lambda v, x: JEncodec(**geom, dtype=jnp.bfloat16).apply(v, x, method=method))(
            v, jnp.asarray(x))
        with torch.no_grad():
            got = port(_t(x))
        assert got.dtype == torch.bfloat16
        assert _dist(got.float(), want) <= 2 * _dist(jbf16, want)
