"""Port parity, stage training from raw audio: SoundDataset and
SoundDatasetForPreprocessing, the audio batch iterator, stage_ds_config,
tokenizing_iterator, DataPreprocessor, fma_ignore_files, the artifact
writers and StageTrainer.artifact_logits against the JAX package on the CPU
in float32 (tiny towers, weights carried over by open_musiclm_torch.convert,
inputs from numpy with a seed); then the trackers, and the train_stage and
preprocess_data CLIs with ``--device cpu`` at doll-house widths.
"""

import dataclasses
import functools
import json
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_musiclm_tpu.config import GlobalConfig as JGlobalConfig
from open_musiclm_tpu.core.sequence import TokenSequenceSpec as JSpec
from open_musiclm_tpu.data import dataset as jdataset
from open_musiclm_tpu.data import fma as jfma
from open_musiclm_tpu.data import pipeline as jpipeline
from open_musiclm_tpu.data.preprocess import DataPreprocessor as JDataPreprocessor
from open_musiclm_tpu.data.tokenstore import ShardedTokenStore as JShardedTokenStore
from open_musiclm_tpu.models.clap.clap import CLAP as JCLAP
from open_musiclm_tpu.models.clap.clap import ClapQuantized as JClapQuantized
from open_musiclm_tpu.models.rvq import rvq_init as j_rvq_init
from open_musiclm_tpu.models.token_cond import StageLossConfig as JLossConfig
from open_musiclm_tpu.models.token_cond import TokenConditionedTransformer as JTCT
from open_musiclm_tpu.parallel.mesh import make_mesh
from open_musiclm_tpu.testing import CB, N_CLAP_Q, TINY_AUDIO, TINY_TEXT
from open_musiclm_tpu.train import artifacts as jartifacts
from open_musiclm_tpu.train.trainer import StageTrainer as JStageTrainer

from open_musiclm_torch import config as tconfig
from open_musiclm_torch.checkpoint import find_latest_checkpoint, load_checkpoint
from open_musiclm_torch.cli import train_coarse_stage, train_fine_stage, train_semantic_stage
from open_musiclm_torch.cli import train_stage
from open_musiclm_torch.convert import clap_audio_state_dict, rvq_state
from open_musiclm_torch.data import audio_io, dataset, fma, pipeline
from open_musiclm_torch.data.preprocess import DataPreprocessor
from open_musiclm_torch.data.tokenstore import ShardedTokenStore
from open_musiclm_torch.models.clap.clap import CLAP, ClapQuantized
from open_musiclm_torch.models.clap.roberta import RobertaConfig
from open_musiclm_torch.models.hubert import HubertConfig
from open_musiclm_torch.models.encodec import EncodecModel
from open_musiclm_torch.core.sequence import TokenSequenceSpec
from open_musiclm_torch.models.token_cond import StageLossConfig, TokenConditionedTransformer
from open_musiclm_torch.train import artifacts
from open_musiclm_torch.train.trainer import StageTrainer

from tests.test_torch_audio_prompt import _codec_pair, _wav2vec_pair
from tests.test_torch_clap import TEXT_CFG
from tests.test_torch_htsat import port_cfg
from tests.test_torch_slice import _t, port_model
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
# (seconds, rate) of the seeded tracks: two longer than the 2 s window, one
# shorter, one at an odd rate
TRACKS = [(3.5, 8000), (2.6, 4000), (1.2, 8000), (2.2, 11025)]
# the doll-house windows: 2 s semantic (CLAP) windows, 1 s coarse and fine
GLOBAL = dict(semantic_audio_length_seconds=2.0, coarse_audio_length_seconds=1.0, fine_audio_length_seconds=1.0,
              clap_audio_length_seconds=2.0, num_coarse_quantizers=2, num_fine_quantizers=2)
# float32 embeddings of the two packages are ~1e-6 apart; a nearest-code
# choice whose margin (second-best minus best squared distance) is below
# this may go either way and is counted as a near tie
NEAR_TIE = 1e-3


def write_tracks(folder: Path, tracks=TRACKS, seed=0) -> Path:
    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i, (sec, sr) in enumerate(tracks):
        t = np.arange(int(sec * sr)) / sr
        sig = 0.3 * np.sin(2 * np.pi * (110 + 40 * i) * t) + 0.1 * rng.randn(len(t))
        audio_io.write_wav(str(folder / f"track_{i}.wav"), sig.astype(np.float32), sr)
    return folder


@pytest.fixture(scope="module")
def wav_folder(tmp_path_factory):
    return write_tracks(tmp_path_factory.mktemp("tracks"))


def _views_equal(got, want):
    got, want = (got, want) if isinstance(want, tuple) else ((got,), (want,))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# 1. datasets and the batch iterator
# ---------------------------------------------------------------------------

VIEWS = {
    "coarse": dict(max_length_seconds=(2.0, 1.0, 1.0), normalize=(False, True, False),
                   target_sample_hz=(8000, 160, 240), seq_len_multiple_of=(None, 16, None), seed=3),
    "one_view": dict(max_length_seconds=(1.5,), normalize=(True,), target_sample_hz=(8000,),
                     seq_len_multiple_of=(320,), seed=4),
    "no_crop": dict(max_length_seconds=(None, 1.0), normalize=(False, False), target_sample_hz=(4000, 8000),
                    seq_len_multiple_of=(None, None), random_crop=False),
}


@pytest.mark.parametrize("kind", sorted(VIEWS))
def test_sound_dataset_views_match_jax(wav_folder, kind):
    """Nested crops from the same seed, resampling, normalization, the int16
    round trip and curtailing, a track shorter than its view padded, every
    view within 1e-6 of JAX's over two passes."""
    kw = VIEWS[kind]
    want = jdataset.SoundDataset(folder=str(wav_folder), **kw)
    got = dataset.SoundDataset(folder=str(wav_folder), **kw)
    assert [f.name for f in got.files] == [f.name for f in want.files]
    for i in (0, 2, 1, 3, 2, 0):
        _views_equal(got[i], want[i])


def test_preprocessing_dataset_matches_jax(tmp_path):
    """Whole tracks: the short one repeated up to the window, the others
    padded to a whole second, cropped to 3 s; an unreadable file gives None."""
    folder = write_tracks(tmp_path)
    (folder / "broken.wav").write_bytes(b"not a wave file")
    kw = dict(folder=str(folder), pad_to_seconds=2, max_length_seconds=(3, 3), normalize=(False, True),
              target_sample_hz=(8000, 160), seq_len_multiple_of=(None, 16))
    want = jdataset.SoundDatasetForPreprocessing(**kw)
    got = dataset.SoundDatasetForPreprocessing(**kw)
    for i in range(len(want)):
        w, g = want[i], got[i]
        if w is None:
            assert g is None and want.files[i].name == "broken.wav"
            continue
        assert (g["idx"], g["file_path"]) == (w["idx"], w["file_path"])
        _views_equal(g["data"], w["data"])


@pytest.mark.parametrize("shuffle", [True, False])
def test_batch_iterator_audio_batches_match_jax(wav_folder, shuffle):
    """flatten_token_batches=False, one worker: the same [B, T] view batches
    in the same order."""
    kw = VIEWS["coarse"]
    want_it = jdataset.batch_iterator(jdataset.SoundDataset(folder=str(wav_folder), **kw), 3, shuffle=shuffle,
                                      seed=5, num_workers=1, flatten_token_batches=False)
    got_it = dataset.batch_iterator(dataset.SoundDataset(folder=str(wav_folder), **kw), 3, shuffle=shuffle,
                                    seed=5, num_workers=1, flatten_token_batches=False)
    for _ in range(3):
        want, got = next(want_it), next(got_it)
        assert [b.shape for b in got] == [b.shape for b in want] == [(3, 16000), (3, 160), (3, 240)]
        _views_equal(tuple(got), tuple(want))
    want_it.close()
    got_it.close()


def test_batch_iterator_batches_one_view_datasets(wav_folder):
    """A one-view SoundDataset gives bare arrays; they batch as a tuple of
    one [B, T] array (the tokenizer trainers' input). The JAX package's
    collate cannot take them (its pad_to_longest zips over the samples)."""
    ds = dataset.SoundDataset(folder=str(wav_folder), **VIEWS["one_view"])
    it = dataset.batch_iterator(ds, 4, num_workers=2, flatten_token_batches=False)
    batch = next(it)
    it.close()
    assert len(batch) == 1 and batch[0].shape == (4, 11840) and batch[0].dtype == np.float32
    with pytest.raises(IndexError):
        jdataset.pad_to_longest([np.zeros(8, np.float32)] * 2)


@pytest.mark.parametrize("stage", ["semantic", "coarse", "fine"])
def test_stage_ds_config_matches_jax(stage):
    towers = (types.SimpleNamespace(sample_rate=48000), types.SimpleNamespace(target_sample_hz=16000,
                                                                              seq_len_multiple_of=320),
              types.SimpleNamespace(sample_rate=24000))
    want = jpipeline.stage_ds_config(stage, *towers, JGlobalConfig(**GLOBAL))
    assert pipeline.stage_ds_config(stage, *towers, tconfig.GlobalConfig(**GLOBAL)) == want
    with pytest.raises(ValueError):
        pipeline.stage_ds_config("acoustic", *towers, tconfig.GlobalConfig(**GLOBAL))


def test_fma_ignore_files_matches_jax(tmp_path):
    """FMA's two-row header, genre lists, listens / favorites limits, a
    malformed row and a non-track row."""
    (tmp_path / "tracks.csv").write_text(
        ",album,album,track,track,track,track\n"
        "track_id,genres_all,listens,title,genres_all,listens,favorites\n"
        "1,[1],5,a,\"[38, 2]\",500,1\n"
        "2,[38],5,b,\"[38]\",5000,100\n"
        "3,[38],5,c,\"[10]\",10,0\n"
        "4,[1],5,d,\"[1, 38]\",2000,3\n"
        "5,[1],5,e,\"[38\",10,0\n"
        "12,[1],5,f,\"[38]\",1000.0,9\n"
        "note,,,,,,\n")
    want = jfma.fma_ignore_files(str(tmp_path))
    assert fma.fma_ignore_files(str(tmp_path)) == want == ["000001.mp3", "000004.mp3", "000012.mp3"]
    assert fma.fma_ignore_files(str(tmp_path), max_listens=100, max_favorites=0) == jfma.fma_ignore_files(
        str(tmp_path), max_listens=100, max_favorites=0)


# ---------------------------------------------------------------------------
# 2. the tokenizers: tokenizing_iterator and DataPreprocessor
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tokenizers():
    """The doll-house tokenizers of both packages, the port's carrying JAX's
    weights: CLAP (HTSAT at 8 kHz, a 4 x 16 RVQ), HuBERT at 160 Hz with a
    16-entry k-means (9 ids a second), Encodec at 240 Hz (15 frames a
    second, 2 coarse + 2 fine quantizers). The CLAP has its audio side
    alone (the text tower is off these paths)."""
    jmodel = JCLAP(audio_cfg=TINY_AUDIO, text_cfg=TINY_TEXT, joint_embed_shape=16)
    init = jax.jit(functools.partial(jmodel.init, method=JCLAP.get_audio_embedding))
    v = jax.device_get(init(jax.random.PRNGKey(2), jnp.zeros((1, TINY_AUDIO.clip_samples))))
    model = CLAP(TEXT_CFG, joint_embed_shape=16, audio_cfg=port_cfg(TINY_AUDIO))
    missing, unexpected = model.load_state_dict(clap_audio_state_dict(v), strict=False)
    assert not unexpected and all(k.startswith(("text_", "audio_transform.", "logit_scale_t")) for k in missing)
    jstate = j_rvq_init(N_CLAP_Q, CB, 16, jax.random.PRNGKey(7))
    kw = dict(num_quantizers=N_CLAP_Q, codebook_size=CB, sample_rate=TINY_AUDIO.sample_rate,
              clip_samples=TINY_AUDIO.clip_samples)
    # jnp leaves: under jax.jit the JAX HTSAT indexes its rel-pos table with a traced array
    jclap = JClapQuantized(model=jmodel, params=jax.tree_util.tree_map(jnp.asarray, v), rvq=jstate, **kw)
    clap = ClapQuantized(model=model, rvq=rvq_state(jstate), **kw)
    jw, tw = _wav2vec_pair(4)
    jcodec, jparams, codec = _codec_pair(5, sample_rate=240, ratios=(4, 4), num_quantizers=4, codebook_size=CB,
                                         dimension=8, n_filters=2)
    return (jclap, jw, jcodec, jparams), (clap, tw, codec)


def _nearest_chain_decided(x, codebooks, ids):
    """[n] bool: rows of x [n, D] whose residual nearest-code choices
    ``ids`` [n, Q] through codebooks [Q, K, D] are each decided by more
    than NEAR_TIE."""
    x, ok = np.asarray(x, np.float64), np.ones(len(x), bool)
    for q, cb in enumerate(np.asarray(codebooks, np.float64)):
        d2 = ((x[:, None, :] - cb[None]) ** 2).sum(-1)
        part = np.sort(d2, axis=-1)
        ok &= (part[:, 1] - part[:, 0] > NEAR_TIE) & (d2.argmin(-1) == ids[:, q])
        x = x - cb[ids[:, q]]
    return ok


def _decided_masks(stage, ttok, batch, ids):
    """Per sequence, the [B, n] positions JAX's tokens ``ids`` decide beyond
    a near tie (CLAP: its RVQ chain; semantic: the k-means; codes: each
    frame's residual chain), the margins taken on the port's float32
    inputs to the nearest-code searches (~1e-6 from JAX's)."""
    clap, w2v, codec = ttok
    with torch.no_grad():
        emb = clap.audio_embedding(_t(batch[0])).numpy()
        masks = [np.repeat(_nearest_chain_decided(emb, clap.rvq.codebooks, ids[0])[:, None], N_CLAP_Q, 1)]
        if stage in ("semantic", "coarse"):
            feats = w2v.features(_t(batch[1])).numpy()
            b, t, d = feats.shape
            masks.append(_nearest_chain_decided(feats.reshape(-1, d), w2v.centroids[None].numpy(),
                                                ids[1].reshape(-1, 1)).reshape(b, t))
        if stage in ("coarse", "fine"):
            z = codec.embed(_t(batch[-1])).numpy()
            b, t, d = z.shape
            q_c = GLOBAL["num_coarse_quantizers"]
            codes = np.concatenate([ids[-1 if stage == "coarse" else 1].reshape(b, t, q_c)]
                                   + ([ids[2].reshape(b, t, -1)] if stage == "fine" else []), axis=-1)
            frame_ok = _nearest_chain_decided(z.reshape(-1, d), codec.codebooks[:codes.shape[-1]].numpy(),
                                              codes.reshape(b * t, -1)).reshape(b, t)
            masks += [np.repeat(frame_ok, q_c, 1)] + ([np.repeat(frame_ok, codes.shape[-1] - q_c, 1)]
                                                       if stage == "fine" else [])
    return masks


@pytest.mark.parametrize("stage,lens", [("semantic", (N_CLAP_Q, 19)), ("coarse", (N_CLAP_Q, 9, 30)),
                                        ("fine", (N_CLAP_Q, 30, 30))])
def test_tokenizing_iterator_matches_jax(wav_folder, tokenizers, stage, lens):
    """accum 2 x batch 2 of a stage's views from the dataset: int64
    [accum, B, n_i] token batches equal to JAX's at every position whose
    nearest-code choice is not a near tie (the near ties counted and few)."""
    jtok, ttok = tokenizers
    g = tconfig.GlobalConfig(**GLOBAL)
    cfg = pipeline.stage_ds_config(stage, ttok[0], ttok[1], ttok[2], g)
    ds = dataset.SoundDataset(folder=str(wav_folder), seed=6, **cfg)
    batches = [tuple(np.stack(c) for c in zip(*(ds[i] for i in pair))) for pair in ((0, 2), (3, 1))]
    want = next(jpipeline.tokenizing_iterator(stage, iter(batches), *jtok, num_coarse_quantizers=2, accum=2))
    masks = [_decided_masks(stage, ttok, batch, [np.asarray(w[a]) for w in want])
             for a, batch in enumerate(batches)]
    got = next(pipeline.tokenizing_iterator(stage, iter(batches), *ttok, num_coarse_quantizers=2, accum=2))
    assert [tuple(t.shape) for t in got] == [np.asarray(w).shape for w in want] == [(2, 2, n) for n in lens]
    assert all(t.dtype == torch.long for t in got)
    near = total = 0
    for a in range(len(batches)):
        for t, w, m in zip(got, want, masks[a]):
            np.testing.assert_array_equal(t[a].numpy()[m], np.asarray(w[a])[m])
            near, total = near + int((~m).sum()), total + m.size
    assert near <= 0.05 * total


def _preprocessors(tokenizers, folder, results, **kw):
    (jclap, jw, jcodec, jparams), (clap, tw, codec) = tokenizers
    common = dict(folder=str(folder), num_coarse_quantizers=2, clap_audio_length_seconds=1,
                  semantic_audio_length_seconds=1, clap_batch_size=2, **{"max_audio_length_seconds": 2, **kw})
    return (JDataPreprocessor(clap=jclap, wav2vec=jw, codec=jcodec, codec_params=jparams,
                              results_folder=str(results / "jax"), **common),
            DataPreprocessor(clap=clap, wav2vec=tw, codec=codec, results_folder=str(results / "port"), **common))


def test_preprocessor_store_matches_jax(tmp_path, wav_folder, tokenizers):
    """One row per readable track (an unreadable file skipped), with the
    CLAP tokens of every 1 s window at a 1 s hop in batches of 2, the
    semantic ids and the coarse / fine codes: each array equal to the JAX
    package's store, uint16, with the same shapes."""
    folder = write_tracks(tmp_path / "tracks")
    (folder / "broken.wav").write_bytes(b"not a wave file")
    jpre, pre = _preprocessors(tokenizers, folder, tmp_path)
    assert jpre.process() == pre.process() == len(TRACKS)
    want, got = JShardedTokenStore(str(tmp_path / "jax")), ShardedTokenStore(str(tmp_path / "port"))
    assert len(got) == len(want) == len(TRACKS)
    fields = ("clap", "semantic", "coarse", "fine")
    for i in range(len(want)):
        for name, g, w in zip(fields, got.get(i, fields), want.get(i, fields)):
            assert g.dtype == w.dtype == np.uint16 and g.shape == w.shape, name
            np.testing.assert_array_equal(g, w, err_msg=name)
    clap_ids, sem, coarse, fine = got.get(0, fields)
    assert clap_ids.shape == (2, N_CLAP_Q) and sem.shape == (1, 19) and coarse.shape == (1, 30, 2)
    assert fine.shape == (1, 30, 2)


def test_preprocessor_restarts_and_shards(tmp_path, wav_folder, tokenizers, one_torch_thread):
    """A rerun writes nothing (rows already stored), replace_existing
    rewrites every row, and two ranks of world 2 write disjoint shards
    (even / odd tracks) whose rows equal the single-rank store's. No track
    is longer than 4 s, so no crop draws from the dataset's generator."""
    kw = dict(max_audio_length_seconds=4)
    _, pre = _preprocessors(tokenizers, wav_folder, tmp_path / "one", **kw)
    assert pre.process() == len(TRACKS)
    assert pre.process() == 0
    calls = []
    _, again = _preprocessors(tokenizers, wav_folder, tmp_path / "one", replace_existing=True, **kw)
    assert again.process(progress=lambda i, n: calls.append((i, n))) == len(TRACKS)
    assert calls == [(i, len(TRACKS)) for i in range(len(TRACKS))]
    for rank in (0, 1):
        _, shard = _preprocessors(tokenizers, wav_folder, tmp_path / "two", rank=rank, world=2, **kw)
        assert shard.process() == 2
    two = tmp_path / "two" / "port"
    assert sorted(p.name for p in two.iterdir()) == ["preprocessed.rank0.db", "preprocessed.rank1.db"]
    one, both = ShardedTokenStore(str(tmp_path / "one" / "port")), ShardedTokenStore(str(two))
    assert sorted(idx for _, idx in both.index) == list(range(len(TRACKS)))
    fields = ("clap", "semantic", "coarse", "fine")
    for i, (si, idx) in enumerate(both.index):
        assert idx % 2 == si
        for a, b in zip(both.get(i, fields), one.shards[0].get(idx, fields)):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# 3. artifacts, artifact_logits and the trackers
# ---------------------------------------------------------------------------


def test_save_predicted_tokens_matches_jax(tmp_path):
    """At most 4 examples of targets, argmax predictions and accuracies: the
    same text file."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((5, 7, CB + 1)).astype(np.float32)
    labels = rng.integers(0, CB + 1, (5, 7))
    labels[0] = logits[0].argmax(-1)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = jartifacts.save_predicted_tokens(jnp.asarray(logits), jnp.asarray(labels), str(tmp_path / "jax"),
                                            "coarse", 3)
    got = artifacts.save_predicted_tokens(_t(logits), _t(labels), str(tmp_path / "port"), "coarse", 3)
    assert Path(got).name == Path(want).name == "coarse.tokens.3.txt"
    assert Path(got).read_text() == Path(want).read_text()
    assert "accuracy:  1.0000" in Path(got).read_text()


@pytest.mark.parametrize("stage,b", [("coarse", 2), ("fine", 5)])
def test_save_reconstructed_wave_matches_jax(tmp_path, tokenizers, stage, b):
    """Predicted (and, for the fine stage, ground-truth coarse) tokens out
    of range clipped into the codebook, at most 4 examples decoded: waves
    within 1e-4 of JAX's decode, written at the codec's rate."""
    (_, _, jcodec, jparams), (_, _, codec) = tokenizers
    # the JAX codec with its apply compiled (JAX's writer calls it eagerly)
    jcodec = types.SimpleNamespace(codebook_size=jcodec.codebook_size, sample_rate=jcodec.sample_rate,
                                   apply=jax.jit(jcodec.apply, static_argnames="method"))
    rng = np.random.default_rng(1)
    pred = rng.integers(0, CB + 1, (b, 12 * 2))
    cond = rng.integers(0, CB, (b, 13 * 2)) if stage == "fine" else None
    want_paths, want = jartifacts.save_reconstructed_wave(
        stage, jnp.asarray(pred), None if cond is None else jnp.asarray(cond), jcodec, jparams, 2, 2,
        str(tmp_path), 4)
    paths, waves = artifacts.save_reconstructed_wave(stage, _t(pred), None if cond is None else _t(cond),
                                                     codec, 2, 2, str(tmp_path), 4)
    assert paths == want_paths == [str(tmp_path / f"{stage}.recon.4.{i}.wav") for i in range(min(b, 4))]
    assert waves.shape == np.asarray(want).shape == (min(b, 4), 12 * 16)
    np.testing.assert_allclose(waves.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    back, sr = audio_io.read_wav(paths[0])
    assert sr == 240 and back.shape == (12 * 16,)
    assert artifacts.save_reconstructed_wave("semantic", _t(pred), None, codec, 2, 2, str(tmp_path), 4) is None


def test_artifact_logits_matches_jax(tmp_path):
    """The final sequence's logits within 1e-4 and its labels equal, on a
    valid batch with a padded conditioning row."""
    jmodel = JTCT(specs=(JSpec(CB, 2), JSpec(CB, 1)), dim=16, depth=1, heads=2, dim_head=8)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(3), [jnp.zeros((1, 6), jnp.int32),
                                                           jnp.zeros((1, 8), jnp.int32)])
    cfg = dict(lr=1e-3, results_folder=str(tmp_path), use_tensorboard=False)
    jtrainer = JStageTrainer(model=jmodel, loss_cfg=JLossConfig((0.5, 1.0)), mesh=make_mesh(dp=1), **cfg)
    trainer = StageTrainer(model=port_model(jmodel, jparams), loss_cfg=StageLossConfig((0.5, 1.0)), **cfg)
    rng = np.random.default_rng(2)
    cond, pred = rng.integers(0, CB, (3, 6)).astype(np.int32), rng.integers(0, CB, (3, 8)).astype(np.int32)
    cond[1, -2:] = -1
    want_logits, want_labels = jtrainer.artifact_logits(jtrainer.init_state(jparams),
                                                        (jnp.asarray(cond), jnp.asarray(pred)), jax.random.PRNGKey(0))
    logits, labels = trainer.artifact_logits(trainer.init_state(), (_t(cond), _t(pred)))
    assert logits.shape == np.asarray(want_logits).shape == (3, 9, CB + 1)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want_labels))


class FakeSink:
    """Stands in for ``wandb`` (``init`` returns a run) and for
    ``torch.utils.tensorboard`` (``SummaryWriter``), recording each call."""

    def __init__(self):
        self.calls = []

    def module(self, name):
        mod = types.ModuleType(name)
        sink = self

        class Run:
            def log(self, data, step):
                sink.calls.append(("wandb", step, data))

        class SummaryWriter:
            def __init__(self, log_dir):
                sink.calls.append(("tb_dir", log_dir))

            def add_scalar(self, tag, value, step):
                sink.calls.append(("tb_scalar", step, tag, value))

            def add_audio(self, tag, snd, step, sample_rate):
                sink.calls.append(("tb_audio", step, tag, tuple(snd.shape), sample_rate))

        mod.init = lambda **kw: sink.calls.append(("wandb_init", kw)) or Run()
        mod.Audio = lambda w, sample_rate, caption: ("audio", len(w), sample_rate, caption)
        mod.SummaryWriter = SummaryWriter
        return mod


def _tiny_trainer(tmp_path, **kw):
    model = TokenConditionedTransformer((TokenSequenceSpec(CB, 2), TokenSequenceSpec(CB, 1)), 16, 1, heads=2,
                                        dim_head=8, generator=torch.Generator().manual_seed(0))
    return StageTrainer(model=model, loss_cfg=StageLossConfig((0.5, 1.0)), results_folder=str(tmp_path),
                        stage_name="fine", **kw)


def test_trackers_receive_scalars_and_audio(tmp_path, monkeypatch):
    """With wandb and tensorboard installed (fakes here), every logged
    scalar reaches both, and log_audio sends each wave; the JSONL log is
    written as always."""
    sink = FakeSink()
    monkeypatch.setitem(sys.modules, "wandb", sink.module("wandb"))
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", sink.module("torch.utils.tensorboard"))
    trainer = _tiny_trainer(tmp_path, use_wandb=True, wandb_run_config={"lr": 0.1})
    trainer.log(3, train_loss=torch.tensor(2.5), step_time_s=0.25)
    trainer.log_audio(3, "fine_recon", torch.zeros(2, 24), 240)
    assert sink.calls[0] == ("tb_dir", str(tmp_path / "tb" / "fine"))
    assert sink.calls[1][0] == "wandb_init" and sink.calls[1][1]["config"] == {"lr": 0.1}
    assert ("tb_scalar", 3, "train_loss", 2.5) in sink.calls and ("tb_scalar", 3, "step_time_s", 0.25) in sink.calls
    assert ("wandb", 3, {"train_loss": 2.5, "step_time_s": 0.25}) in sink.calls
    assert ("tb_audio", 3, "fine_recon.1", (1, 24), 240) in sink.calls
    assert ("wandb", 3, {"fine_recon": [("audio", 24, 240, "fine_recon.0"), ("audio", 24, 240, "fine_recon.1")]}) \
        in sink.calls
    assert json.loads((tmp_path / "fine.log.jsonl").read_text())["train_loss"] == 2.5


def test_trackers_absent_log_nothing(tmp_path, monkeypatch):
    """Without wandb and tensorboard, use_wandb / use_tensorboard set: no
    error, no tracker output, the JSONL log alone."""
    monkeypatch.setitem(sys.modules, "wandb", None)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    trainer = _tiny_trainer(tmp_path, use_wandb=True)
    assert trainer._tb is None and trainer._wandb is None
    trainer.log(0, valid_loss=1.0)
    trainer.log_audio(0, "fine_recon", torch.zeros(1, 8), 240)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["fine.log.jsonl"]


# ---------------------------------------------------------------------------
# 4. the CLIs, --device cpu
# ---------------------------------------------------------------------------


def tiny_model_config(folder: Path, **global_cfg) -> str:
    """tests/test_torch_load.py's doll-house model config (stages of dim 32,
    depth 1, 2 heads; 16-entry codebooks; 4 CLAP quantizers; Encodec at 3
    kbps: 2 coarse + 2 fine quantizers) as JSON; returns its path. (That
    module imports orbax, which takes seconds.)"""
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


def tiny_cli_towers(monkeypatch):
    """The loader's towers at doll-house widths (tests/test_torch_load.py's,
    the k-means 768 wide as the loader draws it), Encodec too (24 kHz, hop
    320, 2 filters), and no cached text tokenizer."""
    monkeypatch.setattr(tconfig, "RobertaConfig", lambda: RobertaConfig(
        vocab_size=300, hidden_size=32, num_hidden_layers=1, num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=80))
    monkeypatch.setattr(tconfig, "HubertConfig", lambda: HubertConfig(
        conv_dim=(16,) * 7, hidden_size=768, num_hidden_layers=1, num_attention_heads=2, intermediate_size=64,
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=16))
    audio = port_cfg(TINY_AUDIO)
    monkeypatch.setattr(tconfig, "audio_config_from_name", lambda name, enable_fusion=False: dataclasses.replace(
        audio, enable_fusion=enable_fusion))
    monkeypatch.setattr(tconfig, "create_encodec_24khz", lambda bandwidth, codebook_size, **kw: EncodecModel(
        num_quantizers=int(bandwidth / 24.0 * 32), codebook_size=codebook_size, dimension=8, n_filters=2, **kw))
    monkeypatch.setitem(sys.modules, "transformers", None)


@pytest.fixture
def cli_env(tmp_path, monkeypatch, one_torch_thread):
    """Doll-house towers and model config (2 s CLAP / semantic windows,
    1 s coarse and fine), the tracks with an unreadable file beside them,
    a training config pointing every trainer at them (batch 2 x accum 2,
    3 steps, results and checkpoints every 2), and wandb and tensorboard
    absent."""
    tiny_cli_towers(monkeypatch)
    monkeypatch.setitem(sys.modules, "wandb", None)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    folder = write_tracks(tmp_path / "tracks", tracks=TRACKS + [(2.5, 16000)])
    (folder / "broken.wav").write_bytes(b"not a wave file")
    tc = json.loads((ROOT / "configs" / "training" / "train_musiclm_fma.json").read_text())
    for stage in ("semantic", "coarse", "fine"):
        tc[f"{stage}_trainer_cfg"].update(folder=str(folder), batch_size=2, grad_accum_every=2, num_train_steps=3,
                                          save_results_every=2, save_model_every=2, lr_warmup=1)
    tc["data_preprocessor_cfg"] = dict(folder=str(folder), results_folder=str(tmp_path / "store"),
                                       max_audio_length_seconds=3)
    (tmp_path / "train.json").write_text(json.dumps(tc))
    args = ["--model_config", tiny_model_config(tmp_path, clap_audio_length_seconds=2.0), "--training_config",
            str(tmp_path / "train.json"), "--device", "cpu", "--seed", "3"]
    return tmp_path, args


def _log(folder: Path, stage: str):
    return [json.loads(line) for line in (folder / f"{stage}.log.jsonl").read_text().splitlines()]


@pytest.mark.parametrize("cli,stage,recon", [(train_semantic_stage, "semantic", None),
                                             (train_coarse_stage, "coarse", 24000),
                                             (train_fine_stage, "fine", 24000)])
def test_train_stage_cli_audio_path(cli_env, cli, stage, recon):
    """On the fly from the tracks (the unreadable file skipped): 3 finite
    train losses, valid metrics and artifacts at steps 0 and 2, a checkpoint
    at step 2 holding the state after 3 steps, and 1 s reconstructions at
    24 kHz for the coarse and fine stages."""
    tmp, args = cli_env
    out = tmp / "results"
    state = cli.main(args + ["--results_folder", str(out), "--num_workers", "1"])
    assert state.step == 3
    recs = _log(out, stage)
    losses = [r["train_loss"] for r in recs if "train_loss" in r]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert [r["step"] for r in recs if "valid_loss" in r] == [0, 2]
    assert all(0 <= r["valid_accuracy"] <= 1 for r in recs if "valid_loss" in r)
    names = sorted(p.name for p in out.iterdir())
    want = [f"{stage}.log.jsonl", f"{stage}.tokens.0.txt", f"{stage}.tokens.2.txt", f"{stage}.transformer.2.ckpt"]
    if recon:
        want += [f"{stage}.recon.{s}.{i}.wav" for s in (0, 2) for i in (0, 1)]
    assert names == sorted(want)
    assert load_checkpoint(str(out / f"{stage}.transformer.2.ckpt"))["step"] == 3
    if recon:
        wave, sr = audio_io.read_wav(str(out / f"{stage}.recon.2.1.wav"))
        assert (sr, len(wave)) == (24000, recon)


def test_train_stage_cli_resume_and_fine_tune(cli_env):
    """Resume: the latest checkpoint's weights and step, then exactly the
    steps left (one, numbered 3). Fine-tune: the checkpoint's weights with a
    fresh optimizer at step 0. --bf16 computes in bfloat16 on float32
    weights."""
    tmp, args = cli_env
    out = tmp / "results"
    args = args + ["--num_workers", "1"]
    first = train_stage.main(args + ["--stage", "fine", "--results_folder", str(out), "--bf16"])
    assert first.model.compute_dtype == torch.bfloat16 and first.model.start_tokens.dtype == torch.float32
    tc = json.loads((tmp / "train.json").read_text())
    tc["fine_trainer_cfg"]["num_train_steps"] = 4
    (tmp / "train.json").write_text(json.dumps(tc))
    resumed = train_stage.main(args + ["--stage", "fine", "--results_folder", str(out),
                                       "--continue_from_dir", str(out)])
    assert resumed.step == 4
    assert [r["step"] for r in _log(out, "fine") if "train_loss" in r] == [0, 1, 2, 3]
    ckpt = find_latest_checkpoint(str(out), "fine.transformer")
    tuned_dir = tmp / "tuned"
    tc["fine_trainer_cfg"]["num_train_steps"] = 0
    (tmp / "train.json").write_text(json.dumps(tc))
    tuned = train_stage.main(args + ["--stage", "fine", "--results_folder", str(tuned_dir), "--fine_tune_from", ckpt])
    assert tuned.step == 0 and tuned.optimizer.count == 0
    saved = load_checkpoint(ckpt)["model"]
    for name, p in tuned.model.state_dict().items():
        assert torch.equal(p, saved[name]), name
