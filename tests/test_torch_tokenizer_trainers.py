"""Port parity, the tokenizer trainers: k-means (the full-batch and the
minibatch fits, inertia), the RVQ's EMA training step (rvq_update,
init_from_batch, ClapQuantized.learn_rvq_step) against the JAX package on the
CPU in float32, with inputs from numpy with a seed; then ClapRVQTrainer and
HubertKmeansTrainer, and the train_clap_rvq, train_hubert_kmeans and
preprocess_data CLIs with ``--device cpu`` at doll-house widths, whose
checkpoints and token store the loaders and train_stage read back.

The JAX package draws its k-means++ starts, RVQ seeds and dead-code samples
from ``jax.random`` and the port from a ``torch.Generator``, so those draws
differ: the deterministic parts are held from JAX's own draws, the random
parts by their properties.
"""

import json
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_musiclm_tpu.models import kmeans as jkmeans
from open_musiclm_tpu.models import rvq as jrvq
from open_musiclm_tpu.models.clap.clap import ClapQuantized as JClapQuantized
from open_musiclm_tpu.testing import N_CLAP_Q
from open_musiclm_tpu.train.tokenizer_trainers import HubertKmeansTrainer as JHubertKmeansTrainer

from open_musiclm_torch import config as tconfig
from open_musiclm_torch import load as tload
from open_musiclm_torch.checkpoint import load_checkpoint
from open_musiclm_torch.cli import preprocess_data, train_clap_rvq, train_hubert_kmeans, train_stage
from open_musiclm_torch.data.tokenstore import ShardedTokenStore
from open_musiclm_torch.convert import rvq_state
from open_musiclm_torch.models import kmeans
from open_musiclm_torch.models import rvq
from open_musiclm_torch.models.clap.clap import ClapQuantized
from open_musiclm_torch.train import tokenizer_trainers
from open_musiclm_torch.train.tokenizer_trainers import ClapRVQTrainer, HubertKmeansTrainer

from tests.test_torch_train_audio import (  # noqa: F401 (cli_env is a fixture)
    TRACKS, cli_env, tiny_cli_towers, tiny_model_config, write_tracks)
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _blobs(seed, n, d, centers=6, spread=0.3):
    """n rows around ``centers`` well-separated points, float32."""
    rng = np.random.default_rng(seed)
    mu = rng.standard_normal((centers, d)) * 4
    return (mu[rng.integers(0, centers, n)] + spread * rng.standard_normal((n, d))).astype(np.float32)


# ---------------------------------------------------------------------------
# 1. k-means
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,d,k,iters", [(300, 8, 16, 5), (64, 4, 32, 3)])
def test_kmeans_fit_matches_jax_from_its_init(monkeypatch, n, d, k, iters):
    """From JAX's own k-means++ start (its kmeans_fit with num_iters=0),
    the port's Lloyd's steps give JAX's centroids within 1e-5; with k close
    to n some clusters empty and keep their place."""
    x = _blobs(n + d, n, d)
    key = jax.random.PRNGKey(k)
    init = np.asarray(jkmeans.kmeans_fit(jnp.asarray(x), k, key, num_iters=0))
    want = np.asarray(jkmeans.kmeans_fit(jnp.asarray(x), k, key, num_iters=iters))
    monkeypatch.setattr(kmeans, "_plus_plus_lite_init", lambda x_, k_, g=None: _t(init))
    got = kmeans.kmeans_fit(_t(x), k, num_iters=iters)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_plus_plus_init_draws_rows_far_apart():
    """k-means++ from a generator: every centroid is a row of x, the same
    seed gives the same start, and on six well-separated blobs six draws
    land in six different blobs."""
    x = _t(_blobs(1, 600, 5, centers=6, spread=0.05))
    a = kmeans._plus_plus_lite_init(x, 6, torch.Generator().manual_seed(3))
    b = kmeans._plus_plus_lite_init(x, 6, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    d2 = torch.cdist(a, x)
    assert (d2.min(dim=1).values == 0).all()
    blob = kmeans.kmeans_predict(x, a)
    assert len(torch.unique(blob)) == 6


def test_minibatch_kmeans_and_inertia_match_jax():
    """From JAX's minibatch init: four count-weighted updates (centroids and
    counts) and the inertia within 1e-5 of JAX's."""
    x = _blobs(2, 400, 6)
    jstate = jkmeans.minibatch_kmeans_init(jnp.asarray(x[:100]), 12, jax.random.PRNGKey(0))
    state = kmeans.KMeansState(_t(jstate.centroids), _t(jstate.counts).float())
    assert state.centroids.shape == (12, 6) and not state.counts.any()
    for i in range(4):
        batch = x[i * 100:(i + 1) * 100]
        jstate = jkmeans.minibatch_kmeans_update(jstate, jnp.asarray(batch))
        state = kmeans.minibatch_kmeans_update(state, _t(batch))
        np.testing.assert_allclose(state.centroids.numpy(), np.asarray(jstate.centroids), **TOL)
        np.testing.assert_allclose(state.counts.numpy(), np.asarray(jstate.counts), **TOL)
    np.testing.assert_allclose(kmeans.kmeans_inertia(_t(x), state.centroids).item(),
                               float(jkmeans.kmeans_inertia(jnp.asarray(x), jstate.centroids)), **TOL)
    init = kmeans.minibatch_kmeans_init(_t(x[:100]), 12, torch.Generator().manual_seed(0))
    assert init.centroids.shape == (12, 6) and init.counts.tolist() == [0.0] * 12


# ---------------------------------------------------------------------------
# 2. the RVQ's EMA training step
# ---------------------------------------------------------------------------


def _initted_state(seed, q=3, k=16, d=8, low=0.0):
    """A seeded JAX RVQState: codebooks, EMA counts in [low, low + 2),
    sums = codes x counts."""
    rng = np.random.default_rng(seed)
    cb = rng.standard_normal((q, k, d)).astype(np.float32)
    cs = (low + 2 * rng.random((q, k))).astype(np.float32)
    return jrvq.RVQState(jnp.asarray(cb), jnp.asarray(cs), jnp.asarray(cb * cs[..., None]), jnp.array(True))


def _residuals(x, codebooks, idx):
    """The residual each quantizer saw: x less the codes before it."""
    out, r = [], x.copy()
    for q in range(codebooks.shape[0]):
        out.append(r)
        r = r - codebooks[q][idx[:, q]]
    return out


def test_rvq_update_matches_jax_without_dead_codes():
    """threshold_ema_dead_code 0, a seeded state: the new codebooks, EMA
    counts and sums, the quantized output and the indices within 1e-5 of
    JAX's (the indices equal) over two steps."""
    jstate = _initted_state(0)
    state = rvq_state(jstate)
    assert bool(state.initted)
    for step in range(2):
        x = np.random.default_rng(10 + step).standard_normal((200, 8)).astype(np.float32)
        jstate, jquant, jidx = jrvq.rvq_update(jstate, jnp.asarray(x), jax.random.PRNGKey(step), decay=0.9)
        state, quant, idx = rvq.rvq_update(state, _t(x), decay=0.9)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        for name, a, b in zip(rvq.RVQState._fields, state, jstate):
            if name == "initted":
                assert bool(a) and bool(b)
            else:
                np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL, err_msg=name)
        np.testing.assert_allclose(quant.numpy(), np.asarray(jquant), **TOL)


def test_rvq_update_dead_codes_reseeded_from_the_residual():
    """threshold_ema_dead_code 0.5 (musiclm_small's): a code whose EMA count
    stays under it is replaced by a row of that quantizer's residual (count
    raised to the threshold, sum = row x count); every live code, count and
    sum equals JAX's within 1e-5."""
    jstate = _initted_state(1, low=0.0)
    x = np.random.default_rng(5).standard_normal((60, 8)).astype(np.float32)
    old = np.asarray(jstate.codebooks)
    jnew, _, jidx = jrvq.rvq_update(jstate, jnp.asarray(x), jax.random.PRNGKey(0), decay=0.95,
                                    threshold_ema_dead_code=0.5)
    new, _, idx = rvq.rvq_update(rvq_state(jstate), _t(x), torch.Generator().manual_seed(0), decay=0.95,
                                 threshold_ema_dead_code=0.5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    counts = np.stack([np.bincount(np.asarray(jidx)[:, q], minlength=16) for q in range(3)])
    sz = np.asarray(jstate.cluster_size) * 0.95 + counts * 0.05
    dead = sz < 0.5
    assert 0 < dead.sum() < dead.size
    resid = _residuals(x, old, np.asarray(jidx))
    for q in range(3):
        live = ~dead[q]
        for a, b in zip(new, jnew):
            if a.ndim > 1:
                np.testing.assert_allclose(a[q].numpy()[live], np.asarray(b)[q][live], **TOL)
        for k in np.flatnonzero(dead[q]):
            row = new.codebooks[q, k].numpy()
            assert np.abs(resid[q] - row).max(axis=1).min() == 0
            assert new.cluster_size[q, k].item() == 0.5
            np.testing.assert_allclose(new.embed_avg[q, k].numpy(), row * 0.5, **TOL)


def test_init_from_batch_residual_falls():
    """The first step of an unseeded state seeds each quantizer by k-means
    over its residual: the residual's mean square falls quantizer by
    quantizer, EMA counts start at one, and fewer rows than codes raise."""
    x = _t(_blobs(3, 256, 8, centers=12))
    state = rvq.init_from_batch(x, 4, 16, torch.Generator().manual_seed(0))
    assert bool(state.initted) and state.codebooks.shape == (4, 16, 8)
    assert torch.equal(state.cluster_size, torch.ones(4, 16)) and torch.equal(state.embed_avg, state.codebooks)
    r, mse = x, [x.square().mean().item()]
    for cb in state.codebooks:
        r = r - cb[rvq._nearest(r, cb)]
        mse.append(r.square().mean().item())
    assert all(b < a for a, b in zip(mse, mse[1:])), mse
    fresh = rvq.rvq_init(4, 16, 8, torch.Generator().manual_seed(1))
    assert not bool(fresh.initted)
    after, quant, _ = rvq.rvq_update(fresh, x, torch.Generator().manual_seed(0))
    assert bool(after.initted) and torch.isfinite(after.codebooks).all()
    assert (quant - x).square().mean() < 0.5 * x.square().mean()
    with pytest.raises(ValueError, match="at least codebook_size"):
        rvq.rvq_update(fresh, x[:15])
    # a state built from codebooks alone (a ResidualVQ import) is not seeded
    assert bool(rvq.rvq_update(rvq.RVQState(fresh.codebooks), x, torch.Generator().manual_seed(0))[0].initted)


def test_learn_rvq_step_matches_jax():
    """ClapQuantized.learn_rvq_step on a seeded state: the new RVQ and the
    quantization MSE within 1e-5 of JAX's; the port's step leaves the
    ClapQuantized it was called on as it was."""
    jstate = _initted_state(2, q=2, k=8, d=16)
    emb = np.random.default_rng(7).standard_normal((40, 16)).astype(np.float32)
    jclap, jmse = JClapQuantized(model=None, params=None, rvq=jstate).learn_rvq_step(
        jnp.asarray(emb), jax.random.PRNGKey(0), decay=0.8)
    clap = ClapQuantized(model=None, rvq=rvq_state(jstate))
    new, mse = clap.learn_rvq_step(_t(emb), decay=0.8)
    np.testing.assert_allclose(mse.item(), float(jmse), **TOL)
    np.testing.assert_allclose(new.rvq.codebooks.numpy(), np.asarray(jclap.rvq.codebooks), **TOL)
    assert torch.equal(clap.rvq.codebooks, _t(jstate.codebooks))


# ---------------------------------------------------------------------------
# 3. the trainers and their CLIs
# ---------------------------------------------------------------------------


def test_hubert_kmeans_fit_matches_jax(tmp_path, monkeypatch):
    """HubertKmeansTrainer.fit from JAX's k-means++ start: the same numpy
    shuffles and minibatches give JAX's centroids and counts within 1e-5."""
    feats = _blobs(4, 700, 8, centers=10)
    key = jax.random.PRNGKey(1)
    want = JHubertKmeansTrainer.fit(types.SimpleNamespace(n_clusters=12, fit_batch_size=100), feats, key)
    jinit = jkmeans.minibatch_kmeans_init(jnp.asarray(feats[:100]), 12, key)
    monkeypatch.setattr(tokenizer_trainers, "minibatch_kmeans_init", lambda x0, k, g=None: kmeans.KMeansState(
        _t(jinit.centroids), torch.zeros(k)))
    w2v = torch.nn.Module()
    w2v.register_buffer("centroids", torch.zeros(12, 8))
    trainer = HubertKmeansTrainer(hubert_kmeans=w2v, results_folder=str(tmp_path),
                                  n_clusters=12, fit_batch_size=100)
    got = trainer.fit(feats)
    np.testing.assert_allclose(got.centroids.numpy(), np.asarray(want.centroids), **TOL)
    np.testing.assert_allclose(got.counts.numpy(), np.asarray(want.counts), **TOL)


@pytest.fixture
def tok_env(tmp_path, monkeypatch, one_torch_thread):
    """Doll-house towers and model config (a 4 x 16 RVQ over 512-d CLAP
    embeddings, a 16 x 768 k-means), the seeded tracks, and a training
    config pointing both tokenizer trainers at them."""
    tiny_cli_towers(monkeypatch)
    folder = write_tracks(tmp_path / "tracks")
    tc = json.loads((ROOT / "configs" / "training" / "train_musiclm_fma.json").read_text())
    tc["clap_rvq_trainer_cfg"].update(folder=str(folder), num_train_steps=3, batch_size=4, accumulate_batches=4,
                                      save_model_every=2, save_results_every=1)
    tc["hubert_kmeans_trainer_cfg"].update(folder=str(folder), feature_extraction_num_steps=3,
                                           feature_extraction_batch_size=2)
    (tmp_path / "train.json").write_text(json.dumps(tc))
    model_config = tiny_model_config(tmp_path, clap_audio_length_seconds=2.0)
    args = ["--model_config", model_config, "--training_config", str(tmp_path / "train.json"), "--device", "cpu",
            "--seed", "2"]
    return tmp_path, args, tconfig.load_model_config(model_config)


def test_train_clap_rvq_cli_writes_loadable_checkpoints(tok_env, capsys):
    """3 steps of batch 4 x accumulate 4 (16 embeddings, one per code): the
    RVQ seeded on step 0, a finite rvq_mse logged each step, checkpoints at
    steps 0 and 2 (save_model_every 2, and the last step); load_rvq reads
    clap.rvq.2.ckpt back equal, and create_musiclm_from_config takes it."""
    tmp, args, mc = tok_env
    out = tmp / "rvq"
    state = train_clap_rvq.main(args + ["--results_folder", str(out)])
    assert bool(state.initted) and state.codebooks.shape == (4, 16, 512)
    logs = [json.loads(line.replace("'", '"')) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{'step'")]
    assert [r["step"] for r in logs] == [0, 1, 2] and np.isfinite([r["rvq_mse"] for r in logs]).all()
    assert sorted(p.name for p in out.iterdir()) == ["clap.rvq.0.ckpt", "clap.rvq.2.ckpt"]
    back = tload.load_rvq(str(out / "clap.rvq.2.ckpt"), mc, None, device="cpu")
    for name, a, b in zip(rvq.RVQState._fields, back, state):
        assert torch.equal(a, b), name
    musiclm = tload.create_musiclm_from_config(mc, rvq_path=str(out / "clap.rvq.2.ckpt"), device="cpu")
    assert torch.equal(musiclm.clap.rvq.codebooks, state.codebooks)


def test_train_hubert_kmeans_cli_writes_loadable_checkpoint(tok_env):
    """3 batches of 2 clips of 2 s (99 frames each): kmeans.ckpt with 16
    centroids and a finite inertia, read back by load_kmeans and taken by
    create_musiclm_from_config as the semantic codebook."""
    tmp, args, mc = tok_env
    out = tmp / "km"
    centroids = train_hubert_kmeans.main(args + ["--results_folder", str(out)])
    assert centroids.shape == (16, 768) and torch.isfinite(centroids).all()
    tree = load_checkpoint(str(out / "kmeans.ckpt"))
    assert torch.equal(tree["centroids"], centroids) and np.isfinite(tree["inertia"].item())
    assert torch.equal(tload.load_kmeans(str(out / "kmeans.ckpt"), mc, None), centroids)
    musiclm = tload.create_musiclm_from_config(mc, kmeans_path=str(out / "kmeans.ckpt"), device="cpu")
    assert torch.equal(musiclm.wav2vec.centroids, centroids)


def test_trainers_update_their_towers(tok_env):
    """ClapRVQTrainer leaves the trained RVQ on the ClapQuantized it was
    given, and HubertKmeansTrainer its codebook on the HuBERT it was given,
    so that later tokenizing uses them."""
    tmp, _, mc = tok_env
    musiclm = tload.create_musiclm_from_config(mc, seed=1, device="cpu")
    rng = np.random.default_rng(0)

    def clips(n, t):
        while True:
            yield (0.2 * rng.standard_normal((n, t))).astype(np.float32)

    state = ClapRVQTrainer(clap=musiclm.clap, results_folder=str(tmp / "r"), num_train_steps=1,
                           accumulate_batches=2).train(clips(8, 8000), torch.Generator().manual_seed(0))
    assert musiclm.clap.rvq is state and sorted(p.name for p in (tmp / "r").iterdir()) == ["clap.rvq.0.ckpt"]
    cents = HubertKmeansTrainer(hubert_kmeans=musiclm.wav2vec, results_folder=str(tmp / "k"),
                                feature_extraction_num_steps=2, n_clusters=16, fit_batch_size=40).train(
        clips(2, 16000), torch.Generator().manual_seed(0))
    assert torch.equal(musiclm.wav2vec.centroids, cents)
    assert musiclm.wav2vec(torch.zeros(1, 16000)).max().item() < 16


def test_preprocess_then_train_on_the_store(cli_env):
    """preprocess_data writes one row per readable track; a rerun writes
    none; --filter_fma drops the tracks tracks.csv marks; then the fine stage
    trains 3 steps on the store (use_preprocessed_data)."""
    tmp, args = cli_env
    assert preprocess_data.main(args) == len(TRACKS) + 1
    assert preprocess_data.main(args) == 0
    store = ShardedTokenStore(str(tmp / "store"))
    assert len(store) == len(TRACKS) + 1
    clap_ids, sem, coarse, fine = store.get(0, ("clap", "semantic", "coarse", "fine"))
    assert clap_ids.shape == (2, N_CLAP_Q) and sem.shape == (1, 149)
    assert coarse.shape == (1, 225, 2) and fine.shape == (1, 225, 2)
    tc = json.loads((tmp / "train.json").read_text())
    meta = tmp / "meta"
    meta.mkdir()
    (meta / "tracks.csv").write_text(",track,track,track\ntrack_id,genres_all,listens,favorites\n1,[38],5,0\n")
    tc["data_preprocessor_cfg"].update(metadata_folder=str(meta), results_folder=str(tmp / "filtered"))
    tc["fine_trainer_cfg"].update(folder=str(tmp / "store"), use_preprocessed_data=True)
    (tmp / "train.json").write_text(json.dumps(tc))
    (tmp / "tracks" / "000001.mp3").write_bytes(b"")
    # 000001.mp3 (unreadable) dropped, rank 1 of 2 takes the 2nd, 4th and 6th of the other six files
    assert preprocess_data.main(args + ["--filter_fma", "--rank", "1", "--world", "2"]) == 3
    assert [p.name for p in (tmp / "filtered").iterdir()] == ["preprocessed.rank1.db"]
    out = tmp / "results"
    state = train_stage.main(args + ["--stage", "fine", "--results_folder", str(out), "--num_workers", "2"])
    assert state.step == 3
    assert sorted(p.name for p in out.iterdir()) == ["fine.log.jsonl", "fine.tokens.0.txt", "fine.tokens.2.txt",
                                                     "fine.transformer.2.ckpt"]


def test_training_modules_import_no_jax():
    """The data path, the preprocessor, the trainers, artifacts and the
    five training CLIs import with jax, flax and the JAX package blocked."""
    blocked = ("jax", "jaxlib", "flax", "optax", "orbax", "open_musiclm_tpu")
    code = (
        "import sys\n"
        f"for name in {blocked!r}: sys.modules[name] = None\n"
        "import open_musiclm_torch.data.dataset, open_musiclm_torch.data.pipeline, open_musiclm_torch.data.fma\n"
        "import open_musiclm_torch.data.preprocess, open_musiclm_torch.train.artifacts\n"
        "import open_musiclm_torch.train.tokenizer_trainers, open_musiclm_torch.models.kmeans\n"
        "from open_musiclm_torch.cli import train_stage, train_semantic_stage, train_coarse_stage\n"
        "from open_musiclm_torch.cli import train_fine_stage, preprocess_data, train_clap_rvq, train_hubert_kmeans\n"
        "assert not any(m.split('.')[0] in ('jax', 'flax', 'open_musiclm_tpu') for m, v in sys.modules.items()"
        " if v is not None)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
