"""Port parity, data parallel training: open_musiclm_torch.parallel
(initialize_distributed, the dp Mesh, shard_batch), the data-parallel
StageTrainer and the rank shards of the data path, on the CPU.

Two gloo ranks run as spawned processes (tests/torch_dp_workers.py) that
join through a ``file://`` store in the test's tmp_path, each join bounded
by a timeout. Their parameters after two steps are held to a one-process
run on the whole batch and to the JAX package's StageTrainer on a dp=2
mesh of the conftest's virtual CPU devices, within 1e-5. As in
tests/test_torch_train.py's trainer test, Adam's eps is 1e-2 on every side
(never in the port), so that an element whose gradient is rounding noise
moves by ~lr x 1e-5 and not by +-lr; dropout and the forgetful mask are
off (each rank draws its own, so no draw can equal one process's).
"""

import ctypes
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_musiclm_tpu.core.sequence import TokenSequenceSpec as JSpec
from open_musiclm_tpu.models.token_cond import StageLossConfig as JLossConfig
from open_musiclm_tpu.models.token_cond import TokenConditionedTransformer as JTCT
from open_musiclm_tpu.parallel.mesh import make_mesh as jmake_mesh
from open_musiclm_tpu.train.optimizer import make_optimizer
from open_musiclm_tpu.testing import N_CLAP_Q, TINY_AUDIO
from open_musiclm_tpu.train.trainer import StageTrainer as JStageTrainer

from open_musiclm_torch import config as tconfig
from open_musiclm_torch.convert import stage_state_dict
from open_musiclm_torch.data.dataset import PreprocessedDataset, SoundDataset, batch_iterator
from open_musiclm_torch.data.pipeline import stage_ds_config, tokenizing_iterator
from open_musiclm_torch.data.tokenstore import writer_for_rank
from open_musiclm_torch.models.clap.clap import CLAP, ClapQuantized
from open_musiclm_torch.models.encodec import EncodecModel
from open_musiclm_torch.models.hubert import HubertConfig, HubertModel, HubertWithKmeans
from open_musiclm_torch.models.rvq import rvq_init
from open_musiclm_torch.models.token_cond import StageLossConfig
from open_musiclm_torch.parallel import distributed
from open_musiclm_torch.parallel.mesh import Mesh, make_mesh, shard_batch
from open_musiclm_torch.train.trainer import StageTrainer

from tests.test_torch_audio_prompt import TINY_HUBERT
from tests.test_torch_clap import TEXT_CFG
from tests.test_torch_htsat import port_cfg
from tests.test_torch_train_audio import GLOBAL, write_tracks
from tests.torch_dp_workers import join_ranks, start_ranks, tiny_stage, trainer_rank
from tests.torch_threads import one_torch_thread  # noqa: F401

CB = 16
HP = dict(lr=1e-3, wd=1e-2, lr_warmup=2, max_grad_norm=0.5, grad_accum_every=2,
          loss_cfg=None)
EPS = 1e-2
DIST_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT", "COORDINATOR_ADDRESS",
            "NUM_PROCESSES", "PROCESS_ID")


@pytest.fixture
def no_dist_env(monkeypatch):
    for name in DIST_ENV:
        monkeypatch.delenv(name, raising=False)


# ---------------------------------------------------------------------------
# 1. initialize_distributed and the mesh
# ---------------------------------------------------------------------------


def test_initialize_distributed_is_a_no_op_in_one_process(no_dist_env):
    assert distributed.initialize_distributed("cpu") is False
    assert distributed.process_info() == {"rank": 0, "world_size": 1, "local_rank": 0, "backend": None}
    assert distributed.is_main_process()
    assert make_mesh() == Mesh() and make_mesh(dp=1) == Mesh()


@pytest.mark.parametrize("env", [{"RANK": "0"}, {"NUM_PROCESSES": "2"}])
def test_initialize_distributed_needs_rank_and_world(no_dist_env, monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="rank"):
        distributed.initialize_distributed("cpu")


def test_initialize_distributed_on_cuda_without_a_card_raises(no_dist_env, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        distributed.initialize_distributed("cuda")


def test_make_mesh_refuses_tp_and_a_dp_without_ranks(no_dist_env):
    """A tp (or a dp) axis needs a process group of dp x tp ranks."""
    with pytest.raises(ValueError, match="tp=2"):
        make_mesh(tp=2)
    with pytest.raises(ValueError, match="dp=2"):
        make_mesh(dp=2)
    with pytest.raises(ValueError, match="at least one rank"):
        make_mesh(tp=0)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_shard_batch_takes_the_ranks_rows(world):
    x = torch.arange(8 * 3).reshape(8, 3)
    acc = torch.arange(2 * 8 * 5).reshape(2, 8, 5)
    got = [shard_batch(Mesh(None, r, world), (x, x.numpy()), batch_axis=0) for r in range(world)]
    assert torch.equal(torch.cat([g[0] for g in got]), x)
    per = 8 // world
    for r, (rows, rows_np) in enumerate(got):
        assert torch.equal(rows, x[r * per:(r + 1) * per])
        np.testing.assert_array_equal(rows_np, rows.numpy())
    got = [shard_batch(Mesh(None, r, world), acc, batch_axis=1) for r in range(world)]
    assert torch.equal(torch.cat(got, dim=1), acc)
    with pytest.raises(ValueError, match="split"):
        shard_batch(Mesh(None, 0, 3), x)


def test_rank_seed_is_the_seed_in_one_process():
    assert Mesh().rank_seed(7) == 7


# ---------------------------------------------------------------------------
# 2. two gloo ranks against one process and the JAX dp=2 trainer
# ---------------------------------------------------------------------------


def _token_batches(seed, accum, batch, cond_len=6, pred_len=8):
    rng = np.random.default_rng(seed)
    cond = rng.integers(0, CB, (accum, batch, cond_len)).astype(np.int64)
    cond[:, 0, -1] = -1
    cond[:, 3, -2] = -1
    pred = rng.integers(0, CB, (accum, batch, pred_len)).astype(np.int64)
    return torch.from_numpy(cond), torch.from_numpy(pred)


def test_two_rank_trainer_matches_one_process_and_jax(tmp_path, no_dist_env):
    """Two steps at b4 x accum 2 on two ranks (b2 each): parameters within
    1e-5 of the one-process run and of JAX's StageTrainer(mesh dp=2); the
    logged losses, the eval loss and accuracy and the gathered artifact
    logits equal the one-process ones within 1e-5; rank 0 alone writes the
    log and the checkpoint, which both ranks read back; a flag set on rank 1
    reaches rank 0 through ``Mesh.any``; the ranks' seeds differ."""
    jmodel = JTCT(specs=(JSpec(CB, 2), JSpec(CB, 1)), dim=32, depth=2, heads=2, dim_head=16)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0), [jnp.zeros((1, 6), jnp.int32),
                                                           jnp.zeros((1, 8), jnp.int32)])
    sd = stage_state_dict(jax.device_get(jparams), 2, jmodel.depth)
    weights = (0.5, 1.0)
    hp = dict(HP, loss_cfg=StageLossConfig(weights, mask_prob=0.0))
    batches = [_token_batches(step, 2, 4) for step in range(2)]
    valid = tuple(b[0] for b in _token_batches(9, 1, 4))
    torch.save({"state_dict": sd, "hp": hp, "eps": EPS, "batches": batches, "valid": valid},
               tmp_path / "inputs.pt")
    procs = start_ranks(trainer_rank, 2, (str(tmp_path / "store"), str(tmp_path)))

    # one process on the whole batch
    model = tiny_stage(0)
    model.load_state_dict(sd)
    trainer = StageTrainer(model=model, results_folder=str(tmp_path / "one"), stage_name="test",
                           use_tensorboard=False, save_model_every=0, **hp)
    state = trainer.init_state()
    state.optimizer.eps = EPS
    losses = []
    for b in batches:
        state, loss = trainer.train_step(state, b)
        losses.append(loss.item())
    vloss, vacc = trainer.eval_step(state, valid)
    logits, labels = trainer.artifact_logits(state, valid)

    # the JAX package on a dp=2 mesh
    jtrainer = JStageTrainer(model=jmodel, loss_cfg=JLossConfig(weights, mask_prob=0.0), mesh=jmake_mesh(dp=2),
                             use_tensorboard=False, results_folder=str(tmp_path / "jax"),
                             **{k: v for k, v in HP.items() if k != "loss_cfg"})
    jtrainer.optimizer = make_optimizer(1e-3, 1e-2, warmup_steps=2, max_grad_norm=0.5, eps=EPS)
    jstate = jtrainer.init_state(jparams)
    for step, b in enumerate(batches):
        jstate, _ = jtrainer.train_step(jstate, tuple(jnp.asarray(t.numpy().astype(np.int32)) for t in b),
                                        jax.random.PRNGKey(step))
    want_jax = stage_state_dict(jax.device_get(jstate.params), 2, jmodel.depth)

    join_ranks(procs, timeout=180)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]

    for r, got in enumerate(ranks):
        assert got["step"] == 2 and got["resumed"] and got["any"]
        for name, p in model.state_dict().items():
            np.testing.assert_allclose(got["params"][name].numpy(), p.numpy(), atol=1e-5, rtol=0,
                                       err_msg=f"rank {r} vs one process: {name}")
            np.testing.assert_allclose(got["params"][name].numpy(), want_jax[name].numpy(), atol=1e-5, rtol=0,
                                       err_msg=f"rank {r} vs JAX dp=2: {name}")
        np.testing.assert_allclose(got["eval"], (vloss.item(), vacc.item()), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["logits"].numpy(), logits.numpy(), atol=1e-5, rtol=0)
        assert torch.equal(got["labels"], labels)
    assert ranks[0]["seed"] != ranks[1]["seed"]

    log = (tmp_path / "dp" / "test.log.jsonl").read_text().splitlines()
    logged = [json.loads(line)["train_loss"] for line in log]
    np.testing.assert_allclose(logged, losses, rtol=1e-5)
    assert sorted(p.name for p in (tmp_path / "dp").iterdir()) == ["test.log.jsonl", "test.transformer.1.ckpt"]


# ---------------------------------------------------------------------------
# 3. the data path's rank shards
# ---------------------------------------------------------------------------


def _write_store(folder, n_tracks, seconds=12, seed=0):
    rng = np.random.RandomState(seed)
    writer = writer_for_rank(str(folder), 0, 1)
    for i in range(n_tracks):
        s = seconds + i % 3  # lengths differ, so the crop draws do too
        clap = rng.randint(0, 100, (s - 10 + 1, 12, 1)).astype(np.uint16)
        sem = rng.randint(0, 100, (1, s * 50 - 1)).astype(np.uint16)
        coarse = rng.randint(0, 100, (1, s * 75, 3)).astype(np.uint16)
        fine = rng.randint(0, 100, (1, s * 75, 5)).astype(np.uint16)
        writer.put(i, f"t{i}.wav", clap, sem, coarse, fine)


def _rank_batches(make_dataset, batch, world, steps, **kw):
    its = [batch_iterator(make_dataset(), batch, num_workers=1, seed=3, rank=r, world=world, **kw)
           for r in range(world)]
    try:
        return [[next(it) for it in its] for _ in range(steps)]
    finally:
        for it in its:
            it.close()


@pytest.mark.parametrize("stage", ["semantic", "coarse", "fine"])
@pytest.mark.parametrize("world", [2, 4])
def test_rank_store_batches_put_together_equal_one_process(tmp_path, stage, world):
    _write_store(tmp_path, 7)

    def make():
        return PreprocessedDataset(folder=str(tmp_path), stage=stage, seed=5)

    one = _rank_batches(make, 4, 1, 5)
    split = _rank_batches(make, 4, world, 5)
    for (want,), parts in zip(one, split):
        for i, w in enumerate(want):
            np.testing.assert_array_equal(np.concatenate([p[i] for p in parts]), w)


@pytest.fixture(scope="module")
def wav_folder(tmp_path_factory):
    return write_tracks(tmp_path_factory.mktemp("tracks"))


def test_rank_sound_batches_put_together_equal_one_process(wav_folder):
    kw = dict(max_length_seconds=(2.0, 1.0), target_sample_hz=(8000, 16000), normalize=(False, True))

    def make():
        return SoundDataset(folder=str(wav_folder), seed=4, **kw)

    one = _rank_batches(make, 4, 1, 4, flatten_token_batches=False)
    split = _rank_batches(make, 4, 2, 4, flatten_token_batches=False)
    for (want,), parts in zip(one, split):
        for i, w in enumerate(want):
            np.testing.assert_array_equal(np.concatenate([p[i] for p in parts]), w)


def test_sound_dataset_skip_draws_what_getitem_draws(wav_folder):
    ds = SoundDataset(folder=str(wav_folder), seed=2, max_length_seconds=(2.0, 1.0),
                      target_sample_hz=(8000, 16000), normalize=(False, True))
    twin = SoundDataset(folder=str(wav_folder), seed=2, max_length_seconds=(2.0, 1.0),
                        target_sample_hz=(8000, 16000), normalize=(False, True))
    for i in range(len(ds)):
        ds[i]
        twin.skip(i)
        assert ds._rng.getstate() == twin._rng.getstate()


def _have(lib):
    try:
        ctypes.CDLL(lib)
    except OSError:
        return False
    return True


HAVE_MP3 = _have("libmpg123.so.0") and _have("libmp3lame.so.0")


def _encode_mp3(path, samples, sr, *, tagged):
    """Mono CBR 64 kbit/s MP3 through libmp3lame; ``tagged`` writes the
    LAME tag (encoder delay and padding: the gapless trim) over the first
    frame, as a finished encoder does."""
    lame = ctypes.CDLL("libmp3lame.so.0")
    lame.lame_init.restype = ctypes.c_void_p
    h = ctypes.c_void_p(lame.lame_init())
    lame.lame_set_in_samplerate(h, sr)
    lame.lame_set_num_channels(h, 1)
    lame.lame_set_mode(h, 3)
    lame.lame_set_brate(h, 64)
    assert lame.lame_init_params(h) >= 0
    fp, up = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_ubyte)
    pcm = np.ascontiguousarray(samples, np.float32)
    out = np.empty(2 * len(pcm) + 14400, np.uint8)
    n = lame.lame_encode_buffer_ieee_float(h, pcm.ctypes.data_as(fp), pcm.ctypes.data_as(fp), len(pcm),
                                           out.ctypes.data_as(up), len(out))
    n += lame.lame_encode_flush(h, out[n:].ctypes.data_as(up), len(out) - n)
    tag = np.empty(4096, np.uint8)
    n_tag = lame.lame_get_lametag_frame(h, tag.ctypes.data_as(up), len(tag)) if tagged else 0
    lame.lame_close(h)
    out = out[:n]
    out[:n_tag] = tag[:n_tag]
    Path(path).write_bytes(out.tobytes())


def _write_compressed(folder, seed=0):
    """FLAC and MP3 tracks (1.3-3.1 s at 8-48 kHz, the MP3s tagged and not)."""
    from tests.test_compressed_audio import write_flac

    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i, sec in enumerate((1.3, 2.2, 3.1)):
        write_flac(str(folder / f"f{i}.flac"), [(rng.randn(int(sec * 8000)) * 3000).astype(int).tolist()],
                   sr=8000, block=4096)
    if HAVE_MP3:
        for i, (sec, sr, tagged) in enumerate(((1.7, 16000, True), (2.71, 44100, False), (3.05, 48000, True))):
            t = np.arange(int(sec * sr)) / sr
            sig = 0.3 * np.sin(2 * np.pi * (200 + 50 * i) * t) + 0.05 * rng.randn(len(t))
            _encode_mp3(folder / f"m{i}.mp3", sig, sr, tagged=tagged)
    return folder


@pytest.fixture(scope="module")
def compressed_folder(tmp_path_factory):
    return _write_compressed(tmp_path_factory.mktemp("compressed"))


def test_audio_info_is_read_audios_length(compressed_folder, wav_folder):
    """audio_info's (frames, rate), from headers alone, equal what
    read_audio decodes: WAV, FLAC, MP3 with and without the gapless tag."""
    from open_musiclm_torch.data.audio_io import audio_info, read_audio

    files = sorted(compressed_folder.iterdir()) + sorted(wav_folder.glob("*.wav"))[:2]
    assert {f.suffix for f in files} == ({".flac", ".mp3", ".wav"} if HAVE_MP3 else {".flac", ".wav"})
    for f in files:
        data, sr = read_audio(str(f))
        assert audio_info(str(f)) == (data.shape[0], sr), f.name


def test_sound_dataset_skip_decodes_no_compressed_samples(compressed_folder, monkeypatch):
    """skip on FLAC and MP3 draws what __getitem__ draws, with the decoder
    unreachable: the ranks split the decode of a global batch."""
    from open_musiclm_torch.data import audio_io, dataset as dataset_mod

    kw = dict(max_length_seconds=(1.0, 0.5), target_sample_hz=(8000, 16000), normalize=(False, True),
              ignore_load_errors=False)
    ds = SoundDataset(folder=str(compressed_folder), seed=7, **kw)
    twin = SoundDataset(folder=str(compressed_folder), seed=7, **kw)
    items = [ds[i] for i in range(len(ds))]

    def no_decode(*a, **k):
        raise AssertionError("skip decoded samples")

    monkeypatch.setattr(dataset_mod, "read_audio", no_decode)
    monkeypatch.setattr(audio_io, "read_audio", no_decode)
    monkeypatch.setattr(audio_io, "_read_via", no_decode)
    for i in range(len(twin)):
        twin.skip(i)
    assert ds._rng.getstate() == twin._rng.getstate() and len(items) == len(twin)


@pytest.fixture(scope="module")
def tokenizers():
    """The port's doll-house tokenizers (tests/test_torch_train_audio.py's
    geometry), seeded: CLAP with HTSAT at 8 kHz and a 4 x 16 RVQ, HuBERT at
    160 Hz with a 16-entry k-means, Encodec at 240 Hz."""
    g = torch.Generator().manual_seed(2)
    model = CLAP(TEXT_CFG, joint_embed_shape=16, audio_cfg=port_cfg(TINY_AUDIO), generator=g).eval()
    clap = ClapQuantized(model=model, rvq=rvq_init(N_CLAP_Q, CB, 16, generator=g), num_quantizers=N_CLAP_Q,
                         codebook_size=CB, sample_rate=TINY_AUDIO.sample_rate, clip_samples=TINY_AUDIO.clip_samples)
    hubert = HubertModel(HubertConfig(**TINY_HUBERT), generator=g).eval()
    wav2vec = HubertWithKmeans(hubert, torch.randn(CB, 32, generator=g), embed_layer=1, target_sample_hz=160,
                               seq_len_multiple_of=16, output_hz=10).eval()
    codec = EncodecModel(sample_rate=240, ratios=(4, 4), num_quantizers=4, codebook_size=CB, dimension=8,
                         n_filters=2, generator=g).eval()
    return clap, wav2vec, codec


@pytest.mark.parametrize("stage", ["semantic", "coarse", "fine"])
def test_rank_tokenizing_iterator_puts_together_equal_one_process(tokenizers, wav_folder, stage):
    """Each rank tokenizes its own rows: the ranks' token batches put
    together equal one process's (the doll-house towers are row-independent
    on the CPU)."""
    clap, wav2vec, codec = tokenizers
    g = tconfig.GlobalConfig(**GLOBAL)

    def tokens(world, rank):
        ds = SoundDataset(folder=str(wav_folder), seed=6, **stage_ds_config(stage, clap, wav2vec, codec, g))
        audio = batch_iterator(ds, 4, num_workers=1, seed=1, rank=rank, world=world, flatten_token_batches=False)
        try:
            it = tokenizing_iterator(stage, audio, clap, wav2vec, codec, num_coarse_quantizers=2, accum=2)
            return next(it)
        finally:
            audio.close()

    want = tokens(1, 0)
    parts = [tokens(2, r) for r in range(2)]
    for i, w in enumerate(want):
        assert torch.equal(torch.cat([p[i] for p in parts], dim=1), w), f"sequence {i}"


def test_rank_batches_refuse_an_uneven_split(tmp_path):
    _write_store(tmp_path, 3)
    it = batch_iterator(PreprocessedDataset(folder=str(tmp_path), stage="coarse"), 3, rank=0, world=2)
    with pytest.raises(ValueError, match="split"):
        next(it)


def test_new_training_modules_import_no_jax():
    """parallel/, train/clip_loss.py, train/roofline.py, the roofline CLI and
    the rank processes' module import with jax, flax, optax, orbax and the
    JAX package blocked."""
    import subprocess
    import sys

    blocked = ("jax", "jaxlib", "flax", "optax", "orbax", "open_musiclm_tpu")
    code = (
        "import sys\n"
        f"for name in {blocked!r}: sys.modules[name] = None\n"
        "import open_musiclm_torch.parallel.distributed, open_musiclm_torch.parallel.mesh\n"
        "import open_musiclm_torch.train.clip_loss, open_musiclm_torch.train.roofline\n"
        "import open_musiclm_torch.cli.roofline_train, open_musiclm_torch.cli.train_stage\n"
        "import tests.torch_dp_workers\n"
        f"assert not any(sys.modules.get(n) for n in {blocked!r})\n"
    )
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
