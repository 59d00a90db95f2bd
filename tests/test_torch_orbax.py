"""The port reads the JAX package's orbax checkpoints (open_musiclm_torch/orbax_io.py).

read_orbax is held bit for bit, with the same structure, against
orbax.checkpoint.StandardCheckpointer().restore on directories written by
the JAX package's save_checkpoint, by tensorstore (a chunk grid, absent
chunks, B+tree nodes above the leaves, several data files), without OCDBT,
and without the root manifest; its refusals and a missing libzstd raise.
Then the loaders: the doll-house MusicLM the JAX trainers wrote
(tests/torch_fixtures/orbax_dollhouse/, tests/orbax_fixture.py) through the
port's create_musiclm_from_config against JAX's (teacher-forced logits,
greedy codes), a JAX TrainState resumed by StageTrainer.load (adam and the
masked adamw) against JAX's next step, train_stage's --continue_from_dir
and --fine_tune_from on JAX directories, the fixture's expected.npz
recomputed with JAX, and phase 14's checks of chip_smoke.py on the CPU.
"""

import dataclasses
import json
import shutil
from pathlib import Path

import flax.linen
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch

from open_musiclm_tpu import load as jload
from open_musiclm_tpu.checkpoint import save_checkpoint as jax_save
from open_musiclm_tpu.config import load_model_config as j_load_model_config
from open_musiclm_tpu.core.sequence import TokenSequenceSpec as JSpec
from open_musiclm_tpu.models.clap.clap import CLAP as JCLAP
from open_musiclm_tpu.models.encodec import EncodecModel as JEncodec
from open_musiclm_tpu.models.hubert import HubertConfig as JHubertConfig
from open_musiclm_tpu.models.hubert import HubertModel as JHubertModel
from open_musiclm_tpu.models.token_cond import StageLossConfig as JLossConfig
from open_musiclm_tpu.models.token_cond import TokenConditionedTransformer as JTCT
from open_musiclm_tpu.parallel.mesh import make_mesh
from open_musiclm_tpu.testing import TINY_AUDIO, TINY_TEXT
from open_musiclm_tpu.train.optimizer import make_optimizer
from open_musiclm_tpu.train.trainer import StageTrainer as JStageTrainer

import chip_smoke
from open_musiclm_torch import config as tconfig
from open_musiclm_torch import load as tload
from open_musiclm_torch import orbax_io
from open_musiclm_torch.checkpoint import find_latest_checkpoint, save_checkpoint
from open_musiclm_torch.cli import train_stage
from open_musiclm_torch.convert import stage_state_dict
from open_musiclm_torch.models.token_cond import StageLossConfig
from open_musiclm_torch.orbax_io import is_orbax_dir, read_orbax
from open_musiclm_torch.train.trainer import StageTrainer

from tests import orbax_fixture as fx
from tests.test_torch_load import GREEDY, TINY_HUBERT, _tiny_towers
from tests.test_torch_train import port_model
from tests.torch_threads import one_torch_thread  # noqa: F401

CB = 16


def restore(path):
    return ocp.StandardCheckpointer().restore(Path(path).absolute())


def assert_same(got, want, where="tree"):
    """Bit for bit and the same structure: dict keys in the same order,
    lists, None, Python scalars, arrays of the same dtype and shape
    (bfloat16: the port's torch.bfloat16 tensor against ml_dtypes')."""
    if isinstance(want, np.ndarray) and want.dtype == ml_dtypes.bfloat16:
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, where
        assert tuple(got.shape) == want.shape, where
        assert np.array_equal(got.view(torch.int16).numpy(), want.view(np.int16)), where
        return
    assert type(got) is type(want), f"{where}: {type(got).__name__} against {type(want).__name__}"
    if isinstance(want, dict):
        assert list(got) == list(want), f"{where}: keys {list(got)} against {list(want)}"
        for k in want:
            assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, f"{where}: {got.dtype} {got.shape}"
        assert got.tobytes() == want.tobytes(), where
    else:
        assert got == want, where


def every_dtype_tree(rng):
    return {
        "params": {
            "kernel": rng.standard_normal((3, 5)).astype(np.float32),
            "big": rng.standard_normal((300, 300)).astype(np.float32),  # in a data file
            "scalar": np.float32(2.5),
            "i4": rng.integers(-9, 9, (4,)).astype(np.int32),
            "i8": np.arange(5, dtype=np.int64) * (1 << 40),
            "b1": np.array([True, False, True]),
            "f2": rng.standard_normal((2, 3)).astype(np.float16),
            "i1": np.arange(-3, 3, dtype=np.int8),
            "bf16": rng.standard_normal((4, 2)).astype(ml_dtypes.bfloat16),
            "nested": {"deeper": {"leaf": np.arange(6, dtype=np.float32).reshape(1, 2, 3)}},
        },
        "step": np.int32(7),
        "chain": [None, [{"count": np.int32(3), "mu": {"w": np.ones(2, np.float32)}}, {"inner_state": None}]],
        "pair": (np.int32(1), np.float32(2.0)),
        "empty_dict": {},
        "empty_list": [],
        "none": None,
        "python_int": 3,
        "python_float": 0.25,
    }


def test_read_orbax_matches_orbax_restore(tmp_path):
    """The JAX package's save_checkpoint: nested dicts, lists and tuples
    (restored as lists), 0-d arrays, Python scalars, None / {} / [] and every
    dtype; a 360 KB array lands in a data file beside values kept inline in
    the B+tree leaf. (orbax refuses to save a zero-size array; the
    tensorstore cases read one.)"""
    path = tmp_path / "ckpt"
    jax_save(str(path), every_dtype_tree(np.random.default_rng(0)))
    assert is_orbax_dir(path) and not is_orbax_dir(tmp_path)
    assert_same(read_orbax(path), restore(path))
    items = orbax_io._Store(path, True).items
    assert isinstance(items["params.big/0.0"], tuple) and isinstance(items["params.kernel/0.0"], bytes)
    assert items["params.big/0.0"][0].startswith("ocdbt.process_0/d/")
    with pytest.raises(ValueError, match="Cannot save arrays with zero size"):
        jax_save(str(tmp_path / "zero"), {"a": np.zeros((0, 3), np.float32)})


def tensorstore_checkpoint(path: Path, arrays: dict, *, ocdbt: bool, config=None, fill=None, write=None):
    """A checkpoint directory written by tensorstore as orbax writes one
    (zarr v2 arrays under their dotted names, _METADATA beside them), with
    each array's own chunk shape; ``write`` maps a name to the region
    written (the other chunks stay absent), ``fill`` to its fill_value."""
    tree = {}
    for name, (value, chunks) in arrays.items():
        if ocdbt:
            kv = {"driver": "ocdbt", "base": f"file://{path}", "path": f"{name}/", "config": config or {}}
        else:
            kv = {"driver": "file", "path": f"{path}/{name}/"}
        dtype = "bfloat16" if value.dtype == ml_dtypes.bfloat16 else value.dtype.str
        arr = ts.open({"driver": "zarr", "kvstore": kv, "create": True, "metadata": {
            "shape": list(value.shape), "chunks": list(chunks), "dtype": dtype,
            "fill_value": (fill or {}).get(name), "compressor": {"id": "zstd", "level": 1}}}).result()
        region = (write or {}).get(name, tuple(slice(None) for _ in value.shape))
        if value.size:
            arr[region] = value[region]
        keys = name.split(".")
        tree[str(tuple(keys))] = {"key_metadata": [{"key": k, "key_type": 2} for k in keys],
                                  "value_metadata": {"value_type": "np.ndarray", "skip_deserialize": False}}
    (path / "_METADATA").write_text(json.dumps({"tree_metadata": tree, "use_ocdbt": ocdbt, "use_zarr3": False}))


@pytest.mark.parametrize("ocdbt", [True, False], ids=["ocdbt_btree", "zarr_directories"])
def test_read_orbax_chunk_grids(tmp_path, monkeypatch, ocdbt):
    """Arrays over a chunk grid smaller than the array (edge chunks cut), a
    chunk never written (fill_value null reads as 0, 7 as 7), a zero-size
    array, bfloat16 and big-endian floats; with OCDBT, 1 KB nodes put a level
    of B+tree nodes above the leaves, every array is a commit of its own
    (many data files) and values over 64 bytes go to data files."""
    rng = np.random.default_rng(1)
    arrays = {f"layer.w{i}": (rng.standard_normal((7, 5)).astype(np.float32), (3, 2)) for i in range(12)}
    arrays.update({
        "layer.big": (rng.standard_normal((40, 30)).astype(np.float32), (16, 16)),
        "part.nulls": (rng.integers(0, 100, (7, 5)).astype(np.int32), (3, 2)),
        "part.sevens": (rng.standard_normal((6, 4)).astype(np.float32), (4, 4)),
        "zero": (np.zeros((0, 4), np.float32), (1, 4)),
        "bf16": (rng.standard_normal((5, 3)).astype(ml_dtypes.bfloat16), (2, 3)),
        "big_endian": (rng.standard_normal((3, 3)).astype(">f4"), (2, 2)),
    })
    tensorstore_checkpoint(tmp_path, arrays, ocdbt=ocdbt, config={"max_decoded_node_bytes": 1024,
                                                                  "max_inline_value_bytes": 64},
                           fill={"part.sevens": 7.0},
                           write={"part.nulls": (slice(0, 4), slice(0, 3)), "part.sevens": (slice(0, 4), slice(0, 4))})
    heights = []
    walk = orbax_io._Store._walk
    monkeypatch.setattr(orbax_io._Store, "_walk", lambda self, files, *a: heights.append(a[3]) or walk(self, files, *a))
    got = read_orbax(tmp_path)
    assert_same(got, restore(tmp_path))
    assert got["part"]["nulls"][4:].sum() == 0 and (got["part"]["sevens"][4:] == 7).all()
    assert got["big_endian"].dtype == np.dtype("<f4")
    if ocdbt:
        assert max(heights) >= 1 and len(list((tmp_path / "d").iterdir())) > 10


def test_read_orbax_without_ocdbt(tmp_path):
    """orbax's own non-OCDBT layout (use_ocdbt False: one file a key)."""
    tree = every_dtype_tree(np.random.default_rng(2))
    ckptr = ocp.Checkpointer(ocp.StandardCheckpointHandler(use_ocdbt=False))
    ckptr.save(tmp_path / "plain", tree)
    assert (tmp_path / "plain" / "params.big" / ".zarray").is_file()
    assert_same(read_orbax(tmp_path / "plain"), restore(tmp_path / "plain"))


def test_read_orbax_per_process_manifests(tmp_path):
    """Without the root manifest (and the root B+tree it names), the
    per-process database under ocdbt.process_0 gives the same tree."""
    path = tmp_path / "ckpt"
    jax_save(str(path), every_dtype_tree(np.random.default_rng(3)))
    want = restore(path)
    (path / "manifest.ocdbt").unlink()
    shutil.rmtree(path / "d")
    assert_same(read_orbax(path), want)


def _refit_crc(path: Path, data: bytearray) -> None:
    data[-4:] = orbax_io.crc32c(bytes(data[:-4])).to_bytes(4, "little")
    path.write_bytes(bytes(data))


def _spoil(path: Path, how: str) -> str:
    """Damage the checkpoint at ``path`` one way; returns the error's pattern."""
    meta = path / "_METADATA"
    if how == "compressor":
        zarray = path / "params.kernel" / ".zarray"
        zarray.write_text(zarray.read_text().replace('"zstd"', '"blosc"'))
        return "compressor 'blosc'"
    if how == "dtype":
        zarray = path / "params.kernel" / ".zarray"
        zarray.write_text(zarray.read_text().replace('"<f4"', '"<c8"'))
        return "dtype '<c8'"
    if how == "zarr3":
        meta.write_text(meta.read_text().replace('"use_zarr3": false', '"use_zarr3": true'))
        return "use_zarr3"
    if how == "manifest_version":
        data = bytearray((path / "manifest.ocdbt").read_bytes())
        data[12] = 1  # the format version varint after the magic and the length
        _refit_crc(path / "manifest.ocdbt", data)
        return "format version 1"
    if how == "crc":
        data = bytearray((path / "manifest.ocdbt").read_bytes())
        data[20] ^= 0xFF
        (path / "manifest.ocdbt").write_bytes(bytes(data))
        return "CRC32C mismatch"
    if how == "missing_data_file":
        big = max((path / "ocdbt.process_0" / "d").iterdir(), key=lambda p: p.stat().st_size)
        big.unlink()
        return "is missing"
    if how == "no_metadata":
        meta.unlink()
        return "no _METADATA"
    raise ValueError(how)


@pytest.mark.parametrize("how", ["compressor", "dtype", "zarr3", "manifest_version", "crc", "missing_data_file",
                                 "no_metadata"])
def test_read_orbax_refuses(tmp_path, how):
    """Each refusal raises a ValueError naming what it found, and so does the
    stage loader, which names the three layouts it reads."""
    tree = {"params": {"kernel": np.ones((3, 5), np.float32),
                       "big": np.random.default_rng(4).standard_normal((300, 300)).astype(np.float32)}}
    path = tmp_path / "ckpt"
    if how in ("compressor", "dtype"):
        ocp.Checkpointer(ocp.StandardCheckpointHandler(use_ocdbt=False)).save(path, tree)
    else:
        jax_save(str(path), tree)
    pattern = _spoil(path, how)
    with pytest.raises(ValueError, match=pattern):
        read_orbax(path)
    model = tconfig.init_stage(tconfig.load_model_config(str(fx.FIXTURE / "model.json")), "fine", 0,
                               device="cpu").model
    with pytest.raises(ValueError, match="orbax checkpoint directory") as err:
        tload.load_stage_params(str(path), model)
    assert "reference stage .pt" in str(err.value) and "checkpoint.save_checkpoint" in str(err.value)


def test_loaders_name_their_layouts(tmp_path):
    """A path in none of the layouts: the error names all of them."""
    mc = tconfig.load_model_config(str(fx.FIXTURE / "model.json"))
    (tmp_path / "notes.txt").write_text("not a checkpoint")
    for path in (tmp_path / "absent", tmp_path / "notes.txt", tmp_path):
        with pytest.raises(ValueError, match=r"\(1\) the port's .*\(2\) .*\(3\) the JAX package's orbax"):
            tload.load_rvq(str(path), mc, None, device="cpu")
    with pytest.raises(ValueError, match=r"scikit-learn .*\(3\) the JAX package's orbax"):
        tload.load_kmeans(str(tmp_path / "absent"), mc, None)
    with pytest.raises(ValueError, match="a directory"):
        tload._load_into(torch.nn.Linear(2, 2), str(tmp_path), None)


def test_missing_libzstd_is_loud(monkeypatch):
    orbax_io._libzstd.cache_clear()
    monkeypatch.setattr(orbax_io.ctypes.util, "find_library", lambda name: None)
    try:
        with pytest.raises(OSError, match=r"libzstd\.so\.1"):
            read_orbax(fx.FIXTURE / fx.DIRS["kmeans"])
    finally:
        orbax_io._libzstd.cache_clear()


def test_zstd_frames_with_and_without_size():
    """The reader's zstd against the frames tensorstore writes: a node frame
    declaring its size, a zarr chunk frame that does not (decoded by its
    known size, and streamed)."""
    raw = (fx.FIXTURE / fx.DIRS["kmeans"] / "manifest.ocdbt").read_bytes()
    body = orbax_io._unframe(raw, orbax_io._MANIFEST_MAGIC, "manifest")
    assert len(body) > 40
    store = orbax_io._Store(fx.FIXTURE / fx.DIRS["kmeans"], True)
    frame = store.read(*store.items["centroids/0.0"])
    assert frame[:4] == b"\x28\xb5\x2f\xfd" and not frame[4] & 0xE0  # no content size in the header
    known = orbax_io.zstd_decompress_into(frame, np.empty(CB * 768 * 4, np.uint8))
    assert orbax_io.zstd_decompress(frame) == known.tobytes()
    with pytest.raises(ValueError, match="Destination buffer is too small"):
        orbax_io.zstd_decompress_into(frame, np.empty(CB * 768 * 4 - 4, np.uint8))
    with pytest.raises(ValueError, match="zstd"):
        orbax_io.zstd_decompress(frame[:-3])


# ---------------------------------------------------------------------------
# the loaders on what the JAX trainers wrote
# ---------------------------------------------------------------------------


def _stub_init(cls):
    """``cls`` whose init returns no variables: a tower the test never runs
    (flax would otherwise initialise it op by op, or compile it)."""

    class StubInit(cls):
        def init(self, rngs, *args):
            return {}

    return StubInit


def _no_tokenizer(path):
    raise FileNotFoundError(path)


def _patch_jax_towers(monkeypatch):
    """JAX's create_musiclm_from_config with doll-house towers that are
    built but not initialised (the CLAP at TINY_AUDIO / TINY_TEXT, HuBERT at
    TINY_HUBERT, a 60 Hz Encodec: the codes are compared before the codec),
    no tokenizer, and each stage's init traced for its shapes only (its
    params come from the directory)."""
    monkeypatch.setattr(jload, "build_clap", lambda mc, dtype=jnp.float32: _stub_init(JCLAP)(
        audio_cfg=TINY_AUDIO, text_cfg=TINY_TEXT, joint_embed_shape=16))
    monkeypatch.setattr(jload, "build_hubert", lambda mc, dtype=jnp.float32: _stub_init(JHubertModel)(
        cfg=JHubertConfig(**TINY_HUBERT)))
    monkeypatch.setattr(jload, "build_encodec", lambda mc, dtype=jnp.float32: _stub_init(JEncodec)(
        sample_rate=60, ratios=(2, 2), num_quantizers=4, codebook_size=CB, dimension=8, n_filters=2))
    monkeypatch.setattr(jload, "load_tokenizer", _no_tokenizer)
    monkeypatch.setattr(JTCT, "init", lambda self, key, ids: jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, s.dtype),
        jax.eval_shape(lambda k, i: flax.linen.Module.init(self, k, i), key, ids)))


def test_create_musiclm_from_jax_directories(monkeypatch):
    """The fixture's stages (a TrainState's params and bare params), RVQ
    and k-means, as the JAX trainers wrote them, through both packages'
    create_musiclm_from_config (doll-house towers, not compared): the RVQ and the
    centroids bit for bit, each stage's teacher-forced float32 logits
    within 1e-5 x max|logit|, and greedy generate codes equal."""
    _tiny_towers(monkeypatch)
    _patch_jax_towers(monkeypatch)
    paths = {f"{k}_path": str(fx.FIXTURE / d) for k, d in fx.DIRS.items()}
    cfg = str(fx.FIXTURE / "model.json")
    jm = jload.create_musiclm_from_config(j_load_model_config(cfg), **paths)
    tm = tload.create_musiclm_from_config(tconfig.load_model_config(cfg), device="cpu", **paths)
    for field in ("codebooks", "cluster_size", "embed_avg", "initted"):
        np.testing.assert_array_equal(getattr(tm.clap.rvq, field).numpy(), np.asarray(getattr(jm.clap.rvq, field)))
    np.testing.assert_array_equal(tm.wav2vec.centroids.numpy(), np.asarray(jm.wav2vec.centroids))

    mc = j_load_model_config(cfg)
    for i, name in enumerate(("semantic", "coarse", "fine")):
        ids = fx.token_batch(mc, name, 50 + i, 2)
        jstage = getattr(jm, f"{name}_stage")
        want = jax.jit(jstage.model.apply)(jstage.params, [jnp.asarray(t) for t in ids])
        with torch.no_grad():
            got = getattr(tm, f"{name}_stage").model([torch.from_numpy(t).long() for t in ids])
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max(), name

    codes = {}

    def capture(name, wave):
        def decode(*args):  # the codes; the codecs differ (not compared)
            codes[name] = np.asarray(args[-1])
            return wave
        return decode

    jm._decode = capture("jax", jnp.zeros((2, 1)))
    tm._decode = capture("torch", torch.zeros(2, 1))
    clap = np.random.default_rng(5).integers(0, CB, (2, fx.N_CLAP_Q, 1))
    windows = dict(output_seconds=2, semantic_window_seconds=2, coarse_window_seconds=1, fine_window_seconds=1)
    jm.generate(key=jax.random.PRNGKey(0), clap_token_ids=jnp.asarray(clap, jnp.int32), **GREEDY, **windows)
    tm.generate(clap_token_ids=torch.from_numpy(clap), **GREEDY, **windows)
    assert codes["torch"].shape == codes["jax"].shape == (2, 150, 4)
    np.testing.assert_array_equal(codes["torch"], codes["jax"])


def _jax_trained(tmp_path, wd: float, steps: int = 2):
    """A doll-house stage trained ``steps`` steps by JAX's StageTrainer and
    saved there; returns (trainer, state, model, path)."""
    jmodel = JTCT(specs=(JSpec(CB, 2), JSpec(CB, 1)), dim=32, depth=1, heads=2, dim_head=16)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0), [jnp.zeros((1, 6), jnp.int32),
                                                           jnp.zeros((1, 8), jnp.int32)])
    trainer = JStageTrainer(model=jmodel, loss_cfg=JLossConfig((0.5, 1.0), mask_prob=0.0), mesh=make_mesh(dp=1),
                            lr=1e-3, wd=wd, lr_warmup=3, max_grad_norm=0.5, use_tensorboard=False,
                            results_folder=str(tmp_path), stage_name="coarse")
    trainer.optimizer = make_optimizer(1e-3, wd, warmup_steps=3, max_grad_norm=0.5, eps=1e-2)
    state = trainer.init_state(jparams)
    for step in range(steps):
        state, _ = trainer.train_step(state, _batch(step), jax.random.PRNGKey(step))
    trainer.save(state, int(state.step))
    return trainer, state, jmodel, Path(trainer.checkpoint_path(int(state.step)))


def _batch(seed):
    rng = np.random.default_rng(seed)
    return tuple(jnp.asarray(rng.integers(0, CB, (1, 3, n)), jnp.int32) for n in (6, 8))


@pytest.mark.parametrize("wd", [0.0, 1e-2], ids=["adam", "adamw_masked"])
def test_resume_jax_train_state(tmp_path, wd):
    """A JAX StageTrainer's TrainState after two steps, resumed by the
    port's StageTrainer.load (its model first drawn from another seed): the
    third step's params within 1e-6, mu and nu within 1e-5 x their largest
    |value|, count and step equal, loss within 1e-4 (adam's eps 1e-2 on both
    sides, as in test_torch_train.py). A trainer whose optimizer is another
    chain (no clip, or wd the other way) refuses the directory."""
    jtrainer, jstate, jmodel, path = _jax_trained(tmp_path / "jax", wd)
    jstate = jtrainer.load(str(path), jstate.params)
    model = port_model(jmodel, jax.jit(jmodel.init)(jax.random.PRNGKey(9), [jnp.zeros((1, 6), jnp.int32),
                                                                           jnp.zeros((1, 8), jnp.int32)]))
    hp = dict(loss_cfg=StageLossConfig((0.5, 1.0), mask_prob=0.0), lr=1e-3, lr_warmup=3, max_grad_norm=0.5,
              use_tensorboard=False, results_folder=str(tmp_path / "port"), stage_name="coarse")
    trainer = StageTrainer(model=model, wd=wd, **hp)
    state = trainer.load(str(path))
    state.optimizer.eps = 1e-2
    assert (state.step, state.optimizer.count) == (2, 2)

    jstate, jloss = jtrainer.train_step(jstate, _batch(2), jax.random.PRNGKey(2))
    state, loss = trainer.train_step(state, tuple(torch.from_numpy(np.array(b)).long() for b in _batch(2)))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    assert state.step == int(jstate.step) == 3
    adam = jstate.opt_state[1][0]
    assert state.optimizer.count == int(adam.count) == 3
    names = [n for n, _ in model.named_parameters()]
    for part, tensors in (("mu", state.optimizer.mu), ("nu", state.optimizer.nu)):
        want = stage_state_dict(jax.device_get(getattr(adam, part)), 2, 1)
        scale = max(float(want[n].abs().max()) for n in names)
        for n, t in zip(names, tensors):
            assert float((t - want[n]).abs().max()) <= 1e-5 * scale, (part, n)
    want = stage_state_dict(jax.device_get(jstate.params), 2, 1)
    for n, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[n].numpy(), atol=1e-6, err_msg=n)

    for other in (dict(wd=1e-2 - wd), dict(wd=wd, max_grad_norm=None)):
        kw = {**hp, **other}
        with pytest.raises(ValueError, match="optimizer's chain"):
            StageTrainer(model=port_model(jmodel, jstate.params), **kw).load(str(path))


def _cli_env(tmp_path: Path):
    """The fixture's model config, a token store, and a training config
    whose coarse trainer matches the fixture's TrainState (train.json):
    the token store path, batch 2, 3 steps, no checkpoints or results."""
    mc = tconfig.load_model_config(str(fx.FIXTURE / "model.json"))
    chip_smoke.write_token_store(tmp_path / "store", mc, n_tracks=4, seconds=3, seed=0)
    train = json.loads((fx.FIXTURE / "train.json").read_text())
    tc = json.loads((chip_smoke.ROOT / "configs" / "training" / "train_musiclm_fma.json").read_text())
    tc["coarse_trainer_cfg"].update(
        folder=str(tmp_path / "store"), use_preprocessed_data=True, batch_size=2, grad_accum_every=1,
        num_train_steps=3, save_model_every=0, save_results_every=0, lr=train["lr"], wd=train["wd"],
        lr_warmup=train["lr_warmup"], max_grad_norm=train["max_grad_norm"],
        cross_entropy_loss_weights=train["coarse_loss_weights"])
    (tmp_path / "train.json").write_text(json.dumps(tc))
    return ["--stage", "coarse", "--model_config", str(fx.FIXTURE / "model.json"), "--training_config",
            str(tmp_path / "train.json"), "--device", "cpu", "--num_workers", "1",
            "--results_folder", str(tmp_path / "out")]


@pytest.mark.parametrize("newest", ["jax", "port"])
def test_continue_from_dir_mixed_folder(tmp_path, newest):
    """--continue_from_dir on a folder holding the JAX trainer's directory
    (step 2) and the port's files (step 1, and step 5 where the port's is
    newest): the newest step wins whichever package wrote it, and training
    runs what is left of num_train_steps from there. (Before the reader, the
    JAX directory made StageTrainer.load call torch.load on a directory.)"""
    args = _cli_env(tmp_path)
    res = tmp_path / "res"
    res.mkdir()
    shutil.copytree(fx.FIXTURE / fx.DIRS["coarse"], res / "coarse.transformer.2.ckpt")
    mc = tconfig.load_model_config(str(fx.FIXTURE / "model.json"))
    port = tconfig.init_stage(mc, "coarse", 3, device="cpu").model
    opt = {"mu": [torch.zeros_like(p) for p in port.parameters()],
           "nu": [torch.zeros_like(p) for p in port.parameters()]}
    older = [1] + ([5] if newest == "port" else [])
    for step in older:
        save_checkpoint(str(res / f"coarse.transformer.{step}.ckpt"),
                        {"model": port.state_dict(), "optimizer": dict(opt, count=step), "step": step})
    want = max([2] + older)
    assert find_latest_checkpoint(str(res), "coarse.transformer").endswith(f"coarse.transformer.{want}.ckpt")
    if newest == "port":
        tc = json.loads((tmp_path / "train.json").read_text())
        tc["coarse_trainer_cfg"]["num_train_steps"] = 6
        (tmp_path / "train.json").write_text(json.dumps(tc))
    state = train_stage.main(args + ["--continue_from_dir", str(res)])
    logged = [json.loads(line)["step"] for line in (tmp_path / "out" / "coarse.log.jsonl").read_text().splitlines()]
    assert logged == [want] and state.step == want + 1 and state.optimizer.count == want + 1


def test_fine_tune_from_jax_directory(tmp_path):
    """--fine_tune_from the JAX trainer's TrainState directory: its params
    (as the JAX loader unwraps them, through stage_state_dict), a fresh
    optimizer at step 0."""
    args = _cli_env(tmp_path)
    tc = json.loads((tmp_path / "train.json").read_text())
    tc["coarse_trainer_cfg"]["num_train_steps"] = 0
    (tmp_path / "train.json").write_text(json.dumps(tc))
    path = str(fx.FIXTURE / fx.DIRS["coarse"])
    state = train_stage.main(args + ["--fine_tune_from", path])
    assert state.step == 0 and state.optimizer.count == 0
    jparams = jload.load_stage_params(path, None)
    want = stage_state_dict(jparams, 3, 1)
    got = state.model.state_dict()
    assert sorted(got) == sorted(want)
    for name, p in got.items():
        assert torch.equal(p, want[name]), name


def test_fixture_npz_is_current():
    """expected.npz recomputed from the fixture's directories with JAX on
    the CPU: the same arrays (integers equal, floats within 1e-5 x max: XLA
    fuses the same program otherwise on another CPU, ~2e-6 here between
    jit and op-by-op), so the fixture cannot go stale; chip_smoke.py names
    the same directories."""
    assert chip_smoke.ORBAX_DIRS == fx.DIRS and chip_smoke.ORBAX_FIXTURE == fx.FIXTURE
    committed = np.load(fx.FIXTURE / "expected.npz")
    fresh = fx.expected(fx.FIXTURE)
    assert sorted(committed.files) == sorted(fresh)
    for k, want in fresh.items():
        got = committed[k]
        assert got.dtype == np.asarray(want).dtype and got.shape == np.shape(want), k
        if got.dtype.kind == "f":
            assert np.abs(got - want).max() <= 1e-5 * max(np.abs(want).max(), 1e-30), k
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)


def test_phase14_checks_on_cpu():
    """chip_smoke.py's phase 14 checks on the CPU (the kernels' plain
    versions): the fixture through the port against expected.npz."""
    res = chip_smoke.orbax_fixture_checks(torch, tconfig, torch.device("cpu"), chip_smoke.all_counters())
    assert max(res["logit_err"].values()) <= chip_smoke.ORBAX_LOGIT_TOL
    assert res["step_err"]["params"] <= chip_smoke.ORBAX_PARAM_ATOL
    assert res["decoded_bytes"] > 0 and not any(res["step_launches"].values())
    assert dataclasses.is_dataclass(res["stages"]["coarse"])
