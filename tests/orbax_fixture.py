"""The doll-house fixture of JAX-written orbax checkpoints.

``tests/torch_fixtures/orbax_dollhouse/`` holds what the JAX package's
trainers write for a doll-house MusicLM (``model.json``: stages of dim 32,
depth 1, 2 heads of 64; 16-entry codebooks; 4 CLAP quantizers; 2 coarse and
2 fine quantizers), each through ``open_musiclm_tpu.checkpoint.save_checkpoint``:

  * ``coarse.transformer.2.ckpt``: the ``StageTrainer``'s ``TrainState``
    after two steps (params, the optax chain of clip and masked adamw with
    warmup, step);
  * ``semantic.params`` and ``fine.params``: a stage's bare flax variables,
    the other stage layout the JAX loader reads;
  * ``clap.rvq.1.ckpt``: ``ClapRVQTrainer``'s ``RVQState`` after two EMA
    updates (16-d embeddings);
  * ``kmeans.ckpt``: ``HubertKmeansTrainer``'s centroids [16, 768] and inertia;
  * ``train.json``: the stage trainer's hyperparameters and the coarse
    stage's loss weights (adam's eps raised to
    1e-2 on both sides, as in tests/test_torch_train.py, so that a float32
    gradient difference cannot move an element whose gradient is rounding
    noise by about lr);
  * ``expected.npz``: what the JAX package computes on the CPU from these
    directories: each stage's teacher-forced logits on seeded tokens, the
    RVQ and the centroids as JAX's loaders read them, and one more coarse
    training step from the saved ``TrainState`` (its batch, loss, and the
    next params, mu, nu and count in the port's state-dict names).

``chip_smoke.py`` (phase 14) holds the port on the card against
``expected.npz`` without JAX; tests/test_torch_orbax.py recomputes the
``.npz`` from the directories with JAX, so the fixture cannot go stale.

    python -m tests.orbax_fixture      # rewrite the fixture (from the repository root)
"""

from __future__ import annotations

import json
import shutil
import tempfile
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np

from open_musiclm_tpu import load as jload
from open_musiclm_tpu.checkpoint import save_checkpoint
from open_musiclm_tpu import config as jconfig
from open_musiclm_tpu.config import load_model_config, stage_example_lengths
from open_musiclm_tpu.models.rvq import rvq_init
from open_musiclm_tpu.models.stages import Stage
from open_musiclm_tpu.models.token_cond import StageLossConfig
from open_musiclm_tpu.parallel.mesh import make_mesh
from open_musiclm_tpu.train.optimizer import make_optimizer
from open_musiclm_tpu.train.tokenizer_trainers import ClapRVQTrainer, HubertKmeansTrainer
from open_musiclm_tpu.train.trainer import StageTrainer

from open_musiclm_torch.convert import optax_stage_state, stage_state_dict

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "torch_fixtures" / "orbax_dollhouse"
CB, N_CLAP_Q, RVQ_DIM = 16, 4, 16
DIRS = {"semantic": "semantic.params", "coarse": "coarse.transformer.2.ckpt", "fine": "fine.params",
        "rvq": "clap.rvq.1.ckpt", "kmeans": "kmeans.ckpt"}
TRAIN = {"lr": 1e-3, "wd": 1e-2, "lr_warmup": 4, "max_grad_norm": 0.5, "eps": 1e-2, "batch": 2, "mask_prob": 0.0}
MODEL = {
    "global_cfg": {"semantic_audio_length_seconds": 2.0, "coarse_audio_length_seconds": 1.0,
                   "fine_audio_length_seconds": 1.0, "clap_audio_length_seconds": 1.0,
                   "num_coarse_quantizers": 2, "num_fine_quantizers": 2},
    "clap_rvq_cfg": {"rq_num_quantizers": N_CLAP_Q, "codebook_size": CB},
    "hubert_kmeans_cfg": {"model_name": "m-a-p/MERT-v0", "normalize_embeds": True, "embed_layer": 1,
                          "codebook_size": CB},
    "encodec_cfg": {"bandwidth": 3.0, "codebook_size": CB},
    **{f"{s}_cfg": {"dim": 32, "depth": 1, "heads": 2, "ff_dropout": 0.0} for s in ("semantic", "coarse", "fine")},
}


def token_batch(mc, stage: str, seed: int, batch: int) -> list:
    """Seeded tokens of a stage's training example geometry: [batch, n_i]."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CB, (batch, n)).astype(np.int32) for n in stage_example_lengths(mc, stage)]


def _jax_trainer(stage, folder) -> StageTrainer:
    trainer = StageTrainer(model=stage.model, loss_cfg=StageLossConfig(
        stage.loss_cfg.cross_entropy_loss_weights, mask_prob=TRAIN["mask_prob"]), mesh=make_mesh(dp=1),
        lr=TRAIN["lr"], wd=TRAIN["wd"], lr_warmup=TRAIN["lr_warmup"], max_grad_norm=TRAIN["max_grad_norm"],
        results_folder=str(folder), stage_name=stage.name, use_tensorboard=False)
    trainer.optimizer = make_optimizer(TRAIN["lr"], TRAIN["wd"], warmup_steps=TRAIN["lr_warmup"],
                                       max_grad_norm=TRAIN["max_grad_norm"], eps=TRAIN["eps"])
    return trainer


def write_checkpoints(folder: Path, seed: int = 0) -> None:
    """Every artifact of the doll-house, written by the JAX trainers into
    ``folder`` (model.json, train.json and the directories of ``DIRS``)."""
    folder.mkdir(parents=True, exist_ok=True)
    (folder / "model.json").write_text(json.dumps(MODEL, indent=1))
    mc = load_model_config(str(folder / "model.json"))
    key = jax.random.PRNGKey(seed)
    for i, name in enumerate(("semantic", "coarse", "fine")):
        stage = jload.load_stage(mc, name, None, jax.random.fold_in(key, i))
        if name != "coarse":
            save_checkpoint(str(folder / DIRS[name]), stage.params)
            continue
        train = dict(TRAIN, coarse_loss_weights=list(stage.loss_cfg.cross_entropy_loss_weights))
        (folder / "train.json").write_text(json.dumps(train, indent=1))
        trainer = _jax_trainer(stage, folder)
        state = trainer.init_state(stage.params)
        for step in range(2):
            batch = tuple(jnp.asarray(t[None]) for t in token_batch(mc, name, 10 * i + step, TRAIN["batch"]))
            state, _ = trainer.train_step(state, batch, jax.random.fold_in(key, 100 + step))
        trainer.save(state, int(state.step))

    rng = np.random.default_rng(seed)
    clap = SimpleNamespace(audio_embedding=lambda x: x, rvq=rvq_init(N_CLAP_Q, CB, RVQ_DIM, jax.random.fold_in(key, 7)))
    embeds = iter([rng.standard_normal((32, RVQ_DIM)).astype(np.float32) for _ in range(2)])
    with tempfile.TemporaryDirectory() as tmp:
        ClapRVQTrainer(clap=clap, results_folder=tmp, num_train_steps=2, accumulate_batches=1,
                       save_model_every=1).train(embeds, jax.random.fold_in(key, 8))
        shutil.copytree(Path(tmp) / DIRS["rvq"], folder / DIRS["rvq"])
    feats = iter([rng.standard_normal((64, 768)).astype(np.float32) for _ in range(2)])
    HubertKmeansTrainer(hubert_kmeans=SimpleNamespace(features=lambda x: x, centroids=None), results_folder=str(folder),
                        feature_extraction_num_steps=2, n_clusters=CB, fit_batch_size=32).train(
        feats, jax.random.fold_in(key, 9))


def _jax_stage(mc, name: str, path: str) -> Stage:
    """The stage ``open_musiclm_tpu.load.load_stage`` gives for ``path``
    (its model, the params JAX's ``load_stage_params`` reads, the default
    loss weights), without the random init it draws first and discards."""
    model = getattr(jconfig, f"build_{name}_transformer")(mc)
    params = jax.tree_util.tree_map(jnp.asarray, jload.load_stage_params(path, model))
    return Stage(model, params, StageLossConfig(tuple([1.0] * len(model.specs))), name=name)


def expected(folder: Path) -> dict:
    """What the JAX package computes on the CPU from the directories in
    ``folder``: the arrays of ``expected.npz``."""
    mc = load_model_config(str(folder / "model.json"))
    key = jax.random.PRNGKey(0)
    out = {}
    stages = {}
    for i, name in enumerate(("semantic", "coarse", "fine")):
        stage = stages[name] = _jax_stage(mc, name, str(folder / DIRS[name]))
        ids = token_batch(mc, name, 1000 + i, TRAIN["batch"])
        logits = jax.jit(stage.model.apply)(stage.params, [jnp.asarray(t) for t in ids])
        for j, t in enumerate(ids):
            out[f"{name}.ids.{j}"] = t
        for j, lg in enumerate(logits):
            if lg is not None:
                out[f"{name}.logits.{j}"] = np.asarray(lg)
    rvq = jload.load_rvq(str(folder / DIRS["rvq"]), mc, key)
    out.update({f"rvq.{f}": np.asarray(getattr(rvq, f)) for f in rvq._fields})
    out["kmeans.centroids"] = np.asarray(jload.load_kmeans(str(folder / DIRS["kmeans"]), mc, key))

    stage = stages["coarse"]
    with tempfile.TemporaryDirectory() as tmp:
        trainer = _jax_trainer(stage, tmp)
        state = trainer.load(str(folder / DIRS["coarse"]), stage.params)
    batch = token_batch(mc, "coarse", 2000, TRAIN["batch"])
    state, loss = trainer.train_step(state, tuple(jnp.asarray(t[None]) for t in batch), key)
    specs, depth = len(stage.model.specs), stage.model.depth
    opt = optax_stage_state(jax.device_get(_as_restored(state.opt_state)))
    out.update({f"step.batch.{j}": t for j, t in enumerate(batch)})
    out["step.loss"] = np.float32(loss)
    out["step.step"] = np.int64(state.step)
    out["step.count"] = np.int64(opt["count"])
    for part, tree in (("model", jax.device_get(state.params)), ("mu", opt["mu"]), ("nu", opt["nu"])):
        for k, v in stage_state_dict(jax.device_get(tree), specs, depth).items():
            out[f"step.{part}.{k}"] = v.numpy()
    return out


def _as_restored(tree):
    """An optax state as orbax restores it without a target: NamedTuples as
    dicts of their fields (lists where they are tuples), empty states as None."""
    if hasattr(tree, "_fields"):
        return {f: _as_restored(getattr(tree, f)) for f in tree._fields} if tree._fields else None
    if isinstance(tree, (tuple, list)):
        return [_as_restored(t) for t in tree]
    if isinstance(tree, dict):
        return {k: _as_restored(v) for k, v in tree.items()}
    return tree


def write(folder: Path = FIXTURE) -> None:
    """Rewrite the fixture: the directories, then ``expected.npz`` from them."""
    if folder.exists():
        shutil.rmtree(folder)
    write_checkpoints(folder)
    np.savez_compressed(folder / "expected.npz", **expected(folder))


if __name__ == "__main__":
    write()
    print(f"wrote {FIXTURE} ({sum(p.stat().st_size for p in FIXTURE.rglob('*') if p.is_file())} bytes)")
