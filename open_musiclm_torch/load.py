"""Inference-model assembly from checkpoints (port of open_musiclm_tpu/load.py).

``create_musiclm_from_config`` builds a whole ``MusicLM`` from a model
config: the three stages, the CLAP with its RVQ, HuBERT with its k-means
codebook, the Encodec codec and the tokenizer. A stage's, the RVQ's and the
k-means codebook's path is in one of three layouts:
  * the port's own checkpoint file (``checkpoint.save_checkpoint``): a
    module's ``state_dict`` (for a stage also a trainer checkpoint's
    ``{"model": ...}``), an RVQ's ``{"codebooks": ...}`` or whole state,
    k-means ``{"centroids": ...}``;
  * the reference ecosystem's file, read through ``import_torch``: a stage
    ``.pt``, a ``vector_quantize_pytorch`` ResidualVQ, a scikit-learn k-means
    joblib;
  * the JAX package's orbax directory (``orbax_io.read_orbax``; a path
    that is a directory is one, as in the JAX package's ``_is_orbax``): a
    stage's params or its trainer's ``TrainState`` (whose ``params`` are
    taken), the RVQ trainer's ``RVQState``, the k-means trainer's
    ``{"centroids", "inertia"}``, through ``convert``.
The towers' paths (Encodec, HuBERT, the laion CLAP) are files in the first
two layouts. A file holding exactly the module's own keys is the port's;
any other is read as the reference layout. A path in none of the layouts
raises a ValueError that names them. A path that is None gives a seeded
random init: one ``torch.Generator`` made from ``seed`` draws a seed for
each of the eight parts (as the JAX package splits its key), so a part's
weights do not depend on which other paths are given.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from types import SimpleNamespace
from typing import Optional, Sequence

import torch

from . import convert
from . import import_torch as it
from .checkpoint import load_checkpoint
from .config import (
    MusicLMModelConfig,
    build_clap,
    build_encodec,
    build_hubert,
    init_stage,
    target_device,
)
from .models.clap.tokenizer import load_tokenizer
from .models.musiclm import MusicLM
from .models.rvq import RVQState, rvq_init, rvq_to
from .models.stages import Stage
from .orbax_io import read_orbax

_TORCH_ZIP_MAGIC = b"PK\x03\x04"

_PORT = "the port's checkpoint file (checkpoint.save_checkpoint)"
_JAX = "the JAX package's orbax checkpoint directory (open_musiclm_tpu.checkpoint.save_checkpoint)"
STAGE_LAYOUTS = (f"{_PORT}: a stage's state_dict or a trainer checkpoint's {{'model': ...}}",
                 "a reference stage .pt (open_musiclm_torch.import_torch)",
                 f"{_JAX}: a stage's params or its trainer's TrainState")
RVQ_LAYOUTS = (f"{_PORT}: {{'codebooks': ...}} or a whole RVQState",
               "a vector_quantize_pytorch ResidualVQ state dict",
               f"{_JAX}: the RVQ trainer's RVQState (codebooks, cluster_size, embed_avg, initted)")
KMEANS_LAYOUTS = (f"{_PORT}: {{'centroids': ...}}",
                  "a scikit-learn MiniBatchKMeans joblib dump",
                  f"{_JAX}: the k-means trainer's {{'centroids', 'inertia'}}")
TOWER_LAYOUTS = (f"{_PORT}: the module's state_dict",
                 "the reference ecosystem's state dict (a .pt or Hugging Face .bin)")


def _not_readable(path, part: str, layouts: Sequence[str], why) -> ValueError:
    return ValueError(f"{path} is not {part} in a layout the loader reads ({why}); it reads "
                      + "; ".join(f"({i + 1}) {layout}" for i, layout in enumerate(layouts)))


def _is_torch_file(path: str) -> bool:
    """torch.save's zip format (a joblib or other pickle dump is not)."""
    with open(path, "rb") as f:
        return f.read(4) == _TORCH_ZIP_MAGIC


def _read(path: str, part: str, layouts: Sequence[str], orbax: bool = True):
    """The tree a checkpoint holds: a JAX orbax directory through
    ``read_orbax`` (where ``orbax``), else the object a torch file holds,
    read as the reference importer reads it."""
    p = Path(path)
    if p.is_dir():
        if not orbax:
            raise _not_readable(path, part, layouts, "a directory")
        try:
            return read_orbax(p)
        except ValueError as e:
            raise _not_readable(path, part, layouts, e) from e
    if not p.is_file():
        raise _not_readable(path, part, layouts, "no such file or directory")
    try:
        return torch.load(path, map_location="cpu", weights_only=False)
    except (pickle.UnpicklingError, RuntimeError, EOFError) as e:
        raise _not_readable(path, part, layouts, f"torch.load: {e}") from e


def _port_state_dict(tree, module: torch.nn.Module) -> Optional[dict]:
    """``tree`` if it is the port's checkpoint of ``module`` (a trainer
    checkpoint's ``model`` entry included), else None."""
    if isinstance(tree, dict) and isinstance(tree.get("model"), dict):
        tree = tree["model"]
    if isinstance(tree, dict) and set(tree) == set(module.state_dict()):
        return tree
    return None


def _load_into(module: torch.nn.Module, path: str, import_fn) -> None:
    """``module``'s weights from ``path``: the port's checkpoint as it is,
    anything else through ``import_fn(numpy state dict)``."""
    tree = _read(path, f"a {type(module).__name__} checkpoint", TOWER_LAYOUTS, orbax=False)
    sd = _port_state_dict(tree, module)
    module.load_state_dict(sd if sd is not None else import_fn(it.numpy_state_dict(tree)))


def load_stage_params(path: str, model) -> dict:
    """A stage's weights (``model``'s state_dict keys) from any of
    ``STAGE_LAYOUTS``: the port's checkpoint as it is, a reference stage
    ``.pt`` through ``import_torch.import_stage_transformer``, the JAX
    package's params (a ``TrainState``'s ``params`` unwrapped, as
    open_musiclm_tpu/load.py:50-53 does) through ``convert.stage_state_dict``."""
    tree = _read(path, "a stage checkpoint", STAGE_LAYOUTS)
    if Path(path).is_dir():
        return convert.stage_state_dict(tree.get("params", tree), len(model.specs), model.depth)
    sd = _port_state_dict(tree, model)
    if sd is not None:
        return sd
    return it.import_stage_transformer(it.numpy_state_dict(tree), len(model.specs), model.depth)


def load_stage(mc: MusicLMModelConfig, stage_name: str, path: Optional[str], seed: int, *,
               device="cuda", dtype: torch.dtype = torch.float32) -> Stage:
    """The stage ``stage_name`` of ``mc`` with its parameters in ``dtype`` on
    ``device``: its weights from ``path``, or a random init from ``seed``."""
    device = target_device(device, "load_stage")
    stage = init_stage(mc, stage_name, seed, device="cpu")
    if path is not None:
        stage.model.load_state_dict(load_stage_params(path, stage.model))
    stage.model.to(device=device, dtype=dtype)
    return stage


def load_rvq(path: Optional[str], mc: MusicLMModelConfig, generator: Optional[torch.Generator],
             *, device="cuda") -> RVQState:
    """The CLAP's residual VQ from any of ``RVQ_LAYOUTS``: the port's
    ``{"codebooks": ...}`` or a whole ``RVQState`` (``ClapRVQTrainer``'s
    ``clap.rvq.{step}.ckpt``), a ResidualVQ state dict, the JAX RVQ
    trainer's ``RVQState`` directory (through ``convert.rvq_state``); or
    standard-normal Q x K x 512 codebooks where ``path`` is None."""
    device = target_device(device, "load_rvq")
    cfg = mc.clap_rvq_cfg
    if path is None:
        rvq = rvq_init(cfg.rq_num_quantizers, cfg.codebook_size, 512, generator)
    else:
        tree = _read(path, "an RVQ checkpoint", RVQ_LAYOUTS)
        if Path(path).is_dir():
            missing = sorted(set(RVQState._fields) - set(tree))
            if missing:
                raise _not_readable(path, "an RVQ checkpoint", RVQ_LAYOUTS, f"it has no {missing}")
            rvq = convert.rvq_state(SimpleNamespace(**{f: tree[f] for f in RVQState._fields}))
        elif "codebooks" in tree and set(tree) <= set(RVQState._fields):
            rvq = RVQState(**tree)
        else:
            rvq = it.import_rvq(it.numpy_state_dict(tree))
    return rvq_to(rvq, device)


def load_kmeans(path: Optional[str], mc: MusicLMModelConfig, generator: Optional[torch.Generator]) -> torch.Tensor:
    """[K, 768] k-means centroids from any of ``KMEANS_LAYOUTS``: the
    port's ``{"centroids": ...}``, a scikit-learn joblib dump, the JAX
    k-means trainer's directory (through ``convert.kmeans_centroids``); or
    N(0, 1) where ``path`` is None."""
    if path is None:
        return torch.randn(mc.hubert_kmeans_cfg.codebook_size, 768, generator=generator)
    if Path(path).is_dir():
        tree = _read(path, "a k-means checkpoint", KMEANS_LAYOUTS)
        if "centroids" not in tree:
            raise _not_readable(path, "a k-means checkpoint", KMEANS_LAYOUTS, f"it has no centroids ({sorted(tree)})")
        return convert.kmeans_centroids(tree["centroids"])
    if not Path(path).is_file():
        raise _not_readable(path, "a k-means checkpoint", KMEANS_LAYOUTS, "no such file or directory")
    if _is_torch_file(path):
        return load_checkpoint(path, map_location="cpu")["centroids"]
    return it.import_kmeans_joblib(path)


def create_musiclm_from_config(
    mc: MusicLMModelConfig,
    *,
    semantic_path: Optional[str] = None,
    coarse_path: Optional[str] = None,
    fine_path: Optional[str] = None,
    rvq_path: Optional[str] = None,
    kmeans_path: Optional[str] = None,
    clap_path: Optional[str] = None,
    hubert_path: Optional[str] = None,
    encodec_path: Optional[str] = None,
    tokenizer_path: Optional[str] = None,
    dtype: torch.dtype = torch.float32,
    seed: int = 0,
    device="cuda",
) -> MusicLM:
    """A whole MusicLM on ``device``. ``dtype`` is the stages' parameter
    dtype and the towers' compute dtype (their parameters stay float32).
    Without a tokenizer (no ``tokenizer_path`` and no cached roberta-base)
    ``tokenizer`` is None and ``generate(text=...)`` raises."""
    device = target_device(device, "create_musiclm_from_config")
    seeds = torch.randint(0, 2**62, (8,), generator=torch.Generator().manual_seed(seed)).tolist()

    def generator(i: int) -> torch.Generator:
        return torch.Generator().manual_seed(seeds[i])

    clap = build_clap(mc, generator(0), device="cpu", dtype=dtype)
    if clap_path is not None:
        if mc.clap_rvq_cfg.enable_fusion:
            raise NotImplementedError(
                "a fusion CLAP checkpoint cannot be imported: its mel_conv2d / fusion_model weights "
                "are not mapped (the JAX package maps none either)")
        tower = clap.model
        _load_into(tower, clap_path, lambda sd: it.import_clap(
            sd, tower.audio_branch.cfg, tower.text_branch.cfg))
    clap.model.to(device)
    clap.rvq = load_rvq(rvq_path, mc, generator(1), device=device)

    wav2vec = build_hubert(mc, generator(2), device="cpu", dtype=dtype)
    if hubert_path is not None:
        _load_into(wav2vec.model, hubert_path, lambda sd: it.import_hubert(sd, wav2vec.model.cfg))
    wav2vec.centroids = load_kmeans(kmeans_path, mc, generator(3)).float()
    wav2vec.to(device)

    codec = build_encodec(mc, generator(4), device="cpu", dtype=dtype)
    if encodec_path is not None:
        _load_into(codec, encodec_path, lambda sd: it.import_encodec(
            sd, len(codec.ratios), codec.codebooks.shape[0]))
    codec.to(device).eval()

    try:
        tokenizer = load_tokenizer(tokenizer_path)
    except FileNotFoundError:
        tokenizer = None  # text prompts unavailable; clap_token_ids still work

    stages = {f"{name}_stage": load_stage(mc, name, path, seeds[5 + i], device=device, dtype=dtype)
              for i, (name, path) in enumerate((("semantic", semantic_path), ("coarse", coarse_path),
                                                ("fine", fine_path)))}
    return MusicLM(codec=codec, clap=clap, tokenizer=tokenizer, wav2vec=wav2vec, **stages)
