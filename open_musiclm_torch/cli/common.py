"""Shared flags and model assembly of the port's CLIs (port of
scripts/common.py: ``add_model_args``, ``add_training_args`` and
``build_musiclm``).

The flags are the JAX CLIs', plus ``--device`` (default ``cuda``; ``cpu``
runs the kernels' plain versions). Paths take the port's checkpoints or the
reference layout (``open_musiclm_torch.load``); a missing path is a seeded
random init.
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

import torch

REPO_ROOT = Path(__file__).resolve().parents[2]


def add_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model_config", default=str(REPO_ROOT / "configs/model/musiclm_small.json"))
    p.add_argument("--semantic_path", default=None)
    p.add_argument("--coarse_path", default=None)
    p.add_argument("--fine_path", default=None)
    p.add_argument("--rvq_path", default=None)
    p.add_argument("--kmeans_path", default=None)
    p.add_argument("--clap_path", default=None, help="CLAP torch checkpoint bundle")
    p.add_argument("--hubert_path", default=None, help="MERT/HuBERT torch state dict")
    p.add_argument("--encodec_path", default=None, help="Encodec torch state dict")
    p.add_argument("--tokenizer_path", default=None, help="dir with vocab.json+merges.txt")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16: the stages' parameters, the towers' compute")
    p.add_argument("--int8", action="store_true",
                   help="int8 fused-FF serving mode for the stage decoders (faster, "
                   "approximate token parity)")
    p.add_argument("--flash_kv", default=None, choices=["bf16", "int8"],
                   help="flash-decode KV cache mode (with --int8): early exit at the "
                   "live cache length; 'int8' also keeps the cache int8 (fastest)")
    p.add_argument("--approx_topk", action="store_true",
                   help="accepted for the JAX CLIs' flags; the port takes the exact top-k "
                   "(approx_max_k is a TPU op)")
    p.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")


def add_training_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--training_config",
                   default=str(REPO_ROOT / "configs/training/train_musiclm_fma.json"))
    p.add_argument("--results_folder", default="./results")
    p.add_argument("--continue_from_dir", default=None)
    p.add_argument("--fine_tune_from", default=None)


def build_musiclm(args):
    """(MusicLM, model config) from the parsed flags."""
    from ..config import load_model_config
    from ..load import create_musiclm_from_config

    mc = load_model_config(args.model_config)
    musiclm = create_musiclm_from_config(
        mc,
        semantic_path=args.semantic_path,
        coarse_path=args.coarse_path,
        fine_path=args.fine_path,
        rvq_path=args.rvq_path,
        kmeans_path=args.kmeans_path,
        clap_path=args.clap_path,
        hubert_path=args.hubert_path,
        encodec_path=args.encodec_path,
        tokenizer_path=args.tokenizer_path,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        seed=args.seed,
        device=args.device,
    )
    if args.int8:
        for name in ("semantic_stage", "coarse_stage", "fine_stage"):
            st = getattr(musiclm, name)
            setattr(musiclm, name, dataclasses.replace(st, quantized=True, flash_kv=args.flash_kv))
    return musiclm, mc


def generator(args) -> torch.Generator:
    """The sampling generator on the run's device, seeded by ``--seed``."""
    return torch.Generator(device=args.device).manual_seed(args.seed)


def window_kwargs(mc) -> dict:
    g = mc.global_cfg
    return dict(semantic_window_seconds=int(g.semantic_audio_length_seconds),
                coarse_window_seconds=int(g.coarse_audio_length_seconds),
                fine_window_seconds=int(g.fine_audio_length_seconds))


def wav_name(prompt: str) -> str:
    return prompt.replace(" ", "_")[:35]
