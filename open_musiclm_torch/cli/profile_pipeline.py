"""Wall time of each piece of the generation pipeline at one batch (port of
scripts/profile_pipeline.py).

Times each piece alone, bf16 weights with a seeded random init: the
semantic stage's first window, the coarse stage's window, the fine stage's
batched windows, Encodec's decode of the whole clip (``MusicLM``'s own
decode: a row at a time on the card) and the CLAP text tower (RoBERTa-base
with the config's HTSAT geometry, as the JAX script builds it) plus the
RVQ. Each piece runs once to warm, then ``--reps`` times between two
``torch.cuda.synchronize()``: the wall a call, in seconds. The stages
decode in ``Stage``'s default mode: ``--int8 1`` the int8 decode, with
``flash_kv`` from ``$OPEN_MUSICLM_FLASH_KV``, as in the JAX package.

Beyond the JAX script's keys, ``launches`` gives each piece's device
launches a call (the CUDA kernels, copies and memsets of one profiled
call; on the CPU its host ops), so that a host-bound piece shows as such,
``kernel_launches`` the hand-written kernels' launches a call (those that
launched; ``ops/launches.py``), and ``flash_kv`` the stages' mode.

    python -m open_musiclm_torch.cli.profile_pipeline --batch 16 --seconds 4
    OPEN_MUSICLM_FLASH_KV=fused python -m open_musiclm_torch.cli.profile_pipeline
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, Optional

import torch

from .common import REPO_ROOT

PIECES = ("semantic_window_s", "coarse_window_s", "fine_batched_s", "encodec_decode_s", "clap_text_s")


def build_text_tower(mc, text_cfg, audio_cfg, *, device, generator: torch.Generator,
                     rvq_generator: torch.Generator):
    """The CLAP (``text_cfg``'s RoBERTa and ``audio_cfg``'s audio tower) in
    bf16 with a seeded random init, and a ``clap_rvq_cfg`` RVQ over its
    joint embedding."""
    from ..models.clap.clap import CLAP, JOINT_EMBED, ClapQuantized
    from ..models.rvq import rvq_init, rvq_to

    cfg = mc.clap_rvq_cfg
    model = CLAP(text_cfg, generator=generator, audio_cfg=audio_cfg, compute_dtype=torch.bfloat16)
    model = model.to(device=device, dtype=torch.bfloat16).eval()
    rvq = rvq_init(cfg.rq_num_quantizers, cfg.codebook_size, JOINT_EMBED, rvq_generator)
    return ClapQuantized(model=model, rvq=rvq_to(rvq, device), num_quantizers=cfg.rq_num_quantizers,
                         codebook_size=cfg.codebook_size, sample_rate=audio_cfg.sample_rate,
                         clip_samples=audio_cfg.clip_samples)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn: Callable, reps: int, device: torch.device) -> float:
    """Seconds a call of ``fn``: one warm call, then ``reps`` calls between
    two synchronizations of the device."""
    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / reps


def device_launches(pieces: Dict[str, Callable], device: torch.device) -> Dict[str, int]:
    """Device launches of one call of each piece: every piece under one
    torch.profiler session in its own ``annotate`` range, synchronised at
    its end, and the device events counted by range
    (``profiling.range_launches``)."""
    from .. import profiling

    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        for name, fn in pieces.items():
            with profiling.annotate(name):
                fn()
                _sync(device)
    return profiling.range_launches(prof, set(pieces))


def profile(mc, *, batch: int = 16, seconds: float = 4, int8: bool = True, reps: int = 3, device="cuda",
            text_cfg=None, audio_cfg=None, parts: Optional[dict] = None) -> dict:
    """The report of the module docstring. ``text_cfg`` / ``audio_cfg``
    default to RoBERTa-base and the config's CLAP audio tower; ``parts``
    (``serving_deviation.build_parts``: the bf16 stage models from seeds
    1-3 and the codec) are built here if None."""
    from .. import config
    from ..models.musiclm import MusicLM
    from ..models.stages import Stage
    from ..ops import launches as kernel_counts
    from .serving_deviation import build_parts

    device = config.target_device(device, "profile_pipeline")
    parts = parts or build_parts(mc, device)
    stages = {name: Stage(model, name=name, quantized=bool(int8)) for name, model in parts["models"].items()}
    b = batch
    g = mc.global_cfg
    sem_hz, ac_hz = mc.hubert_kmeans_cfg.output_hz, mc.encodec_cfg.output_hz
    n_clap = mc.clap_rvq_cfg.rq_num_quantizers
    coarse_s, fine_s = g.coarse_audio_length_seconds, g.fine_audio_length_seconds

    def ids(seed: int, high: int, *shape) -> torch.Tensor:
        return torch.randint(0, high, shape, generator=torch.Generator().manual_seed(seed)).to(device)

    def gen(seed: int) -> torch.Generator:
        return torch.Generator(device=device).manual_seed(seed)

    specs = {name: st.model.specs for name, st in stages.items()}
    clap_ids = ids(5, specs["semantic"][0].codebook_size, b, n_clap)
    sem_T = int(min(seconds, g.semantic_audio_length_seconds) * sem_hz)
    sem_win = ids(6, specs["coarse"][1].codebook_size, b, int(coarse_s * sem_hz) - 1)
    coarse_T = int(coarse_s * ac_hz)
    n_fine_windows = max(int(seconds // fine_s), 1)
    n_coarse_q = g.num_coarse_quantizers
    coarse_win = ids(7, specs["fine"][1].codebook_size, b * n_fine_windows, int(fine_s * ac_hz) * n_coarse_q)
    clap_rep = clap_ids.repeat(n_fine_windows, 1)

    musiclm = MusicLM(codec=parts["codec"], **{f"{name}_stage": st for name, st in stages.items()})
    n_q = n_coarse_q + g.num_fine_quantizers
    codes = ids(8, mc.encodec_cfg.codebook_size, b, int(seconds * ac_hz), n_q)

    text_cfg = text_cfg if text_cfg is not None else config.RobertaConfig()
    audio_cfg = audio_cfg if audio_cfg is not None else config.audio_config_from_name(
        mc.clap_rvq_cfg.amodel_type, enable_fusion=mc.clap_rvq_cfg.enable_fusion)
    clap = build_text_tower(mc, text_cfg, audio_cfg, device=device, generator=torch.Generator().manual_seed(9),
                            rvq_generator=torch.Generator().manual_seed(10))
    input_ids = ids(11, min(50000, text_cfg.vocab_size), b, 77)
    mask = torch.ones_like(input_ids)

    pieces = {
        "semantic_window_s": lambda: stages["semantic"].generate([clap_ids], gen(1), max_time_steps=sem_T),
        "coarse_window_s": lambda: stages["coarse"].generate([clap_ids, sem_win], gen(2), max_time_steps=coarse_T,
                                                             temperature=0.95),
        "fine_batched_s": lambda: stages["fine"].generate([clap_rep, coarse_win], gen(3),
                                                          max_time_steps=int(fine_s * ac_hz), temperature=0.4),
        "encodec_decode_s": lambda: musiclm._decode(codes),
        "clap_text_s": lambda: clap.tokenize_text(input_ids, mask),
    }
    report = {"batch": b, "seconds": seconds, "int8": bool(int8), "flash_kv": stages["semantic"].flash_kv,
              "device": torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)}
    per_call = {}
    with torch.no_grad():
        for name, fn in pieces.items():
            before = kernel_counts.counts()
            report[name] = timed(fn, reps, device)
            per_call[name] = {k: n // (reps + 1) for k, n in kernel_counts.since(before).items() if n}
        report["launches"] = device_launches(pieces, device)
    report = {k: (round(v, 4) if isinstance(v, float) else v) for k, v in report.items()}
    report["kernel_launches"] = per_call
    report["audio_seconds_per_batch"] = b * seconds
    return report


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--seconds", type=float, default=4)
    p.add_argument("--int8", type=int, default=1)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--model_config", default=str(REPO_ROOT / "configs/model/musiclm_small.json"))
    p.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = p.parse_args(argv)

    from ..config import load_model_config

    report = profile(load_model_config(args.model_config), batch=args.batch, seconds=args.seconds,
                     int8=bool(args.int8), reps=args.reps, device=args.device)
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
