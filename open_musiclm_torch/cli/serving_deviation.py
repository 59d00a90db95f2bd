"""How far the int8 serving stack's tokens move from the fp decode, at a
model config's real stage geometry (port of
scripts/measure_serving_deviation.py).

The serving stack (int8 weights, the flash-decode kernel over int8 cache
rows) approximates the fp decode. On bf16 weights with a seeded random init
and per-row keys 0..B-1 (the same keys give both paths the same Gumbel
noise), this measures, stage by stage:

  1. per-step agreement, teacher-forced: the serving path is scored along
     the fp path's own tokens, so a mismatch at step t means the serving
     kernels' logit perturbation flipped that step's noisy argmax;
  2. free-running divergence: the share of rows whose whole token sequence
     matches, and the mean first step where a row diverges;
  3. the knob ladder: each decode mode scored teacher-forced along the same
     fp tokens, one rung at a time (the flash modes stack on int8 weights);
  4. the logit perturbation: the serving path's top1 - top2 logit change
     along the fp tokens and its exceedance curve over a grid of gaps (what
     transfers to a trained checkpoint's margins);
  5. the margin sweep: the full stack re-scored with the logits scaled by s
     (temperature / s on both paths);
  6. end to end: the waveform SNR of MusicLM.generate, fp pipeline against
     serving pipeline, with the same per-row keys.

Differences from the JAX script, also written into the report
(``port_differences``):
  * no approx_topk: the port's top-k is exact (approx_max_k is a TPU op), so
    the ladder has no ``approx_topk_only_fp`` rung, ``serving_stack`` says
    ``approx_topk: false``, and ``full_stack`` is ``int8_w_plus_flash_int8``'s
    mode (its numbers are that rung's);
  * the ladder gains ``int8_w_plus_fused`` (flash_kv="fused": kernel 7, one
    launch a layer and decode step), the mode ``GenerationServer`` serves;
  * ``kernel_launches``: each rung's and the end-to-end runs' launches of
    the hand-written kernels, those that launched (``ops/launches.py``;
    none on the CPU, where the plain versions run).

    python -m open_musiclm_torch.cli.serving_deviation [--batch 16] [--json out.json]
    python -m open_musiclm_torch.cli.serving_deviation --device cpu --model_config tiny.json

``measure`` is the whole measurement as a function: ``step_fraction`` cuts
each stage's decode steps (and the end-to-end run's steps per second) to
that share of the real geometry, and ``serving`` is the stack under test
(``FP`` gives the fp-against-fp control: 0 % mismatch, every row and wave
identical, the SNR at its cap). The reductions (``token_mismatch``,
``free_running``, ``logit_perturbation``, ``waveform_comparison``) are
functions of numpy arrays.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .common import REPO_ROOT

STAGES = ("semantic", "coarse", "fine")
TEMPERATURES = {"semantic": 1.0, "coarse": 0.95, "fine": 0.4}  # the pipeline's (models/musiclm.py)
GAP_GRID = (0.01, 0.03, 0.1, 0.3, 1.0, 3.0)
FP = dict(quantized=False, flash_kv=None)
SERVING_STACK = dict(quantized=True, flash_kv="int8")
# one serving knob a rung; the flash modes live in the int8 decode, so each
# stacks on int8 weights and its own share is the delta from the rung before
LADDER = {
    "int8_weights_only": dict(quantized=True, flash_kv=None),
    "int8_w_plus_flash_bf16": dict(quantized=True, flash_kv="bf16"),
    # float32 cache rows: the same kernel, rows kept at full precision
    "int8_w_plus_flash_f32": dict(quantized=True, flash_kv="f32"),
    "int8_w_plus_flash_int8": dict(quantized=True, flash_kv="int8"),
    "int8_w_plus_fused": dict(quantized=True, flash_kv="fused"),
    "full_stack": SERVING_STACK,
}
PORT_DIFFERENCES = (
    "no approx_topk (exact top-k; no approx_topk_only_fp rung; full_stack is int8_w_plus_flash_int8's mode)",
    "the ladder adds int8_w_plus_fused (flash_kv='fused', kernel 7)",
    "kernel_launches: each rung's launches of the hand-written kernels",
)
PERTURBATION_NOTE = (
    "expected argmax flip rate at trained margins = P(|delta_top2| > gap) under the "
    "checkpoint's top-2 gap distribution; random-init gaps (p50 above) sit at the same "
    "scale as delta, which is why raw rates look large")
END_TO_END_NOTE = (
    "AR sampling compounds the first flipped token, so free-running waveforms diverge to "
    "decorrelated-but-valid audio once any step flips; the per-step teacher-forced mismatch "
    "above is the kernel-numerics metric")


# ---- reductions (numpy) ----

def token_mismatch(scored, ref) -> float:
    """Share of tokens where ``scored`` differs from ``ref``."""
    return float(np.mean(np.asarray(scored) != np.asarray(ref)))


def free_running(free, ref) -> dict:
    """Rows of ``free`` ([B, T, q]) identical to ``ref``'s, and the mean
    first flat step where a row diverges (the row's length if none)."""
    free, ref = np.asarray(free), np.asarray(ref)
    B = ref.shape[0]
    flat_ref, flat_free = ref.reshape(B, -1), free.reshape(B, -1)
    rows_equal = float(np.mean(np.all(flat_free == flat_ref, axis=1)))
    first_div = []
    for r in range(B):
        neq = np.nonzero(flat_ref[r] != flat_free[r])[0]
        first_div.append(int(neq[0]) if len(neq) else flat_ref.shape[1])
    return {
        "free_running_rows_identical_pct": round(100 * rows_equal, 1),
        "mean_first_divergence_step": round(float(np.mean(first_div)), 1),
        "total_flat_steps": int(flat_ref.shape[1]),
    }


def logit_perturbation(logits_fp, logits_srv, gap_grid: Sequence[float] = GAP_GRID) -> dict:
    """The serving logits' change along the fp tokens ([..., vocab] each;
    the masked EOS lane, below -1e8, left out): its RMS, the top1 - top2
    differential's |p50| / |p90|, the fp top-2 gap's p50, and the share of
    steps whose differential exceeds each gap of ``gap_grid``."""
    Lf = np.asarray(logits_fp, np.float32)
    Ls = np.asarray(logits_srv, np.float32)
    valid = (Lf > -1e8) & (Ls > -1e8)
    d = np.where(valid, Ls - Lf, 0.0)
    order = np.argsort(Lf, axis=-1)
    t1, t2 = order[..., -1:], order[..., -2:-1]
    take = np.take_along_axis
    d_eff = take(d, t1, -1)[..., 0] - take(d, t2, -1)[..., 0]
    gap_fp = take(Lf, t1, -1)[..., 0] - take(Lf, t2, -1)[..., 0]
    return {
        "delta_rms": round(float(np.sqrt(np.mean(d[valid] ** 2))), 4),
        "delta_top2_abs_p50": round(float(np.median(np.abs(d_eff))), 4),
        "delta_top2_abs_p90": round(float(np.quantile(np.abs(d_eff), 0.9)), 4),
        "fp_top2_gap_p50_random_init": round(float(np.median(gap_fp)), 4),
        "exceedance_pct": {f">{g:g}": round(100 * float(np.mean(np.abs(d_eff) > g)), 3) for g in gap_grid},
        "note": PERTURBATION_NOTE,
    }


def waveform_comparison(w_fp, w_srv) -> dict:
    """The serving waves' SNR against the fp waves ([B, samples]), and the
    share of rows that are identical."""
    w_fp, w_srv = np.asarray(w_fp, np.float32), np.asarray(w_srv, np.float32)
    err = w_fp - w_srv
    snr_db = 10.0 * np.log10((np.sum(w_fp ** 2) + 1e-12) / (np.sum(err ** 2) + 1e-12))
    rows_identical = float(np.mean(np.all(w_fp == w_srv, axis=-1)))
    return {"waveform_snr_db": round(float(snr_db), 2),
            "rows_waveform_identical_pct": round(100 * rows_identical, 1)}


# ---- the measurement ----

def geometry(mc, step_fraction: float = 1.0) -> Dict[str, tuple]:
    """Per stage (conditioning lengths, decode steps, temperature) at the
    config's single-window geometry; ``step_fraction`` cuts the decode steps."""
    g = mc.global_cfg
    sem_hz, ac_hz = mc.hubert_kmeans_cfg.output_hz, mc.encodec_cfg.output_hz
    n_clap = mc.clap_rvq_cfg.rq_num_quantizers
    geo = {
        "semantic": ((n_clap,), int(g.semantic_audio_length_seconds * sem_hz)),
        "coarse": ((n_clap, int(g.coarse_audio_length_seconds * sem_hz) - 1),
                   int(g.coarse_audio_length_seconds * ac_hz)),
        "fine": ((n_clap, int(g.fine_audio_length_seconds * ac_hz) * g.num_coarse_quantizers),
                 int(g.fine_audio_length_seconds * ac_hz)),
    }
    return {name: (lens, max(1, int(T * step_fraction)), TEMPERATURES[name]) for name, (lens, T) in geo.items()}


def teacher_forced(stage, cond, ref: torch.Tensor, T: int, keys: torch.Tensor, temperature: float,
                   return_logits: bool = False):
    """``stage`` scored along ``ref``'s tokens (``Stage.generate`` with
    ``teacher_forced_ids``): its ids [B, T, q], and with ``return_logits``
    its per-step float32 logits [B, T * q, vocab]."""
    return stage.generate(cond, None, max_time_steps=T, per_row_keys=keys, temperature=temperature,
                          teacher_forced_ids=ref, return_logits=return_logits)


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().cpu().numpy() if x.is_floating_point() else x.detach().cpu().numpy()


def build_parts(mc, device) -> dict:
    """The stage models (bf16, seeds 1-3) and the Encodec codec (bf16, its
    LSTM stem float32; seed 4) that ``measure`` runs, on ``device``."""
    from .. import config

    device = config.target_device(device, "serving_deviation")
    bf16 = torch.bfloat16
    models = {name: config.init_stage(mc, name, i, device=device, dtype=bf16).model
              for i, name in enumerate(STAGES, 1)}
    codec = config.build_encodec(mc, generator=torch.Generator().manual_seed(4), device=device).to(bf16)
    codec.decoder.lstm.float()  # the LSTM stem recurs in float32 (models/encodec.py)
    return {"models": models, "codec": codec}


def measure(mc, *, model: str = "musiclm_small", batch: int = 16, device="cuda", knobs: bool = True,
            margin_scales: Sequence[float] = (4.0, 16.0), step_fraction: float = 1.0,
            serving: Optional[dict] = None, parts: Optional[dict] = None, log=print) -> dict:
    """The report of the module docstring for model config ``mc`` (named
    ``model`` in it) with per-row keys 0..batch-1, on ``parts``
    (``build_parts``, built here if None)."""
    from .. import config
    from ..core.sampling import seed_keys
    from ..models.musiclm import MusicLM
    from ..models.stages import Stage
    from ..ops import launches

    device = config.target_device(device, "serving_deviation")
    serving = dict(SERVING_STACK if serving is None else serving)
    parts = parts or build_parts(mc, device)
    models, codec = parts["models"], parts["codec"]
    stage_cache: Dict[tuple, Stage] = {}

    def stage(name: str, mode: dict) -> Stage:
        key = (name, mode["quantized"], mode["flash_kv"])
        if key not in stage_cache:  # one Stage a mode, so its int8 weights are quantized once
            stage_cache[key] = Stage(models[name], name=name, quantized=mode["quantized"], flash_kv=mode["flash_kv"])
        return stage_cache[key]

    geo = geometry(mc, step_fraction)
    B = batch
    keys = seed_keys(range(B), device=device)
    conds = {}
    for name, (lens, _, _) in geo.items():
        specs = models[name].specs
        conds[name] = [
            torch.randint(0, specs[i].codebook_size, (B, n), generator=torch.Generator().manual_seed(40 + i)).to(device)
            for i, n in enumerate(lens)]
    report = {
        "model": model,
        "batch_rows": B,
        "serving_stack": {"int8_weights": bool(serving["quantized"]), "flash_kv": serving["flash_kv"],
                          "approx_topk": False},
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else str(device),
        "port_differences": list(PORT_DIFFERENCES),
        "stages": {},
        "kernel_launches": {},
    }
    if step_fraction != 1.0:
        report["decode_step_fraction"] = step_fraction

    # per-step agreement (teacher-forced) and free-running divergence
    fp_refs, scored_memo = {}, {}

    def mismatch(rung_mode: dict, name: str, ref: torch.Tensor, temp: float, counted=None) -> float:
        """The mode's teacher-forced mismatch along ``ref``; its kernel
        launches are added to ``counted``. The fp tokens at (stage,
        temperature) are one tensor, so the key names a scoring, and a mode
        scored twice (full_stack) reuses the first scoring and its launches."""
        key = (rung_mode["quantized"], rung_mode["flash_kv"], name, temp)
        if key not in scored_memo:
            _, T, _ = geo[name]
            before = launches.counts()
            scored = teacher_forced(stage(name, rung_mode), conds[name], ref, T, keys, temp)
            scored_memo[key] = token_mismatch(_np(scored), _np(ref)), launches.since(before)
        value, n = scored_memo[key]
        if counted is not None:
            for k, v in n.items():
                counted[k] = counted.get(k, 0) + v
        return value

    for name, (_, T, temp) in geo.items():
        ref = stage(name, FP).generate(conds[name], None, max_time_steps=T, per_row_keys=keys, temperature=temp)
        fp_refs[name] = ref
        step_mismatch = mismatch(serving, name, ref, temp)
        free = stage(name, serving).generate(conds[name], None, max_time_steps=T, per_row_keys=keys,
                                             temperature=temp)
        report["stages"][name] = {"decode_steps": T, "quantizers": int(ref.shape[-1]), "temperature": temp,
                                  "per_step_token_mismatch_pct": round(100 * step_mismatch, 3),
                                  **free_running(_np(free), _np(ref))}
        log(f"{name}: {json.dumps(report['stages'][name])}")

    # the knob ladder, each rung teacher-forced along the fp tokens
    if knobs:
        report["knob_attribution"] = {}
        for rung, mode in LADDER.items():
            counted = {}
            report["knob_attribution"][rung] = {
                name: round(100 * mismatch(mode, name, fp_refs[name], temp, counted), 3)
                for name, (_, _, temp) in geo.items()}
            report["kernel_launches"][rung] = {k: v for k, v in counted.items() if v}
            log(f"knob {rung}: {json.dumps(report['knob_attribution'][rung])}")

    # the logit perturbation along the fp tokens
    report["logit_perturbation"] = {}
    for name, (_, T, temp) in geo.items():
        _, logits_fp = teacher_forced(stage(name, FP), conds[name], fp_refs[name], T, keys, temp, True)
        _, logits_srv = teacher_forced(stage(name, serving), conds[name], fp_refs[name], T, keys, temp, True)
        report["logit_perturbation"][name] = logit_perturbation(_np(logits_fp), _np(logits_srv))
        lp = report["logit_perturbation"][name]
        log(f"logit_perturbation {name}: {json.dumps(lp['exceedance_pct'])} (delta_rms {lp['delta_rms']})")

    # the margin sweep: logits x s == temperature / s on both paths
    if margin_scales:
        report["margin_sweep_full_stack"] = {}
        for s in margin_scales:
            row = {}
            for name, (_, T, temp) in geo.items():
                t_eff = temp / s
                ref_s = stage(name, FP).generate(conds[name], None, max_time_steps=T, per_row_keys=keys,
                                                 temperature=t_eff)
                row[name] = round(100 * mismatch(serving, name, ref_s, t_eff), 3)
            report["margin_sweep_full_stack"][f"x{s:g}"] = row
            log(f"margin x{s:g}: {json.dumps(row)}")

    # end to end: MusicLM.generate, fp pipeline against serving pipeline
    g = mc.global_cfg
    n_clap = mc.clap_rvq_cfg.rq_num_quantizers
    clap_tokens = torch.randint(0, mc.clap_rvq_cfg.codebook_size, (B, n_clap, 1),
                                generator=torch.Generator().manual_seed(5)).to(device)
    gen_kw = dict(
        clap_token_ids=clap_tokens, per_row_keys=keys, output_seconds=4.0,
        semantic_window_seconds=int(g.semantic_audio_length_seconds),
        coarse_window_seconds=int(g.coarse_audio_length_seconds),
        fine_window_seconds=int(g.fine_audio_length_seconds),
        semantic_steps_per_second=mc.hubert_kmeans_cfg.output_hz * step_fraction,
        acoustic_steps_per_second=mc.encodec_cfg.output_hz * step_fraction,
    )
    waves = {}
    for label, mode in (("serving", serving), ("fp", FP)):
        lm = MusicLM(codec=codec, **{f"{n}_stage": stage(n, mode) for n in STAGES})
        before = launches.counts()
        waves[label] = _np(lm.generate(**gen_kw))
        report["kernel_launches"][f"end_to_end_{label}"] = launches.since(before, nonzero=True)
    report["end_to_end"] = {"output_seconds": 4.0, "wave_samples": int(waves["fp"].shape[-1]),
                            **waveform_comparison(waves["fp"], waves["serving"]), "note": END_TO_END_NOTE}
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=16, help="rows = independent per-row keys")
    ap.add_argument("--model_config", default=str(REPO_ROOT / "configs/model/musiclm_small.json"))
    ap.add_argument("--json", default=None, help="also write the report here")
    ap.add_argument("--knobs", type=int, default=1, help="also score each serving knob alone (the ladder)")
    ap.add_argument("--margin_scales", default="4,16",
                    help="comma list of logit-margin scales for the sweep ('' disables)")
    ap.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    from ..config import load_model_config

    mc = load_model_config(args.model_config)
    report = measure(mc, model=Path(args.model_config).stem, batch=args.batch, device=args.device, knobs=bool(args.knobs),
                     margin_scales=[float(s) for s in args.margin_scales.split(",") if s])
    print(json.dumps(report))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
