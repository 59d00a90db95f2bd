"""Closed-loop offline generation: ``MusicLM.generate`` called back to back
on batches of seeded CLAP token ids, as a catalogue job runs it.

Traffic parameters (``benchmark/traffic/<mix>.json``, kind "generate"):
``batch`` prompts a call; ``pool`` distinct prompt batches drawn from the
seed, used in turn; ``generate``: the keyword arguments of every call
(clip length, windows, temperatures); ``greedy_every``: every n-th call
(the first of the window included) decodes greedily, so that its tokens can
be checked; ``check_rows``: prompts of the last greedy call the reference
follows.

The window runs calls until ``--seconds`` have passed and ends when the
last call has returned, so no call is half counted. ``audio_s_per_s`` is
the audio of every call over the whole window. A traced run traces the
calls of its first ``trace_seconds`` (reading a longer trace would take
minutes), and its per-layer readers take the spans inside them.
"""

from __future__ import annotations

import sys
import time
from typing import Any, Dict, List

import torch

from .. import system
from .. import weights as W
from ..reference.encodec import EncodecDecoderReference
from ..spans import Spans
from ..trace import Trace
from .common import (Context, Outcome, free, greedy_stage_gaps, judge, memory_peak, reference_mode,
                     wave_error)

GREEDY = {"semantic_temperature": 0.0, "coarse_temperature": 0.0, "fine_temperature": 0.0}


def stage_note(name: str, specs):
    n_q = specs[-1][1]

    def note(args, kwargs, out) -> Dict[str, Any]:
        cond = [c.reshape(c.shape[0], -1) for c in args[0]]
        rows = cond[0].shape[0]
        init = kwargs.get("init_pred_ids")
        n_init = 0 if init is None else init.reshape(rows, -1).shape[1]
        n_new = int(kwargs["max_time_steps"]) * n_q - n_init
        keys = kwargs.get("per_row_keys")
        return {"stage": name, "cond": cond, "tokens": out.reshape(rows, -1), "n_init": n_init,
                "n_new": n_new, "rows": rows, "prefill_len": sum(c.shape[1] + 1 for c in cond) + len(specs) + n_init,
                "temperature": float(kwargs.get("temperature", 1.0)),
                "filter_thres": float(kwargs.get("filter_thres", 0.9)),
                "keys": None if keys is None else keys.clone()}
    return note


def codec_note(args, kwargs, out) -> Dict[str, Any]:
    return {"codes": args[0], "wave": out}


def instrument(lm, parts, spans: Spans) -> None:
    """Spans around each stage call and the codec decode of one MusicLM."""
    for name in system.STAGES:
        stage = getattr(lm, f"{name}_stage")
        spans.wrap(stage, "generate", f"stage.{name}", stage_note(name, parts[name]["dims"]["specs"]))
    spans.wrap(lm, "_decode", "codec", codec_note)


def run(ctx: Context) -> Outcome:
    cfg, tr = ctx.config, ctx.traffic
    spans = Spans(ctx.trace, ctx.sync)
    lm, parts = system.build_musiclm(cfg, ctx.seed, ctx.device, text=False)
    instrument(lm, parts, spans)
    b = tr["batch"]
    rq = cfg["model"]["clap_rvq_cfg"]
    gen = W.generator(ctx.seed, "prompts", ctx.device)
    pool = torch.randint(0, rq["codebook_size"], (tr["pool"] + 1, b, rq["rq_num_quantizers"], 1),
                         generator=gen, device=ctx.device)
    sampler = W.generator(ctx.seed, "sampling", ctx.device)

    def call(i: int, greedy: bool) -> torch.Tensor:
        kw = dict(tr["generate"], **(GREEDY if greedy else {}))
        return lm.generate(clap_token_ids=pool[i], generator=sampler, **kw)

    call(tr["pool"], greedy=False)  # warm-up: every shape of the window
    ctx.sync()
    setup_s = ctx.since_start()

    calls: List[Dict[str, Any]] = []
    spans.active = True
    tracer = Trace(ctx.trace)
    tracer.start()
    t0 = time.perf_counter()
    t_traced = None
    while time.perf_counter() - t0 < ctx.seconds:
        if t_traced is None and time.perf_counter() - t0 >= tr.get("trace_seconds", ctx.seconds):
            t_traced = time.perf_counter()  # the last call has synchronised; stopping takes seconds
            tracer.stop()
        i = len(calls)
        greedy = i % tr["greedy_every"] == 0
        first = len(spans.records)
        wave = call(i % tr["pool"], greedy)
        ctx.sync()
        calls.append({"t1": time.perf_counter(), "greedy": greedy, "rows": wave.shape[0],
                      "samples": wave.shape[-1], "records": spans.records[first:]})
    window_s = calls[-1]["t1"] - t0
    if t_traced is None:
        tracer.stop()
        t_traced = calls[-1]["t1"]
    spans.active = False
    peak = memory_peak(ctx)
    t_read = time.perf_counter()
    summary = tracer.summary()
    t_read = time.perf_counter() - t_read

    rate = lm.codec.sample_rate
    audio_s = sum(c["rows"] * c["samples"] for c in calls) / rate
    dims = {n: parts[n]["dims"] for n in system.STAGES}
    traced = [r for r in spans.records if r["t1"] <= t_traced]
    layer = {"spans": traced, "window_s": t_traced - t0, "trace": summary, "dims": dims,
             "calls": len(calls), "weight_bytes": 1.0 if cfg["flash_kv"] in ("int8", "fused") else 2.0}

    # ---- the check: the last greedy call, at prompts drawn from the seed ----
    target = [c for c in calls if c["greedy"]][-1]
    del lm, call, pool, sampler
    free(ctx)
    t_check = time.perf_counter()
    reference_mode(ctx)
    pick = torch.Generator().manual_seed(W.stream_seed(ctx.seed, "check"))
    rows = torch.randperm(b, generator=pick)[: tr["check_rows"]].tolist()
    stage_recs = [r for r in target["records"] if r["name"].startswith("stage.")]
    weights = {n: system.stage_weights(parts, n, ctx.seed, cfg, ctx.device) for n in system.STAGES}
    gaps = greedy_stage_gaps(weights, dims, stage_recs, b, rows, ctx.device, ctx.control)
    del weights
    codec = next(r for r in target["records"] if r["name"] == "codec")
    cw = system.codec_weights(parts, ctx.seed, cfg, ctx.device)
    codes = codec["codes"][rows].to(ctx.device)
    ref_wave = EncodecDecoderReference(cw).decode(codes)
    numbers = {"logit_gap": gaps["gap"], "wave_rel_err": wave_error(ref_wave, codec["wave"][rows].to(ctx.device))}
    control = None
    if ctx.control:
        ctl_wave = EncodecDecoderReference(cw, dtype=torch.bfloat16).decode(codes)
        control = {"logit_gap": gaps["control_gap"], "wave_rel_err": wave_error(ref_wave, ctl_wave)}
    print(f"generate: {len(calls)} calls in {window_s:.3f} s, setup {setup_s:.1f} s, trace read {t_read:.1f} s, "
          f"check {time.perf_counter() - t_check:.1f} s ({gaps['tokens']} tokens)", file=sys.stderr)
    correct, checks = judge(numbers, ctx.limits)
    return Outcome(correct=correct, attempted=len(calls) * b, failed=0,
                   e2e={"audio_s_per_s": audio_s / window_s, "setup_s": setup_s}, layer=layer,
                   memory_peak_bytes=peak, checks=checks, trace=summary, window_s=t_traced - t0,
                   control=control)
