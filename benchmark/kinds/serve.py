"""Open-loop text serving through ``GenerationServer``: requests arrive on
a fixed schedule whatever the server does, as independent users send them.

Traffic parameters (``benchmark/traffic/<mix>.json``, kind "serve"):
``rate`` requests a second; the window holds ``round(rate * seconds)``
requests; ``arrivals`` "even" sends one every ``1 / rate`` s, the same
times for every seed, and "exponential" (the default) puts the exponential
distribution's quantiles between them, in an order drawn from the seed;
prompts of ``min_words``..``max_words`` words drawn from ``words``, every
length as often whatever the seed, in an order drawn from it; ``server``: GenerationServer's settings (buckets,
batch size, workers, batch timeout); ``generate``: the keyword arguments of
every batch; ``check_requests``: requests the reference follows.

Each request is timed from the moment it was due to be sent until its
future resolved; the generator's lateness goes to standard error. Every
request of the window is drained before the line prints. A request that
fails counts in ``failed`` and makes the run not correct. A traced run
traces the window the requests were sent in, and its per-layer readers
take the spans that ended inside it.
"""

from __future__ import annotations

import math
import shutil
import statistics
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Dict, List

import torch

from .. import system
from .. import weights as W
from ..demo_vocab import write_demo_vocab
from ..reference import keys as K
from ..reference.encodec import EncodecDecoderReference
from ..reference.stage import StageReference
from ..reference.text import TextReference, bpe_ids
from ..spans import Spans
from ..trace import Trace
from .common import Context, Outcome, free, judge, memory_peak, reference_mode, wave_error
from .generate import instrument

NEG_INF = -1e9


def schedule(rate: float, seconds: float, seed: int, arrivals: str = "exponential") -> List[float]:
    """Due times (s from the window's start) of the window's requests."""
    n = max(1, round(rate * seconds))
    if arrivals == "even":
        return [(i + 0.5) / rate for i in range(n)]
    if arrivals != "exponential":
        raise ValueError(f"arrivals {arrivals!r}: 'even' or 'exponential'")
    gaps = torch.tensor([-math.log(1.0 - (i + 0.5) / n) / rate for i in range(n)], dtype=torch.float64)
    order = torch.randperm(n, generator=torch.Generator().manual_seed(W.stream_seed(seed, "arrivals")))
    return torch.cumsum(gaps[order], 0).tolist()


def prompts(n: int, tr: Dict[str, Any], seed: int, tag: str) -> List[str]:
    g = torch.Generator().manual_seed(W.stream_seed(seed, tag))
    lo, hi, words = tr["min_words"], tr["max_words"], tr["words"]
    lengths = [lo + i % (hi - lo + 1) for i in range(n)]  # every length alike, whatever the seed
    lengths = [lengths[i] for i in torch.randperm(n, generator=g).tolist()]
    return [" ".join(words[j] for j in torch.randint(0, len(words), (k,), generator=g).tolist()) for k in lengths]


def request_seed(seed: int, k: int) -> int:
    return W.stream_seed(seed, f"request:{k}") >> 2  # positive; padding rows take negative seeds


def percentile(values: List[float], p: float) -> float:
    """The p-th percentile, linear between order statistics."""
    return statistics.quantiles(values, n=100, method="inclusive")[p - 1] if len(values) > 1 else values[0]


def run(ctx: Context) -> Outcome:
    from open_musiclm_torch.serve import GenerationServer

    cfg, tr = ctx.config, ctx.traffic
    spans = Spans(ctx.trace, ctx.sync)
    vocab_dir = Path(tempfile.mkdtemp(prefix="bench_vocab_"))
    vocab, merges = write_demo_vocab(vocab_dir)
    lm, parts = system.build_musiclm(cfg, ctx.seed, ctx.device, text=True, vocab_dir=vocab_dir)
    shutil.rmtree(vocab_dir)  # the tokenizer has read it
    instrument(lm, parts, spans)
    spans.wrap(lm, "clap_tokens_from_text", "text", lambda a, kw, out: {"rows": len(a[0])})
    inner_emb = lm.clap.text_embedding

    def text_embedding(*args, **kwargs):  # the tower's output, kept for the check
        out = inner_emb(*args, **kwargs)
        spans.local.emb = out
        return out

    lm.clap.text_embedding = text_embedding
    server = GenerationServer(lm, **tr["server"], **tr["generate"])
    batches: List[Dict[str, Any]] = []
    inner = server._run_header

    def run_header(header):
        sink = []
        spans.local.sink = sink
        t0 = time.perf_counter()
        try:
            waves = inner(header)
        finally:
            spans.local.sink = None
        if spans.active:
            batches.append({"seeds": list(header["seeds"]), "bucket": header["bucket"], "records": sink,
                            "clap": header["clap_token_ids"], "emb": spans.local.emb,
                            "t0": t0, "t1": time.perf_counter()})
        return waves

    server._run_header = run_header
    server.start()
    try:
        for i, bucket in enumerate(tr["server"]["batch_buckets"]):  # warm-up: one batch a bucket
            texts = prompts(bucket, tr, ctx.seed, f"warm:{i}")
            for f in [server.submit(t, seed=request_seed(ctx.seed, -1 - j)) for j, t in enumerate(texts)]:
                f.result()
        ctx.sync()
        setup_s = ctx.since_start()

        due = schedule(tr["rate"], ctx.seconds, ctx.seed, tr.get("arrivals", "exponential"))
        texts = prompts(len(due), tr, ctx.seed, "prompts")
        seeds = [request_seed(ctx.seed, k) for k in range(len(due))]
        done = [None] * len(due)
        futures = [None] * len(due)
        sent = [0.0] * len(due)
        spans.active = True
        tracer = Trace(ctx.trace)
        tracer.start()
        t0 = time.perf_counter()

        def send():
            for k, d in enumerate(due):
                wait = t0 + d - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                sent[k] = time.perf_counter()
                fut = server.submit(texts[k], seed=seeds[k])
                fut.add_done_callback(lambda f, k=k: done.__setitem__(k, time.perf_counter()))
                futures[k] = fut

        sender = threading.Thread(target=send, name="bench-sender")
        sender.start()
        sender.join()
        t_sent = time.perf_counter()
        tracer.stop()  # the traced window is the window the requests were sent in
        for f in futures:  # drain: every request of the window (a failure is counted below)
            f.exception()
        t_end = time.perf_counter()
        spans.active = False
    finally:
        server.stop()
    window_s = t_end - t0
    peak = memory_peak(ctx)
    t_read = time.perf_counter()
    summary = tracer.summary()
    t_read = time.perf_counter() - t_read

    failed = [k for k, f in enumerate(futures) if f.exception() is not None]
    lat = [(done[k] if k not in failed else math.inf) - (t0 + due[k]) for k in range(len(due))]
    late = [sent[k] - (t0 + due[k]) for k in range(len(due))]
    half = len(lat) // 2
    print(f"serve: {len(due)} requests at {tr['rate']} /s over {due[-1]:.3f} s, drained at {window_s:.3f} s; "
          f"sender late by at most {max(late):.6f} s (median {statistics.median(late):.6f}); "
          f"median latency first half {statistics.median(lat[:half] or lat):.4f} s, second half "
          f"{statistics.median(lat[half:]):.4f} s; batches (start s, wall s, requests, bucket): "
          f"{[(round(b['t0'] - t0, 3), round(b['t1'] - b['t0'], 3), sum(s >= 0 for s in b['seeds']), b['bucket']) for b in batches]}",
          file=sys.stderr)
    finite = [x for x in lat if x != math.inf]
    e2e = {"setup_s": setup_s}
    if not failed:
        e2e.update(request_p50_s=percentile(lat, 50), request_p80_s=percentile(lat, 80))
    traced = [r for r in spans.records if r["t1"] <= t_sent] if ctx.trace else spans.records
    layer = {"spans": traced, "window_s": t_sent - t0, "trace": summary,
             "dims": {n: parts[n]["dims"] for n in system.STAGES}, "batches": batches,
             "weight_bytes": 1.0 if cfg["flash_kv"] in ("int8", "fused") else 2.0}

    # ---- the check: requests drawn from the seed, each through the reference ----
    waves = {k: futures[k].result() for k in range(len(due)) if k not in failed}
    del lm, server
    free(ctx)
    reference_mode(ctx)
    pick = torch.Generator().manual_seed(W.stream_seed(ctx.seed, "check"))
    chosen = [k for k in torch.randperm(len(due), generator=pick).tolist() if k in waves][: tr["check_requests"]]
    t_check = time.perf_counter()
    numbers, control = check(ctx, parts, chosen, texts, seeds, waves, batches, vocab, merges)
    print(f"serve: setup {setup_s:.1f} s, trace read {t_read:.1f} s, check {time.perf_counter() - t_check:.1f} s",
          file=sys.stderr)
    if failed:
        numbers["failed_requests"] = float(len(failed))
    correct, checks = judge(numbers, dict(ctx.limits, failed_requests=0.0))
    return Outcome(correct=correct and not failed, attempted=len(due), failed=len(failed), e2e=e2e,
                   layer=layer, memory_peak_bytes=peak, checks=checks, trace=summary, window_s=t_sent - t0,
                   control=control)


def check(ctx, parts, chosen, texts, seeds, waves, batches, vocab, merges):
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    where = {}  # request -> (batch, row)
    for b in batches:
        for row, s in enumerate(b["seeds"]):
            where.setdefault(s, (b, row))
    numbers = {"text_err": 0.0, "token_gap": 0.0, "wave_rel_err": 0.0}
    control = {k: 0.0 for k in numbers} if ctx.control else None
    rq = cfg["model"]["clap_rvq_cfg"]
    books = system.rvq_codebooks(ctx.seed, rq["rq_num_quantizers"], rq["codebook_size"], 512, dev)
    cw = system.clap_weights(parts, ctx.seed, cfg, dev)
    ids, mask = zip(*(bpe_ids(texts[k], vocab, merges) for k in chosen))
    ids, mask = torch.tensor(ids, device=dev), torch.tensor(mask, device=dev)

    def row_of(k, key):
        b, row = where[seeds[k]]
        return torch.as_tensor(b[key][row])

    prog_codes = torch.stack([row_of(k, "clap") for k in chosen]).to(dev)
    prog_emb = torch.stack([row_of(k, "emb") for k in chosen]).to(dev).float()
    ref = TextReference(cw, books)
    ref_emb = ref.embedding(ids, mask)
    numbers["text_err"] = text_error(ref, ref_emb, prog_emb, prog_codes)
    if control is not None:
        ctl_emb = TextReference(cw, books, tf32_products=True).embedding(ids, mask)
        control["text_err"] = text_error(ref, ref_emb, ctl_emb, ref.rvq_codes(ctl_emb))
    del cw
    gen = tr["generate"]
    temps = {name: gen[f"{name}_temperature"] for name in system.STAGES}
    for name, stage_index in zip(system.STAGES, range(3)):
        w = system.stage_weights(parts, name, ctx.seed, cfg, dev)
        d = parts[name]["dims"]
        ref = StageReference(w, d["specs"], d["depth"], d["heads"], d["dim_head"])
        ctl = StageReference(w, d["specs"], d["depth"], d["heads"], d["dim_head"], precision="int4") if control else None
        del w
        for k in chosen:
            b, row = where[seeds[k]]
            recs = [r for r in b["records"] if r.get("stage") == name]
            for window, rec in enumerate(recs):
                per = rec["rows"] // b["bucket"]
                for wj in range(per):
                    i = wj * b["bucket"] + row
                    cond = [c[i:i + 1].to(dev) for c in rec["cond"]]
                    tokens = rec["tokens"][i:i + 1].to(dev)
                    win = window + wj
                    key = K.fold(K.seed_keys([seeds[k]], dev), stage_index, win)
                    noise = K.gumbel(K.step_subkeys(key, rec["n_new"]), d["vocab"])[0]
                    served = tokens[0, rec["n_init"]:]
                    logits = ref.logits(cond, tokens, rec["n_init"])[0]
                    thres = gen[f"{name}_filter_thres"]
                    numbers["token_gap"] = max(numbers["token_gap"], sampled_gap(
                        logits, served, noise, temps[name], thres))
                    if ctl is not None:
                        pick = choose(ctl.logits(cond, tokens, rec["n_init"])[0], noise, temps[name], thres)
                        control["token_gap"] = max(control["token_gap"], sampled_gap(
                            logits, pick, noise, temps[name], thres))
        del ref, ctl
        free(ctx)
    ref = EncodecDecoderReference(system.codec_weights(parts, ctx.seed, cfg, dev))
    ctl = EncodecDecoderReference(system.codec_weights(parts, ctx.seed, cfg, dev), torch.bfloat16) if control else None
    for k in chosen:
        b, row = where[seeds[k]]
        codes = next(r for r in b["records"] if r["name"] == "codec")["codes"][row:row + 1].to(dev)
        ref_wave = ref.decode(codes)
        numbers["wave_rel_err"] = max(numbers["wave_rel_err"], wave_error(ref_wave, torch.as_tensor(waves[k], device=dev)[None]))
        if ctl is not None:
            control["wave_rel_err"] = max(control["wave_rel_err"], wave_error(ref_wave, ctl.decode(codes)))
    return numbers, control


def text_error(ref: TextReference, ref_emb, emb, codes) -> float:
    """The worst row's ||emb - ref|| / ||ref|| of the text embedding; 1 (a
    fault) where the codes are not the nearest codes of that embedding."""
    if not ref.codes_exact(emb, codes.to(emb.device)):
        return 1.0
    return float(((emb - ref_emb).norm(dim=-1) / ref_emb.norm(dim=-1)).max())


def choose(logits: torch.Tensor, noise: torch.Tensor, temperature: float, thres: float) -> torch.Tensor:
    """The sampler's choice: EOS masked, top-k filtered, over T, plus noise."""
    x = logits.clone()
    x[:, -1] = NEG_INF
    k = max(int((1.0 - thres) * x.shape[-1]), 1)
    kth = torch.topk(x, k, dim=-1).values[:, -1:]
    x = torch.where(x < kth, torch.full_like(x, NEG_INF), x)
    return (x if temperature == 0.0 else x / temperature + noise).argmax(dim=-1)


def sampled_gap(logits, served, noise, temperature, thres) -> float:
    """How far, in logits, the reference would have to move for the served
    tokens to be its own choice, at the widest position: each reference
    competitor whose score beats the served token's must either lose its
    lead (``T * (score_c - score_t)``) or drop out of the top k below the
    first logit outside it (``logit_c - logit_{k+1}``), whichever is less,
    and a served token outside the reference's top k must enter it
    (``logit_k - logit_t``). Greedy (T = 0): ``max(logit) - logit_t``. A
    top-k boundary moves on rounding, so a plain gap of filtered scores
    would read a boundary token's Gumbel draw as an error."""
    x = logits.clone()
    x[:, -1] = -math.inf
    own_logit = x.gather(-1, served[:, None])
    if temperature == 0.0:
        return float((x.max(dim=-1, keepdim=True).values - own_logit).max())
    k = max(int((1.0 - thres) * x.shape[-1]), 1)
    top = torch.topk(x, k + 1, dim=-1).values
    kth, after = top[:, k - 1:k], top[:, k:k + 1]
    score = x / temperature + noise
    own = score.gather(-1, served[:, None])
    beats = (x >= kth) & (score > own)
    need = torch.minimum(temperature * (score - own), x - after)
    comp = torch.where(beats, need, torch.zeros_like(need)).amax(dim=-1)
    enter = (kth - own_logit)[:, 0].clamp(min=0)
    return float(torch.maximum(comp, enter).max())
