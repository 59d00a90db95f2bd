#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (open_musiclm_torch) on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root

Phases, each of which fails the run:
  1. build the hand-written kernels from open_musiclm_torch/csrc/ (one nvcc
     process per source, all started together);
  2. hold each kernel against its plain PyTorch version, in float32 and
     bfloat16, and time both: kernels 1-4 and 7 at the serving path's
     shapes (kernel 2 at b 8, 2 and 16 and pos 0 to 1279 with int8,
     activation-dtype and float32 rows, kernel 7 also at an odd batch, at
     the fine stage's 14 rows and at pos 0, beside one layer of the
     two-kernel decode step), kernel 1 (with a key mask and its row
     statistics) and kernels 5 and 6 (the attention backward) at the three
     training shapes; time one PyTorch library call computing the same
     function where there is one (scaled_dot_product_attention, and
     torch._weight_int8pack_mm where it runs on the card), and compute each
     kernel's bound (the least time the card could take: bytes over the
     memory rate or FLOPs over the peak rate, whichever is larger); kernel 3
     at b 8 and 16 also as GB/s and a share of 3.35 TB/s, kernel 5 (bf16) at
     each training shape as TFLOP/s beside SDPA's backward;
  3. hold every decode mode with kernels (CUDA) against the same decode on
     the CPU through the plain versions: per-step teacher-forced logits of
     the full-width semantic stage in float32, flash_kv "bf16", "int8",
     "f32", "fused" and None, and the fp decode;
  4. the serving path: MusicLM.generate on musiclm_small at full width
     (random weights from a seed, bf16): quantized=True, flash_kv="int8" at
     batch 8 x 4 s and batch 2 x 12 s (kernels 1-4), flash_kv="fused" at
     batch 8 x 4 s (kernel 7 exactly once per layer and decode step, kernels
     1 and 4), the fp decode (kernel 1) and flash_kv=None (kernels 1, 3, 4)
     at batch 2 x 4 s, each checking waveform shapes, finiteness and that
     exactly its kernels launched; then each mode's decode step on the
     semantic stage at batch 8: ms a step, CUDA launches a step and device
     busy time (torch.profiler);
  5. the training path: the full-width coarse stage's loss and every
     parameter gradient on the card (kernels 1, 5, 6) against the plain path
     on the CPU in float64, within 3x the CPU float32 path's own distance
     from float64 (a control with bf16 attention must fail that limit);
     then a token store written from a seed, read by
     PreprocessedDataset -> batch_iterator -> accumulate_token_batches into
     StageTrainer.train with the coarse trainer config of
     configs/training/train_musiclm_fma.json (batch 2 x accum 8, bf16 compute
     on float32 master weights, dropout 0.1, forgetful mask 0.15): 3 steps,
     one eval step, a checkpoint round trip, and kernels 1, 5, 6 launched.

Times a call, two readings of each kernel and library call:
  ms         stream time: CUDA events around 20 calls as the host launches
             them; for a kernel of a few microseconds this is the host's
             time to launch it (the Python wrapper included);
  device ms  the card's time: each of 20 calls between its own pair of
             events, all enqueued while a spin kernel holds the stream (the
             run is repeated with a longer spin if the spin ends before the
             host has enqueued them), and a 128 MiB buffer written between
             calls outside the events, so that every call finds the 50 MB L2
             cold, as a decode step's kernels find their layer's data.

Prints the card, the kernels' JSON summary, and as its last line
{"ok": true, "device": {...}}. Without a CUDA card it exits non-zero.
"""

from __future__ import annotations

import copy
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

PACKAGE = "open_musiclm_torch"
ROOT = Path(__file__).resolve().parent

# bf16 outputs are compared with the plain version computed in float32 on
# the same (bf16-valued) inputs: the kernel rounds its float32 result once
# to bf16, at most half a bf16 ulp = 2**-8 of the largest output's binade;
# the bound allows twice that. float32: both sides accumulate in float32 in
# another order over up to 2730 terms (~sqrt(K) * 6e-8 of the term sum).
TOL_REL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}

# NVIDIA's H100 SXM data sheet (dense, at the 700 W limit): memory rate and
# peak rates by operand type (bf16 on the tensor cores, float32 on the CUDA
# cores). A kernel's bound is the larger of bytes / rate and FLOPs / peak.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def to_device(tree, dev):
    """A quantize_stage_params tree (dicts, tuples, tensors) on ``dev``."""
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(to_device(v, dev) for v in tree)
    return tree.to(dev)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound_ms(n_bytes: float, flops: float, dtype: str):
    """(least ms, what bounds it) for moving n_bytes and doing flops."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def allowed_pairs(b: int, n: int, m: int, key_mask) -> int:
    """(batch, query, key) triples the causal and key masks let through: the
    score entries an attention kernel must compute for these inputs."""
    import torch

    allowed = torch.arange(m)[None, :] <= torch.arange(n)[:, None] + (m - n)
    if key_mask is None:
        return b * int(allowed.sum())
    return int((allowed[None] & key_mask.cpu()[:, None, :]).sum())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on a card", file=sys.stderr)
        return 2
    try:
        from open_musiclm_torch import config as omt_config
        from open_musiclm_torch.models.musiclm import MusicLM
        from open_musiclm_torch.models.stages import Stage
        from open_musiclm_torch.core.sequence import TokenSequenceSpec
        from open_musiclm_torch.models import token_cond
        from open_musiclm_torch.models.quant_decode import (
            flash_quant_decode_step, generate_quantized, quantize_stage_params)
        from open_musiclm_torch.models.token_cond import TokenConditionedTransformer
        from open_musiclm_torch.ops import attention, cuda_lib, decode_attention, fused_ff, fused_layer, quant
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2

    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # ---- 1. build ----
    t0 = time.perf_counter()
    lib_path = cuda_lib.build()
    cuda_lib.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {lib_path.name}")
    log = (cuda_lib.BUILD_DIR / "build.log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())

    # ---- 2. kernels against their plain versions ----
    g = torch.Generator(device="cpu").manual_seed(0)

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    def time_ms(fn, reps=20):
        """Stream ms a call: CUDA events around ``reps`` calls after a
        warm-up. For a kernel of a few microseconds this is the host's time
        to launch it (Python wrapper included), not the card's."""
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    spin = {}  # torch.cuda._sleep cycles a millisecond on this card, the L2 flush buffer

    def device_ms(fn, reps=20):
        """Device ms a call: ``reps`` calls, each between its own pair of
        CUDA events and after a write of a 128 MiB buffer (outside the events),
        all enqueued while a spin kernel (torch.cuda._sleep) holds the
        stream, so that the card runs them back to back and each finds L2
        cold. The spin lasts 1.5x the host's time to enqueue them, doubled
        until an event recorded just after it is still pending once the
        host has enqueued the last call."""
        if not spin:
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            torch.cuda._sleep(10_000_000)
            b.record()
            b.synchronize()
            spin["per_ms"] = 10_000_000 / a.elapsed_time(b)
            spin["flush"] = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)  # 2.5x the 50 MB L2

        def enqueue():
            events = []
            for _ in range(reps):
                spin["flush"].zero_()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                events.append((start, end))
            return events

        enqueue()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enqueue()
        spin_ms = 1.5 * (time.perf_counter() - t0) * 1e3 + 1.0
        torch.cuda.synchronize()
        for _ in range(6):
            held = torch.cuda.Event()
            torch.cuda._sleep(int(spin["per_ms"] * spin_ms))
            held.record()
            events = enqueue()
            held_through = not held.query()
            torch.cuda.synchronize()
            if held_through:
                return sum(a.elapsed_time(b) for a, b in events) / reps
            spin_ms *= 2
        fail(f"the spin kernel ran out before the host enqueued {reps} calls, {spin_ms / 2:.1f} ms at last")

    results = {}

    def compare(name, label, dtype, got, want):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err, ref_max = 0.0, 0.0
        for a, b in zip(got, want):
            a, b = a.float(), b.float()
            if not torch.isfinite(a).all():
                fail(f"{name} {label} {dtype}: non-finite output")
            err = max(err, (a - b).abs().max().item())
            ref_max = max(ref_max, b.abs().max().item())
        tol = TOL_REL[str(dtype).removeprefix("torch.")] * max(1.0, ref_max)
        return err, ref_max, tol

    def both_ms(fn, reps=20):
        """(stream ms, device ms) a call of ``fn``."""
        return time_ms(fn, reps), device_ms(fn, reps)

    def ratio(kernel, library):
        """kernel/library on both readings: (stream, device) pairs."""
        return f"kernel/library {kernel[0] / library[0]:.2f}x stream, {kernel[1] / library[1]:.2f}x device"

    def report(name, label, dtype, err, ref_max, tol, ms, plain_ms, summary=None, library=None):
        """Print one case; ``ms`` is the kernel's (stream ms, device ms) a
        call, ``plain_ms`` the plain version's stream ms; ``summary``
        (bytes, flops, library (stream, device) ms or None) marks the case
        whose numbers go into the kernels' JSON line; ``library`` ((stream,
        device) ms) prints kernel/library for another case."""
        ok = err <= tol
        lib_txt = f" {ratio(ms, library)}" if library else ""
        print(f"  {name:26s} {label:30s} {str(dtype):14s} max_abs_err {err:.3e} "
              f"max|ref| {ref_max:.3e} rel_err {err / max(ref_max, 1e-30):.3e} tol {tol:.3e} "
              f"kernel {ms[0]:.4f} ms (device {ms[1]:.4f}) plain {plain_ms:.4f} ms{lib_txt} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"{name} {label} {dtype}: max abs err {err} > {tol}")
        r = results.setdefault(name, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if summary is not None:
            n_bytes, flops, lib = summary
            b_ms, b_by = bound_ms(n_bytes, flops, str(dtype).removeprefix("torch."))
            r.update(ms=ms[0], plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     library_ms=lib[0] if lib else None, device_ms=ms[1],
                     library_device_ms=lib[1] if lib else None)
            lib_txt = f"{lib[0]:.4f} ms (device {lib[1]:.4f}), {ratio(ms, lib)}" if lib else "none"
            print(f"    -> summary case {label} {dtype}: {n_bytes / 1e6:.2f} MB, "
                  f"{flops / 1e9:.3f} GFLOP, bound {b_ms * 1e3:.2f} us ({b_by}), kernel/bound "
                  f"{ms[0] / b_ms:.1f}x stream, {ms[1] / b_ms:.1f}x device, library {lib_txt} [{card}]",
                  flush=True)

    def check(name, label, dtype, kernel_fn, plain_fn, inputs, keep_f32=(), summary=None,
              library=None):
        """kernel_fn on the inputs in ``dtype`` (int8 inputs and those named in
        keep_f32 stay as they are) against plain_fn on float32 copies of
        those same values; both sides are then timed on the ``dtype`` inputs.
        ``summary(low_inputs, output)`` -> (bytes, flops, library (stream,
        device) ms or None) marks the JSON case; ``library(low_inputs)`` ->
        (stream, device) ms prints kernel/library for another case. Returns
        the kernel's (stream, device) ms."""
        low = {k: v.to(dtype) if v.is_floating_point() and k not in keep_f32 else v
               for k, v in inputs.items()}
        ref_in = {k: v.float() if v.is_floating_point() else v for k, v in low.items()}
        got = kernel_fn(**low)
        want = plain_fn(**ref_in)
        torch.cuda.synchronize()
        err, ref_max, tol = compare(name, label, dtype, got, want)
        ms = both_ms(lambda: kernel_fn(**low))
        plain_ms = time_ms(lambda: plain_fn(**low))
        report(name, label, dtype, err, ref_max, tol, ms, plain_ms,
               summary(low, got) if summary is not None else None,
               library(low) if library is not None else None)
        return ms

    def sdpa_backend(fn):
        """The first SDPA backend that takes these inputs, to time it under."""
        from torch.nn.attention import SDPBackend, sdpa_kernel

        for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                   SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
            try:
                with warnings.catch_warnings(), sdpa_kernel([be]):
                    warnings.simplefilter("ignore")
                    fn()
                torch.cuda.synchronize()
                return be
            except RuntimeError:
                continue
        fail("no scaled_dot_product_attention backend takes these inputs")

    def library_time(label, fn, backend=None):
        """(stream ms, device ms) of ``fn`` (one scaled_dot_product_attention
        call) under ``backend``, by default the first that takes the inputs;
        the port never calls it. Returns (ms pair, backend)."""
        from torch.nn.attention import sdpa_kernel

        be = backend or sdpa_backend(fn)
        with sdpa_kernel([be]):
            ms = both_ms(fn)
        print(f"    library: {label}: {ms[0]:.4f} ms (device {ms[1]:.4f}) on SDPA backend {be.name}",
              flush=True)
        return ms, be

    def causal_float_mask(bias, key_mask, n, m, dtype):
        """bias [h, n, m] plus -1e9 where the causal or key mask hides a key,
        as SDPA's float attn_mask [b or 1, h, n, m]."""
        i = torch.arange(n, device=dev)[:, None]
        j = torch.arange(m, device=dev)[None, :]
        hidden = ~(j <= i + (m - n))[None, None]
        if key_mask is not None:
            hidden = hidden | ~key_mask[:, None, None, :]
        return bias.float()[None].masked_fill(hidden, -1e9).to(dtype)

    print("kernels vs plain versions:", flush=True)
    H, D, DIM, INNER, C = 8, 64, 1024, 2730, 1025
    # 1. prefill attention: coarse first window (b 8, n 216), coarse continuation
    #    (b 2, n 666), fine batched windows (b 16, n 467)
    for b, n in ((8, 216), (2, 666), (16, 467)):
        ins = dict(q=attention.l2norm(rand(b, H, n, D)), k=attention.l2norm(rand(b, n, D)),
                   v=rand(b, n, D), attn_bias=rand(H, n, n))
        for dt in (torch.bfloat16, torch.float32):
            def summary(low, out, b=b, n=n):
                mask = causal_float_mask(low["attn_bias"], None, n, n, low["q"].dtype)
                kx, vx = (low[t][:, None].expand(b, H, n, D) for t in ("k", "v"))
                lib = library_time(f"SDPA forward b{b} n{n}", lambda: F.scaled_dot_product_attention(
                    low["q"], kx, vx, attn_mask=mask, scale=8.0))[0]
                pairs = H * allowed_pairs(b, n, n, None)
                return (nbytes(low["q"], low["k"], low["v"], low["attn_bias"], out),
                        4 * D * pairs, lib)

            check("prefill_attention", f"b{b} n{n}", dt,
                  lambda q, k, v, attn_bias: attention.shared_kv_attention_fused(q, k, v, attn_bias),
                  lambda q, k, v, attn_bias: attention.shared_kv_attention(
                      q, k, v, attn_bias=attn_bias, causal=True),
                  ins, summary=summary if (b, n, dt) == (8, 216, torch.bfloat16) else None)
    # 2. flash decode: the coarse / fine cache (N 1280) at b 8, 2 and 16 (the
    #    bench's batch, one long request, the fine stage's windows) and pos 0,
    #    100, 700 and 1279 (one split to 20), with int8, activation-dtype and
    #    float32 rows (the "f32" cache mode). Beside every bf16 case, SDPA's
    #    one-query call over the same live rows (bf16 K/V expanded to 8 heads,
    #    bias row + mask as a float attn_mask) as kernel/library.
    N = 1280
    for b in (8, 2, 16):
        k, v = attention.l2norm(rand(b, N, D)), rand(b, N, D)
        kq, ks = decode_attention.quantize_kv_row(k)
        vq, vs = decode_attention.quantize_kv_row(v)
        caches = {"int8": (torch.cat([kq, vq], -1).contiguous(), torch.stack([ks, vs]).contiguous()),
                  "bf16": (torch.cat([k, v], -1).contiguous(), None),
                  "f32": (torch.cat([k, v], -1).contiguous(), None)}
        ins = dict(q_t=attention.l2norm(rand(b, H, D)), bias_row=rand(N, H),
                   add_mask=torch.zeros(b, N, device=dev))
        for pos in (0, 100, 700, N - 1):
            q4 = ins["q_t"].to(torch.bfloat16)[:, :, None]
            kvx = caches["bf16"][0].to(torch.bfloat16)
            kx = kvx[:, None, :, :D].expand(b, H, N, D)
            vx = kvx[:, None, :, D:].expand(b, H, N, D)
            j = torch.arange(N, device=dev)
            mask = (ins["bias_row"].t()[None, :, None, :] + ins["add_mask"][:, None, None, :])
            mask = mask.masked_fill(j > pos, -1e9).to(torch.bfloat16)
            lib_ms = library_time(f"SDPA one query b{b} N{N} pos{pos}",
                                  lambda: F.scaled_dot_product_attention(q4, kx, vx, attn_mask=mask, scale=8.0))[0]

            def summary(low, out, pos=pos, b=b, lib_ms=lib_ms):
                rows = pos + 1  # the kernel reads cache rows <= pos only
                row_bytes = low["kv_cache"].element_size() * 2 * D
                moved = (nbytes(low["q_t"], out) + b * rows * row_bytes
                         + rows * H * low["bias_row"].element_size() + b * rows * 4)
                return moved, 4 * b * H * D * rows, lib_ms

            for mode, (kv, sc) in caches.items():
                for dt in (torch.bfloat16, torch.float32):
                    check("flash_decode_step", f"{mode} b{b} N{N} pos{pos}", dt,
                          lambda q_t, kv_cache, bias_row, add_mask, pos=pos, sc=sc:
                              decode_attention.flash_decode_step(q_t, kv_cache, pos, bias_row, add_mask, sc),
                          lambda q_t, kv_cache, bias_row, add_mask, pos=pos, sc=sc:
                              decode_attention.flash_decode_step_plain(q_t, kv_cache, pos, bias_row, add_mask, sc),
                          dict(ins, kv_cache=kv),
                          keep_f32=("bias_row", "add_mask") + (("kv_cache",) if mode == "f32" else ()),
                          summary=summary if (b, mode, pos, dt) == (8, "bf16", N - 1, torch.bfloat16) else None,
                          library=(lambda low, lib_ms=lib_ms: lib_ms) if dt == torch.bfloat16 else None)
    # 3. fused FF: the fine stage's rows at batch 8 (2 windows x 8), and batch 8
    from open_musiclm_torch.models.transformer import ConvFeedForward

    ff = ConvFeedForward(DIM, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ff.norm_in.gamma.normal_(1.0, 0.1, generator=g)
        ff.norm_mid.gamma.normal_(1.0, 0.1, generator=g)
    packed = {k: v.to(dev) for k, v in fused_ff.pack_ff_weights(ff).items()}
    for b in (16, 8):
        ins = dict(x=rand(b, DIM), state=rand(b, 2, 2 * INNER))

        def summary(low, out, b=b):
            # no single PyTorch call computes LN -> int8 projections -> conv -> GEGLU -> LN
            return (nbytes(low["x"], low["state"], *packed.values(), *out),
                    2 * b * (DIM * 2 * INNER + INNER * DIM), None)

        for dt in (torch.bfloat16, torch.float32):
            ms = check("fused_ff_apply", f"b{b} dim{DIM} inner{INNER}", dt,
                       lambda x, state: fused_ff.fused_ff_apply(x, packed, state),
                       lambda x, state: fused_ff.fused_ff_apply_plain(x, packed, state), ins,
                       summary=summary if (b, dt) == (8, torch.bfloat16) else None)
            if dt == torch.bfloat16:
                # x and the state in, y and the new state out, every weight once
                moved = 2 * nbytes(ins["x"].to(dt), ins["state"].to(dt)) + nbytes(*packed.values())
                rate = moved / (ms[1] * 1e-3)
                print(f"    -> kernel 3 b{b} bf16: device {ms[1]:.4f} ms, {moved / 1e6:.2f} MB moved, "
                      f"{rate / 1e9:.1f} GB/s = {100 * rate / HBM_BYTES_PER_S:.1f} % of "
                      f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s [{card}]", flush=True)
    # 4. int8 matmul: the 1025-way logit head at b 8 and the fine rows b 16
    wq, s = quant.quantize_weight(torch.randn(DIM, C, generator=g))
    wq, s = wq.to(dev), s.to(dev)

    def int8pack_library(x, out):
        """(stream, device) ms of torch._weight_int8pack_mm (x @ int8
        W[out, in]^T * scales in x's dtype), the one PyTorch call computing
        kernel 4's function, where the installed PyTorch has it for CUDA;
        None, with its error, where not."""
        w_t, sc = wq.t().contiguous(), s.to(x.dtype)
        try:
            y = torch._weight_int8pack_mm(x, w_t, sc)
            torch.cuda.synchronize()
        except (RuntimeError, NotImplementedError) as e:
            print(f"    library: torch._weight_int8pack_mm: none on this card: {str(e).splitlines()[0][:300]}")
            return None
        ms = both_ms(lambda: torch._weight_int8pack_mm(x, w_t, sc))
        print(f"    library: torch._weight_int8pack_mm b{x.shape[0]}: {ms[0]:.4f} ms (device {ms[1]:.4f}; max abs diff from "
              f"the kernel {(y.float() - out.float()).abs().max().item():.3e}, scales in {x.dtype})")
        return ms
    for b in (8, 16):
        ins = dict(x=rand(b, DIM))

        def summary(low, out, b=b):
            return nbytes(low["x"], wq, s, out), 2 * b * DIM * C, int8pack_library(low["x"], out)

        for dt in (torch.bfloat16, torch.float32):
            check("int8_matmul", f"b{b} {DIM}x{C}", dt,
                  lambda x: quant.int8_matmul(x, wq, s),
                  lambda x: quant.int8_matmul_plain(x, wq, s), ins,
                  summary=summary if (b, dt) == (8, torch.bfloat16) else None)
    # 7. one whole decode layer: a full-width layer (seeded weights, LayerNorm
    #    gains and q/k scales drawn around 1) over the coarse / fine cache
    #    (N 1280) at b 8 with pos in the first and the last chunk, at the
    #    fine stage's b 14 (batch 2 x 7 windows), at an odd b 3 and at pos 0.
    #    The kernel writes the fresh row and the conv state in place, so each
    #    side gets its own copies. For context, one layer of the two-kernel
    #    flash_quant_decode_step (kernels 2 and 3 plus the plain projections
    #    and row write) over the same weights and cache.
    layer_model = TokenConditionedTransformer(
        (TokenSequenceSpec(1024, 1),), DIM, 1, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        for t in (*layer_model.transformer.attns[0].parameters(), *layer_model.transformer.ffs[0].parameters()):
            if t.dim() == 1:
                t.normal_(1.0, 0.1, generator=g)
    layer_model = layer_model.to(dev).eval()
    lpacked = fused_layer.pack_layer_weights(layer_model.transformer.attns[0], layer_model.transformer.ffs[0])
    lfn = fused_layer.fused_layer_decode_step
    two_model = copy.deepcopy(layer_model).to(torch.bfloat16)
    two_qp = {"ff_0": {"packed": fused_ff.pack_ff_weights(layer_model.transformer.ffs[0])}}
    for b, pos in ((8, 100), (8, N - 1), (14, N - 1), (3, 700), (8, 0)):
        kq, ks = decode_attention.quantize_kv_row(attention.l2norm(rand(b, N, D)))
        vq, vs = decode_attention.quantize_kv_row(rand(b, N, D))
        kv, sc = torch.cat([kq, vq], -1).contiguous(), torch.stack([ks, vs]).contiguous()
        x32, st32, bias_row = rand(b, DIM), rand(b, 2, 2 * INNER), rand(N, H)
        add_mask = torch.zeros(b, N, device=dev)
        label = f"b{b} N{N} pos{pos}"
        for dt in (torch.bfloat16, torch.float32):
            x, st = x32.to(dt), st32.to(dt)
            args = (pos, bias_row, add_mask)
            want = fused_layer.fused_layer_decode_step_plain(
                x.float(), lpacked, kv.clone(), sc.clone(), st.float().clone(), *args, heads=H)
            got = lfn(x, lpacked, kv.clone(), sc.clone(), st.clone(), *args, heads=H)
            torch.cuda.synchronize()
            err, ref_max, tol = compare("fused_layer_decode_step", label, dt, got, want)
            kv_t, sc_t, st_t = kv.clone(), sc.clone(), st.clone()
            ms = both_ms(lambda: lfn(x, lpacked, kv_t, sc_t, st_t, *args, heads=H))
            plain_ms = time_ms(lambda: fused_layer.fused_layer_decode_step_plain(
                x, lpacked, kv_t, sc_t, st_t, *args, heads=H), reps=5)
            summary = None
            if (b, pos, dt) == (8, N - 1, torch.bfloat16):
                # the cache rows j < pos and their scales, the bias rows and
                # the mask the step reads; every weight once; x and the state
                # in, y, krow, the state and the fresh row out
                moved = (nbytes(x, st, *lpacked.values(), *got) + b * pos * (2 * D + 8)
                         + (pos + 1) * H * 4 + b * pos * 4 + b * (2 * D + 8))
                flops = (2 * b * DIM * (2 * H * D + 2 * D + 3 * INNER)
                         + 4 * b * H * D * (pos + 1))
                summary = (moved, flops, None)  # no one PyTorch call computes a decode layer
                cache = {"kv": kv.clone()[None], "kvs": sc.clone()[None], "ff": st.clone()[None]}
                two = time_ms(lambda: flash_quant_decode_step(
                    two_model, two_qp, x, cache, pos, bias_row, add_mask, int8_kv=True))
                print(f"    two-kernel flash_quant_decode_step, one layer, {label} {dt}: {two:.4f} ms on the stream "
                      f"(kernels 2 + 3, plain projections, row write, final LayerNorm) [{card}]",
                      flush=True)
            report("fused_layer_decode_step", label, dt, err, ref_max, tol, ms, plain_ms, summary)
            del want, got
    del layer_model, lpacked, two_model, two_qp

    # 1 (training forward), 5 and 6 (the attention backward) at the training
    # shapes (semantic b4 n514, coarse b2 n1116, fine b2 n1217), with the bias
    # in the compute dtype (as the training path passes it) and a key mask
    # hiding 15 % of the keys (the forgetful mask's share; key 0 always kept).
    # Kernel 1 also writes each row's softmax statistics here, compared as
    # (row max, log denominator). One call runs kernels 5 and 6: kernel 5's
    # ms is the call without dbias, kernel 6's the call with it less that.
    bwd = attention.shared_kv_attention_bwd
    for stage_name, b, n in (("semantic", 4, 514), ("coarse", 2, 1116), ("fine", 2, 1217)):
        q32, k32 = attention.l2norm(rand(b, H, n, D)) * 1.5, attention.l2norm(rand(b, n, D)) * 1.5
        v32, dout32, bias32 = rand(b, n, D), rand(b, n, H * D), rand(H, n, n)
        key_mask = (torch.rand(b, n, generator=g) > 0.15).to(dev)
        key_mask[:, 0] = True
        label = f"{stage_name} b{b} n{n} mask"
        for dt in (torch.bfloat16, torch.float32):
            q, k, v, dout, bias = (t.to(dt) for t in (q32, k32, v32, dout32, bias32))
            fwd_args = (q, k, v, bias, key_mask)
            out, stats = attention.shared_kv_attention_fused(*fwd_args, return_stats=True)
            want_out, want_stats = attention.shared_kv_attention(
                q.float(), k.float(), v.float(), attn_bias=bias.float(), key_mask=key_mask,
                causal=True, return_stats=True)

            def max_and_log_denom(st):
                return torch.stack([st[..., 0], torch.log(st[..., 1])], dim=-1)

            torch.cuda.synchronize()
            ms1 = both_ms(lambda: attention.shared_kv_attention_fused(*fwd_args, return_stats=True))
            plain1 = time_ms(lambda: attention.shared_kv_attention(
                q, k, v, attn_bias=bias, key_mask=key_mask, causal=True, return_stats=True))
            lib1 = None
            if (stage_name, dt) == ("coarse", torch.bfloat16):
                # the library forward: SDPA with K/V expanded to 8 heads and the
                # bias + causal and key masks as a float attn_mask (no stats)
                mask = causal_float_mask(bias, key_mask, n, n, dt)
                kx, vx = (t[:, None].expand(b, H, n, D) for t in (k, v))
                lib1 = library_time(f"SDPA forward b{b} n{n} key mask", lambda: F.scaled_dot_product_attention(
                    q, kx, vx, attn_mask=mask, scale=8.0))[0]
                n_bytes = nbytes(q, k, v, bias, key_mask, out, stats)
                b_ms, b_by = bound_ms(n_bytes, 4 * D * H * allowed_pairs(b, n, n, key_mask), "bfloat16")
                print(f"    -> kernel 1 {label} bf16 with stats: {n_bytes / 1e6:.2f} MB, bound "
                      f"{b_ms * 1e3:.2f} us ({b_by}), kernel {ms1[0]:.4f} ms (device {ms1[1]:.4f}) = "
                      f"{ms1[0] / b_ms:.1f}x bound stream, {ms1[1] / b_ms:.1f}x device, "
                      f"{ratio(ms1, lib1)} [{card}]", flush=True)
                del mask, kx, vx
            report("prefill_attention", label, dt,
                   *compare("prefill_attention", label, dt, out, want_out), ms1, plain1, library=lib1)
            report("prefill_attention", label + " stats", dt,
                   *compare("prefill_attention", label + " stats", dt,
                            max_and_log_denom(stats), max_and_log_denom(want_stats)), ms1, plain1)

            args = (q, k, v, bias, key_mask, out, stats, dout)
            want = attention.shared_kv_attention_bwd_plain(
                q.float(), k.float(), v.float(), dout.float(), attn_bias=bias.float(),
                key_mask=key_mask)
            got = bwd(*args)
            torch.cuda.synchronize()
            ms5 = both_ms(lambda: bwd(*args, dbias=False))
            ms56 = both_ms(lambda: bwd(*args))
            plain_ms = time_ms(lambda: attention.shared_kv_attention_bwd_plain(
                q, k, v, dout, attn_bias=bias, key_mask=key_mask), reps=5)
            print(f"    kernels 5 + 6 in one call {ms56[0]:.4f} ms (device {ms56[1]:.4f}), kernel 5 alone "
                  f"{ms5[0]:.4f} ms (device {ms5[1]:.4f})", flush=True)
            sums = (None, None)
            if dt == torch.bfloat16:
                coarse = stage_name == "coarse"
                sum5, sum6 = backward_summaries(torch, F, dev, args, key_mask, library_time,
                                                causal_float_mask, with_dbias=coarse)
                if coarse:
                    sums = (sum5, sum6)
                lib5 = sum5[2]
                print(f"    -> kernel 5 {label} bf16: device {ms5[1]:.4f} ms, {sum5[1] / 1e9:.2f} GFLOP, "
                      f"{sum5[1] / (ms5[1] * 1e-3) / 1e12:.1f} TFLOP/s, SDPA backward (dq, dk, dv) "
                      f"device {lib5[1]:.4f} ms: kernel/SDPA {ms5[1] / lib5[1]:.2f}x device, "
                      f"{ms5[0] / lib5[0]:.2f}x stream [{card}]", flush=True)
            report("attention_bwd", label, dt, *compare("attention_bwd", label, dt, got[:3], want[:3]),
                   ms5, plain_ms, sums[0])
            report("attention_dbias", label, dt, *compare("attention_dbias", label, dt, got[3], want[3]),
                   (ms56[0] - ms5[0], ms56[1] - ms5[1]), plain_ms, sums[1])
            del out, stats, want_out, want_stats, args, want, got
    print("  (plain ms of attention_bwd / attention_dbias: one plain backward computing "
          "dq, dk, dv and dbias together)")
    spin.clear()  # frees the L2 flush buffer before the phases that read peak memory

    # ---- 3. every decode mode with kernels vs the plain path on the CPU ----
    # float32, 24 teacher-forced steps of the full-width semantic stage. With
    # unquantized cache rows ("bf16" rows are float32 here, "f32", None, and
    # the fp decode) only float32 rounding order differs: 1e-4 of the largest
    # logit. With int8 rows ("int8", "fused") a float32 difference at a
    # rounding boundary can move one cache element by a quantization step
    # (1/127 of its row's absmax), so those modes are held to 1e-2.
    mc = omt_config.load_model_config(str(ROOT / "configs" / "model" / "musiclm_small.json"))
    stage = omt_config.init_stage(mc, "semantic", 11, device="cpu", quantized=True)
    cond = torch.randint(0, 1024, (2, 12), generator=g)
    teacher = torch.randint(0, 1024, (2, 24, 1), generator=g)
    qp_cpu = quantize_stage_params(stage.model, fused=True)
    model_gpu = copy.deepcopy(stage.model).to(dev)
    qp_gpu = to_device(qp_cpu, dev)
    for mode, rel in (("bf16", 1e-4), ("int8", 1e-2), ("f32", 1e-4), ("fused", 1e-2),
                      (None, 1e-4), ("fp", 1e-4)):
        kw = dict(max_time_steps=24, temperature=0.0, teacher_ids=teacher, return_logits=True)
        if mode == "fp":
            _, want = token_cond.generate(stage.model, [cond], **kw)
            _, got = token_cond.generate(model_gpu, [cond.to(dev)], **kw)
        else:
            _, want = generate_quantized(stage.model, qp_cpu, [cond], flash_kv=mode, **kw)
            _, got = generate_quantized(model_gpu, qp_gpu, [cond.to(dev)], flash_kv=mode, **kw)
        got, want = got.cpu()[..., :-1], want[..., :-1]  # the EOS column is -1e9 on both
        err = (got - want).abs().max().item()
        tol = rel * max(1.0, want.abs().max().item())
        name = "fp decode (quantized=False)" if mode == "fp" else f"int8 decode, flash_kv={mode}"
        print(f"{name}, semantic stage f32, 24 teacher-forced steps: CUDA vs CPU plain logits "
              f"max_abs_err {err:.3e} tol {tol:.3e} (max |logit| {want.abs().max().item():.2f})",
              flush=True)
        if not err <= tol:
            fail(f"{name} logits differ: {err} > {tol}")
    del model_gpu, qp_gpu, stage

    # ---- 4. the serving path in every decode mode: MusicLM.generate at full width ----
    bf16 = torch.bfloat16
    stages = {
        f"{name}_stage": omt_config.init_stage(
            mc, name, seed, device=dev, dtype=bf16, quantized=True, flash_kv="int8")
        for name, seed in (("semantic", 1), ("coarse", 2), ("fine", 3))
    }
    codec = omt_config.build_encodec(mc, generator=torch.Generator().manual_seed(4), device=dev).to(bf16)
    codec.decoder.lstm.float()  # the LSTM stem recurs in float32 (see models/encodec.py)
    musiclm = MusicLM(codec=codec, **stages)
    kernels = [  # (name, counter: wrapper and attribute, source, TPU kernel replaced)
        ("prefill_attention", (attention.shared_kv_attention_fused, "launches"),
         "prefill_attention.cu", "open_musiclm_tpu/ops/pallas_attention.py:155"),
        ("flash_decode_step", (decode_attention.flash_decode_step, "launches"), "flash_decode.cu",
         "open_musiclm_tpu/ops/decode_attention.py:195"),
        ("fused_ff_apply", (fused_ff.fused_ff_apply, "launches"), "fused_ff.cu",
         "open_musiclm_tpu/ops/fused_ff.py:204"),
        ("int8_matmul", (quant.int8_matmul, "launches"), "int8_matmul.cu",
         "open_musiclm_tpu/ops/quant.py:80"),
        ("attention_bwd", (bwd, "launches"), "attention_bwd.cu",
         "open_musiclm_tpu/ops/pallas_attention.py:420"),
        ("attention_dbias", (bwd, "dbias_launches"), "attention_bwd.cu",
         "open_musiclm_tpu/ops/pallas_attention.py:475"),
        ("fused_layer_decode_step", (fused_layer.fused_layer_decode_step, "launches"),
         "fused_layer.cu", "open_musiclm_tpu/ops/fused_layer.py:348"),
    ]
    counters = {name: counter for name, counter, _, _ in kernels}
    gen = torch.Generator(device=dev).manual_seed(0)
    n_clap = mc.clap_rvq_cfg.rq_num_quantizers
    windows = dict(
        semantic_window_seconds=int(mc.global_cfg.semantic_audio_length_seconds),
        coarse_window_seconds=int(mc.global_cfg.coarse_audio_length_seconds),
        fine_window_seconds=int(mc.global_cfg.fine_audio_length_seconds),
    )

    def clap_tokens(batch):
        return torch.randint(0, mc.clap_rvq_cfg.codebook_size, (batch, n_clap, 1), generator=g).to(dev)

    def drive(musiclm, mode, runs):
        """MusicLM.generate for each (batch, seconds, waveform shape) of
        ``runs``, every kernel count set to 0 just before and read just
        after. Returns the counts."""
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        for batch, seconds, want_shape in runs:
            clap = clap_tokens(batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wave = musiclm.generate(clap_token_ids=clap, generator=gen, output_seconds=seconds, **windows)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            audio_s = wave.shape[0] * wave.shape[1] / codec.sample_rate
            print(f"MusicLM.generate {mode}, batch {batch} x {seconds} s: wave {tuple(wave.shape)} "
                  f"{wall:.2f} s wall, {audio_s / wall:.3f} audio-s/wall-s, "
                  f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]", flush=True)
            if tuple(wave.shape) != want_shape:
                fail(f"{mode}: waveform shape {tuple(wave.shape)} != {want_shape}")
            if not torch.isfinite(wave.float()).all():
                fail(f"{mode}: waveform has non-finite samples")
        return {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}

    def expect(mode, launches, path):
        """Fail unless exactly the kernels in ``path`` launched (and each did)."""
        print(f"  {mode} launches: {launches}")
        for name, n in launches.items():
            if (n > 0) != (name in path):
                fail(f"{mode}: kernel {name} launched {n} times; the path runs {sorted(path)}")

    # the int8 serving path (flash_kv="int8"): kernels 1-4
    launches = drive(musiclm, "flash_kv=int8", ((8, 4.0, (8, 96000)), (2, 12.0, (2, 336000))))
    expect("flash_kv=int8", launches, {"prefill_attention", "flash_decode_step", "fused_ff_apply", "int8_matmul"})
    path_launches = dict(launches)

    # the same models in the other decode modes: "fused" (kernel 7 once per
    # layer and step, kernel 4 once per step for the logits, kernel 1 per
    # window), the fp decode (kernel 1 only) and flash_kv=None (kernels 1, 3, 4)
    def restage(**mode):
        return MusicLM(codec=codec, **{key: Stage(st.model, name=st.name, **mode) for key, st in stages.items()})

    depth = len(stages["semantic_stage"].model.transformer.attns)
    launches = drive(restage(quantized=True, flash_kv="fused"), "flash_kv=fused", ((8, 4.0, (8, 96000)),))
    expect("flash_kv=fused", launches, {"prefill_attention", "int8_matmul", "fused_layer_decode_step"})
    steps = launches["int8_matmul"]  # one logit head a decode step
    print(f"  flash_kv=fused: {steps} decode steps, kernel 7 {launches['fused_layer_decode_step'] / steps:.2f} "
          f"launches a step (depth {depth})")
    if launches["fused_layer_decode_step"] != depth * steps:
        fail(f"kernel 7 launched {launches['fused_layer_decode_step']} times, want {depth} x {steps}")
    path_launches["fused_layer_decode_step"] = launches["fused_layer_decode_step"]
    launches = drive(restage(quantized=False), "fp decode (quantized=False)", ((2, 4.0, (2, 96000)),))
    expect("fp decode", launches, {"prefill_attention"})
    launches = drive(restage(quantized=True, flash_kv=None), "flash_kv=None", ((2, 4.0, (2, 96000)),))
    expect("flash_kv=None", launches, {"prefill_attention", "fused_ff_apply", "int8_matmul"})
    if launches["fused_ff_apply"] != depth * launches["int8_matmul"]:
        fail(f"flash_kv=None: kernel 3 launched {launches['fused_ff_apply']} times, "
             f"want {depth} x {launches['int8_matmul']}")

    # per-step cost of each mode: the semantic stage at batch 8, 16 and 48
    # decode steps; the difference divided by 32 removes the prefill
    sem = stages["semantic_stage"].model
    clap = clap_tokens(8).reshape(8, -1)
    for mode in (dict(quantized=True, flash_kv="int8"), dict(quantized=True, flash_kv="fused"),
                 dict(quantized=True, flash_kv=None), dict(quantized=False)):
        st = Stage(sem, name="semantic", **mode)
        st.generate([clap], gen, max_time_steps=4)  # warm-up, qparams
        walls = []
        for T in (16, 48):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st.generate([clap], gen, max_time_steps=T)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        prof = [profile_generate(torch, st, clap, gen, T) for T in (16, 48)]
        step_ms = (walls[1] - walls[0]) / 32 * 1e3
        step_launches = (prof[1][0] - prof[0][0]) / 32
        busy_ms = (prof[1][1] - prof[0][1]) / 32
        print(f"decode step, semantic b8, {mode}: {step_ms:.3f} ms a step (unprofiled), "
              f"{step_launches:.1f} CUDA kernel launches a step, device busy {busy_ms:.3f} ms a step "
              f"(idle share {100 * (1 - busy_ms / step_ms):.1f} % of the unprofiled step) [{card}]",
              flush=True)
    del musiclm, stages, codec
    torch.cuda.empty_cache()

    # ---- 5. the training path ----
    train_launches = training_phase(torch, omt_config, mc, dev, card, attention, kernels)
    path_launches.update(attention_bwd=train_launches["attention_bwd"],
                         attention_dbias=train_launches["attention_dbias"])

    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": f"{PACKAGE}/csrc/{src}", "replaces": tpu,
         "launches": path_launches[name], **results[name]}
        for name, _, src, tpu in kernels
    ]}
    print(json.dumps(summary))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


def backward_summaries(torch, F, dev, args, key_mask, library_time, causal_float_mask,
                       with_dbias=True):
    """(bytes, FLOPs, library (stream, device) ms) of kernels 5 and 6 on these inputs (kernel
    6's None without ``with_dbias``). The library call is
    scaled_dot_product_attention with K/V expanded to the 8 heads and the
    bias plus masks as a float attn_mask: its backward (fwd + bwd less fwd)
    with the mask not requiring grad computes kernel 5's dq, dk, dv; with the
    mask requiring grad it also computes kernel 6's dbias (summed over the
    batch afterwards, outside the timing)."""
    q, k, v, bias, _, out, stats, dout = args
    b, h, n, d = q.shape
    pairs = h * allowed_pairs(b, n, n, key_mask)
    inputs = nbytes(q, k, v, bias, key_mask, out, stats, dout)
    grad_out = dout.reshape(b, n, h, d).transpose(1, 2)
    kx = k[:, None].expand(b, h, n, d).contiguous()
    vx = v[:, None].expand(b, h, n, d).contiguous()
    mask = causal_float_mask(bias, key_mask, n, n, q.dtype)
    libs = []
    for mask_grad in (False, True)[:2 if with_dbias else 1]:
        leaves = [q.detach().requires_grad_(), kx.requires_grad_(), vx.requires_grad_()]
        m = mask.clone().requires_grad_(mask_grad)
        wrt = leaves + ([m] if mask_grad else [])

        def fwd():
            return F.scaled_dot_product_attention(*leaves, attn_mask=m, scale=8.0)

        def fwd_bwd():
            torch.autograd.grad(fwd(), wrt, grad_out)

        tag = "with the mask's gradient" if mask_grad else "dq, dk, dv"
        t_fb, be = library_time(f"SDPA forward + backward ({tag}) b{b} n{n}", fwd_bwd)
        t_f, _ = library_time(f"SDPA forward b{b} n{n}", fwd, be)
        libs.append((t_fb[0] - t_f[0], t_fb[1] - t_f[1]))
    sum5 = (inputs + nbytes(q, k, v), 10 * d * pairs, libs[0])
    sum6 = (inputs + nbytes(bias), 4 * d * pairs, libs[1]) if with_dbias else None
    return sum5, sum6


def write_token_store(folder, mc, n_tracks: int, seconds: int, seed: int):
    """A preprocessed token store for ``n_tracks`` tracks of ``seconds`` s:
    CLAP tokens per 10 s window, semantic and acoustic tokens at the
    config's rates, random codes from ``seed``."""
    import numpy as np

    from open_musiclm_torch.data.tokenstore import writer_for_rank

    rng = np.random.RandomState(seed)
    g = mc.global_cfg
    sem_hz, ac_hz = mc.hubert_kmeans_cfg.output_hz, mc.encodec_cfg.output_hz
    win = int(g.semantic_audio_length_seconds)
    store = writer_for_rank(str(folder), 0, 1)
    for i in range(n_tracks):
        clap = rng.randint(0, mc.clap_rvq_cfg.codebook_size,
                           (seconds - win + 1, mc.clap_rvq_cfg.rq_num_quantizers, 1))
        sem = rng.randint(0, mc.hubert_kmeans_cfg.codebook_size, (1, seconds * sem_hz - 1))
        coarse = rng.randint(0, mc.encodec_cfg.codebook_size, (1, seconds * ac_hz, g.num_coarse_quantizers))
        fine = rng.randint(0, mc.encodec_cfg.codebook_size, (1, seconds * ac_hz, g.num_fine_quantizers))
        store.put(i, f"track{i}.wav", clap, sem, coarse, fine)
    store.close()


def profile_generate(torch, stage, clap, gen, steps):
    """(CUDA kernel launches, device busy ms) of one Stage.generate call of
    ``steps`` decode steps under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        stage.generate([clap], gen, max_time_steps=steps)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.count for e in events), sum(e.self_device_time_total for e in events) / 1e3


def profile_step(torch, trainer, state, batch, gen, card):
    """One more train step under torch.profiler: device busy time by kernel
    group and the device's idle share of the (profiled) step."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(state, batch, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups = {
        "kernel 1 (prefill_attention)": ("prefill_attention",),
        "kernels 5, 6 (attention bwd)": ("bwd_bf16_kernel", "dq_kernel", "dkdv_kernel",
                                          "dbias_kernel", "delta_kernel", "sum_heads_kernel"),
        "matmuls (cuBLAS)": ("gemm", "Kernel2", "nvjet", "cutlass", "xmma"),
    }
    by_group, n_kernels, rows = {}, 0, []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.self_device_time_total
        n_kernels += e.count
        rows.append((us, e.count, e.key))
        group = next((g for g, keys in groups.items() if any(k in e.key for k in keys)), "other")
        by_group[group] = by_group.get(group, 0.0) + us
    busy_ms = sum(by_group.values()) / 1e3
    print(f"profiled train step: {wall_ms:.1f} ms wall under the profiler, device busy "
          f"{busy_ms:.1f} ms (idle share {100 * (1 - busy_ms / wall_ms):.1f} %), "
          f"{n_kernels} kernel launches [{card}]")
    for group, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"    {group:32s} {us / 1e3:9.2f} ms  {100 * us / 1e3 / busy_ms:5.1f} % of busy")
    for us, count, key in sorted(rows, reverse=True)[:10]:
        print(f"    {us / 1e3:9.2f} ms {count:6d}x  {key[:110]}")


def training_phase(torch, omt_config, mc, dev, card, attention, kernels):
    """Phase 5. Returns the launches of kernels 1, 5 and 6 during the
    StageTrainer.train run."""
    from open_musiclm_torch.models import transformer
    from open_musiclm_torch.checkpoint import find_latest_checkpoint
    from open_musiclm_torch.data.dataset import PreprocessedDataset, batch_iterator, train_valid_split
    from open_musiclm_torch.data.pipeline import accumulate_token_batches
    from open_musiclm_torch.models.token_cond import StageLossConfig, stage_training_loss
    from open_musiclm_torch.train.flops import peak_flops, stage_train_flops
    from open_musiclm_torch.train.trainer import StageTrainer

    lens = omt_config.stage_example_lengths(mc, "coarse")

    # 5a. full-width coarse gradients on the card (float32, batch 2, no
    # dropout or forgetful mask; pad and EOS in the conditioning) against the
    # plain path on the CPU in float64, with the same plain path in float32
    # beside them. Errors are max abs err / max|grad| per tensor. At full
    # width float32 rounding alone puts the CPU's float32 gradients up to
    # ~2e-4 from float64 (the rel-pos MLP and the embedding tables, whose
    # gradients are sums of many cancelling terms), so 1e-4 against a
    # float32 side would be rounding, not the kernels. The card's float32
    # sums run in another order but are no less exact: it is held to 3x the
    # CPU float32 path's worst distance from float64 in this run (measured
    # card/CPU ratio up to ~1.5x, so 2x room), and that distance itself must
    # stay under 3e-4. A control run with the attention in bf16 must fail
    # the same limit. The rel-pos MLP's output bias shifts a whole row of
    # scores, which the softmax ignores: its true gradient is 0, and its
    # rounding noise is scaled by the output weight's largest gradient.
    t0 = time.perf_counter()
    cpu_model = omt_config.init_stage(mc, "coarse", 21, device="cpu").model
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    f64_model = copy.deepcopy(cpu_model).double()
    # the phase's own seeded draws, so that phases before it do not change its inputs
    ids_gen = torch.Generator().manual_seed(1)
    ids = [torch.randint(0, s.codebook_size, (2, n), generator=ids_gen) for s, n in zip(cpu_model.specs, lens)]
    ids[0][0, -1], ids[0][1, 4] = -1, cpu_model.specs[0].eos_id
    ids[1][1, -3:], ids[1][0, 7] = -1, cpu_model.specs[1].eos_id
    cfg = StageLossConfig((0.5, 0.5, 1.0), mask_prob=0.0)

    def loss_and_grads(model, device):
        loss, _ = stage_training_loss(model, [t.to(device) for t in ids], cfg, train=True)
        loss.backward()
        return loss.item(), {name: p.grad.double().cpu() for name, p in model.named_parameters()}

    bwd = attention.shared_kv_attention_bwd
    counts = (bwd.launches, bwd.dbias_launches)
    gpu_loss, gpu_grads = loss_and_grads(gpu_model, dev)
    if (bwd.launches - counts[0], bwd.dbias_launches - counts[1]) != (6, 6):
        fail("the card's backward did not run kernels 5 and 6 once per layer")
    cpu_loss, cpu_grads = loss_and_grads(cpu_model, "cpu")
    _, f64_grads = loss_and_grads(f64_model, "cpu")

    # the control: the same card model with q, k, v and the bias rounded to
    # bf16 at the attention, so kernels 1, 5 and 6 run in bf16
    def bf16_attention(q, k, v, attn_bias=None, key_mask=None, **kw):
        low = (t.bfloat16() if t is not None else None for t in (q, k, v, attn_bias))
        return attention.shared_kv_attention_train(*low, key_mask, **kw).float()

    gpu_model.zero_grad()
    transformer.shared_kv_attention_train = bf16_attention
    try:
        _, ctl_grads = loss_and_grads(gpu_model, dev)
    finally:
        transformer.shared_kv_attention_train = attention.shared_kv_attention_train

    shift = "transformer.rel_pos_bias.out_layer.bias"
    rows = []
    for name, want in f64_grads.items():
        scale = want.abs().max().item()
        if name == shift:
            scale = f64_grads["transformer.rel_pos_bias.out_layer.weight"].abs().max().item()
        errs = [(a[name] - want).abs().max().item() / max(scale, 1e-30)
                for a in (gpu_grads, cpu_grads, ctl_grads)]
        rows.append((errs, name))
    rows.sort(reverse=True)
    cpu_worst = max(errs[1] for errs, _ in rows)
    ctl_worst = max(errs[2] for errs, _ in rows)
    limit = 3 * cpu_worst
    loss_rel = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    print(f"training gradients, full-width coarse f32 b2 n{sum(lens) + 2 * len(lens) - 1}: loss card "
          f"{gpu_loss:.6f} CPU {cpu_loss:.6f} (rel {loss_rel:.2e}); {len(rows)} gradient tensors, "
          f"{time.perf_counter() - t0:.1f} s; max abs err / max|grad| against CPU f64 of the worst "
          "six (card f32, CPU f32, card with bf16 attention):", flush=True)
    for errs, name in rows[:6]:
        print(f"    {name:48s} {errs[0]:.2e} {errs[1]:.2e} {errs[2]:.2e}")
    print(f"  gradient gate: card f32 worst {rows[0][0][0]:.2e} <= limit {limit:.2e} "
          f"(3 x CPU f32 worst {cpu_worst:.2e}); control bf16 attention worst {ctl_worst:.2e} "
          f"must exceed it [{card}]", flush=True)
    if not cpu_worst <= 3e-4:
        fail(f"the CPU float32 gradients are {cpu_worst:.2e} x max|grad| from float64 (> 3e-4)")
    if rows[0][0][0] > limit:
        fail(f"gradient {rows[0][1]}: card vs CPU f64 {rows[0][0][0]:.2e} x max|grad| > {limit:.2e}")
    if not ctl_worst > limit:
        fail(f"the gradient gate passes bf16 attention ({ctl_worst:.2e} <= {limit:.2e})")
    if not loss_rel <= 1e-4:
        fail(f"training loss card {gpu_loss} vs CPU {cpu_loss}")
    del cpu_model, gpu_model, f64_model, cpu_grads, gpu_grads, f64_grads, ctl_grads
    torch.cuda.empty_cache()

    # 5b. StageTrainer.train on a token store, the coarse trainer config
    tcfg = omt_config.load_training_config(
        str(ROOT / "configs" / "training" / "train_musiclm_fma.json")).coarse_trainer_cfg
    gcfg = mc.global_cfg
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        store_dir, results = Path(tmp) / "tokens", Path(tmp) / "results"
        write_token_store(store_dir, mc, n_tracks=8, seconds=12, seed=7)
        ds = PreprocessedDataset(
            folder=str(store_dir), stage="coarse",
            semantic_window_seconds=int(gcfg.semantic_audio_length_seconds),
            coarse_window_seconds=int(gcfg.coarse_audio_length_seconds),
            fine_window_seconds=int(gcfg.fine_audio_length_seconds),
            semantic_steps_per_second=mc.hubert_kmeans_cfg.output_hz,
            acoustic_steps_per_second=mc.encodec_cfg.output_hz,
        )
        tr_idx, va_idx = train_valid_split(len(ds), tcfg.valid_frac)
        batches = batch_iterator(ds, tcfg.batch_size, indices=tr_idx, num_workers=4)
        valid_iter = batch_iterator(ds, tcfg.batch_size, indices=va_idx or tr_idx[:1], num_workers=1)
        train_iter = accumulate_token_batches(batches, tcfg.grad_accum_every)
        model = omt_config.init_stage(mc, "coarse", 5, device=dev, compute_dtype=torch.bfloat16).model
        hp = dict(loss_cfg=StageLossConfig(tuple(tcfg.cross_entropy_loss_weights)),
                  lr=tcfg.lr, wd=tcfg.wd, lr_warmup=tcfg.lr_warmup,
                  max_grad_norm=tcfg.max_grad_norm, grad_accum_every=tcfg.grad_accum_every,
                  results_folder=str(results), save_model_every=tcfg.save_model_every,
                  save_results_every=tcfg.save_results_every, stage_name="coarse")
        trainer = StageTrainer(model=model, **hp)
        state = trainer.init_state()
        before = {name: p.detach().clone() for name, p in model.named_parameters()}
        gen = torch.Generator(device=dev).manual_seed(0)
        steps = 3
        train_kernels = {name: counter for name, counter, _, _ in kernels
                         if name in ("prefill_attention", "attention_bwd", "attention_dbias")}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn, attr in train_kernels.values():
            setattr(fn, attr, 0)
        state = trainer.train(state, train_iter, num_steps=steps, generator=gen, valid_iter=valid_iter)
        torch.cuda.synchronize()
        launches = {name: getattr(fn, attr) for name, (fn, attr) in train_kernels.items()}
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        profile_step(torch, trainer, state, next(train_iter), gen, card)
        batches.close()
        valid_iter.close()

        recs = [json.loads(line) for line in (results / "coarse.log.jsonl").read_text().splitlines()]
        losses = [r["train_loss"] for r in recs if "train_loss" in r]
        step_s = [r["step_time_s"] for r in recs if "step_time_s" in r]
        valid = [r for r in recs if "valid_loss" in r]
        print(f"StageTrainer.train coarse (b{tcfg.batch_size} x accum {tcfg.grad_accum_every}, bf16 "
              f"compute, dropout 0.1, forgetful mask 0.15): losses {losses}, step s {step_s}, "
              f"valid {[(r['valid_loss'], r['valid_accuracy']) for r in valid]}", flush=True)
        if len(losses) != steps or not all(math.isfinite(x) for x in losses):
            fail(f"training losses {losses}")
        if len(valid) != 1 or not math.isfinite(valid[0]["valid_loss"]):
            fail(f"eval step results {valid}")
        changed = [n for n, p in model.named_parameters() if not torch.equal(p.detach(), before[n])]
        max_delta = max((model.get_parameter(n).detach() - before[n]).abs().max().item() for n in before)
        print(f"parameters changed: {len(changed)} of {len(before)} tensors, max |delta| {max_delta:.3e}")
        if not changed:
            fail("no parameter changed in training")
        print(f"training-path launches ({steps} steps + 1 eval step): {launches}")
        per_step = steps * tcfg.grad_accum_every * len(model.transformer.attns)
        if launches["attention_bwd"] != per_step or launches["attention_dbias"] != per_step:
            fail(f"kernels 5/6 launched {launches}, want {per_step} each")
        if launches["prefill_attention"] < per_step:
            fail(f"kernel 1 launched {launches['prefill_attention']} times, want >= {per_step}")

        # checkpoint round trip into a differently seeded model
        trainer.save(state, state.step)
        path = find_latest_checkpoint(str(results), "coarse.transformer")
        other = StageTrainer(model=omt_config.init_stage(
            mc, "coarse", 6, device=dev, compute_dtype=torch.bfloat16).model, **hp)
        restored = other.load(path)
        same = (restored.step == state.step
                and all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                          other.model.state_dict().values()))
                and all(torch.equal(a, b) for a, b in zip(
                    state.optimizer.mu + state.optimizer.nu,
                    restored.optimizer.mu + restored.optimizer.nu)))
        print(f"checkpoint round trip ({Path(path).name}, "
              f"{Path(path).stat().st_size / 2**20:.0f} MiB): {'exact' if same else 'DIFFERS'}")
        if not same:
            fail("checkpoint round trip is not exact")

    step_ms = statistics.median(step_s[1:]) * 1e3
    # a start token per sequence and an EOS after each conditioning sequence
    stream = sum(lens) + 2 * len(lens) - 1
    tokens = tcfg.batch_size * tcfg.grad_accum_every * stream
    flops = stage_train_flops(model, lens, tcfg.batch_size, tcfg.grad_accum_every)
    rate = flops / (step_ms / 1e3)
    peak = peak_flops(torch.cuda.get_device_name(0))
    print(f"training throughput, coarse b{tcfg.batch_size} x accum {tcfg.grad_accum_every} "
          f"n{stream} bf16: {step_ms:.1f} ms/step (median of steps 2-{steps}), "
          f"{tokens / (step_ms / 1e3):.0f} tokens/s, model {rate / 1e12:.2f} TFLOP/s "
          f"({100 * rate / peak:.2f} % of the {peak / 1e12:.0f} TFLOP/s data-sheet bf16 peak), "
          f"peak device memory {peak_gib:.2f} GiB [{card}]", flush=True)
    return launches


if __name__ == "__main__":
    sys.exit(main())
