#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (open_musiclm_torch) on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root

Phases, each of which fails the run:
  1. build the hand-written kernels from open_musiclm_torch/csrc/ (nvcc);
  2. hold each kernel against its plain PyTorch version at the serving
     path's shapes, in float32 and bfloat16, and time both;
  3. hold the int8 serving decode with kernels (CUDA) against the same decode
     on the CPU through the plain versions: per-step teacher-forced logits of
     the full-width semantic stage in float32, both cache modes;
  4. drive MusicLM.generate on musiclm_small at full width (random weights
     from a seed, bf16, quantized=True, flash_kv="int8"), at batch 8 x 4 s
     and batch 2 x 12 s, checking waveform shapes, finiteness and that every
     kernel of the path launched.

Prints the card, the kernels' JSON summary, and as its last line
{"ok": true, "device": {...}}. Without a CUDA card it exits non-zero.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

PACKAGE = "open_musiclm_torch"
ROOT = Path(__file__).resolve().parent

# bf16 outputs are compared with the plain version computed in float32 on
# the same (bf16-valued) inputs: the kernel rounds its float32 result once
# to bf16, at most half a bf16 ulp = 2**-8 of the largest output's binade;
# the bound allows twice that. float32: both sides accumulate in float32 in
# another order over up to 2730 terms (~sqrt(K) * 6e-8 of the term sum).
TOL_REL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on a card", file=sys.stderr)
        return 2
    try:
        from open_musiclm_torch import config as omt_config
        from open_musiclm_torch.models.musiclm import MusicLM
        from open_musiclm_torch.models.quant_decode import generate_quantized
        from open_musiclm_torch.ops import attention, cuda_lib, decode_attention, fused_ff, quant
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2

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
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    results = {}

    def check(name, label, dtype, kernel_fn, plain_fn, inputs, keep_f32=()):
        """kernel_fn on the inputs in ``dtype`` (int8 inputs and those named in
        keep_f32 stay as they are) against plain_fn on float32 copies of
        those same values; both sides are then timed on the ``dtype`` inputs."""
        low = {k: v.to(dtype) if v.is_floating_point() and k not in keep_f32 else v
               for k, v in inputs.items()}
        ref_in = {k: v.float() if v.is_floating_point() else v for k, v in low.items()}
        got = kernel_fn(**low)
        want = plain_fn(**ref_in)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        rel = TOL_REL[str(dtype).removeprefix("torch.")]
        err, ref_max = 0.0, 0.0
        for a, b in zip(got, want):
            a, b = a.float(), b.float()
            if not torch.isfinite(a).all():
                fail(f"{name} {label} {dtype}: non-finite output")
            err = max(err, (a - b).abs().max().item())
            ref_max = max(ref_max, b.abs().max().item())
        tol = rel * max(1.0, ref_max)
        ms = time_ms(lambda: kernel_fn(**low))
        plain_ms = time_ms(lambda: plain_fn(**low))
        ok = err <= tol
        print(f"  {name:18s} {label:26s} {str(dtype):14s} max_abs_err {err:.3e} "
              f"max|ref| {ref_max:.3e} rel_err {err / max(ref_max, 1e-30):.3e} tol {tol:.3e} "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"{name} {label} {dtype}: max abs err {err} > {tol}")
        r = results.setdefault(name, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if dtype == torch.bfloat16 and "ms" not in r:  # the serving dtype at the first shape
            r["ms"], r["plain_ms"] = ms, plain_ms

    print("kernels vs plain versions:", flush=True)
    H, D, DIM, INNER, C = 8, 64, 1024, 2730, 1025
    # 1. prefill attention: coarse first window (b 8, n 216), coarse continuation
    #    (b 2, n 666), fine batched windows (b 16, n 467)
    for b, n in ((8, 216), (2, 666), (16, 467)):
        ins = dict(q=attention.l2norm(rand(b, H, n, D)), k=attention.l2norm(rand(b, n, D)),
                   v=rand(b, n, D), attn_bias=rand(H, n, n))
        for dt in (torch.bfloat16, torch.float32):
            check("prefill_attention", f"b{b} n{n}", dt,
                  lambda q, k, v, attn_bias: attention.shared_kv_attention_fused(q, k, v, attn_bias),
                  lambda q, k, v, attn_bias: attention.shared_kv_attention(
                      q, k, v, attn_bias=attn_bias, causal=True),
                  ins)
    # 2. flash decode: the coarse / fine cache (N 1280) at b 8, pos in the
    #    first and in the last 256-row chunk, int8 and activation-dtype rows
    b, N = 8, 1280
    k, v = attention.l2norm(rand(b, N, D)), rand(b, N, D)
    kq, ks = decode_attention.quantize_kv_row(k)
    vq, vs = decode_attention.quantize_kv_row(v)
    caches = {"int8": (torch.cat([kq, vq], -1).contiguous(), torch.stack([ks, vs]).contiguous()),
              "bf16": (torch.cat([k, v], -1).contiguous(), None)}
    for mode, (kv, sc) in caches.items():
        for pos in (100, N - 1):
            ins = dict(q_t=attention.l2norm(rand(b, H, D)), kv_cache=kv, bias_row=rand(N, H),
                       add_mask=torch.zeros(b, N, device=dev))
            for dt in (torch.bfloat16, torch.float32):
                check("flash_decode_step", f"{mode} b{b} N{N} pos{pos}", dt,
                      lambda q_t, kv_cache, bias_row, add_mask, pos=pos, sc=sc:
                          decode_attention.flash_decode_step(q_t, kv_cache, pos, bias_row, add_mask, sc),
                      lambda q_t, kv_cache, bias_row, add_mask, pos=pos, sc=sc:
                          decode_attention.flash_decode_step_plain(q_t, kv_cache, pos, bias_row, add_mask, sc),
                      ins, keep_f32=("bias_row", "add_mask"))
    # 3. fused FF: the fine stage's rows at batch 8 (2 windows x 8), and batch 8
    from open_musiclm_torch.models.transformer import ConvFeedForward

    ff = ConvFeedForward(DIM, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ff.norm_in.gamma.normal_(1.0, 0.1, generator=g)
        ff.norm_mid.gamma.normal_(1.0, 0.1, generator=g)
    packed = {k: v.to(dev) for k, v in fused_ff.pack_ff_weights(ff).items()}
    for b in (16, 8):
        ins = dict(x=rand(b, DIM), state=rand(b, 2, 2 * INNER))
        for dt in (torch.bfloat16, torch.float32):
            check("fused_ff_apply", f"b{b} dim{DIM} inner{INNER}", dt,
                  lambda x, state: fused_ff.fused_ff_apply(x, packed, state),
                  lambda x, state: fused_ff.fused_ff_apply_plain(x, packed, state), ins)
    # 4. int8 matmul: the 1025-way logit head at b 8 and the fine rows b 16
    wq, s = quant.quantize_weight(torch.randn(DIM, C, generator=g))
    wq, s = wq.to(dev), s.to(dev)
    for b in (8, 16):
        ins = dict(x=rand(b, DIM))
        for dt in (torch.bfloat16, torch.float32):
            check("int8_matmul", f"b{b} {DIM}x{C}", dt,
                  lambda x: quant.int8_matmul(x, wq, s),
                  lambda x: quant.int8_matmul_plain(x, wq, s), ins)

    # ---- 3. the serving decode with kernels vs the plain path on the CPU ----
    # float32, 24 teacher-forced steps of the full-width semantic stage. With
    # "bf16" cache rows (float32 here) only float32 rounding order differs.
    # With "int8" rows a float32 difference at a rounding boundary can move
    # one cache element by a quantization step (1/127 of its row's absmax),
    # so that mode is held to 1e-2 of the largest logit instead of 1e-4.
    mc = omt_config.load_model_config(str(ROOT / "configs" / "model" / "musiclm_small.json"))
    stage = omt_config.init_stage(mc, "semantic", 11, quantized=True)
    cond = torch.randint(0, 1024, (2, 12), generator=g)
    teacher = torch.randint(0, 1024, (2, 24, 1), generator=g)
    qp_cpu = stage.qparams()
    model_gpu = copy.deepcopy(stage.model).to(dev)
    qp_gpu = {k: ({n: t.to(dev) for n, t in v.items()} if isinstance(v, dict) else tuple(t.to(dev) for t in v))
              for k, v in qp_cpu.items()}
    for mode, rel in (("bf16", 1e-4), ("int8", 1e-2)):
        kw = dict(max_time_steps=24, temperature=0.0, teacher_ids=teacher, return_logits=True, flash_kv=mode)
        _, want = generate_quantized(stage.model, qp_cpu, [cond], **kw)
        _, got = generate_quantized(model_gpu, qp_gpu, [cond.to(dev)], **kw)
        got, want = got.cpu()[..., :-1], want[..., :-1]  # the EOS column is -1e9 on both
        err = (got - want).abs().max().item()
        tol = rel * max(1.0, want.abs().max().item())
        print(f"serving decode, semantic stage f32, flash_kv={mode}, 24 teacher-forced steps: "
              f"CUDA kernels vs CPU plain logits max_abs_err {err:.3e} tol {tol:.3e} "
              f"(max |logit| {want.abs().max().item():.2f})", flush=True)
        if not err <= tol:
            fail(f"serving decode logits ({mode} cache) differ: {err} > {tol}")
    del model_gpu, qp_gpu, stage

    # ---- 4. the main path: MusicLM.generate at full width ----
    bf16 = torch.bfloat16
    stages = {
        f"{name}_stage": omt_config.init_stage(
            mc, name, seed, device=dev, dtype=bf16, quantized=True, flash_kv="int8")
        for name, seed in (("semantic", 1), ("coarse", 2), ("fine", 3))
    }
    codec = omt_config.build_encodec(mc, generator=torch.Generator().manual_seed(4)).to(dev, bf16)
    codec.decoder.lstm.float()  # the LSTM stem recurs in float32 (see models/encodec.py)
    musiclm = MusicLM(codec=codec, **stages)
    kernels = [
        ("prefill_attention", attention.shared_kv_attention_fused, "prefill_attention.cu",
         "open_musiclm_tpu/ops/pallas_attention.py:155"),
        ("flash_decode_step", decode_attention.flash_decode_step, "flash_decode.cu",
         "open_musiclm_tpu/ops/decode_attention.py:195"),
        ("fused_ff_apply", fused_ff.fused_ff_apply, "fused_ff.cu",
         "open_musiclm_tpu/ops/fused_ff.py:204"),
        ("int8_matmul", quant.int8_matmul, "int8_matmul.cu", "open_musiclm_tpu/ops/quant.py:80"),
    ]
    for _, fn, _, _ in kernels:
        fn.launches = 0
    gen = torch.Generator(device=dev).manual_seed(0)
    n_clap = mc.clap_rvq_cfg.rq_num_quantizers
    for batch, seconds, want_shape in ((8, 4.0, (8, 96000)), (2, 12.0, (2, 336000))):
        clap = torch.randint(0, mc.clap_rvq_cfg.codebook_size, (batch, n_clap, 1), generator=g).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wave = musiclm.generate(
            clap_token_ids=clap, generator=gen, output_seconds=seconds,
            semantic_window_seconds=int(mc.global_cfg.semantic_audio_length_seconds),
            coarse_window_seconds=int(mc.global_cfg.coarse_audio_length_seconds),
            fine_window_seconds=int(mc.global_cfg.fine_audio_length_seconds),
        )
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        audio_s = wave.shape[0] * wave.shape[1] / codec.sample_rate
        print(f"MusicLM.generate batch {batch} x {seconds} s: wave {tuple(wave.shape)} "
              f"{wall:.2f} s wall, {audio_s / wall:.3f} audio-s/wall-s, "
              f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
        if tuple(wave.shape) != want_shape:
            fail(f"waveform shape {tuple(wave.shape)} != {want_shape}")
        if not torch.isfinite(wave.float()).all():
            fail("waveform has non-finite samples")
    launches = {name: fn.launches for name, fn, _, _ in kernels}
    print(f"main-path launches: {launches}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")

    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": f"{PACKAGE}/csrc/{src}", "replaces": tpu,
         "launches": launches[name], **results[name]}
        for name, _, src, tpu in kernels
    ]}
    print(json.dumps(summary))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
