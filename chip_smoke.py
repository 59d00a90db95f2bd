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
     the fine stage's 14 rows, at pos 0 and at musiclm_large's 16 heads,
     with its plan (grid, shared memory and weight share a block), beside
     one layer of the two-kernel decode step), kernel 1 (with a key mask and its row
     statistics) and kernels 5 and 6 (the attention backward) at the three
     training shapes; time one PyTorch library call computing the same
     function where there is one (scaled_dot_product_attention, and
     torch._weight_int8pack_mm where it runs on the card), and compute each
     kernel's bound (the least time the card could take: bytes over the
     memory rate or FLOPs over the peak rate, whichever is larger); kernel 3
     at b 8 and 16 also as GB/s and a share of 3.35 TB/s, kernel 4 at the
     logit head's b 8, 14, 16, 64 and 256 (one route, the stream) and the
     five projections of the fused_ff=False step, kernel 5 (bf16) at each
     training shape as TFLOP/s beside SDPA's backward, kernel 6 (bf16, the
     bias in bf16 and in float32) there beside its bound, and kernels 5 + 6
     beside SDPA's backward with the mask's gradient;
  3. hold every decode mode with kernels (CUDA) against the same decode on
     the CPU through the plain versions: per-step teacher-forced logits of
     the full-width semantic stage in float32, flash_kv "bf16", "int8",
     "f32", "fused" and None (with fused_ff True and False), and the fp
     decode; (b) the same for the semantic stage with the T5 bucketed
     relative position bias and a bidirectional prefix (12 steps, each mode
     exactly its kernels), then its loss and every gradient (kernels 1, 5,
     6, the bucket table's among them) in float32 against the CPU in
     float64 within 3x the CPU float32 path's distance, and one bf16 step
     against the CPU float32 gradients within 3x the CPU bf16 step's;
  4. the serving path: MusicLM.generate on musiclm_small at full width
     (random weights from a seed, bf16): quantized=True, flash_kv="int8" at
     batch 8 x 4 s and batch 2 x 12 s (kernels 1-4), flash_kv="fused" at
     batch 8 x 4 s (kernel 7 exactly once per layer and decode step, kernels
     1 and 4), the fp decode (kernel 1) and flash_kv=None (kernels 1, 3, 4)
     at batch 2 x 4 s, each checking waveform shapes, finiteness and that
     exactly its kernels launched; then each mode's decode step on the
     semantic stage at batch 8: ms a step, CUDA launches a step and device
     busy time (torch.profiler); (b) one row alone and in batches of 4 and
     8: 3 teacher-forced steps of each stage in "int8", flash_kv=None and
     the fp decode, logits bit-equal (phase 11 holds MusicLM.generate);
  5. text to waveforms: the tokenizer on a byte-level demo vocabulary (8
     prompts, one truncated at 77 tokens); the full-width text tower
     (RoBERTa-base, the CLAP projection, a 12 x 1024 x 512 RVQ, seeded) on
     the card against the CPU in float32 (embeddings within TEXT_EMB_TOL,
     CLAP tokens equal wherever the CPU's nearest-code margin is not a near
     tie, the near ties counted), its ms at b8 in float32 and bf16 beside its
     bound; the per-row keys' splits, folds and uniforms bit-equal on the
     card and the CPU, and a decode step's CUDA launches with per-row keys
     equal at b1 and b8 ("int8" and "fused"); MusicLM.generate(text=8
     prompts, per_row_keys) in "int8" at batch 8 x 4 s (exactly kernels 1-4);
     the GenerationServer in "fused" mode (batch 8, buckets [1, 8], 2
     workers): 8 concurrent text requests, then a lone one at bucket 1, and
     one (text, seed) request bit-equal in two batch-8 batches with other
     companions and slots and alone at bucket 1 (codes bit-equal, wave
     within 1e-6), each request's latency printed;
  6. the training path: the full-width coarse stage's loss and every
     parameter gradient on the card (kernels 1, 5, 6) against the plain path
     on the CPU in float64, within 3x the CPU float32 path's own distance
     from float64 (a control with bf16 attention must fail that limit);
     then a token store written from a seed, read by
     PreprocessedDataset -> batch_iterator -> accumulate_token_batches into
     StageTrainer.train with the coarse trainer config of
     configs/training/train_musiclm_fma.json (batch 2 x accum 8, bf16 compute
     on float32 master weights, dropout 0.1, forgetful mask 0.15): 3 steps,
     one eval step, a checkpoint round trip, and kernels 1, 5, 6 launched;
  7. audio prompts and reranking, float32 towers with seeded weights at full
     width: HuBERT (MERT-v0 geometry, a 1024 x 768 k-means codebook) on a b1
     x 10 s prime (sines plus noise, 48 kHz resampled to 16 kHz), the Encodec
     encoder at 6 kbps on the same prime at 24 kHz, HTSAT-tiny with the audio
     projection at b8 x 10 s 48 kHz, each on the card against the CPU
     (features, latent and embeddings within TOWER_REL / TOWER_ABS; semantic
     ids and Encodec codes equal off near ties, the near ties counted) and
     timed beside its bound; MusicLM.generate(prime_wave=the 10 s prime at
     48 kHz, output_seconds=12) in "fused" at b1 (the wave's length, exactly
     kernels 1, 4 and 7), once more with return_coarse_generated_wave; and
     generate_top_match(2 prompts x 4 samples, 4 s) in "fused" (sims in
     [-1, 1], exactly kernels 7, 1 and 4; its wall and HTSAT's share).
  8. musiclm_large: musiclm_large_small_context (24 layers x 16 heads x
     dim 1024, random weights from a seed) built through
     load.create_musiclm_from_config on the card in float32; its semantic
     stage written as a reference-layout .pt and read back equal through
     load.load_stage_params; 8 teacher-forced decode steps of each stage
     in the fp decode (kernel 1), "int8" (kernels 1-4) and "fused" (kernels
     1, 4, 7) against the CPU plain path (phase 3's limits); generate(text=1
     prompt) in "fused" at b1 x 4 s (exactly kernels 1, 4 and 7, kernel 7
     24 times a decode step); musiclm_large's fusion CLAP (HTSAT-tiny with
     the AFF patch fusion) + projection at b4 x 30 s on the card against
     the CPU; python -m open_musiclm_torch.cli.infer --int8 --flash_kv int8
     --duration 4 at musiclm_small, which must write a 4 s wav. Phase 2
     also holds kernels 1, 2, 5 and 6 at 16 heads, and kernels 2 and 7 over
     musiclm_large's 2,816-row coarse cache.
  9. stage training from raw audio through the five training CLIs, in
     process, at musiclm_small's full width with random weights from a seed,
     on 9 seeded tracks (44.1 and 48 kHz, 12-35 s, one of 7 s):
     train_stage --stage coarse --bf16 on the fly at the shipped trainer
     config (b2 x accum 8), cut to 3 steps with results and checkpoints
     every 2 (3 finite losses, valid loss and accuracy at steps 0 and 2,
     coarse.tokens.{0,2}.txt, 4 s reconstructions at 24 kHz,
     coarse.transformer.2.ckpt, kernels 5 and 6 once a layer and
     micro-batch and kernel 1 in every forward, no other kernel), its step
     wall and fetch share from the log; a resume from that checkpoint that
     takes exactly one step, numbered 3, then one on-the-fly step under
     torch.profiler (fetch share, device idle share); one coarse
     micro-batch tokenized on the card in float32 against the CPU (CLAP
     tokens, semantic ids, codes equal off near ties, the near ties
     counted); one step each of the semantic (b4 x accum 8) and fine stages;
     preprocess_data over the folder (a row a track; track 0's stored tokens
     against the CPU off near ties) and one fine step on that store;
     train_clap_rvq, 2 steps at the shipped b64 x accumulate 16 (finite
     rvq_mse, clap.rvq.*.ckpt read back equal by load.load_rvq) and
     train_hubert_kmeans, 4 feature steps of 32 clips and 1024 clusters
     (kmeans.ckpt with a finite inertia, read back by load.load_kmeans).
 10. the rest of training: (a) musiclm_large's coarse stage (cut to 8 of
     its 24 layers, 16 heads x 1024, its 10 s window) at the shipped coarse
     trainer config (b2 x accum
     8, bf16 on float32 masters, ff_dropout 0.1), two StageTrainer steps
     without remat and two with it from the same weights and generator
     state: the first step's loss and gradients equal (bit-equal, or within
     1e-6 x max|grad| a tensor), kernel 1 depth x accum launches a step
     without remat and twice that with it, kernels 5 and 6 depth x accum,
     each run's ms a step and peak memory; (b) train_stage --stage coarse
     under python -m torch.distributed.run --standalone --nproc_per_node 1
     on NCCL (musiclm_small, a token store, 2 steps, rank 0's log,
     checkpoint and tokens, then a resume for one more step), and two gloo
     ranks on the one card (their own processes) for 3 steps at b4 x accum
     2 against one process on the whole batch (1e-5 x max|p| a tensor),
     with whether gloo's all_gather takes CUDA tensors; (c) the roofline
     (train/roofline.py, the H100's data sheet) of (a)'s steps and phase 6's
     beside their measured ms.
 11. tensor parallelism and the serving layouts, on two gloo ranks (their
     own processes) sharing the card: (a) musiclm_large's coarse stage at
     tp=2 (cut to 8 layers, 8 of its 16 heads a rank, n 2,766): one float32 step
     (b2 x accum 1, remat, ff_dropout 0.1) against one process from the same
     weights and generator seed (the loss and every gathered gradient within
     1e-5 x max|g| a tensor), then two steps at the shipped coarse trainer
     config (b2 x accum 8, bf16, remat): ms and peak memory a rank, kernel 1
     2 x depth x accum and kernels 5 and 6 depth x accum times a step on each
     rank; (b) 8 teacher-forced fp decode steps of each stage of
     musiclm_large_small_context (cut to 8 layers) at tp=2 against one process's float32
     logits (phase 3's 1e-4 x max|logit|); (c) MusicLM.generate over
     make_mesh(dp=2) with per-row keys at musiclm_small, b8 x 4 s (b4 a
     rank) in "int8" and "fused", against one process's calls at the
     rank's batch: the codes bit-equal, the waves (a float32 Encodec) within
     1e-5, phase 4's kernels exactly on each rank; and one process's b8 call
     against two b4 calls, and ("fused") against row 2 alone (b1): every
     row's codes equal, waves within 1e-6; a
     row alone against b 2, 4, 8, 16 in the prefill's and a step's row
     tiles, kernels 1-4 and 7, and the semantic stage's prefill and
     teacher-forced logits in "int8" and "fused", bit-equal; (d)
     MusicLM.to_pipelined on the one card (one entry, and two entries
     naming it, which copies the coarse stage and the codec): waves
     bit-equal to the unpipelined run; (e) GenerationServer over the dp=2
     mesh ("fused", the full-width text tower, buckets [2, 4], one worker):
     4 text requests, each one's codes bit-equal and wave within 1e-6 to
     one process's server, and both ranks stop. gloo over one card shows
     the function on the card's kernels, not tensor-parallel speed.
 12. the CLAP options and the profiling hooks: (a) PANN Cnn14, Cnn10 and
     Cnn6 with the audio projection, b4 x 10 s at 48 kHz, and (b)
     HTSAT-base and HTSAT-large b1 x 10 s and the CLIP text tower (77 x
     512, 12 layers) b8, float32 on the card against the CPU (towers'
     TOWER_REL / TOWER_ABS), each timed beside its bound; (c) musiclm_small
     with clap_rvq_cfg.amodel_type "PANN-14" through
     load.create_musiclm_from_config, generate_top_match(2 prompts x 2
     samples, 4 s) in "fused" (sims in [-1, 1], exactly kernels 1, 4 and 7;
     its wall and PANN's share), its second generate under profiling.trace
     and profiling.annotate (the range and kernel 7 in the written trace,
     device_memory_stats' peak above 0); (d) ClapModule's three entry points
     on the card against the CPU.
 13. the tools (open_musiclm_torch/cli): (a) serving_deviation at b8 over a
     tenth of each stage's decode steps (semantic 50, coarse 30, fine 15):
     an fp-against-fp control (0 % mismatch, every row and wave equal), then
     the int8 stack's report with every ladder rung (each exactly its
     kernels: 1 in every prefill, 2 and 3 in the flash rungs, 7 in "fused",
     4 for the int8 logits), the logit curve, the margin sweep and the SNR;
     (b) profile_pipeline at b8 x 4 s, reps 1, in "fused" (picked by
     $OPEN_MUSICLM_FLASH_KV); (c) trace_train, one traced coarse step at b8
     (buckets within 1 % of the device total; kernels 1, 5 and 6 by name).
 14. the JAX package's orbax checkpoints: a doll-house MusicLM that the
     JAX trainers wrote (tests/torch_fixtures/orbax_dollhouse/: three
     stages, one a TrainState, the RVQ, k-means) read by
     orbax_io.read_orbax (its time and MB/s printed); each stage's float32
     teacher-forced logits against JAX's (expected.npz, 1e-4 x max|logit|;
     kernel 1), the RVQ and centroids bit for bit, the TrainState resumed
     by StageTrainer.load for one step against JAX's (kernels 1, 5, 6
     exactly), and MusicLM.generate at b2 x 2 s on the loaded stages in
     "int8" (kernels 1-4) and "fused" (kernels 1, 4, 7), exactly those.
Phase 8 also builds musiclm_large itself (30 s semantic, 10 s coarse, 3 s
fine windows, the fusion CLAP; its stages cut to 8 of their 24 layers) and
runs generate(text=1 prompt) in "fused" at b1 x 10 s, one whole coarse
window (kernel 7 once a layer and decode step).

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

    python3 chip_smoke.py --kernel4 ROOT

times kernel 4 alone at its phase-2 shapes from the port in the checkout
ROOT (another commit's, for a comparison within one call) and prints a JSON
line of its device ms.

    python3 chip_smoke.py --phase8      # or --phase9 to --phase14

builds the kernels and runs that phase alone.

    python3 chip_smoke.py --probe

builds the kernels and prints which pieces of the serving path give a row
other bits at other batch sizes (cuBLAS products, reductions, cuDNN, the
kernels, each stage end to end), then all of it as one JSON line.

    python3 chip_smoke.py --cost ROOT

times, from the port in the checkout ROOT, kernels 2, 7 and 4 at the
batch sizes where a grid or route changed with the batch, Encodec's decode
at b8, the semantic decode step in each mode and two prefills (a JSON
line), for a comparison of two commits within one call.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import inspect
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


# musiclm_large's coarse cache: a 10 s window's 2,766 rows (12 + 1 CLAP,
# 499 + 1 semantic, 3 start tokens, 2,250 coarse steps) padded to 256-row chunks
LARGE_N = 2816

# kernel 4's cases (name, rows, K, N): the logit head at the decode batch
# (b 8), the fine stage's rows (b 14: batch 2 x 7 windows; b 16), b 64 and
# the fine stage's cap of 256 rows (MAX_FINE_ROWS), phase 7's rows (b 1 and 5:
# the continuation's semantic / coarse and fine steps; b 4: the reranking's
# samples); the five int8 projections of the fused_ff=False decode step at b 8
INT8_CASES = ([("head", b, 1024, 1025) for b in (8, 14, 16, 64, 256, 1, 4, 5)]
              + [(name, 8, k, n) for name, k, n in (
                  ("to_q", 1024, 512), ("to_kv", 1024, 128), ("to_out", 512, 1024),
                  ("proj_in", 1024, 5460), ("proj_out", 2730, 1024))])


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def expect_launches(mode, launches, path):
    """Fail unless exactly the kernels in ``path`` launched (and each did)."""
    print(f"  {mode} launches: {launches}")
    for name, n in launches.items():
        if (n > 0) != (name in path):
            fail(f"{mode}: kernel {name} launched {n} times; the path runs {sorted(path)}")


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


class Timer:
    """Stream and device ms a call on the card (the two readings of the
    module docstring)."""

    def __init__(self, torch, dev):
        self.torch, self.dev = torch, dev
        self.spin = {}  # torch.cuda._sleep cycles a millisecond on this card, the L2 flush buffer

    def stream_ms(self, fn, reps=20):
        """Stream ms a call: CUDA events around ``reps`` calls after a
        warm-up. For a kernel of a few microseconds this is the host's time
        to launch it (Python wrapper included), not the card's."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def device_ms(self, fn, reps=20):
        """Device ms a call: ``reps`` calls, each between its own pair of
        CUDA events and after a write of a 128 MiB buffer (outside the events),
        all enqueued while a spin kernel (torch.cuda._sleep) holds the
        stream, so that the card runs them back to back and each finds L2
        cold. The spin lasts 1.5x the host's time to enqueue them, doubled
        until an event recorded just after it is still pending once the
        host has enqueued the last call."""
        torch, spin = self.torch, self.spin
        if not spin:
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            torch.cuda._sleep(10_000_000)
            b.record()
            b.synchronize()
            spin["per_ms"] = 10_000_000 / a.elapsed_time(b)
            spin["flush"] = torch.empty(128 * 2**20, dtype=torch.uint8, device=self.dev)  # 2.5x the 50 MB L2

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

    def both_ms(self, fn, reps=20):
        """(stream ms, device ms) a call of ``fn``."""
        return self.stream_ms(fn, reps), self.device_ms(fn, reps)

    def release(self):
        """Frees the L2 flush buffer."""
        self.spin.clear()


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

    t_start = time.perf_counter()  # each phase's start is printed, to see where a run's time goes
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

    print(f"chip_smoke: phase 2 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # ---- 2. kernels against their plain versions ----
    g = torch.Generator(device="cpu").manual_seed(0)

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    timer = Timer(torch, dev)
    time_ms, device_ms, both_ms = timer.stream_ms, timer.device_ms, timer.both_ms

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
    #    (b 2, n 666), fine batched windows (b 16, n 467); phase 7's batches:
    #    the continuation's semantic first window with the prime's 250 tokens
    #    (b 1, n 265), its first coarse window (b 1, n 666) and its 5 fine
    #    windows (b 5, n 467), the reranking's coarse windows (b 4, n 216)
    #    musiclm_large's 16 heads (phase 8): the first coarse window of
    #    musiclm_large_small_context (b 1 and 8, n 216) and musiclm_large's
    #    10 s coarse window (b 1, n 516)
    for b, n, h in ((8, 216, H), (2, 666, H), (16, 467, H), (1, 265, H), (1, 666, H), (5, 467, H), (4, 216, H),
                    (1, 216, 16), (8, 216, 16), (1, 516, 16)):
        ins = dict(q=attention.l2norm(rand(b, h, n, D)), k=attention.l2norm(rand(b, n, D)),
                   v=rand(b, n, D), attn_bias=rand(h, n, n))
        for dt in (torch.bfloat16, torch.float32):
            def summary(low, out, b=b, n=n):
                mask = causal_float_mask(low["attn_bias"], None, n, n, low["q"].dtype)
                kx, vx = (low[t][:, None].expand(b, H, n, D) for t in ("k", "v"))
                lib = library_time(f"SDPA forward b{b} n{n}", lambda: F.scaled_dot_product_attention(
                    low["q"], kx, vx, attn_mask=mask, scale=8.0))[0]
                pairs = H * allowed_pairs(b, n, n, None)
                return (nbytes(low["q"], low["k"], low["v"], low["attn_bias"], out),
                        4 * D * pairs, lib)

            check("prefill_attention", f"b{b} n{n}" + ("" if h == H else f" h{h}"), dt,
                  lambda q, k, v, attn_bias: attention.shared_kv_attention_fused(q, k, v, attn_bias),
                  lambda q, k, v, attn_bias: attention.shared_kv_attention(
                      q, k, v, attn_bias=attn_bias, causal=True),
                  ins, summary=summary if (b, n, h, dt) == (8, 216, H, torch.bfloat16) else None)
    # 2. flash decode: the coarse / fine cache (N 1280) at b 8, 2 and 16 (the
    #    bench's batch, one long request, the fine stage's windows) and pos 0,
    #    100, 700 and 1279 (one split to 20), with int8, activation-dtype and
    #    float32 rows (the "f32" cache mode); also b 1 and 5, the "int8"
    #    continuation's semantic / coarse and fine rows in phase 7. Beside
    #    every bf16 case, SDPA's one-query call over the same live rows (bf16
    #    K/V expanded to 8 heads, bias row + mask as a float attn_mask) as
    #    kernel/library.
    N = 1280
    for b in (8, 2, 16, 1, 5):
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
    # 2 at musiclm_large's shapes (phase 8): 16 heads over the 1280-row cache,
    #    and the 2,816-row cache of its 10 s coarse window (2,766 live rows:
    #    12 + 1 CLAP, 499 + 1 semantic, 3 start tokens, 2,250 coarse steps)
    #    at its last live row, at b 1 (one request) and b 8
    for b, h, n_cache, pos in ((8, 16, N, N - 1), (1, 16, LARGE_N, LARGE_N - 51), (8, 16, LARGE_N, LARGE_N - 51)):
        k, v = attention.l2norm(rand(b, n_cache, D)), rand(b, n_cache, D)
        kq, ks = decode_attention.quantize_kv_row(k)
        vq, vs = decode_attention.quantize_kv_row(v)
        caches = {"int8": (torch.cat([kq, vq], -1).contiguous(), torch.stack([ks, vs]).contiguous()),
                  "bf16": (torch.cat([k, v], -1).contiguous(), None),
                  "f32": (torch.cat([k, v], -1).contiguous(), None)}
        ins = dict(q_t=attention.l2norm(rand(b, h, D)), bias_row=rand(n_cache, h),
                   add_mask=torch.zeros(b, n_cache, device=dev))
        for mode, (kv, sc) in caches.items():
            for dt in (torch.bfloat16, torch.float32):
                check("flash_decode_step", f"{mode} b{b} N{n_cache} pos{pos} h{h}", dt,
                      lambda q_t, kv_cache, bias_row, add_mask, pos=pos, sc=sc:
                          decode_attention.flash_decode_step(q_t, kv_cache, pos, bias_row, add_mask, sc),
                      lambda q_t, kv_cache, bias_row, add_mask, pos=pos, sc=sc:
                          decode_attention.flash_decode_step_plain(q_t, kv_cache, pos, bias_row, add_mask, sc),
                      dict(ins, kv_cache=kv),
                      keep_f32=("bias_row", "add_mask") + (("kv_cache",) if mode == "f32" else ()))
        del k, v, kq, vq, caches, ins
    # 3. fused FF: the fine stage's rows at batch 8 (2 windows x 8), batch 8,
    #    and phase 7's continuation rows (b 5 fine windows, b 1)
    from open_musiclm_torch.models.transformer import ConvFeedForward

    ff = ConvFeedForward(DIM, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ff.norm_in.gamma.normal_(1.0, 0.1, generator=g)
        ff.norm_mid.gamma.normal_(1.0, 0.1, generator=g)
    packed = {k: v.to(dev) for k, v in fused_ff.pack_ff_weights(ff).items()}
    for b in (16, 8, 5, 1):
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
    # 4. int8 matmul at INT8_CASES, each beside its bound and
    #    torch._weight_int8pack_mm, on the weight stream (kernel 4's one
    #    route, at every row count)
    def int8pack_library(x, wq, s, out):
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

    for name, b, K, M in INT8_CASES:
        wq, s = quant.quantize_weight(torch.randn(K, M, generator=g))
        wq, s = wq.to(dev), s.to(dev)
        ins = dict(x=rand(b, K))

        def summary(low, out, b=b, K=K, M=M, wq=wq, s=s):
            return nbytes(low["x"], wq, s, out), 2 * b * K * M, int8pack_library(low["x"], wq, s, out)

        for dt in (torch.bfloat16, torch.float32):
            main_case = (name, b, dt) == ("head", 8, torch.bfloat16)
            ms = check("int8_matmul", f"{name} b{b} {K}x{M}", dt,
                       lambda x, wq=wq, s=s: quant.int8_matmul(x, wq, s),
                       lambda x, wq=wq, s=s: quant.int8_matmul_plain(x, wq, s), ins,
                       summary=summary if main_case else None)
            if dt != torch.bfloat16 or main_case:
                continue
            x = ins["x"].to(dt)
            out = quant.int8_matmul(x, wq, s)
            n_bytes, flops, lib = summary(dict(x=x), out)
            b_ms, b_by = bound_ms(n_bytes, flops, "bfloat16")
            lib_txt = f"{lib[1]:.4f} ms, kernel/library {ms[1] / lib[1]:.2f}x device" if lib else "none"
            print(f"    -> kernel 4 {name} b{b} {K}x{M} bf16: device {ms[1]:.4f} ms, bound "
                  f"{b_ms * 1e3:.2f} us ({b_by}), {ms[1] / b_ms:.1f}x bound; library device {lib_txt} [{card}]",
                  flush=True)
        del wq, s
    # 7. one whole decode layer: a full-width layer (seeded weights, LayerNorm
    #    gains and q/k scales drawn around 1) over the coarse / fine cache
    #    (N 1280) at b 8 with pos in the first and the last chunk, at the
    #    fine stage's b 14 (batch 2 x 7 windows), at an odd b 3, at pos 0 and
    #    at phase 7's reranking batch (b 4, 4 samples); then musiclm_large's layer width (16 heads of 64 at dim 1024) at b 8
    #    and pos 1279. The kernel writes the fresh row and the conv state in
    #    place, so each side gets its own copies. For context, one layer of
    #    the two-kernel flash_quant_decode_step (kernels 2 and 3 plus the
    #    plain projections and row write) over the same weights and cache.
    lfn = fused_layer.fused_layer_decode_step

    def layer_model_of(heads):
        model = TokenConditionedTransformer(
            (TokenSequenceSpec(1024, 1),), DIM, 1, heads=heads, generator=torch.Generator().manual_seed(5))
        with torch.no_grad():
            for t in (*model.transformer.attns[0].parameters(), *model.transformer.ffs[0].parameters()):
                if t.dim() == 1:
                    t.normal_(1.0, 0.1, generator=g)
        return model.to(dev).eval()

    def layer_plan_line(heads):
        plan = fused_layer.layer_plan(heads, DIM, INNER, cuda_lib.sm_count(dev))
        held = [sum(e[p][1] * plan.unit_bytes[p] for p in range(len(plan.units))) for e in plan.blocks]
        print(f"    kernel 7 plan, {heads} heads: grid {plan.grid} x {fused_layer.LAYER_THREADS} threads, "
              f"{plan.smem} B shared a block (weight share {min(held)}-{max(held)} B, gains to "
              f"{plan.stage_off}, staging {4 * plan.stage_floats} B, partials {4 * plan.part_floats} B), "
              f"weights {sum(held) / 1e6:.2f} MB", flush=True)

    #    Then musiclm_large's coarse cache (2,816 rows) at its last live row,
    #    b 1 and 8 (phase 8).
    for heads, cases in ((H, ((8, 100, N), (8, N - 1, N), (14, N - 1, N), (3, 700, N), (8, 0, N), (4, 100, N),
                              (4, N - 1, N))),
                         (16, ((8, N - 1, N), (1, LARGE_N - 51, LARGE_N), (8, LARGE_N - 51, LARGE_N)))):
        layer_model = layer_model_of(heads)
        layer_plan_line(heads)
        lpacked = fused_layer.pack_layer_weights(layer_model.transformer.attns[0], layer_model.transformer.ffs[0])
        two_model = copy.deepcopy(layer_model).to(torch.bfloat16)
        two_qp = {"ff_0": {"packed": fused_ff.pack_ff_weights(layer_model.transformer.ffs[0])}}
        for b, pos, N in cases:
            kq, ks = decode_attention.quantize_kv_row(attention.l2norm(rand(b, N, D)))
            vq, vs = decode_attention.quantize_kv_row(rand(b, N, D))
            kv, sc = torch.cat([kq, vq], -1).contiguous(), torch.stack([ks, vs]).contiguous()
            x32, st32, bias_row = rand(b, DIM), rand(b, 2, 2 * INNER), rand(N, heads)
            add_mask = torch.zeros(b, N, device=dev)
            label = f"b{b} N{N} pos{pos}" + ("" if heads == H else f" h{heads}")
            for dt in (torch.bfloat16, torch.float32):
                x, st = x32.to(dt), st32.to(dt)
                args = (pos, bias_row, add_mask)
                want = fused_layer.fused_layer_decode_step_plain(
                    x.float(), lpacked, kv.clone(), sc.clone(), st.float().clone(), *args, heads=heads)
                got = lfn(x, lpacked, kv.clone(), sc.clone(), st.clone(), *args, heads=heads)
                torch.cuda.synchronize()
                err, ref_max, tol = compare("fused_layer_decode_step", label, dt, got, want)
                kv_t, sc_t, st_t = kv.clone(), sc.clone(), st.clone()
                ms = both_ms(lambda: lfn(x, lpacked, kv_t, sc_t, st_t, *args, heads=heads))
                plain_ms = time_ms(lambda: fused_layer.fused_layer_decode_step_plain(
                    x, lpacked, kv_t, sc_t, st_t, *args, heads=heads), reps=5)
                summary = None
                if (b, pos, dt, heads) == (8, N - 1, torch.bfloat16, H):
                    # the cache rows j < pos and their scales, the bias rows and
                    # the mask the step reads; every weight once; x and the state
                    # in, y, krow, the state and the fresh row out
                    moved = (nbytes(x, st, *lpacked.values(), *got) + b * pos * (2 * D + 8)
                             + (pos + 1) * heads * 4 + b * pos * 4 + b * (2 * D + 8))
                    flops = (2 * b * DIM * (2 * heads * D + 2 * D + 3 * INNER)
                             + 4 * b * heads * D * (pos + 1))
                    summary = (moved, flops, None)  # no one PyTorch call computes a decode layer
                    cache = {"kv": kv.clone()[None], "kvs": sc.clone()[None], "ff": st.clone()[None]}
                    two = time_ms(lambda: flash_quant_decode_step(
                        two_model, two_qp, x, cache, pos, bias_row, add_mask, int8_kv=True))
                    print(f"    two-kernel flash_quant_decode_step, one layer, {label} {dt}: {two:.4f} ms on the "
                          f"stream (kernels 2 + 3, plain projections, row write, final LayerNorm) [{card}]",
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
                sum5, sum6 = backward_summaries(torch, F, dev, args, key_mask, library_time,
                                                causal_float_mask)
                if stage_name == "coarse":
                    sums = (sum5, sum6)
                lib5, lib6 = sum5[2], sum6[2]
                print(f"    -> kernel 5 {label} bf16: device {ms5[1]:.4f} ms, {sum5[1] / 1e9:.2f} GFLOP, "
                      f"{sum5[1] / (ms5[1] * 1e-3) / 1e12:.1f} TFLOP/s, SDPA backward (dq, dk, dv) "
                      f"device {lib5[1]:.4f} ms: kernel/SDPA {ms5[1] / lib5[1]:.2f}x device, "
                      f"{ms5[0] / lib5[0]:.2f}x stream [{card}]", flush=True)
                b6_ms, b6_by = bound_ms(sum6[0], sum6[1], "bfloat16")
                print(f"    -> kernel 6 {label} bf16: device {ms56[1] - ms5[1]:.4f} ms, bound {b6_ms * 1e3:.2f} us "
                      f"({b6_by}); kernels 5 + 6 device {ms56[1]:.4f} ms, SDPA backward with the mask's "
                      f"gradient device {lib6[1]:.4f} ms: kernels/SDPA {ms56[1] / lib6[1]:.2f}x device, "
                      f"{ms56[0] / lib6[0]:.2f}x stream [{card}]", flush=True)
            report("attention_bwd", label, dt, *compare("attention_bwd", label, dt, got[:3], want[:3]),
                   ms5, plain_ms, sums[0])
            report("attention_dbias", label, dt, *compare("attention_dbias", label, dt, got[3], want[3]),
                   (ms56[0] - ms5[0], ms56[1] - ms5[1]), plain_ms, sums[1])
            if dt == torch.bfloat16:
                # kernel 6 with the bias held in float32 beside bf16 inputs
                # (dbias comes back in float32)
                out_f, stats_f = attention.shared_kv_attention_fused(q, k, v, bias32, key_mask, return_stats=True)
                args_f = (q, k, v, bias32, key_mask, out_f, stats_f, dout)
                got_f = bwd(*args_f)[3]
                want_f = attention.shared_kv_attention_bwd_plain(
                    q.float(), k.float(), v.float(), dout.float(), attn_bias=bias32, key_mask=key_mask)[3]
                torch.cuda.synchronize()
                ms5f = both_ms(lambda: bwd(*args_f, dbias=False))
                ms56f = both_ms(lambda: bwd(*args_f))
                report("attention_dbias", label + " bias f32", dt,
                       *compare("attention_dbias", label + " bias f32", dt, got_f, want_f),
                       (ms56f[0] - ms5f[0], ms56f[1] - ms5f[1]), plain_ms)
                del out_f, stats_f, args_f, got_f, want_f
            del out, stats, want_out, want_stats, args, want, got
    # 5 and 6 at musiclm_large's 16 heads: its coarse training shape (b 2, n
    # 1116 in musiclm_large_small_context), bf16 with the key mask
    b, n, h = 2, 1116, 16
    q, k = attention.l2norm(rand(b, h, n, D)) * 1.5, attention.l2norm(rand(b, n, D)) * 1.5
    v, dout, bias = rand(b, n, D), rand(b, n, h * D), rand(h, n, n)
    q, k, v, dout, bias = (t.to(torch.bfloat16) for t in (q, k, v, dout, bias))
    key_mask = (torch.rand(b, n, generator=g) > 0.15).to(dev)
    key_mask[:, 0] = True
    out, stats = attention.shared_kv_attention_fused(q, k, v, bias, key_mask, return_stats=True)
    args = (q, k, v, bias, key_mask, out, stats, dout)
    want = attention.shared_kv_attention_bwd_plain(
        q.float(), k.float(), v.float(), dout.float(), attn_bias=bias.float(), key_mask=key_mask)
    got = bwd(*args)
    torch.cuda.synchronize()
    ms5, ms56 = both_ms(lambda: bwd(*args, dbias=False)), both_ms(lambda: bwd(*args))
    plain_ms = time_ms(lambda: attention.shared_kv_attention_bwd_plain(
        q, k, v, dout, attn_bias=bias, key_mask=key_mask), reps=5)
    label = f"coarse b{b} n{n} mask h{h}"
    report("attention_bwd", label, torch.bfloat16,
           *compare("attention_bwd", label, torch.bfloat16, got[:3], want[:3]), ms5, plain_ms)
    report("attention_dbias", label, torch.bfloat16,
           *compare("attention_dbias", label, torch.bfloat16, got[3], want[3]),
           (ms56[0] - ms5[0], ms56[1] - ms5[1]), plain_ms)
    del q, k, v, dout, bias, out, stats, args, want, got
    print("  (plain ms of attention_bwd / attention_dbias: one plain backward computing "
          "dq, dk, dv and dbias together)")
    timer.release()  # frees the L2 flush buffer before the phases that read peak memory

    print(f"chip_smoke: phase 3 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
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
    # phase 7's batches: "int8" at b1 (the continuation) and "fused" at b4
    # (the reranking's samples), drawn from their own seed
    g7 = torch.Generator().manual_seed(12)
    inputs = {b: (torch.randint(0, 1024, (b, 12), generator=g7), torch.randint(0, 1024, (b, 24, 1), generator=g7))
              for b in (1, 4)}
    inputs[2] = (cond, teacher)
    qp_cpu = quantize_stage_params(stage.model, fused=True)
    model_gpu = copy.deepcopy(stage.model).to(dev)
    qp_gpu = to_device(qp_cpu, dev)
    # flash_kv=None also with fused_ff=False: kernel 4 for every projection
    # of the step (1024 -> 512, 128, 5460; 512, 2730 -> 1024) at full width
    for mode, fused_ff_on, rel, b in (("bf16", True, 1e-4, 2), ("int8", True, 1e-2, 2), ("f32", True, 1e-4, 2),
                                      ("fused", True, 1e-2, 2), (None, True, 1e-4, 2), (None, False, 1e-4, 2),
                                      ("fp", True, 1e-4, 2), ("int8", True, 1e-2, 1), ("fused", True, 1e-2, 4)):
        cond, teacher = inputs[b]
        kw = dict(max_time_steps=24, temperature=0.0, teacher_ids=teacher, return_logits=True)
        if mode == "fp":
            _, want = token_cond.generate(stage.model, [cond], **kw)
            _, got = token_cond.generate(model_gpu, [cond.to(dev)], **kw)
        else:
            kw.update(flash_kv=mode, fused_ff=fused_ff_on)
            _, want = generate_quantized(stage.model, qp_cpu, [cond], **kw)
            _, got = generate_quantized(model_gpu, qp_gpu, [cond.to(dev)], **kw)
        got, want = got.cpu()[..., :-1], want[..., :-1]  # the EOS column is -1e9 on both
        err = (got - want).abs().max().item()
        tol = rel * max(1.0, want.abs().max().item())
        name = ("fp decode (quantized=False)" if mode == "fp" else
                f"int8 decode, flash_kv={mode}" + ("" if fused_ff_on else ", fused_ff=False"))
        print(f"{name}, semantic stage f32 b{b}, 24 teacher-forced steps: CUDA vs CPU plain logits "
              f"max_abs_err {err:.3e} tol {tol:.3e} (max |logit| {want.abs().max().item():.2f})",
              flush=True)
        if not err <= tol:
            fail(f"{name} b{b} logits differ: {err} > {tol}")
    del model_gpu, qp_gpu, stage, inputs

    print(f"chip_smoke: phase 3 (b) starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # ---- 3 (b). the T5 bias: every decode mode and the training step ----
    t5_launches = t5_phase(torch, omt_config, mc, dev, card, all_counters())
    print(json.dumps({"phase3b_t5_launches": t5_launches}))

    print(f"chip_smoke: phase 4 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
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

    expect = expect_launches

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

    # (b) one row alone and in batches of 4 and 8: flash_kv=None and fp
    rows_across_batches(torch, stages, dev, card)

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

    print(f"chip_smoke: phase 5 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # ---- 5. text to waveforms: the text tower, per-row keys, the server ----
    conditioning_phase(torch, omt_config, mc, dev, card, stages, codec, counters, expect, windows, time_ms)
    del musiclm, stages, codec
    torch.cuda.empty_cache()

    print(f"chip_smoke: phase 6 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # ---- 6. the training path ----
    train_launches, phase6_ms = training_phase(torch, omt_config, mc, dev, card, attention, kernels)
    path_launches.update(attention_bwd=train_launches["attention_bwd"],
                         attention_dbias=train_launches["attention_dbias"])
    torch.cuda.empty_cache()

    print(f"chip_smoke: phase 7 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # ---- 7. audio prompts and reranking ----
    audio_launches = audio_prompt_phase(torch, omt_config, mc, dev, card, counters, expect, windows, time_ms)
    print(json.dumps({"phase7_launches": audio_launches}))
    torch.cuda.empty_cache()

    print(f"chip_smoke: phase 8 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # ---- 8. musiclm_large: loading, 24 x 16 stages, the fusion CLAP, the CLI ----
    large_launches = large_phase(torch, omt_config, dev, card, counters, expect, windows, time_ms)
    print(json.dumps({"phase8_launches": large_launches}))
    torch.cuda.empty_cache()

    print(f"chip_smoke: phase 9 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # ---- 9. stage training from raw audio: the five training CLIs ----
    raw_launches = raw_audio_phase(torch, omt_config, dev, card, counters)
    print(json.dumps({"phase9_launches": raw_launches}))
    torch.cuda.empty_cache()

    print(f"chip_smoke: phase 10 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # ---- 10. remat at musiclm_large's width, data parallel, the rooflines ----
    phase10(torch, omt_config, dev, card, counters, phase6_ms)
    torch.cuda.empty_cache()

    print(f"chip_smoke: phase 11 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # ---- 11. tensor parallelism and the serving layouts ----
    print(json.dumps({"phase11": tp_phase(torch, omt_config, dev, card, all_counters())}))
    torch.cuda.empty_cache()

    print(f"chip_smoke: phase 12 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # ---- 12. the CLAP options and the profiling hooks ----
    print(json.dumps({"phase12_launches": clap_options_phase(
        torch, omt_config, dev, card, counters, expect, windows, time_ms)}))
    torch.cuda.empty_cache()

    print(f"chip_smoke: phase 13 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # ---- 13. the tools: serving deviation, pipeline profile, training trace ----
    print(json.dumps({"phase13": tools_phase(torch, omt_config, dev, card, all_counters(), expect)}))
    torch.cuda.empty_cache()

    print(f"chip_smoke: phase 14 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # ---- 14. the JAX package's orbax checkpoints: serve and resume ----
    print(json.dumps({"phase14": orbax_phase(torch, omt_config, dev, card, all_counters(), expect)}))

    print(f"chip_smoke: phases done at {time.perf_counter() - t_start:.1f} s", flush=True)
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


def t5_phase(torch, omt_config, mc, dev, card, counters) -> dict:
    """Phase 3 (b): musiclm_small's semantic stage at full width with the T5
    bucketed bias (``relative_position_bias_type="t5"``) and a bidirectional
    prefix over the start token and the 12 CLAP tokens (which makes the
    prefill read the table beyond bucket 0, where the JAX package puts every
    causal distance), float32, seed 13. (a) 12 teacher-forced steps at b2
    in every decode mode on the card against the CPU plain path (phase 3's
    limits), each with exactly its kernels; (b) the loss and every gradient
    on the card in float32 against the CPU in float64, within 3x the CPU
    float32 path's own distance (phase 6's gate), the bucket table's
    gradient among them (kernel 6's dbias through the Toeplitz and bucket
    scatter-adds); then one bfloat16 step (bf16 compute on the float32
    weights, kernels 1, 5 and 6 in bf16) against the CPU float32 gradients,
    within 3x the distance of the same bf16 step on the CPU. Returns each
    run's kernel launches."""
    import dataclasses

    from open_musiclm_torch.models import token_cond
    from open_musiclm_torch.models.quant_decode import generate_quantized, quantize_stage_params
    from open_musiclm_torch.models.token_cond import StageLossConfig, stage_training_loss

    t0 = time.perf_counter()
    mc_t5 = dataclasses.replace(mc, semantic_cfg=dataclasses.replace(
        mc.semantic_cfg, relative_position_bias_type="t5", non_causal_prefix_size=13, ff_dropout=0.0))
    cpu = omt_config.init_stage(mc_t5, "semantic", 13, device="cpu").model
    gpu = copy.deepcopy(cpu).to(dev)
    g = torch.Generator().manual_seed(14)
    cond, teacher = torch.randint(0, 1024, (2, 12), generator=g), torch.randint(0, 1024, (2, 12, 1), generator=g)
    qp_cpu = quantize_stage_params(cpu, fused=True)
    qp_gpu = to_device(qp_cpu, dev)
    paths = {"fp": {"prefill_attention"}, None: {"prefill_attention", "fused_ff_apply", "int8_matmul"},
             "fused": {"prefill_attention", "int8_matmul", "fused_layer_decode_step"}}
    flash = {"prefill_attention", "flash_decode_step", "fused_ff_apply", "int8_matmul"}
    out = {}
    for mode, fused_ff_on, rel in (("bf16", True, 1e-4), ("int8", True, 1e-2), ("f32", True, 1e-4),
                                   ("fused", True, 1e-2), (None, True, 1e-4), (None, False, 1e-4),
                                   ("fp", True, 1e-4)):
        kw = dict(max_time_steps=12, temperature=0.0, teacher_ids=teacher, return_logits=True)
        reset_counts(counters)
        if mode == "fp":
            _, want = token_cond.generate(cpu, [cond], **kw)
            _, got = token_cond.generate(gpu, [cond.to(dev)], **kw)
        else:
            kw.update(flash_kv=mode, fused_ff=fused_ff_on)
            _, want = generate_quantized(cpu, qp_cpu, [cond], **kw)
            _, got = generate_quantized(gpu, qp_gpu, [cond.to(dev)], **kw)
        launches = read_counts(counters)
        got, want = got.cpu()[..., :-1], want[..., :-1]
        err = (got - want).abs().max().item()
        tol = rel * max(1.0, want.abs().max().item())
        name = f"flash_kv={mode}" + ("" if fused_ff_on else ", fused_ff=False")
        print(f"phase 3 (b): T5 bias, semantic stage f32 b2, 12 teacher-forced steps, {name}: CUDA vs CPU plain "
              f"logits max_abs_err {err:.3e} tol {tol:.3e}; launches {launches} [{card}]", flush=True)
        if not err <= tol:
            fail(f"phase 3 (b): T5 {name} logits differ: {err} > {tol}")
        path = paths.get(mode, flash) if fused_ff_on else {"prefill_attention", "int8_matmul"}
        expect_launches(f"phase 3 (b) T5 {name}", launches, path)
        out[name] = launches
    del qp_cpu, qp_gpu

    # (b) gradients: float32 on the card against float64 on the CPU, then bf16
    lens = omt_config.stage_example_lengths(mc, "semantic")
    ids = [torch.randint(0, s.codebook_size, (2, n), generator=g) for s, n in zip(cpu.specs, lens)]
    ids[0][0, -1] = -1
    cfg = StageLossConfig((0.5, 1.0), mask_prob=0.0)

    def loss_and_grads(model, device):
        model.zero_grad()
        loss, _ = stage_training_loss(model.train(), [t.to(device) for t in ids], cfg, train=True)
        loss.backward()
        return loss.item(), {n: p.grad.double().cpu() for n, p in model.named_parameters()}

    def worst(grads, want):
        """(max over tensors of max abs err / max|want|, the tensor)."""
        return max(((grads[n] - w).abs().max().item() / max(w.abs().max().item(), 1e-30), n)
                   for n, w in want.items())

    reset_counts(counters)
    gpu_loss, gpu_grads = loss_and_grads(gpu, dev)
    f32_launches = read_counts(counters)
    cpu_loss, cpu_grads = loss_and_grads(cpu, "cpu")
    _, f64_grads = loss_and_grads(copy.deepcopy(cpu).double(), "cpu")
    table = "transformer.rel_pos_bias.embedding"
    card_err, cpu_err = worst(gpu_grads, f64_grads), worst(cpu_grads, f64_grads)
    table_err = worst({table: gpu_grads[table]}, {table: f64_grads[table]})[0]
    limit = 3 * cpu_err[0]
    print(f"phase 3 (b): T5 semantic stage f32 b2, loss card {gpu_loss:.6f} CPU {cpu_loss:.6f}; gradients against "
          f"CPU f64: card worst {card_err[0]:.2e} ({card_err[1]}), bucket table {table_err:.2e}, limit {limit:.2e} "
          f"(3 x CPU f32 worst {cpu_err[0]:.2e}); launches {f32_launches} [{card}]", flush=True)
    if not card_err[0] <= limit or abs(gpu_loss - cpu_loss) > 1e-4 * abs(cpu_loss) or not cpu_err[0] <= 3e-4:
        fail(f"phase 3 (b): T5 gradients on the card differ: {card_err} > {limit} (CPU f32 {cpu_err})")
    depth = len(gpu.transformer.attns)
    want_launches = {"prefill_attention": depth, "attention_bwd": depth, "attention_dbias": depth}
    expect_launches("phase 3 (b) T5 training f32", f32_launches, set(want_launches))
    gpu.compute_dtype = cpu.compute_dtype = torch.bfloat16
    reset_counts(counters)
    bf16_loss, bf16_grads = loss_and_grads(gpu, dev)
    bf16_launches = read_counts(counters)
    _, cpu_bf16_grads = loss_and_grads(cpu, "cpu")
    card_err, cpu_err = worst(bf16_grads, cpu_grads), worst(cpu_bf16_grads, cpu_grads)
    table_err = worst({table: bf16_grads[table]}, {table: cpu_grads[table]})[0]
    print(f"phase 3 (b): T5 semantic stage bf16 step b2, loss {bf16_loss:.6f}; gradients against CPU f32: card "
          f"worst {card_err[0]:.2e} ({card_err[1]}), bucket table {table_err:.2e}, limit {3 * cpu_err[0]:.2e} "
          f"(3 x the CPU bf16 step's worst {cpu_err[0]:.2e}); launches {bf16_launches}; phase 3 (b) "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    if not card_err[0] <= 3 * cpu_err[0] or not math.isfinite(bf16_loss):
        fail(f"phase 3 (b): T5 bf16 gradients on the card: {card_err} > 3 x {cpu_err}")
    if dev.type == "cuda" and bf16_launches != {k: want_launches.get(k, 0) for k in bf16_launches}:
        fail(f"phase 3 (b): T5 bf16 step launched {bf16_launches}, want {want_launches}")
    out["training f32"], out["training bf16"] = f32_launches, bf16_launches
    return out


# phase 4 (b)'s teacher-forced steps a stage and mode (cut from 6 for time)
TF_STEPS_4B = 3


def rows_across_batches(torch, stages, dev, card) -> None:
    """Phase 4 (b): TF_STEPS_4B teacher-forced steps of each stage in
    "int8", flash_kv=None and the fp decode, row 2 alone (b 1) and in slot
    2 of b 4 and b 8: its logits bit-equal. (Phase 11's one-process runs hold
    MusicLM.generate in "int8" at b4 / b8 and in "fused" at b1 / b4 / b8.)"""
    from open_musiclm_torch.models.stages import Stage

    g = torch.Generator().manual_seed(161)
    r = 2
    for key, st in stages.items():
        model = st.model
        cond = [torch.randint(0, spec.codebook_size, (8, 12 if i == 0 else 24 * spec.num_quantizers), generator=g)
                .to(dev) for i, spec in enumerate(model.specs[:-1])]
        teacher = torch.randint(0, model.specs[-1].codebook_size, (8, TF_STEPS_4B, model.specs[-1].num_quantizers),
                                generator=g).to(dev)
        for mode in (dict(quantized=True, flash_kv="int8"), dict(quantized=True, flash_kv=None),
                     dict(quantized=False)):
            stage = Stage(model, name=key, **mode)

            def logits(rows):
                return stage.generate([c[rows] for c in cond], teacher_forced_ids=teacher[rows],
                                      max_time_steps=TF_STEPS_4B, temperature=0.0, return_logits=True)[1]

            alone = logits(slice(r, r + 1))[0]
            equal = {b: torch.equal(logits(slice(0, b))[r], alone) for b in (4, 8)}
            print(f"phase 4 (b): {key} {mode}, {TF_STEPS_4B} teacher-forced steps, row {r} alone against its slot in "
                  f"b4 / b8: logits bit-equal {equal} [{card}]", flush=True)
            if not all(equal.values()):
                fail(f"phase 4 (b) {key} {mode}: row {r}'s logits depend on its batch: {equal}")


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


# the demo vocabulary's merges over bytes_to_unicode's symbols ("Ġ" is the
# space byte): the real roberta-base vocab.json and merges.txt are not in the
# repository
DEMO_MERGES = (("Ġ", "t"), ("h", "e"), ("Ġt", "he"), ("i", "n"), ("Ġ", "a"), ("e", "r"), ("o", "n"),
               ("Ġ", "s"), ("a", "n"), ("Ġ", "w"), ("r", "o"), ("Ġ", "b"))
PROMPTS = (
    "a calm piano melody with soft strings",
    "upbeat electronic dance track, 128 bpm, heavy bass",
    "lo-fi hip hop beat for studying",
    "an orchestral film score building to a climax",
    "acoustic guitar and whistling on a sunny afternoon",
    "café jazz trio — brushed drums, upright bass ♪",
    "distorted rock riff with pounding drums!!!",
    " ".join(["a long rambling prompt about ambient drones and field recordings"] * 6),  # > 77 tokens
)
# card vs CPU float32 text embeddings (unit norm, components ~0.04; TF32 off)
TEXT_EMB_TOL = 1e-4
# a request's wave in two batches of other sizes (the JAX package's
# tests/test_serve.py limit; the card decodes Encodec a row at a time, so
# the rows' bits are equal)
ROW_WAVE_TOL = 1e-6
# nearest-code margins: moving x by d moves score_k - score_j (2 x.c - |c|^2)
# by at most 2 |d|_2 |c_k - c_j| <= 2 sqrt(512) max|d| * ~32 for N(0, 1) codes
# in 512 dims, ~1450 max|d|; a position whose CPU margin exceeds TIE_MULT x
# its row's max|d|, plus TIE_ROUNDING for the scores' own float32 rounding
# (scores ~|c|^2 ~ 512), must get the same token on the card
TIE_MULT, TIE_ROUNDING = 4096, 1e-2


def check_off_near_ties(torch, x_cpu, row_err, books, got, want, what: str):
    """Codes [n, Q] on the card against the CPU's off near ties: at quantizer
    q the CPU's code maximizes 2 r.c - |c|^2 over ``books[q]`` ([K, D]; the
    residual r is x less the codes before q). A position whose CPU margin
    exceeds TIE_MULT x its row's max error + TIE_ROUNDING must get the same
    code; a row's quantizers after a near tie are not checked (a tie
    changes every later residual). Returns (checked, near-tie positions)."""
    resid, row_err = x_cpu.double(), row_err.double()
    live = torch.ones(len(resid), dtype=torch.bool)  # rows whose earlier quantizers were all decided
    checked = near = 0
    for q, cb in enumerate(books.double()):
        score = 2.0 * resid @ cb.t() - (cb * cb).sum(-1)[None]
        top = score.topk(2, dim=-1).values
        decided = live & (top[:, 0] - top[:, 1] > TIE_MULT * row_err + TIE_ROUNDING)
        near += int((~decided).sum())
        checked += int(decided.sum())
        if not torch.equal(got[decided, q], want[decided, q]):
            fail(f"{what} differ at quantizer {q} on rows whose margin is not a near tie")
        live = decided
        resid = resid - cb[want[:, q]]
    return checked, near


def write_demo_vocab(folder: Path) -> None:
    """A byte-level vocabulary: the special ids, the 256 byte symbols and
    DEMO_MERGES' results, every id below roberta-base's 50265."""
    from open_musiclm_torch.models.clap.tokenizer import bytes_to_unicode

    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for c in sorted(set(bytes_to_unicode().values())):
        vocab[c] = len(vocab)
    for a, b in DEMO_MERGES:
        vocab[a + b] = len(vocab)
    (folder / "vocab.json").write_text(json.dumps(vocab))
    (folder / "merges.txt").write_text("#version: demo\n" + "".join(f"{a} {b}\n" for a, b in DEMO_MERGES))


def text_tower_bound(model, b: int, t: int, dtype: str):
    """(bound ms, what bounds it, GFLOP) of one get_text_embedding call at
    b x t: every weight read once (the embedding tables' looked-up rows
    only), the ids and the output moved once; the FLOPs of every position."""
    branch, cfg = model.text_branch, model.text_branch.cfg
    H, F, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    joint = model.text_projection[2].out_features
    flops = (2 * b * t * L * (4 * H * H + 2 * H * F) + 4 * b * t * t * H * L
             + 2 * b * (H * H + H * joint + joint * joint))
    tables = sum(m.weight.numel() for m in (branch.embeddings.word_embeddings,
                                           branch.embeddings.position_embeddings))
    elem = 2 if dtype == "bfloat16" else 4
    n_params = sum(p.numel() for p in model.text_branch.parameters()) - tables
    n_params += sum(p.numel() for p in model.text_projection.parameters())
    n_bytes = (n_params + 2 * b * t * H) * elem + 2 * b * t * 8 + b * joint * 4
    ms, by = bound_ms(n_bytes, flops, dtype)
    return ms, by, flops / 1e9


def conditioning_phase(torch, omt_config, mc, dev, card, stages, codec, counters, expect, windows,
                       stream_ms):
    """Phase 5: text to waveforms. The tokenizer on a demo vocabulary, the
    full-width text tower (RoBERTa-base, the projection, a 12 x 1024 x 512
    RVQ) on the card against the CPU, the per-row keys' bits on both,
    decode-step launches with per-row keys at b1 and b8, MusicLM.generate
    from 8 text prompts in "int8" (kernels 1-4, counted), and the
    GenerationServer in "fused" mode."""
    import numpy as np

    from open_musiclm_torch.core.sampling import fold_in_rows, row_uniforms, seed_keys, split_row_keys
    from open_musiclm_torch.models.clap.tokenizer import load_tokenizer
    from open_musiclm_torch.models.musiclm import MusicLM
    from open_musiclm_torch.models.stages import Stage
    from open_musiclm_torch.serve import GenerationServer

    # a. tokenizer
    with tempfile.TemporaryDirectory() as tmp:
        write_demo_vocab(Path(tmp))
        tok = load_tokenizer(tmp)
    enc = tok(list(PROMPTS))
    lengths = enc["attention_mask"].sum(1).tolist()
    print(f"tokenizer (demo vocabulary, {len(DEMO_MERGES)} merges): {len(PROMPTS)} prompts, "
          f"lengths {lengths} of 77", flush=True)
    if max(lengths) != 77 or enc["input_ids"].max() >= 50265:
        fail(f"tokenizer: lengths {lengths} (one prompt must be truncated to 77), ids < 50265")

    # b. the text tower on the card against the CPU, float32, same seed
    t0 = time.perf_counter()
    clap_gpu = omt_config.build_clap(mc, torch.Generator().manual_seed(31))
    clap_cpu = omt_config.build_clap(mc, torch.Generator().manual_seed(31), device="cpu")
    print(f"build_clap (RoBERTa-base + projection, RVQ {tuple(clap_gpu.rvq.codebooks.shape)}) x2: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    emb_gpu = clap_gpu.text_embedding(enc["input_ids"], enc["attention_mask"])
    emb_cpu = clap_cpu.text_embedding(enc["input_ids"], enc["attention_mask"])
    if emb_gpu.device.type != "cuda" or emb_gpu.shape != (8, 512) or not torch.isfinite(emb_gpu).all():
        fail(f"text embedding: {emb_gpu.device} {tuple(emb_gpu.shape)}, want cuda (8, 512), finite")
    diff = (emb_gpu.cpu() - emb_cpu).abs()
    err = diff.max().item()
    norm_err = (torch.linalg.vector_norm(emb_gpu, dim=-1) - 1).abs().max().item()
    print(f"text embedding b8 float32, card vs CPU: max_abs_err {err:.3e} tol {TEXT_EMB_TOL:.0e}, "
          f"| |e| - 1 | {norm_err:.1e}", flush=True)
    if not err <= TEXT_EMB_TOL:
        fail(f"text embeddings differ: {err} > {TEXT_EMB_TOL}")
    tok_gpu = clap_gpu.quantize(emb_gpu).cpu()
    tok_cpu = clap_cpu.quantize(emb_cpu)
    checked, near = check_off_near_ties(torch, emb_cpu, diff.amax(dim=1), clap_cpu.rvq.codebooks,
                                        tok_gpu[..., 0], tok_cpu[..., 0], "CLAP tokens")
    print(f"CLAP tokens [8, 12, 1] card vs CPU: {checked} positions decided and equal, {near} near-tie "
          f"positions (margin <= {TIE_MULT} x the row's embedding error + {TIE_ROUNDING}, or after one); "
          f"tokens equal at {int((tok_gpu == tok_cpu).sum())} of 96", flush=True)

    ids_d = torch.from_numpy(enc["input_ids"]).to(dev, torch.long)
    mask_d = torch.from_numpy(enc["attention_mask"]).to(dev, torch.long)
    bf16_model = copy.deepcopy(clap_gpu.model).to(torch.bfloat16)
    bf16_model.text_branch.compute_dtype = torch.bfloat16
    for name, model in (("float32", clap_gpu.model), ("bfloat16", bf16_model)):
        with torch.no_grad():
            ms = stream_ms(lambda: model.get_text_embedding(ids_d, mask_d))
        b_ms, b_by, gflop = text_tower_bound(model, 8, 77, name)
        print(f"text tower b8 x 77 (RoBERTa-base + projection, get_text_embedding) {name}: {ms:.3f} ms, "
              f"bound {b_ms:.3f} ms ({b_by}; {gflop:.1f} GFLOP, {gflop / ms:.1f} TFLOP/s) [{card}]",
              flush=True)
    del bf16_model, clap_cpu

    # c. per-row keys: the same bits on the card and the CPU; decode-step
    # launches with per-row keys the same at b1 and b8
    keys = fold_in_rows(seed_keys([0, 1, 7, 2 ** 40, -1, 12345, 99, 3]), 1, 4)
    sub, carry = split_row_keys(keys)
    sub_d, carry_d = split_row_keys(keys.to(dev))
    u_cpu, u_gpu = row_uniforms(sub, 1025), row_uniforms(sub_d, 1025).cpu()
    same = (torch.equal(sub_d.cpu(), sub) and torch.equal(carry_d.cpu(), carry)
            and torch.equal(fold_in_rows(keys.to(dev), 2, 3).cpu(), fold_in_rows(keys, 2, 3))
            and torch.equal(u_gpu, u_cpu))
    print(f"per-row keys: splits, folds and [8, 1025] uniforms card vs CPU bit-equal: {same}", flush=True)
    if not same:
        fail("per-row keys or uniforms differ between the card and the CPU")
    sem = stages["semantic_stage"].model
    clap8 = tok_gpu.reshape(8, -1).to(dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    row_keys = seed_keys(range(8), device=dev)
    for mode in ("int8", "fused"):
        st = Stage(sem, name="semantic", quantized=True, flash_kv=mode)
        st.generate([clap8], gen, max_time_steps=4)  # warm-up, qparams

        n_gen = step_launches(torch, st, clap8, gen)
        n1 = step_launches(torch, st, clap8[:1], gen, per_row_keys=row_keys[:1])
        n8 = step_launches(torch, st, clap8, gen, per_row_keys=row_keys)
        print(f"decode step, semantic, flash_kv={mode}: CUDA launches a step (raw), per-row keys b1 "
              f"{n1[0]} ({n1[1]:.3f}), b8 {n8[0]} ({n8[1]:.3f}); generator b8 {n_gen[0]} ({n_gen[1]:.3f})",
              flush=True)
        if n1[0] != n8[0]:
            fail(f"flash_kv={mode}: per-row-key decode step launches {n1} at b1, {n8} at b8")

    # d. text to waveforms, "int8", b8 x 4 s, per-row keys: kernels 1-4
    musiclm = MusicLM(codec=codec, clap=clap_gpu, tokenizer=tok, **stages)
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wave = musiclm.generate(text=list(PROMPTS), per_row_keys=seed_keys(range(8)), output_seconds=4.0, **windows)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}
    print(f"MusicLM.generate(text=8 prompts, per_row_keys) flash_kv=int8, batch 8 x 4.0 s: wave "
          f"{tuple(wave.shape)} {wall:.2f} s wall (text tower included), "
          f"{8 * 4.0 / wall:.3f} audio-s/wall-s [{card}]", flush=True)
    if tuple(wave.shape) != (8, 96000) or not torch.isfinite(wave.float()).all():
        fail(f"text to wave: waveform {tuple(wave.shape)} (want (8, 96000)) or non-finite samples")
    expect("text, flash_kv=int8", launches,
           {"prefill_attention", "flash_decode_step", "fused_ff_apply", "int8_matmul"})

    # e. the server, "fused", batch_size 8, buckets [1, 8], 2 workers
    fused = {key: Stage(st.model, name=st.name, quantized=True, flash_kv="fused") for key, st in stages.items()}
    for st in fused.values():
        st.qparams()
    server_lm = MusicLM(codec=codec, clap=clap_gpu, tokenizer=tok, **fused)
    calls = []  # (rows, row keys) of each generate call
    generate = server_lm.generate

    def spy(**kw):
        calls.append((int(kw["clap_token_ids"].shape[0]), kw["per_row_keys"].tolist()))
        return generate(**kw)

    server_lm.generate = spy
    codes_of_calls = []  # the codes reaching Encodec, a generate call each
    decode = server_lm._decode

    def capture(c):
        codes_of_calls.append(c.cpu())
        return decode(c)

    server_lm._decode = capture
    gen_kw = dict(output_seconds=4.0, **windows)

    def serve(requests, started):
        """Waves and latencies (s) of ``requests`` [(text, seed)] on a new
        server, submitted all at once after (started) or before its start."""
        server = GenerationServer(server_lm, batch_size=8, batch_buckets=[1, 8], num_workers=2, **gen_kw)
        if started:
            server.start()
        done, t_submit = {}, time.perf_counter()
        futs = [server.submit(text, seed=seed) for text, seed in requests]
        for i, f in enumerate(futs):
            f.add_done_callback(lambda _, i=i: done.setdefault(i, time.perf_counter()))
        if not started:
            server.start()
        try:
            waves = [f.result(timeout=600) for f in futs]
        finally:
            server.stop()
        for w in waves:
            if w.shape != (96000,) or not np.isfinite(w).all():
                fail(f"server: waveform {w.shape} (want (96000,)) or non-finite samples")
        return waves, [done[i] - t_submit for i in range(len(futs))]

    server = GenerationServer(server_lm, batch_size=8, batch_buckets=[1, 8], num_workers=2, **gen_kw).start()
    try:
        t_submit = time.perf_counter()
        futs = [server.submit(p, seed=100 + i) for i, p in enumerate(PROMPTS)]
        waves = [f.result(timeout=600) for f in futs]
        lat8 = time.perf_counter() - t_submit
        n_calls = len(calls)
        t_submit = time.perf_counter()
        lone = server.submit("a lone request for a slow waltz", seed=200).result(timeout=600)
        lat1 = time.perf_counter() - t_submit
    finally:
        server.stop()
    print(f"server (flash_kv=fused, buckets [1, 8], 2 workers): 8 concurrent text requests in "
          f"{n_calls} batch(es) of rows {[r for r, _ in calls[:n_calls]]}, all resolved {lat8:.2f} s "
          f"after submission; then a lone request in rows {calls[-1][0]}: {lat1:.2f} s [{card}]", flush=True)
    if calls[-1][0] != 1 or len(calls) != n_calls + 1 or lone.shape != (96000,) or len(waves) != 8:
        fail(f"server: the lone request ran at rows {calls[-1][0]} (want bucket 1), calls {len(calls)}")

    target = ("a (text, seed) request held across batches: warm synth pads", 4242)
    first = [target] + [(p, 300 + i) for i, p in enumerate(PROMPTS[:7])]
    second = [(p, 400 + i) for i, p in enumerate(PROMPTS[1:6])] + [target] + [(p, 500 + i) for i, p in enumerate(PROMPTS[6:8])]
    target_key = seed_keys([target[1]]).item()
    slots = []
    for requests in (first, second, [target]):
        n0 = len(calls)
        waves, lat = serve(requests, started=False)
        i, (rows, keys_) = next((n0 + j, c) for j, c in enumerate(calls[n0:]) if target_key in c[1])
        slot = keys_.index(target_key)
        slots.append((rows, slot, waves[requests.index(target)], codes_of_calls[i][slot]))
        print(f"  server round of 8: batches of rows {[r for r, _ in calls[n0:]]}, latency per request "
              f"{', '.join(f'{x:.2f}' for x in lat)} s; the target at slot {slots[-1][1]} of {rows} [{card}]",
              flush=True)
    (rows_a, slot_a, wave_a, codes_a), (rows_b, slot_b, wave_b, codes_b), (rows_c, _, wave_c, codes_c) = slots
    equal = bool(np.array_equal(wave_a, wave_b))
    alone = bool(torch.equal(codes_c, codes_a)), float(np.abs(wave_c - wave_a).max())
    print(f"server: the same (text, seed) at slot {slot_a} and slot {slot_b} of two batch-8 batches with "
          f"other companions: codes bit-equal {torch.equal(codes_a, codes_b)}, waves bit-equal {equal}; "
          f"alone at bucket {rows_c}: codes bit-equal to bucket 8's {alone[0]}, waves max abs diff "
          f"{alone[1]:.2e} (limit {ROW_WAVE_TOL:.0e}) [{card}]", flush=True)
    if rows_a != 8 or rows_b != 8 or slot_a == slot_b or rows_c != 1:
        fail(f"server rounds: the target ran at rows {rows_a}/{rows_b}/{rows_c}, slots {slot_a}/{slot_b}")
    if not equal or not torch.equal(codes_a, codes_b):
        fail(f"server: the same request's waves differ across batches "
             f"(max abs diff {np.abs(wave_a - wave_b).max()})")
    if not alone[0] or not alone[1] <= ROW_WAVE_TOL:
        fail(f"server: the request alone at bucket 1 differs from its row at bucket 8: codes equal {alone[0]}, "
             f"waves {alone[1]}")
    del server_lm.generate, server_lm._decode  # the spies refer to server_lm: a cycle would keep its CLAP on the card


def step_launches(torch, stage, clap, gen, **kw):
    """CUDA launches (kernels and copies) a decode step of Stage.generate,
    as (whole, raw): per kernel name, a 48-step call's count less a 16-step
    call's, over 32, each call in its own torch.profiler session; ``raw``
    sums these, ``whole`` sums them rounded to whole launches. A session
    late in a long run now and then reports a few events too many or too
    few (seen as a total that moved by a fraction of a launch from reading
    to reading), which the rounding takes out; a loop over rows would add
    whole launches a step for every row."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    counts = []
    for steps in (16, 48):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            stage.generate([clap], gen, max_time_steps=steps, **kw)
            torch.cuda.synchronize()
        counts.append({e.key: e.count for e in prof.key_averages() if e.device_type == cuda})
    per = [(counts[1].get(k, 0) - counts[0].get(k, 0)) / 32 for k in set(counts[0]) | set(counts[1])]
    return sum(round(v) for v in per), sum(per)


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
                                          "dbias_kernel", "dbias_bf16_kernel", "delta_kernel",
                                          "sum_heads_kernel"),
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
    """Phase 6. Returns the launches of kernels 1, 5 and 6 during the
    StageTrainer.train run, and its ms a step."""
    from open_musiclm_torch.models import transformer
    from open_musiclm_torch.checkpoint import find_latest_checkpoint
    from open_musiclm_torch.data.dataset import PreprocessedDataset, batch_iterator, train_valid_split
    from open_musiclm_torch.data.pipeline import accumulate_token_batches
    from open_musiclm_torch.models.token_cond import StageLossConfig, stage_training_loss
    from open_musiclm_torch.train.flops import peak_flops, stage_train_flops
    from open_musiclm_torch.train.trainer import StageTrainer

    lens = omt_config.stage_example_lengths(mc, "coarse")

    # 6a. full-width coarse gradients on the card (float32, batch 2, no
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

    # 6b. StageTrainer.train on a token store, the coarse trainer config
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
    return launches, step_ms


# phase 7: card vs CPU float32 towers (TF32 off): HuBERT's layer-7 features
# and the Encodec latent within TOWER_REL x their largest element (float32
# sums in another order over up to 512 x 3 conv taps and 3072 FF terms),
# HTSAT's unit-norm embeddings within TOWER_ABS
TOWER_REL, TOWER_ABS = 1e-4, 1e-4
PRIME_SECONDS, PRIME_HZ = 10, 48000


def seeded_prime(seed: int, seconds: float, hz: int):
    """[1, seconds * hz] float32: a few sines plus noise from ``seed``."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * hz)) / hz
    wave = sum(a * np.sin(2 * np.pi * f * t + ph) for a, f, ph in
               zip(rng.uniform(0.05, 0.2, 4), rng.uniform(80, 2000, 4), rng.uniform(0, 6.28, 4)))
    wave = wave + 0.02 * rng.randn(len(t))
    return torch.from_numpy(wave.astype(np.float32))[None]


def check_prepared(torch, prime, hz: int, target_hz: int, normalize: bool, dev, what: str):
    """prepare_audio of the seeded prime on the card against the CPU. The
    float32 wave before the int16 truncation must lie within 3x the CPU
    float32 wave's own worst distance from float64 (the reductions of the
    normalization and the resampler's taps run in another order), and the
    card's int16 samples must be its own wave truncated, so that a sample
    differs from the CPU's only by one step, where the two waves straddle
    one. Returns the CPU's prepared wave."""
    from open_musiclm_torch.ops.audio import int16_round_trip, prepare_audio, resample, zero_mean_unit_var_norm

    def before_truncation(x):
        x = zero_mean_unit_var_norm(x) if normalize else x
        return resample(x[..., : PRIME_SECONDS * hz], hz, target_hz)

    kw = dict(normalize=normalize, target_length_seconds=PRIME_SECONDS)
    want, got = prepare_audio(prime, hz, target_hz, **kw), prepare_audio(prime.to(dev), hz, target_hz, **kw).cpu()
    y64 = before_truncation(prime.double())
    y_cpu, y_card = before_truncation(prime), before_truncation(prime.to(dev)).cpu()
    cpu_err = (y_cpu.double() - y64).abs().max().item()
    card_err = (y_card.double() - y64).abs().max().item()
    steps = ((got - want).abs() * 32767).round()
    print(f"prepared {what} prime ({target_hz} Hz), card vs CPU: before the int16 truncation "
          f"{(y_card - y_cpu).abs().max().item():.3e} apart; from float64 card {card_err:.3e}, CPU {cpu_err:.3e} "
          f"(limit {3 * cpu_err:.3e}); {int((steps > 0).sum())} of {want.numel()} int16 samples a step apart",
          flush=True)
    if not card_err <= 3 * cpu_err:
        fail(f"prepared {what} prime: card {card_err} from float64, over 3x the CPU's {cpu_err}")
    if not torch.equal(got, int16_round_trip(y_card)) or steps.max().item() > 1:
        fail(f"prepared {what} prime: int16 samples other than the card's own wave truncated, "
             f"or more than one step from the CPU's ({steps.max().item():.0f} steps)")
    return want


def tower_cost(torch, model, run):
    """(FLOPs, parameter bytes) of one ``run()`` of ``model``'s modules: the
    linear, conv and LSTM products and the attention matmuls (HuBERT's
    Attention, HTSAT's WindowAttention) each forward took, and the
    parameters of every module that ran, each read once."""
    from torch import nn

    flops, ran = [0], set()

    def hook(module, inputs, out):
        ran.add(module)
        name = type(module).__name__
        if isinstance(module, nn.Linear):
            flops[0] += 2 * out.numel() * module.in_features
        elif isinstance(module, (nn.Conv1d, nn.Conv2d)):
            flops[0] += 2 * out.numel() * module.weight[0].numel()
        elif isinstance(module, nn.LSTM):
            rows = out[0].shape[0] * out[0].shape[1]
            flops[0] += sum(2 * 4 * module.hidden_size * (w.shape[1] + module.hidden_size) * rows
                            for w in (getattr(module, f"weight_ih_l{l}") for l in range(module.num_layers)))
        elif name in ("Attention", "WindowAttention"):  # q k^T and p v
            b, n, c = inputs[0].shape
            flops[0] += 4 * b * n * n * c

    handles = [m.register_forward_hook(hook) for m in model.modules()]
    try:
        with torch.no_grad():
            run()
    finally:
        for h in handles:
            h.remove()
    params = sum(p.numel() * p.element_size() for m in ran for p in m.parameters(recurse=False))
    return flops[0], params


def audio_prompt_phase(torch, omt_config, mc, dev, card, counters, expect, windows, stream_ms):
    """Phase 7: audio prompts and reranking. HuBERT (MERT-v0 geometry, a
    1024 x 768 codebook), the Encodec encoder and HTSAT-tiny (with the audio
    projection) at full width in float32 on the card against the CPU, each
    timed beside its bound; MusicLM.generate(prime_wave=10 s at 48 kHz,
    output_seconds=12) in "fused" at b1 (exactly kernels 1, 4, 7), once more
    with return_coarse_generated_wave; generate_top_match(2 prompts x 4 samples,
    4 s) in "fused" (exactly kernels 7, 1, 4). Returns the two runs' launches."""
    from open_musiclm_torch.models.clap.tokenizer import load_tokenizer
    from open_musiclm_torch.models.hubert import zero_mean_unit_var
    from open_musiclm_torch.models.musiclm import MusicLM
    from open_musiclm_torch.models.stages import Stage

    t_phase = time.perf_counter()
    prime = seeded_prime(7, PRIME_SECONDS, PRIME_HZ)
    prime_gpu = prime.to(dev)

    # a. HuBERT + k-means, b1 x 10 s at 16 kHz
    w2v_gpu = omt_config.build_hubert(mc, torch.Generator().manual_seed(41))
    w2v_cpu = omt_config.build_hubert(mc, torch.Generator().manual_seed(41), device="cpu")
    # the continuation feeds HuBERT and the encoder the card's own prepared
    # prime; the towers are compared here on the CPU's
    wav16 = check_prepared(torch, prime, PRIME_HZ, w2v_cpu.target_sample_hz, True, dev, "HuBERT")
    with torch.no_grad():
        raw_cpu = w2v_cpu.model.extract_features(wav16, w2v_cpu.embed_layer)[0]
        raw_gpu = w2v_gpu.model.extract_features(wav16.to(dev), w2v_gpu.embed_layer)[0].cpu()
    err = (raw_gpu - raw_cpu).abs().max().item()
    tol = TOWER_REL * raw_cpu.abs().max().item()
    print(f"HuBERT (MERT-v0 geometry) layer-{w2v_cpu.embed_layer} features {tuple(raw_cpu.shape)} float32, card vs "
          f"CPU: max_abs_err {err:.3e} tol {tol:.3e} (max |x| {raw_cpu.abs().max().item():.2f})", flush=True)
    if not err <= tol:
        fail(f"HuBERT features differ: {err} > {tol}")
    x_cpu, x_gpu = zero_mean_unit_var(raw_cpu), zero_mean_unit_var(raw_gpu)
    ids_cpu, ids_gpu = w2v_cpu(wav16)[0], w2v_gpu(wav16.to(dev))[0].cpu()
    checked, near = check_off_near_ties(torch, x_cpu, (x_gpu - x_cpu).abs().amax(dim=1), w2v_cpu.centroids[None],
                                        ids_gpu[:, None], ids_cpu[:, None], "semantic ids")
    print(f"semantic ids [{len(ids_cpu)}] card vs CPU: {checked} decided and equal, {near} near ties; "
          f"equal at {int((ids_gpu == ids_cpu).sum())} of {len(ids_cpu)}", flush=True)
    wav16_d = wav16.to(dev)
    ms = stream_ms(lambda: w2v_gpu(wav16_d), reps=10)
    flops, params = tower_cost(torch, w2v_gpu, lambda: w2v_gpu(wav16_d))
    flops += 2 * len(ids_cpu) * w2v_gpu.centroids.numel()  # the k-means product
    b_ms, b_by = bound_ms(params + w2v_gpu.centroids.numel() * 4 + wav16.numel() * 4, flops, "float32")
    print(f"HuBERT + k-means b1 x {PRIME_SECONDS} s (layers 0-{w2v_cpu.embed_layer - 1} run): {ms:.3f} ms, bound "
          f"{b_ms:.3f} ms ({b_by}; {flops / 1e9:.1f} GFLOP, {flops / 1e9 / ms:.2f} TFLOP/s) [{card}]", flush=True)
    del w2v_cpu, raw_cpu, raw_gpu

    # b. the Encodec encoder at 6 kbps, b1 x 10 s at 24 kHz
    codec = omt_config.build_encodec(mc, torch.Generator().manual_seed(4))
    codec_cpu = omt_config.build_encodec(mc, torch.Generator().manual_seed(4), device="cpu")
    wav24 = check_prepared(torch, prime, PRIME_HZ, codec.sample_rate, False, dev, "Encodec")
    with torch.no_grad():
        z_cpu = codec_cpu.embed(wav24)
        z_gpu = codec.embed(wav24.to(dev))
        codes_cpu = codec_cpu.quantize_embedding(z_cpu)[0]
        codes_gpu = codec.quantize_embedding(z_gpu)[0].cpu()
        z_cpu, z_gpu = z_cpu[0], z_gpu[0].cpu()
    err = (z_gpu - z_cpu).abs().max().item()
    tol = TOWER_REL * z_cpu.abs().max().item()
    print(f"Encodec encoder latent {tuple(z_cpu.shape)} float32, card vs CPU: max_abs_err {err:.3e} tol {tol:.3e} "
          f"(max |z| {z_cpu.abs().max().item():.3f})", flush=True)
    if not err <= tol:
        fail(f"Encodec latents differ: {err} > {tol}")
    checked, near = check_off_near_ties(torch, z_cpu, (z_gpu - z_cpu).abs().amax(dim=1), codec_cpu.codebooks,
                                        codes_gpu, codes_cpu, "Encodec codes")
    print(f"Encodec codes {tuple(codes_cpu.shape)} card vs CPU: {checked} positions decided and equal, {near} "
          f"near-tie positions (or after one); equal at {int((codes_gpu == codes_cpu).sum())} of "
          f"{codes_cpu.numel()}", flush=True)
    wav24_d = wav24.to(dev)
    ms = stream_ms(lambda: codec.encode(wav24_d), reps=5)
    enc_flops, params = tower_cost(torch, codec.encoder, lambda: codec.embed(wav24_d))
    enc_flops += 2 * codes_cpu.numel() * codec.codebooks.shape[1] * codec.codebooks.shape[2]
    b_ms, b_by = bound_ms(params + codec.codebooks.numel() * 4 + wav24.numel() * 4, enc_flops, "float32")
    print(f"Encodec encode b1 x {PRIME_SECONDS} s ({len(codes_cpu)} LSTM steps a layer, in sequence): {ms:.3f} ms, "
          f"bound {b_ms:.3f} ms ({b_by}; {enc_flops / 1e9:.1f} GFLOP) [{card}]", flush=True)
    del codec_cpu

    # c. HTSAT-tiny + the audio projection, b8 x 10 s at 48 kHz
    clap_gpu = omt_config.build_clap(mc, torch.Generator().manual_seed(31))
    clap_cpu = omt_config.build_clap(mc, torch.Generator().manual_seed(31), device="cpu")
    clips = torch.cat([seeded_prime(100 + i, 10, clap_cpu.sample_rate) for i in range(8)])
    emb_cpu = clap_cpu.audio_embedding(clips)
    emb_gpu = clap_gpu.audio_embedding(clips.to(dev))
    if emb_gpu.device.type != "cuda" or emb_gpu.shape != (8, 512) or not torch.isfinite(emb_gpu).all():
        fail(f"audio embedding: {emb_gpu.device} {tuple(emb_gpu.shape)}, want cuda (8, 512), finite")
    err = (emb_gpu.cpu() - emb_cpu).abs().max().item()
    print(f"HTSAT-tiny audio embedding b8 x 10 s float32, card vs CPU: max_abs_err {err:.3e} tol {TOWER_ABS:.0e}",
          flush=True)
    if not err <= TOWER_ABS:
        fail(f"audio embeddings differ: {err} > {TOWER_ABS}")
    del clap_cpu
    clips_d = clips.to(dev)
    ms = stream_ms(lambda: clap_gpu.audio_embedding(clips_d), reps=5)
    model = clap_gpu.model
    flops, params = tower_cost(torch, model, lambda: model.get_audio_embedding(clips_d))
    cfg = model.audio_branch.cfg
    frames = 1 + clips.shape[1] // cfg.hop_size
    flops += 8 * frames * (2.5 * cfg.window_size_fft * math.log2(cfg.window_size_fft)  # rfft
                           + 2 * (cfg.window_size_fft // 2 + 1) * cfg.mel_bins)  # mel filterbank
    b_ms, b_by = bound_ms(params + clips.numel() * 4, flops, "float32")
    print(f"HTSAT-tiny + projection b8 x 10 s (audio_embedding): {ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}; "
          f"{flops / 8e9:.1f} GFLOP a clip, {flops / 1e9 / ms:.2f} TFLOP/s) [{card}]", flush=True)

    # d. continuation, "fused" b1: a 10 s prime at 48 kHz, 12 s out
    stages = {
        f"{name}_stage": omt_config.init_stage(
            mc, name, seed, device=dev, dtype=torch.bfloat16, quantized=True, flash_kv="int8")
        for name, seed in (("semantic", 1), ("coarse", 2), ("fine", 3))
    }
    gen = torch.Generator(device=dev).manual_seed(7)
    clap1 = torch.randint(0, mc.clap_rvq_cfg.codebook_size, (1, mc.clap_rvq_cfg.rq_num_quantizers, 1),
                          generator=gen, device=dev)
    hop, ac_hz = codec.hop_length, mc.encodec_cfg.output_hz
    prime_frames = PRIME_SECONDS * ac_hz
    # 12 s: semantic 750 tokens, 150 trimmed; 5 coarse windows, 900 frames,
    # 150 trimmed; 5 batched fine windows of 150; the prime's 750 frames first.
    # Both run in "fused" (the continuation's prompt set-up and trims are the
    # mode's business of no stage, and phases 4, 5 and 11 run "int8"), to
    # keep the phase short
    fused_path = {"prefill_attention", "int8_matmul", "fused_layer_decode_step"}
    runs = ((False, "fused", (1, (prime_frames + 750) * hop), fused_path),
            (True, "fused", (1, 900 * hop), fused_path))
    phase_launches = {}
    for coarse_only, mode, want_shape, path in runs:
        m = MusicLM(codec=codec, wav2vec=w2v_gpu, **{k: Stage(st.model, name=st.name, quantized=True, flash_kv=mode)
                                                     for k, st in stages.items()})
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wave = m.generate(clap_token_ids=clap1, generator=gen, prime_wave=prime_gpu,
                          prime_wave_sample_hz=PRIME_HZ, output_seconds=12.0,
                          return_coarse_generated_wave=coarse_only, **windows)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}
        tag = "return_coarse_generated_wave" if coarse_only else "the wave"
        print(f"MusicLM.generate(prime_wave=10 s at 48 kHz, output_seconds=12) flash_kv={mode} b1, {tag}: "
              f"wave {tuple(wave.shape)} {wall:.2f} s wall (HuBERT and the encoder included) [{card}]", flush=True)
        if tuple(wave.shape) != want_shape or not torch.isfinite(wave.float()).all():
            fail(f"continuation ({tag}): waveform {tuple(wave.shape)} (want {want_shape}) or non-finite samples")
        expect(f"continuation ({tag}), flash_kv={mode}", launches, path)
        phase_launches["continuation" + (" (coarse only)" if coarse_only else "")] = launches
    del m, w2v_gpu

    # e. reranking, "fused": 2 demo-vocabulary prompts x 4 samples, 4 s
    with tempfile.TemporaryDirectory() as tmp:
        write_demo_vocab(Path(tmp))
        tok = load_tokenizer(tmp)
    fused = {key: Stage(st.model, name=st.name, quantized=True, flash_kv="fused") for key, st in stages.items()}
    ranker = MusicLM(codec=codec, clap=clap_gpu, tokenizer=tok, **fused)
    tower_s = [0.0]
    audio_embedding = clap_gpu.audio_embedding

    def timed_embedding(wav):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = audio_embedding(wav)
        torch.cuda.synchronize()
        tower_s[0] += time.perf_counter() - t0
        return out

    clap_gpu.audio_embedding = timed_embedding
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    samples, sims = ranker.generate_top_match(text=list(PROMPTS[:2]), num_samples=4, generator=gen,
                                              output_seconds=4.0, **windows)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del clap_gpu.audio_embedding
    launches = {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}
    print(f"generate_top_match(2 prompts x 4 samples, 4 s) flash_kv=fused: sims "
          f"{[round(float(x), 5) for sim in sims for x in sim]}, {wall:.2f} s wall, HTSAT (2 calls at b4) "
          f"{tower_s[0]:.3f} s = {100 * tower_s[0] / wall:.1f} % of it [{card}]", flush=True)
    for sample, sim in zip(samples, sims):
        if tuple(sample.shape) != (1, 96000) or tuple(sim.shape) != (1,) or not torch.isfinite(sample.float()).all():
            fail(f"reranking: sample {tuple(sample.shape)} (want (1, 96000)), sims {tuple(sim.shape)}")
        if not (sim.abs() <= 1.0 + 1e-6).all():
            fail(f"reranking: similarity {sim.tolist()} outside [-1, 1]")
    expect("reranking, flash_kv=fused", launches, {"prefill_attention", "int8_matmul", "fused_layer_decode_step"})
    phase_launches["reranking"] = launches
    print(f"phase 7: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return phase_launches


def reference_stage_state_dict(model) -> dict:
    """A port stage's weights in the reference TokenConditionedTransformer
    layout (``embeddings.{i}``, ``logit_weights.{i}``,
    ``transformer.layers.{l}.0`` / ``.2``, ``rel_pos_bias.net.{j}``, the
    conv-FF's ``ds_conv`` [C, 1, 3]): what import_torch reads back."""
    sd, out = model.state_dict(), {}
    for i in range(len(model.specs)):
        out[f"start_tokens.{i}"] = sd["start_tokens"][i]
        out[f"embeddings.{i}.weight"] = sd[f"embeds.{i}.weight"]
        out[f"logit_weights.{i}"] = sd[f"logit_heads.{i}"]
    rp = "transformer.rel_pos_bias."
    n_mid = sum(1 for k in sd if k.startswith(rp + "mid_layers.") and k.endswith(".weight"))
    names = [("in_layer", "net.0.0")] + [(f"mid_layers.{j}", f"net.{j + 1}.0") for j in range(n_mid)]
    for port, ref in names + [("out_layer", f"net.{n_mid + 1}")]:
        for w in ("weight", "bias"):
            out[f"{rp}{ref}.{w}"] = sd[f"{rp}{port}.{w}"]
    for l in range(model.depth):
        a, f, ra, rf = f"transformer.attns.{l}.", f"transformer.ffs.{l}.", f"transformer.layers.{l}.0.", \
            f"transformer.layers.{l}.2."
        for name in ("norm.gamma", "to_q.weight", "to_kv.weight", "q_scale", "k_scale"):
            out[ra + name] = sd[a + name]
        out[ra + "to_out.0.weight"] = sd[a + "to_out.weight"]
        out[rf + "0.gamma"], out[rf + "1.weight"] = sd[f + "norm_in.gamma"], sd[f + "proj_in.weight"]
        out[rf + "2.ds_conv.weight"] = sd[f + "conv_w"].t()[:, None, :].contiguous()
        out[rf + "4.gamma"], out[rf + "6.weight"] = sd[f + "norm_mid.gamma"], sd[f + "proj_out.weight"]
    out["transformer.norm.gamma"] = sd["transformer.final_norm.gamma"]
    return {k: v.detach().cpu() for k, v in out.items()}


def large_phase(torch, omt_config, dev, card, counters, expect, windows, time_ms):
    """Phase 8: musiclm_large_small_context (24 layers x 16 heads x dim 1024)
    through load.create_musiclm_from_config at full width in float32: a
    reference-layout .pt of its semantic stage read back equal; 24
    teacher-forced decode steps of each stage in the fp decode, "int8" and
    "fused" against the CPU; generate(text) in "fused" at b1 x 4 s; musiclm_large
    itself at its own 30 s / 10 s / 3 s windows (``large_windows_generate``);
    the fusion CLAP of musiclm_large at b4 x 30 s against the CPU; the infer
    CLI at musiclm_small. Returns the launches of the b1 x 4 s generate call."""
    from open_musiclm_torch import load
    from open_musiclm_torch.models import token_cond
    from open_musiclm_torch.models.musiclm import MusicLM
    from open_musiclm_torch.models.quant_decode import generate_quantized, quantize_stage_params
    from open_musiclm_torch.models.stages import Stage

    t_phase = time.perf_counter()
    mc = omt_config.load_model_config(str(ROOT / "configs" / "model" / "musiclm_large_small_context.json"))
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_demo_vocab(tmp)
        # (a) the whole model from the config, seeded
        t0 = time.perf_counter()
        musiclm = load.create_musiclm_from_config(mc, tokenizer_path=str(tmp), seed=8, device=dev)
        torch.cuda.synchronize()
        stages = {name: getattr(musiclm, f"{name}_stage") for name in ("semantic", "coarse", "fine")}
        n_stage = [sum(p.numel() for p in st.model.parameters()) for st in stages.values()]
        print(f"phase 8: musiclm_large_small_context built in {time.perf_counter() - t0:.1f} s: stages "
              f"{[st.model.depth for st in stages.values()]} layers x {mc.semantic_cfg.heads} heads x dim "
              f"{mc.semantic_cfg.dim}, {[round(n / 1e6, 1) for n in n_stage]} M parameters "
              f"({4 * sum(n_stage) / 1e9:.2f} GB float32), peak mem "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]", flush=True)
        sem = stages["semantic"].model
        ref_path = tmp / "semantic_reference.pt"
        torch.save(reference_stage_state_dict(sem), ref_path)
        back, own = load.load_stage_params(str(ref_path), sem), sem.state_dict()
        if sorted(back) != sorted(own) or not all(torch.equal(back[k], own[k].cpu()) for k in own):
            fail("phase 8: the semantic stage read back from its reference-layout .pt differs")
        first = [k for k in own if k.startswith(("transformer.attns.0.", "transformer.ffs.0."))]
        print(f"  reference-layout .pt ({ref_path.stat().st_size / 1e9:.2f} GB) read back through "
              f"load.load_stage_params: the first block's {len(first)} tensors and all {len(own)} equal")
        del back, own
        ref_path.unlink()

        # (b) teacher-forced logits of each 24-layer stage, card vs CPU
        g = torch.Generator().manual_seed(81)
        for name, st in stages.items():
            model, specs = st.model, st.model.specs
            cpu_model = copy.deepcopy(model).cpu()
            qp_cpu = quantize_stage_params(cpu_model, fused=True)
            qp_gpu = to_device(qp_cpu, dev)
            prefix = {"semantic": (12,), "coarse": (12, 20), "fine": (12, 30)}[name]
            cond = [torch.randint(0, spec.codebook_size, (2, n), generator=g) for spec, n in zip(specs, prefix)]
            q_last = specs[-1].num_quantizers
            T = -(-LARGE_TF_STEPS // q_last)
            teacher = torch.randint(0, specs[-1].codebook_size, (2, T, q_last), generator=g)
            for mode, rel, path in (("fp", 1e-4, {"prefill_attention"}),
                                    ("int8", 1e-2, {"prefill_attention", "flash_decode_step", "fused_ff_apply",
                                                    "int8_matmul"}),
                                    ("fused", 1e-2, {"prefill_attention", "int8_matmul",
                                                     "fused_layer_decode_step"})):
                kw = dict(max_time_steps=T, temperature=0.0, teacher_ids=teacher, return_logits=True)
                gpu_cond = [c.to(dev) for c in cond]
                for fn, attr in counters.values():
                    setattr(fn, attr, 0)
                if mode == "fp":
                    _, got = token_cond.generate(model, gpu_cond, **kw)
                    launches = {n: getattr(fn, attr) for n, (fn, attr) in counters.items()}
                    _, want = token_cond.generate(cpu_model, cond, **kw)
                else:
                    kw.update(flash_kv=mode, fused_ff=True)
                    _, got = generate_quantized(model, qp_gpu, gpu_cond, **kw)
                    launches = {n: getattr(fn, attr) for n, (fn, attr) in counters.items()}
                    _, want = generate_quantized(cpu_model, qp_cpu, cond, **kw)
                got, want = got.cpu()[..., :-1], want[..., :-1]  # the EOS column is -1e9 on both
                err = (got - want).abs().max().item()
                tol = rel * max(1.0, want.abs().max().item())
                print(f"  {name} stage ({model.depth} x {model.heads} heads) f32 b2, {T * q_last} teacher-forced "
                      f"steps, {mode}: CUDA vs CPU plain logits max_abs_err {err:.3e} tol {tol:.3e}", flush=True)
                if not err <= tol:
                    fail(f"phase 8: {name} {mode} logits differ: {err} > {tol}")
                expect(f"phase 8 {name} {mode}", launches, path)
            del cpu_model, qp_cpu, qp_gpu

        # (c) text to waveform in "fused" at b1 x 4 s
        fused = MusicLM(codec=musiclm.codec, clap=musiclm.clap, tokenizer=musiclm.tokenizer,
                        wav2vec=musiclm.wav2vec,
                        **{f"{n}_stage": Stage(st.model, name=n, quantized=True, flash_kv="fused")
                           for n, st in stages.items()})
        gen = torch.Generator(device=dev).manual_seed(8)
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wave = fused.generate(text=[PROMPTS[0]], generator=gen, output_seconds=4.0, **windows)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: getattr(fn, attr) for n, (fn, attr) in counters.items()}
        print(f"  MusicLM.generate(text=1 prompt) fused, musiclm_large_small_context float32, batch 1 x 4 s: "
              f"wave {tuple(wave.shape)} {wall:.2f} s wall [{card}]", flush=True)
        if tuple(wave.shape) != (1, 96000) or not torch.isfinite(wave.float()).all():
            fail(f"phase 8: fused generate gave {tuple(wave.shape)} or non-finite samples")
        expect("phase 8 generate fused", launches, {"prefill_attention", "int8_matmul", "fused_layer_decode_step"})
        depth = stages["semantic"].model.depth
        if launches["fused_layer_decode_step"] != depth * launches["int8_matmul"]:
            fail(f"phase 8: kernel 7 launched {launches['fused_layer_decode_step']} times, "
                 f"want {depth} x {launches['int8_matmul']}")
        del fused, musiclm, stages, sem, wave
        torch.cuda.empty_cache()

        # (c2) musiclm_large itself at its own windows, 8 of its 24 layers
        large_windows_generate(torch, omt_config, dev, card, counters, expect, tmp)

        # (d) musiclm_large's fusion CLAP: the fusion HTSAT + projection at b4 x 30 s
        mc_large = omt_config.load_model_config(str(ROOT / "configs" / "model" / "musiclm_large.json"))
        clap = omt_config.build_clap(mc_large, torch.Generator().manual_seed(9), device="cpu")
        gpu_model = copy.deepcopy(clap.model).to(dev)
        seconds = mc_large.global_cfg.clap_audio_length_seconds
        wav = torch.cat([seeded_prime(90 + i, seconds, clap.sample_rate) for i in range(4)])
        with torch.no_grad():
            want = clap.model.get_audio_embedding(wav)
            wav_gpu = wav.to(dev)
            got = gpu_model.get_audio_embedding(wav_gpu).cpu()
            ms = time_ms(lambda: gpu_model.get_audio_embedding(wav_gpu), reps=5)
        err = (got - want).abs().max().item()
        print(f"  fusion CLAP (musiclm_large: HTSAT-tiny, AFF, mel_conv2d) + projection, b4 x {seconds:.0f} s "
              f"at {clap.sample_rate} Hz (longer: all): card vs CPU f32 embeddings max_abs_err {err:.3e} tol "
              f"{TOWER_ABS:.1e}; {ms:.3f} ms a call on the card [{card}]", flush=True)
        if not (err <= TOWER_ABS and torch.isfinite(got).all()):
            fail(f"phase 8: fusion CLAP embeddings differ: {err}")
        del clap, gpu_model, wav_gpu
        torch.cuda.empty_cache()

        # (e) the infer CLI, musiclm_small in "int8"
        out_dir = tmp / "cli"
        cmd = [sys.executable, "-m", f"{PACKAGE}.cli.infer", PROMPTS[1], "--model_config",
               str(ROOT / "configs" / "model" / "musiclm_small.json"), "--int8", "--flash_kv", "int8",
               "--duration", "4", "--tokenizer_path", str(tmp), "--results_folder", str(out_dir)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            fail(f"phase 8: the infer CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
        wavs = list(out_dir.glob("*_generated.wav"))
        import wave as wave_mod

        if len(wavs) != 1:
            fail(f"phase 8: the infer CLI wrote {len(wavs)} wavs")
        with wave_mod.open(str(wavs[0]), "rb") as w:
            frames, rate = w.getnframes(), w.getframerate()
        print(f"  python -m {PACKAGE}.cli.infer --int8 --flash_kv int8 --duration 4 (musiclm_small): "
              f"{time.perf_counter() - t0:.1f} s, wrote {wavs[0].name} ({frames} frames at {rate} Hz) "
              f"[{card}]", flush=True)
        if (frames, rate) != (96000, 24000):
            fail(f"phase 8: the CLI's wav has {frames} frames at {rate} Hz")
    print(f"phase 8: {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    return launches


def expected_decode_steps(seconds, windows, quantizers, semantic_hz, acoustic_hz, batch):
    """Decode steps a stage of MusicLM.generate runs for ``seconds`` without
    a prime, at its default sliding steps (semantic and coarse windows half
    overlapped, fine windows side by side and batched up to max_fine_rows()
    rows): a call decodes (its window - its carried prefix) x the stage's
    quantizers. ``quantizers`` maps each stage to its count."""
    from open_musiclm_torch.models.musiclm import max_fine_rows

    sem_window = windows["semantic_window_seconds"] * semantic_hz
    sem_total = int(min(seconds, windows["semantic_window_seconds"]) * semantic_hz)
    sem = sem_total
    while sem_total < int(seconds * semantic_hz):  # continuations carry half a window
        sem += sem_window - sem_window // 2
        sem_total += sem_window - sem_window // 2
    window = windows["coarse_window_seconds"] * semantic_hz - 1
    n_coarse = (sem_total - window) // (window // 2) + 1
    coarse_t = windows["coarse_window_seconds"] * acoustic_hz
    coarse_len = coarse_t + (n_coarse - 1) * (coarse_t - coarse_t // 2)
    fine_t = windows["fine_window_seconds"] * acoustic_hz
    n_fine = (coarse_len - fine_t) // fine_t + 1
    fine_calls = math.ceil(n_fine / max(1, max_fine_rows() // batch))
    return {"semantic": sem * quantizers["semantic"], "coarse": coarse_len * quantizers["coarse"],
            "fine": fine_calls * fine_t * quantizers["fine"]}


def large_windows_generate(torch, omt_config, dev, card, counters, expect, tokenizer_dir: Path,
                           model_config: Path = None, seconds: float = 10.0):
    """Phase 8 (c2): musiclm_large (configs/model/musiclm_large.json: 16
    heads x dim 1024, its stages cut to LARGE_CUT_DEPTH of their 24 layers
    for the script's time, the fusion CLAP, 30 s semantic, 10 s coarse and
    3 s fine windows) through load.create_musiclm_from_config in float32, then
    generate(text=1 prompt) in "fused" at b1 x ``seconds`` (one whole coarse
    window: 2,250 coarse decode steps over the coarse cache): the wave's
    shape (the fine windows that fit) and finiteness, exactly kernels 1, 4
    and 7, kernel 7 once a layer and decode step; its wall, each stage's ms a
    decode step and the peak memory. ``model_config`` and ``dev`` let a
    rehearsal run it on the CPU at small widths. Returns the launches."""
    from open_musiclm_torch import load
    from open_musiclm_torch.models.musiclm import MusicLM
    from open_musiclm_torch.models.stages import Stage

    on_card = dev.type == "cuda"
    mc = cut_depth(omt_config.load_model_config(str(model_config or ROOT / "configs" / "model" /
                                                    "musiclm_large.json")))
    g = mc.global_cfg
    windows = dict(semantic_window_seconds=int(g.semantic_audio_length_seconds),
                   coarse_window_seconds=int(g.coarse_audio_length_seconds),
                   fine_window_seconds=int(g.fine_audio_length_seconds))
    t0 = time.perf_counter()
    musiclm = load.create_musiclm_from_config(mc, tokenizer_path=str(tokenizer_dir), seed=18, device=dev)
    build_s = time.perf_counter() - t0
    stages = {n: Stage(getattr(musiclm, f"{n}_stage").model, name=n, quantized=True, flash_kv="fused")
              for n in ("semantic", "coarse", "fine")}
    depth = stages["semantic"].model.depth
    walls = {}
    steps = {}

    def timed(name, st):
        inner = st.generate

        def run(*args, **kw):
            if on_card:
                torch.cuda.synchronize()
            before, t = counters["int8_matmul"][0].launches, time.perf_counter()
            out = inner(*args, **kw)
            if on_card:
                torch.cuda.synchronize()
            walls[name] = walls.get(name, 0.0) + time.perf_counter() - t
            steps[name] = steps.get(name, 0) + counters["int8_matmul"][0].launches - before
            return out

        st.generate = run
        return st

    fused = MusicLM(codec=musiclm.codec, clap=musiclm.clap, tokenizer=musiclm.tokenizer, wav2vec=musiclm.wav2vec,
                    **{f"{n}_stage": timed(n, st) for n, st in stages.items()})
    gen = torch.Generator(device=dev).manual_seed(18)
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    wave = fused.generate(text=[PROMPTS[0]], generator=gen, output_seconds=seconds, **windows)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else float("nan")
    launches = {n: getattr(fn, attr) for n, (fn, attr) in counters.items()}
    ac_hz, hop = mc.encodec_cfg.output_hz, musiclm.codec.sample_rate // mc.encodec_cfg.output_hz
    fine_window = windows["fine_window_seconds"] * ac_hz
    frames = ((int(seconds * ac_hz) - fine_window) // fine_window + 1) * fine_window
    per_step = {n: f"{1e3 * walls[n] / max(steps[n], 1):.3f} ms x {steps[n]} steps" for n in walls}
    print(f"  (c2) musiclm_large ({depth} of its 24 layers) generate(text=1 prompt) fused at its own windows "
          f"{windows}, float32, b1 x {seconds:.0f} s: built in {build_s:.1f} s; wave {tuple(wave.shape)} in {wall:.2f} s wall; a decode "
          f"step {per_step}; peak memory {peak:.2f} GiB [{card}]", flush=True)
    if tuple(wave.shape) != (1, frames * hop) or not torch.isfinite(wave.float()).all():
        fail(f"phase 8 (c2): musiclm_large generate gave {tuple(wave.shape)} (want (1, {frames * hop})) "
             "or non-finite samples")
    expect("phase 8 musiclm_large generate fused", launches,
           {"prefill_attention", "int8_matmul", "fused_layer_decode_step"})
    rates = inspect.signature(MusicLM.generate).parameters  # generate's own token rates
    want = expected_decode_steps(seconds, windows, {n: st.model.specs[-1].num_quantizers for n, st in stages.items()},
                                 rates["semantic_steps_per_second"].default,
                                 rates["acoustic_steps_per_second"].default, batch=1)
    want_k7 = sum(stages[n].model.depth * k for n, k in want.items())
    if on_card and (steps != want or launches["int8_matmul"] != sum(want.values())
                    or launches["fused_layer_decode_step"] != want_k7):
        fail(f"phase 8 (c2): decode steps {steps} (kernel 4 {launches['int8_matmul']}), kernel 7 "
             f"{launches['fused_layer_decode_step']}; the windows give {want} steps, kernel 7 {want_k7}")
    print(f"    launches: {launches}; the windows give {want} decode steps, kernel 7 {want_k7} = {depth} x "
          f"{sum(want.values())}", flush=True)
    del fused, musiclm, stages, wave
    if on_card:
        torch.cuda.empty_cache()
    return launches


# phase 9: seeded tracks (seconds, rate): 44.1 and 48 kHz, 12-35 s, the
# first longer than the preprocessor's 30 s crop, the last shorter than the
# 10 s window
RAW_TRACKS = ((31.5, 44100), (12.0, 48000), (18.3, 44100), (35.0, 48000), (22.7, 44100), (14.2, 48000),
              (27.9, 44100), (16.6, 48000), (7.0, 44100))
# how many of track 0's CLAP windows (of 21) phase 9 recomputes on the CPU
CHECKED_CLAP_WINDOWS = 4


def write_raw_tracks(folder: Path) -> None:
    """RAW_TRACKS as PCM16 wavs ``track_{i:02d}.wav``: sines plus noise from seed i."""
    from open_musiclm_torch.data.audio_io import write_wav

    folder.mkdir(parents=True, exist_ok=True)
    for i, (seconds, hz) in enumerate(RAW_TRACKS):
        write_wav(str(folder / f"track_{i:02d}.wav"), seeded_prime(200 + i, seconds, hz)[0].numpy(), hz)


class Patched:
    """Attribute replacements (object, name, value) undone on exit."""

    def __init__(self, *patches):
        self.patches, self.saved = patches, []

    def __enter__(self):
        for obj, name, value in self.patches:
            self.saved.append((obj, name, getattr(obj, name)))
            setattr(obj, name, value)
        return self

    def __exit__(self, *exc):
        for obj, name, value in reversed(self.saved):
            setattr(obj, name, value)


def tower_tokens_check(torch, cpu, gpu, clap_wave, sem_wave, ac_wave, got, what: str, dev):
    """Token ids the card gave (``got``: CLAP [W, Q], semantic [B, T'],
    codes [B, T', q]) against the CPU towers' on the same float32 waves,
    off near ties (check_off_near_ties; the card's own embeddings give each
    row's error). ``cpu`` / ``gpu``: (ClapQuantized, HubertWithKmeans,
    EncodecModel). Returns {tower: (checked, near ties)}."""
    (clap_c, w2v_c, codec_c), (clap_g, w2v_g, codec_g) = cpu, gpu
    out = {}
    with torch.no_grad():
        x_c = clap_c.audio_embedding(clap_wave)
        x_g = clap_g.audio_embedding(clap_wave.to(dev)).cpu()
        out["clap"] = check_off_near_ties(torch, x_c, (x_g - x_c).abs().amax(1), clap_c.rvq.codebooks,
                                          got[0].cpu(), clap_c.quantize(x_c)[..., 0], f"{what} CLAP tokens")
        f_c = w2v_c.features(sem_wave).reshape(-1, w2v_c.centroids.shape[1])
        f_g = w2v_g.features(sem_wave.to(dev)).reshape(-1, w2v_c.centroids.shape[1]).cpu()
        out["semantic"] = check_off_near_ties(torch, f_c, (f_g - f_c).abs().amax(1), w2v_c.centroids[None],
                                              got[1].cpu().reshape(-1, 1), w2v_c(sem_wave).reshape(-1, 1),
                                              f"{what} semantic ids")
        z_c = codec_c.embed(ac_wave)
        z_g = codec_g.embed(ac_wave.to(dev)).cpu()
        q = got[2].shape[-1]
        flat = lambda t: t.reshape(-1, t.shape[-1])  # noqa: E731
        out["codes"] = check_off_near_ties(torch, flat(z_c), flat(z_g - z_c).abs().amax(1), codec_c.codebooks[:q],
                                           flat(got[2].cpu()), flat(codec_c.quantize_embedding(z_c))[:, :q],
                                           f"{what} Encodec codes")
    return out


def raw_audio_phase(torch, omt_config, dev, card, counters, model_config: Path = None):
    """Phase 9: stage training from raw audio through the five training
    CLIs, in process, at musiclm_small's full width with random weights from
    a seed, on seeded tracks (RAW_TRACKS). The CLIs share one tower build
    per flag set (the same seed and flags build the same towers; each build
    is seconds of seeded CPU draws). ``model_config`` (musiclm_small's by
    default) and ``dev`` let a rehearsal run it on the CPU at small widths.
    Returns the launches of the coarse run."""
    import argparse
    import wave as wave_mod

    from open_musiclm_torch import load
    from open_musiclm_torch.cli import (common, preprocess_data, train_clap_rvq, train_hubert_kmeans,
                                        train_stage)
    from open_musiclm_torch.data import dataset, pipeline
    from open_musiclm_torch.data.preprocess import DataPreprocessor
    from open_musiclm_torch.data.tokenstore import ShardedTokenStore
    from open_musiclm_torch.models.clap.clap import ClapQuantized
    from open_musiclm_torch.train import tokenizer_trainers
    from open_musiclm_torch.train.trainer import StageTrainer
    from torch.profiler import ProfilerActivity, profile
    import numpy as np

    t_phase = time.perf_counter()
    small = model_config or ROOT / "configs" / "model" / "musiclm_small.json"
    mc = omt_config.load_model_config(str(small))
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    g = mc.global_cfg
    builds, build_s = {}, []
    build_musiclm = common.build_musiclm

    def shared_build(args):
        key = (args.model_config, args.seed, args.bf16, args.device)
        if key not in builds:
            t0 = time.perf_counter()
            builds[key] = build_musiclm(args)
            build_s.append(time.perf_counter() - t0)
        return builds[key]

    def reset():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    def read():
        return {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}

    def log_of(folder: Path, stage: str):
        return [json.loads(line) for line in (folder / f"{stage}.log.jsonl").read_text().splitlines()]

    def wav_shape(path: Path):
        with wave_mod.open(str(path), "rb") as w:
            return w.getnframes(), w.getframerate()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_audio_") as tmp, Patched(
            *((mod, "build_musiclm", shared_build) for mod in (common, preprocess_data, train_clap_rvq,
                                                                train_hubert_kmeans))):
        tmp = Path(tmp)
        tracks, store = tmp / "tracks", tmp / "store"
        write_raw_tracks(tracks)
        tc = json.loads((ROOT / "configs" / "training" / "train_musiclm_fma.json").read_text())
        for stage in ("semantic", "coarse", "fine"):
            tc[f"{stage}_trainer_cfg"].update(folder=str(tracks), num_train_steps=1)
        tc["coarse_trainer_cfg"].update(num_train_steps=3, save_results_every=2, save_model_every=2)
        tc["data_preprocessor_cfg"] = dict(folder=str(tracks), results_folder=str(store))
        # 1,024 embeddings a step (the shipped accumulate 32 halved): the
        # codebook's size, the least the RVQ's k-means init takes
        tc["clap_rvq_trainer_cfg"].update(folder=str(tracks), num_train_steps=2, accumulate_batches=16)
        tc["hubert_kmeans_trainer_cfg"].update(folder=str(tracks), feature_extraction_num_steps=4)

        def config(name, **stage_cfgs):
            cfg = copy.deepcopy(tc)
            for key, over in stage_cfgs.items():
                cfg[key].update(over)
            path = tmp / f"{name}.json"
            path.write_text(json.dumps(cfg))
            return ["--model_config", str(small), "--training_config", str(path), "--device", str(dev)]

        ctc = tc["coarse_trainer_cfg"]
        print(f"phase 9: {len(RAW_TRACKS)} seeded tracks ({sum(s for s, _ in RAW_TRACKS):.0f} s at 44.1 and "
              f"48 kHz); coarse trainer config b{ctc['batch_size']} x accum {ctc['grad_accum_every']}", flush=True)

        # (a) train_stage --stage coarse --bf16 on the fly: 3 steps, results and checkpoints every 2
        res = tmp / "coarse"
        reset()
        t0 = time.perf_counter()
        train_stage.main(["--stage", "coarse", "--bf16", "--results_folder", str(res)] + config("coarse"))
        sync()
        wall = time.perf_counter() - t0
        launches = read()
        recs = log_of(res, "coarse")
        losses = [r["train_loss"] for r in recs if "train_loss" in r]
        valid = [(r["step"], r["valid_loss"], r["valid_accuracy"]) for r in recs if "valid_loss" in r]
        print(f"  (a) train_stage coarse --bf16, 3 on-the-fly steps: {wall:.1f} s (tower build "
              f"{build_s[-1]:.1f} s), losses {losses}, valid (step, loss, accuracy) {valid} [{card}]", flush=True)
        if len(losses) != 3 or not all(math.isfinite(x) for x in losses):
            fail(f"phase 9 coarse: train losses {losses}")
        if [v[0] for v in valid] != [0, 2] or not all(math.isfinite(v[1]) and 0 <= v[2] <= 1 for v in valid):
            fail(f"phase 9 coarse: valid metrics {valid}")
        want = {"coarse.log.jsonl", "coarse.transformer.2.ckpt", "coarse.tokens.0.txt", "coarse.tokens.2.txt"}
        want |= {f"coarse.recon.{s}.{i}.wav" for s in (0, 2) for i in (0, 1)}
        got_files = {p.name for p in res.iterdir() if p.is_file()}
        if not want <= got_files:
            fail(f"phase 9 coarse: missing {sorted(want - got_files)}")
        shapes = {wav_shape(res / f"coarse.recon.{s}.{i}.wav") for s in (0, 2) for i in (0, 1)}
        print(f"    files {sorted(got_files)}; reconstructions (frames, rate) {shapes}")
        if shapes != {(96000, 24000)}:
            fail(f"phase 9 coarse: reconstructions {shapes}, want 4 s at 24 kHz")
        per_step = 3 * ctc["grad_accum_every"] * mc.coarse_cfg.depth
        print(f"    launches: {launches}")
        if launches["attention_bwd"] != per_step or launches["attention_dbias"] != per_step \
                or launches["prefill_attention"] < per_step:
            fail(f"phase 9 coarse: kernels 1 / 5 / 6 launched {launches}, want 5 and 6 {per_step} times each")
        if any(n for name, n in launches.items()
               if name not in ("prefill_attention", "attention_bwd", "attention_dbias")):
            fail(f"phase 9 coarse: a serving kernel launched in training: {launches}")
        times = [r["time"] for r in recs if "train_loss" in r]
        step_wall = times[2] - times[1]
        train_s = [r["step_time_s"] for r in recs if "train_loss" in r][2]
        print(f"    on-the-fly step 2: {step_wall:.3f} s wall (log times), train step {train_s:.3f} s, "
              f"tokenizing (fetch) share {100 * (1 - train_s / step_wall):.1f} % [{card}]", flush=True)

        # resume: the checkpoint of step 2 holds the state after 3 steps, so one
        # more step, numbered 3; then one more on-the-fly step under the profiler
        prof_out = {}
        train = StageTrainer.train

        def train_then_profile(self, state, data_iter, **kw):
            state = train(self, state, data_iter, **kw)
            sync()
            with profile(activities=[ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * on_card) as prof:
                t0 = time.perf_counter()
                batch = next(data_iter)
                sync()
                t1 = time.perf_counter()
                self.train_step(state, batch, kw.get("generator"))
                sync()
                t2 = time.perf_counter()
            busy = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
            prof_out.update(wall=t2 - t0, fetch=t1 - t0, train=t2 - t1, busy=busy)
            return state

        with Patched((StageTrainer, "train", train_then_profile)):
            train_stage.main(["--stage", "coarse", "--bf16", "--results_folder", str(res),
                              "--continue_from_dir", str(res)] + config("coarse_resume", coarse_trainer_cfg=dict(
                                  num_train_steps=4)))
        steps = [r["step"] for r in log_of(res, "coarse") if "train_loss" in r]
        print(f"    resumed from coarse.transformer.2.ckpt with num_train_steps 4: logged steps {steps}")
        if steps != [0, 1, 2, 3]:
            fail(f"phase 9 coarse resume: logged steps {steps}, want [0, 1, 2, 3]")
        p = prof_out
        print(f"    profiled on-the-fly coarse step (b{ctc['batch_size']} x accum {ctc['grad_accum_every']}, "
              f"bf16): {p['wall']:.3f} s wall, tokenizing (fetch) {p['fetch']:.3f} s = "
              f"{100 * p['fetch'] / p['wall']:.1f} %, train step {p['train']:.3f} s; device busy "
              f"{p['busy']:.3f} s, idle share {100 * (1 - p['busy'] / p['wall']):.1f} % [{card}]", flush=True)

        # (a') one coarse micro-batch tokenized on the card in float32 against the CPU
        fp32 = ["--model_config", str(small), "--device", str(dev), "--seed", "0"]
        parser = argparse.ArgumentParser()
        common.add_model_args(parser)
        musiclm, _ = shared_build(parser.parse_args(fp32))
        gpu = (musiclm.clap, musiclm.wav2vec, musiclm.codec)
        cpu = (ClapQuantized(model=copy.deepcopy(musiclm.clap.model).cpu(),
                             rvq=type(musiclm.clap.rvq)(*(None if t is None else t.cpu()
                                                          for t in musiclm.clap.rvq)),
                             num_quantizers=musiclm.clap.num_quantizers,
                             codebook_size=musiclm.clap.codebook_size, sample_rate=musiclm.clap.sample_rate,
                             clip_samples=musiclm.clap.clip_samples),
               copy.deepcopy(musiclm.wav2vec).cpu(), copy.deepcopy(musiclm.codec).cpu())
        ds = dataset.SoundDataset(folder=str(tracks), **pipeline.stage_ds_config("coarse", *gpu, g))
        batch = tuple(np.stack(c) for c in zip(ds[0], ds[3]))
        toks = pipeline.tokenize_audio_batch("coarse", batch, *gpu)
        lens = omt_config.stage_example_lengths(mc, "coarse")
        if tuple(t.shape[1] for t in toks) != lens:
            fail(f"phase 9: coarse token lengths {[tuple(t.shape) for t in toks]}, want {lens}")
        q_c = g.num_coarse_quantizers
        b = torch.as_tensor(batch[0]), torch.as_tensor(batch[1]), torch.as_tensor(batch[2])
        out = tower_tokens_check(torch, cpu, gpu, b[0], b[1], b[2],
                                 (toks[0], toks[1], toks[2].reshape(2, -1, q_c)), "coarse micro-batch", dev)
        print(f"  coarse micro-batch (b2: CLAP 10 s, HuBERT 4 s, Encodec 4 s) tokenized on the card in float32 "
              f"vs the CPU: lengths {lens}; (decided and equal, near ties) {out}", flush=True)

        # (b) one on-the-fly step each of the semantic and fine stages, their shipped batch x accum
        for stage in ("semantic", "fine"):
            cfg = tc[f"{stage}_trainer_cfg"]
            res = tmp / stage
            reset()
            t0 = time.perf_counter()
            train_stage.main(["--stage", stage, "--bf16", "--results_folder", str(res)] + config(stage))
            sync()
            wall = time.perf_counter() - t0
            run = read()
            recs = log_of(res, stage)
            losses = [r["train_loss"] for r in recs if "train_loss" in r]
            n = cfg["grad_accum_every"] * getattr(mc, f"{stage}_cfg").depth
            print(f"  (b) train_stage {stage} --bf16, 1 on-the-fly step at b{cfg['batch_size']} x accum "
                  f"{cfg['grad_accum_every']}: {wall:.1f} s, loss {losses}, launches {run} [{card}]", flush=True)
            if len(losses) != 1 or not math.isfinite(losses[0]):
                fail(f"phase 9 {stage}: train losses {losses}")
            if run["attention_bwd"] != n or run["attention_dbias"] != n or run["prefill_attention"] < n:
                fail(f"phase 9 {stage}: kernels 1 / 5 / 6 launched {run}, want 5 and 6 {n} times each")

        # (c) preprocess_data over the folder (float32 towers), one track's
        # tokens against the CPU, then one fine step on the store
        t0 = time.perf_counter()
        rows = preprocess_data.main(["--seed", "0"] + config("preprocess"))
        pre_s = time.perf_counter() - t0
        reader = ShardedTokenStore(str(store))
        print(f"\n  (c) preprocess_data: {rows} rows in {pre_s:.1f} s, {pre_s / max(rows, 1):.2f} s a track "
              f"(a 30 s crop at most; towers float32) [{card}]", flush=True)
        if rows != len(RAW_TRACKS) or len(reader) != len(RAW_TRACKS):
            fail(f"phase 9 preprocess: {rows} rows written, {len(reader)} in the store, want {len(RAW_TRACKS)}")
        fields = ("clap", "semantic", "coarse", "fine")
        clap_ids, sem, coarse, fine = (torch.from_numpy(a.astype(np.int64)) for a in reader.get(0, fields))
        item = dataset.SoundDatasetForPreprocessing(
            folder=str(tracks), pad_to_seconds=int(g.semantic_audio_length_seconds), max_length_seconds=(30,) * 3,
            normalize=(False, True, False), target_sample_hz=(cpu[0].sample_rate, cpu[1].target_sample_hz,
                                                              cpu[2].sample_rate),
            seq_len_multiple_of=(None, cpu[1].seq_len_multiple_of, None))[0]
        wave_clap, wave_sem, wave_ac = (torch.from_numpy(v) for v in item["data"])
        sr, win = cpu[0].sample_rate, int(g.clap_audio_length_seconds) * cpu[0].sample_rate
        windows = torch.stack([wave_clap[j * sr: j * sr + win] for j in range(CHECKED_CLAP_WINDOWS)])
        codes = torch.cat([coarse, fine], dim=-1)
        print(f"    track 0 ({Path(item['file_path']).name}, {RAW_TRACKS[0][0]} s cropped to 30 s): stored clap "
              f"{tuple(clap_ids.shape)}, semantic {tuple(sem.shape)}, coarse {tuple(coarse.shape)}, fine "
              f"{tuple(fine.shape)}", flush=True)
        if clap_ids.shape[0] != 21 or sem.shape[1] != 30 * 50 - 1 or codes.shape[1] != 30 * 75:
            fail(f"phase 9 preprocess: track 0's token shapes {[tuple(t.shape) for t in (clap_ids, sem, codes)]}")
        out = tower_tokens_check(torch, cpu, gpu, windows, wave_sem[None], wave_ac[None],
                                 (clap_ids[:CHECKED_CLAP_WINDOWS], sem, codes), "stored track 0", dev)
        print(f"    stored tokens of track 0 vs the CPU (its first {CHECKED_CLAP_WINDOWS} CLAP windows, all its "
              f"semantic ids and codes): (decided and equal, near ties) {out}", flush=True)
        res = tmp / "fine_store"
        reset()
        train_stage.main(["--stage", "fine", "--bf16", "--results_folder", str(res)] + config(
            "fine_store", fine_trainer_cfg=dict(folder=str(store), use_preprocessed_data=True)))
        losses = [r["train_loss"] for r in log_of(res, "fine") if "train_loss" in r]
        print(f"    train_stage fine --bf16 on the store: 1 step, loss {losses}, launches {read()}", flush=True)
        if len(losses) != 1 or not math.isfinite(losses[0]) or not read()["attention_bwd"]:
            fail(f"phase 9 fine on the store: losses {losses}, launches {read()}")

        # (d) train_clap_rvq: 2 steps at the shipped batch x accumulate
        rvq_cfg = tc["clap_rvq_trainer_cfg"]
        step_s, mses = [], []
        learn = ClapQuantized.learn_rvq_step

        def timed_learn(self, embedding, *a, **kw):
            sync()
            t0 = time.perf_counter()
            new, mse = learn(self, embedding, *a, **kw)
            mses.append(mse.item())
            step_s.append(time.perf_counter() - t0)
            return new, mse

        res = tmp / "rvq"
        t0 = time.perf_counter()
        with Patched((ClapQuantized, "learn_rvq_step", timed_learn)):
            state = train_clap_rvq.main(["--seed", "0", "--results_folder", str(res)] + config("rvq"))
        wall = time.perf_counter() - t0
        ckpts = sorted(p.name for p in res.iterdir())
        back = load.load_rvq(str(res / "clap.rvq.1.ckpt"), mc, None, device=dev)
        same = all(torch.equal(a, b) for a, b in zip(back, state))
        print(f"\n  (d) train_clap_rvq: {rvq_cfg['num_train_steps']} steps of b{rvq_cfg['batch_size']} x accumulate "
              f"{rvq_cfg['accumulate_batches']} ({rvq_cfg['batch_size'] * rvq_cfg['accumulate_batches']} embeddings "
              f"a step) in {wall:.1f} s; the RVQ update (k-means init on step 0) {[round(s, 3) for s in step_s]} s; "
              f"rvq_mse {mses}; {ckpts}; load_rvq reads clap.rvq.1.ckpt back "
              f"{'equal' if same else 'DIFFERENT'} [{card}]", flush=True)
        if len(mses) != 2 or not all(math.isfinite(m) for m in mses) or not bool(state.initted):
            fail(f"phase 9 rvq: mse {mses}")
        if ckpts != ["clap.rvq.0.ckpt", "clap.rvq.1.ckpt"] or not same:
            fail(f"phase 9 rvq: checkpoints {ckpts}, read back equal {same}")

        # (e) train_hubert_kmeans: 4 feature steps, 1024 clusters
        fit_s = []
        fit = tokenizer_trainers.HubertKmeansTrainer.fit

        def timed_fit(self, *a, **kw):
            sync()
            t0 = time.perf_counter()
            out = fit(self, *a, **kw)
            sync()
            fit_s.append(time.perf_counter() - t0)
            return out

        res = tmp / "kmeans"
        t0 = time.perf_counter()
        with Patched((tokenizer_trainers.HubertKmeansTrainer, "fit", timed_fit)):
            cents = train_hubert_kmeans.main(["--seed", "0", "--results_folder", str(res)] + config("kmeans"))
        wall = time.perf_counter() - t0
        tree = torch.load(res / "kmeans.ckpt", map_location="cpu", weights_only=True)
        back = load.load_kmeans(str(res / "kmeans.ckpt"), mc, None)
        km = tc["hubert_kmeans_trainer_cfg"]
        print(f"  (e) train_hubert_kmeans: {km['feature_extraction_num_steps']} steps of "
              f"{km['feature_extraction_batch_size']} clips x 10 s, {tuple(cents.shape)} centroids in {wall:.1f} s, "
              f"the fit (k-means++ and minibatch Lloyd's) {fit_s[0]:.2f} s, inertia "
              f"{tree['inertia'].item():.4f}; load_kmeans reads it back "
              f"{'equal' if torch.equal(back, cents) else 'DIFFERENT'} [{card}]", flush=True)
        if tuple(cents.shape) != (mc.hubert_kmeans_cfg.codebook_size, 768) or not torch.equal(back, cents) \
                or not math.isfinite(tree["inertia"].item()):
            fail("phase 9 k-means: centroids, inertia or read-back")
    print(f"phase 9: {time.perf_counter() - t_phase:.1f} s (tower builds {[round(s, 1) for s in build_s]} s) "
          f"[{card}]", flush=True)
    return launches


# phase 10 (b): the data-parallel cases, musiclm_small's coarse stage at b4 x
# accum 2 in float32 (TF32 off) without dropout or the forgetful mask (each
# rank draws its own), Adam's eps raised to 1e-2 on both sides as the CPU
# tests do (an element whose gradient is rounding noise then moves by ~lr x
# 1e-5, not by +-lr), held to 1e-5 x max|p| a tensor after 3 steps
DP_STEPS, DP_BATCH, DP_ACCUM, DP_EPS, DP_TOL = 3, 4, 2, 1e-2, 1e-5


def dp_setup(torch, omt_config, dev, model_config: Path):
    """(model, trainer keyword arguments, global token batches) of the
    data-parallel cases: the same on every rank and in the one-process run."""
    from open_musiclm_torch.models.token_cond import StageLossConfig

    mc = omt_config.load_model_config(str(model_config))
    tcfg = omt_config.load_training_config(
        str(ROOT / "configs" / "training" / "train_musiclm_fma.json")).coarse_trainer_cfg
    model = omt_config.init_stage(mc, "coarse", 51, device=dev).model
    for ff in model.transformer.ffs:
        ff.dropout = 0.0
    hp = dict(loss_cfg=StageLossConfig(tuple(tcfg.cross_entropy_loss_weights), mask_prob=0.0), lr=tcfg.lr,
              wd=tcfg.wd, lr_warmup=tcfg.lr_warmup, max_grad_norm=tcfg.max_grad_norm,
              grad_accum_every=DP_ACCUM, stage_name="coarse", use_tensorboard=False, save_model_every=0)
    g = torch.Generator().manual_seed(52)
    lens = omt_config.stage_example_lengths(mc, "coarse")
    batches = [tuple(torch.randint(0, s.codebook_size, (DP_ACCUM, DP_BATCH, n), generator=g)
                     for s, n in zip(model.specs, lens)) for _ in range(DP_STEPS)]
    return model, hp, batches


CLIP_SCALE = 1 / 0.07


def clip_features(torch):
    """Seeded L2-normalized audio and text features [8, 512] of phase 10
    (b)'s clip_loss check."""
    g = torch.Generator().manual_seed(54)
    return [torch.nn.functional.normalize(torch.randn(8, 512, generator=g), dim=-1) for _ in range(2)]


def dp_rank_main(rank: int, world: int, init_file: str, folder: str, device: str, model_config: str) -> int:
    """One gloo rank of phase 10 (b) on the one card (every rank on cuda:0;
    ``device`` cpu in a rehearsal): DP_STEPS StageTrainer steps on its rows
    of each global batch, then clip_loss gathered over the ranks on the
    device's tensors (gloo's all_gather and all_reduce)."""
    import torch
    import torch.distributed as dist

    from open_musiclm_torch import config as omt_config
    from open_musiclm_torch.parallel.distributed import initialize_distributed
    from open_musiclm_torch.parallel.mesh import make_mesh, shard_batch
    from open_musiclm_torch.train.clip_loss import clip_loss
    from open_musiclm_torch.train.trainer import StageTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    initialize_distributed(dev.type, init_method=f"file://{init_file}", rank=rank, world_size=world,
                           local_rank=0, backend="gloo")
    mesh = make_mesh()
    model, hp, batches = dp_setup(torch, omt_config, dev, Path(model_config))
    trainer = StageTrainer(model=model, mesh=mesh, results_folder=str(Path(folder) / "results"), **hp)
    state = trainer.init_state()
    state.optimizer.eps = DP_EPS
    gen = torch.Generator(device=dev).manual_seed(mesh.rank_seed(53))
    losses = []
    for b in batches:
        state, loss = trainer.train_step(state, shard_batch(mesh, b, batch_axis=1), gen)
        losses.append(loss.item())
    # clip_loss's gather of this device's tensors: a failure fails the rank
    mine = [shard_batch(mesh, f).to(dev).requires_grad_(True) for f in clip_features(torch)]
    loss = clip_loss(*mine, torch.tensor(CLIP_SCALE, device=dev), group=mesh.group)
    clip = (loss.item(), [g.cpu() for g in torch.autograd.grad(loss, mine)])
    torch.save({"params": {k: v.detach().cpu() for k, v in model.state_dict().items()}, "losses": losses,
                "clip": clip}, Path(folder) / f"rank{rank}.pt")
    dist.destroy_process_group()
    return 0


def training_roofline(torch, model, lens, batch, accum, *, remat, measured_ms, what, card, dtype_bytes=2):
    """Prints (and returns) the roofline of one step beside its measured ms."""
    from open_musiclm_torch.train.roofline import stage_train_roofline

    r = stage_train_roofline(model, lens, batch, accum, device_name=torch.cuda.get_device_name(0),
                             compute_dtype_bytes=dtype_bytes, remat=remat)
    out = r.summary(measured_ms / 1e3 if measured_ms else None)
    share = (f"measured {measured_ms:.1f} ms, bound = {100 * r.bound_s / (measured_ms / 1e3):.3f} % of it"
             if measured_ms else "measured: not in this run")
    print(f"  (c) roofline, {what}: {out['bound']}-bound, bound {out['bound_ms']} ms (compute "
          f"{out['compute_ms']} / memory {out['memory_ms']} ms, {out['model_tflops']} model TFLOP, bytes GB "
          f"{out['bytes_gb_by_term']}); {share} [{card}]", flush=True)
    return out


def kernel1_bits(torch, model, lens, batch, dev, card):
    """Kernel 1 three times on the same inputs at a remat step's shape (the
    stage's heads, b rows of the whole stream, bf16, the rel-pos bias, a key
    mask): output and row statistics bit-identical call to call, so the
    backward's recompute saves what the forward would have."""
    from open_musiclm_torch.ops import attention

    n = sum(lens) + 2 * len(lens) - 1
    g = torch.Generator().manual_seed(44)
    q = attention.l2norm(torch.randn(batch, model.heads, n, model.dim_head, generator=g)).to(dev, torch.bfloat16)
    k = attention.l2norm(torch.randn(batch, n, model.dim_head, generator=g)).to(dev, torch.bfloat16)
    v = torch.randn(batch, n, model.dim_head, generator=g).to(dev, torch.bfloat16)
    with torch.no_grad():
        bias = model.transformer.rel_pos_bias(n, torch.bfloat16)
    key_mask = (torch.rand(batch, n, generator=g) > 0.15).to(dev)
    key_mask[:, 0] = True
    runs = [attention.shared_kv_attention_fused(q, k, v, bias, key_mask, return_stats=True) for _ in range(3)]
    same = all(torch.equal(a, b) for r in runs[1:] for a, b in zip(r, runs[0]))
    print(f"  kernel 1 at b{batch} x {model.heads} heads x n{n} bf16 (bias, key mask), 3 calls: output and row "
          f"statistics {'bit-identical' if same else 'DIFFER'} [{card}]", flush=True)
    if not same:
        fail("phase 10 (a): kernel 1 is not bit-identical call to call")


def remat_phase(torch, omt_config, dev, card, counters, model_config: Path = None):
    """Phase 10 (a): musiclm_large's coarse stage (LARGE_CUT_DEPTH of its 24
    layers, 16 heads x 1024, its 10 s coarse window) at the shipped coarse
    trainer config (b2 x accum 8,
    bf16 compute on float32 master weights, ff_dropout 0.1, forgetful mask
    0.15): two StageTrainer steps without remat and two with it, each pair
    from the same weights and generator state. The first step's loss and
    every gradient (read at the optimizer) must agree (bit-equal, or within
    1e-6 x max|grad| a tensor); kernel 1 must launch depth x accum times a
    step without remat and 2 x depth x accum with it, kernels 5 and 6 depth
    x accum either way. Prints each run's peak memory and ms a step (the
    second), and the step's roofline. ``model_config`` and ``dev`` let a
    rehearsal run it on the CPU at small widths."""
    from open_musiclm_torch.train.trainer import StageTrainer
    from open_musiclm_torch.models.token_cond import StageLossConfig

    on_card = dev.type == "cuda"
    mc = cut_depth(omt_config.load_model_config(str(model_config or ROOT / "configs" / "model" / "musiclm_large.json")))
    tcfg = omt_config.load_training_config(
        str(ROOT / "configs" / "training" / "train_musiclm_fma.json")).coarse_trainer_cfg
    b, accum = tcfg.batch_size, tcfg.grad_accum_every
    t0 = time.perf_counter()
    model = omt_config.init_stage(mc, "coarse", 41, device=dev, compute_dtype=torch.bfloat16).model
    depth, lens = model.depth, omt_config.stage_example_lengths(mc, "coarse")
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    g = torch.Generator().manual_seed(42)
    batches = [tuple(torch.randint(0, s.codebook_size, (accum, b, n), generator=g)
                     for s, n in zip(model.specs, lens)) for _ in range(2)]
    print(f"phase 10 (a): musiclm_large coarse stage, {depth} layers x {model.heads} heads x dim {model.dim}, "
          f"lens {lens}, b{b} x accum {accum}, bf16 on float32 masters, ff_dropout "
          f"{model.transformer.ffs[0].dropout}, built in {time.perf_counter() - t0:.1f} s", flush=True)
    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_remat_") as tmp:
        for remat in (False, True):
            model.load_state_dict(init)
            model.transformer.remat = remat
            trainer = StageTrainer(model=model, loss_cfg=StageLossConfig(tuple(tcfg.cross_entropy_loss_weights)),
                                   lr=tcfg.lr, wd=tcfg.wd, lr_warmup=tcfg.lr_warmup,
                                   max_grad_norm=tcfg.max_grad_norm, grad_accum_every=accum,
                                   results_folder=tmp, stage_name="coarse", use_tensorboard=False)
            state = trainer.init_state()
            grads, step = [], state.optimizer.step

            def capture(gs, step=step, grads=grads):
                if not grads:
                    grads.extend(x.detach().clone() for x in gs)
                step(gs)

            state.optimizer.step = capture
            gen = torch.Generator(device=dev).manual_seed(43)
            steps = []
            for batch in batches:
                for fn, attr in counters.values():
                    setattr(fn, attr, 0)
                if on_card:
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                t1 = time.perf_counter()
                state, loss = trainer.train_step(state, batch, gen)
                loss = loss.item()
                ms = (time.perf_counter() - t1) * 1e3
                peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else float("nan")
                steps.append((loss, ms, peak, {n: getattr(fn, attr) for n, (fn, attr) in counters.items()}))
            runs[remat] = (steps, grads)
            print(f"  remat={remat}: losses {[s[0] for s in steps]}, ms a step {[round(s[1], 1) for s in steps]}, "
                  f"peak device memory {[round(s[2], 2) for s in steps]} GiB [{card}]", flush=True)
            del trainer, state
            if on_card:
                torch.cuda.empty_cache()
    (plain, plain_grads), (remat, remat_grads) = runs[False], runs[True]
    names = [n for n, _ in model.named_parameters()]
    worst, bit_equal = (0.0, ""), 0
    for name, a, r in zip(names, plain_grads, remat_grads):
        if torch.equal(a, r):
            bit_equal += 1
            continue
        err = (a - r).abs().max().item() / max(a.abs().max().item(), 1e-30)
        worst = max(worst, (err, name))
    same_loss = plain[0][0] == remat[0][0]
    print(f"  remat against none, step 1: loss {'bit-equal' if same_loss else 'DIFFERS'} ({plain[0][0]!r} / "
          f"{remat[0][0]!r}); gradients bit-equal in {bit_equal} of {len(names)} tensors, worst other "
          f"{worst[0]:.2e} x max|grad| ({worst[1] or '-'}); step 2 loss {plain[1][0]!r} / {remat[1][0]!r}",
          flush=True)
    if worst[0] > 1e-6 or abs(plain[0][0] - remat[0][0]) > 1e-6 * abs(plain[0][0]):
        fail(f"phase 10 (a): remat changes the step: loss {plain[0][0]} / {remat[0][0]}, gradient {worst}")
    if on_card:
        kernel1_bits(torch, model, lens, b, dev, card)
    counts = {}
    for flag, steps in ((False, plain), (True, remat)):
        want = {"prefill_attention": (2 if flag else 1) * depth * accum, "attention_bwd": depth * accum,
                "attention_dbias": depth * accum}
        for i, (_, _, _, launches) in enumerate(steps):
            got = {n: launches[n] for n in want}
            others = {n: c for n, c in launches.items() if n not in want and c}
            if on_card and (got != want or others):
                fail(f"phase 10 (a) remat={flag} step {i + 1}: launches {launches}, want {want}")
        counts[flag] = steps[-1][3]
        print(f"  remat={flag}: launches a step {steps[-1][3]}")
    shares = {}
    for flag, steps in ((False, plain), (True, remat)):
        shares[flag] = training_roofline(torch, model, lens, b, accum, remat=flag, measured_ms=steps[1][1],
                                         what=f"musiclm_large coarse b{b} x accum {accum} bf16 remat={flag}",
                                         card=card) if on_card else None
    return {"launches": counts, "ms": {str(k): v[0][1][1] for k, v in runs.items()},
            "peak_gib": {str(k): v[0][1][2] for k, v in runs.items()}, "roofline": shares}


def data_parallel_phase(torch, omt_config, dev, card, model_config: Path = None):
    """Phase 10 (b): train_stage --stage coarse (musiclm_small, bf16, the
    shipped b2 x accum 8 on a token store) under ``python -m
    torch.distributed.run --standalone --nproc_per_node 1`` on NCCL (2 steps,
    a checkpoint, valid metrics and tokens written by rank 0), resumed the
    same way for one more step; then two gloo ranks on the one card (their
    own processes, a file:// store) for DP_STEPS steps at b4 x accum 2
    against a one-process run on the whole batch on the card. ``model_config``
    (musiclm_small's by default) and ``dev`` let a rehearsal run it on the
    CPU at small widths (then gloo throughout)."""
    from open_musiclm_torch.train.trainer import StageTrainer

    model_config = model_config or ROOT / "configs" / "model" / "musiclm_small.json"
    mc = omt_config.load_model_config(str(model_config))
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
        tmp = Path(tmp)
        write_token_store(tmp / "store", mc, n_tracks=8, seconds=12, seed=7)
        tc = json.loads((ROOT / "configs" / "training" / "train_musiclm_fma.json").read_text())
        tc["coarse_trainer_cfg"].update(use_preprocessed_data=True, folder=str(tmp / "store"), num_train_steps=2,
                                        save_model_every=1, save_results_every=1)
        cfg = tmp / "train.json"
        cfg.write_text(json.dumps(tc))
        res = tmp / "results"

        def torchrun(steps, *extra):
            tc["coarse_trainer_cfg"]["num_train_steps"] = steps
            cfg.write_text(json.dumps(tc))
            cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
                   "-m", f"{PACKAGE}.cli.train_stage", "--stage", "coarse", "--bf16", "--num_workers", "1",
                   "--training_config", str(cfg), "--results_folder", str(res), "--model_config",
                   str(model_config), "--device", dev.type, *extra]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
            wall = time.perf_counter() - t0
            if proc.returncode != 0:
                fail(f"phase 10 (b): torchrun train_stage exited {proc.returncode}: "
                     f"{proc.stdout[-1500:]} {proc.stderr[-3000:]}")
            return proc.stdout, wall

        stdout, wall = torchrun(2)
        said = [line for line in stdout.splitlines() if "training coarse" in line]
        recs = [json.loads(line) for line in (res / "coarse.log.jsonl").read_text().splitlines()]
        losses = [r["train_loss"] for r in recs if "train_loss" in r]
        files = sorted(p.name for p in res.iterdir() if p.is_file())
        print(f"phase 10 (b): python -m torch.distributed.run --standalone --nproc_per_node 1 -m "
              f"{PACKAGE}.cli.train_stage --stage coarse --bf16 (token store, b2 x accum 8): {wall:.1f} s; "
              f"{said}; losses {losses}; files {files} [{card}]", flush=True)
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if not said or backend not in said[0] or len(losses) != 2 or not all(map(math.isfinite, losses)):
            fail(f"phase 10 (b): the NCCL run said {said}, logged losses {losses}")
        if "coarse.transformer.1.ckpt" not in files or "coarse.tokens.1.txt" not in files:
            fail(f"phase 10 (b): rank 0 wrote {files}")
        stdout, wall = torchrun(3, "--continue_from_dir", str(res))
        recs = [json.loads(line) for line in (res / "coarse.log.jsonl").read_text().splitlines()]
        steps = [r["step"] for r in recs if "train_loss" in r]
        print(f"  resumed under torchrun: {wall:.1f} s, {[ln for ln in stdout.splitlines() if 'resuming' in ln]}, "
              f"logged steps {steps}", flush=True)
        if steps != [0, 1, 2] or "resuming" not in stdout:
            fail(f"phase 10 (b): the resume logged steps {steps}")
        out["torchrun_nccl_s"] = wall

        # two gloo ranks on the one card against one process on the whole batch
        folder = tmp / "gloo"
        folder.mkdir()
        cmd = [[sys.executable, str(ROOT / "chip_smoke.py"), "--dp_rank", str(r), "2", str(folder / "store"),
                str(folder), dev.type, str(model_config)] for r in range(2)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(c, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for c in cmd]
        try:
            logs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        if any(p.returncode for p in procs):
            fail(f"phase 10 (b): gloo ranks exited {[p.returncode for p in procs]}: {logs[0][-2000:]} "
                 f"{logs[1][-2000:]}")
        ranks = [torch.load(folder / f"rank{r}.pt", weights_only=False) for r in range(2)]  # written just above
        model, hp, batches = dp_setup(torch, omt_config, dev, model_config)
        trainer = StageTrainer(model=model, results_folder=str(folder / "one"), **hp)
        state = trainer.init_state()
        state.optimizer.eps = DP_EPS
        gen = torch.Generator(device=dev).manual_seed(53)
        losses = []
        t1 = time.perf_counter()
        for b in batches:
            state, loss = trainer.train_step(state, b, gen)
            losses.append(loss.item())
        one_s = time.perf_counter() - t1
        # the rel-pos MLP's output bias shifts a whole score row, which the
        # softmax ignores: its gradient is rounding noise and its values stay
        # near 0, so it is scaled by the output weight (as phase 6 does)
        sd, worst = {k: v.detach().cpu() for k, v in model.state_dict().items()}, (0.0, "")
        shift = "transformer.rel_pos_bias.out_layer.bias"
        for name, p in sd.items():
            scale = sd["transformer.rel_pos_bias.out_layer.weight"] if name == shift else p
            for r in ranks:
                worst = max(worst, ((r["params"][name] - p).abs().max().item()
                                    / max(scale.abs().max().item(), 1e-30), name))
        print(f"  2 gloo ranks on one card, musiclm_small coarse f32 b{DP_BATCH} x accum {DP_ACCUM} (b2 a rank), "
              f"{DP_STEPS} steps: {wall:.1f} s for both processes; losses rank 0 {ranks[0]['losses']}, one process "
              f"{losses} ({one_s:.2f} s); parameters: worst {worst[0]:.2e} x max|p| ({worst[1]}), limit {DP_TOL:.0e} "
              f"[{card}]", flush=True)
        if worst[0] > DP_TOL:
            fail(f"phase 10 (b): two gloo ranks differ from one process: {worst}")
        # clip_loss gathered over the two ranks against one process on all 8 rows:
        # each rank's loss, and its rows' gradient over the world size
        from open_musiclm_torch.train.clip_loss import clip_loss

        one = [f.to(dev).requires_grad_(True) for f in clip_features(torch)]
        loss = clip_loss(*one, torch.tensor(CLIP_SCALE, device=dev))
        grads = [x.cpu() for x in torch.autograd.grad(loss, one)]
        err = max(max(abs(r["clip"][0] - loss.item()),
                      *((gr / 2 - g[4 * i: 4 * i + 4]).abs().max().item() for gr, g in zip(r["clip"][1], grads)))
                  for i, r in enumerate(ranks))
        print(f"  gloo all_gather of {dev.type} tensors: clip_loss over 2 x 4 rows of 512, loss and gradients "
              f"against one process: max abs err {err:.2e} (limit 1e-6) [{card}]", flush=True)
        if err > 1e-6:
            fail(f"phase 10 (b): clip_loss gathered over gloo differs from one process by {err}")
        out.update(gloo_worst=worst[0], clip_err=err)
    return out


def phase10(torch, omt_config, dev, card, counters, phase6_ms=None):
    """Phase 10: (a) remat at musiclm_large's full width, (b) data parallel
    on the one card, (c) the rooflines. Returns (a)'s launches with remat."""
    t0 = time.perf_counter()
    a = remat_phase(torch, omt_config, dev, card, counters)
    torch.cuda.empty_cache()
    mc = omt_config.load_model_config(str(ROOT / "configs" / "model" / "musiclm_small.json"))
    with torch.device("meta"):
        small = omt_config.build_coarse_transformer(mc)
    training_roofline(torch, small, omt_config.stage_example_lengths(mc, "coarse"), 2, 8, remat=False,
                      measured_ms=phase6_ms, what="phase 6's musiclm_small coarse b2 x accum 8 bf16", card=card)
    b = data_parallel_phase(torch, omt_config, dev, card)
    print(json.dumps({"phase10": {"remat": {k: v for k, v in a.items() if k != "launches"}, **b},
                      "phase10_launches": {str(k): v for k, v in a["launches"].items()}}))
    print(f"phase 10: {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    return a["launches"][True]


# phase 11: tensor parallelism and the multi-card serving layouts on one card
TP_TOL = 1e-5  # (a) the loss and each gathered gradient, x max|g| a tensor
# phase 8's teacher-forced steps a stage and mode, and the depth of
# musiclm_large's stages in phases 10 (a) and 11 (a, b) (cut from 24 steps
# and 24 layers at the full width, to keep the whole script in its time
# limit on a slow host as phases were added)
LARGE_TF_STEPS = 8
LARGE_CUT_DEPTH = 8


def cut_depth(mc, depth: int = LARGE_CUT_DEPTH):
    """``mc`` with every stage at most ``depth`` layers deep (widths kept)."""
    import dataclasses

    return dataclasses.replace(mc, **{k: dataclasses.replace(getattr(mc, k), depth=min(depth, getattr(mc, k).depth))
                                      for k in ("semantic_cfg", "coarse_cfg", "fine_cfg")})
# (e) the mesh server's text requests: one batch of 4
SERVER_REQUESTS = tuple((p, 700 + i) for i, p in enumerate(PROMPTS[:4]))
TP_STEPS = 2  # (a) bf16 steps at the shipped coarse trainer config
LOGIT_TOL = 1e-4  # (b) phase 3's limit, x max|logit|
WAVE_TOL = 1e-5  # (c) the waves, absolute


def reset_counts(counters):
    for fn, attr in counters.values():
        setattr(fn, attr, 0)


def read_counts(counters):
    return {n: getattr(fn, attr) for n, (fn, attr) in counters.items()}


def heads_reversed(torch, model):
    """A copy of ``model`` with its attention heads in reverse order (to_q's
    rows, to_out's columns and the rel-pos MLP's outputs by head): the same
    function, its sums over heads in another order. Returns it and a map of
    (parameter name, its gradient) back to the original head order."""
    h, d = model.heads, model.dim_head
    perm = torch.arange(h - 1, -1, -1)
    idx = (perm[:, None] * d + torch.arange(d)).reshape(-1)
    flipped = copy.deepcopy(model)
    rows = {"to_q.weight": (0, idx), "to_out.weight": (1, idx), "out_layer.weight": (0, perm),
            "out_layer.bias": (0, perm)}
    with torch.no_grad():
        for name, p in flipped.named_parameters():
            rule = next((r for k, r in rows.items() if name.endswith(k)), None)
            if rule is not None:
                p.copy_(p.index_select(rule[0], rule[1].to(p.device)))

    def unflip(name, t):
        rule = next((r for k, r in rows.items() if name.endswith(k)), None)
        return t if rule is None else t.index_select(rule[0], rule[1].to(t.device))  # reversal is its own inverse

    return flipped, unflip


def tp_training(torch, omt_config, dev, mesh, large_config: str, counters) -> dict:
    """Phase 11 (a), on each rank of a tp=2 mesh: musiclm_large's coarse
    stage (LARGE_CUT_DEPTH layers, its 10 s window). First one float32 step at b2 x accum 1 with
    remat, ff_dropout 0.1 and the forgetful mask, from the same weights and
    generator seed as one process on the whole model, which the main rank
    runs first: the loss and every gathered gradient (read at the
    optimizer). Then TP_STEPS steps at the shipped coarse trainer config
    (bf16 compute on float32 masters, remat): ms, peak memory and launches a
    step."""
    from open_musiclm_torch.models.token_cond import StageLossConfig
    from open_musiclm_torch.parallel.mesh import Mesh
    from open_musiclm_torch.parallel.sharding import gather_param_tensors, load_whole_state_dict
    from open_musiclm_torch.train.trainer import StageTrainer

    on_card = dev.type == "cuda"
    mc = cut_depth(omt_config.load_model_config(large_config))
    tcfg = omt_config.load_training_config(
        str(ROOT / "configs" / "training" / "train_musiclm_fma.json")).coarse_trainer_cfg
    b, accum = tcfg.batch_size, tcfg.grad_accum_every
    t0 = time.perf_counter()
    model = omt_config.init_stage(mc, "coarse", 111, device=dev).model
    for ff in model.transformer.ffs:
        ff.dropout = 0.1
    model.transformer.remat = True
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    lens = omt_config.stage_example_lengths(mc, "coarse")
    g = torch.Generator().manual_seed(112)
    parity = tuple(torch.randint(0, s.codebook_size, (1, b, n), generator=g) for s, n in zip(model.specs, lens))
    batches = [tuple(torch.randint(0, s.codebook_size, (accum, b, n), generator=g)
                     for s, n in zip(model.specs, lens)) for _ in range(TP_STEPS)]
    hp = dict(loss_cfg=StageLossConfig(tuple(tcfg.cross_entropy_loss_weights)), lr=tcfg.lr, wd=tcfg.wd,
              lr_warmup=tcfg.lr_warmup, max_grad_norm=tcfg.max_grad_norm, stage_name="coarse",
              use_tensorboard=False, save_model_every=0)
    # the stream: each sequence with its EOS (the last one's is label only) and its start token
    out = {"shape": (model.depth, model.heads, model.dim, sum(lens) + 2 * len(lens) - 1, b, accum),
           "built_s": time.perf_counter() - t0}

    def first_step(m, mesh_, folder):
        """(loss, whole gradients) of one float32 step of ``m`` on ``mesh_``."""
        trainer = StageTrainer(model=m, mesh=mesh_, grad_accum_every=1, results_folder=folder, **hp)
        state = trainer.init_state()
        grads, step = [], state.optimizer.step

        def capture(gs):
            grads.extend(x.cpu() for x in gather_param_tensors(m, [x.detach() for x in gs]))
            step(gs)

        state.optimizer.step = capture
        gen = torch.Generator(device=dev).manual_seed(mesh_.rank_seed(113))
        _, loss = trainer.train_step(state, parity, gen)
        return loss.item(), grads

    def rel_err(got, ref):
        """Each tensor's max |got - ref| over its max |ref|; the rel-pos MLP's
        output bias shifts a whole score row (true gradient 0), so it is
        scaled by its output weight's, as phase 6 does."""
        out_w = ref["transformer.rel_pos_bias.out_layer.weight"]
        return {n: (got[n] - r).abs().max().item() / max((out_w if n.endswith("out_layer.bias") else r)
                                                         .abs().max().item(), 1e-30) for n, r in ref.items()}

    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as tmp:
        names = [n for n, _ in model.named_parameters()]
        if mesh.is_main:
            # one process on the whole model, the same weights and generator
            # seed; and its rounding floor: the same function with the heads
            # in reverse order (a reordering of the sums, as tp=2's is)
            one = copy.deepcopy(model)
            out["one_loss"], one_grads = first_step(one, Mesh(), tmp)
            ref = dict(zip(names, one_grads))
            del one, one_grads
            flipped, unflip = heads_reversed(torch, model)
            out["flipped_loss"], flipped_grads = first_step(flipped, Mesh(), tmp)
            floor = rel_err({n: unflip(n, x) for n, x in zip(names, flipped_grads)}, ref)
            del flipped, flipped_grads
        out["tp_loss"], grads = first_step(model, mesh, tmp)
        if mesh.is_main:
            errs = rel_err(dict(zip(names, grads)), ref)
            # each tensor within TP_TOL, or within 3x its rounding floor where
            # one process's reordered sums alone move it further. The rel-pos
            # MLP's gradients all come from one [2n-1, h] table gradient, a
            # sum of bias gradients whose rows sum to 0 (the softmax): they
            # share the largest floor among them
            rel_pos = [n for n in names if ".rel_pos_bias." in n]
            floor.update(dict.fromkeys(rel_pos, max(floor[n] for n in rel_pos)))
            limit = {n: max(TP_TOL, 3 * floor[n]) for n in names}
            out["worst_grad"] = max((errs[n] / limit[n], errs[n], n) for n in names)
            out["n_grads"] = len(names)
            out["within_tol"] = sum(errs[n] <= TP_TOL for n in names)
            out["largest"] = sorted(((errs[n], floor[n], n) for n in names if errs[n] > TP_TOL), reverse=True)[:5]
            del ref
        del grads
        gc.collect()  # the capturing optimizers' cycles hold the reference models
        if on_card:
            torch.cuda.empty_cache()
        # the shipped config: bf16 compute on the whole weights again
        load_whole_state_dict(model, init)
        del init
        model.compute_dtype = torch.bfloat16
        trainer = StageTrainer(model=model, mesh=mesh, grad_accum_every=accum, results_folder=tmp, **hp)
        state = trainer.init_state()
        gen = torch.Generator(device=dev).manual_seed(mesh.rank_seed(114))
        steps = []
        for batch in batches:
            reset_counts(counters)
            if on_card:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            state, loss = trainer.train_step(state, batch, gen)
            loss = loss.item()
            steps.append((loss, (time.perf_counter() - t1) * 1e3,
                          torch.cuda.max_memory_allocated() / 2**30 if on_card else float("nan"),
                          read_counts(counters)))
        out["steps"] = steps
    return out


def tp_decode(torch, omt_config, dev, mesh, config: str, counters) -> dict:
    """Phase 11 (b), on each rank of a tp=2 mesh: LARGE_TF_STEPS teacher-forced
    fp decode steps of each stage of musiclm_large_small_context (LARGE_CUT_DEPTH
    layers, float32) on the
    rank's shard; the main rank first runs them on the whole stage. Returns
    the main rank's errors and each rank's launches."""
    from open_musiclm_torch.models import token_cond
    from open_musiclm_torch.parallel.sharding import shard_module

    mc = cut_depth(omt_config.load_model_config(config))
    g = torch.Generator().manual_seed(121)
    out = {}
    for name, seed in (("semantic", 122), ("coarse", 123), ("fine", 124)):
        model = omt_config.init_stage(mc, name, seed, device=dev).model
        specs = model.specs
        prefix = {"semantic": (12,), "coarse": (12, 20), "fine": (12, 30)}[name]
        cond = [torch.randint(0, s.codebook_size, (2, n), generator=g).to(dev) for s, n in zip(specs, prefix)]
        q_last = specs[-1].num_quantizers
        T = -(-LARGE_TF_STEPS // q_last)
        teacher = torch.randint(0, specs[-1].codebook_size, (2, T, q_last), generator=g).to(dev)
        kw = dict(max_time_steps=T, temperature=0.0, teacher_ids=teacher, return_logits=True)
        want = token_cond.generate(model, cond, **kw)[1].cpu() if mesh.is_main else None
        shard_module(model, mesh)
        reset_counts(counters)
        tokens, got = token_cond.generate(model, cond, **kw)
        launches = read_counts(counters)
        got = got.cpu()
        rec = {"launches": launches, "steps": got.shape[1], "heads": model.transformer.attns[0].heads,
               "depth": model.depth}
        if want is not None:
            live = want[..., :-1]  # the EOS column is -1e9 on both
            rec["err"] = (got[..., :-1] - live).abs().max().item()
            rec["tol"] = LOGIT_TOL * max(1.0, live.abs().max().item())
        out[name] = rec
        del model
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def serving_musiclm(torch, omt_config, mc, dev):
    """Phase 4's musiclm_small stages (bf16, seeds 1-3) with a float32
    Encodec (seed 4), so that a wave's rows can be held within WAVE_TOL."""
    from open_musiclm_torch.models.musiclm import MusicLM

    stages = {f"{name}_stage": omt_config.init_stage(mc, name, seed, device=dev, dtype=torch.bfloat16,
                                                     quantized=True, flash_kv="int8")
              for name, seed in (("semantic", 1), ("coarse", 2), ("fine", 3))}
    codec = omt_config.build_encodec(mc, generator=torch.Generator().manual_seed(4), device=dev)
    return MusicLM(codec=codec, **stages)


def serving_runs(torch, omt_config, dev, mesh, small_config: str, counters, batch: int = 8,
                 parts=((0, 8),), modes=("int8", "fused")) -> dict:
    """Phase 11 (c): MusicLM.generate(serving_mesh=mesh, per_row_keys) at
    musiclm_small, ``batch`` x 4 s, in "int8" and "fused" (``mesh`` None: one
    process, one call for each row range of ``parts``, put together).
    Returns each mode's codes reaching Encodec, waves, wall and launches, and
    the MusicLM."""
    import dataclasses

    from open_musiclm_torch.core.sampling import seed_keys
    from open_musiclm_torch.models.stages import Stage

    mc = omt_config.load_model_config(small_config)
    musiclm = serving_musiclm(torch, omt_config, mc, dev)
    windows = dict(semantic_window_seconds=int(mc.global_cfg.semantic_audio_length_seconds),
                   coarse_window_seconds=int(mc.global_cfg.coarse_audio_length_seconds),
                   fine_window_seconds=int(mc.global_cfg.fine_audio_length_seconds))
    g = torch.Generator().manual_seed(131)
    clap = torch.randint(0, mc.clap_rvq_cfg.codebook_size, (batch, mc.clap_rvq_cfg.rq_num_quantizers, 1),
                         generator=g).to(dev)
    keys = seed_keys(range(131, 131 + batch), device=dev)
    out = {"musiclm": musiclm, "windows": windows}
    for mode in modes:
        m = dataclasses.replace(musiclm, serving_mesh=mesh, **{
            k: Stage(getattr(musiclm, k).model, name=k, quantized=True, flash_kv=mode)
            for k in ("semantic_stage", "coarse_stage", "fine_stage")})
        codes, decode = [], m._decode

        def capture(c, codes=codes, decode=decode):
            codes.append(c)
            return decode(c)

        m._decode = capture
        reset_counts(counters)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        waves = [m.generate(clap_token_ids=clap[lo:hi], per_row_keys=keys[lo:hi], output_seconds=4.0, **windows)
                 for lo, hi in parts]
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out[mode] = {"codes": torch.cat(codes).cpu(), "wave": torch.cat(waves).float().cpu(),
                     "wall": time.perf_counter() - t0, "launches": read_counts(counters),
                     "depth": len(musiclm.semantic_stage.model.transformer.attns)}
    return out


def mesh_server_runs(torch, omt_config, dev, mesh, small_config: str, vocab_dir: str) -> dict:
    """Phase 11 (e): GenerationServer in "fused" at musiclm_small (phase 4's
    stages, a float32 Encodec) with the full-width text tower (seed 31) and
    the demo vocabulary, buckets [2, 4], one worker, over ``mesh`` (None:
    one process). The front takes SERVER_REQUESTS, submitted before the
    server starts so that the batch (all 4) forms alike everywhere;
    every rank records the codes reaching Encodec, the front the waves and
    its wall. Another rank returns once the front's stop header came."""
    from open_musiclm_torch.models.clap.tokenizer import load_tokenizer
    from open_musiclm_torch.models.musiclm import MusicLM
    from open_musiclm_torch.models.stages import Stage
    from open_musiclm_torch.serve import GenerationServer

    mc = omt_config.load_model_config(small_config)
    base = serving_musiclm(torch, omt_config, mc, dev)
    front = mesh is None or mesh.is_main
    clap = omt_config.build_clap(mc, torch.Generator().manual_seed(31), device=dev) if front else None
    musiclm = MusicLM(codec=base.codec, clap=clap, tokenizer=load_tokenizer(vocab_dir), serving_mesh=mesh, **{
        k: Stage(getattr(base, k).model, name=k, quantized=True, flash_kv="fused")
        for k in ("semantic_stage", "coarse_stage", "fine_stage")})
    codes, decode = [], musiclm._decode

    def capture(c):
        codes.append(c.cpu())
        return decode(c)

    musiclm._decode = capture
    g = mc.global_cfg
    server = GenerationServer(musiclm, batch_size=4, batch_buckets=[2, 4], batch_timeout_s=0.5, num_workers=1,
                              output_seconds=4.0, semantic_window_seconds=int(g.semantic_audio_length_seconds),
                              coarse_window_seconds=int(g.coarse_audio_length_seconds),
                              fine_window_seconds=int(g.fine_audio_length_seconds))
    out = {"front": server.is_front}
    if server.is_front:
        futs = [server.submit(text, seed=seed) for text, seed in SERVER_REQUESTS]
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        server.start()
        out["waves"] = [f.result(timeout=600) for f in futs]
        out["wall"] = time.perf_counter() - t0
        server.stop()
    else:
        server.start().stop(timeout=600)
    out["codes"] = codes
    return out


def batch_size_probe(torch, musiclm, dev, card) -> dict:
    """Whether a row's bits alone (b 1) equal its bits at b 2, 4, 8 and 16
    in the pieces of a decode (bf16, musiclm_small's widths): the prefill's
    products in their row tiles (``row_linear``, [b x 216, 1024] x [1024,
    5460] and [b x 216, 2730] x [2730, 1024]) and a decode step's ([b, 1024]
    x [1024, 512]), kernel 1 (8 heads over 216 keys), kernel 2 over a
    1280-row int8 cache at pos 1279, kernel 3 (one conv-FF layer), kernel 4
    (the logit head, also at 17 and 32 rows), kernel 7 (one fused layer at
    pos 1279); then the semantic stage's prefill and 3 teacher-forced decode
    steps in "int8" and "fused". Each entry lists the batch sizes at which
    row 0 differed; the caller fails unless every list is empty."""
    from open_musiclm_torch.models.stages import Stage
    from open_musiclm_torch.ops import attention, decode_attention, fused_ff, fused_layer, quant
    from open_musiclm_torch.ops.rows import DECODE_TILE, PREFILL_TILE, row_linear

    g = torch.Generator().manual_seed(151)
    model = musiclm.semantic_stage.model
    ff, at = model.transformer.ffs[0], model.transformer.attns[0]
    wq, sc = quant.quantize_weight(model.logit_heads[-1][0].detach().float().t())
    packed, layer = fused_ff.pack_ff_weights(ff), fused_layer.pack_layer_weights(at, ff)
    sizes = (2, 4, 8, 16)

    def rand(*shape):  # in the stage's dtype (bf16 in phase 11)
        return torch.randn(*shape, generator=g).to(dev, model.start_tokens.dtype)

    def differs(fn, n_max=16, counts=sizes):
        """Batch sizes b at which fn(b)'s first rows (batch row 0's) differ
        from fn(1)."""
        one = fn(1)
        return [b for b in counts if b <= n_max and not torch.equal(fn(b)[:one.shape[0]], one)]

    N = 1280
    x, h = rand(16 * 216, model.dim), rand(16, model.dim)
    mid = rand(16 * 216, ff.inner_dim)
    q, k, v, bias = rand(16, 8, 216, 64), rand(16, 216, 64), rand(16, 216, 64), rand(8, 216, 216)
    state = rand(16, 2, 2 * ff.inner_dim)
    kv = torch.randint(-127, 128, (16, N, 128), generator=g, dtype=torch.int8).to(dev)
    kvs = (torch.rand(2, 16, N, generator=g) * 0.02).to(dev)
    add, row, qd = torch.zeros(16, N, device=dev), torch.randn(N, 8, generator=g).to(dev), rand(16, 8, 64)
    head_rows, row_h = rand(32, model.dim), torch.randn(N, model.heads, generator=g).to(dev)
    out = {
        "prefill proj_in (row tiles)": differs(lambda b: row_linear(x[:b * 216], ff.proj_in.weight, tile=PREFILL_TILE)),
        "prefill proj_out (row tiles)": differs(
            lambda b: row_linear(mid[:b * 216], ff.proj_out.weight, tile=PREFILL_TILE)),
        "decode to_q (row tiles)": differs(lambda b: row_linear(h[:b], at.to_q.weight, tile=DECODE_TILE)),
        "kernel 1": differs(lambda b: attention.shared_kv_attention_fused(q[:b], k[:b], v[:b], bias)),
        "kernel 2": differs(lambda b: decode_attention.flash_decode_step(
            qd[:b], kv[:b], N - 1, row, add[:b], kvs[:, :b].contiguous())),
        "kernel 3": differs(lambda b: fused_ff.fused_ff_apply(h[:b].contiguous(), packed, state[:b].clone())[0]),
        "kernel 4": differs(lambda b: quant.int8_matmul(head_rows[:b].contiguous(), wq, sc), 32,
                            sizes + (17, 32)),
        "kernel 7": differs(lambda b: fused_layer.fused_layer_decode_step(
            h[:b].contiguous(), layer, kv[:b].clone(), kvs[:, :b].contiguous(), state[:b].clone(), N - 1, row_h,
            add[:b], heads=model.heads)[0]),
    }
    clap = torch.randint(0, model.specs[0].codebook_size, (16, 12), generator=g).to(dev)
    teacher = torch.randint(0, model.specs[-1].codebook_size, (16, 3, 1), generator=g).to(dev)
    stream = model.assemble_stream([clap])
    with torch.no_grad():
        out["semantic prefill"] = differs(lambda b: model.transformer.prefill(
            stream[:b], model.transformer.init_cache(b, stream.shape[1]))[0])
    for mode in ("int8", "fused"):
        st = Stage(model, quantized=True, flash_kv=mode)
        kw = dict(max_time_steps=3, temperature=0.0, return_logits=True)
        out[f"semantic {mode} teacher-forced logits"] = differs(
            lambda b: st.generate([clap[:b]], teacher_forced_ids=teacher[:b], **kw)[1])
    return out

def invariance_probe(torch, dev, card) -> dict:
    """Which pieces of the serving path give a row other bits when its batch
    has other rows (``--probe``): cuBLAS products at the decode's and the
    prefill's row counts and at fixed row tiles (the row moved within the
    tile, and tiles as one batched call), the row reductions (the port's
    LayerNorm, F.layer_norm, l2norm, softmax), the fp decode's attention,
    the Encodec decoder, kernels 1-4 and 7 at b 1-16, and the semantic
    stage's prefill and teacher-forced logits in each mode. Each entry lists
    the row counts at which a row's bits differed from its bits alone (or
    whether a moved row kept its bits)."""
    import torch.nn.functional as F

    from open_musiclm_torch import config as omt_config
    from open_musiclm_torch.models.stages import Stage
    from open_musiclm_torch.models.transformer import layer_norm
    from open_musiclm_torch.ops import attention, decode_attention, fused_ff, fused_layer, quant

    g = torch.Generator().manual_seed(161)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(dev, dtype)

    def differs(fn, x, counts):
        """Row counts m at which fn(x[:m])'s row 0 differs from fn(x[:1])."""
        one = fn(x[:1])
        return [m for m in counts if not torch.equal(fn(x[:m])[:1], one)]

    out = {}
    counts = (2, 3, 4, 8, 16, 17, 32, 56, 64, 112, 128, 216, 432, 1000, 3456)
    shapes = {"to_q": (1024, 512), "to_kv": (1024, 128), "to_out": (512, 1024), "proj_in": (1024, 5460),
              "proj_out": (2730, 1024), "head": (1024, 1025), "roberta_ff": (768, 3072)}
    for dt in (torch.bfloat16, torch.float32):
        tag = str(dt).removeprefix("torch.")
        for name, (K, N) in shapes.items():
            w, x = rnd(N, K, dtype=dt), rnd(3456, K, dtype=dt)
            out[f"linear {name} {tag}"] = differs(lambda a: F.linear(a, w), x, counts)
            for T in (16, 64, 128, 256):
                base = F.linear(x[:T], w)
                out[f"linear {name} {tag} tile {T} row moved keeps bits"] = all(
                    torch.equal(F.linear(x[:T].roll(s, 0), w), base.roll(s, 0)) for s in (1, 5, T // 2 + 3))
                bad = []
                for c in (2, 5, 13):
                    xc = x[:c * T]
                    single = torch.cat([F.linear(xc[i * T:(i + 1) * T], w) for i in range(c)])
                    if not torch.equal(torch.matmul(xc.view(c, T, K), w.t()).reshape(c * T, N), single):
                        bad.append(c)
                out[f"linear {name} {tag} tile {T} batched tiles differing from single calls"] = bad
        for width in (1024, 2730, 768):
            x, gamma = rnd(3456, width, dtype=dt), rnd(width)
            out[f"layer_norm {width} {tag}"] = differs(lambda a: layer_norm(a, gamma), x, counts)
            out[f"F.layer_norm {width} {tag}"] = differs(
                lambda a: F.layer_norm(a.float(), (width,), gamma).to(dt), x, counts)
        q = rnd(3456, 8, 64, dtype=dt)
        out[f"l2norm 8x64 {tag}"] = differs(attention.l2norm, q, counts)
        out[f"l2norm 1x64 {tag}"] = differs(attention.l2norm, q[:, 0], counts)
    s = rnd(1000, 8, 1280)
    out["softmax 8x1280 float32"] = differs(lambda a: torch.softmax(a, -1), s, (2, 4, 8, 16, 17, 32, 112, 1000))
    for dt in (torch.bfloat16, torch.float32):
        q, k, v = rnd(16, 8, 64, dtype=dt), rnd(16, 1280, 64, dtype=dt), rnd(16, 1280, 64, dtype=dt)
        table = rnd(2 * 1280 - 1, 8)
        out[f"fp decode attention {dt}"] = [
            b for b in (2, 4, 8, 16)
            if not torch.equal(attention.shared_kv_decode_step(q[:b], k[:b], v[:b], 1279, bias_table=table)[:1],
                               attention.shared_kv_decode_step(q[:1], k[:1], v[:1], 1279, bias_table=table))]
    mc = omt_config.load_model_config(str(ROOT / "configs" / "model" / "musiclm_small.json"))
    codec = omt_config.build_encodec(mc, generator=torch.Generator().manual_seed(4), device=dev)
    codes = torch.randint(0, 1024, (16, 300, 8), generator=g).to(dev)
    with torch.no_grad():
        one = codec.decode(codes[:1])
        rows = {b: codec.decode(codes[:b])[:1] for b in (2, 4, 8, 16)}
    out["encodec decode f32 max abs diff of row 0 at b"] = {b: (r - one).abs().max().item() for b, r in rows.items()}

    # the kernels
    wq, sc = quant.quantize_weight(rnd(1024, 1025))
    x = rnd(256, 1024, dtype=torch.bfloat16)
    out["kernel 4"] = differs(lambda a: quant.int8_matmul(a.contiguous(), wq, sc), x, (2, 8, 9, 16, 17, 64, 200, 256))
    base = quant.int8_matmul(x[:16], wq, sc)
    out["kernel 4 row moved keeps bits"] = all(
        torch.equal(quant.int8_matmul(x[:16].roll(r, 0).contiguous(), wq, sc), base.roll(r, 0)) for r in (1, 5, 11))
    stage = omt_config.init_stage(mc, "semantic", 1, device=dev, dtype=torch.bfloat16)
    model = stage.model
    ff, at = model.transformer.ffs[0], model.transformer.attns[0]
    packed = fused_ff.pack_ff_weights(ff)
    h, state = rnd(16, 1024, dtype=torch.bfloat16), rnd(16, 2, 2 * ff.inner_dim, dtype=torch.bfloat16)
    out["kernel 3"] = differs(lambda a: fused_ff.fused_ff_apply(
        a.contiguous(), packed, state[:a.shape[0]].clone())[0], h, (2, 4, 8, 16))
    qb, kb, vb = (rnd(8, 8, 216, 64, dtype=torch.bfloat16), rnd(8, 216, 64, dtype=torch.bfloat16),
                  rnd(8, 216, 64, dtype=torch.bfloat16))
    bias = rnd(8, 216, 216, dtype=torch.bfloat16)
    out["kernel 1"] = [b for b in (2, 4, 8) if not torch.equal(
        attention.shared_kv_attention_fused(qb[:b], kb[:b], vb[:b], bias)[:1],
        attention.shared_kv_attention_fused(qb[:1], kb[:1], vb[:1], bias))]
    N = 1280
    kv = torch.randint(-127, 128, (16, N, 128), generator=g, dtype=torch.int8).to(dev)
    kvs = (torch.rand(2, 16, N, generator=g) * 0.01).to(dev)
    add = torch.zeros(16, N, device=dev)
    row = rnd(N, 8)
    qd = rnd(16, 8, 64, dtype=torch.bfloat16)
    for pos in (100, 1279):
        out[f"kernel 2 pos {pos}"] = [b for b in (2, 4, 8, 16) if not torch.equal(
            decode_attention.flash_decode_step(qd[:b], kv[:b], pos, row, add[:b], kvs[:, :b].contiguous())[:1],
            decode_attention.flash_decode_step(qd[:1], kv[:1], pos, row, add[:1], kvs[:, :1].contiguous()))]
    lay = fused_layer.pack_layer_weights(at, ff)

    def k7(b, pos):
        return fused_layer.fused_layer_decode_step(
            h[:b].contiguous(), lay, kv[:b].clone(), kvs[:, :b].contiguous(), state[:b].clone(), pos, row,
            add[:b], heads=8)[0][:1]

    for pos in (100, 1279):
        out[f"kernel 7 pos {pos}"] = [b for b in (2, 4, 8, 16) if not torch.equal(k7(b, pos), k7(1, pos))]

    # row_linear, F.layer_norm with the rows moved, the text tower
    from open_musiclm_torch.ops.rows import DECODE_TILE, PREFILL_TILE, row_linear
    for dt in (torch.bfloat16, torch.float32):
        for name, (K, N) in shapes.items():
            w, x = rnd(N, K, dtype=dt), rnd(600, K, dtype=dt)
            for tile in (DECODE_TILE, PREFILL_TILE):
                out[f"row_linear {name} {dt} tile {tile}"] = differs(
                    lambda a: row_linear(a, w, tile=tile), x, (2, 3, 8, 16, 17, 64, 65, 300, 600))
        for width in (1024, 2730):
            x, gamma = rnd(64, width, dtype=dt), rnd(width)
            base = layer_norm(x, gamma)
            out[f"layer_norm {width} {dt} rows moved keep bits"] = all(
                torch.equal(layer_norm(x.roll(r, 0), gamma), base.roll(r, 0)) for r in (1, 3, 7))
    clap_model = omt_config.build_clap(mc, generator=torch.Generator().manual_seed(31), device=dev)
    ids = torch.randint(4, 200, (8, 77), generator=g)
    mask = torch.ones(8, 77, dtype=torch.long)
    mask[:, 40:] = 0
    toks8 = clap_model.tokenize_text(ids, mask)
    out["text tower tokens, rows alone vs in b8"] = [
        i for i in range(8) if not torch.equal(clap_model.tokenize_text(ids[i:i + 1], mask[i:i + 1])[0], toks8[i])]
    del clap_model

    # each stage end to end: the prefill, then teacher-forced logits in each mode
    for name, seed in (("semantic", 1), ("coarse", 2), ("fine", 3)):
        stage = omt_config.init_stage(mc, name, seed, device=dev, dtype=torch.bfloat16)
        model = stage.model
        cond = [torch.randint(0, spec.codebook_size, (16, 12 if i == 0 else 24 * spec.num_quantizers), generator=g)
                .to(dev) for i, spec in enumerate(model.specs[:-1])]
        q = model.specs[-1].num_quantizers
        teacher = torch.randint(0, model.specs[-1].codebook_size, (16, 3, q), generator=g).to(dev)
        stream = model.assemble_stream(cond + [torch.zeros((16, 0), dtype=torch.long, device=dev)])
        with torch.no_grad():
            h1 = model.transformer.prefill(stream[:1], model.transformer.init_cache(1, stream.shape[1]))[0]
            out[f"{name} prefill"] = [b for b in (2, 4, 8, 16) if not torch.equal(
                model.transformer.prefill(stream[:b], model.transformer.init_cache(b, stream.shape[1]))[0][:1], h1)]
        for mode, quantized in (("int8", True), ("fused", True), (None, True), ("fp", False)):
            st = Stage(model, quantized=quantized, flash_kv=mode if quantized else None)
            kw = dict(max_time_steps=3, temperature=0.0, return_logits=True)
            one = st.generate([c[:1] for c in cond], teacher_forced_ids=teacher[:1], **kw)[1]
            out[f"{name} {mode} teacher-forced logits"] = [
                b for b in (2, 4, 8, 16)
                if not torch.equal(st.generate([c[:b] for c in cond], teacher_forced_ids=teacher[:b], **kw)[1][:1],
                                   one)]
        del stage, model
    print(f"invariance probe [{card}]:", flush=True)
    for k, v in out.items():
        print(f"  {k}: {v}", flush=True)
    return out


def tp_rank_main(rank: int, world: int, init_file: str, folder: str, device: str) -> int:
    """One gloo rank of phase 11 (every rank on cuda:0; ``device`` cpu in a
    rehearsal): (a) and (b) on make_mesh(tp=2), (c) on make_mesh(dp=2).
    Writes its results to ``folder``/tp_rank{rank}.pt."""
    import torch
    import torch.distributed as dist

    from open_musiclm_torch import config as omt_config
    from open_musiclm_torch.parallel.distributed import initialize_distributed
    from open_musiclm_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    spec = json.loads((Path(folder) / "spec.json").read_text())
    initialize_distributed(dev.type, init_method=f"file://{init_file}", rank=rank, world_size=world,
                           local_rank=0, backend="gloo")
    counters = all_counters()
    tp = make_mesh(tp=world)
    out = {"a": tp_training(torch, omt_config, dev, tp, spec["large"], counters)}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["b"] = tp_decode(torch, omt_config, dev, tp, spec["large_small_context"], counters)
    dp = make_mesh(dp=world)
    c = serving_runs(torch, omt_config, dev, dp, spec["small"], counters)
    out["c"] = {mode: c[mode] for mode in ("int8", "fused")}
    del c
    out["e"] = mesh_server_runs(torch, omt_config, dev, dp, spec["small"], spec["vocab"])
    torch.save(out, Path(folder) / f"tp_rank{rank}.pt")
    dist.destroy_process_group()
    return 0


def tp_phase(torch, omt_config, dev, card, counters, large_config: Path = None,
             large_small_context_config: Path = None, small_config: Path = None) -> dict:
    """Phase 11: tensor parallelism and the serving layouts on the one card.
    Two gloo ranks (their own processes, a file:// store, both on the card)
    run (a) musiclm_large's coarse stage at tp=2 (8 heads a rank over n
    2,766), (b) the fp decode of musiclm_large_small_context's stages at
    tp=2, (c) MusicLM.generate over make_mesh(dp=2) at musiclm_small (b4
    a rank) and (e) GenerationServer over that mesh, while this process runs
    (c)'s one-process runs (b8, and b8 as two b4 calls, which must agree
    code for code), the batch-size gate (``batch_size_probe``), (d)
    to_pipelined on the card and (e)'s one-process server. gloo over one card shows that the sharded
    path computes one process's function on the card's kernels; it does not
    measure tensor-parallel speed (every collective crosses the host). The
    configs let a rehearsal run it on the CPU at small widths."""
    import dataclasses

    import numpy as np

    from open_musiclm_torch.models.stages import Stage

    root_cfg = ROOT / "configs" / "model"
    spec = {"large": str(large_config or root_cfg / "musiclm_large.json"),
            "large_small_context": str(large_small_context_config or root_cfg / "musiclm_large_small_context.json"),
            "small": str(small_config or root_cfg / "musiclm_small.json")}
    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as tmp:
        tmp = Path(tmp)
        (tmp / "vocab").mkdir()
        write_demo_vocab(tmp / "vocab")
        spec["vocab"] = str(tmp / "vocab")
        (tmp / "spec.json").write_text(json.dumps(spec))
        cmd = [[sys.executable, str(ROOT / "chip_smoke.py"), "--tp_rank", str(r), "2", str(tmp / "store"),
                str(tmp), dev.type] for r in range(2)]
        procs = [subprocess.Popen(c, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for c in cmd]
        try:
            # (c) one process on each rank's rows (b4 a call) and on the whole
            # batch (b8), and (d), while the ranks run
            one = serving_runs(torch, omt_config, dev, None, spec["small"], counters, parts=((0, 4), (4, 8)))
            whole = serving_runs(torch, omt_config, dev, None, spec["small"], counters)
            alone = serving_runs(torch, omt_config, dev, None, spec["small"], counters, parts=((2, 3),),
                                 modes=("fused",))
            del alone["musiclm"]
            probe = batch_size_probe(torch, whole["musiclm"], dev, card)
            musiclm, windows = whole["musiclm"], whole["windows"]
            del one["musiclm"]
            gen_kw = dict(clap_token_ids=torch.randint(0, 1024, (2, 12, 1), generator=torch.Generator()
                                                       .manual_seed(141)).to(dev), output_seconds=4.0, **windows)
            # to_pipelined's placement is the mode's business of no stage: "fused", the shortest
            musiclm = dataclasses.replace(musiclm, **{
                k: Stage(getattr(musiclm, k).model, name=k, quantized=True, flash_kv="fused")
                for k in ("semantic_stage", "coarse_stage", "fine_stage")})
            want = musiclm.generate(generator=torch.Generator(device=dev).manual_seed(142), **gen_kw)
            # the one card as cuda:0, and as cuda:0 and cuda (another name for
            # it, so the coarse stage and the codec are copied)
            first = torch.device("cuda", 0) if on_card else dev
            other = torch.device("cuda") if on_card else torch.device("cpu", 0)
            pipelined = {}
            for what, devices in (("one device", [first]), ("two entries naming the one card (copies)",
                                                            [first, other])):
                pl = musiclm.to_pipelined(devices)
                got = pl.generate(generator=torch.Generator(device=dev).manual_seed(142), **gen_kw)
                copied = sum(getattr(pl, k) is not getattr(musiclm, k) for k in ("coarse_stage", "codec"))
                pipelined[what] = (torch.equal(got, want), copied, [str(d) for d in pl.stage_devices])
                print(f"phase 11 (d): to_pipelined({[str(d) for d in devices]}): stage devices "
                      f"{[str(d) for d in pl.stage_devices]}, {copied} of the coarse stage and codec copied, "
                      f"fused b2 x 4 s waves {'bit-equal' if torch.equal(got, want) else 'DIFFER'} to the "
                      f"unpipelined run [{card}]", flush=True)
                del pl
            del musiclm
            one_server = mesh_server_runs(torch, omt_config, dev, None, spec["small"], spec["vocab"])
            logs = [p.communicate(timeout=900)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode for p in procs):
            fail(f"phase 11: tp ranks exited {[p.returncode for p in procs]}: {logs[0][-3000:]} {logs[1][-3000:]}")
        ranks = [torch.load(tmp / f"tp_rank{r}.pt", weights_only=False) for r in range(2)]  # written just above
    if not all(ok for ok, _, _ in pipelined.values()) or pipelined["two entries naming the one card (copies)"][1] == 0:
        fail(f"phase 11 (d): to_pipelined: {pipelined}")
    out["pipelined_bit_equal"] = True

    # (a) training at tp=2
    a = [r["a"] for r in ranks]
    depth, heads, dim, n, b, accum = a[0]["shape"]
    share, worst, name = a[0]["worst_grad"]
    print(f"phase 11 (a): musiclm_large coarse stage at tp=2 on two gloo ranks of one card, {depth} layers x "
          f"{heads} heads ({heads // 2} a rank) x dim {dim}, n {n}; float32 b{b} x accum 1, remat, ff_dropout 0.1: "
          f"loss tp {a[0]['tp_loss']!r} / one process {a[0]['one_loss']!r} (heads reversed "
          f"{a[0]['flipped_loss']!r}); gathered gradients of {a[0]['n_grads']} tensors: the worst at "
          f"{share:.3f} of its limit ({name}: {worst:.2e} x max|g|); limit {TP_TOL:.0e} x max|g|, or 3x a "
          f"tensor's own rounding floor (one process with the heads reversed) where that is larger; "
          f"{a[0]['within_tol']} tensors within {TP_TOL:.0e}, the largest others (tp err, floor, name): "
          f"{a[0]['largest']} [{card}]", flush=True)
    if share > 1.0 or abs(a[0]["tp_loss"] - a[0]["one_loss"]) > TP_TOL * abs(a[0]["one_loss"]):
        fail(f"phase 11 (a): tp=2 differs from one process: loss {a[0]['tp_loss']} / {a[0]['one_loss']}, "
             f"gradient {name} {worst}")
    want_launches = {"prefill_attention": 2 * depth * accum, "attention_bwd": depth * accum,
                     "attention_dbias": depth * accum}
    for r, rank in enumerate(a):
        for i, (loss, ms, peak, launches) in enumerate(rank["steps"]):
            got = {k: launches[k] for k in want_launches}
            others = {k: c for k, c in launches.items() if k not in want_launches and c}
            print(f"  rank {r} bf16 step {i + 1} (b{b} x accum {accum}, remat): loss {loss:.6f}, {ms:.1f} ms, peak "
                  f"{peak:.2f} GiB (phase 10 (a) prints one process's, 16 heads), launches {launches} "
                  f"[{card}]", flush=True)
            if not math.isfinite(loss) or (on_card and (got != want_launches or others)):
                fail(f"phase 11 (a) rank {r} step {i + 1}: loss {loss}, launches {launches}, want {want_launches}")
    out["a"] = {"worst_grad": worst, "ms": [[s[1] for s in rank["steps"]] for rank in a],
                "peak_gib": [[s[2] for s in rank["steps"]] for rank in a], "launches": want_launches}

    # (b) the fp decode at tp=2
    for name, rec in ranks[0]["b"].items():
        print(f"phase 11 (b): musiclm_large_small_context {name} stage ({rec['depth']} layers, {rec['heads']} heads "
              f"a rank) f32 b2, {rec['steps']} teacher-forced fp decode steps at tp=2 against one process: "
              f"max_abs_err {rec['err']:.3e} tol {rec['tol']:.3e}; launches rank 0 {rec['launches']}, rank 1 "
              f"{ranks[1]['b'][name]['launches']} [{card}]", flush=True)
        if not rec["err"] <= rec["tol"]:
            fail(f"phase 11 (b): {name} logits differ at tp=2: {rec['err']} > {rec['tol']}")
        for rank in ranks:
            expect_launches(f"phase 11 (b) {name}", rank["b"][name]["launches"] if on_card else
                            {k: 0 for k in counters}, {"prefill_attention"} if on_card else set())
    # (c) prompt-parallel serving over dp=2: held to one process on each
    # rank's rows (the same batch a call); beside it the one-process b8 run
    paths = {"int8": {"prefill_attention", "flash_decode_step", "fused_ff_apply", "int8_matmul"},
             "fused": {"prefill_attention", "int8_matmul", "fused_layer_decode_step"}}
    for mode in ("int8", "fused"):
        want, b8 = one[mode], whole[mode]
        rows_b8 = [torch.equal(a, w) for a, w in zip(want["codes"], b8["codes"])]
        n_coarse = 3
        coarse_b8 = sum(torch.equal(a[:, :n_coarse], w[:, :n_coarse]) for a, w in zip(want["codes"], b8["codes"]))
        wave_diff = (want['wave'] - b8['wave']).abs().max().item()
        print(f"phase 11 (c): one process, {mode} b8 x 4 s as two b4 calls ({want['wall']:.2f} s) against one b8 "
              f"call ({b8['wall']:.2f} s): rows with equal codes {sum(rows_b8)} of {len(rows_b8)} (equal coarse "
              f"codes {coarse_b8}), waves max abs diff {wave_diff:.2e} (limit {ROW_WAVE_TOL:.0e}); batch sizes at "
              f"which row 0's bits differ from its bits alone: {probe} [{card}]", flush=True)
        one_row = alone.get(mode)
        row_equal, row_diff = True, 0.0
        if one_row is not None:
            row_equal = torch.equal(one_row["codes"][0], b8["codes"][2])
            row_diff = (one_row["wave"][0] - b8["wave"][2]).abs().max().item()
            print(f"phase 11 (c): one process, {mode} x 4 s, row 2 alone (b1, {one_row['wall']:.2f} s) against its "
                  f"slot in the b8 call: codes bit-equal {row_equal}, wave max abs diff {row_diff:.2e} [{card}]",
                  flush=True)
        if sum(rows_b8) != len(rows_b8) or not wave_diff <= ROW_WAVE_TOL:
            fail(f"phase 11 (c) {mode}: b8 as two b4 calls against one b8 call: {sum(rows_b8)} of {len(rows_b8)} "
                 f"rows with equal codes, waves {wave_diff}")
        if not row_equal or not row_diff <= ROW_WAVE_TOL:
            fail(f"phase 11 (c) {mode}: row 2 alone differs from its row in the b8 call: {row_equal}, {row_diff}")
        if any(probe.values()):
            fail(f"phase 11 (c): a row's bits depend on its batch's size: {probe}")
        for r, rank in enumerate(ranks):
            got = rank["c"][mode]
            same = torch.equal(got["codes"], want["codes"])
            err = (got["wave"] - want["wave"]).abs().max().item() if got["wave"].shape == want["wave"].shape else math.inf
            print(f"phase 11 (c): MusicLM.generate(serving_mesh=dp2, per_row_keys) {mode} b{want['codes'].shape[0]} "
                  f"x 4 s, rank {r} (b{want['codes'].shape[0] // 2} a rank): {got['wall']:.2f} s; against one process "
                  f"on each rank's rows: codes {'bit-equal' if same else 'DIFFER'}, waves max abs err {err:.2e} "
                  f"(limit {WAVE_TOL:.0e}); rows with codes equal to the b8 call's "
                  f"{sum(torch.equal(a, w) for a, w in zip(got['codes'], b8['codes']))} of {len(rows_b8)}; "
                  f"launches {got['launches']} [{card}]", flush=True)
            if not same or not err <= WAVE_TOL:
                fail(f"phase 11 (c) {mode} rank {r}: codes equal {same}, waves {err}")
            if on_card:
                expect_launches(f"phase 11 (c) {mode} rank {r}", got["launches"], paths[mode])
                steps = got["launches"]["int8_matmul"]
                if mode == "fused" and got["launches"]["fused_layer_decode_step"] != got["depth"] * steps:
                    fail(f"phase 11 (c) fused rank {r}: kernel 7 launched {got['launches']} times, "
                         f"want {got['depth']} x {steps}")
    out["c"] = {mode: {"rank_s": [r["c"][mode]["wall"] for r in ranks], "one_b4_s": one[mode]["wall"],
                       "one_b8_s": whole[mode]["wall"],
                       "rows_equal_b8": sum(torch.equal(a, w) for a, w in zip(one[mode]["codes"], whole[mode]["codes"]))}
                for mode in ("int8", "fused")}
    out["c"]["probe"] = probe

    # (e) GenerationServer over the dp=2 mesh against one process's server
    front = ranks[0]["e"]
    same = [len(r["e"]["codes"]) == len(one_server["codes"])
            and all(torch.equal(a, b) for a, b in zip(r["e"]["codes"], one_server["codes"])) for r in ranks]
    errs = [float(np.abs(a - b).max()) for a, b in zip(front["waves"], one_server["waves"])]
    print(f"phase 11 (e): GenerationServer over make_mesh(dp=2), fused, buckets [2, 4]: {len(SERVER_REQUESTS)} text "
          f"requests in batches of rows {[c.shape[0] for c in front['codes']]}, {front['wall']:.2f} s on the "
          f"front ({one_server['wall']:.2f} s one process); codes bit-equal to one process's server on ranks "
          f"{same}, waves max abs err {max(errs):.2e} (limit {ROW_WAVE_TOL:.0e}); both ranks stopped [{card}]",
          flush=True)
    if not all(same) or not max(errs) <= ROW_WAVE_TOL or [r["e"]["front"] for r in ranks] != [True, False]:
        fail(f"phase 11 (e): the mesh server differs from one process: codes {same}, waves {errs}")
    out["e"] = {"front_s": front["wall"], "one_process_s": one_server["wall"], "wave_err": max(errs)}
    print(f"phase 11: {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    return out


# phase 12: the PANN towers at b4 x 10 s and HTSAT-base / -large at b1 x 10 s
# at 48 kHz, the CLIP text tower at b8 x 77; reranking and ClapModule on a
# PANN-14 musiclm_small; the profiling hooks around one generate
PANN_PRESETS = ("PANN-14", "PANN-10", "PANN-6")
TRACE_RANGE = "phase12_generate"
KERNEL7_SYMBOL = "fused_layer_kernel"


def clap_options_phase(torch, omt_config, dev, card, counters, expect, windows, stream_ms,
                       model_config: Path = None) -> dict:
    """Phase 12: the CLAP options and the profiling hooks. (a) PANN Cnn14,
    Cnn10 and Cnn6 with the audio projection, b4 x 10 s at 48 kHz, float32
    on the card against the CPU (the tower's embedding within TOWER_REL x
    max, the unit-norm joint embedding within TOWER_ABS), each timed beside
    its bound; (b) HTSAT-base and HTSAT-large b1 x 10 s, and the CLIP text
    tower at its preset geometry (77 x 512, 12 layers) at b8, likewise; (c)
    musiclm_small (``model_config``) built by load.create_musiclm_from_config
    with clap_rvq_cfg.amodel_type "PANN-14" and generate_top_match(2 prompts
    x 2 samples, 4 s) in "fused": sims in [-1, 1], exactly kernels 1, 4 and
    7, its wall and PANN's share of it; its second generate under
    profiling.trace and profiling.annotate, the written trace read back
    (the annotated range and kernel 7's symbol in it, its CUDA kernel events
    counted) and profiling.device_memory_stats' peak; (d) ClapModule's
    get_text_embedding, get_audio_embedding_from_data (10 s clips and a 7 s
    one, repeat-padded) and get_audio_embedding_from_filelist (two seeded
    WAVs, 44.1 kHz x 7 s and 48 kHz x 12 s) on the card against the CPU.
    Returns the reranking run's launches."""
    import dataclasses

    from open_musiclm_torch import load as omt_load
    from open_musiclm_torch import profiling
    from open_musiclm_torch.data.audio_io import write_wav
    from open_musiclm_torch.models.clap.clap import Projection, l2_normalize
    from open_musiclm_torch.models.clap.clip_text import ClipTextConfig, ClipTextTransformer
    from open_musiclm_torch.models.clap.hook import ClapModule
    from open_musiclm_torch.models.clap.htsat import HTSAT
    from open_musiclm_torch.models.clap.model_configs import audio_config_from_name
    from open_musiclm_torch.models.clap.pann import EMBED_DIM, PANN
    from open_musiclm_torch.models.clap.roberta import init_normal_
    from open_musiclm_torch.models.musiclm import MusicLM
    from open_musiclm_torch.models.stages import Stage

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def card_vs_cpu(what, cpu_model, run, x, outs):
        """``run(model, x)`` -> tuple of outputs, on the CPU and on a copy of
        the model on the card; each output held to the CPU's within its
        (relative, absolute) tolerance in ``outs``; the card's stream ms and
        the bound of one run."""
        gpu_model = copy.deepcopy(cpu_model).to(dev)
        x_d = x.to(dev)
        with torch.no_grad():
            want = run(cpu_model, x)
            got = [t.cpu() for t in run(gpu_model, x_d)]
        errs = []
        for (label, rel), w, g in zip(outs, want, got):
            err = (g.float() - w.float()).abs().max().item()
            tol = rel * (w.abs().max().item() if label != "unit-norm" else 1.0)
            errs.append(f"{label} {tuple(w.shape)} max_abs_err {err:.3e} tol {tol:.3e}")
            if not (err <= tol and torch.isfinite(g).all()):
                fail(f"phase 12: {what} {label} differs on the card: {err} > {tol}")
        ms = stream_ms(lambda: run(gpu_model, x_d), reps=5)
        flops, params = tower_cost(torch, gpu_model, lambda: run(gpu_model, x_d))
        return gpu_model, errs, ms, flops, params

    def mel_flops(cfg, rows, samples):
        frames = 1 + samples // cfg.hop_size
        return rows * frames * (2.5 * cfg.window_size_fft * math.log2(cfg.window_size_fft)
                                + 2 * (cfg.window_size_fft // 2 + 1) * cfg.mel_bins)

    # a. PANN + the audio projection, b4 x 10 s at 48 kHz
    clips = torch.cat([seeded_prime(200 + i, 10, 48000) for i in range(4)])
    tower_ms = {}
    for i, name in enumerate(PANN_PRESETS):
        cfg = audio_config_from_name(name)
        g = torch.Generator().manual_seed(50 + i)
        tower = torch.nn.ModuleDict({"tower": PANN(cfg, generator=g), "proj": Projection(EMBED_DIM[cfg.arch])})
        init_normal_(tower["proj"], g)

        def run(m, x):
            emb = m["tower"](x)["embedding"]
            return emb, l2_normalize(m["proj"](emb))

        _, errs, ms, flops, params = card_vs_cpu(name, tower.eval(), run, clips,
                                                 (("embedding", TOWER_REL), ("unit-norm", TOWER_ABS)))
        flops += mel_flops(cfg, 4, clips.shape[1])
        b_ms, b_by = bound_ms(params + clips.numel() * 4, flops, "float32")
        tower_ms[name] = ms
        print(f"phase 12: {name} ({cfg.arch}) + projection b4 x 10 s float32, card vs CPU: {'; '.join(errs)}; "
              f"{ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}; {flops / 4e9:.1f} GFLOP a clip, "
              f"{flops / 1e9 / ms:.2f} TFLOP/s) [{card}]", flush=True)
        del tower

    # b. HTSAT-base / -large b1 x 10 s; the CLIP text tower b8 x 77
    for i, name in enumerate(("HTSAT-base", "HTSAT-large")):
        cfg = audio_config_from_name(name)
        tower = HTSAT(cfg, generator=torch.Generator().manual_seed(60 + i)).eval()
        _, errs, ms, flops, params = card_vs_cpu(name, tower, lambda m, x: (m(x)["embedding"],), clips[:1],
                                                 (("embedding", TOWER_REL),))
        flops += mel_flops(cfg, 1, clips.shape[1])
        b_ms, b_by = bound_ms(params + clips[:1].numel() * 4, flops, "float32")
        print(f"phase 12: {name} b1 x 10 s float32, card vs CPU: {'; '.join(errs)}; {ms:.3f} ms, bound "
              f"{b_ms:.3f} ms ({b_by}; {flops / 1e9:.1f} GFLOP, {flops / 1e9 / ms:.2f} TFLOP/s) [{card}]", flush=True)
        del tower
    ccfg = ClipTextConfig()
    g = torch.Generator().manual_seed(70)
    ids = torch.randint(1, ccfg.vocab_size - 2, (8, ccfg.context_length), generator=g)
    for r in range(8):  # <start_of_text> ... <end_of_text>, then zeros
        end = 5 + 9 * r
        ids[r, 0], ids[r, end], ids[r, end + 1:] = ccfg.vocab_size - 2, ccfg.vocab_size - 1, 0
    text_tower = ClipTextTransformer(ccfg, 512, generator=g).eval()
    _, errs, ms, _, _ = card_vs_cpu("CLIP text tower", text_tower, lambda m, x: (m(x),), ids,
                                    (("projected feature", TOWER_REL),))
    # a layer: q/k/v/out and the 4x MLP (24 b n w^2), causal scores and p v
    # (2 b n^2 w); the projection; read: the weights but the token table, whose
    # b n rows are gathered
    b, n, w = *ids.shape, ccfg.width
    flops = ccfg.layers * (24 * b * n * w * w + 2 * b * n * n * w) + 2 * b * (w * 512 + 512 * 512)
    params = sum(p.numel() * 4 for name, p in text_tower.named_parameters() if name != "token_embedding.weight")
    b_ms, b_by = bound_ms(params + b * n * w * 4 + ids.numel() * 8, flops, "float32")
    print(f"phase 12: CLIP text tower (77 x 512, 12 layers) b8 float32, card vs CPU: {'; '.join(errs)}; "
          f"{ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}; {flops / 1e9:.1f} GFLOP) [{card}]", flush=True)
    del text_tower

    # c. reranking on musiclm_small with a PANN-14 CLAP, "fused"
    mc = omt_config.load_model_config(str(model_config or ROOT / "configs" / "model" / "musiclm_small.json"))
    mc = dataclasses.replace(mc, clap_rvq_cfg=dataclasses.replace(mc.clap_rvq_cfg, amodel_type="PANN-14"))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        write_demo_vocab(Path(tmp))
        musiclm = omt_load.create_musiclm_from_config(mc, seed=12, device=dev, tokenizer_path=tmp)
    clap = musiclm.clap
    if not (isinstance(clap.model.audio_branch, PANN) and clap.model.audio_branch.cfg.arch == "Cnn14"
            and (clap.sample_rate, clap.clip_samples) == (48000, 480000)):
        fail("phase 12: create_musiclm_from_config did not build a PANN-14 CLAP at 48 kHz x 10 s")
    print(f"phase 12: musiclm_small with amodel_type PANN-14 built in {time.perf_counter() - t0:.1f} s", flush=True)
    fused = {f"{name}_stage": Stage(st.model.to(torch.bfloat16), name=st.name, quantized=True, flash_kv="fused")
             for name, st in (("semantic", musiclm.semantic_stage), ("coarse", musiclm.coarse_stage),
                              ("fine", musiclm.fine_stage))}
    ranker = MusicLM(codec=musiclm.codec, clap=clap, tokenizer=musiclm.tokenizer, **fused)
    tower_s, profs, gen_s = [0.0], [], []
    audio_embedding, generate = clap.audio_embedding, ranker.generate

    def timed_embedding(wav):
        sync()
        t0 = time.perf_counter()
        out = audio_embedding(wav)
        sync()
        tower_s[0] += time.perf_counter() - t0
        return out

    def traced_second(**kw):
        sync()
        t0 = time.perf_counter()
        if not profs:
            profs.append(None)
            out = generate(**kw)
        else:
            with profiling.trace(trace_dir) as prof, profiling.annotate(TRACE_RANGE):
                out = generate(**kw)
            profs.append(prof)
        sync()
        gen_s.append(time.perf_counter() - t0)
        return out

    gen = torch.Generator(device=dev).manual_seed(12)
    with tempfile.TemporaryDirectory() as trace_dir:
        clap.audio_embedding, ranker.generate = timed_embedding, traced_second
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        sync()
        t0 = time.perf_counter()
        samples, sims = ranker.generate_top_match(text=list(PROMPTS[:2]), num_samples=2, num_top_matches=2,
                                                  generator=gen, output_seconds=4.0, **windows)
        sync()
        wall = time.perf_counter() - t0
        launches = {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}
        del clap.audio_embedding, ranker.generate
        events = json.loads(Path(profs[1].trace_path).read_text())["traceEvents"]
    print(f"phase 12: generate_top_match(2 prompts x 2 samples, 4 s) flash_kv=fused, PANN-14 CLAP: sims "
          f"{[round(float(x), 5) for sim in sims for x in sim]}, {wall:.2f} s wall: the first generate "
          f"{gen_s[0]:.2f} s, the second under the profiler {gen_s[1]:.2f} s (the trace written); PANN-14 (2 "
          f"calls at b2) {tower_s[0]:.3f} s = {100 * tower_s[0] / wall:.1f} % of it [{card}]", flush=True)
    for sample, sim in zip(samples, sims):
        if tuple(sample.shape) != (2, 96000) or tuple(sim.shape) != (2,) or not torch.isfinite(sample.float()).all():
            fail(f"phase 12: reranking sample {tuple(sample.shape)} (want (2, 96000)), sims {tuple(sim.shape)}")
        if not (sim.abs() <= 1.0 + 1e-6).all():
            fail(f"phase 12: similarity {sim.tolist()} outside [-1, 1]")
    expect("phase 12 reranking (PANN-14), flash_kv=fused", launches,
           {"prefill_attention", "int8_matmul", "fused_layer_decode_step"})

    # e. the profiling hooks: the trace of the second generate
    names = [e.get("name", "") for e in events]
    kernels = [n for e, n in zip(events, names) if e.get("cat") == "kernel"]
    k7 = sum(KERNEL7_SYMBOL in n for n in kernels)
    stats = profiling.device_memory_stats()
    peak = (stats.get(str(torch.device("cuda", dev.index or 0))) or {}).get("allocated_bytes.all.peak", 0)
    print(f"phase 12: trace of the second generate: {len(events)} events, {len(kernels)} CUDA kernel events, "
          f"{k7} of kernel 7 ({KERNEL7_SYMBOL}), range {TRACE_RANGE!r} {'found' if TRACE_RANGE in names else 'missing'}"
          f"; device_memory_stats peak {peak / 2**30:.2f} GiB [{card}]", flush=True)
    if TRACE_RANGE not in names:
        fail(f"phase 12: the annotated range {TRACE_RANGE} is not in the trace")
    if on_card and not (k7 > 0 and peak > 0):
        fail(f"phase 12: the trace holds {k7} kernel-7 events, device_memory_stats a peak of {peak}")

    # d. ClapModule on the card against the CPU
    tok = musiclm.tokenizer
    cpu_model = copy.deepcopy(clap.model).cpu()
    kw = dict(sample_rate=clap.sample_rate, clip_samples=clap.clip_samples)
    hook, hook_cpu = ClapModule(model=clap.model, tokenizer=tok, **kw), ClapModule(model=cpu_model, tokenizer=tok, **kw)
    text = hook.get_text_embedding(list(PROMPTS[:4]))
    err = (text.cpu() - hook_cpu.get_text_embedding(list(PROMPTS[:4]))).abs().max().item()
    lines = [f"get_text_embedding b4 {err:.3e} (tol {TEXT_EMB_TOL:.0e})"]
    if text.device.type != dev.type or not err <= TEXT_EMB_TOL:
        fail(f"phase 12: ClapModule text embeddings on {text.device}: {err} > {TEXT_EMB_TOL}")
    with tempfile.TemporaryDirectory() as tmp:
        paths = [str(Path(tmp) / f"clip{i}.wav") for i in range(2)]
        for path, (sec, hz), seed in zip(paths, ((7.0, 44100), (12.0, 48000)), (210, 211)):
            write_wav(path, seeded_prime(seed, sec, hz)[0].numpy(), hz)
        for label, call, arg in (("get_audio_embedding_from_data b2 x 10 s", "get_audio_embedding_from_data",
                                  clips[:2]),
                                 ("get_audio_embedding_from_data b1 x 7 s (repeat-pad)",
                                  "get_audio_embedding_from_data", clips[2:, :7 * 48000]),
                                 ("get_audio_embedding_from_filelist (2 WAVs)", "get_audio_embedding_from_filelist",
                                  paths)):
            got = getattr(hook, call)(arg)
            err = (got.cpu() - getattr(hook_cpu, call)(arg)).abs().max().item()
            lines.append(f"{label} {err:.3e}")
            if got.device.type != dev.type or not err <= TOWER_ABS:
                fail(f"phase 12: ClapModule {label} on {got.device}: {err} > {TOWER_ABS}")
    print(f"phase 12: ClapModule (PANN-14, RoBERTa-base) card vs CPU: {'; '.join(lines)} (tol {TOWER_ABS:.0e})",
          flush=True)
    del musiclm, ranker, fused, clap, cpu_model, hook, hook_cpu
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# phase 13: the three tools at b8, the deviation tool over about a tenth of
# each stage's decode steps (semantic 50, coarse 30, fine 15), its fp-against-fp
# control over a twentieth (the fp decode's ~15 ms a step would hold it)
TOOLS_BATCH = 8
DEVIATION_FRACTION = 0.1
CONTROL_FRACTION = 0.05
K1, K2, K3, K4, K7 = ("prefill_attention", "flash_decode_step", "fused_ff_apply", "int8_matmul",
                      "fused_layer_decode_step")
RUNG_KERNELS = {  # each ladder rung's kernels: 1 in every prefill, 4 for the int8 logits
    "int8_weights_only": {K1, K3, K4}, "int8_w_plus_flash_bf16": {K1, K2, K3, K4},
    "int8_w_plus_flash_f32": {K1, K2, K3, K4}, "int8_w_plus_flash_int8": {K1, K2, K3, K4},
    "int8_w_plus_fused": {K1, K4, K7}, "full_stack": {K1, K2, K3, K4},
    "end_to_end_serving": {K1, K2, K3, K4}, "end_to_end_fp": {K1},
}
TRACE_KERNELS = ("kernel 1 prefill_attention", "kernel 5 attention_bwd", "kernel 6 attention_dbias")


def percentages(report):
    """Every percentage of a serving_deviation report: (where, value)."""
    for name, st in report["stages"].items():
        yield f"stages.{name}.per_step", st["per_step_token_mismatch_pct"]
        yield f"stages.{name}.rows_identical", st["free_running_rows_identical_pct"]
    for table in ("knob_attribution", "margin_sweep_full_stack"):
        for rung, row in report.get(table, {}).items():
            for name, v in row.items():
                yield f"{table}.{rung}.{name}", v
    for name, lp in report["logit_perturbation"].items():
        for g, v in lp["exceedance_pct"].items():
            yield f"logit_perturbation.{name}.{g}", v
    yield "end_to_end.rows_identical", report["end_to_end"]["rows_waveform_identical_pct"]


def tools_phase(torch, omt_config, dev, card, counters, expect, model_config: Path = None) -> dict:
    """Phase 13: the port's three tools on musiclm_small (``model_config``)
    at full width, bf16, random weights from seeds. (a)
    cli.serving_deviation.measure at b8 over DEVIATION_FRACTION of each
    stage's decode steps: first the fp-against-fp control over
    CONTROL_FRACTION (0 % mismatch, every row and wave identical, the
    logits unmoved), then the int8 stack with every ladder
    rung, the logit curve, the margin sweep and the SNR (every percentage
    in [0, 100], each rung exactly its kernels; the margin sweep at x4
    alone); (b) cli.profile_pipeline
    at b8 x 4 s, reps 1, with $OPEN_MUSICLM_FLASH_KV=fused, on (a)'s
    stages and codec; (c)
    cli.trace_train on the coarse stage at b8, one traced step (the buckets
    within 1 % of the device total; kernels 1, 5 and 6 named in it).
    Returns the phase's seconds and the trace's bucket table."""
    import os

    from open_musiclm_torch.cli import profile_pipeline, serving_deviation, trace_train

    t_phase = time.perf_counter()
    mc = omt_config.load_model_config(str(model_config or ROOT / "configs" / "model" / "musiclm_small.json"))
    parts = serving_deviation.build_parts(mc, dev)  # the bf16 stages and codec of (a) and (b)
    print(f"phase 13: bf16 stages and codec built in {time.perf_counter() - t_phase:.1f} s", flush=True)

    # (a) the deviation tool: the control, then the int8 stack
    t0 = time.perf_counter()
    control = serving_deviation.measure(mc, batch=TOOLS_BATCH, device=dev, knobs=False, margin_scales=(),
                                        step_fraction=CONTROL_FRACTION, serving=serving_deviation.FP,
                                        parts=parts, log=lambda line: None)
    for name, st in control["stages"].items():
        if st["per_step_token_mismatch_pct"] != 0.0 or st["free_running_rows_identical_pct"] != 100.0:
            fail(f"phase 13 (a): the fp-against-fp control's {name} stage moved: {st}")
    if control["end_to_end"]["rows_waveform_identical_pct"] != 100.0:
        fail(f"phase 13 (a): the fp-against-fp control's waves differ: {control['end_to_end']}")
    if any(lp["delta_rms"] != 0.0 for lp in control["logit_perturbation"].values()):
        fail(f"phase 13 (a): the fp-against-fp control's logits moved: {control['logit_perturbation']}")
    print(f"phase 13 (a): fp-against-fp control b{TOOLS_BATCH}: 0 % mismatch, 100 % rows identical in every "
          f"stage ({ {n: st['decode_steps'] for n, st in control['stages'].items()} } decode steps), waves "
          f"equal (SNR {control['end_to_end']['waveform_snr_db']} dB, the cap), "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    report = serving_deviation.measure(mc, batch=TOOLS_BATCH, device=dev, step_fraction=DEVIATION_FRACTION,
                                       margin_scales=(4.0,), parts=parts,
                                       log=lambda line: print(f"  {line}", flush=True))
    for where, v in percentages(report):
        if not 0.0 <= v <= 100.0:
            fail(f"phase 13 (a): {where} = {v} is not a percentage")
    for rung, path in RUNG_KERNELS.items():
        got = report["kernel_launches"][rung]
        expect(f"phase 13 (a) {rung}", {name: got.get(name, 0) for name in counters}, path)
    print(f"phase 13 (a): serving_deviation int8 stack b{TOOLS_BATCH}, {time.perf_counter() - t0:.1f} s "
          f"[{card}]", flush=True)
    print(json.dumps({"phase13_serving_deviation": report}), flush=True)

    # (b) profile_pipeline in "fused", picked by the environment
    t0 = time.perf_counter()
    os.environ["OPEN_MUSICLM_FLASH_KV"] = "fused"
    try:
        prof = profile_pipeline.profile(mc, batch=TOOLS_BATCH, seconds=4, int8=True, reps=1, device=dev,
                                        parts=parts)
    finally:
        del os.environ["OPEN_MUSICLM_FLASH_KV"]
    if prof["flash_kv"] != "fused" or not prof["kernel_launches"]["semantic_window_s"].get(K7):
        fail(f"phase 13 (b): the stages did not decode in 'fused': {prof['flash_kv']}, "
             f"{prof['kernel_launches']['semantic_window_s']}")
    print(f"phase 13 (b): profile_pipeline b{TOOLS_BATCH} x 4 s fused, {time.perf_counter() - t0:.1f} s [{card}]")
    print(json.dumps({"phase13_profile_pipeline": prof}), flush=True)
    del parts
    torch.cuda.empty_cache()

    # (c) trace_train: one traced coarse step
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as folder:
        path = trace_train.run(mc, stage="coarse", batch=TOOLS_BATCH, accum=1, steps=1, device=dev,
                               trace_dir=folder, results_folder=folder)
        tr = trace_train.parse(folder, top=12, steps=1, path=path, log=lambda line: print(f"  {line}"))
    total = tr["device_ms_per_step"]
    buckets = sum(tr["buckets_ms_per_step"].values())
    if not tr["on_device"] or total <= 0 or abs(buckets - total) > 0.01 * total:
        fail(f"phase 13 (c): buckets sum to {buckets} ms against the device's {total} ms")
    missing = [k for k in TRACE_KERNELS if not tr["family_launches_per_step"].get(k)]
    if missing:
        fail(f"phase 13 (c): {missing} not in the trace: {tr['family_launches_per_step']}")
    print(f"phase 13 (c): trace_train coarse b{TOOLS_BATCH}, 1 traced step: {total:.2f} ms device, span "
          f"{tr['span_ms_per_step']:.2f} ms, buckets sum {buckets:.2f} ms; kernels 1, 5, 6 "
          f"{[tr['family_launches_per_step'].get(k) for k in TRACE_KERNELS]} launches, "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    seconds = time.perf_counter() - t_phase
    print(f"phase 13: {seconds:.1f} s [{card}]", flush=True)
    return {"seconds": seconds, "trace_buckets_ms": tr["buckets_ms_per_step"]}


# phase 14: the JAX package's orbax checkpoints of a doll-house MusicLM
# (tests/orbax_fixture.py writes them with the JAX trainers, and the
# expected.npz beside them with JAX on the CPU)
ORBAX_FIXTURE = ROOT / "tests" / "torch_fixtures" / "orbax_dollhouse"
ORBAX_DIRS = {"semantic": "semantic.params", "coarse": "coarse.transformer.2.ckpt", "fine": "fine.params",
              "rvq": "clap.rvq.1.ckpt", "kmeans": "kmeans.ckpt"}
# teacher-forced logits: phase 3's 1e-4 x max|logit|; the resumed step: the
# float32 gradients of two implementations differ by ~1e-6 of their scale,
# which moves mu (0.1 g) and nu (0.01 g^2) by ~1e-6 of theirs (held to 1e-4
# x the largest |mu| / |nu| of any tensor), and a parameter by at most lr x
# that / eps (train.json's eps 1e-2): ~1e-7
ORBAX_LOGIT_TOL = 1e-4
ORBAX_MOMENT_TOL = 1e-4
ORBAX_PARAM_ATOL = 1e-6
ORBAX_SECONDS = 2  # generate's output: two semantic windows of the doll-house


def orbax_fixture_checks(torch, omt_config, dev, counters) -> dict:
    """Phase 14's comparisons on ``dev`` (also run on the CPU by
    tests/test_torch_orbax.py): every directory of ORBAX_FIXTURE read by
    orbax_io.read_orbax (timed); the three stages through load.load_stage
    (coarse: a JAX TrainState, semantic and fine: bare params), their
    teacher-forced float32 logits against JAX's; the RVQ and the centroids
    through load.load_rvq / load.load_kmeans bit for bit; and the coarse
    TrainState resumed by StageTrainer.load, one step on the .npz's batch
    against JAX's next step (params, mu, nu, count, step, loss). The kernel
    counts are set to 0 before the forwards and before the step and read
    after each. Fails the run where a check fails."""
    import numpy as np

    from open_musiclm_torch import load
    from open_musiclm_torch.models.token_cond import StageLossConfig
    from open_musiclm_torch.orbax_io import read_orbax
    from open_musiclm_torch.train.trainer import StageTrainer

    exp = np.load(ORBAX_FIXTURE / "expected.npz")
    mc = omt_config.load_model_config(str(ORBAX_FIXTURE / "model.json"))
    train = json.loads((ORBAX_FIXTURE / "train.json").read_text())
    t0 = time.perf_counter()
    trees = {name: read_orbax(ORBAX_FIXTURE / d) for name, d in ORBAX_DIRS.items()}
    read_s = time.perf_counter() - t0

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in leaves(v)]
        if isinstance(tree, list):
            return [x for v in tree for x in leaves(v)]
        return [tree] if hasattr(tree, "nbytes") else []

    decoded = sum(int(x.nbytes) for tree in trees.values() for x in leaves(tree))
    on_disk = sum(p.stat().st_size for d in ORBAX_DIRS.values() for p in (ORBAX_FIXTURE / d).rglob("*") if p.is_file())

    def reset():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    def read():
        return {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}

    stages, logit_err = {}, {}
    reset()
    for name in ("semantic", "coarse", "fine"):
        stage = stages[name] = load.load_stage(mc, name, str(ORBAX_FIXTURE / ORBAX_DIRS[name]), 0, device=dev)
        n = sum(1 for k in exp.files if k.startswith(f"{name}.ids."))
        ids = [torch.from_numpy(exp[f"{name}.ids.{j}"]).long().to(dev) for j in range(n)]
        with torch.no_grad():
            logits = stage.model(ids)
        for j, got in enumerate(logits):
            if got is None:
                continue
            want = exp[f"{name}.logits.{j}"]
            err = float(np.abs(got.float().cpu().numpy() - want).max()) / float(np.abs(want).max())
            logit_err[f"{name}.{j}"] = err
            if not err <= ORBAX_LOGIT_TOL:
                fail(f"phase 14: the {name} stage's logits {j} differ from JAX's by {err} x max|logit| "
                     f"> {ORBAX_LOGIT_TOL}")
    forward_launches = read()
    rvq = load.load_rvq(str(ORBAX_FIXTURE / ORBAX_DIRS["rvq"]), mc, None, device=dev)
    centroids = load.load_kmeans(str(ORBAX_FIXTURE / ORBAX_DIRS["kmeans"]), mc, None)
    for what, got, want in [(f"rvq.{f}", getattr(rvq, f), exp[f"rvq.{f}"]) for f in rvq._fields] + [
            ("kmeans.centroids", centroids, exp["kmeans.centroids"])]:
        if not np.array_equal(got.cpu().numpy(), want):
            fail(f"phase 14: {what} read by the port differs from JAX's")

    with tempfile.TemporaryDirectory() as folder:
        model = omt_config.init_stage(mc, "coarse", 7, device=dev).model
        trainer = StageTrainer(model=model, loss_cfg=StageLossConfig(
            tuple(train["coarse_loss_weights"]), mask_prob=train["mask_prob"]), lr=train["lr"], wd=train["wd"],
            lr_warmup=train["lr_warmup"], max_grad_norm=train["max_grad_norm"], results_folder=folder,
            stage_name="coarse", use_tensorboard=False)
        state = trainer.load(str(ORBAX_FIXTURE / ORBAX_DIRS["coarse"]))
    state.optimizer.eps = train["eps"]
    if (state.step, state.optimizer.count) != (2, 2):
        fail(f"phase 14: the resumed TrainState is at step {state.step}, count {state.optimizer.count}, want 2, 2")
    n = sum(1 for k in exp.files if k.startswith("step.batch."))
    batch = tuple(torch.from_numpy(exp[f"step.batch.{j}"][None]).long() for j in range(n))
    reset()
    state, loss = trainer.train_step(state, batch)
    step_launches = read()
    names = [k for k, _ in model.named_parameters()]
    step_err = {"loss": abs(loss.item() - float(exp["step.loss"])) / abs(float(exp["step.loss"]))}
    for part, tensors in (("mu", state.optimizer.mu), ("nu", state.optimizer.nu)):
        # on the moment's scale over all tensors: a parameter outside the
        # loss's reach (a bias softmax cancels) has a moment of rounding noise
        scale = max(float(np.abs(exp[f"step.{part}.{k}"]).max()) for k in names)
        step_err[part] = max(float(np.abs(t.cpu().numpy() - exp[f"step.{part}.{k}"]).max())
                             for k, t in zip(names, tensors)) / scale
    step_err["params"] = max(float(np.abs(v.cpu().numpy() - exp[f"step.model.{k}"]).max())
                             for k, v in model.state_dict().items())
    if not (step_err["loss"] <= 1e-4 and step_err["mu"] <= ORBAX_MOMENT_TOL and step_err["nu"] <= ORBAX_MOMENT_TOL
            and step_err["params"] <= ORBAX_PARAM_ATOL):
        fail(f"phase 14: the resumed step differs from JAX's: {step_err} (loss rtol 1e-4, mu / nu "
             f"{ORBAX_MOMENT_TOL} x max, params {ORBAX_PARAM_ATOL})")
    if (state.step, state.optimizer.count) != (int(exp["step.step"]), int(exp["step.count"])):
        fail(f"phase 14: step {state.step} / count {state.optimizer.count} after the resumed step, want "
             f"{int(exp['step.step'])} / {int(exp['step.count'])}")
    return {"read_s": read_s, "decoded_bytes": decoded, "on_disk_bytes": on_disk, "logit_err": logit_err,
            "step_err": step_err, "forward_launches": forward_launches, "step_launches": step_launches,
            "mc": mc, "stages": stages}


def orbax_phase(torch, omt_config, dev, card, counters, expect) -> dict:
    """Phase 14: the doll-house MusicLM the JAX package trained, read from
    its orbax directories on the card (orbax_fixture_checks: kernel 1 in the
    forwards, kernels 1, 5 and 6 in the resumed step, exactly); then
    MusicLM.generate on its stages in bf16 (load.load_stage, as
    create_musiclm_from_config loads them) and a seeded Encodec at b2 x
    ORBAX_SECONDS s, in "int8" (kernels 1-4) and "fused" (kernels 1, 4, 7),
    exactly those kernels each. Returns the phase's figures."""
    from open_musiclm_torch import load
    from open_musiclm_torch.models.musiclm import MusicLM

    t_phase = time.perf_counter()
    res = orbax_fixture_checks(torch, omt_config, dev, counters)
    expect("phase 14 forwards", res["forward_launches"], {"prefill_attention"})
    expect("phase 14 resumed step", res["step_launches"], {"prefill_attention", "attention_bwd", "attention_dbias"})
    mb = res["decoded_bytes"] / 1e6
    print(f"phase 14: read_orbax of the fixture's {len(ORBAX_DIRS)} JAX directories: {res['read_s'] * 1e3:.1f} ms, "
          f"{mb:.3f} MB of arrays ({res['on_disk_bytes'] / 1e6:.3f} MB on disk), {mb / res['read_s']:.1f} MB/s "
          f"(host) [{card}]", flush=True)
    print(f"phase 14: teacher-forced float32 logits against JAX's, worst "
          f"{max(res['logit_err'].values()):.2e} x max|logit| (limit {ORBAX_LOGIT_TOL}); the resumed coarse step "
          f"{res['step_err']} [{card}]", flush=True)

    mc = res["mc"]
    g = mc.global_cfg
    windows = dict(semantic_window_seconds=int(g.semantic_audio_length_seconds),
                   coarse_window_seconds=int(g.coarse_audio_length_seconds),
                   fine_window_seconds=int(g.fine_audio_length_seconds))
    bf16 = torch.bfloat16
    stages = {name: load.load_stage(mc, name, str(ORBAX_FIXTURE / ORBAX_DIRS[name]), 0, device=dev, dtype=bf16)
              for name in ("semantic", "coarse", "fine")}
    codec = omt_config.build_encodec(mc, generator=torch.Generator().manual_seed(4), device=dev).to(bf16)
    codec.decoder.lstm.float()  # the LSTM stem recurs in float32 (see models/encodec.py)
    clap = torch.randint(0, mc.clap_rvq_cfg.codebook_size, (2, mc.clap_rvq_cfg.rq_num_quantizers, 1),
                         generator=torch.Generator().manual_seed(5)).to(dev)
    generated = {}
    for mode, path in (("int8", {"prefill_attention", "flash_decode_step", "fused_ff_apply", "int8_matmul"}),
                       ("fused", {"prefill_attention", "int8_matmul", "fused_layer_decode_step"})):
        musiclm = MusicLM(codec=codec, **{f"{name}_stage": dataclasses.replace(st, quantized=True, flash_kv=mode)
                                          for name, st in stages.items()})
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wave = musiclm.generate(clap_token_ids=clap, generator=torch.Generator(device=dev).manual_seed(6),
                                output_seconds=ORBAX_SECONDS, **windows)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}
        want = (2, ORBAX_SECONDS * codec.sample_rate)
        if tuple(wave.shape) != want or not torch.isfinite(wave.float()).all():
            fail(f"phase 14: {mode} generate gave {tuple(wave.shape)} (want {want}) or non-finite samples")
        expect(f"phase 14 generate {mode}", launches, path)
        generated[mode] = {"wall_s": wall, "launches": launches}
        print(f"phase 14: MusicLM.generate {mode} from the JAX checkpoints, b2 x {ORBAX_SECONDS} s: "
              f"{wall:.2f} s wall [{card}]", flush=True)
    seconds = time.perf_counter() - t_phase
    print(f"phase 14: {seconds:.1f} s [{card}]", flush=True)
    return {"seconds": seconds, "read_ms": res["read_s"] * 1e3, "read_mb_per_s": mb / res["read_s"],
            "decoded_mb": mb, "logit_err": res["logit_err"], "step_err": res["step_err"],
            "step_launches": res["step_launches"], "generate": generated}


def all_counters():
    """Every kernel's launch counter: name -> (wrapper, attribute)."""
    from open_musiclm_torch.ops import launches

    return dict(launches.KERNELS)


def phase_only(n: int) -> int:
    """Phase 1 (the build) and phase 8, 10, 11, 12, 13 or 14 alone."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on a card", file=sys.stderr)
        return 2
    from open_musiclm_torch import config as omt_config
    from open_musiclm_torch.ops import cuda_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    cuda_lib.build()
    cuda_lib.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    if n == 11:
        print(json.dumps({"phase11": tp_phase(torch, omt_config, dev, card, all_counters())}))
    elif n == 13:
        print(json.dumps({"phase13": tools_phase(torch, omt_config, dev, card, all_counters(), expect_launches)}))
    elif n == 14:
        print(json.dumps({"phase14": orbax_phase(torch, omt_config, dev, card, all_counters(), expect_launches)}))
    elif n in (8, 12):
        mc = omt_config.load_model_config(str(ROOT / "configs" / "model" / "musiclm_small.json"))
        g = mc.global_cfg
        windows = dict(semantic_window_seconds=int(g.semantic_audio_length_seconds),
                       coarse_window_seconds=int(g.coarse_audio_length_seconds),
                       fine_window_seconds=int(g.fine_audio_length_seconds))
        phase = large_phase if n == 8 else clap_options_phase
        launches = phase(torch, omt_config, dev, card, all_counters(), expect_launches, windows,
                         Timer(torch, dev).stream_ms)
        print(json.dumps({f"phase{n}_launches": launches}))
    else:
        phase10(torch, omt_config, dev, card, all_counters())
    return 0


def kernel4_times(root: Path) -> int:
    """Kernel 4 alone at INT8_CASES in bf16 (device and stream ms, error
    against its plain version), from the port in ``root``: another checkout,
    such as a parent commit's, timed beside this one in one call."""
    sys.path.insert(0, str(root.resolve()))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on a card", file=sys.stderr)
        return 2
    from open_musiclm_torch.ops import quant

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}\nkernel 4 from {quant.__file__}", flush=True)
    timer = Timer(torch, dev)
    g = torch.Generator().manual_seed(0)
    times = {}
    for name, b, K, N in INT8_CASES:
        wq, s = quant.quantize_weight(torch.randn(K, N, generator=g))
        wq, s = wq.to(dev), s.to(dev)
        x = torch.randn(b, K, generator=g).to(dev, torch.bfloat16)
        err = (quant.int8_matmul(x, wq, s).float() - quant.int8_matmul_plain(x.float(), wq, s)).abs().max().item()
        ms = timer.both_ms(lambda: quant.int8_matmul(x, wq, s))
        times[f"{name} b{b} {K}x{N}"] = ms[1]
        print(f"  kernel 4 {name} b{b} {K}x{N} bf16: device {ms[1]:.4f} ms, stream {ms[0]:.4f} ms, "
              f"max abs err {err:.3e} [{card}]", flush=True)
    print(json.dumps({"kernel4_device_ms": times, "root": str(root)}))
    return 0


def probe_only() -> int:
    """Phase 1 (the build) and ``invariance_probe`` alone."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on a card", file=sys.stderr)
        return 2
    from open_musiclm_torch.ops import cuda_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    cuda_lib.build()
    cuda_lib.lib()
    print(json.dumps({"probe": invariance_probe(torch, torch.device("cuda"), card)}))
    return 0


def cost_times(root: Path) -> int:
    """What batch invariance costs, from the port in the checkout ``root``
    (another commit's, such as the parent's, timed beside this one in one
    call), bf16 at the shipped widths: kernel 2's device and stream ms (8
    heads over int8 rows of N 1280 at pos 1279, b 1, 8 and 16; 16 heads at
    musiclm_large's N 2816, pos 2765, b 1), kernel 7's (musiclm_small's
    layer at N 1280, pos 1279, b 1, 2 and 8; musiclm_large's at N 2816, pos
    2765, b 1), kernel 4's on the logit head at 8-256 rows (the fine stage's
    rows are batch x windows), Encodec's decode of b8 x 4 s (float32, wall
    ms), the semantic stage's decode step at b8 in each mode (phase 4's
    method: 48 steps less 16, over 32, unprofiled) and the prefill's ms at
    b8 (the semantic stage's 14 positions, the coarse stage's 214 of a
    first window) at musiclm_small's width. Prints one JSON line."""
    sys.path.insert(0, str(root.resolve()))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on a card", file=sys.stderr)
        return 2
    from open_musiclm_torch import config as omt_config
    from open_musiclm_torch.core.sequence import TokenSequenceSpec
    from open_musiclm_torch.models.musiclm import MusicLM
    from open_musiclm_torch.models.stages import Stage
    from open_musiclm_torch.models.token_cond import TokenConditionedTransformer
    from open_musiclm_torch.ops import attention, cuda_lib, decode_attention, fused_layer, quant

    dev, card = torch.device("cuda"), card_line()
    cuda_lib.build()
    cuda_lib.lib()
    print(f"card: {card}\ncost of the port in {decode_attention.__file__}", flush=True)
    timer = Timer(torch, dev)
    g = torch.Generator().manual_seed(171)
    out = {}

    def int8_cache(b, N, heads):
        kq, ks = decode_attention.quantize_kv_row(attention.l2norm(torch.randn(b, N, 64, generator=g).to(dev)))
        vq, vs = decode_attention.quantize_kv_row(torch.randn(b, N, 64, generator=g).to(dev))
        return (torch.cat([kq, vq], -1).contiguous(), torch.stack([ks, vs]).contiguous(),
                torch.randn(N, heads, generator=g).to(dev), torch.zeros(b, N, device=dev))

    for b, heads, N, pos in ((1, 8, 1280, 1279), (8, 8, 1280, 1279), (16, 8, 1280, 1279), (1, 16, 2816, 2765)):
        q = attention.l2norm(torch.randn(b, heads, 64, generator=g).to(dev, torch.bfloat16))
        kv, kvs, row, add = int8_cache(b, N, heads)
        ms = timer.both_ms(lambda: decode_attention.flash_decode_step(q, kv, pos, row, add, kvs))
        out[f"kernel 2 b{b} h{heads} N{N} pos {pos}"] = {"stream_ms": ms[0], "device_ms": ms[1]}
    for heads, cases in ((8, ((1, 1279, 1280), (2, 1279, 1280), (8, 1279, 1280))), (16, ((1, 2765, 2816),))):
        layer = TokenConditionedTransformer((TokenSequenceSpec(1024, 1),), 1024, 1, heads=heads,
                                            generator=torch.Generator().manual_seed(5)).to(dev).eval()
        packed = fused_layer.pack_layer_weights(layer.transformer.attns[0], layer.transformer.ffs[0])
        inner = layer.transformer.ffs[0].inner_dim
        for b, pos, N in cases:
            kv, kvs, row, add = int8_cache(b, N, heads)
            x = torch.randn(b, 1024, generator=g).to(dev, torch.bfloat16)
            st = torch.randn(b, 2, 2 * inner, generator=g).to(dev, torch.bfloat16)
            ms = timer.both_ms(lambda: fused_layer.fused_layer_decode_step(x, packed, kv, kvs, st, pos, row, add,
                                                                           heads=heads))
            out[f"kernel 7 b{b} h{heads} N{N} pos {pos}"] = {"stream_ms": ms[0], "device_ms": ms[1]}
        del layer, packed
    wq, sc = quant.quantize_weight(torch.randn(1024, 1025, generator=g))
    wq, sc = wq.to(dev), sc.to(dev)
    for b in (8, 14, 16, 24, 32, 56, 64, 128, 256):
        x = torch.randn(b, 1024, generator=g).to(dev, torch.bfloat16)
        ms = timer.both_ms(lambda: quant.int8_matmul(x, wq, sc))
        out[f"kernel 4 head b{b}"] = {"stream_ms": ms[0], "device_ms": ms[1]}
    timer.release()
    mc = omt_config.load_model_config(str(ROOT / "configs" / "model" / "musiclm_small.json"))
    decoder = MusicLM.__new__(MusicLM)  # only its Encodec decode
    decoder.codec = omt_config.build_encodec(mc, generator=torch.Generator().manual_seed(4), device=dev)
    codes = torch.randint(0, 1024, (8, 300, 8), generator=g).to(dev)
    walls = []
    with torch.no_grad():
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            decoder._decode_rows(codes)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    out["encodec _decode_rows b8 x 300 frames f32 ms"] = statistics.median(walls[2:]) * 1e3
    del decoder
    sem = omt_config.init_stage(mc, "semantic", 1, device=dev, dtype=torch.bfloat16).model
    coarse = omt_config.init_stage(mc, "coarse", 2, device=dev, dtype=torch.bfloat16).model
    clap = torch.randint(0, 1024, (8, 12), generator=g).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
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
        out[f"semantic decode step b8 {mode.get('flash_kv') if mode['quantized'] else 'fp'}"] = \
            (walls[1] - walls[0]) / 32 * 1e3
    semantic = torch.randint(0, 1024, (8, 199), generator=g).to(dev)
    for name, model, ids in (("semantic", sem, [clap]), ("coarse", coarse, [clap, semantic])):
        stream = model.assemble_stream(ids + [torch.zeros((8, 0), dtype=torch.long, device=dev)])
        walls = []
        with torch.no_grad():
            for _ in range(12):
                cache = model.transformer.init_cache(8, stream.shape[1])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model.transformer.prefill(stream, cache)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
        out[f"{name} prefill b8 n{stream.shape[1]} ms"] = statistics.median(walls[2:]) * 1e3
    print(json.dumps({"cost": out, "root": str(root), "card": card}), flush=True)
    return 0


def phase9_only() -> int:
    """Phase 1 (the build) and phase 9 alone, with the training kernels'
    counts (kernels 1, 5 and 6)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on a card", file=sys.stderr)
        return 2
    from open_musiclm_torch import config as omt_config
    from open_musiclm_torch.ops import attention, cuda_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    cuda_lib.build()
    cuda_lib.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    bwd = attention.shared_kv_attention_bwd
    counters = {"prefill_attention": (attention.shared_kv_attention_fused, "launches"),
                "attention_bwd": (bwd, "launches"), "attention_dbias": (bwd, "dbias_launches")}
    print(json.dumps({"phase9_launches": raw_audio_phase(torch, omt_config, torch.device("cuda"), card, counters)}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--kernel4":
        sys.exit(kernel4_times(Path(sys.argv[2])))
    if len(sys.argv) == 3 and sys.argv[1] == "--cost":
        sys.exit(cost_times(Path(sys.argv[2])))
    if len(sys.argv) == 2 and sys.argv[1] == "--probe":
        sys.exit(probe_only())
    if len(sys.argv) == 2 and sys.argv[1] == "--phase9":
        sys.exit(phase9_only())
    if len(sys.argv) == 2 and sys.argv[1] in ("--phase8", "--phase10", "--phase11", "--phase12", "--phase13",
                                              "--phase14"):
        sys.exit(phase_only(int(sys.argv[1][len("--phase"):])))
    if len(sys.argv) == 8 and sys.argv[1] == "--dp_rank":
        sys.exit(dp_rank_main(int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:]))
    if len(sys.argv) == 7 and sys.argv[1] == "--tp_rank":
        sys.exit(tp_rank_main(int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:]))
    sys.exit(main())
