"""Trace stage-training steps and split their device time (port of
scripts/trace_train.py).

Runs ``--steps`` train steps of the port's ``StageTrainer`` (after two
untraced ones) under ``profiling.trace``, each step in its own
``omt:train_step`` range, then reads the written Chrome trace back and
gives: the device time a step, the gap to the steps' span on the device
(the device's idle time inside a step), the split by bucket (where in the
model each kernel was launched), by kernel family (the hand-written
kernels by name, cuBLAS GEMMs, copies, reductions, elementwise) and the
top kernels (a kernel name a bucket), each with the host op that launched
it most often. ``--parse_only`` reads the newest trace under ``--trace_dir``
again.

A CUDA kernel's name carries no model path (the JAX script matched flax
parameter paths in HLO names), so a kernel goes to the module that
launched it: the tool opens a profiler range around each attention block
(``omt:attn``), conv-FF block (``omt:ff``), the rel-pos bias MLP
(``omt:relpos``), the transformer (``omt:transformer``) and the whole stage
(``omt:model``) with forward hooks, and the trainer names its loss,
gradient sums and optimizer step (``stage_loss``, ``grad_accumulate``,
``optimizer_step``). A kernel's launch (its CUDA runtime call, by
``correlation``) lies inside those ranges on the launching thread. A
backward kernel is launched by the autograd engine inside
``autograd::engine::evaluate_function: <Node>``, whose ``Sequence number``
is that of the forward op that made the node: the kernel takes the forward
op's bucket. Buckets, first hit wins: collectives (NCCL / c10d), dropout
and RNG draws (a random op on the stack), then the innermost range:
attention, ff, relpos, plumbing (the transformer's residual stream, grad
shrink and final norm; the gradient sums; copies and memsets outside a
range), logits_loss (embeddings, stream assembly, logit heads, the loss),
optimizer; else other. The buckets sum to the device total.

On a trace of the CPU (no card) the leaf host ops stand in for kernels.

    python -m open_musiclm_torch.cli.trace_train --stage coarse --batch 32 --accum 1
    python -m open_musiclm_torch.cli.trace_train --trace_dir DIR --parse_only
"""

from __future__ import annotations

import argparse
import json
import os
import re
import tempfile
from collections import Counter, defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from .common import REPO_ROOT

STEP_RANGE = "omt:train_step"
RANGE_BUCKETS = {
    "omt:attn": "attention", "omt:ff": "ff", "omt:relpos": "relpos", "omt:transformer": "plumbing",
    "omt:model": "logits_loss", "stage_loss": "logits_loss", "grad_accumulate": "plumbing",
    "optimizer_step": "optimizer",
}
BUCKETS = ("attention", "ff", "relpos", "logits_loss", "optimizer", "dropout_rng", "plumbing", "collectives",
           "other")
BACKWARD = "autograd::engine::evaluate_function:"
COLLECTIVE = re.compile(r"nccl|c10d::|all_?reduce|all_?gather|reduce_scatter|broadcast", re.I)
RANDOM = re.compile(r"^aten::(rand|randn|randint|bernoulli|uniform|normal|native_dropout|dropout)", re.I)
COPY = re.compile(r"memcpy|memset|^aten::(copy_|_to_copy|to|clone|contiguous|cat|fill_|zero_|zeros|empty)",
                  re.I)
# kernel families: the hand-written kernels by the names in csrc/, then the library's
FAMILIES = (
    ("kernel 1 prefill_attention", re.compile(r"prefill_attention_\w*kernel")),
    ("kernel 2 flash_decode_step", re.compile(r"flash_decode_kernel")),
    ("kernel 3 fused_ff_apply", re.compile(r"\bff_(in|out)_kernel")),
    ("kernel 4 int8_matmul", re.compile(r"\bstream_kernel")),
    ("kernel 6 attention_dbias", re.compile(r"\bdbias(_bf16)?_kernel")),
    ("kernel 5 attention_bwd", re.compile(r"\b(bwd_bf16|dq|dkdv|delta|sum_heads)_kernel")),
    ("kernel 7 fused_layer_decode_step", re.compile(r"fused_layer_kernel")),
    ("cuBLAS GEMM", re.compile(r"gemm|nvjet|cutlass|xmma|cublas|^aten::(mm|addmm|bmm|baddbmm|matmul|linear)$",
                               re.I)),
    ("copies", re.compile(r"memcpy|memset|copy|CatArray|^aten::(_to_copy|clone|cat|fill_|zero_)$", re.I)),
    ("reductions", re.compile(r"reduce|softmax|norm|cunn_|scan|sort|topk|"
                              r"^aten::(sum|mean|var|max|min|amax|_log_softmax|native_layer_norm)$", re.I)),
    ("elementwise", re.compile(r"elementwise|vectorized|unrolled|^aten::", re.I)),
)


def family(name: str) -> str:
    for fam, pat in FAMILIES:
        if pat.search(name):
            return fam
    return "other"


def _bucket_of_stack(stack, forward_buckets: Dict[int, str]) -> Optional[str]:
    """The innermost range of ``stack`` that names a bucket; a backward
    node's range gives its forward op's bucket."""
    for host in stack:
        name = host["name"]
        if name in RANGE_BUCKETS:
            return RANGE_BUCKETS[name]
        if name.startswith(BACKWARD):
            bucket = forward_buckets.get(host.get("args", {}).get("Sequence number"))
            if bucket is not None:
                return bucket
    return None


def classify(op, forward_buckets: Dict[int, str]) -> str:
    """The bucket of a ``profiling.DeviceOp`` (the module docstring's rules)."""
    ops = [h["name"] for h in op.stack if h.get("cat") == "cpu_op"]
    if COLLECTIVE.search(op.name) or any(COLLECTIVE.search(n) for n in ops):
        return "collectives"
    if any(RANDOM.search(n) for n in ops):
        return "dropout_rng"
    bucket = _bucket_of_stack(op.stack, forward_buckets)
    if bucket is not None:
        return bucket
    if COPY.search(op.name) or (ops and COPY.search(ops[0])):
        return "plumbing"
    return "other"


def forward_buckets(trace_events: List[dict]) -> Dict[int, str]:
    """Sequence number -> bucket of every forward op that made an autograd
    node (its innermost bucket range)."""
    from .. import profiling

    host = [e for e in trace_events if e.get("ph") == "X" and e.get("cat") in profiling.HOST_CATEGORIES]
    parent = profiling.host_parents(host)
    out = {}
    for i, e in enumerate(host):
        seq = e.get("args", {}).get("Sequence number")
        if e.get("cat") != "cpu_op" or seq is None or e["name"].startswith(BACKWARD):
            continue
        stack, j = [], i
        while j is not None:
            stack.append(host[j])
            j = parent[j]
        if any(h["name"].startswith(BACKWARD) for h in stack):
            continue  # a node's own ops (and remat's recompute) run in the backward
        bucket = _bucket_of_stack(stack, {})
        if bucket is not None:
            out[seq] = bucket
    return out


def parse(trace_dir: str, top: int = 40, steps: int = 1, path: Optional[str] = None, log=print) -> dict:
    """Read the newest trace under ``trace_dir`` (or ``path``), print the
    tables, and return them (ms a step)."""
    from .. import profiling

    path = path or profiling.newest_trace(trace_dir)
    events = profiling.load_trace(path)
    ops, on_device = profiling.device_ops(events)
    fwd = forward_buckets(events)
    step_ranges = [e for e in events  # the host's ranges (the card's timeline repeats them)
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e.get("name") == STEP_RANGE]
    n = len(step_ranges) or max(steps, 1)
    if step_ranges:  # the device ops launched inside a step
        inside = [op for op in ops if any(float(r["ts"]) <= op.launch_ts <= float(r["ts"]) + float(r["dur"])
                                          for r in step_ranges)]
    else:
        inside = ops
    per_bucket, per_family, per_kernel = defaultdict(float), defaultdict(float), defaultdict(float)
    family_count, kernel_ops = defaultdict(int), defaultdict(Counter)
    total = 0.0
    for op in inside:
        bucket = classify(op, fwd)
        fam = family(op.name)
        per_bucket[bucket] += op.dur
        per_family[fam] += op.dur
        family_count[fam] += 1
        per_kernel[(op.name, bucket)] += op.dur  # a kernel name a bucket, as the JAX script's ops
        launcher = next((h["name"] for h in op.stack if h.get("cat") == "cpu_op"), "")
        kernel_ops[(op.name, bucket)][launcher] += 1
        total += op.dur
    span = 0.0
    for r in step_ranges or [None]:
        mine = [op for op in inside if r is None
                or float(r["ts"]) <= op.launch_ts <= float(r["ts"]) + float(r["dur"])]
        if mine:
            span += max(op.ts + op.dur for op in mine) - min(op.ts for op in mine)
    ms = lambda us: us / 1e3 / n  # noqa: E731
    report = {
        "trace": path, "steps": n, "on_device": on_device,
        "device_ms_per_step": ms(total), "span_ms_per_step": ms(span), "gap_ms_per_step": ms(span - total),
        "launches_per_step": len(inside) / n,
        "buckets_ms_per_step": {b: ms(per_bucket.get(b, 0.0)) for b in BUCKETS},
        "families_ms_per_step": {f: ms(d) for f, d in sorted(per_family.items(), key=lambda kv: -kv[1])},
        "family_launches_per_step": {f: family_count[f] / n for f in per_family},
        "top": [{"ms_per_step": ms(d), "pct": 100 * d / max(total, 1e-30), "bucket": bucket,
                 "op": kernel_ops[(name, bucket)].most_common(1)[0][0], "name": name}
                for (name, bucket), d in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:top]],
    }
    what = "device kernel time" if on_device else "leaf host-op time (no device in the trace)"
    log(f"trace: {path}")
    log(f"{what} {total / 1e3:.2f} ms total, {ms(total):.2f} ms/step ({n} steps, "
        f"{report['launches_per_step']:.0f} launches/step); span on the device {ms(span):.2f} ms/step "
        f"(gap {ms(span - total):+.2f} ms/step)")
    log("\n-- bucket totals (per step) --")
    for b, d in sorted(report["buckets_ms_per_step"].items(), key=lambda kv: -kv[1]):
        log(f"{b:20s} {d:9.2f} ms  {100 * d / max(ms(total), 1e-30):5.1f}%")
    log("\n-- kernel families (per step) --")
    for f, d in report["families_ms_per_step"].items():
        log(f"{f:34s} {d:9.2f} ms  {100 * d / max(ms(total), 1e-30):5.1f}%  "
            f"{report['family_launches_per_step'][f]:8.1f} launches")
    log(f"\n-- top {top} kernels (per step) --")
    for row in report["top"]:
        log(f"{row['ms_per_step']:9.3f} ms  {row['pct']:5.1f}%  [{row['bucket']}] {row['op'][:48]}: "
            f"{row['name'][:100]}")
    return report


def instrument(model) -> list:
    """Forward hooks that open the module docstring's profiler ranges
    around the stage's blocks; returns their handles."""
    tfm = model.transformer
    named = [(model, "omt:model"), (tfm, "omt:transformer")]
    named += [(m, "omt:attn") for m in tfm.attns] + [(m, "omt:ff") for m in tfm.ffs]
    if tfm.rel_pos_bias is not None:
        named.append((tfm.rel_pos_bias, "omt:relpos"))
    handles = []
    for module, name in named:
        open_ranges = []

        def pre(_module, _args, name=name, open_ranges=open_ranges):
            rf = torch.profiler.record_function(name)
            rf.__enter__()
            open_ranges.append(rf)

        def post(_module, _args, _out, open_ranges=open_ranges):
            open_ranges.pop().__exit__(None, None, None)

        handles += [module.register_forward_pre_hook(pre), module.register_forward_hook(post)]
    return handles


def train_batch(mc, model, stage: str, batch: int, accum: int, seed: int = 0):
    """A seeded token batch ([accum, batch, n] a sequence) at the config's
    training lengths."""
    from ..config import stage_example_lengths

    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.integers(0, spec.codebook_size, (accum, batch, n)))
                 for spec, n in zip(model.specs, stage_example_lengths(mc, stage)))


def run(mc, *, stage: str = "coarse", batch: int = 32, accum: int = 1, steps: int = 3, device="cuda",
        trace_dir: Optional[str] = None, results_folder: Optional[str] = None) -> str:
    """Two untraced train steps, then ``steps`` traced ones (bf16 compute on
    float32 weights, seed 0); returns the trace's path."""
    from .. import config, profiling
    from ..models.token_cond import StageLossConfig
    from ..train.trainer import StageTrainer

    device = config.target_device(device, "trace_train")
    tmp = tempfile.gettempdir()
    st = config.init_stage(mc, stage, 0, device=device, compute_dtype=torch.bfloat16)
    trainer = StageTrainer(
        model=st.model, loss_cfg=StageLossConfig((0.0,) * (len(st.model.specs) - 1) + (1.0,)),
        lr=3e-4, wd=0.1, lr_warmup=10, max_grad_norm=0.5, grad_accum_every=accum,
        results_folder=results_folder or os.path.join(tmp, "trace_train"), save_model_every=0,
        save_results_every=0, stage_name=stage, use_tensorboard=False)
    state = trainer.init_state()
    data = train_batch(mc, st.model, stage, batch, accum)
    gen = torch.Generator(device=device).manual_seed(1)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(2):  # warm up, settle the allocator
        state, loss = trainer.train_step(state, data, gen)
    float(loss)
    handles = instrument(st.model)
    try:
        with profiling.trace(trace_dir or os.path.join(tmp, "omt_trace")) as prof:
            for _ in range(steps):
                with torch.profiler.record_function(STEP_RANGE):
                    state, loss = trainer.train_step(state, data, gen)
                    sync()
        float(loss)
    finally:
        for h in handles:
            h.remove()
    return prof.trace_path


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--stage", default="coarse")
    p.add_argument("--model_config", default=str(REPO_ROOT / "configs/model/musiclm_small.json"))
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--accum", type=int, default=1)
    p.add_argument("--steps", type=int, default=3, help="traced steps")
    p.add_argument("--trace_dir", default=os.path.join(tempfile.gettempdir(), "omt_trace"))
    p.add_argument("--parse_only", action="store_true")
    p.add_argument("--top", type=int, default=40)
    p.add_argument("--json", default=None, help="also write the tables here")
    p.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = p.parse_args(argv)

    path = None
    if not args.parse_only:
        from ..config import load_model_config

        path = run(load_model_config(args.model_config), stage=args.stage, batch=args.batch, accum=args.accum,
                   steps=args.steps, device=args.device, trace_dir=args.trace_dir)
        print(f"captured {args.steps} steps to {path}; parsing...\n")
    report = parse(args.trace_dir, args.top, args.steps, path=path)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
