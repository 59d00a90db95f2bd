"""Stage training: ``StageTrainer.train_step`` called step after step on
seeded token batches, as a training job runs it.

Traffic parameters (``benchmark/traffic/<mix>.json``, kind "train"):
``stage``; ``lengths``, the tokens of each sequence of an example (before
EOS); ``batch`` and ``accum``, rows a micro-batch and micro-batches a step;
``compute_dtype`` of the pass on float32 master weights; ``trainer``:
StageTrainer's settings (learning rate, warmup, decay, clip, loss weights,
forgetful-mask rate); ``check_steps``, the first steps the reference
follows.

Set-up builds the trainer and its state once and takes the first
``check_steps`` steps through ``train_step`` (they also warm every shape);
the window then carries on with the same objects (a traced run traces its
first ``trace_seconds``). Each step's rows are new
draws from the seed, and each step ends when its loss reaches the host, as a
training loop that logs its loss does. ``train_tokens_per_s`` is the tokens
of every sequence of every step over the whole window.

The check: the reference (float32, TF32 off) follows the first steps from
the same weights, batches and random draws (the forgetful mask and the FF
dropout drawn from a generator seeded alike, in the model's order): each
step's loss, each parameter's gradient norm as the optimizer took it after
one step (its first moment over 1 - b1), and each parameter's change after
the checked steps, the last two by the worst leaf against the reference's
norm of that leaf or of the median leaf, whichever is larger. A leaf whose
reference gradient is under a thousandth of the median leaf's moves under
Adam by round-off alone and is left out of the change.
"""

from __future__ import annotations

import shutil
import statistics
import sys
import tempfile
import time
from typing import Dict, List

import torch

from .. import system
from .. import weights as W
from ..flops import stage_train_flops
from ..reference.optimizer import AdamWReference
from ..reference.stage import StageReference
from ..trace import Trace
from .common import Context, Outcome, free, judge, memory_peak, reference_mode

B1 = 0.9  # the optimizer's first-moment decay


def batches(ctx: Context, specs, device):
    """The seeded batches, one tuple of [accum, B, n_i] id tensors a step."""
    tr = ctx.traffic
    gen = W.generator(ctx.seed, "batches", device)
    while True:
        yield tuple(torch.randint(0, cb, (tr["accum"], tr["batch"], n), generator=gen, device=device)
                    for (cb, _), n in zip(specs, tr["lengths"]))


def run(ctx: Context) -> Outcome:
    from open_musiclm_torch.models.token_cond import StageLossConfig
    from open_musiclm_torch.train.trainer import StageTrainer

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    tcfg = tr["trainer"]
    model, shapes = system.build_stage_model(cfg, tr["stage"], ctx.seed, dev, train=True)
    model.compute_dtype = system.DTYPES[tr["compute_dtype"]]
    dims = system.stage_dims(model)
    ff_dropout = cfg["model"][f"{tr['stage']}_cfg"]["ff_dropout"]
    results = tempfile.mkdtemp(prefix="bench_train_")  # train_step writes nothing there
    trainer = StageTrainer(
        model=model, loss_cfg=StageLossConfig(tuple(tcfg["cross_entropy_loss_weights"]), mask_prob=tcfg["mask_prob"]),
        lr=tcfg["lr"], wd=tcfg["wd"], lr_warmup=tcfg["lr_warmup"], max_grad_norm=tcfg["max_grad_norm"],
        grad_accum_every=tr["accum"], results_folder=results,
        use_tensorboard=False, stage_name=tr["stage"])
    state = trainer.init_state()
    shutil.rmtree(results)
    drops = W.generator(ctx.seed, "dropout", dev)
    feed = batches(ctx, dims["specs"], dev)

    losses: List[float] = []
    grad_norms = None
    for s in range(tr["check_steps"]):
        state, loss = trainer.train_step(state, next(feed), drops)
        losses.append(loss.item())
        if s == 0:
            grad_norms = torch.stack([m.norm() for m in state.optimizer.mu]).cpu() / (1 - B1)
    after = [p.detach().to("cpu", copy=True) for p in model.parameters()]
    ctx.sync()
    setup_s = ctx.since_start()

    tracer = Trace(ctx.trace)
    tracer.start()
    steps = 0
    t0 = time.perf_counter()
    traced_steps, t_traced = None, None
    while time.perf_counter() - t0 < ctx.seconds:
        if t_traced is None and time.perf_counter() - t0 >= tr.get("trace_seconds", ctx.seconds):
            traced_steps, t_traced = steps, time.perf_counter()  # the last loss has synchronised
            tracer.stop()
        state, loss = trainer.train_step(state, next(feed), drops)
        loss.item()
        steps += 1
    window_s = time.perf_counter() - t0
    if t_traced is None:
        traced_steps, t_traced = steps, time.perf_counter()
        tracer.stop()
    peak = memory_peak(ctx)
    t_read = time.perf_counter()
    summary = tracer.summary()
    t_read = time.perf_counter() - t_read
    tokens = steps * tr["accum"] * tr["batch"] * sum(tr["lengths"])
    layer = {"window_s": t_traced - t0, "trace": summary, "steps": traced_steps,
             "flops_per_step": stage_train_flops(dims, tr["lengths"], tr["batch"], tr["accum"])}

    del trainer, state, model, feed
    free(ctx)
    t_check = time.perf_counter()
    reference_mode(ctx)
    prog = {"loss": losses, "grad": grad_norms, "after": after}
    names = [n for n, _ in shapes]
    ref = follow(ctx, shapes, dims, ff_dropout, "fp32")
    numbers = compare(prog, ref, names)
    control = None
    if ctx.control:
        ctl = follow(ctx, shapes, dims, ff_dropout, "fp8")
        control = compare({"loss": ctl["loss"], "grad": ctl["grad"], "after": ctl["after"]}, ref, names)
    print(f"train: {steps} steps in {window_s:.3f} s; losses {losses} (reference {ref['loss']}); "
          f"trace read {t_read:.1f} s, check {time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    correct, checks = judge(numbers, ctx.limits)
    return Outcome(correct=correct, attempted=steps, failed=0,
                   e2e={"train_tokens_per_s": tokens / window_s, "setup_s": setup_s}, layer=layer,
                   memory_peak_bytes=peak, checks=checks, trace=summary, window_s=t_traced - t0,
                   control=control)


def follow(ctx: Context, shapes, dims, ff_dropout: float, precision: str) -> Dict:
    """The reference through the first steps: losses, first clipped
    gradient norms per leaf, the parameters after the steps, and the start."""
    tr, dev = ctx.traffic, ctx.device
    tcfg = tr["trainer"]
    start = W.draw(shapes, ctx.seed, f"stage:{tr['stage']}", dev, system.DTYPES[ctx.config["stage_dtype"]])
    ref = StageReference(start, dims["specs"], dims["depth"], dims["heads"], dims["dim_head"],
                         precision=precision, train=True, grad_shrink=dims["grad_shrink"])
    leaves = [ref.w[n] for n, _ in shapes]
    opt = AdamWReference(leaves, tcfg["lr"], tcfg["wd"], tcfg["lr_warmup"], tcfg["max_grad_norm"])
    drops = W.generator(ctx.seed, "dropout", dev)
    feed = batches(ctx, dims["specs"], dev)
    out = {"loss": [], "start": [start[n].float().cpu() for n, _ in shapes]}
    for s in range(tr["check_steps"]):
        batch = next(feed)
        grads = [torch.zeros_like(p) for p in leaves]
        total = 0.0
        for a in range(tr["accum"]):
            loss = ref.loss([t[a] for t in batch], tcfg["mask_prob"], ff_dropout, drops)
            got = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [g + (0 if x is None else x) for g, x in zip(grads, got)]
            total += loss.item()
        grads = [g / tr["accum"] for g in grads]
        out["loss"].append(total / tr["accum"])
        clipped = opt.step(grads)
        if s == 0:
            out["grad"] = torch.stack([g.norm() for g in clipped]).cpu()
    out["after"] = [p.detach().cpu() for p in leaves]
    del ref, opt, leaves
    free(ctx)
    return out


def compare(prog: Dict, ref: Dict, names) -> Dict[str, float]:
    """The three numbers of a run (or of the control) against the reference."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"]))
    g_ref, g_prog = ref["grad"].double(), prog["grad"].double()
    med = statistics.median(g_ref.tolist())
    grad = float(((g_prog - g_ref).abs() / g_ref.clamp(min=med)).max())
    moved = g_ref >= 1e-3 * med  # leaves the optimizer moves by more than round-off
    d_ref = torch.stack([(a - s).double().norm() for a, s in zip(ref["after"], ref["start"])])
    d_prog = torch.stack([(a - s).double().norm() for a, s in zip(prog["after"], ref["start"])])
    med_d = statistics.median(d_ref[moved].tolist())
    rel_d = torch.where(moved, (d_prog - d_ref).abs() / d_ref.clamp(min=med_d), torch.zeros_like(d_ref))
    rel_g = (g_prog - g_ref).abs() / g_ref.clamp(min=med)
    worst = {"grad": [(names[i], float(rel_g[i])) for i in rel_g.argsort(descending=True)[:3].tolist()],
             "change": [(names[i], float(rel_d[i])) for i in rel_d.argsort(descending=True)[:3].tolist()],
             "left_out": [names[i] for i in (~moved).nonzero()[:, 0].tolist()]}
    print(f"train: worst leaves {worst}; change of the median leaf {float(d_prog[moved].median()):.6e} "
          f"(reference {float(d_ref[moved].median()):.6e})", file=sys.stderr)
    return {"loss_rel_gap": loss, "grad_norm_gap": grad, "change_norm_gap": float(rel_d.max())}
