"""Single-stage trainer on token batches (port of open_musiclm_tpu/train/trainer.py).

A step is the forward and backward of ``stage_training_loss`` for each of
``accum`` microbatches, the mean of their gradients and losses, then the
optimizer (global-norm clip, AdamW with warmup; train/optimizer.py).
Evaluation gives the valid loss and the token accuracy of the final
sequence. Metrics go to ``{stage}.log.jsonl``, and to TensorBoard
(``tb/{stage}`` under the results folder) and wandb where those packages
are installed (a missing package skips its sink); checkpoints are
``{stage}.transformer.{step}.ckpt``. At the ``save_results_every`` cadence
``train`` hands the valid batch to an ``artifact_fn`` (train/artifacts.py
through ``artifact_logits``).

Data parallel over a ``parallel.mesh.Mesh`` (default: the process group
``parallel.distributed.initialize_distributed`` joined, else one process):
parameters are replicated (rank 0's broadcast at ``init_state``), each rank
takes its own rows of every global batch, and after the accumulation loop
one all-reduce sums the gradients and the loss of all ranks as one flat
buffer a dtype; they are divided by the world size times ``accum`` before
the clip and the step, so every rank clips and steps on the same global
gradient, as the JAX package's psum before optax does. The mean of the
ranks' means is the global mean because the loss averages over a fixed
number of labels a micro-batch and every rank's micro-batch has the same
shape (checked each step). ``torch.autograd.grad`` takes the gradients, so
no ``DistributedDataParallel`` hook would fire: the reduction is explicit.
The eval loss and accuracy are averaged over ranks, ``artifact_logits``
gathers the ranks' rows, only rank 0 writes logs, trackers and checkpoints,
every rank waits at a barrier before it reads a checkpoint, and a SIGTERM /
SIGINT on any rank stops all of them after the same step.

Tensor parallel over the mesh's ``tp`` axis (``make_mesh(dp, tp)``):
``init_state`` gives every rank global rank 0's whole weights, then shards
the model (``parallel/sharding.py:shard_module``). After the accumulation
loop one all-reduce over ``tp`` makes whole the gradients that each rank
holds a share of (the replicated parameters of split blocks, as a flat
buffer), then the gradients and the loss are summed over ``dp`` as above;
the clip counts a split parameter's squares over all its parts once and a
replicated one's once. The ranks at d 0 gather the whole weights and
moments for a checkpoint, which keeps the unsharded layout and which rank
(d 0, t 0) writes; ``load`` reads the whole checkpoint and shards it.

Randomness (FF dropout, the forgetful causal mask) comes from an explicit
``torch.Generator`` on the model's device; with several ``dp`` ranks each
rank's should be seeded on its own (``Mesh.rank_seed``), or every rank draws
the same masks over different rows. The ranks of a ``tp`` group must draw
from the same generator state (``rank_seed`` gives them one).

``train_step`` names its loss, gradient sums and optimizer step as profiler
ranges (``stage_loss``, ``grad_accumulate``, ``optimizer_step``), which
``cli/trace_train.py`` reads from a trace.
"""

from __future__ import annotations

import dataclasses
import json
import signal
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..checkpoint import load_checkpoint, save_checkpoint
from ..convert import optax_stage_state, stage_state_dict
from ..models.token_cond import (
    StageLossConfig,
    TokenConditionedTransformer,
    stage_training_loss,
    token_accuracy,
)
from ..parallel.mesh import Mesh, make_mesh
from ..parallel.sharding import (
    gather_param_tensors,
    gather_state_dict,
    load_whole_state_dict,
    shard_module,
    shard_param_tensors,
)
from ..profiling import StepTimer
from .optimizer import StageOptimizer


@dataclasses.dataclass
class TrainState:
    """The model (its parameters are updated in place), the optimizer with
    its moments, and the number of optimizer steps taken."""

    model: TokenConditionedTransformer
    optimizer: StageOptimizer
    step: int = 0


class _PreemptionGuard:
    """Latches SIGTERM/SIGINT so the train loop can checkpoint and exit;
    ``restore`` puts the previous handlers back."""

    def __init__(self):
        self.triggered = False
        self._prev = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
            except (ValueError, OSError):
                pass  # not the main thread

    def _handler(self, signum, frame):
        self.triggered = True

    def restore(self):
        for sig, handler in self._prev.items():
            signal.signal(sig, handler)


@dataclasses.dataclass
class StageTrainer:
    """Train one stage on token batches: per step a tuple of
    ``[accum, B, n_i]`` integer tensors, one per sequence."""

    model: TokenConditionedTransformer
    loss_cfg: StageLossConfig
    lr: float = 3e-4
    wd: float = 1e-2
    lr_warmup: int = 0
    max_grad_norm: float = 0.5
    grad_accum_every: int = 1
    results_folder: str = "./results"
    save_model_every: int = 1000
    save_results_every: int = 250
    stage_name: str = "stage"
    use_tensorboard: bool = True
    # wandb: no-op where the package is absent or its init fails;
    # ``wandb_run_config`` is the run's recorded hyperparameters
    use_wandb: bool = False
    wandb_project: str = "open-musiclm-tpu"
    wandb_run_config: Optional[Dict[str, Any]] = None
    mesh: Optional[Mesh] = None

    def __post_init__(self):
        if self.mesh is None:
            self.mesh = make_mesh()
        if self.mesh.group is not None and self.loss_cfg.unique_consecutive:
            raise ValueError("data parallel training needs a fixed label count a micro-batch "
                             "(unique_consecutive makes it data-dependent)")
        Path(self.results_folder).mkdir(parents=True, exist_ok=True)
        self._log_path = Path(self.results_folder) / f"{self.stage_name}.log.jsonl"
        self._tb = None
        if self.use_tensorboard and self.mesh.is_main:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(str(Path(self.results_folder) / "tb" / self.stage_name))
            except Exception:
                self._tb = None
        self._wandb = None
        if self.use_wandb and self.mesh.is_main:
            try:
                import wandb

                self._wandb = wandb.init(project=self.wandb_project, name=f"{self.stage_name}_{int(time.time())}",
                                         dir=self.results_folder, config=self.wandb_run_config or {})
            except Exception:
                self._wandb = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    # ---- state ----

    def init_state(self) -> TrainState:
        """A fresh optimizer over the model: an unsharded model first takes
        global rank 0's weights on every rank, then this mesh's ``tp`` split."""
        if self.model.tp_mesh is None:
            self.mesh.broadcast_(list(self.model.parameters()))
            shard_module(self.model, self.mesh)
        elif self.model.tp_mesh != self.mesh:
            raise ValueError("the model is sharded over another mesh than the trainer's")
        split = [n in self.model.tp_splits for n, _ in self.model.named_parameters()]
        opt = StageOptimizer(
            self.model.parameters(), self.lr, self.wd, warmup_steps=self.lr_warmup,
            max_grad_norm=self.max_grad_norm,
            sum_squares=(lambda sq: self._sum_squares(sq, split)) if any(split) else None,
        )
        return TrainState(self.model, opt, 0)

    def _sum_squares(self, squares, split):
        """The global sum of squares: the split parameters' parts summed over
        ``tp``, plus the replicated ones (each counted once)."""
        parts = torch.stack([s for s, k in zip(squares, split) if k]).sum().reshape(1)
        self.mesh.tp_all_reduce_coalesced_([parts])
        return parts[0] + sum(s for s, k in zip(squares, split) if not k)

    # ---- steps ----

    def _on_device(self, batch: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        return tuple(torch.as_tensor(b).to(self.device, torch.long) for b in batch)

    def train_step(self, state: TrainState, batch: Sequence[torch.Tensor],
                   generator: Optional[torch.Generator] = None):
        """batch: tuple of [accum, B, n_i], this rank's rows. Returns (state,
        mean loss over all ranks as a 0-d tensor on the device)."""
        batch = self._on_device(batch)
        self.mesh.assert_same([d for b in batch for d in b.shape], "the micro-batch shape", self.device)
        model = state.model
        model.train()
        params = state.optimizer.params
        accum = batch[0].shape[0]
        grads, loss_sum = None, None
        for a in range(accum):
            with record_function("stage_loss"):
                loss, _ = stage_training_loss(
                    model, [b[a] for b in batch], self.loss_cfg, generator=generator, train=True)
            # a parameter outside the loss (the logit head of a sequence with
            # weight 0) gets a zero gradient, as under jax.grad
            micro = torch.autograd.grad(loss, params, materialize_grads=True)
            if grads is None:  # 0 + g == g: the first microbatch starts the sums
                grads, loss_sum = list(micro), loss.detach()
            else:
                with record_function("grad_accumulate"):
                    for g, m in zip(grads, micro):
                        g.add_(m)
                    loss_sum = loss_sum + loss.detach()
        if model.tp_partial:  # replicated parameters of split blocks: a share a rank
            names = [n for n, _ in model.named_parameters()]
            self.mesh.tp_all_reduce_coalesced_([g for g, n in zip(grads, names) if n in model.tp_partial])
        if self.mesh.group is not None:
            loss_sum = loss_sum.reshape(1)
            self.mesh.all_reduce_coalesced_(grads + [loss_sum])
            grads = [g / (self.mesh.world * accum) for g in grads]
            loss_sum = loss_sum[0] / (self.mesh.world * accum)
        elif accum > 1:
            grads = [g / accum for g in grads]
            loss_sum = loss_sum / accum
        with record_function("optimizer_step"):
            state.optimizer.step(grads)
        state.step += 1
        return state, loss_sum

    @torch.no_grad()
    def _eval(self, state: TrainState, batch: Sequence[torch.Tensor],
              generator: Optional[torch.Generator] = None):
        """(loss, final sequence's logits [B, n, vocab], its labels [B, n])
        of the model in eval mode on a batch of [B, n_i]."""
        state.model.eval()
        loss, aux = stage_training_loss(
            state.model, list(self._on_device(batch)), self.loss_cfg, generator=generator, train=False)
        return loss, aux["logits"][-1], aux["labels"][-1]

    def eval_step(self, state: TrainState, batch: Sequence[torch.Tensor],
                  generator: Optional[torch.Generator] = None):
        """batch: tuple of [B, n_i], this rank's rows. Returns (loss, accuracy
        of the final sequence) over all ranks as 0-d tensors."""
        loss, logits, labels = self._eval(state, batch, generator)
        acc = token_accuracy(logits, labels)
        if self.mesh.group is not None:
            both = self.mesh.all_reduce_(torch.stack([loss, acc])) / self.mesh.world
            loss, acc = both[0], both[1]
        return loss, acc

    def artifact_logits(self, state: TrainState, batch: Sequence[torch.Tensor],
                        generator: Optional[torch.Generator] = None):
        """The final sequence's (logits, labels) on a valid batch, for the
        artifact dumps: every rank's rows, in rank order."""
        _, logits, labels = self._eval(state, batch, generator)
        return self.mesh.all_gather_rows(logits), self.mesh.all_gather_rows(labels)

    # ---- logs and checkpoints ----

    def log(self, step: int, **metrics):
        """Rank 0 writes; the other ranks' calls do nothing."""
        if not self.mesh.is_main:
            return
        rec = {"step": int(step), "time": time.time(), "stage": self.stage_name}
        rec.update({k: float(v) for k, v in metrics.items()})
        with open(self._log_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in metrics.items():
                try:
                    self._tb.add_scalar(k, float(v), int(step))
                except Exception:
                    pass
        if self._wandb is not None:
            try:
                self._wandb.log({k: float(v) for k, v in metrics.items()}, step=int(step))
            except Exception:
                pass

    def log_audio(self, step: int, tag: str, waves, sample_rate: int):
        """Reconstruction audio to the trackers. ``waves``: [n, T] (or [T])
        in [-1, 1]. Rank 0 writes."""
        if self._tb is None and self._wandb is None:
            return
        waves = torch.as_tensor(waves).detach().float().cpu().numpy()
        if waves.ndim == 1:
            waves = waves[None]
        if self._tb is not None:
            try:
                for i, w in enumerate(waves):
                    self._tb.add_audio(f"{tag}.{i}", torch.from_numpy(w)[None], int(step), sample_rate=sample_rate)
            except Exception:
                pass
        if self._wandb is not None:
            try:
                import wandb

                self._wandb.log({tag: [wandb.Audio(np.asarray(w), sample_rate=sample_rate, caption=f"{tag}.{i}")
                                       for i, w in enumerate(waves)]}, step=int(step))
            except Exception:
                pass

    def checkpoint_path(self, step: int) -> str:
        return str(Path(self.results_folder) / f"{self.stage_name}.transformer.{step}.ckpt")

    def save(self, state: TrainState, step: int):
        """Rank (d 0, t 0) writes the checkpoint, whole (the ranks at d 0
        gather a sharded model's parts); the other ranks' calls do nothing."""
        if self.mesh.rank != 0:
            return
        opt = state.optimizer.state_dict()
        opt["mu"], opt["nu"] = (gather_param_tensors(state.model, opt[k]) for k in ("mu", "nu"))
        tree = {"model": gather_state_dict(state.model), "optimizer": opt, "step": int(state.step)}
        if self.mesh.is_main:
            save_checkpoint(self.checkpoint_path(step), tree)

    def _from_jax(self, tree: dict, path: str) -> dict:
        """A JAX ``StageTrainer``'s ``TrainState`` (params, opt_state, step;
        open_musiclm_tpu/train/trainer.py:310-333) as this trainer's
        checkpoint: the params, adam's ``mu`` and ``nu`` through the same
        ``stage_state_dict`` map, in parameter order, and adam's count. The
        optax chain's layout must be this trainer's optimizer's (clip with
        ``max_grad_norm``, masked decay with ``wd``, a schedule with
        ``lr_warmup``), as the JAX trainer's own restore requires."""
        missing = sorted({"params", "opt_state", "step"} - set(tree))
        if missing:
            raise ValueError(f"{path} is not a JAX StageTrainer checkpoint: it has no {missing} "
                             f"(keys {sorted(tree)})")
        opt = optax_stage_state(tree["opt_state"])
        want = {"clip": self.max_grad_norm is not None, "decay": bool(self.wd),
                "schedule": bool(self.lr_warmup and self.lr_warmup > 0)}
        got = {"clip": opt["clip"], "decay": opt["decay"], "schedule": opt["schedule_count"] is not None}
        if got != want:
            raise ValueError(f"{path}: the JAX optimizer's chain {got} is not this trainer's {want} "
                             f"(max_grad_norm {self.max_grad_norm}, wd {self.wd}, lr_warmup {self.lr_warmup})")
        if opt["schedule_count"] is not None and opt["schedule_count"] != opt["count"]:
            raise ValueError(f"{path}: adam's count {opt['count']} and the schedule's "
                             f"{opt['schedule_count']} differ")
        specs, depth = len(self.model.specs), self.model.depth
        names = [n for n, _ in self.model.named_parameters()]
        moments = {k: stage_state_dict(opt[k], specs, depth) for k in ("mu", "nu")}
        return {"model": stage_state_dict(tree["params"], specs, depth),
                "optimizer": {"mu": [moments["mu"][n] for n in names], "nu": [moments["nu"][n] for n in names],
                              "count": opt["count"]},
                "step": int(tree["step"])}

    def load(self, path: str) -> TrainState:
        """A state with this trainer's model restored from ``path`` (the
        port's checkpoint file, or the JAX trainer's orbax directory, read
        through ``_from_jax``), read on every rank once all ranks reach this
        call (rank 0's last ``save`` has then returned); a ``tp`` mesh takes
        each rank's part."""
        self.mesh.barrier()
        tree = load_checkpoint(path, map_location=self.device)
        if Path(path).is_dir():
            tree = self._from_jax(tree, path)
        load_whole_state_dict(self.model, tree["model"])
        state = self.init_state()
        opt = dict(tree["optimizer"])
        opt["mu"], opt["nu"] = (shard_param_tensors(self.model, opt[k]) for k in ("mu", "nu"))
        state.optimizer.load_state_dict(opt)
        state.step = int(tree["step"])
        return state

    # ---- loop ----

    def train(self, state: TrainState, data_iter: Iterator, *, num_steps: int,
              generator: Optional[torch.Generator] = None,
              valid_iter: Optional[Iterator] = None,
              artifact_fn: Optional[Callable] = None) -> TrainState:
        """The reference train loop: steps, the valid metrics every
        ``save_results_every`` steps (then ``artifact_fn(state, valid_batch,
        step)``), a checkpoint every ``save_model_every``, and on
        SIGTERM/SIGINT (on any rank) a checkpoint and a clean stop of every
        rank after the same step."""
        timer = StepTimer(device=self.device)
        stop = _PreemptionGuard()
        try:
            for _ in range(num_steps):
                if self.mesh.any(stop.triggered, self.device):
                    self.save(state, state.step)
                    self.log(state.step, preempted=1.0)
                    break
                step = state.step
                batch = next(data_iter)
                with timer:
                    state, loss = self.train_step(state, batch, generator)
                self.log(step, train_loss=loss, step_time_s=timer.last_s)
                if valid_iter is not None and self.save_results_every and (
                    step % self.save_results_every == 0
                ):
                    vb = next(valid_iter)
                    vloss, vacc = self.eval_step(state, vb, generator)
                    self.log(step, valid_loss=vloss, valid_accuracy=vacc)
                    if artifact_fn is not None:
                        artifact_fn(state, vb, step)
                if self.save_model_every and step > 0 and step % self.save_model_every == 0:
                    self.save(state, step)
        finally:
            stop.restore()
        return state
