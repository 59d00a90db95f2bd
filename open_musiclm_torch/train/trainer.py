"""Single-stage trainer on token batches (port of open_musiclm_tpu/train/trainer.py).

One device, no mesh. A step is the forward and backward of
``stage_training_loss`` for each of ``accum`` microbatches, the mean of
their gradients and losses, then the optimizer (global-norm clip, AdamW with
warmup; train/optimizer.py). Evaluation gives the valid loss and the token
accuracy of the final sequence. Metrics go to ``{stage}.log.jsonl``;
checkpoints are ``{stage}.transformer.{step}.ckpt``. TensorBoard, wandb and
the artifact dumps are not ported.

Randomness (FF dropout, the forgetful causal mask) comes from an explicit
``torch.Generator`` on the model's device.
"""

from __future__ import annotations

import dataclasses
import json
import signal
import time
from pathlib import Path
from typing import Iterator, Optional, Sequence, Tuple

import torch

from ..checkpoint import load_checkpoint, save_checkpoint
from ..models.token_cond import (
    StageLossConfig,
    TokenConditionedTransformer,
    stage_training_loss,
    token_accuracy,
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

    def __post_init__(self):
        Path(self.results_folder).mkdir(parents=True, exist_ok=True)
        self._log_path = Path(self.results_folder) / f"{self.stage_name}.log.jsonl"

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    # ---- state ----

    def init_state(self) -> TrainState:
        opt = StageOptimizer(
            self.model.parameters(), self.lr, self.wd, warmup_steps=self.lr_warmup,
            max_grad_norm=self.max_grad_norm,
        )
        return TrainState(self.model, opt, 0)

    # ---- steps ----

    def _on_device(self, batch: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        return tuple(torch.as_tensor(b).to(self.device, torch.long) for b in batch)

    def train_step(self, state: TrainState, batch: Sequence[torch.Tensor],
                   generator: Optional[torch.Generator] = None):
        """batch: tuple of [accum, B, n_i]. Returns (state, mean loss as a
        0-d tensor on the device)."""
        batch = self._on_device(batch)
        model = state.model
        model.train()
        params = state.optimizer.params
        accum = batch[0].shape[0]
        grads, loss_sum = None, None
        for a in range(accum):
            loss, _ = stage_training_loss(
                model, [b[a] for b in batch], self.loss_cfg, generator=generator, train=True)
            # a parameter outside the loss (the logit head of a sequence with
            # weight 0) gets a zero gradient, as under jax.grad
            micro = torch.autograd.grad(loss, params, materialize_grads=True)
            if grads is None:  # 0 + g == g: the first microbatch starts the sums
                grads, loss_sum = list(micro), loss.detach()
            else:
                for g, m in zip(grads, micro):
                    g.add_(m)
                loss_sum = loss_sum + loss.detach()
        if accum > 1:
            grads = [g / accum for g in grads]
            loss_sum = loss_sum / accum
        state.optimizer.step(grads)
        state.step += 1
        return state, loss_sum

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: Sequence[torch.Tensor],
                  generator: Optional[torch.Generator] = None):
        """batch: tuple of [B, n_i]. Returns (loss, accuracy of the final
        sequence) as 0-d tensors."""
        batch = self._on_device(batch)
        state.model.eval()
        loss, aux = stage_training_loss(
            state.model, list(batch), self.loss_cfg, generator=generator, train=False)
        return loss, token_accuracy(aux["logits"][-1], aux["labels"][-1])

    # ---- logs and checkpoints ----

    def log(self, step: int, **metrics):
        rec = {"step": int(step), "time": time.time(), "stage": self.stage_name}
        rec.update({k: float(v) for k, v in metrics.items()})
        with open(self._log_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def checkpoint_path(self, step: int) -> str:
        return str(Path(self.results_folder) / f"{self.stage_name}.transformer.{step}.ckpt")

    def save(self, state: TrainState, step: int):
        save_checkpoint(self.checkpoint_path(step), {
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": int(state.step),
        })

    def load(self, path: str) -> TrainState:
        """A state with this trainer's model restored from ``path``."""
        tree = load_checkpoint(path, map_location=self.device)
        self.model.load_state_dict(tree["model"])
        state = self.init_state()
        state.optimizer.load_state_dict(tree["optimizer"])
        state.step = int(tree["step"])
        return state

    # ---- loop ----

    def train(self, state: TrainState, data_iter: Iterator, *, num_steps: int,
              generator: Optional[torch.Generator] = None,
              valid_iter: Optional[Iterator] = None) -> TrainState:
        """The reference train loop: steps, the valid metrics every
        ``save_results_every`` steps, a checkpoint every ``save_model_every``,
        and on SIGTERM/SIGINT a checkpoint and a clean stop."""
        timer = StepTimer(device=self.device)
        stop = _PreemptionGuard()
        try:
            for _ in range(num_steps):
                if stop.triggered:
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
                    vloss, vacc = self.eval_step(state, next(valid_iter), generator)
                    self.log(step, valid_loss=vloss, valid_accuracy=vacc)
                if self.save_model_every and step > 0 and step % self.save_model_every == 0:
                    self.save(state, step)
        finally:
            stop.restore()
        return state
