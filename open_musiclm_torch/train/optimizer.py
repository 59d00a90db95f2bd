"""Optimizer: global-norm clip, then AdamW with dimension-gated weight decay
and linear warmup (port of open_musiclm_tpu/train/optimizer.py).

Written out to run the optax chain ``clip_by_global_norm(max_norm)`` then
``adamw(schedule, b1=0.9, b2=0.99, eps=1e-8, weight_decay, mask=ndim >= 2)``
step for step, rather than with ``torch.optim.AdamW`` and
``clip_grad_norm_``, which round differently (the latter divides by
``norm + 1e-6`` and clips even below the limit):

  * clip: when the global norm is at least ``max_norm``, every gradient
    becomes ``g / norm * max_norm``; below it, gradients pass unchanged;
  * adam: ``mu = 0.1 g + 0.9 mu``, ``nu = 0.01 g^2 + 0.99 nu``, bias
    corrections with the incremented count, ``mu_hat / (sqrt(nu_hat) + eps)``;
  * decay: ``+ wd * p`` for parameters with ``ndim >= 2`` only;
  * learning rate: ``-lr(count) *`` with the schedule's own count, so the
    first update uses count 0 (``lr * 1e-7`` under warmup).

Updates happen in place on the parameters (float32 master weights).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch


def learning_rate(count: int, lr: float, warmup_steps: int = 0) -> float:
    """optax.linear_schedule(lr * 1e-7 -> lr over warmup_steps), evaluated in
    float32 as optax evaluates it; constant lr without warmup."""
    if not warmup_steps or warmup_steps <= 0:
        return lr
    f32 = np.float32
    init, end = f32(lr * 1e-7), f32(lr)
    c = min(max(count, 0), warmup_steps)
    frac = f32(1) - f32(c) / f32(warmup_steps)
    return float((init - end) * frac + end)


class StageOptimizer:
    """Clip + AdamW over ``params``; state: ``mu``, ``nu`` and ``count``."""

    b1, b2, eps = 0.9, 0.99, 1e-8

    def __init__(self, params: Iterable[torch.Tensor], lr: float = 3e-4, wd: float = 1e-2, *,
                 warmup_steps: int = 0, max_grad_norm: Optional[float] = 0.5,
                 sum_squares: Optional[Callable[[List[torch.Tensor]], torch.Tensor]] = None):
        """``sum_squares``: the global sum of the gradients' per-tensor sums
        of squares (default: their sum); a tensor-parallel trainer counts a
        split parameter's over all of its parts."""
        self.params: List[torch.Tensor] = list(params)
        self.sum_squares = sum_squares
        self.lr, self.wd, self.warmup_steps = lr, wd, warmup_steps
        self.max_grad_norm = max_grad_norm
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        """One update from ``grads`` (one per parameter, same order)."""
        if self.max_grad_norm is not None:
            squares = [torch.sum(g * g) for g in grads]
            norm = torch.sqrt(sum(squares) if self.sum_squares is None else self.sum_squares(squares))
            clip = norm >= self.max_grad_norm
            grads = [torch.where(clip, g / norm * self.max_grad_norm, g) for g in grads]
        b1, b2 = self.b1, self.b2
        step_size = -learning_rate(self.count, self.lr, self.warmup_steps)
        count_inc = self.count + 1
        c1 = float(1 - np.float32(b1) ** np.float32(count_inc))
        c2 = float(1 - np.float32(b2) ** np.float32(count_inc))
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.mul_(b1).add_((1 - b1) * g)
            nu.mul_(b2).add_((1 - b2) * (g * g))
            update = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            if self.wd and p.ndim >= 2:
                update = update + self.wd * p
            p.add_(update * step_size)
        self.count = count_inc

    def state_dict(self) -> Dict:
        return {"mu": [t.clone() for t in self.mu], "nu": [t.clone() for t in self.nu],
                "count": self.count}

    def load_state_dict(self, state: Dict) -> None:
        for dst, src in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
            dst.copy_(src)
        self.count = int(state["count"])
