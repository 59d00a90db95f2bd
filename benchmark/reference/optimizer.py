"""Plain reference of the stage trainer's optimizer: clip the gradients to
a global norm (``g * max_norm / norm`` when the norm is at least
``max_norm``), then AdamW (b1 0.9, b2 0.99, eps 1e-8, bias corrections with
the step count, weight decay ``wd * p`` on matrices only) at a learning
rate warmed up linearly from ``lr * 1e-7`` over ``warmup`` steps, the
first update at count 0."""

from __future__ import annotations

from typing import List

import torch


class AdamWReference:
    b1, b2, eps = 0.9, 0.99, 1e-8

    def __init__(self, params: List[torch.Tensor], lr: float, wd: float, warmup: int, max_norm: float):
        self.params = params
        self.lr, self.wd, self.warmup, self.max_norm = lr, wd, warmup, max_norm
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    def rate(self) -> float:
        if self.warmup <= 0:
            return self.lr
        start = self.lr * 1e-7
        return start + (self.lr - start) * min(self.count, self.warmup) / self.warmup

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Updates the parameters in place; returns the clipped gradients."""
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
        if norm >= self.max_norm:
            grads = [g * (self.max_norm / norm) for g in grads]
        lr = self.rate()
        self.count += 1
        c1, c2 = 1 - self.b1 ** self.count, 1 - self.b2 ** self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.mul_(self.b1).add_((1 - self.b1) * g)
            nu.mul_(self.b2).add_((1 - self.b2) * g * g)
            update = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            if p.ndim >= 2:
                update = update + self.wd * p
            p.sub_(lr * update)
        return grads
