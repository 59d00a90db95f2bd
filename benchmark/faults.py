"""Faults planted in the program under test, to show that the check catches
them (the benchmark's tests, and readings of a fault on the card). Each
patches a class of open_musiclm_torch in this process only; no file of
the program is touched.

  token:      a stage's last token altered where it is produced
  frozen:     the optimizer step leaves the state unchanged
  half_batch: half of the batch left out, the mean taken over the rest
"""

from __future__ import annotations


def plant(name: str) -> None:
    import torch

    if name == "token":
        from open_musiclm_torch.models.stages import Stage

        inner = Stage.generate

        def altered(self, *args, **kwargs):
            out = inner(self, *args, **kwargs)
            if self.name == "coarse":
                out = out.clone()
                out[:, -1, 0] = (out[:, -1, 0] + 1) % self.model.specs[-1].codebook_size
            return out

        Stage.generate = altered
    elif name == "frozen":
        from open_musiclm_torch.train.optimizer import StageOptimizer

        StageOptimizer.step = lambda self, grads: None
    elif name == "half_batch":
        from open_musiclm_torch.train.trainer import StageTrainer

        inner = StageTrainer.train_step

        def half(self, state, batch, generator=None):
            return inner(self, state, tuple(torch.as_tensor(b)[:, : b.shape[1] // 2] for b in batch), generator)

        StageTrainer.train_step = half
    else:
        raise ValueError(f"unknown fault {name!r}")
