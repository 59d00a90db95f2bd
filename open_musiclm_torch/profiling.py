"""Step timing (port of open_musiclm_tpu/profiling.py:StepTimer).

PyTorch returns before the card finishes, so the timer synchronises the
card at both ends of each timed region: the time covers the work, not its
enqueue. The JAX package's EMA and JSONL sink are not ported (the trainer
logs each step's time itself).
"""

from __future__ import annotations

import time
from typing import Optional

import torch


class StepTimer:
    """Wall-clock time of the last timed region on ``device``."""

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None
        self._last = None

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self._last = time.perf_counter() - self._t0
        return False

    @property
    def last_s(self) -> Optional[float]:
        return self._last
