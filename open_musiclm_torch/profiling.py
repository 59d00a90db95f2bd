"""Profiling and tracing hooks (port of open_musiclm_tpu/profiling.py).

``trace(log_dir)`` records the enclosed region with ``torch.profiler`` (the
card's kernels too when it runs on one) and writes a Chrome-trace JSON into
``log_dir`` (Perfetto or chrome://tracing open it); ``annotate(name)`` names
a sub-region on that timeline (and as an NVTX range on the card);
``StepTimer`` times steps, keeps an EMA and appends JSONL records;
``device_memory_stats`` reads the allocator's statistics of each card.

PyTorch returns before the card finishes, so the timer synchronises the
card at both ends of each timed region: the time covers the work, not its
enqueue.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from pathlib import Path
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed region (the card's activity too where there is
    one); on exit write ``log_dir/trace_<pid>_<ns>.json``. Yields the
    profiler (its ``key_averages()`` and ``trace_path`` after the region)."""
    cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        prof.trace_path = str(Path(log_dir) / f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(prof.trace_path)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named range on the profiler's timeline (``record_function``), and
    an NVTX range where a card is available."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


class StepTimer:
    """Wall-clock time of the last timed region on ``device``, an EMA of the
    times, and a JSONL sink (``path``) of per-step records."""

    def __init__(self, path: Optional[str] = None, ema: float = 0.9, device=None):
        self.path = path
        self.ema = ema
        self.device = torch.device(device) if device is not None else None
        self._avg = None
        self._last = None
        if path:
            Path(path).parent.mkdir(parents=True, exist_ok=True)

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        dt = time.perf_counter() - self._t0
        self._last = dt
        self._avg = dt if self._avg is None else self.ema * self._avg + (1 - self.ema) * dt
        return False

    @property
    def last_s(self) -> Optional[float]:
        return self._last

    @property
    def avg_s(self) -> Optional[float]:
        return self._avg

    def log(self, step: int, **extra) -> None:
        if not self.path:
            return
        rec = {"step": step, "step_time_s": self._last, "avg_step_time_s": self._avg, **extra}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


def device_memory_stats() -> dict:
    """{device name: ``torch.cuda.memory_stats``} for each card; without a
    card {"cpu": None}, as the JAX package gives None where a device has no
    statistics."""
    if not torch.cuda.is_available():
        return {"cpu": None}
    return {str(torch.device("cuda", i)): torch.cuda.memory_stats(i) for i in range(torch.cuda.device_count())}
