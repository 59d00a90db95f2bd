"""Profiling and tracing hooks (port of open_musiclm_tpu/profiling.py).

``trace(log_dir)`` records the enclosed region with ``torch.profiler`` (the
card's kernels too when it runs on one) and writes a Chrome-trace JSON into
``log_dir`` (Perfetto or chrome://tracing open it); ``annotate(name)`` names
a sub-region on that timeline (and as an NVTX range on the card);
``StepTimer`` times steps, keeps an EMA and appends JSONL records;
``device_memory_stats`` reads the allocator's statistics of each card;
``range_launches`` counts a session's device events by ``annotate`` range;
``device_ops`` reads a written trace back: every device event (kernel,
copy, memset) with the host ranges and ops it was launched from.

PyTorch returns before the card finishes, so the timer synchronises the
card at both ends of each timed region: the time covers the work, not its
enqueue.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import gzip
import json
import os
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

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


def range_launches(prof: torch.profiler.profile, names) -> Dict[str, int]:
    """Device events (kernels, copies, memsets) of a finished profiler
    session that started inside each ``annotate`` range of ``names``; a
    range must synchronise the card before it closes. Without a card, the
    host ops inside each range. Reads the session's events in memory, with
    no trace written."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    spans = {e.name(): (e.start_ns(), e.end_ns()) for e in events
             if e.is_user_annotation() and e.device_type() == cpu and e.name() in names}
    starts = [e.start_ns() for e in events if e.device_type() == cuda and not e.is_user_annotation()]
    if not starts:
        starts = [e.start_ns() for e in events if e.device_type() == cpu and not e.is_user_annotation()]
    return {name: sum(lo <= t <= hi for t in starts) for name, (lo, hi) in spans.items()}


# Chrome-trace categories torch.profiler writes: the card's work, and the
# host's ranges, ops and CUDA runtime calls
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "python_function", "cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class DeviceOp:
    """One device event of a trace: its name, start and duration (us), the
    host time of its launch, and the host events it was launched from,
    innermost first (the launching op, then the ops and ranges around it,
    each the trace's event dict). On a trace without a card the leaf host
    ops stand in for the device's work (``device_ops``)."""

    name: str
    ts: float
    dur: float
    launch_ts: float
    stack: Tuple[dict, ...]


def newest_trace(folder: str) -> str:
    """The newest Chrome trace (``*.json`` or ``*.json.gz``) under ``folder``."""
    files = [f for pat in ("*.json", "*.json.gz")
             for f in glob.glob(os.path.join(folder, "**", pat), recursive=True)]
    if not files:
        raise FileNotFoundError(f"no Chrome trace under {folder}")
    return max(files, key=os.path.getmtime)


def load_trace(path: str) -> List[dict]:
    """The events of a Chrome trace file (plain or gzipped JSON)."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def host_parents(host: List[dict]) -> Dict[int, Optional[int]]:
    """Each host event's innermost enclosing event on its own thread."""
    by_thread: Dict[tuple, List[int]] = {}
    for i, e in enumerate(host):
        by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(i)
    parent: Dict[int, Optional[int]] = {}
    for idx in by_thread.values():
        idx.sort(key=lambda i: (float(host[i]["ts"]), -float(host[i].get("dur", 0))))
        open_: List[int] = []
        for i in idx:
            ts = float(host[i]["ts"])
            while open_ and float(host[open_[-1]]["ts"]) + float(host[open_[-1]].get("dur", 0)) <= ts:
                open_.pop()
            parent[i] = open_[-1] if open_ else None
            open_.append(i)
    return parent


def device_ops(events: List[dict]) -> Tuple[List[DeviceOp], bool]:
    """(every device event of ``events`` with its host stack, whether a card
    was traced). A kernel, copy or memset is tied to its CUDA runtime launch
    by ``correlation`` (else to its op by ``External id``); the stack is that
    launch's enclosing ops and ranges on the launching thread (the autograd
    engine's thread for the backward). Without device events (a trace of the
    CPU), the host ops that hold no other op stand in for them."""
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATEGORIES]
    parent = host_parents(host)

    def stack_from(i: Optional[int]) -> Tuple[dict, ...]:
        out = []
        while i is not None:
            out.append(host[i])
            i = parent[i]
        return tuple(out)

    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]
    if not device:
        has_child = {parent[i] for i, e in enumerate(host) if e["cat"] == "cpu_op" and parent[i] is not None}
        ops = [DeviceOp(e["name"], float(e["ts"]), float(e.get("dur", 0)), float(e["ts"]), stack_from(i))
               for i, e in enumerate(host) if e["cat"] == "cpu_op" and i not in has_child]
        return ops, False
    launch_by_corr = {e["args"]["correlation"]: i for i, e in enumerate(host)
                      if e["cat"] in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})}
    op_by_ext = {e["args"]["External id"]: i for i, e in enumerate(host)
                 if e["cat"] == "cpu_op" and "External id" in e.get("args", {})}
    ops = []
    for e in device:
        args = e.get("args", {})
        i = launch_by_corr.get(args.get("correlation"))
        if i is not None:
            launch_ts, stack = float(host[i]["ts"]), stack_from(parent[i])
        else:
            i = op_by_ext.get(args.get("External id"))
            launch_ts = float(host[i]["ts"]) if i is not None else float(e["ts"])
            stack = stack_from(i)
        ops.append(DeviceOp(e["name"], float(e["ts"]), float(e.get("dur", 0)), launch_ts, stack))
    return ops, True
