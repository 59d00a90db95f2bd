"""The device trace of a traced run, read from ``torch.profiler``.

``Trace`` profiles the CPU and the card over the measured window.
``summary()`` gives what the per-layer readers and the result line take:
the kernels' union on the device timeline (``busy_s``), the device time of
the kernels launched inside each of the benchmark's ``bench:*`` ranges, the
device time by kernel name and by kernel family, and the longest idle gaps,
each named by the innermost range (the benchmark's or the program's own,
such as the trainer's ``stage_loss``) whose device interval holds it.

``FAMILIES`` and ``family()`` are a frozen copy of
``open_musiclm_torch/cli/trace_train.py:73-90``.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

import torch

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
SMALL_OPS = ("copies", "reductions", "elementwise")


def family(name: str) -> str:
    for fam, pat in FAMILIES:
        if pat.search(name):
            return fam
    return "other"


class Trace:
    """``start``/``stop`` the profiler around the window of a traced run; an
    untraced run's Trace does nothing and its ``summary`` is None."""

    def __init__(self, enabled: bool):
        self.prof = None
        if enabled:
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            self.prof = torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False)

    def start(self) -> None:
        if self.prof is not None:
            self.prof.start()

    def stop(self) -> None:
        if self.prof is not None:
            self.prof.stop()

    def summary(self) -> Optional[Dict[str, Any]]:
        """Kernels, and the device intervals of the benchmark's ranges: each
        ``bench:*`` range appears on the device timeline from its first
        kernel to its last, and a kernel counts toward a range when it lies
        in that range's interval there. (A kernel launched through ctypes has
        no host op to link it to a range; the device intervals place it.
        Ranges opened in other threads than the profiler's do not reach the
        device timeline, so a threaded traffic kind's ranges read nothing.)"""
        if self.prof is None:
            return None
        gpu = torch.autograd.DeviceType.CUDA
        kernels: List[Tuple[float, float, str]] = []
        spans: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        program: List[Tuple[float, float, str]] = []  # the program's own ranges, for naming gaps
        # the raw events: FunctionEvent trees (prof.events()) take minutes to
        # build for a window of a million launches
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != gpu:
                continue
            name = e.name()
            t0 = e.start_ns() * 1e-3
            t = (t0, t0 + e.duration_ns() * 1e-3)
            if name.startswith("bench:"):
                name = name[len("bench:"):]
                spans[name].append(t)
                spans[name.split(".")[0] + "."].append(t)
            elif e.is_user_annotation():  # the program's own ranges on the device timeline
                program.append(t + (name,))
            else:
                kernels.append(t + (name,))
        kernels.sort()
        by_name: Dict[str, float] = defaultdict(float)
        by_family: Dict[str, float] = defaultdict(float)
        for t0, t1, name in kernels:
            by_name[name] += (t1 - t0) * 1e-6
            by_family[family(name)] += (t1 - t0) * 1e-6
        merged = _union([(t0, t1) for t0, t1, _ in kernels])
        busy = sum(t1 - t0 for t0, t1 in merged) * 1e-6
        points = sorted((0.5 * (t0 + t1), t1 - t0) for t0, t1, _ in kernels)
        mids = [m for m, _ in points]
        cum = [0.0]
        for _, d in points:
            cum.append(cum[-1] + d)
        within = {}
        for name, ivs in spans.items():
            total = 0.0
            for a, b in _union(ivs):
                total += cum[bisect.bisect_right(mids, b)] - cum[bisect.bisect_left(mids, a)]
            within[name] = total * 1e-6
        labelled = sorted([(t0, t1, n) for n, ivs in spans.items() if not n.endswith(".") for t0, t1 in ivs]
                          + program)
        starts = [t0 for t0, _, _ in labelled]

        def label(t: float) -> str:
            i = bisect.bisect_right(starts, t)
            inside = [n for t0, t1, n in labelled[max(0, i - 16):i] if t0 <= t <= t1]
            return inside[-1] if inside else "outside any range"

        gaps = sorted(((b[0] - a[1], 0.5 * (a[1] + b[0])) for a, b in zip(merged, merged[1:]) if b[0] > a[1]),
                      reverse=True)
        return {
            "busy_s": busy,
            "kernel_s": sum(by_name.values()),
            "range_device_s": within,
            "by_family": dict(by_family),
            "device_ops": sorted(([n, s] for n, s in by_name.items()), key=lambda x: -x[1])[:10],
            "idle_gaps": [[label(t), g * 1e-6] for g, t in gaps[:10]],
            "n_kernels": len(kernels),
        }


def _union(intervals):
    merged: List[List[float]] = []
    for t0, t1 in sorted(intervals):
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    return merged
