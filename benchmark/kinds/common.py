"""What every traffic kind shares: the run's context, its outcome, and the
comparison of served tokens with the reference."""

from __future__ import annotations

import dataclasses
import gc
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from ..reference.stage import StageReference, eos_masked


@dataclasses.dataclass
class Context:
    root: Path
    cell: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    control: bool = False

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def since_start(self) -> float:
        return time.perf_counter() - self.t_start


@dataclasses.dataclass
class Outcome:
    correct: bool
    attempted: int
    failed: int
    e2e: Dict[str, float]
    layer: Dict[str, Any]  # what the per-layer readers take
    memory_peak_bytes: int
    checks: Dict[str, Dict[str, float]]
    trace: Optional[Dict[str, Any]] = None
    window_s: Optional[float] = None
    control: Optional[Dict[str, float]] = None


def memory_peak(ctx: Context) -> int:
    return int(torch.cuda.max_memory_allocated(ctx.device)) if ctx.device.type == "cuda" else 0


def free(ctx: Context) -> None:
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def reference_mode(ctx: Context) -> None:
    """Full float32 for the reference: no TF32 in products or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def judge(checks: Dict[str, float], limits: Dict[str, float]) -> (bool, Dict[str, Dict[str, float]]):
    """Each number against its limit; a number that is not finite fails."""
    out, ok = {}, True
    for name, value in checks.items():
        limit = float(limits[name])
        value = float(value)
        out[name] = {"value": value, "limit": limit}
        if not (value == value and value <= limit):  # NaN fails
            ok = False
    return ok, out


def token_gaps(ref_scores: torch.Tensor, served: torch.Tensor, chosen_scores: torch.Tensor = None) -> torch.Tensor:
    """Per position, how far the served token's reference score lies below
    the reference's best: ``max(ref) - ref[served]`` over the choosable
    tokens. ``chosen_scores`` (default ``ref_scores``) is the score read at
    the served token, where it may differ from the one the best is taken
    over (a top-k filter)."""
    chosen = ref_scores if chosen_scores is None else chosen_scores
    best = ref_scores.max(dim=-1).values
    return best - chosen.gather(-1, served[..., None])[..., 0]


def greedy_stage_gaps(weights, dims, records: List[Dict[str, Any]], batch: int, rows: List[int], device,
                      control: bool) -> Dict[str, float]:
    """Widest greedy gap of the program's tokens in each stage call of one
    generate call of ``batch`` prompts, at ``rows`` of them; with ``control`` also
    the widest gap of the tokens the int4 reference puts first."""
    out = {"gap": 0.0, "tokens": 0}
    if control:
        out["control_gap"] = 0.0
    for rec in records:
        name = rec["stage"]
        per = rec["rows"] // batch  # windows batched into one call
        idx = [w * batch + r for w in range(per) for r in rows]
        cond = [c[idx].to(device) for c in rec["cond"]]
        tokens = rec["tokens"][idx].to(device)
        ref = StageReference(weights[name], dims[name]["specs"], dims[name]["depth"], dims[name]["heads"],
                             dims[name]["dim_head"])
        logits = eos_masked(ref.logits(cond, tokens, rec["n_init"]))
        served = tokens[:, rec["n_init"]:]
        out["gap"] = max(out["gap"], float(token_gaps(logits, served).max()))
        out["tokens"] += served.numel()
        if control:
            ctl = StageReference(weights[name], dims[name]["specs"], dims[name]["depth"], dims[name]["heads"],
                                 dims[name]["dim_head"], precision="int4")
            pick = eos_masked(ctl.logits(cond, tokens, rec["n_init"])).argmax(dim=-1)
            out["control_gap"] = max(out["control_gap"], float(token_gaps(logits, pick).max()))
            del ctl
        del ref, logits
    return out


def wave_error(ref_wave: torch.Tensor, wave: torch.Tensor) -> float:
    """The worst row's ||wave - ref|| / ||ref||."""
    num = (wave.float() - ref_wave).norm(dim=-1)
    return float((num / ref_wave.norm(dim=-1).clamp(min=1e-30)).max())
