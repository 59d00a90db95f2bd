"""Arithmetic the per-layer readers share: the work of the window's stage
calls from their shapes, and the device time of the benchmark's ranges."""

from __future__ import annotations

from typing import Any, Dict, Optional

from . import roofline


def device_trace(layer: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """The traced run's summary where it saw the card run something."""
    trace = layer.get("trace")
    return trace if trace and trace["busy_s"] > 0 else None


def stage_spans(layer: Dict[str, Any]):
    return [s for s in layer["spans"] if s["name"].startswith("stage.")]


def stage_totals(layer: Dict[str, Any]) -> Dict[str, float]:
    """Work of every stage call in the window: FLOPs, least seconds, decode
    steps and host seconds."""
    flops = least = steps = wall = 0.0
    for s in stage_spans(layer):
        dims = layer["dims"][s["stage"]]
        pf, pb, df, db = roofline.stage_work(dims, s["rows"], s["prefill_len"], s["n_new"],
                                             weight_bytes=layer["weight_bytes"])
        flops += pf + df
        least += roofline.bound_s(pb, pf) + roofline.bound_s(db, df)
        steps += s["n_new"]
        wall += s["t1"] - s["t0"]
    return {"flops": flops, "least_s": least, "steps": steps, "wall_s": wall}


def range_device_s(layer: Dict[str, Any], prefix: str) -> Optional[float]:
    trace = device_trace(layer)
    return None if trace is None else trace["range_device_s"].get(prefix)


def idle_pct(layer: Dict[str, Any]) -> Optional[float]:
    trace = device_trace(layer)
    return None if trace is None else 100.0 * (1.0 - trace["busy_s"] / layer["window_s"])


def stage_roofline_pct(layer: Dict[str, Any]) -> Optional[float]:
    device_s = range_device_s(layer, "stage.")
    if not device_s:
        return None
    return 100.0 * stage_totals(layer)["least_s"] / device_s


def stage_mfu_pct(layer: Dict[str, Any]) -> Optional[float]:
    if not device_trace(layer):
        return None
    return 100.0 * stage_totals(layer)["flops"] / (layer["window_s"] * roofline.PEAK_FLOPS["bfloat16"])


def decode_step_ms(layer: Dict[str, Any]) -> Optional[float]:
    if not layer.get("trace"):
        return None
    t = stage_totals(layer)
    return 1e3 * t["wall_s"] / t["steps"] if t["steps"] else None


def mean_span_ms(layer: Dict[str, Any], name: str) -> Optional[float]:
    spans = [s for s in layer["spans"] if s["name"] == name]
    if not layer.get("trace") or not spans:
        return None
    return 1e3 * sum(s["t1"] - s["t0"] for s in spans) / len(spans)
