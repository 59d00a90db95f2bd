"""Least time of the stage calls' work (benchmark/roofline.py, from their
shapes) over the device time of the kernels launched inside the
benchmark's stage ranges, in percent."""

from benchmark.readings import stage_roofline_pct as read  # noqa: F401
