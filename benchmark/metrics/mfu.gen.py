"""Model FLOPs of the window's stage calls (prefilled and decoded tokens,
attention over the live cache) over the window times the bf16 peak."""

from benchmark.readings import stage_mfu_pct as read  # noqa: F401
