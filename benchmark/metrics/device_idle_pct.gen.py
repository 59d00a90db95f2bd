"""Share of the traced window in which no kernel ran on the card."""

from benchmark.readings import idle_pct as read  # noqa: F401
