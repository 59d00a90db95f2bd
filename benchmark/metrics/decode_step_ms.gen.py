"""Host wall of the benchmark's Stage.generate spans (synchronised at their
ends in the traced run) over the decode steps they ran, prefill included."""

from benchmark.readings import decode_step_ms as read  # noqa: F401
