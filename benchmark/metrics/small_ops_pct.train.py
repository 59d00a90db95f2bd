"""Share of the training window's kernel time in the elementwise, copy and
reduction families (benchmark/trace.py's frozen copy of the program's
kernel families), in percent."""


def read(layer):
    from benchmark.readings import device_trace
    from benchmark.trace import SMALL_OPS

    trace = device_trace(layer)
    if not trace:
        return None
    return 100.0 * sum(trace["by_family"].get(f, 0.0) for f in SMALL_OPS) / trace["kernel_s"]
