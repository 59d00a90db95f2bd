"""Model FLOPs of the window's optimizer steps (benchmark/flops.py: forward
once, backward twice) over the window times the bf16 peak, in percent."""


def read(layer):
    from benchmark.readings import device_trace
    from benchmark.roofline import PEAK_FLOPS

    if not device_trace(layer) or not layer["steps"]:
        return None
    return 100.0 * layer["flops_per_step"] * layer["steps"] / (layer["window_s"] * PEAK_FLOPS["bfloat16"])
