"""Requests served over the rows of the batches that served them (each
batch padded to its bucket), in percent, over the window's batches."""


def read(layer):
    batches = layer.get("batches")
    if not layer.get("trace") or not batches:
        return None
    real = sum(1 for b in batches for s in b["seeds"] if s >= 0)
    return 100.0 * real / sum(b["bucket"] for b in batches)
