"""Seeded weights for every module a cell runs, made on the device.

Each module's parameters are drawn in one ``torch.randn`` call over a flat
buffer from a ``torch.Generator`` on the device, seeded from ``--seed`` and
the module's tag, then each tensor's slice is scaled by a rule of its name
and shape. The same seed gives the same weights, so the reference draws
them again after the window instead of keeping a copy, and never reads the
program's. The scales keep every activation of order one: fan-in scaled
matrices, gains near one, and a relative-position MLP whose first layer
maps the largest distance to about one.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Iterable, Tuple

import torch

GAIN_NAMES = ("gamma", "q_scale", "k_scale", "LayerNorm.weight")


def stream_seed(seed: int, tag: str) -> int:
    """A 63-bit generator seed of the run's seed and a component's tag."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, tag))


def scale_of(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """(offset, std) of a parameter: value = offset + std * N(0, 1)."""
    if name.endswith(GAIN_NAMES):
        return 1.0, 0.05
    if name.endswith("rel_pos_bias.in_layer.weight"):
        return 0.0, 1.0 / 512.0  # distances run to ~1.2k positions
    if len(shape) <= 1:
        return 0.0, 0.02
    if name.startswith(("embeds.", "start_tokens")) or "embeddings." in name or name == "codebooks":
        return 0.0, 1.0
    if name.startswith("logit_heads."):
        return 0.0, 1.0 / math.sqrt(shape[-1])
    if name.endswith("conv_w"):
        return 0.0, 1.0 / math.sqrt(3.0)
    if "convtr" in name:  # [in, out, k] with k = 2 * stride: each output sums in * 2 taps
        return 0.0, 1.0 / math.sqrt(shape[0] * 2.0)
    if len(shape) == 3:  # conv [out, in, k]
        return 0.0, 1.0 / math.sqrt(shape[1] * shape[2])
    return 0.0, 1.0 / math.sqrt(shape[-1])  # [out, in]


def draw(shapes: Iterable[Tuple[str, Tuple[int, ...]]], seed: int, tag: str, device,
         dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """{name: tensor} for ``shapes``, from one flat draw."""
    shapes = [(n, tuple(s)) for n, s in shapes]
    total = sum(math.prod(s) for _, s in shapes)
    flat = torch.randn(total, generator=generator(seed, tag, device), device=device, dtype=dtype)
    out, at = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        offset, std = scale_of(name, shape)
        t = flat[at:at + n].view(shape).mul_(std)
        out[name] = t.add_(offset) if offset else t
        at += n
    return out


def module_shapes(module: torch.nn.Module):
    return [(n, tuple(p.shape)) for n, p in module.named_parameters()]


@torch.no_grad()
def load_into(module: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into the module's parameters (every one, by name)."""
    params = dict(module.named_parameters())
    missing = sorted(set(params) ^ set(weights))
    if missing:
        raise KeyError(f"weights and module differ in {missing[:5]}")
    for name, p in params.items():
        p.copy_(weights[name])
