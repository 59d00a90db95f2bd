"""Checkpoint I/O (port of open_musiclm_tpu/checkpoint.py).

One ``torch.save`` file per checkpoint holding plain dicts of tensors (the
model's state_dict, the optimizer state and the step), step-stamped as
``{stage}.transformer.{step}.ckpt`` with the same latest-checkpoint lookup.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any, Optional

import torch


def save_checkpoint(path: str, tree: Any) -> None:
    """Write atomically: a preempted save never leaves a torn file behind."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_name(p.name + f".{os.getpid()}.tmp")
    torch.save(tree, tmp)
    os.replace(tmp, p)


def load_checkpoint(path: str, map_location=None) -> Any:
    return torch.load(path, map_location=map_location, weights_only=True)


def find_latest_checkpoint(folder: str, prefix: str) -> Optional[str]:
    """The highest-step ``{prefix}.<step>.ckpt`` in folder, or None."""
    pat = re.compile(re.escape(prefix) + r"\.(\d+)\.ckpt$")
    best, best_step = None, -1
    for p in Path(folder).glob(f"{prefix}.*.ckpt"):
        m = pat.search(p.name)
        if m and int(m.group(1)) > best_step:
            best, best_step = str(p), int(m.group(1))
    return best
