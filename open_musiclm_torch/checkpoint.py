"""Checkpoint I/O (port of open_musiclm_tpu/checkpoint.py).

One ``torch.save`` file per checkpoint holding plain dicts of tensors (the
model's state_dict, the optimizer state and the step), step-stamped as
``{stage}.transformer.{step}.ckpt`` with the same latest-checkpoint lookup.
The JAX package writes the same names as orbax directories:
``load_checkpoint`` reads those through ``orbax_io.read_orbax`` (the JAX
tree, which the caller maps: ``load.py``, ``StageTrainer.load``), and
``find_latest_checkpoint`` takes the newest step of either kind.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any, Optional

import torch

from .orbax_io import read_orbax


def save_checkpoint(path: str, tree: Any) -> None:
    """Write atomically: a preempted save never leaves a torn file behind."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_name(p.name + f".{os.getpid()}.tmp")
    torch.save(tree, tmp)
    os.replace(tmp, p)


def load_checkpoint(path: str, map_location=None) -> Any:
    """The port's checkpoint file, or the tree of the JAX package's orbax
    directory (numpy arrays; ``map_location`` does not apply)."""
    if Path(path).is_dir():
        return read_orbax(path)
    return torch.load(path, map_location=map_location, weights_only=True)


def find_latest_checkpoint(folder: str, prefix: str) -> Optional[str]:
    """The highest-step ``{prefix}.<step>.ckpt`` in folder, or None: a file
    the port wrote or a directory the JAX package wrote, whichever has the
    newest step (an unfinished orbax save is a ``*.orbax-checkpoint-tmp-*``
    directory, which the pattern leaves out)."""
    pat = re.compile(re.escape(prefix) + r"\.(\d+)\.ckpt$")
    best, best_step = None, -1
    for p in Path(folder).glob(f"{prefix}.*.ckpt"):
        m = pat.search(p.name)
        if m and int(m.group(1)) > best_step:
            best, best_step = str(p), int(m.group(1))
    return best
