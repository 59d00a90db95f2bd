"""Multi-process start-up (port of open_musiclm_tpu/parallel/distributed.py).

Every process calls ``initialize_distributed()`` once before it touches a
card. It reads torchrun's contract (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``: ``python -m
torch.distributed.run --nproc_per_node N ...`` sets them) or the JAX
package's names (``COORDINATOR_ADDRESS`` host:port, ``NUM_PROCESSES``,
``PROCESS_ID``), and joins the default process group: NCCL on CUDA, gloo on
the CPU, each rank on ``cuda:LOCAL_RANK``. Without either contract (and no
``init_method``) it does nothing: a single process. ``init_method`` (a
``file://`` store, as the tests use) takes the place of the address.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def _int_env(*names: str) -> Optional[int]:
    for name in names:
        if os.environ.get(name) is not None:
            return int(os.environ[name])
    return None


def initialize_distributed(
    device: str = "cuda",
    *,
    init_method: Optional[str] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    local_rank: Optional[int] = None,
    backend: Optional[str] = None,
) -> bool:
    """Join the default process group if the environment (or the arguments)
    name one. ``device`` "cuda" picks NCCL and sets this process's card to
    ``LOCAL_RANK``; "cpu" picks gloo. Returns True when a process group is
    active afterwards (also one this call found already set up). A CUDA
    device on a machine without a card raises."""
    if dist.is_initialized():
        return True
    rank = rank if rank is not None else _int_env("RANK", "PROCESS_ID")
    world_size = world_size if world_size is not None else _int_env("WORLD_SIZE", "NUM_PROCESSES")
    if init_method is None and rank is None and world_size is None:
        return False
    if rank is None or world_size is None:
        raise ValueError(f"a process group needs both a rank ({rank}) and a world size ({world_size})")
    local_rank = local_rank if local_rank is not None else _int_env("LOCAL_RANK")
    on_cuda = torch.device(device).type == "cuda"
    if on_cuda:
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed(device='cuda'): no CUDA card is visible")
        # without LOCAL_RANK (the JAX package's contract): ranks fill each host's cards in order
        torch.cuda.set_device(local_rank if local_rank is not None else rank % torch.cuda.device_count())
    if init_method is None:
        coordinator = os.environ.get("COORDINATOR_ADDRESS")
        if coordinator and not os.environ.get("MASTER_ADDR"):
            host, _, port = coordinator.rpartition(":")
            init_method = f"tcp://{host}:{port}"
        else:
            init_method = "env://"
    dist.init_process_group(backend or ("nccl" if on_cuda else "gloo"), init_method=init_method,
                            rank=rank, world_size=world_size)
    return True


def process_info() -> dict:
    """This process's place: rank, world size, local rank and backend."""
    if not dist.is_initialized():
        return {"rank": 0, "world_size": 1, "local_rank": 0, "backend": None}
    return {"rank": dist.get_rank(), "world_size": dist.get_world_size(),
            "local_rank": _int_env("LOCAL_RANK") or 0, "backend": dist.get_backend()}


def is_main_process() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0
