"""The data-parallel mesh (port of open_musiclm_tpu/parallel/mesh.py, its
``dp`` axis).

``Mesh`` names the process group the batch is split over, this process's
rank in it and its size. Parameters are replicated on every rank; each rank
takes rows ``[r * B / W, (r + 1) * B / W)`` of a global batch of B rows
(``shard_batch``), as the JAX package's ``NamedSharding`` over ``dp`` does.
Tensor parallelism (the ``tp`` axis, ``parallel/sharding.py``'s column- and
row-parallel rules) is not ported (ROADMAP, Queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``group`` None: one process, no collectives."""

    group: Optional[dist.ProcessGroup] = None
    rank: int = 0
    world: int = 1

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def rank_seed(self, seed: int) -> int:
        """A seed of its own for this rank's draws (dropout, the forgetful
        mask): ``seed`` itself in one process, else one drawn from
        (seed, rank)."""
        if self.group is None:
            return seed
        return int(np.random.SeedSequence([seed, self.rank]).generate_state(1)[0])

    def all_reduce_(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        if self.group is not None:
            dist.all_reduce(t, op=op, group=self.group)
        return t

    def any(self, flag: bool, device=None) -> bool:
        """True on every rank if ``flag`` is set on any (an all-reduce MAX)."""
        if self.group is None:
            return bool(flag)
        t = torch.tensor([int(flag)], dtype=torch.int32, device=device)
        return bool(self.all_reduce_(t, dist.ReduceOp.MAX).item())

    def assert_same(self, values: Sequence[int], what: str, device=None) -> None:
        """Raise unless every rank passes the same integers."""
        if self.group is None:
            return
        t = torch.tensor(list(values), dtype=torch.int64, device=device)
        hi, lo = self.all_reduce_(t.clone(), dist.ReduceOp.MAX), self.all_reduce_(t.clone(), dist.ReduceOp.MIN)
        if not torch.equal(hi, lo):
            raise ValueError(f"{what} differs across ranks: {list(values)} here, from {lo.tolist()} to "
                             f"{hi.tolist()}")

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (the same shape on each) concatenated along
        dim 0 in rank order."""
        if self.group is None:
            return t
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts, dim=0)

    def all_reduce_coalesced_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Sum each tensor over the ranks in place, as one flat buffer a
        dtype: one collective a dtype, not one a tensor."""
        self._flat_collective(tensors, lambda flat: dist.all_reduce(flat, group=self.group))

    def broadcast_(self, tensors: Sequence[torch.Tensor], src: int = 0) -> None:
        """Rank ``src``'s values into ``tensors`` on every rank, as one flat
        buffer a dtype."""
        self._flat_collective(tensors, lambda flat: dist.broadcast(flat, src=src, group=self.group))

    def _flat_collective(self, tensors: Sequence[torch.Tensor], collective) -> None:
        if self.group is None:
            return
        by_dtype = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        with torch.no_grad():
            for group in by_dtype.values():
                flat = torch.cat([t.reshape(-1) for t in group])
                collective(flat)
                off = 0
                for t in group:
                    t.copy_(flat[off: off + t.numel()].view_as(t))
                    off += t.numel()

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)


def make_mesh(dp: Optional[int] = None, tp: int = 1) -> Mesh:
    """The mesh over the default process group (``initialize_distributed``),
    or a one-process mesh when there is none. ``dp`` (None: every rank) must
    equal the group's size."""
    if tp != 1:
        raise NotImplementedError(
            "tensor parallelism (tp > 1) is not ported; ROADMAP.md Queue 1 lists it next")
    if not dist.is_initialized():
        if dp not in (None, 1):
            raise ValueError(f"dp={dp} needs a process group of {dp} ranks (initialize_distributed)")
        return Mesh()
    world = dist.get_world_size()
    if dp not in (None, world):
        raise ValueError(f"dp={dp}, but the process group has {world} ranks")
    return Mesh(dist.group.WORLD, dist.get_rank(), world)


def shard_rows(n: int, mesh: Mesh) -> slice:
    """This rank's rows of a global batch of ``n``; ``n`` must split evenly."""
    if n % mesh.world:
        raise ValueError(f"a global batch of {n} rows does not split over {mesh.world} ranks")
    per = n // mesh.world
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(mesh: Mesh, batch, batch_axis: int = 0):
    """This rank's rows of every array or tensor in ``batch`` (a tuple, a
    list or one array), along ``batch_axis``."""
    def take(x):
        rows = shard_rows(x.shape[batch_axis], mesh)
        index = (slice(None),) * batch_axis + (rows,)
        return x[index]

    if isinstance(batch, (tuple, list)):
        return type(batch)(take(x) for x in batch)
    return take(batch)
