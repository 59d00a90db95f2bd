"""The device mesh (port of open_musiclm_tpu/parallel/mesh.py): a ``dp x tp``
grid of processes.

``make_mesh(dp, tp)`` lays the process group out as the JAX package's
``reshape(dp, tp)`` grid, so rank ``r = d * tp + t``. ``Mesh`` names this
rank's place (d, t) and three groups: ``group``, the ``dp`` axis (the ranks
with this rank's t), over which the batch is split: each takes rows
``[d * B / dp, (d + 1) * B / dp)`` of a global batch of B rows
(``shard_batch``), as the JAX package's ``NamedSharding`` over ``dp`` does;
``tp_group``, the ``tp`` axis (the ranks with this rank's d), over which
``parallel/sharding.py`` splits a stage's weights (column- and row-parallel
attention and feed-forward, vocab-parallel embeddings and logit heads);
and ``everyone``, all dp x tp ranks (start-up broadcast, barriers, stop
flags). A group is None where its axis has one rank.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``Mesh()``: one process, no collectives. ``rank`` / ``world`` are this
    rank's d and the ``dp`` size, ``tp_rank`` / ``tp`` its t and the ``tp``
    size."""

    group: Optional[dist.ProcessGroup] = None
    rank: int = 0
    world: int = 1
    tp_group: Optional[dist.ProcessGroup] = None
    tp_rank: int = 0
    tp: int = 1
    everyone: Optional[dist.ProcessGroup] = None

    def __deepcopy__(self, memo):
        return self  # process groups are handles: a copied module shares them

    @property
    def is_main(self) -> bool:
        """The rank at (d 0, t 0), which writes logs and checkpoints."""
        return self.rank == 0 and self.tp_rank == 0

    def rank_seed(self, seed: int) -> int:
        """A seed of its own for this ``dp`` rank's draws (dropout, the
        forgetful mask): ``seed`` itself with one ``dp`` rank, else one drawn
        from (seed, d). The ranks of a ``tp`` group share it, so they draw
        the same masks."""
        if self.group is None:
            return seed
        return int(np.random.SeedSequence([seed, self.rank]).generate_state(1)[0])

    def all_reduce_(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``t`` reduced over the ``dp`` ranks, in place."""
        if self.group is not None:
            dist.all_reduce(t, op=op, group=self.group)
        return t

    def any(self, flag: bool, device=None) -> bool:
        """True on every rank if ``flag`` is set on any (an all-reduce MAX
        over ``everyone``)."""
        if self.everyone is None:
            return bool(flag)
        t = torch.tensor([int(flag)], dtype=torch.int32, device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.everyone)
        return bool(t.item())

    def assert_same(self, values: Sequence[int], what: str, device=None) -> None:
        """Raise unless every rank passes the same integers."""
        if self.everyone is None:
            return
        t = torch.tensor(list(values), dtype=torch.int64, device=device)
        hi, lo = t.clone(), t.clone()
        dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=self.everyone)
        dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=self.everyone)
        if not torch.equal(hi, lo):
            raise ValueError(f"{what} differs across ranks: {list(values)} here, from {lo.tolist()} to "
                             f"{hi.tolist()}")

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every ``dp`` rank's ``t`` (the same shape on each) concatenated
        along dim 0 in rank order."""
        if self.group is None:
            return t
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts, dim=0)

    def all_reduce_coalesced_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Sum each tensor over the ``dp`` ranks in place, as one flat buffer
        a dtype: one collective a dtype, not one a tensor."""
        self._flat_collective(tensors, self.group, lambda flat: dist.all_reduce(flat, group=self.group))

    def tp_all_reduce_coalesced_(self, tensors: Sequence[torch.Tensor]) -> None:
        """The same over the ``tp`` ranks."""
        self._flat_collective(tensors, self.tp_group, lambda flat: dist.all_reduce(flat, group=self.tp_group))

    def broadcast_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Global rank 0's values into ``tensors`` on every rank, as one flat
        buffer a dtype."""
        self._flat_collective(tensors, self.everyone, lambda flat: dist.broadcast(flat, src=0, group=self.everyone))

    @staticmethod
    def _flat_collective(tensors: Sequence[torch.Tensor], group, collective) -> None:
        if group is None:
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
        if self.everyone is not None:
            dist.barrier(group=self.everyone)


def make_mesh(dp: Optional[int] = None, tp: int = 1) -> Mesh:
    """The ``dp x tp`` mesh over the default process group
    (``initialize_distributed``), or a one-process mesh when there is none.
    ``dp`` (None: every rank over ``tp``) times ``tp`` must equal the group's
    size. Every rank of the group must make the same call: the axes' groups
    are made collectively."""
    if tp < 1 or (dp is not None and dp < 1):
        raise ValueError(f"dp={dp} x tp={tp}: each axis needs at least one rank")
    if not dist.is_initialized():
        if tp != 1 or dp not in (None, 1):
            raise ValueError(f"dp={dp} x tp={tp} needs a process group of that many ranks "
                             "(initialize_distributed)")
        return Mesh()
    world = dist.get_world_size()
    dp = world // tp if dp is None else dp
    if dp * tp != world:
        raise ValueError(f"dp={dp} x tp={tp}, but the process group has {world} ranks")
    if tp == 1:
        return Mesh(dist.group.WORLD, dist.get_rank(), world, everyone=dist.group.WORLD)
    d, t = divmod(dist.get_rank(), tp)
    dp_group = tp_group = None
    for tt in range(tp):  # every rank makes every group, in one order
        g = dist.new_group([dd * tp + tt for dd in range(dp)]) if dp > 1 else None
        dp_group = g if tt == t else dp_group
    for dd in range(dp):
        g = dist.new_group([dd * tp + tt for tt in range(tp)])
        tp_group = g if dd == d else tp_group
    return Mesh(dp_group, d, dp, tp_group, t, tp, dist.group.WORLD)


def shard_rows(n: int, mesh: Mesh) -> slice:
    """This ``dp`` rank's rows of a global batch of ``n``; ``n`` must split
    evenly."""
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
