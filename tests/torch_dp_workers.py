"""Rank processes of tests/test_torch_parallel.py and
tests/test_torch_clip_train.py: each joins a gloo group through a
``file://`` store (so concurrent test workers never race for a port), runs
its share and writes its results for the parent to compare. This module
imports no JAX: the ranks are spawned processes that import it afresh.
"""

from __future__ import annotations

import multiprocessing
import time
from pathlib import Path

import torch

from open_musiclm_torch.parallel.distributed import initialize_distributed


def start_ranks(fn, world: int, args: tuple):
    """``fn(rank, world, *args)`` in ``world`` spawned processes, started."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=fn, args=(rank, world) + args) for rank in range(world)]
    for p in procs:
        p.start()
    return procs


def join_ranks(procs, timeout: float = 120.0) -> None:
    """Raises if a rank failed or the ranks are not done within ``timeout``
    seconds (then they are killed)."""
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        hung = [i for i, p in enumerate(procs) if p.is_alive()]
        if hung:
            raise TimeoutError(f"ranks {hung} still running after {timeout} s")
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise RuntimeError(f"rank exit codes {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)


def run_ranks(fn, world: int, args: tuple, timeout: float = 120.0) -> None:
    join_ranks(start_ranks(fn, world, args), timeout)


def tiny_stage(seed: int):
    """The trainer tests' stage: two sequences (16 codes, 2 and 1
    quantizers), dim 32, depth 2, 2 heads of 16."""
    from open_musiclm_torch.core.sequence import TokenSequenceSpec
    from open_musiclm_torch.models.token_cond import TokenConditionedTransformer

    specs = (TokenSequenceSpec(16, 2), TokenSequenceSpec(16, 1))
    return TokenConditionedTransformer(specs, 32, 2, heads=2, dim_head=16,
                                       generator=torch.Generator().manual_seed(seed))


def _join(rank: int, world: int, init_file: str) -> None:
    torch.set_num_threads(1)
    initialize_distributed("cpu", init_method=f"file://{init_file}", rank=rank, world_size=world)


def trainer_rank(rank: int, world: int, init_file: str, folder: str) -> None:
    """Two StageTrainer.train steps on this rank's rows of the global batches
    in ``folder``/inputs.pt (rank 0 saves a checkpoint after them), the eval
    loss and accuracy and the gathered artifact logits of a valid batch, a
    resume of the checkpoint into a differently seeded model, and
    ``Mesh.any`` of a flag set on the last rank only."""
    import torch.distributed as dist

    from open_musiclm_torch.checkpoint import find_latest_checkpoint
    from open_musiclm_torch.parallel.mesh import make_mesh, shard_batch
    from open_musiclm_torch.train.trainer import StageTrainer

    _join(rank, world, init_file)
    folder = Path(folder)
    inputs = torch.load(folder / "inputs.pt", weights_only=False)  # the parent test wrote it
    mesh = make_mesh()

    def trainer_of(model):
        return StageTrainer(model=model, mesh=mesh, results_folder=str(folder / "dp"), stage_name="test",
                            use_tensorboard=False, save_model_every=1, **inputs["hp"])

    model = tiny_stage(0)
    model.load_state_dict(inputs["state_dict"])
    trainer = trainer_of(model)
    state = trainer.init_state()
    state.optimizer.eps = inputs["eps"]
    shards = iter([shard_batch(mesh, b, batch_axis=1) for b in inputs["batches"]])
    gen = torch.Generator().manual_seed(mesh.rank_seed(0))
    state = trainer.train(state, shards, num_steps=len(inputs["batches"]), generator=gen)
    valid = shard_batch(mesh, inputs["valid"])
    loss, acc = trainer.eval_step(state, valid)
    logits, labels = trainer.artifact_logits(state, valid)

    other = trainer_of(tiny_stage(1))
    restored = other.load(find_latest_checkpoint(str(folder / "dp"), "test.transformer"))
    resumed = all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                    other.model.state_dict().values()))
    torch.save({"params": model.state_dict(), "step": state.step, "eval": (loss.item(), acc.item()),
                "logits": logits, "labels": labels, "resumed": resumed and restored.step == state.step,
                "any": mesh.any(rank == world - 1), "seed": mesh.rank_seed(0)},
               folder / f"rank{rank}.pt")
    dist.destroy_process_group()


def clip_rank(rank: int, world: int, init_file: str, folder: str) -> None:
    """clip_loss and clip_loss_mlp over this rank's rows of the features in
    ``folder``/features.pt, gathered over the group, with the gradients of
    this rank's rows."""
    import torch.distributed as dist

    from open_musiclm_torch.parallel.mesh import make_mesh, shard_batch
    from open_musiclm_torch.train.clip_loss import clip_loss, clip_loss_mlp

    _join(rank, world, init_file)
    folder = Path(folder)
    feats = torch.load(folder / "features.pt", weights_only=False)  # the parent test wrote it
    mesh = make_mesh()
    mine = [shard_batch(mesh, f).clone().requires_grad_(True) for f in feats["features"]]
    scale_a, scale_t = feats["scales"]
    out = {}
    loss = clip_loss(mine[0], mine[1], scale_a, group=mesh.group)
    out["clip"] = (loss.item(), [g for g in torch.autograd.grad(loss, mine[:2])])
    loss = clip_loss_mlp(*mine, scale_a, scale_t, group=mesh.group)
    out["mlp"] = (loss.item(), [g for g in torch.autograd.grad(loss, mine)])
    torch.save(out, folder / f"clip{rank}.pt")
    dist.destroy_process_group()
