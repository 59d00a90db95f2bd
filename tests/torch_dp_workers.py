"""Rank processes of tests/test_torch_parallel.py,
tests/test_torch_clip_train.py, tests/test_torch_tp.py and
tests/test_torch_serving_mesh.py: each joins a gloo group through a
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


def tp_stage(specs, dim: int, depth: int, heads: int, dim_head: int, dropout: float = 0.0):
    """A TokenConditionedTransformer of tests/test_torch_tp.py's geometry
    (its weights are loaded from the parent's state dict)."""
    from open_musiclm_torch.models.token_cond import TokenConditionedTransformer

    return TokenConditionedTransformer(specs, dim, depth, heads=heads, dim_head=dim_head, ff_dropout=dropout)


def tp_train(inputs, mesh, folder: Path, *, remat: bool, dropout: float, batches, seed=None, save=False):
    """StageTrainer steps on ``mesh`` from the parent's weights: (losses,
    the whole parameters, the trainer, its state). ``seed``: a generator
    seeded with ``mesh.rank_seed(seed)`` draws dropout and the forgetful
    mask."""
    from open_musiclm_torch.parallel.mesh import shard_batch
    from open_musiclm_torch.parallel.sharding import gather_state_dict
    from open_musiclm_torch.train.trainer import StageTrainer

    model = tp_stage(dropout=dropout, **inputs["geometry"])
    model.load_state_dict(inputs["state_dict"])
    model.transformer.remat = remat
    hp = dict(inputs["hp"], loss_cfg=inputs["dropout_loss_cfg"] if dropout else inputs["hp"]["loss_cfg"])
    trainer = StageTrainer(model=model, mesh=mesh, results_folder=str(folder), stage_name="tp",
                           use_tensorboard=False, save_model_every=0, **hp)
    state = trainer.init_state()
    state.optimizer.eps = inputs["eps"]
    gen = None if seed is None else torch.Generator().manual_seed(mesh.rank_seed(seed))
    losses = []
    for b in batches:
        state, loss = trainer.train_step(state, shard_batch(mesh, b, batch_axis=1), gen)
        losses.append(loss.item())
    if save:
        trainer.save(state, state.step)
    return losses, gather_state_dict(model), trainer, state


def tp_rank(rank: int, world: int, init_file: str, folder: str) -> None:
    """tests/test_torch_tp.py's ranks on ``make_mesh(dp=world // tp, tp)``:
    the trainer with and without remat (and with dropout and the forgetful
    mask on, under remat), a checkpoint written whole and read back into a
    new shard, and (tp 2 alone) the fp decode on the shard: greedy tokens
    and teacher-forced logits."""
    import torch.distributed as dist

    from open_musiclm_torch.models.token_cond import generate
    from open_musiclm_torch.parallel.mesh import make_mesh
    from open_musiclm_torch.parallel.sharding import gather_state_dict, shard_module

    _join(rank, world, init_file)
    folder = Path(folder)
    inputs = torch.load(folder / "inputs.pt", weights_only=False)  # the parent test wrote it
    mesh = make_mesh(tp=inputs["tp"])
    out = {"place": (mesh.rank, mesh.world, mesh.tp_rank, mesh.tp, mesh.is_main)}
    if inputs["tp"] == world:
        for remat in (False, True):
            losses, params, trainer, state = tp_train(inputs, mesh, folder / f"run{int(remat)}", remat=remat,
                                                      dropout=0.0, batches=inputs["batches"], save=not remat)
            out[f"remat{int(remat)}"] = (losses, params)
            if not remat:
                other = tp_train(inputs, mesh, folder / "run0", remat=False, dropout=0.0, batches=[])[2]
                restored = other.load(str(folder / "run0" / f"tp.transformer.{state.step}.ckpt"))
                out["restored"] = (restored.step, gather_state_dict(other.model),
                                   [m.clone() for m in restored.optimizer.mu], [m.clone() for m in state.optimizer.mu])
        losses, params, _, _ = tp_train(inputs, mesh, folder / "drop", remat=True, dropout=0.1,
                                        batches=inputs["dropout_batches"], seed=inputs["dropout_seed"])
        out["dropout"] = (losses, params)
        model = tp_stage(**inputs["geometry"])
        model.load_state_dict(inputs["state_dict"])
        shard_module(model.eval(), mesh)
        kw = dict(max_time_steps=inputs["decode_steps"], temperature=0.0)
        out["tokens"] = generate(model, [inputs["cond"]], **kw)
        out["logits"] = generate(model, [inputs["cond"]], teacher_ids=inputs["teacher"], return_logits=True, **kw)[1]
        out["shapes"] = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    else:
        out["step"] = tp_train(inputs, mesh, folder / "dp_tp", remat=False, dropout=0.0,
                               batches=inputs["batches"][:1])[:2]
    torch.save(out, folder / f"rank{rank}.pt")
    dist.destroy_process_group()


def serving_rank(rank: int, world: int, init_file: str, folder: str) -> None:
    """tests/test_torch_serving_mesh.py's ranks on ``make_mesh(dp=world)``:
    Stage.generate(mesh=) in every decode mode (tokens, and logits of a
    teacher-forced call), and MusicLM(serving_mesh=) with per-row keys
    (waves) and greedy (the codes reaching Encodec)."""
    import dataclasses

    import torch.distributed as dist

    from open_musiclm_torch.parallel.mesh import make_mesh

    _join(rank, world, init_file)
    folder = Path(folder)
    inputs = torch.load(folder / "inputs.pt", weights_only=False)  # the parent test wrote it
    mesh = make_mesh()
    musiclm, keys, clap = inputs["musiclm"], inputs["keys"], inputs["clap"]
    out = {"stage": {}}
    for quantized, flash_kv in inputs["modes"]:
        st = dataclasses.replace(musiclm.coarse_stage, quantized=quantized, flash_kv=flash_kv)
        out["stage"][(quantized, flash_kv)] = st.generate(
            inputs["stage_cond"], per_row_keys=keys, mesh=mesh, teacher_forced_ids=inputs["teacher"],
            return_logits=True, **inputs["stage_kw"])
    sharded = dataclasses.replace(musiclm, serving_mesh=mesh)
    codes = []

    def capture(decode):
        def wrapped(c):
            codes.append(c)
            return decode(c)
        return wrapped

    sharded._decode = capture(sharded._decode)
    out["waves"] = sharded.generate(clap_token_ids=clap, per_row_keys=keys, **inputs["gen_kw"])
    out["greedy"] = sharded.generate(clap_token_ids=clap, per_row_keys=keys, **dict(inputs["gen_kw"], **inputs["greedy"]))
    out["codes"] = codes
    torch.save(out, folder / f"rank{rank}.pt")
    dist.destroy_process_group()


def tp_options_rank(rank: int, world: int, init_file: str, folder: str) -> None:
    """tests/test_torch_options.py's ranks on ``make_mesh(tp=world)``: the
    parent's stage (attention and FF dropout) sharded, in train() mode, one
    loss and backward drawing from a generator seeded 20; writes the loss
    and the whole gradients (split ones gathered, the partial ones of
    replicated parameters summed over ``tp``)."""
    import torch.distributed as dist

    from open_musiclm_torch.models.token_cond import (
        StageLossConfig,
        TokenConditionedTransformer,
        stage_training_loss,
    )
    from open_musiclm_torch.parallel.mesh import make_mesh
    from open_musiclm_torch.parallel.sharding import gather_param_tensors, shard_module

    _join(rank, world, init_file)
    folder = Path(folder)
    inputs = torch.load(folder / "inputs.pt", weights_only=False)  # the parent test wrote it
    mesh = make_mesh(tp=world)
    model = TokenConditionedTransformer(**inputs["model_kw"])
    model.load_state_dict(inputs["state"])
    shard_module(model.train(), mesh)
    assert model.transformer.attns[0].heads == inputs["model_kw"]["heads"] // world
    loss, _ = stage_training_loss(model, inputs["ids"], StageLossConfig((0.5, 1.0), mask_prob=0.0),
                                  generator=torch.Generator().manual_seed(20), train=True)
    loss.backward()
    names = [n for n, _ in model.named_parameters()]
    grads = [p.grad for p in model.parameters()]
    mesh.tp_all_reduce_coalesced_([g for g, n in zip(grads, names) if n in model.tp_partial])
    whole = gather_param_tensors(model, grads)
    torch.save({"loss": loss.item(), "grads": dict(zip(names, whole))}, folder / f"rank{rank}.pt")
    dist.destroy_process_group()


def server_rank(rank: int, world: int, init_file: str, folder: str) -> None:
    """tests/test_torch_mesh_server.py's ranks: the doll-house MusicLM of
    tests/test_torch_serve.py over ``make_mesh(dp=world)`` behind one
    GenerationServer (buckets [2, 4], one worker). The front (rank 0) takes
    the parent's requests, submitted before the server starts so that the
    batches form alike in every run; every rank records the codes reaching
    Encodec; the front writes the waves. Also the two refusals: a bucket
    that dp does not divide, two workers. Then a second server whose first
    batch fails on rank 1 alone: rank 1's ``stop()`` raises it and its
    process ends; the front's request fails (it must not hang), and its
    ``stop()`` returns."""
    import torch.distributed as dist

    from open_musiclm_torch.parallel.mesh import make_mesh
    from open_musiclm_torch.serve import GenerationServer
    from tests.test_torch_serve import GEN_KW, SAMPLING_KW, tiny_musiclm

    _join(rank, world, init_file)
    folder = Path(folder)
    requests = torch.load(folder / "inputs.pt", weights_only=False)["requests"]  # the parent test wrote it
    musiclm = tiny_musiclm()
    musiclm.serving_mesh = make_mesh(dp=world)
    codes, decode = [], musiclm._decode

    def capture(c):
        codes.append(c.clone())
        return decode(c)

    musiclm._decode = capture
    refused = []
    for kw in (dict(batch_buckets=[1, 4]), dict(batch_buckets=[2, 4], num_workers=2)):
        try:
            GenerationServer(musiclm, batch_size=4, **kw)
        except ValueError as e:
            refused.append(str(e))
    server = GenerationServer(musiclm, batch_size=4, batch_buckets=[2, 4], batch_timeout_s=0.2,
                              **GEN_KW, **SAMPLING_KW)
    out = {"refused": refused, "front": server.is_front, "workers": server.num_workers}
    if server.is_front:
        futs = [server.submit(text, clap_token_ids=toks, seed=seed) for text, toks, seed in requests]
        server.start()
        out["waves"] = [f.result(timeout=120) for f in futs]
        server.stop()
    else:
        server.start().stop(timeout=None)
    out["codes"] = list(codes)

    generate = musiclm.generate

    def fails_once(*args, **kwargs):
        musiclm.generate = generate
        raise RuntimeError("injected fault on rank 1")

    if rank == 1:
        musiclm.generate = fails_once
    server = GenerationServer(musiclm, batch_size=2, batch_buckets=[2], batch_timeout_s=0.2,
                              **GEN_KW, **SAMPLING_KW)
    if server.is_front:
        fut = server.submit("alpha", seed=9)
        server.start()
        t0 = time.monotonic()
        try:
            fut.result(timeout=60)
            out["fault"] = "resolved"
        except Exception as e:  # the collective that rank 1 left
            out["fault"] = f"{type(e).__name__}: {e}"
        out["fault_s"] = time.monotonic() - t0
        server.stop(timeout=30)
        torch.save(out, folder / f"rank{rank}.pt")
    else:
        try:
            server.start().stop(timeout=60)
            out["fault"] = "returned"
        except RuntimeError as e:
            out["fault"] = f"{e} <- {e.__cause__}"
        torch.save(out, folder / f"rank{rank}.pt")
        return  # the process ends, which fails the front's pending collective
    dist.destroy_process_group()
