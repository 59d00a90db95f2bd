"""Train one MusicLM stage (port of scripts/train_stage.py).

    python -m open_musiclm_torch.cli.train_stage --stage coarse --bf16 \
        [--training_config JSON] [--results_folder DIR] [--continue_from_dir DIR] \
        [--fine_tune_from CKPT] [--num_workers 4] [--wandb] [--device cpu]

    # data parallel on N cards of one machine (NCCL; rank r on cuda:r)
    python -m torch.distributed.run --nproc_per_node N \
        -m open_musiclm_torch.cli.train_stage --stage coarse --bf16 ...

Under torchrun (or the JAX package's ``COORDINATOR_ADDRESS`` /
``NUM_PROCESSES`` / ``PROCESS_ID``) every rank joins the process group
(``parallel.distributed``; gloo with ``--device cpu``), reads and tokenizes
only its rows of each global batch (``batch_size`` of the trainer config is
the global batch) and draws its dropout from its own seed; rank 0 alone
writes the log, the trackers, the artifacts and the checkpoints.

The stage trainer config (``{stage}_trainer_cfg`` of the training config)
picks the data path: a token store (``use_preprocessed_data``) or audio
files tokenized on the fly by the frozen CLAP, HuBERT + k-means and Encodec
(built from the model flags, on ``--device``). ``--continue_from_dir``
resumes from the latest ``{stage}.transformer.{step}.ckpt`` there and runs
what is left of ``num_train_steps``; ``--fine_tune_from`` starts from a
stage's weights with a fresh optimizer. ``--bf16`` computes the stage in
bfloat16 on float32 master weights, and the towers in bfloat16. At the
``save_results_every`` cadence the predicted tokens and, for the coarse and
fine stages on the audio path, the teacher-forced reconstructions are
written beside the log.
"""

import argparse
import dataclasses

import torch
import torch.distributed as dist

from .common import add_model_args, add_training_args


def main(argv=None):
    p = argparse.ArgumentParser(description="train one MusicLM stage")
    p.add_argument("--stage", required=True, choices=["semantic", "coarse", "fine"])
    add_model_args(p)
    add_training_args(p)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--wandb", action="store_true",
                   help="log scalars and reconstruction audio to wandb (skipped if the package is "
                   "absent); tensorboard (where installed) and the JSONL log stay on")
    args = p.parse_args(argv)

    from ..config import target_device
    from ..parallel.distributed import initialize_distributed
    from ..parallel.mesh import make_mesh

    device = target_device(args.device, "train_stage")
    owns_group = not dist.is_initialized()
    if initialize_distributed(device.type) and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
        args.device = str(device)  # the towers of the audio path, on this rank's card
    try:
        return _train(args, device, make_mesh())
    finally:
        if owns_group and dist.is_initialized():
            dist.destroy_process_group()


def _train(args, device, mesh):
    from ..checkpoint import find_latest_checkpoint
    from ..config import init_stage, load_model_config, load_training_config
    from ..data.dataset import PreprocessedDataset, SoundDataset, batch_iterator, train_valid_split
    from ..data.pipeline import accumulate_token_batches, stage_ds_config, tokenizing_iterator
    from ..load import load_stage_params
    from ..models.token_cond import StageLossConfig
    from ..train.artifacts import save_predicted_tokens, save_reconstructed_wave
    from ..train.trainer import StageTrainer
    from .common import build_musiclm

    mc = load_model_config(args.model_config)
    tc = load_training_config(args.training_config)
    cfg = getattr(tc, f"{args.stage}_trainer_cfg")
    g = mc.global_cfg

    stage = init_stage(mc, args.stage, args.seed, device=device,
                       compute_dtype=torch.bfloat16 if args.bf16 else None)
    trainer = StageTrainer(
        model=stage.model, loss_cfg=StageLossConfig(tuple(cfg.cross_entropy_loss_weights)),
        lr=cfg.lr, wd=cfg.wd, lr_warmup=cfg.lr_warmup, max_grad_norm=cfg.max_grad_norm,
        grad_accum_every=cfg.grad_accum_every, results_folder=args.results_folder,
        save_model_every=cfg.save_model_every, save_results_every=cfg.save_results_every,
        stage_name=args.stage, use_wandb=args.wandb, wandb_run_config=dataclasses.asdict(cfg),
        mesh=mesh,
    )
    shard = dict(rank=mesh.rank, world=mesh.world)

    state = trainer.init_state()
    if args.continue_from_dir:
        latest = find_latest_checkpoint(args.continue_from_dir, f"{args.stage}.transformer")
        if latest:
            print(f"resuming from {latest}")
            state = trainer.load(latest)
    elif args.fine_tune_from:
        stage.model.load_state_dict(load_stage_params(args.fine_tune_from, stage.model))
        state = trainer.init_state()

    accum = cfg.grad_accum_every
    musiclm = None  # the tokenizers, on the audio path
    if cfg.use_preprocessed_data:
        ds = PreprocessedDataset(
            folder=cfg.folder, stage=args.stage,
            semantic_window_seconds=int(g.semantic_audio_length_seconds),
            coarse_window_seconds=int(g.coarse_audio_length_seconds),
            fine_window_seconds=int(g.fine_audio_length_seconds),
            semantic_steps_per_second=mc.hubert_kmeans_cfg.output_hz,
            acoustic_steps_per_second=mc.encodec_cfg.output_hz,
        )
        tr_idx, va_idx = train_valid_split(len(ds), cfg.valid_frac)
        sources = [batch_iterator(ds, cfg.batch_size, indices=tr_idx, num_workers=args.num_workers, **shard),
                   batch_iterator(ds, cfg.batch_size, indices=va_idx or tr_idx[:1], num_workers=1, **shard)]
        train_iter = accumulate_token_batches(sources[0], accum)
        valid_iter = sources[1]
    else:
        musiclm, _ = build_musiclm(args)
        sound_ds = SoundDataset(folder=cfg.folder, **stage_ds_config(
            args.stage, musiclm.clap, musiclm.wav2vec, musiclm.codec, g))
        tr_idx, va_idx = train_valid_split(len(sound_ds), cfg.valid_frac)
        sources = [batch_iterator(sound_ds, cfg.batch_size, indices=tr_idx, num_workers=args.num_workers,
                                  flatten_token_batches=False, **shard),
                   batch_iterator(sound_ds, cfg.batch_size, indices=va_idx or tr_idx[:1], num_workers=1,
                                  flatten_token_batches=False, **shard)]
        towers = (musiclm.clap, musiclm.wav2vec, musiclm.codec)
        train_iter = tokenizing_iterator(args.stage, sources[0], *towers,
                                         num_coarse_quantizers=g.num_coarse_quantizers, accum=accum)
        valid_iter = (tuple(x[0] for x in batch) for batch in tokenizing_iterator(
            args.stage, sources[1], *towers, num_coarse_quantizers=g.num_coarse_quantizers, accum=1))

    art_gen = torch.Generator(device=device).manual_seed(args.seed + 2)

    def artifact_fn(state, vb, step):
        # every rank takes part in the gathers; rank 0 writes
        logits, labels = trainer.artifact_logits(state, vb, art_gen)
        recon = cfg.save_reconstructed_wave and args.stage != "semantic" and musiclm is not None
        # the ground-truth coarse codes of every rank's rows
        cond = mesh.all_gather_rows(vb[1]) if recon and args.stage == "fine" else None
        if not mesh.is_main:
            return
        if cfg.save_predicted_tokens:
            save_predicted_tokens(logits, labels, args.results_folder, args.stage, step)
        if recon:
            pred = logits.argmax(dim=-1)[:, :-1]  # drop the EOS position
            out = save_reconstructed_wave(args.stage, pred, cond, musiclm.codec, g.num_coarse_quantizers,
                                          g.num_fine_quantizers, args.results_folder, step)
            if out is not None:
                trainer.log_audio(step, f"{args.stage}_recon", out[1], musiclm.codec.sample_rate)

    remaining = cfg.num_train_steps - state.step
    if mesh.is_main:
        backend = dist.get_backend() if dist.is_initialized() else "no process group"
        print(f"training {args.stage} stage for {remaining} steps on {mesh.world} rank(s) ({backend})")
    try:
        return trainer.train(state, train_iter, num_steps=remaining,
                             generator=torch.Generator(device=device).manual_seed(mesh.rank_seed(args.seed + 1)),
                             valid_iter=valid_iter, artifact_fn=artifact_fn)
    finally:
        for source in sources:
            source.close()


if __name__ == "__main__":
    main()
