"""Train one MusicLM stage (port of scripts/train_stage.py).

    python -m open_musiclm_torch.cli.train_stage --stage coarse --bf16 \
        [--training_config JSON] [--results_folder DIR] [--continue_from_dir DIR] \
        [--fine_tune_from CKPT] [--num_workers 4] [--wandb] [--device cpu]

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

    from ..checkpoint import find_latest_checkpoint
    from ..config import init_stage, load_model_config, load_training_config, target_device
    from ..data.dataset import PreprocessedDataset, SoundDataset, batch_iterator, train_valid_split
    from ..data.pipeline import accumulate_token_batches, stage_ds_config, tokenizing_iterator
    from ..load import load_stage_params
    from ..models.token_cond import StageLossConfig
    from ..train.artifacts import save_predicted_tokens, save_reconstructed_wave
    from ..train.trainer import StageTrainer
    from .common import build_musiclm

    device = target_device(args.device, "train_stage")
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
    )

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
        sources = [batch_iterator(ds, cfg.batch_size, indices=tr_idx, num_workers=args.num_workers),
                   batch_iterator(ds, cfg.batch_size, indices=va_idx or tr_idx[:1], num_workers=1)]
        train_iter = accumulate_token_batches(sources[0], accum)
        valid_iter = sources[1]
    else:
        musiclm, _ = build_musiclm(args)
        sound_ds = SoundDataset(folder=cfg.folder, **stage_ds_config(
            args.stage, musiclm.clap, musiclm.wav2vec, musiclm.codec, g))
        tr_idx, va_idx = train_valid_split(len(sound_ds), cfg.valid_frac)
        sources = [batch_iterator(sound_ds, cfg.batch_size, indices=tr_idx, num_workers=args.num_workers,
                                  flatten_token_batches=False),
                   batch_iterator(sound_ds, cfg.batch_size, indices=va_idx or tr_idx[:1], num_workers=1,
                                  flatten_token_batches=False)]
        towers = (musiclm.clap, musiclm.wav2vec, musiclm.codec)
        train_iter = tokenizing_iterator(args.stage, sources[0], *towers,
                                         num_coarse_quantizers=g.num_coarse_quantizers, accum=accum)
        valid_iter = (tuple(x[0] for x in batch) for batch in tokenizing_iterator(
            args.stage, sources[1], *towers, num_coarse_quantizers=g.num_coarse_quantizers, accum=1))

    art_gen = torch.Generator(device=device).manual_seed(args.seed + 2)

    def artifact_fn(state, vb, step):
        logits, labels = trainer.artifact_logits(state, vb, art_gen)
        if cfg.save_predicted_tokens:
            save_predicted_tokens(logits, labels, args.results_folder, args.stage, step)
        if cfg.save_reconstructed_wave and args.stage != "semantic" and musiclm is not None:
            pred = logits.argmax(dim=-1)[:, :-1]  # drop the EOS position
            cond = vb[1] if args.stage == "fine" else None  # the ground-truth coarse codes
            out = save_reconstructed_wave(args.stage, pred, cond, musiclm.codec, g.num_coarse_quantizers,
                                          g.num_fine_quantizers, args.results_folder, step)
            if out is not None:
                trainer.log_audio(step, f"{args.stage}_recon", out[1], musiclm.codec.sample_rate)

    remaining = cfg.num_train_steps - state.step
    print(f"training {args.stage} stage for {remaining} steps")
    try:
        return trainer.train(state, train_iter, num_steps=remaining,
                             generator=torch.Generator(device=device).manual_seed(args.seed + 1),
                             valid_iter=valid_iter, artifact_fn=artifact_fn)
    finally:
        for source in sources:
            source.close()


if __name__ == "__main__":
    main()
