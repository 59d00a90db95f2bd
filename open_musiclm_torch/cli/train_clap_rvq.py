"""Fit the CLAP residual-VQ conditioning codebooks (port of
scripts/train_clap_rvq.py).

    python -m open_musiclm_torch.cli.train_clap_rvq [--results_folder DIR] [--device cpu]

Reads ``clap_rvq_trainer_cfg`` of the training config and the RVQ's decay
and dead-code threshold of the model config; writes
``clap.rvq.{step}.ckpt``, which ``--rvq_path`` takes.
"""

import argparse

import torch

from .common import add_model_args, add_training_args, build_musiclm


def main(argv=None):
    p = argparse.ArgumentParser(description="fit the CLAP RVQ codebooks")
    add_model_args(p)
    add_training_args(p)
    args = p.parse_args(argv)

    from ..config import load_model_config, load_training_config
    from ..data.dataset import SoundDataset, batch_iterator
    from ..train.tokenizer_trainers import ClapRVQTrainer

    mc = load_model_config(args.model_config)
    cfg = load_training_config(args.training_config).clap_rvq_trainer_cfg
    musiclm, _ = build_musiclm(args)

    ds = SoundDataset(folder=cfg.folder, max_length_seconds=(mc.global_cfg.semantic_audio_length_seconds,),
                      normalize=(False,), target_sample_hz=(musiclm.clap.sample_rate,), seq_len_multiple_of=(None,))
    source = batch_iterator(ds, cfg.batch_size, flatten_token_batches=False)
    trainer = ClapRVQTrainer(
        clap=musiclm.clap, results_folder=args.results_folder, num_train_steps=cfg.num_train_steps,
        accumulate_batches=cfg.accumulate_batches, rq_ema_decay=mc.clap_rvq_cfg.rq_ema_decay,
        threshold_ema_dead_code=mc.clap_rvq_cfg.threshold_ema_dead_code,
        save_model_every=cfg.save_model_every, save_results_every=cfg.save_results_every,
    )
    try:
        return trainer.train((b[0] for b in source), torch.Generator(device=args.device).manual_seed(args.seed),
                             log=lambda **kw: print(kw))
    finally:
        source.close()


if __name__ == "__main__":
    main()
