"""Offline dataset tokenization into a token store (port of
scripts/preprocess_data.py).

    python -m open_musiclm_torch.cli.preprocess_data [--rank R --world N] \
        [--replace_existing] [--filter_fma] [--device cpu]

Reads ``data_preprocessor_cfg`` of the training config (the audio folder,
the store's folder, the crop length, the CLAP batch). Run one process a
rank: each writes its own shard of the store. Under torchrun (``python -m
torch.distributed.run --nproc_per_node N -m open_musiclm_torch.cli.preprocess_data``)
a rank and world not given as flags come from ``RANK`` and ``WORLD_SIZE``,
and each rank tokenizes on ``cuda:LOCAL_RANK``.
"""

import argparse
import os

from .common import add_model_args, add_training_args, build_musiclm


def main(argv=None):
    p = argparse.ArgumentParser(description="tokenize a folder of audio into a token store")
    add_model_args(p)
    add_training_args(p)
    p.add_argument("--rank", type=int, default=None, help="default: $RANK, else 0")
    p.add_argument("--world", type=int, default=None, help="default: $WORLD_SIZE, else 1")
    p.add_argument("--replace_existing", action="store_true")
    p.add_argument("--filter_fma", action="store_true",
                   help="drop low-engagement FMA experimental-genre tracks")
    args = p.parse_args(argv)
    if args.rank is None:
        args.rank = int(os.environ.get("RANK", 0))
    if args.world is None:
        args.world = int(os.environ.get("WORLD_SIZE", 1))
    if args.device == "cuda" and os.environ.get("LOCAL_RANK") is not None:
        args.device = f"cuda:{int(os.environ['LOCAL_RANK'])}"

    from ..config import load_model_config, load_training_config
    from ..data.preprocess import DataPreprocessor

    mc = load_model_config(args.model_config)
    cfg = load_training_config(args.training_config).data_preprocessor_cfg
    musiclm, _ = build_musiclm(args)

    ignore_files = None
    if args.filter_fma:
        from ..data.fma import fma_ignore_files

        ignore_files = fma_ignore_files(cfg.metadata_folder)
        print(f"filtering {len(ignore_files)} FMA experimental tracks")

    pre = DataPreprocessor(
        clap=musiclm.clap, wav2vec=musiclm.wav2vec, codec=musiclm.codec,
        folder=cfg.folder, results_folder=cfg.results_folder,
        num_coarse_quantizers=mc.global_cfg.num_coarse_quantizers,
        max_audio_length_seconds=cfg.max_audio_length_seconds,
        clap_audio_length_seconds=int(mc.global_cfg.clap_audio_length_seconds),
        semantic_audio_length_seconds=int(mc.global_cfg.semantic_audio_length_seconds),
        clap_batch_size=cfg.clap_batch_size, random_crop=cfg.random_crop, num_crops=cfg.num_crops,
        replace_existing=args.replace_existing, rank=args.rank, world=args.world, ignore_files=ignore_files,
    )
    n = pre.process(progress=lambda i, total: print(f"{i}/{total}", end="\r"))
    print(f"\nwrote {n} rows")
    return n


if __name__ == "__main__":
    main()
