"""Fit the semantic k-means codebook over HuBERT features (port of
scripts/train_hubert_kmeans.py).

    python -m open_musiclm_torch.cli.train_hubert_kmeans [--results_folder DIR] [--device cpu]

Reads ``hubert_kmeans_trainer_cfg`` of the training config; writes
``kmeans.ckpt``, which ``--kmeans_path`` takes.
"""

import argparse

import torch

from .common import add_model_args, add_training_args, build_musiclm


def main(argv=None):
    p = argparse.ArgumentParser(description="fit the semantic k-means codebook")
    add_model_args(p)
    add_training_args(p)
    args = p.parse_args(argv)

    from ..config import load_model_config, load_training_config
    from ..data.dataset import SoundDataset, batch_iterator
    from ..train.tokenizer_trainers import HubertKmeansTrainer

    mc = load_model_config(args.model_config)
    cfg = load_training_config(args.training_config).hubert_kmeans_trainer_cfg
    musiclm, _ = build_musiclm(args)
    w2v = musiclm.wav2vec

    ds = SoundDataset(folder=cfg.folder, max_length_seconds=(mc.global_cfg.semantic_audio_length_seconds,),
                      normalize=(True,), target_sample_hz=(w2v.target_sample_hz,),
                      seq_len_multiple_of=(w2v.seq_len_multiple_of,))
    source = batch_iterator(ds, cfg.feature_extraction_batch_size, flatten_token_batches=False)
    trainer = HubertKmeansTrainer(hubert_kmeans=w2v, results_folder=args.results_folder,
                                  feature_extraction_num_steps=cfg.feature_extraction_num_steps,
                                  n_clusters=mc.hubert_kmeans_cfg.codebook_size)
    try:
        centroids = trainer.train((b[0] for b in source), torch.Generator(device=args.device).manual_seed(args.seed))
    finally:
        source.close()
    print(f"k-means saved to {args.results_folder}/kmeans.ckpt")
    return centroids


if __name__ == "__main__":
    main()
