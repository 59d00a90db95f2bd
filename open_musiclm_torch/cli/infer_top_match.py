"""Batched generation with CLAP-similarity reranking (port of
scripts/infer_top_match.py).

    python -m open_musiclm_torch.cli.infer_top_match "a prompt" --num_samples 4 \
        --num_top_matches 1 --tokenizer_path DIR [--device cpu]
"""

import argparse
from pathlib import Path

from .common import add_model_args, build_musiclm, generator, wav_name, window_kwargs


def main(argv=None):
    p = argparse.ArgumentParser(description="generate N samples, keep best CLAP matches")
    p.add_argument("prompt", nargs="+")
    add_model_args(p)
    p.add_argument("--num_samples", type=int, default=4)
    p.add_argument("--num_top_matches", type=int, default=1)
    p.add_argument("--duration", type=float, default=4.0)
    p.add_argument("--results_folder", default="./results/samples")
    args = p.parse_args(argv)

    from ..data.audio_io import write_wav

    musiclm, mc = build_musiclm(args)
    out_dir = Path(args.results_folder)
    out_dir.mkdir(parents=True, exist_ok=True)
    samples, sims = musiclm.generate_top_match(
        text=list(args.prompt), num_samples=args.num_samples, num_top_matches=args.num_top_matches,
        generator=generator(args), output_seconds=args.duration, **window_kwargs(mc))
    paths = []
    for prompt, waves, sim in zip(args.prompt, samples, sims):
        for j in range(waves.shape[0]):
            path = out_dir / f"{wav_name(prompt)}_top_match_{j}.wav"
            write_wav(str(path), waves[j].float().cpu().numpy(), musiclm.codec.sample_rate)
            print(f"wrote {path} (clap similarity {float(sim[j]):.4f})")
            paths.append(path)
    return paths


if __name__ == "__main__":
    main()
