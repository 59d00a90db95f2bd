"""The coarse stage alone: semantic tokens of real audio -> generated coarse
tokens -> waveform (port of scripts/infer_coarse.py).

    python -m open_musiclm_torch.cli.infer_coarse in.wav --duration 4 [--device cpu]
"""

import argparse
from pathlib import Path

import torch

from .common import add_model_args, build_musiclm, generator


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("audio_files", nargs="+", help="input audio (wav)")
    add_model_args(p)
    p.add_argument("--duration", type=float, default=4.0)
    p.add_argument("--results_folder", default="./results/coarse_outputs")
    args = p.parse_args(argv)

    from ..data.audio_io import read_wav, write_wav

    musiclm, mc = build_musiclm(args)
    out_dir = Path(args.results_folder)
    out_dir.mkdir(parents=True, exist_ok=True)
    gen = generator(args)
    paths = []
    for f in args.audio_files:
        wav16, _ = read_wav(f, target_sr=musiclm.wav2vec.target_sample_hz)
        wav48, _ = read_wav(f, target_sr=musiclm.clap.sample_rate)
        n16 = int(args.duration * musiclm.wav2vec.target_sample_hz)
        with torch.no_grad():
            semantic_ids = musiclm.wav2vec(torch.from_numpy(wav16[:n16])[None].to(args.device))[..., None]
            clap_ids = musiclm.clap.tokenize_audio(torch.from_numpy(wav48)[None].to(args.device))
            coarse = musiclm.coarse_stage.generate(
                [clap_ids, semantic_ids], gen, max_time_steps=int(args.duration * mc.encodec_cfg.output_hz),
                temperature=0.95)
            wave = musiclm.codec.decode(coarse.to(args.device))
        path = out_dir / (Path(f).stem + "_coarse_generated.wav")
        write_wav(str(path), wave[0].float().cpu().numpy(), musiclm.codec.sample_rate)
        print(f"wrote {path}")
        paths.append(path)
    return paths


if __name__ == "__main__":
    main()
