"""The fine stage alone: coarse Encodec codes of real audio -> generated fine
tokens -> waveform (port of scripts/infer_fine.py).

    python -m open_musiclm_torch.cli.infer_fine in.wav --duration 2 [--device cpu]
"""

import argparse
from pathlib import Path

import torch

from .common import add_model_args, build_musiclm, generator


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("audio_files", nargs="+")
    add_model_args(p)
    p.add_argument("--duration", type=float, default=2.0)
    p.add_argument("--results_folder", default="./results/fine_outputs")
    args = p.parse_args(argv)

    from ..data.audio_io import read_wav, write_wav

    musiclm, mc = build_musiclm(args)
    out_dir = Path(args.results_folder)
    out_dir.mkdir(parents=True, exist_ok=True)
    n_coarse = mc.global_cfg.num_coarse_quantizers
    gen = generator(args)
    paths = []
    for f in args.audio_files:
        wav24, _ = read_wav(f, target_sr=musiclm.codec.sample_rate)
        wav48, _ = read_wav(f, target_sr=musiclm.clap.sample_rate)
        n24 = int(args.duration * musiclm.codec.sample_rate)
        with torch.no_grad():
            coarse_ids = musiclm.codec.encode(torch.from_numpy(wav24[:n24])[None].to(args.device))[..., :n_coarse]
            clap_ids = musiclm.clap.tokenize_audio(torch.from_numpy(wav48)[None].to(args.device))
            fine = musiclm.fine_stage.generate(
                [clap_ids, coarse_ids], gen, max_time_steps=int(args.duration * mc.encodec_cfg.output_hz),
                temperature=0.4)
            acoustic = torch.cat([coarse_ids[:, : fine.shape[1]], fine.to(coarse_ids.device)], dim=-1)
            wave = musiclm.codec.decode(acoustic)
        path = out_dir / (Path(f).stem + "_fine_generated.wav")
        write_wav(str(path), wave[0].float().cpu().numpy(), musiclm.codec.sample_rate)
        print(f"wrote {path}")
        paths.append(path)
    return paths


if __name__ == "__main__":
    main()
