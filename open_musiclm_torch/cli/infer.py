"""Text -> music (port of scripts/infer.py).

    python -m open_musiclm_torch.cli.infer "a prompt" --duration 4 \
        --tokenizer_path DIR [--int8 --flash_kv int8] [--device cpu]
"""

import argparse
from pathlib import Path

from .common import add_model_args, build_musiclm, generator, wav_name, window_kwargs


def main(argv=None):
    p = argparse.ArgumentParser(description="generate music from text prompts")
    p.add_argument("prompt", nargs="+", help="one or more text prompts")
    add_model_args(p)
    p.add_argument("--duration", type=float, default=4.0, help="seconds to generate")
    p.add_argument("--results_folder", default="./results/samples")
    p.add_argument("--return_coarse_wave", action="store_true",
                   help="decode from coarse tokens only (skip the fine stage)")
    args = p.parse_args(argv)

    from ..data.audio_io import write_wav

    musiclm, mc = build_musiclm(args)
    out_dir = Path(args.results_folder)
    out_dir.mkdir(parents=True, exist_ok=True)
    wave = musiclm.generate(text=list(args.prompt), generator=generator(args),
                            output_seconds=args.duration, **window_kwargs(mc),
                            return_coarse_generated_wave=args.return_coarse_wave)
    paths = []
    for i, prompt in enumerate(args.prompt):
        path = out_dir / f"{wav_name(prompt)}_generated.wav"
        write_wav(str(path), wave[i].float().cpu().numpy(), musiclm.codec.sample_rate)
        print(f"wrote {path}")
        paths.append(path)
    return paths


if __name__ == "__main__":
    main()
