"""Print a stage training step's roofline on the card (port of
scripts/roofline_train.py; train/roofline.py).

    python -m open_musiclm_torch.cli.roofline_train --stage coarse --batch 2 --accum 8
    python -m open_musiclm_torch.cli.roofline_train --stage coarse --model musiclm_large \
        --remat 1 --measured_ms 900 --json

Host arithmetic only: the stage is built on the meta device. The peaks are
the card's (``--device_name``, default ``torch.cuda.get_device_name(0)``:
without a card, name one). ``--measured_ms`` adds the bound's share of a
measured step.
"""

import argparse
import json
from pathlib import Path

import torch

from .common import REPO_ROOT


def main(argv=None):
    p = argparse.ArgumentParser(description="the roofline of a stage training step")
    p.add_argument("--stage", default="coarse", choices=["semantic", "coarse", "fine"])
    p.add_argument("--model", default="musiclm_small")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--accum", type=int, default=1)
    p.add_argument("--param_dtype", default="f32", choices=["f32", "bf16"])
    p.add_argument("--compute_dtype", default="bf16", choices=["f32", "bf16"])
    p.add_argument("--pallas", type=int, default=1,
                   help="1: kernels 1, 5 and 6 keep the scores on chip (the port); 0: count their passes")
    p.add_argument("--remat", type=int, default=0)
    p.add_argument("--device_name", default=None,
                   help="default: torch.cuda.get_device_name(0); e.g. 'NVIDIA H100 80GB HBM3' without a card")
    p.add_argument("--measured_ms", type=float, default=None)
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)

    from ..config import build_coarse_transformer, build_fine_transformer, build_semantic_transformer
    from ..config import load_model_config, stage_example_lengths
    from ..train.roofline import stage_train_roofline

    name = args.device_name
    if name is None:
        if not torch.cuda.is_available():
            raise SystemExit("roofline_train: no CUDA card; pass --device_name")
        name = torch.cuda.get_device_name(0)
    mc = load_model_config(str(Path(REPO_ROOT) / "configs" / "model" / f"{args.model}.json"))
    build = {"semantic": build_semantic_transformer, "coarse": build_coarse_transformer,
             "fine": build_fine_transformer}[args.stage]
    with torch.device("meta"):
        model = build(mc)
    r = stage_train_roofline(
        model, stage_example_lengths(mc, args.stage), args.batch, args.accum, device_name=name,
        compute_dtype_bytes=2 if args.compute_dtype == "bf16" else 4,
        param_dtype_bytes=2 if args.param_dtype == "bf16" else 4,
        pallas_attention=bool(args.pallas), remat=bool(args.remat),
    )
    out = {
        "stage": args.stage, "model": args.model, "batch": args.batch, "accum": args.accum,
        "device_kind": name, "pallas": bool(args.pallas), "remat": bool(args.remat),
        "param_dtype": args.param_dtype,
        **r.summary(args.measured_ms / 1e3 if args.measured_ms else None),
    }
    if args.json:
        print(json.dumps(out))
    else:
        print(f"{args.stage}[{args.model}] b{args.batch}x{args.accum} on {name}: {out['bound']}-bound, "
              f"floor {out['bound_ms']} ms (compute {out['compute_ms']} / memory {out['memory_ms']} ms), "
              f"MFU ceiling {out['mfu_ceiling'] * 100:.0f}%")
        for k, v in out["bytes_gb_by_term"].items():
            print(f"  {k:12s} {v:8.2f} GB")
        if args.measured_ms:
            print(f"  measured {args.measured_ms} ms = {100 * out['roofline_fraction']:.0f}% of roofline")
    return out


if __name__ == "__main__":
    main()
