"""A copy of the benchmark with tiny cells added beside the real ones, as a
later change adds a cell: new configuration, traffic and check files and
one entry each in BENCHMARK.json, no edit of a file that is there."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# limits at the tiny sizes, where a bf16 pass of one 64-wide layer lies
# farther from float32 than the published widths do (the real cells'
# limits are in benchmark/checks/)
TINY_LIMITS = {
    "tiny-gen": {"logit_gap": 0.3, "wave_rel_err": 0.004},
    "tiny-serve": {"text_err": 1e-4, "token_gap": 0.3, "wave_rel_err": 0.004},
    "tiny-train": {"loss_rel_gap": 1e-3, "grad_norm_gap": 0.2, "change_norm_gap": 0.3},
}
TINY_CELLS = {
    "tiny-gen": ("offline_b32_4s", "small-gen-b32", "audio_s_per_s"),
    "tiny-serve": ("text_even_4s", "lsc-serve-text", "request_p80_s"),
    "tiny-train": ("coarse_train_b16", "small-coarse-train", "train_tokens_per_s"),
}
ONE_SECOND = {"output_seconds": 1, "semantic_window_seconds": 1, "coarse_window_seconds": 1,
              "fine_window_seconds": 1}


def make(tmp: Path) -> Path:
    """A tree holding BENCHMARK.json and benchmark/ with the tiny cells."""
    root = tmp / "tree"
    shutil.copytree(ROOT / "benchmark", root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    b = root / "benchmark"
    cfg = json.loads((b / "configs" / "musiclm_small.json").read_text())
    for s in ("semantic_cfg", "coarse_cfg", "fine_cfg"):
        cfg["model"][s].update(dim=64, depth=1, heads=2)
    cfg["name"] = "tiny"
    (b / "configs" / "tiny.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "tiny", "source": "test", "file": "benchmark/configs/tiny.json",
                             "reduced": [], "why": "test"})
    for cell, (traffic, real, e2e) in TINY_CELLS.items():
        tr = json.loads((b / "traffic" / f"{traffic}.json").read_text())
        if tr["kind"] == "generate":
            tr.update(batch=2, pool=2, greedy_every=2, check_rows=2)
        elif tr["kind"] == "serve":
            tr.update(rate=4.0, check_requests=2)
            tr["server"].update(batch_size=4, batch_buckets=[1, 4])
        else:
            tr.update(lengths=[12, 9, 30], batch=2)
        if "generate" in tr:
            tr["generate"].update(ONE_SECOND)
        (b / "traffic" / f"{cell}.json").write_text(json.dumps(tr))
        (b / "checks" / f"{cell}.json").write_text(json.dumps(TINY_LIMITS[cell]))
        bench["workloads"].append({"name": cell, "config": "tiny", "traffic": cell, "chips": 1, "why": "test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if real in m.get("workloads", []):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
