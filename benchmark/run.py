"""Runs one cell of BENCHMARK.json once and prints its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration (``benchmark/configs/<config>.json``) and a
traffic mix (``benchmark/traffic/<traffic>.json``), whose ``kind`` picks
the module that runs it (``benchmark/kinds/<kind>.py``); the limits of its
correctness check are in ``benchmark/checks/<cell>.json`` and each
per-layer metric's reader is ``benchmark/metrics/<metric>.py``. A cell is
added with new files and one entry in BENCHMARK.json, never by an edit.

The run builds the program (open_musiclm_torch) with seeded weights on the
card, warms up the cell's shapes (all of it counts as ``setup_s``),
measures for ``--seconds``, reads the device's peak memory, frees the
program, and checks what the timed path produced against the plain
reference in ``benchmark/reference/``. The last line of standard output is
the JSON result; the numbers compared, each beside its limit, close both
standard error and that line. Without a card (or with fewer than the cell
asks for), or with JAX loaded once the window has closed, it prints no
result and exits with a code other than 0.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# top-level module names that may not be loaded in the process that prints
# the result: JAX, its libraries, and the JAX package the port was made from
FENCED = ("jax", "jaxlib", "flax", "optax", "orbax", "open_musiclm_tpu")


def fenced_modules(modules=None) -> list:
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FENCED))


def load_cell(root: Path, workload: str):
    """(bench, cell, config, traffic, limits, e2e metrics, per-layer metrics)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "benchmark" / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((root / "benchmark" / "checks" / f"{workload}.json").read_text())

    def mine(m):
        return workload in m.get("workloads", [workload])

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    per_layer = [m for m in bench["per_layer"] if mine(m)]
    return bench, cell, config, traffic, limits, e2e, per_layer


def reader(root: Path, name: str):
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # for the benchmark's own tests and readings, never passed by a check:
    p.add_argument("--root", default=str(ROOT), help="the tree holding BENCHMARK.json and benchmark/")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (tests at tiny sizes only)")
    p.add_argument("--control", action="store_true",
                   help="also read the control (the reference one precision below) beside the program")
    p.add_argument("--fault", help="plant a fault of benchmark/faults.py in the program")
    p.add_argument("--set", action="append", default=[], metavar="KEY=JSON",
                   help="override a traffic parameter (the serving sweep)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    root = Path(args.root)
    bench, cell, config, traffic, limits, e2e, per_layer = load_cell(root, args.workload)
    import torch

    if args.cpu:
        torch.set_num_threads(2)
        device = torch.device("cpu")
    else:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell["chips"]:
            print(f"benchmark: the cell needs {cell['chips']} CUDA card(s); this machine has {have}",
                  file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
        from benchmark.card import card_line

        print(f"card: {card_line()}", file=sys.stderr)
    for item in args.set:  # KEY or OUTER.KEY
        key, value = item.split("=", 1)
        *outer, key = key.split(".")
        node = traffic
        for k in outer:
            node = node[k]
        node[key] = json.loads(value)
    if args.fault:
        from benchmark.faults import plant

        plant(args.fault)
    kind = importlib.import_module(f"benchmark.kinds.{traffic['kind']}")
    ctx = kind.Context(root=root, cell=cell, config=config, traffic=traffic, limits=limits,
                         seed=args.seed, seconds=args.seconds, trace=bool(args.trace), device=device,
                         t_start=T_START, control=args.control)
    out = kind.run(ctx)

    found = fenced_modules()
    if found:
        print(f"benchmark: {found} loaded in the process that reports; the port may not load JAX",
              file=sys.stderr)
        return 4

    metrics = {}
    wanted = e2e if not args.trace else per_layer
    for m in wanted:
        value = out.e2e.get(m["name"]) if not args.trace else reader(root, m["name"])(out.layer)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if not args.trace:
        missing = [m["name"] for m in e2e if m["name"] not in metrics]
        if missing:
            print(f"benchmark: no reading of {missing}", file=sys.stderr)
            return 5
    dev = {"platform": "cpu" if args.cpu else "gpu",
           "kind": "cpu" if args.cpu else torch.cuda.get_device_name(0),
           "count": 1 if args.cpu else cell["chips"], "memory_peak_bytes": out.memory_peak_bytes}
    line = {"correct": out.correct, "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": dev}
    if args.trace and out.trace is not None:
        t = out.trace
        print(f"trace: {t['n_kernels']} kernels, {t['kernel_s']:.6f} s; by range {t['range_device_s']}",
              file=sys.stderr)
        dev["busy_s"] = out.trace["busy_s"]
        dev["window_s"] = out.window_s
        line["breakdown"] = {"device_ops": out.trace["device_ops"], "idle_gaps": out.trace["idle_gaps"]}
    if out.control is not None:
        line["control"] = out.control
    line["checks"] = out.checks
    for name, c in out.checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
