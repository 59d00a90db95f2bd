"""Time open_musiclm_torch.orbax_io.read_orbax on a full-width JAX TrainState.

    python -m tests.orbax_read_bench [--folder DIR] [--model musiclm_small] [--stage coarse]

writes, in one process with the JAX package, the stage's ``TrainState``
(params, optax state with mu and nu, step) at the model's full width
through ``open_musiclm_tpu.train.trainer.StageTrainer.save``, as the JAX
trainer writes its checkpoints; then reads it in a fresh process with the
port alone and prints one JSON line: seconds, MB of arrays and MB/s, the
bytes on disk, and the reader process's peak resident memory
(``resource.getrusage``). The parameter shapes come from
``jax.eval_shape`` of the model's init and the values from numpy (seed 0),
so nothing of the model is computed: the file is what the trainer writes
after its init, with random moments.
"""

from __future__ import annotations

import argparse
import json
import resource
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def write(folder: Path, model: str, stage: str) -> str:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from open_musiclm_tpu import config as jconfig
    from open_musiclm_tpu.models.token_cond import StageLossConfig
    from open_musiclm_tpu.parallel.mesh import make_mesh
    from open_musiclm_tpu.train.trainer import StageTrainer, TrainState

    mc = jconfig.load_model_config(str(ROOT / "configs" / "model" / f"{model}.json"))
    net = getattr(jconfig, f"build_{stage}_transformer")(mc)
    ids = [jnp.zeros((1, n), jnp.int32) for n in jconfig.stage_example_lengths(mc, stage)]
    rng = np.random.default_rng(0)

    def draw(shape_tree, scale):
        return jax.tree_util.tree_map(
            lambda s: (rng.standard_normal(s.shape) * scale).astype(s.dtype) if s.shape
            else np.zeros((), s.dtype), shape_tree)

    params = draw(jax.eval_shape(net.init, jax.random.PRNGKey(0), ids), 0.02)
    trainer = StageTrainer(model=net, loss_cfg=StageLossConfig((1.0,) * len(net.specs)), mesh=make_mesh(dp=1),
                           results_folder=str(folder), stage_name=stage, use_tensorboard=False, lr_warmup=10)
    opt = jax.eval_shape(trainer.optimizer.init, params)
    opt = jax.tree_util.tree_map(lambda s: np.abs(rng.standard_normal(s.shape)).astype(s.dtype) * 1e-3
                                 if s.shape else np.full((), 7, s.dtype), opt)
    trainer.save(TrainState(params, opt, np.int32(7)), 7)
    return trainer.checkpoint_path(7)


def read(path: str) -> dict:
    from open_musiclm_torch.orbax_io import read_orbax

    t0 = time.perf_counter()
    tree = read_orbax(path)
    seconds = time.perf_counter() - t0

    def leaves(t):
        if isinstance(t, dict):
            return [x for v in t.values() for x in leaves(v)]
        if isinstance(t, list):
            return [x for v in t for x in leaves(v)]
        return [t] if hasattr(t, "nbytes") else []

    arrays = leaves(tree)
    mb = sum(int(a.nbytes) for a in arrays) / 1e6
    on_disk = sum(p.stat().st_size for p in Path(path).rglob("*") if p.is_file())
    return {"path": path, "seconds": seconds, "arrays": len(arrays), "array_mb": mb, "mb_per_s": mb / seconds,
            "on_disk_mb": on_disk / 1e6, "peak_rss_mb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024,
            "host": "CPU"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--folder", default=None, help="where to write the checkpoint (default: a temporary folder)")
    p.add_argument("--model", default="musiclm_small")
    p.add_argument("--stage", default="coarse", choices=["semantic", "coarse", "fine"])
    p.add_argument("--read", default=None, help="read this checkpoint only (the reading process)")
    args = p.parse_args(argv)
    if args.read:
        print(json.dumps(read(args.read)))
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        folder = Path(args.folder or tmp)
        t0 = time.perf_counter()
        path = write(folder, args.model, args.stage)
        print(f"wrote {path} with the JAX trainer in {time.perf_counter() - t0:.1f} s", flush=True)
        return subprocess.run([sys.executable, "-m", "tests.orbax_read_bench", "--read", path], cwd=ROOT).returncode


if __name__ == "__main__":
    sys.exit(main())
