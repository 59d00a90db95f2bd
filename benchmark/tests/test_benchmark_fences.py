"""Import fences: nothing the benchmark loads is JAX or the JAX package, and
the reference loads nothing of the program. Top-level names are compared
whole (open_musiclm_torch begins with the JAX package's name)."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from benchmark.run import FENCED, fenced_modules

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


def imported_tops(path: Path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_file_imports_jax():
    for path in BENCH.rglob("*.py"):
        assert not imported_tops(path) & set(FENCED), path


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        tops = imported_tops(path)
        assert "open_musiclm_torch" not in tops and not tops & set(FENCED), path
        for node in ast.walk(ast.parse(path.read_text())):  # and nothing outside the reference
            if isinstance(node, ast.ImportFrom) and node.level:
                assert node.level == 1, path


def test_names_are_compared_whole():
    assert fenced_modules(["open_musiclm_torch.models", "torch", "jaxtyping"]) == []
    assert fenced_modules(["open_musiclm_tpu.config", "jax.numpy"]) == ["jax", "open_musiclm_tpu"]


def test_no_jax_after_a_dry_run(tmp_path):
    from benchmark.tests import tiny

    tree = tiny.make(tmp_path)
    code = ("import sys, json; sys.argv[0] = 'run'; from benchmark import run; "
            f"rc = run.main(['--workload', 'tiny-gen', '--seed', '3', '--seconds', '1', '--trace', '0', "
            f"'--root', {str(tree)!r}, '--cpu']); "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "open_musiclm_torch" in loaded and not loaded & set(FENCED)
