"""run.py end to end on the CPU at tiny sizes: the result line's keys, the
refusals, the control's separation and the faults the check must catch."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("bench"))


def run_cli(tree, *args, cwd=ROOT):
    cmd = [sys.executable, str(ROOT / "benchmark" / "run.py"), "--root", str(tree), *args]
    return subprocess.run(cmd, capture_output=True, text=True, cwd=cwd, timeout=600)


@pytest.mark.parametrize("cell", sorted(tiny.TINY_CELLS))
def test_result_line_on_the_cpu(tree, cell):
    out = run_cli(tree, "--workload", cell, "--seed", str(2 ** 31 + 17), "--seconds", "1", "--trace", "0", "--cpu")
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line) == KEYS
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    e2e = tiny.TINY_CELLS[cell][2]
    assert set(line["metrics"]) == {"setup_s", e2e} or (cell == "tiny-serve" and set(line["metrics"]) == {
        "setup_s", "request_p50_s", "request_p80_s"})
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert line["device"]["platform"] == "cpu"
    err = out.stderr.strip().splitlines()
    assert all(err[-len(line["checks"]) + i].startswith(f"check {n}:") for i, n in enumerate(line["checks"]))


def test_trace_run_reports_no_device_metric_without_a_card(tree):
    out = run_cli(tree, "--workload", "tiny-gen", "--seed", "5", "--seconds", "1", "--trace", "1", "--cpu")
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert not {"stage_roofline.gen", "device_idle_pct.gen", "mfu.gen"} & set(line["metrics"])


def test_no_card_no_result(tree):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = run_cli(tree, "--workload", "tiny-gen", "--seed", "5", "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_result_without_the_program(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    cmd = [sys.executable, "benchmark/run.py", "--workload", "small-gen-b32", "--seed", "1", "--seconds", "1",
           "--trace", "0"]
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.parametrize("cell", sorted(tiny.TINY_CELLS))
def test_control_separates(tree, cell):
    """The reference one precision below, in the program's place, reads at
    least three times what the program reads on one of the cell's numbers."""
    out = run_cli(tree, "--workload", cell, "--seed", "11", "--seconds", "1", "--trace", "0", "--cpu", "--control")
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert any(line["control"][n] >= 3 * c["value"] for n, c in line["checks"].items()), line


@pytest.mark.parametrize("cell,fault", [("tiny-gen", "token"), ("tiny-serve", "token"),
                                        ("tiny-train", "frozen"), ("tiny-train", "half_batch")])
def test_a_planted_fault_is_caught(tree, cell, fault):
    out = run_cli(tree, "--workload", cell, "--seed", "23", "--seconds", "1", "--trace", "0", "--cpu",
                  "--fault", fault)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is False, line["checks"]
