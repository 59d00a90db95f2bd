"""The port's tools (open_musiclm_torch.cli.serving_deviation,
profile_pipeline, trace_train) on the CPU: the deviation tool's reductions
against a numpy copy of scripts/measure_serving_deviation.py's formulas,
the three CLIs end to end at doll-house size (their JSON carries the JAX
scripts' keys, with the stated differences), the fp-against-fp control,
and trace_train's reader on a trace the test writes (a bucket per launch
site, the buckets summing to the total). The teacher-forced logits the
deviation tool scores are held to JAX in tests/test_torch_tools_jax.py.
"""

import json

import numpy as np
import pytest

from open_musiclm_torch import config as tconfig
from open_musiclm_torch.cli import profile_pipeline, serving_deviation, trace_train

from tests.test_torch_load import _tiny_towers, tiny_model_config
from tests.torch_threads import one_torch_thread  # noqa: F401

# the JAX script's report keys (scripts/measure_serving_deviation.py,
# scripts/profile_pipeline.py) and the port's stated differences
JAX_DEVIATION_KEYS = {"model", "batch_rows", "serving_stack", "device", "stages", "knob_attribution",
                      "logit_perturbation", "margin_sweep_full_stack", "end_to_end"}
JAX_LADDER = {"int8_weights_only", "int8_w_plus_flash_bf16", "int8_w_plus_flash_f32", "int8_w_plus_flash_int8",
              "approx_topk_only_fp", "full_stack"}
JAX_STAGE_KEYS = {"decode_steps", "quantizers", "temperature", "per_step_token_mismatch_pct",
                  "free_running_rows_identical_pct", "mean_first_divergence_step", "total_flat_steps"}
JAX_PERTURBATION_KEYS = {"delta_rms", "delta_top2_abs_p50", "delta_top2_abs_p90", "fp_top2_gap_p50_random_init",
                         "exceedance_pct", "note"}
JAX_PROFILE_KEYS = {"batch", "seconds", "int8", "device", "semantic_window_s", "coarse_window_s", "fine_batched_s",
                    "encodec_decode_s", "clap_text_s", "audio_seconds_per_batch"}


# ---- numpy copies of the JAX script's reductions ----

def jax_free_running(free, ref, B):
    """scripts/measure_serving_deviation.py:183-198."""
    rows_equal = float(np.mean(np.all(free.reshape(B, -1) == ref.reshape(B, -1), axis=1)))
    flat_ref = ref.reshape(B, -1)
    flat_free = free.reshape(B, -1)
    first_div = []
    for r in range(B):
        neq = np.nonzero(flat_ref[r] != flat_free[r])[0]
        first_div.append(int(neq[0]) if len(neq) else flat_ref.shape[1])
    return {
        "free_running_rows_identical_pct": round(100 * rows_equal, 1),
        "mean_first_divergence_step": round(float(np.mean(first_div)), 1),
        "total_flat_steps": int(flat_ref.shape[1]),
    }


def jax_perturbation(L_fp, L_srv, gap_grid):
    """scripts/measure_serving_deviation.py:256-279."""
    Lf = np.asarray(L_fp, np.float32)
    Ls = np.asarray(L_srv, np.float32)
    valid = (Lf > -1e8) & (Ls > -1e8)
    d = np.where(valid, Ls - Lf, 0.0)
    order = np.argsort(Lf, axis=-1)
    t1, t2 = order[..., -1:], order[..., -2:-1]
    take = np.take_along_axis
    d_eff = take(d, t1, -1)[..., 0] - take(d, t2, -1)[..., 0]
    gap_fp = take(Lf, t1, -1)[..., 0] - take(Lf, t2, -1)[..., 0]
    return {
        "delta_rms": round(float(np.sqrt(np.mean(d[valid] ** 2))), 4),
        "delta_top2_abs_p50": round(float(np.median(np.abs(d_eff))), 4),
        "delta_top2_abs_p90": round(float(np.quantile(np.abs(d_eff), 0.9)), 4),
        "fp_top2_gap_p50_random_init": round(float(np.median(gap_fp)), 4),
        "exceedance_pct": {f">{g:g}": round(100 * float(np.mean(np.abs(d_eff) > g)), 3) for g in gap_grid},
    }


def jax_snr(w_fp, w_srv):
    """scripts/measure_serving_deviation.py:351-355 (with 357's rounding)."""
    err = w_fp - w_srv
    snr_db = 10.0 * np.log10((np.sum(w_fp**2) + 1e-12) / (np.sum(err**2) + 1e-12))
    rows_identical = float(np.mean(np.all(w_fp == w_srv, axis=-1)))
    return {"waveform_snr_db": round(float(snr_db), 2), "rows_waveform_identical_pct": round(100 * rows_identical, 1)}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reductions_equal_jax_formulas(seed):
    """Token mismatch, free-running rows and first divergence, the logit
    perturbation (masked EOS lanes, ties in the fp logits) and the SNR, on
    seeded arrays, equal the JAX script's numbers exactly."""
    rng = np.random.default_rng(seed)
    B, T, q, V = 6, 40, 3, 33
    ref = rng.integers(0, 16, (B, T, q))
    free = ref.copy()
    for r in range(B):  # rows 0 and 3 stay equal, the others flip from some step on
        if r % 3:
            t = rng.integers(0, T)
            free[r, t:, rng.integers(0, q)] += 1
    assert serving_deviation.free_running(free, ref) == jax_free_running(free, ref, B)
    scored = np.where(rng.random((B, T, q)) < 0.07, ref + 1, ref)
    assert serving_deviation.token_mismatch(scored, ref) == float(np.mean(scored != ref))

    L_fp = rng.standard_normal((B, T * q, V)).astype(np.float32) * 3
    L_fp[..., -1] = -1e9  # the masked EOS lane
    L_fp[0, :5, 2] = L_fp[0, :5].max(-1)  # ties at the top
    L_srv = (L_fp + rng.standard_normal(L_fp.shape).astype(np.float32) * 0.2).astype(np.float32)
    L_srv[..., -1] = -1e9
    got = serving_deviation.logit_perturbation(L_fp, L_srv)
    assert got.pop("note") == serving_deviation.PERTURBATION_NOTE
    assert got == jax_perturbation(L_fp, L_srv, serving_deviation.GAP_GRID)

    w_fp = rng.standard_normal((B, 480)).astype(np.float32)
    w_srv = w_fp.copy()
    w_srv[1:3] += rng.standard_normal((2, 480)).astype(np.float32) * 0.3
    assert serving_deviation.waveform_comparison(w_fp, w_srv) == jax_snr(w_fp, w_srv)
    assert serving_deviation.waveform_comparison(w_fp, w_fp) == jax_snr(w_fp, w_fp)


@pytest.fixture(scope="module")
def tiny_config(tmp_path_factory) -> str:
    return tiny_model_config(tmp_path_factory.mktemp("tiny"))


def test_fp_control_reads_zero(tiny_config):
    """``measure`` with the fp decode as the stack under test: 0 % mismatch,
    every row identical, unmoved logits, equal waves and the SNR at its cap
    (the fp waves' energy over the 1e-12 floor)."""
    mc = tconfig.load_model_config(tiny_config)
    parts = serving_deviation.build_parts(mc, "cpu")
    report = serving_deviation.measure(mc, batch=2, device="cpu", knobs=False, margin_scales=(), step_fraction=0.2,
                                       serving=serving_deviation.FP, parts=parts, log=lambda line: None)
    for st in report["stages"].values():
        assert st["per_step_token_mismatch_pct"] == 0.0
        assert st["free_running_rows_identical_pct"] == 100.0
        assert st["mean_first_divergence_step"] == st["total_flat_steps"]
    for lp in report["logit_perturbation"].values():
        assert lp["delta_rms"] == 0.0 and set(lp["exceedance_pct"].values()) == {0.0}
    e2e = report["end_to_end"]
    assert e2e["rows_waveform_identical_pct"] == 100.0
    assert e2e["waveform_snr_db"] > 100  # 10 log10(energy / 1e-12)
    assert report["serving_stack"] == {"int8_weights": False, "flash_kv": None, "approx_topk": False}
    assert report["kernel_launches"] == {"end_to_end_serving": {}, "end_to_end_fp": {}}  # the CPU: plain versions


def test_serving_deviation_cli(tiny_config, tmp_path, capsys):
    """``python -m open_musiclm_torch.cli.serving_deviation --device cpu``
    at doll-house size: the JAX script's keys, no approx_topk rung, the
    fused rung added, percentages in [0, 100], and the JSON file."""
    out = tmp_path / "dev.json"
    report = serving_deviation.main(["--device", "cpu", "--model_config", tiny_config, "--batch", "2",
                                     "--margin_scales", "4", "--json", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(report))
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == json.loads(json.dumps(report))
    assert set(report) - JAX_DEVIATION_KEYS == {"port_differences", "kernel_launches"}
    assert set(report["knob_attribution"]) == JAX_LADDER - {"approx_topk_only_fp"} | {"int8_w_plus_fused"}
    assert report["serving_stack"] == {"int8_weights": True, "flash_kv": "int8", "approx_topk": False}
    assert report["knob_attribution"]["full_stack"] == report["knob_attribution"]["int8_w_plus_flash_int8"]
    assert report["model"] == "tiny_model" and report["batch_rows"] == 2
    for name, st in report["stages"].items():
        assert set(st) == JAX_STAGE_KEYS, name
        assert 0 <= st["per_step_token_mismatch_pct"] <= 100
        assert 0 <= st["free_running_rows_identical_pct"] <= 100
        assert set(report["logit_perturbation"][name]) == JAX_PERTURBATION_KEYS
    assert list(report["margin_sweep_full_stack"]) == ["x4"]
    assert set(report["end_to_end"]) == {"output_seconds", "waveform_snr_db", "rows_waveform_identical_pct", "note",
                                         "wave_samples"}
    assert report["stages"]["semantic"]["decode_steps"] == 100  # 2 s at 50 Hz: the config's real geometry


def test_profile_pipeline_cli(tiny_config, monkeypatch, capsys):
    """``python -m open_musiclm_torch.cli.profile_pipeline --device cpu`` at
    doll-house size (towers narrowed through the config's builders): the
    JAX script's keys, each piece's launches a call, and the stages in
    Stage's default mode, which $OPEN_MUSICLM_FLASH_KV picks as in the JAX
    package."""
    _tiny_towers(monkeypatch)
    monkeypatch.setenv("OPEN_MUSICLM_FLASH_KV", "fused")
    report = profile_pipeline.main(["--device", "cpu", "--model_config", tiny_config, "--batch", "2",
                                    "--seconds", "2", "--reps", "1"])
    assert json.loads(capsys.readouterr().out) == json.loads(json.dumps(report))
    assert set(report) - JAX_PROFILE_KEYS == {"flash_kv", "launches", "kernel_launches"}
    assert report["flash_kv"] == "fused" and report["int8"] is True
    assert report["audio_seconds_per_batch"] == 4.0
    for piece in profile_pipeline.PIECES:
        assert report[piece] > 0 and report["launches"][piece] > 0, piece
        assert report["kernel_launches"][piece] == {}  # the CPU runs the plain versions


def test_trace_train_cli(tiny_config, tmp_path, capsys):
    """``python -m open_musiclm_torch.cli.trace_train --device cpu``: one
    traced coarse step of the doll-house stage, the leaf host ops standing
    in for kernels; every bucket present, their sum the total; then
    ``--parse_only`` reads the same trace back."""
    report = trace_train.main(["--device", "cpu", "--model_config", tiny_config, "--batch", "2", "--steps", "1",
                               "--trace_dir", str(tmp_path), "--top", "5"])
    assert "captured 1 steps" in capsys.readouterr().out
    assert report["steps"] == 1 and not report["on_device"]
    assert list(report["buckets_ms_per_step"]) == list(trace_train.BUCKETS)
    total = report["device_ms_per_step"]
    assert total > 0 and sum(report["buckets_ms_per_step"].values()) == pytest.approx(total, rel=1e-12)
    for bucket in ("attention", "ff", "logits_loss", "optimizer"):
        assert report["buckets_ms_per_step"][bucket] > 0, bucket
    assert len(report["top"]) == 5
    again = trace_train.main(["--parse_only", "--trace_dir", str(tmp_path), "--json", str(tmp_path / "t.json")])
    assert again["buckets_ms_per_step"] == report["buckets_ms_per_step"]
    assert json.loads((tmp_path / "t.json").read_text())["trace"] == report["trace"]


def _trace_events():
    """A Chrome trace as torch.profiler writes it on a card: one train step
    on the main thread (tid 1), its backward on the autograd engine's thread
    (tid 2), kernels tied to their launches by correlation; the card's
    timeline repeats the step range, and one kernel is launched after it."""
    ev = []

    def host(cat, name, ts, dur, tid=1, **args):
        ev.append({"ph": "X", "cat": cat, "name": name, "pid": 10, "tid": tid, "ts": ts, "dur": dur, "args": args})

    def launch(corr, ts, kernel, start, dur, tid=1, cat="kernel", runtime="cudaLaunchKernel"):
        host("cuda_runtime", runtime, ts, 2, tid, correlation=corr)
        ev.append({"ph": "X", "cat": cat, "name": kernel, "pid": 0, "tid": 7, "ts": start, "dur": dur,
                   "args": {"correlation": corr, "External id": 999}})

    host("user_annotation", trace_train.STEP_RANGE, 0, 1000)
    ev.append({"ph": "X", "cat": "gpu_user_annotation", "name": trace_train.STEP_RANGE, "pid": 0, "tid": 8,
               "ts": 50, "dur": 900})
    host("user_annotation", "stage_loss", 10, 300)
    host("user_annotation", "omt:model", 20, 250)
    host("cpu_op", "aten::cat", 22, 4, **{"Sequence number": 3})
    launch(4, 23, "void at::native::CatArrayBatchedCopy<float>()", 100, 3)
    host("user_annotation", "omt:transformer", 30, 200)
    host("user_annotation", "omt:attn", 35, 90)
    host("cpu_op", "aten::mm", 40, 20, **{"Sequence number": 7})
    launch(1, 45, "sm90_xmma_gemm_bf16bf16_bf16f32", 60, 30)
    host("cpu_op", "aten::rand", 70, 10)
    host("cpu_op", "aten::uniform_", 71, 8)
    launch(2, 72, "void at::native::distribution_elementwise_grid_stride_kernel<float>()", 95, 5)
    host("user_annotation", "omt:ff", 140, 80)
    host("cpu_op", "aten::gelu", 150, 10, **{"Sequence number": 8})
    launch(3, 152, "void at::native::vectorized_elementwise_kernel<4, GeluCUDAKernelImpl>()", 110, 7)
    host("cpu_op", "aten::add", 225, 3, **{"Sequence number": 9})  # the residual add
    launch(10, 226, "void at::native::vectorized_elementwise_kernel<4, CUDAFunctor_add<c10::BFloat16>>()", 120, 2)
    host("cpu_op", "autograd::engine::evaluate_function: MmBackward0", 400, 50, tid=2, **{"Sequence number": 7})
    host("cpu_op", "MmBackward0", 401, 48, tid=2, **{"Sequence number": 7})
    launch(5, 410, "void (anonymous namespace)::bwd_bf16_kernel<__nv_bfloat16>((anonymous namespace)::Bf16Args)",
           420, 11, tid=2)
    host("cpu_op", "autograd::engine::evaluate_function: GeluBackward0", 460, 30, tid=2, **{"Sequence number": 8})
    launch(6, 465, "void (anonymous namespace)::dbias_bf16_kernel((anonymous namespace)::DbiasArgs)", 440, 13,
           tid=2)
    host("cpu_op", "autograd::engine::evaluate_function: FooBackward0", 500, 20, tid=2, **{"Sequence number": 99})
    launch(11, 505, "foo_kernel", 460, 1, tid=2)
    host("user_annotation", "optimizer_step", 600, 100)
    host("cpu_op", "aten::_foreach_add_", 610, 30)
    launch(7, 615, "void at::native::multi_tensor_apply_kernel<>()", 500, 17)
    host("cpu_op", "c10d::allreduce_", 720, 20)
    launch(9, 725, "ncclDevKernel_AllReduce_Sum_f32_RING_LL", 530, 4)
    host("cpu_op", "aten::copy_", 800, 20)
    launch(8, 805, "Memcpy DtoH (Device -> Pinned)", 560, 6, cat="gpu_memcpy", runtime="cudaMemcpyAsync")
    launch(12, 2000, "late_kernel", 2010, 50)  # after the step: not counted
    return ev


def test_trace_train_parses_a_written_trace(tmp_path, capsys):
    """``--parse_only`` on a trace the test writes: each kernel in the
    bucket of its launch site (a backward kernel in its forward op's, by
    sequence number), the families by kernel name, the buckets summing to
    the device total, the step's span and gap; the card's copy of the step
    range is not a step."""
    (tmp_path / "trace_1.json").write_text(json.dumps({"traceEvents": _trace_events()}))
    report = trace_train.main(["--parse_only", "--trace_dir", str(tmp_path), "--top", "3"])
    assert "-- bucket totals (per step) --" in capsys.readouterr().out
    us = 1e-3  # ms a microsecond
    assert report["steps"] == 1 and report["on_device"]
    want = {"attention": (30 + 11) * us, "ff": (7 + 13) * us, "relpos": 0.0, "logits_loss": 3 * us,
            "optimizer": 17 * us, "dropout_rng": 5 * us, "plumbing": (2 + 6) * us, "collectives": 4 * us,
            "other": 1 * us}
    assert report["buckets_ms_per_step"] == pytest.approx(want, abs=1e-12)
    total = sum(want.values())
    assert report["device_ms_per_step"] == pytest.approx(total, abs=1e-12)
    assert sum(report["buckets_ms_per_step"].values()) == pytest.approx(total, abs=1e-12)
    assert report["launches_per_step"] == 11
    assert report["span_ms_per_step"] == pytest.approx((566 - 60) * us, abs=1e-12)
    assert report["gap_ms_per_step"] == pytest.approx((566 - 60) * us - total, abs=1e-12)
    fams = report["family_launches_per_step"]
    assert fams["kernel 5 attention_bwd"] == 1 and fams["kernel 6 attention_dbias"] == 1
    assert fams["cuBLAS GEMM"] == 1 and fams["copies"] == 2
    assert [(row["name"], row["op"]) for row in report["top"]] == [
        ("sm90_xmma_gemm_bf16bf16_bf16f32", "aten::mm"),
        ("void at::native::multi_tensor_apply_kernel<>()", "aten::_foreach_add_"),
        ("void (anonymous namespace)::dbias_bf16_kernel((anonymous namespace)::DbiasArgs)",
         "autograd::engine::evaluate_function: GeluBackward0")]
