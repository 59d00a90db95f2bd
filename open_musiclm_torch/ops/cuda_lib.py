"""Build and bind the hand-written Hopper kernels in ``csrc/``.

Each ``csrc/*.cu`` file compiles in its own ``nvcc`` process, all started
together, and one more call links the objects into a single shared library
with a plain C interface (no PyTorch headers), loaded with ``ctypes``. The build runs at first use, never at
import, into ``build/open_musiclm_torch/`` at the repository root, keyed by
a hash of the sources and flags: an edited kernel rebuilds, an unchanged
one is reused.

Every C entry point takes its pointers and the CUDA stream as ``void*``,
launches on that stream without synchronising, and returns
``cudaGetLastError()``; :func:`check` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "open_musiclm_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# name -> argtypes; every entry point returns the cudaError_t as int
_SIGNATURES = {
    # x, w (aligned base), w_off, scale, out, part, tickets, B, K, N, cols, col_blocks, splits,
    # per, route, x_vec, dtype, stream
    "omt_int8_matmul": (_P, _P, _I, _P, _P, _P, _P) + (_I,) * 8 + (_P,),
    # q, kv, scales, bias_row, add_mask, out, part, ticket, b, heads, N, pos, splits, per,
    # scale, dtype, kv_dtype, stream
    "omt_flash_decode": (_P,) * 8 + (_I,) * 6 + (_F, _I, _I, _P),
    # q, k, v, bias, key_mask, out, stats, b, heads, n, m, causal, non_causal_prefix, scale,
    # dtype, bias_dtype, stream
    "omt_prefill_attention": (_P,) * 7 + (_I, _I, _I, _I, _I, _I, _F, _I, _I, _P),
    # q, k, v, bias, key_mask, out, stats, dout, delta, inv_l, tile_dead, dk_part, dv_part,
    # tickets, kv_split_prefix, dq, dk, dv, dbias, b, heads, n, m, causal, non_causal_prefix,
    # scale, dtype, bias_dtype, kv_splits, stream
    "omt_attention_bwd": (_P,) * 19 + (_I,) * 6 + (_F, _I, _I, _I, _P),
    # x, gin, wv, sv, wg, sg, conv_v, conv_g, state, g_out, new_state, xstats, part,
    # part_stats, midstats, tickets, B, dim, inner, cols, col_blocks, splits, per, dtype, stream
    "omt_fused_ff_in": (_P,) * 16 + (_I,) * 8 + (_P,),
    # g, midstats, gmid, wo, so, x, y, part, tickets, B, inner, dim, cols, col_blocks, splits,
    # per, dtype, stream
    "omt_fused_ff_out": (_P,) * 9 + (_I,) * 8 + (_P,),
    # x, the 19 weights of fused_layer._packed_specs in its order, kv, kv_scale, bias_row,
    # add_mask, state, y, krow, work, work_floats, plan, tickets, grid, smem, b, heads, dim,
    # inner, N, pos, chunk, n_chunks, scale, dtype, stream
    "omt_fused_layer": (_P,) * 28 + (ctypes.c_longlong, _P, _P) + (_I,) * 10 + (_F, _I, _P),
}

_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def library_path() -> Path:
    srcs = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libomt_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` unless this exact source set was built already.
    The compilers' output (ptxas register and spill report) is kept beside
    the library as ``build.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
    nvcc = _nvcc()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = Path(f"{tmp}.{src.stem}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((cmd, obj, proc))
    log, failed = [], []
    for cmd, _, proc in jobs:
        text = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + text)
        if proc.returncode != 0:
            failed.append(text)
    objs = [str(obj) for _, obj, _ in jobs]
    if not failed:
        cmd = [nvcc, "-shared", "-o", f"{tmp}.so", *objs]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout)
        if proc.returncode != 0:
            failed.append(proc.stdout)
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    for obj in objs:
        Path(obj).unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed)[-8000:])
    os.replace(f"{tmp}.so", out)
    return out


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        handle.omt_error_string.argtypes = [ctypes.c_int]
        handle.omt_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        msg = lib().omt_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# (kernel, device, stream) -> (int32 tickets, float32 partials) of the
# kernels that fold across blocks in one launch (kernels 2, 3, 4, 5 and 7)
_scratch: dict = {}


def scratch(kernel: str, device: torch.device, stream_id: int, n_tickets: int, n_floats: int):
    """(tickets [>= n_tickets] int32, floats [>= n_floats] float32) of
    ``kernel`` for launches on stream ``stream_id`` of ``device``, grown when
    a call needs more. Tickets are 0 between launches (the block that folds
    resets its own) and partials are written and read within a launch, so
    launches in stream order can share them, and only those do."""
    key = (kernel, device, stream_id)
    tickets, floats = _scratch.get(key, (None, None))
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(max(n_tickets, 64), dtype=torch.int32, device=device)
    if floats is None or floats.numel() < n_floats:
        floats = torch.empty(n_floats, dtype=torch.float32, device=device)
    _scratch[key] = (tickets, floats)
    return tickets, floats


def stream_scratch(kernel: str, t: torch.Tensor, n_tickets: int, n_floats: int):
    """``scratch`` for launches on the current stream of ``t``'s device."""
    return scratch(kernel, t.device, stream(t), n_tickets, n_floats)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def dtype_code(dtype: torch.dtype) -> int:
    """0 = float32, 1 = bfloat16: the activation types the kernels take."""
    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    raise TypeError(f"kernels take float32 or bfloat16 activations, got {dtype}")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """All tensors on one CUDA device and contiguous."""
    dev = tensors[0].device
    for t in tensors:
        require(t.is_cuda and t.device == dev, f"{name}: all tensors must be on {dev}")
        require(t.is_contiguous(), f"{name}: tensors must be contiguous")
