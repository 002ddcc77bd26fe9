"""Build and load the hand-written CUDA kernels under `csrc/`.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled on first
use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/<name>-<hash>.so csrc/<name>.cu

into `img2img_turbo_tpu_torch/build/` (git-ignored), then loaded with
`ctypes`. The file name carries a hash of the source and of every header
in `csrc/`, so an edited kernel or header is rebuilt and a stale library
is never loaded. Nothing is built at import.

Launch accounting: every kernel wrapper adds one to `launch_counts[name]`
right where it launches its kernel, and nowhere else, so a run can show
that its main path went through the kernels (K8's du counts as K1, the
kernel the JAX package runs for it; K5's GroupNorm combine counts as
"group_norm_combine"). Every wrapper but K9's
also counts its launches by shape in `launch_shapes[name, shape]` (K1
"fused_gn_silu_conv3x3": (B, H, W, C, Co, GN prologue, extra bias,
residual, Csk, stats); K4 "upsample2x_conv3x3": (B, H, W, C, Co, Csk,
stats) of its low-resolution input; K2 "flash_attention_folded" and K7
"flash_attention_folded_bwd": (B, Sq, Skv, H, hd); K3 "fused_matmul": (M,
C, Co, outputs, LN, gate, residual); K6 "downsample2x_conv3x3": (B, H, W,
C, Co, pad_lo) of its input; du "conv3x3_input_grad": (B, H, W, C, Co) of
the forward conv C -> Co; K5 "group_norm_stats": (B, S, C) of its input,
with the combine of the same host call; K5's combine launched alone
"group_norm_combine": (B, tiles, C, groups) of the partial sums), so a
run can weight its per-shape times by the launches of a path.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = ("conv", "attention", "attention_bwd", "fused_matmul", "groupnorm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

launch_counts: collections.Counter = collections.Counter()
launch_shapes: collections.Counter = collections.Counter()

_libs: dict = {}
_lock = threading.Lock()


def reset_launch_counts() -> None:
    launch_counts.clear()
    launch_shapes.clear()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    """build/<name>-<hash>.so, the hash over the source, every header of
    `csrc/` (any of them may be included) and the nvcc flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        src += header.name.encode() + header.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{tag}.so"


def _compile_cmd(name: str, out: Path):
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def _compile(names) -> dict:
    """Compile every missing library among `names`, in parallel.
    Returns {name: seconds spent compiling it (0.0 if it was built)}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if not out.exists():
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            procs[name] = (subprocess.Popen(
                _compile_cmd(name, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), tmp, out,
                time.perf_counter())
    times = {name: 0.0 for name in names}
    errors = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for csrc/{name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def build(names=SOURCES) -> dict:
    """Compile (in parallel) and load every library among `names`.
    Returns {name: seconds spent compiling it}."""
    with _lock:
        times = _compile(names)
    for name in names:
        load(name)
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _compile([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream() -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
