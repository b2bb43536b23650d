"""Build and load the Hopper kernels of `unetseg_tpu_torch/csrc`.

One `nvcc` process per `csrc/*.cu`, all started together, compiles the
sources to objects; one more links them into a shared library with a
plain C interface, loaded with ctypes. The library goes to
`unetseg_tpu_torch/build/<hash>/`, keyed by a hash of the sources and the
flags, at first use; later calls in the process and later processes on
the same checkout reuse it. Nothing is compiled at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / "build"
GENCODE = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *GENCODE, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
)

P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C signatures of the kernels' entry points (csrc/*.cu); each returns the
# CUDA error code of its launch.
SIGNATURES = {
    "weighted_ce_fwd": [P, I, P, P, I, I, I, I, I, I, I, I, P, P],
    "weighted_ce_bwd": [P, I, P, P, P, I, I, I, I, I, I, I, I, P, P],
    "minplus_f32": [P, L, P, L, P, I, I, I, I, P],
    "conv3x3_bias_relu_bf16": [P, P, P, P, P, I, I, I, I, I, I, P],
    "dec_conv0_bf16": [P, I, I, I, I, I, P, I, I, I, P, P, P, I, I, I, P],
    "conv3x3_head_bf16": [P, P, P, P, P, P, I, I, I, I, I, P],
    "enc0_fused_bf16": [P, P, P, P, P, P, P, I, I, I, P],
    "dec_tail_bf16": [P, I, I, I, I, I, P, I, I, I, P, P, P, P, P, P, I, P, I, P],
    "tconv2x2_bias_bf16": [P, P, P, P, I, I, I, I, I, P],
    "conv3x3_dgrad_bf16": [P, P, P, I, I, I, I, I, P],
    "conv3x3_wgrad_bf16": [P, I, I, I, I, I, P, I, I, I, P, I, I, I, I, I, P, P, P],
    "sample_displaced_f32": [P, P, P, P, I, I, I, P, P, P],
    "fused_update_f32": [I, I, P, P, P, P, P, P, P, P, P, P, P, I, P, P],
    "fused_ema_f32": [I, P, P, P, P, P, F, P],
    "bn_relu_stats_bf16": [P, P, L, I, L, I, P, P],
    "bn_relu_fwd_finalize_f32": [P, I, I, P, P, I, L, F, P, P, P, P, F, F, F, P, P, P, P],
    "bn_relu_sums_f32": [P, I, I, P, P],
    "bn_relu_apply_bf16": [P, L, I, I, P, P, P],
    "bn_relu_bwd_stats_bf16": [P, P, L, I, I, P, P, P],
    "bn_relu_bwd_finalize_f32": [P, I, I, P, P, P, P, P, F, F, P, P, P, P, P, P],
    "bn_relu_dz_bf16": [P, P, P, L, I, L, I, P, P, P, P],
}


def sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> dict:
    """Compile the library if this source hash has no build yet.

    Returns {"path", "seconds", "log"}: `seconds` is 0.0 and `log` the
    saved compiler output when an existing build was reused."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / "libunetseg_kernels.so"
    log = out_dir / "nvcc.log"
    if lib.is_file():
        return {"path": str(lib), "seconds": 0.0, "log": log.read_text()}
    out_dir.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=out_dir))
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
               "-o", str(work / f"{src.stem}.o")]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)))
    text, failed = "", []
    for cmd, proc in jobs:  # wait for every compile, then report all failures
        out = proc.communicate()[0]
        text += out
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    if not failed:
        tmp = work / "lib.so"
        cmd = [nvcc, *GENCODE, "-shared", "-o", str(tmp), *sorted(map(str, work.glob("*.o")))]
        res = subprocess.run(cmd, capture_output=True, text=True)
        text += res.stdout + res.stderr
        if res.returncode != 0:
            failed.append(f"nvcc link failed ({res.returncode}):\n{' '.join(cmd)}\n"
                          f"{res.stdout}\n{res.stderr}")
    seconds = time.perf_counter() - t0
    if failed:
        shutil.rmtree(work, ignore_errors=True)
        raise RuntimeError("\n".join(failed))
    log.write_text(text)
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    shutil.rmtree(work, ignore_errors=True)
    return {"path": str(lib), "seconds": seconds, "log": text}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    lib = ctypes.CDLL(build()["path"])
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
