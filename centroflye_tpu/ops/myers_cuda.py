"""Two-strand Myers recruitment scorer: a CUDA kernel on NVIDIA GPUs.

The recruitment hot path scores every surviving segment against the unit
and its reverse complement (reference rr.cpp:74-79, edlib HW mode). The
plain formulation (ops/myers.myers_distance_batch) is a `lax.scan` over
text columns, which XLA runs as a device loop of several kernels per
column with the (B, W) bit state in device memory. The CUDA kernel
(ops/cuda/myers_hw.cu) keeps that state in registers for the whole row:
one warp per (row, strand), the query's words spread over the lanes.

`two_strand_scorer(platform, m)` is the single choice point: the kernel
on a GPU for units up to MAX_M bases, the plain XLA scan otherwise (the
CPU, and longer units). Both return identical integers.

The library is compiled from the tracked source with nvcc at first use
into ops/cuda/build/ (or ahead of time with `python -m
centroflye_tpu.ops.myers_cuda`). A GPU run without nvcc is an error.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import tempfile

import jax
import jax.numpy as jnp
import numpy as np

from centroflye_tpu.ops.myers import myers_distance_batch, n_words

_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda")
_SRC = os.path.join(_DIR, "myers_hw.cu")
BUILD_DIR = os.path.join(_DIR, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libcf_myers_hw.so")
TARGET = "cf_myers_hw_2strand"

MAX_M = 32 * 32 * 8      # lanes x bits x words per lane (myers_hw.cu)
TEXT_ALIGN = 16          # the kernel stages text rows in 16-byte loads

_lib = None              # the loaded kernel library, once registered


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set NVCC or CUDA_HOME): the GPU recruitment "
        "kernel is built from ops/cuda/myers_hw.cu")


def build_kernels() -> str:
    """Compile the kernel library if it is missing or older than its
    source; returns its path. Raises RuntimeError when nvcc is missing or
    the build fails."""
    if (os.path.exists(LIB_PATH)
            and os.path.getmtime(LIB_PATH) >= os.path.getmtime(_SRC)):
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", "arch=compute_90,code=[sm_90,compute_90]",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir(), "-o", tmp, _SRC]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.remove(tmp)
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{res.stderr}")
    os.replace(tmp, LIB_PATH)   # atomic: concurrent builders never race
    return LIB_PATH


def _register() -> None:
    global _lib
    if _lib is not None:
        return
    lib = ctypes.cdll.LoadLibrary(build_kernels())
    jax.ffi.register_ffi_target(
        TARGET, jax.ffi.pycapsule(lib.CfMyersHw2Strand), platform="CUDA")
    _lib = lib


@functools.partial(jax.jit, static_argnames=("m",))
def myers_hw_2strand(peq_f, peq_r, text, lens, *, m: int):
    """HW distances of the unit (peq_f) and its reverse complement (peq_r)
    against every row of text. peq_* (5, W) uint32 (ops/myers.build_peq),
    text (B, L) int8 codes, lens (B,) int32. Returns dict(dist_f, end_f,
    dist_r, end_r), each (B,) int32, equal to myers_distance_batch's
    dist/end in mode HW. GPU only."""
    if not 1 <= m <= MAX_M or n_words(m) != peq_f.shape[-1]:
        raise ValueError(f"unit length {m} outside 1..{MAX_M} or "
                         f"inconsistent with peq width {peq_f.shape[-1]}")
    _register()
    B, L = text.shape
    pad = (-L) % TEXT_ALIGN
    text = text.astype(jnp.int8)
    if pad:
        text = jnp.pad(text, ((0, 0), (0, pad)), constant_values=4)
    peq = jnp.stack([peq_f, peq_r]).astype(jnp.uint32)
    out = jax.ShapeDtypeStruct((2, B), jnp.int32)
    dist, end = jax.ffi.ffi_call(TARGET, (out, out))(
        peq, text, lens.reshape(B).astype(jnp.int32), m=np.int32(m))
    return {"dist_f": dist[0], "end_f": end[0],
            "dist_r": dist[1], "end_r": end[1]}


def myers_hw_2strand_xla(peq_f, peq_r, text, lens, *, m: int):
    """The plain XLA formulation of myers_hw_2strand (same contract)."""
    f = myers_distance_batch(peq_f, text, lens, m=m, mode="HW")
    r = myers_distance_batch(peq_r, text, lens, m=m, mode="HW")
    return {"dist_f": f["dist"], "end_f": f["end"],
            "dist_r": r["dist"], "end_r": r["end"]}


def two_strand_scorer(platform: str, m: int):
    """The recruitment scorer for a device platform and unit length: the
    CUDA kernel on "gpu" (measured faster end to end on an H100, PERF.md)
    for m <= MAX_M, the XLA scan everywhere else."""
    if platform == "gpu" and m <= MAX_M:
        return myers_hw_2strand
    return myers_hw_2strand_xla


if __name__ == "__main__":
    print(build_kernels())
