"""The global-POA DP as a CUDA kernel (ops/cuda/poa_dp.cu) behind JAX's
foreign function interface.

The library is compiled with nvcc for sm_90a from the committed source
on first use, into ops/cuda/ next to it (a content hash keeps a stale
binary from loading), and registered as an XLA FFI target for the CUDA
platform.  poa_dp_cuda has poa_dp_xla's signature and outputs; tbits
rows at v >= nv are zero where the XLA scan leaves junk (the traceback
never reads them).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import jax
import jax.numpy as jnp
import numpy as np

from .poa import GAP_EXT1, GAP_EXT2, GAP_OPEN1, GAP_OPEN2, MATCH, MISMATCH

_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda")
_SRC = os.path.join(_DIR, "poa_dp.cu")
_LIB = os.path.join(_DIR, "_poa_dp.so")
_TARGET = "vgaligner_poa_dp"
MAX_THREADS = 256  # threads per block; kMaxThreads in poa_dp.cu
MAX_W = 4096  # 16 columns per thread at most

_lock = threading.Lock()
_registered = False


def block_geometry(W: int):
    """(threads, columns per thread) of the kernel's block for a row of
    W = L+1 columns, or ValueError when the kernel cannot take W.
    Mirrors the launch in poa_dp.cu."""
    c = 1
    while W // c > MAX_THREADS:
        c <<= 1
    threads = W // c
    if W % c or threads % 32 or W > MAX_W:
        raise ValueError(
            f"W = {W}: must be a multiple of 32 and at most {MAX_W}")
    return threads, c


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA POA kernel cannot be built")


def build() -> str:
    """Compile the kernel library if it is missing or stale; returns
    its path.  Raises on a failed build (the GPU path has no fallback)."""
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
        "-I", jax.ffi.include_dir(), _SRC,
    ]
    with open(_SRC, "rb") as fh:
        key = hashlib.sha256(fh.read() + " ".join(cmd[1:]).encode()).hexdigest()
    stamp = _LIB + ".srchash"
    if os.path.exists(_LIB) and os.path.exists(stamp):
        with open(stamp) as fh:
            if fh.read().strip() == key:
                return _LIB
    tmp = f"{_LIB}.tmp"
    res = subprocess.run(cmd + ["-o", tmp], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed:\n{res.stderr[-4000:]}")
    os.replace(tmp, _LIB)
    with open(stamp + ".tmp", "w") as fh:
        fh.write(key)
    os.replace(stamp + ".tmp", stamp)
    return _LIB


def _register() -> None:
    global _registered
    with _lock:
        if _registered:
            return
        lib = ctypes.CDLL(build())
        jax.ffi.register_ffi_target(
            _TARGET, jax.ffi.pycapsule(lib.VgPoaDp), platform="CUDA"
        )
        _registered = True


def poa_dp_cuda(vcodes, vpred, is_sink, nv, q, nq, init_row):
    """poa_dp_xla on the GPU kernel: vcodes [B,V] int8, vpred [B,V,P],
    is_sink [B,V], nv [B], q [B,L] int8, nq [B], init_row [L+1] f32.
    Returns (score [B] f32, best_sink [B] i32, tbits [B,V,L+1] i32)."""
    _register()
    B, V, P = vpred.shape
    W = q.shape[1] + 1
    block_geometry(W)
    out = (
        jax.ShapeDtypeStruct((B,), jnp.float32),
        jax.ShapeDtypeStruct((B,), jnp.int32),
        jax.ShapeDtypeStruct((B, V, W), jnp.int32),
        jax.ShapeDtypeStruct((B, V + 1, 3 * W), jnp.float32),  # row scratch
    )
    score, best_sink, tbits, _ = jax.ffi.ffi_call(_TARGET, out)(
        vcodes.astype(jnp.int8), vpred.astype(jnp.int32),
        is_sink.astype(jnp.int8), nv.astype(jnp.int32),
        q.astype(jnp.int8), nq.astype(jnp.int32),
        init_row.astype(jnp.float32),
        match=np.float32(MATCH), mismatch=np.float32(MISMATCH),
        gap_open1=np.float32(GAP_OPEN1), gap_ext1=np.float32(GAP_EXT1),
        gap_open2=np.float32(GAP_OPEN2), gap_ext2=np.float32(GAP_EXT2),
    )
    return score, best_sink, tbits
