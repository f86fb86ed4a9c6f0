"""The CUDA POA kernel off the card: its block geometry, the DP
selector, and the kernel source itself run on the CPU under a thread
emulation of the CUDA runtime (tests/cuda_emu), compared with
poa_dp_xla bit for bit."""

import ctypes
import os
import re
import subprocess

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from vgaligner_tpu.ops import poa_cuda, poa_device
from vgaligner_tpu.ops.poa import (
    GAP_EXT1, GAP_EXT2, GAP_OPEN1, GAP_OPEN2, MATCH, MISMATCH,
    build_base_graph,
)
from vgaligner_tpu.ops.poa_device import (
    _slice_preds, make_init_row, poa_dp_xla, prepare_problem,
)
from vgaligner_tpu.utils.dna import encode_seq

from test_poa_device import _random_dag, _random_query_from_path

EMU_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_emu")


@pytest.mark.parametrize("W,threads,cols", [
    (128, 128, 1), (256, 256, 1), (512, 256, 2), (1024, 256, 4),
    (2048, 256, 8), (4096, 256, 16), (96, 96, 1),
])
def test_block_geometry(W, threads, cols):
    assert poa_cuda.block_geometry(W) == (threads, cols)


@pytest.mark.parametrize("W", [100, 8192, 1000])
def test_block_geometry_rejects(W):
    with pytest.raises(ValueError):
        poa_cuda.block_geometry(W)


def _problems(seed, B, n_nodes, l_pad, mutate=0.2):
    rng = np.random.default_rng(seed)
    probs = []
    for _ in range(B):
        nodes, edges = _random_dag(rng, n_nodes)
        q = _random_query_from_path(rng, nodes, edges, mutate)[:l_pad]
        probs.append((build_base_graph(nodes, edges), encode_seq(q)))
    v_pad = 1 << max(int(max(len(bg.codes) for bg, _ in probs) - 1)
                     .bit_length(), 5)
    pp = [prepare_problem(bg, q, v_pad, l_pad) for bg, q in probs]
    return (
        np.stack([p.vcodes for p in pp]),
        np.ascontiguousarray(_slice_preds(np.stack([p.vpred for p in pp]))),
        np.stack([p.is_sink for p in pp]),
        np.array([p.nv for p in pp], np.int32),
        np.stack([p.q for p in pp]),
        np.array([p.nq for p in pp], np.int32),
        make_init_row(l_pad),
    )


@pytest.mark.parametrize("backend,uses_kernel", [("gpu", True), ("cpu", False)])
def test_selector_routes_by_backend(monkeypatch, backend, uses_kernel):
    """_poa_dp sends the DP to the CUDA kernel exactly on GPU backends."""
    calls = []

    def spy(*args):
        calls.append(args[1].shape)
        return poa_dp_xla(*args)

    monkeypatch.setattr(poa_cuda, "poa_dp_cuda", spy)
    monkeypatch.setattr(poa_device.jax, "default_backend", lambda: backend)
    args = _problems(0, 3, 10, 127)
    with jax.enable_x64(False):
        got = poa_device._poa_dp(*map(jnp.asarray, args))
    assert calls == ([args[1].shape] if uses_kernel else [])
    want = poa_dp_xla(*args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.fixture(scope="module")
def emulated_kernel(tmp_path_factory):
    """poa_dp.cu compiled for the CPU against the emulation headers,
    with a C entry point that launches it like the FFI handler does."""
    with open(poa_cuda._SRC) as fh:
        src = fh.read()
    src, n = re.subn(r"(\w+<\w+>)<<<(\w+), (\w+), 0, stream>>>\(",
                     r"emu_launch(\1, \2, \3, ", src)
    assert n == 1
    src += """
extern "C" void emu_poa_dp(int B, int V, int P, int L, const int8_t* vc,
    const int32_t* vp, const int8_t* sink, const int32_t* nv,
    const int8_t* q, const int32_t* nq, const float* init, float* score,
    int32_t* best, int32_t* tbits, float* S, const float* costs) {
  Costs k{costs[0], costs[1], costs[2], costs[3], costs[4], costs[5]};
  int C = 1;
  while ((L + 1) / C > kMaxThreads) C <<= 1;
  const int threads = (L + 1) / C;
  switch (C) {
    case 1: Launch<1>(nullptr, B, threads, vc, vp, sink, nv, q, nq, init,
                      score, best, tbits, S, V, P, L, k); break;
    case 2: Launch<2>(nullptr, B, threads, vc, vp, sink, nv, q, nq, init,
                      score, best, tbits, S, V, P, L, k); break;
    default: Launch<4>(nullptr, B, threads, vc, vp, sink, nv, q, nq, init,
                       score, best, tbits, S, V, P, L, k); break;
  }
}
"""
    d = tmp_path_factory.mktemp("cuda_emu")
    cpp, lib = d / "poa_dp_emu.cpp", d / "poa_dp_emu.so"
    cpp.write_text(src)
    subprocess.run(
        ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
         "-I", EMU_DIR, "-I", jax.ffi.include_dir(), str(cpp), "-o",
         str(lib)],
        check=True, capture_output=True,
    )
    return ctypes.CDLL(str(lib))


@pytest.mark.parametrize("seed,B,n_nodes,l_pad", [
    (0, 3, 12, 127),  # one column per thread
    (1, 3, 40, 127),
    (2, 2, 60, 255),
    (3, 2, 80, 511),  # two columns per thread: cross-thread prefix max
    (4, 2, 120, 1023),  # four columns per thread, W = 1024
])
def test_kernel_source_matches_xla(emulated_kernel, seed, B, n_nodes, l_pad):
    args = _problems(seed, B, n_nodes, l_pad)
    vcodes, vpred, is_sink, nv, q, nq, init = args
    with jax.enable_x64(False):
        s_x, b_x, t_x = (np.asarray(a) for a in poa_dp_xla(*args))
    Bn, V, P = vpred.shape
    W = l_pad + 1
    score = np.zeros(Bn, np.float32)
    best = np.zeros(Bn, np.int32)
    tbits = np.full((Bn, V, W), 7, np.int32)  # rows >= nv must be zeroed
    S = np.zeros((Bn, V + 1, 3 * W), np.float32)
    costs = np.array([MATCH, MISMATCH, GAP_OPEN1, GAP_EXT1, GAP_OPEN2,
                      GAP_EXT2], np.float32)
    keep = [np.ascontiguousarray(a) for a in (
        vcodes.astype(np.int8), vpred.astype(np.int32),
        is_sink.astype(np.int8), nv, q.astype(np.int8), nq, init)]
    ptr = [a.ctypes.data_as(ctypes.c_void_p)
           for a in keep + [score, best, tbits, S, costs]]
    emulated_kernel.emu_poa_dp(Bn, V, P, l_pad, *ptr)
    np.testing.assert_array_equal(score, s_x)
    np.testing.assert_array_equal(best, b_x)
    live = np.arange(V)[None, :, None] < nv[:, None, None]
    np.testing.assert_array_equal(tbits, np.where(live, t_x, 0))
