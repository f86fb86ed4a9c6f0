"""Card-only checks: the CUDA POA kernel, compiled for the card,
against poa_dp_xla on small random inputs.  They skip without an
NVIDIA GPU; chip_smoke.py runs them on the card (at real widths it also
compares the kernel on the CLI runs' own inputs)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.parametrize("seed,n_nodes,l_pad", [(0, 40, 127), (1, 150, 1023)])
def test_poa_kernel_matches_xla_on_gpu(gpu, seed, n_nodes, l_pad):
    from test_poa_device import _random_dag, _random_query_from_path

    from vgaligner_tpu.ops.poa import build_base_graph
    from vgaligner_tpu.ops.poa_cuda import poa_dp_cuda
    from vgaligner_tpu.ops.poa_device import (
        _slice_preds, make_init_row, poa_dp_xla, prepare_problem,
    )
    from vgaligner_tpu.utils.dna import encode_seq

    rng = np.random.default_rng(seed)
    probs = []
    for _ in range(8):
        nodes, edges = _random_dag(rng, n_nodes)
        q = _random_query_from_path(rng, nodes, edges, 0.2)[:l_pad]
        probs.append((build_base_graph(nodes, edges), encode_seq(q)))
    v_pad = 1 << int(max(len(bg.codes) for bg, _ in probs) - 1).bit_length()
    pp = [prepare_problem(bg, q, v_pad, l_pad) for bg, q in probs]
    args = (
        np.stack([p.vcodes for p in pp]),
        _slice_preds(np.stack([p.vpred for p in pp])),
        np.stack([p.is_sink for p in pp]),
        np.array([p.nv for p in pp], np.int32),
        np.stack([p.q for p in pp]),
        np.array([p.nq for p in pp], np.int32),
        make_init_row(l_pad),
    )
    with jax.enable_x64(False):
        s_k, b_k, t_k = jax.jit(poa_dp_cuda)(*map(jnp.asarray, args))
        s_x, b_x, t_x = poa_dp_xla(*args)
    np.testing.assert_array_equal(np.asarray(s_k), np.asarray(s_x))
    np.testing.assert_array_equal(np.asarray(b_k), np.asarray(b_x))
    live = np.arange(v_pad)[None, :, None] < args[3][:, None, None]
    np.testing.assert_array_equal(np.where(live, np.asarray(t_x), 0),
                                  np.asarray(t_k))
