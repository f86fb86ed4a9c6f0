"""Device POA kernel vs the scalar host oracle (ops/poa.py)."""

import numpy as np
import pytest

from vgaligner_tpu.ops.poa import align_global_host
from vgaligner_tpu.ops.poa_device import align_global_batch

DIAMOND_NODES = ["A", "CT", "GA", "GCA"]
DIAMOND_EDGES = [(0, 1), (0, 2), (1, 3), (2, 3)]


def _assert_same(res_d, res_h):
    assert res_d.best_score == res_h.best_score
    assert res_d.cigar == res_h.cigar
    assert res_d.cs == res_h.cs
    assert res_d.node_path == res_h.node_path
    assert res_d.path_vertices == res_h.path_vertices
    assert res_d.aln_start_offset == res_h.aln_start_offset
    assert res_d.aln_end_offset == res_h.aln_end_offset
    assert res_d.n_aligned == res_h.n_aligned


def test_device_matches_host_basics():
    problems = [
        (DIAMOND_NODES, DIAMOND_EDGES, "ACTGCA"),   # exact path
        (DIAMOND_NODES, DIAMOND_EDGES, "AGAGCA"),   # other branch
        (DIAMOND_NODES, DIAMOND_EDGES, "ACTGCC"),   # mismatch
        (DIAMOND_NODES, DIAMOND_EDGES, "ACTTGCA"),  # insertion
        (["ACT", "GGGG", "CA"], [(0, 1), (1, 2)], "ACTCA"),  # deletion
        (["ACT"], [], "ACT"),                        # single node
    ]
    device = align_global_batch(problems)
    for prob, res_d in zip(problems, device):
        res_h = align_global_host(*prob)
        _assert_same(res_d, res_h)


def _random_dag(rng, n_nodes):
    nodes = []
    for _ in range(n_nodes):
        ln = int(rng.integers(1, 6))
        nodes.append("".join("ACGT"[c] for c in rng.integers(0, 4, ln)))
    edges = []
    for b in range(1, n_nodes):
        for a in rng.choice(b, size=min(b, int(rng.integers(1, 3))), replace=False):
            edges.append((int(a), b))
    return nodes, edges


def _random_query_from_path(rng, nodes, edges, mutate=0.1):
    # walk a random source->sink path, then mutate
    succ = {}
    for a, b in edges:
        succ.setdefault(a, []).append(b)
    cur = 0
    seq = nodes[0]
    while cur in succ:
        cur = int(rng.choice(succ[cur]))
        seq += nodes[cur]
    s = list(seq)
    for i in range(len(s)):
        r = rng.random()
        if r < mutate / 3:
            s[i] = "ACGT"[int(rng.integers(0, 4))]
        elif r < 2 * mutate / 3:
            s[i] = s[i] + "ACGT"[int(rng.integers(0, 4))]
        elif r < mutate:
            s[i] = ""
    return "".join(s) or "A"


@pytest.mark.parametrize("seed", range(6))
def test_device_matches_host_random(seed):
    rng = np.random.default_rng(seed)
    problems = []
    for _ in range(4):
        nodes, edges = _random_dag(rng, int(rng.integers(2, 10)))
        q = _random_query_from_path(rng, nodes, edges)
        problems.append((nodes, edges, q))
    device = align_global_batch(problems)
    for prob, res_d in zip(problems, device):
        res_h = align_global_host(*prob)
        _assert_same(res_d, res_h)


@pytest.mark.parametrize("seed", [123, 321])
def test_device_matches_host_long_gaps(seed):
    """Long (25-60 base) indels cross the two-piece gap crossover
    (gap length 20 at abPOA defaults), exercising the closed-form
    in-row recurrence where class dominance is tightest."""
    rng = np.random.default_rng(seed)
    problems = []
    for _ in range(4):
        n_nodes = int(rng.integers(5, 25))
        nodes = [
            "".join("ACGT"[c] for c in rng.integers(0, 4, int(rng.integers(3, 20))))
            for _ in range(n_nodes)
        ]
        edges = []
        for b in range(1, n_nodes):
            for a in rng.choice(b, size=min(b, int(rng.integers(1, 3))), replace=False):
                edges.append((int(a), b))
        succ = {}
        for a, b in edges:
            succ.setdefault(a, []).append(b)
        cur, seq = 0, nodes[0]
        while cur in succ:
            cur = int(rng.choice(succ[cur]))
            seq += nodes[cur]
        q = list(seq)
        pos = int(rng.integers(0, len(q)))
        q.insert(pos, "".join("ACGT"[c] for c in rng.integers(0, 4, int(rng.integers(25, 60)))))
        dpos = int(rng.integers(0, max(len(q) - 40, 1)))
        del q[dpos : dpos + int(rng.integers(25, 40))]
        problems.append((nodes, edges, "".join(q) or "A"))
    device = align_global_batch(problems)
    for prob, res_d in zip(problems, device):
        _assert_same(res_d, align_global_host(*prob))


def test_local_batch_matches_host():
    """Device local no-gap kernel (rspoa engine) vs the scalar oracle."""
    from vgaligner_tpu.ops.poa import align_local_no_gap_host
    from vgaligner_tpu.ops.poa_device import align_local_batch

    rng = np.random.default_rng(11)
    problems = [
        (DIAMOND_NODES, DIAMOND_EDGES, "ACTGCA"),
        (DIAMOND_NODES, DIAMOND_EDGES, "TTACTGCATT"),  # local: soft ends
        (["ACT", "GGGG", "CA"], [(0, 1), (1, 2)], "CCGGGGCC"),
        (["ACGTACGT"], [], "ACGT"),
    ]
    for _ in range(6):
        nodes, edges = _random_dag(rng, int(rng.integers(2, 10)))
        q = _random_query_from_path(rng, nodes, edges, mutate=0.2)
        problems.append((nodes, edges, q))
    for prob, res_d in zip(problems, align_local_batch(problems)):
        res_h = align_local_no_gap_host(*prob)
        assert res_d.best_score == res_h.best_score, prob
        assert res_d.cigar == res_h.cigar
        assert res_d.cs == res_h.cs
        assert res_d.node_path == res_h.node_path
        assert res_d.query_start == res_h.query_start
        assert res_d.query_end == res_h.query_end


def test_wire_kernel_matches_unpacked():
    """The single-buffer wire dispatch (pack_chunk_wire +
    poa_global_kernel_wire) must produce bit-identical outputs to the
    per-array packed kernel — locks the byte layout and the backend
    bitcast semantics the wire relies on."""
    import jax.numpy as jnp

    from vgaligner_tpu.ops.poa_device import (
        pack_chunk_wire,
        poa_global_kernel_packed,
        poa_global_kernel_wire,
        wire_bitcast_supported,
    )

    if not wire_bitcast_supported():
        pytest.skip("wire bitcast unsupported on this backend; fallback path covers it")
    rng = np.random.default_rng(7)
    B, V, P, L = 4, 16, 2, 8
    vcodes = rng.integers(0, 4, size=(B, V)).astype(np.int8)
    vpred = np.full((B, V, P), -1, dtype=np.int16)
    vpred[:, 1:, 0] = np.arange(V - 1, dtype=np.int16)
    is_sink = np.zeros((B, V), dtype=np.int8)
    nv = rng.integers(4, V + 1, size=B).astype(np.int32)
    for b in range(B):
        is_sink[b, nv[b] - 1] = 1
    vcodes_p = (vcodes | (is_sink << 5)).astype(np.int8)
    q = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    nq = rng.integers(1, L + 1, size=B).astype(np.int32)

    ref = poa_global_kernel_packed(
        jnp.asarray(vcodes_p), jnp.asarray(vpred), jnp.asarray(nv),
        jnp.asarray(q), jnp.asarray(nq),
    )
    wire = pack_chunk_wire(vcodes_p, vpred, nv, q, nq)
    got = poa_global_kernel_wire(jnp.asarray(wire), B, V, P, L)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r), np.asarray(g))


def test_fetch_grouped_mixed_dtypes_and_shapes():
    """fetch_grouped must return every input array bit-identical, in
    input order, across interleaved dtypes and shapes (it reorders
    internally into one flat buffer per dtype)."""
    import jax.numpy as jnp

    from vgaligner_tpu.ops.poa_device import fetch_grouped

    rng = np.random.default_rng(3)
    srcs = [
        rng.integers(0, 1000, size=(4, 7)).astype(np.int32),
        rng.random((3,)).astype(np.float32),
        rng.integers(0, 60000, size=(2, 5)).astype(np.uint16),
        rng.integers(0, 1000, size=(6,)).astype(np.int32),
        rng.random((2, 2, 2)).astype(np.float32),
        rng.integers(0, 60000, size=(1,)).astype(np.uint16),
    ]
    got = fetch_grouped([jnp.asarray(a) for a in srcs])
    assert len(got) == len(srcs)
    for src, out in zip(srcs, got):
        assert out.shape == src.shape and out.dtype == src.dtype
        np.testing.assert_array_equal(out, src)

    # single array short-circuits to a plain fetch
    one = fetch_grouped([jnp.asarray(srcs[0])])
    np.testing.assert_array_equal(one[0], srcs[0])
    # empty input
    assert fetch_grouped([]) == []


def test_wire2_kernel_matches_packed():
    """Delta-compressed wire dispatch (encode_pred_deltas +
    poa_global_kernel_wire2) must produce bit-identical real-row outputs
    to the per-array packed kernel, including multi-pred vertices, far
    deltas (> 255, forced to the exception path), and V-padding."""
    import jax.numpy as jnp

    from vgaligner_tpu.ops.poa_device import (
        encode_pred_deltas,
        pack_chunk_wire2,
        poa_global_kernel_packed,
        poa_global_kernel_wire2,
        wire_bitcast_supported,
    )

    if not wire_bitcast_supported():
        pytest.skip("wire bitcast unsupported on this backend; fallback path covers it")
    rng = np.random.default_rng(11)
    B, V, P, L = 5, 300, 3, 8
    nv = np.array([300, 290, 12, 300, 4], dtype=np.int32)
    vpred = np.full((B, V, P), -1, dtype=np.int32)
    is_sink = np.zeros((B, V), dtype=np.int8)
    for b in range(B):
        vpred[b, 1 : nv[b], 0] = np.arange(nv[b] - 1)  # chain (delta 1)
        is_sink[b, nv[b] - 1] = 1
    # multi-pred vertices (slot 1 live)
    vpred[0, 100, 1] = 50
    vpred[1, 200, 1] = 3
    vpred[1, 200, 2] = 199 - 1  # slot 2 too
    # far delta > 255: slot 0 must go through the exception list
    vpred[3, 299, 0] = 2
    # calloc-zero quirk in the padded region (upstream ships zeros there)
    vpred[2, 12:, :] = 0
    vcodes = rng.integers(0, 4, size=(B, V)).astype(np.int8)
    vcodes_p = (vcodes | (is_sink << 5)).astype(np.int8)
    q = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    nq = np.array([8, 7, 5, 8, 3], dtype=np.int32)

    ref = poa_global_kernel_packed(
        jnp.asarray(vcodes_p), jnp.asarray(vpred.astype(np.int16)),
        jnp.asarray(nv), jnp.asarray(q), jnp.asarray(nq),
    )
    dplane, exc_idx, exc_pred = encode_pred_deltas(vpred, nv)
    # exceptions: 4 live exception slots, padded to the pow2 ladder
    assert (dplane[3, 299] == 0) and (dplane[0, 100] == 1)
    wire = pack_chunk_wire2(vcodes_p, dplane, nv, q, nq, exc_idx, exc_pred)
    got = poa_global_kernel_wire2(
        jnp.asarray(wire), B, V, P, L, len(exc_idx)
    )
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r), np.asarray(g))


def test_ladder_bytes_pow2_eighth():
    from vgaligner_tpu.ops.poa_device import _ladder_bytes

    assert _ladder_bytes(1) == 4096
    assert _ladder_bytes(4096) == 4096
    assert _ladder_bytes(4097) == 8192  # step floor is 4096
    assert _ladder_bytes((1 << 20) + 1) == (1 << 20) + (1 << 17)  # pow2/8 step
    for n in (5000, 70000, 1 << 20, (1 << 20) + 1, 30 << 20):
        m = _ladder_bytes(n)
        assert m >= n
        assert (m - n) <= max(4096, (1 << (n.bit_length() - 1)) // 8)
    # ladder values repeat: a small set of sizes per octave
    vals = {_ladder_bytes(n) for n in range(1 << 16, 1 << 17, 97)}
    assert len(vals) <= 9


def test_kernel_launch_wires_groups_by_cap(monkeypatch):
    """kernel_launch_wires must honor the mega-size cap, preserve input
    order, and produce identical pendings to one-launch-per-chunk."""
    import jax.numpy as jnp

    import vgaligner_tpu.ops.poa_device as pd

    if not pd.wire_bitcast_supported():
        pytest.skip("wire bitcast unsupported on this backend")
    rng = np.random.default_rng(5)

    def mk_prepared(B, V, P, L, seed):
        r = np.random.default_rng(seed)
        vcodes = r.integers(0, 4, size=(B, V)).astype(np.int8)
        vpred = np.full((B, V, P), -1, dtype=np.int32)
        vpred[:, 1:, 0] = np.arange(V - 1)
        is_sink = np.zeros((B, V), dtype=np.int8)
        nv = np.full(B, V, np.int32)
        is_sink[:, V - 1] = 1
        vcodes_p = (vcodes | (is_sink << 5)).astype(np.int8)
        q = r.integers(0, 4, size=(B, L)).astype(np.int8)
        nq = np.full(B, L, np.int32)
        dplane, exc_idx, exc_pred = pd.encode_pred_deltas(vpred, nv)
        wire = pd.pack_chunk_wire2(vcodes_p, dplane, nv, q, nq, exc_idx, exc_pred)
        dims = (B, V, P, L, len(exc_idx))
        rest = (vcodes, None, None, q, V, B, B, [None] * B)
        return wire, "v2", dims, rest

    prepared = [mk_prepared(2, 16, 2, 8, s) for s in range(5)]
    # force multiple flush groups (fused path ladder-pads each chunk)
    monkeypatch.setattr(
        pd, "_WIRE_MEGA_CAP", 2 * pd._ladder_bytes(len(prepared[0][0])) + 1
    )
    got = pd.kernel_launch_wires(prepared)
    assert len(got) == 5
    for (wire, _version, dims, rest), pending in zip(prepared, got):
        ref = pd.poa_global_kernel_wire2(jnp.asarray(wire), *dims)
        for r, g in zip(ref, pd.pending_outputs(pending)):
            g = np.asarray(g)
            r = np.asarray(r)
            if r.ndim == 2 and r.shape[1] > g.shape[1]:
                r = r[:, : g.shape[1]]  # fused path slices the tape guess
            np.testing.assert_array_equal(r, g)
        assert pending[1] is rest[0]


def test_wire3_kernel_matches_packed():
    """Row-packed delta wire (pack_rows + poa_global_kernel_wire3) must
    match the per-array packed kernel bit for bit, including V-padding,
    batch-pad rows, ladder tail, and exception slots."""
    import jax.numpy as jnp

    from vgaligner_tpu.ops.poa_device import (
        _ladder_bytes,
        encode_pred_deltas,
        pack_chunk_wire3,
        pack_rows,
        poa_global_kernel_packed,
        poa_global_kernel_wire3,
        wire_bitcast_supported,
    )

    if not wire_bitcast_supported():
        pytest.skip("wire bitcast unsupported on this backend; fallback path covers it")
    rng = np.random.default_rng(17)
    B, V, P, L = 6, 64, 2, 16
    nv = np.array([64, 50, 3, 64, 1, 0], dtype=np.int32)  # incl. pad row
    vpred = np.full((B, V, P), -1, dtype=np.int32)
    is_sink = np.zeros((B, V), dtype=np.int8)
    for b in range(B):
        if nv[b]:
            vpred[b, 1 : nv[b], 0] = np.arange(nv[b] - 1)
            is_sink[b, nv[b] - 1] = 1
        vpred[b, nv[b] :, :] = 0  # upstream calloc quirk
    vpred[0, 30, 1] = 7  # multi-pred exception
    vcodes = rng.integers(0, 4, size=(B, V)).astype(np.int8)
    vcodes_p = (vcodes | (is_sink << 5)).astype(np.int8)
    q = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    nq = np.array([16, 10, 3, 16, 1, 0], dtype=np.int32)

    ref = poa_global_kernel_packed(
        jnp.asarray(vcodes_p), jnp.asarray(vpred.astype(np.int16)),
        jnp.asarray(nv), jnp.asarray(q), jnp.asarray(nq),
    )
    dplane, exc_idx, exc_pred = encode_pred_deltas(vpred, nv)
    vf, df = pack_rows(vcodes_p, nv), pack_rows(dplane, nv)
    assert len(vf) == int(nv.sum())
    t_pad = _ladder_bytes(len(vf))
    vf = np.concatenate([vf, np.zeros(t_pad - len(vf), np.int8)])
    df = np.concatenate([df, np.zeros(t_pad - len(df), np.uint8)])
    wire = pack_chunk_wire3(vf, df, nv, q, nq, exc_idx, exc_pred)
    got = poa_global_kernel_wire3(
        jnp.asarray(wire), B, V, P, L, len(exc_idx), t_pad
    )
    # pad rows (nv==0) produce garbage either way; compare real rows
    real = nv > 0
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r)[real], np.asarray(g)[real])


@pytest.mark.parametrize("wire_env", [None, "v1", "v2", "v3"])
def test_dispatch_wire_versions_agree(monkeypatch, wire_env):
    """kernel_dispatch must produce identical results through the
    row-packed wire (default), dense-plane wire2, and dense-int16 wire1
    escape hatches."""
    import jax.numpy as jnp

    from vgaligner_tpu.ops.poa import align_global_host
    from vgaligner_tpu.ops.poa_device import align_global_batch, wire_bitcast_supported

    if not wire_bitcast_supported():
        pytest.skip("wire bitcast unsupported on this backend")
    if wire_env is None:
        monkeypatch.delenv("VGALIGNER_POA_WIRE", raising=False)
    else:
        monkeypatch.setenv("VGALIGNER_POA_WIRE", wire_env)
    problems = [
        (["A", "CT", "GA", "GCA"], [(0, 1), (0, 2), (1, 3), (2, 3)], "ACTGCA"),
        (["ACGTAC"], [], "ACGGAC"),
    ]
    for prob, res in zip(problems, align_global_batch(problems)):
        ref = align_global_host(*prob)
        assert res.best_score == ref.best_score
        assert res.cigar == ref.cigar
        assert res.node_path == ref.node_path


def test_wire4_kernel_matches_packed_with_escaped_deltas():
    """Nibble-plane wire (v4): slot-0 deltas above 14 must ride the
    exception list; outputs bit-identical to the packed kernel."""
    import jax.numpy as jnp

    from vgaligner_tpu.ops.poa_device import (
        _ladder_bytes,
        encode_pred_deltas,
        exception_pred_deltas,
        nibble_fold,
        pack_chunk_wire4,
        pack_rows,
        poa_global_kernel_packed,
        poa_global_kernel_wire4,
        wire_bitcast_supported,
    )

    if not wire_bitcast_supported():
        pytest.skip("wire bitcast unsupported on this backend")
    rng = np.random.default_rng(23)
    B, V, P, L = 4, 80, 2, 12
    nv = np.array([80, 61, 5, 80], dtype=np.int32)
    vpred = np.full((B, V, P), -1, dtype=np.int32)
    is_sink = np.zeros((B, V), dtype=np.int8)
    for b in range(B):
        vpred[b, 1 : nv[b], 0] = np.arange(nv[b] - 1)
        is_sink[b, nv[b] - 1] = 1
        vpred[b, nv[b] :, :] = 0
    vpred[0, 60, 0] = 2   # delta 58 > 14 -> escaped to exceptions
    vpred[3, 79, 0] = 1   # delta 78 > 14
    vpred[1, 40, 1] = 10  # fan-in 2
    vcodes = rng.integers(0, 4, size=(B, V)).astype(np.int8)
    vcodes_p = (vcodes | (is_sink << 5)).astype(np.int8)
    q = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    nq = np.array([12, 9, 4, 12], dtype=np.int32)

    ref = poa_global_kernel_packed(
        jnp.asarray(vcodes_p), jnp.asarray(vpred.astype(np.int16)),
        jnp.asarray(nv), jnp.asarray(q), jnp.asarray(nq),
    )
    dplane, exc_idx, exc_pred = encode_pred_deltas(vpred, nv, max_delta=14)
    assert (dplane <= 14).all()
    assert dplane[0, 60] == 0 and dplane[3, 79] == 0
    vf, df = pack_rows(vcodes_p, nv), pack_rows(dplane, nv)
    t_pad = _ladder_bytes(len(vf))
    vf = np.concatenate([vf, np.zeros(t_pad - len(vf), np.int8)])
    df = np.concatenate([df, np.zeros(t_pad - len(df), np.uint8)])
    vnib = nibble_fold((vf & 7) | (((vf >> 5) & 1) << 3))
    dnib = nibble_fold(df)
    exc_pd16, ok = exception_pred_deltas(exc_idx, exc_pred, B, V, P)
    assert ok
    wire = pack_chunk_wire4(
        vnib, dnib, nv, nibble_fold(q), nq, exc_idx, exc_pd16
    )
    got = poa_global_kernel_wire4(
        jnp.asarray(wire), B, V, P, L, len(exc_idx), t_pad
    )
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r), np.asarray(g))


def test_exception_pred_delta_overflow_falls_back_to_wire3(monkeypatch):
    """A forward-pointing predecessor (delta < 1) cannot ride the uint16
    delta wire; kernel_prepare must route that chunk to wire3 and still
    produce packed-kernel-identical outputs."""
    import jax.numpy as jnp

    from vgaligner_tpu.ops import poa_device as pd

    if not pd.wire_bitcast_supported():
        pytest.skip("wire bitcast unsupported on this backend")
    rng = np.random.default_rng(7)
    B, V, P, L = 2, 16, 2, 8
    nv = np.array([16, 11], dtype=np.int32)
    vpred = np.full((B, V, P), -1, dtype=np.int32)
    is_sink = np.zeros((B, V), dtype=np.int8)
    for b in range(B):
        vpred[b, 1 : nv[b], 0] = np.arange(nv[b] - 1)
        is_sink[b, nv[b] - 1] = 1
        vpred[b, nv[b] :, :] = 0
    vpred[0, 3, 1] = 5  # fan-in slot with pred AFTER its vertex
    vcodes = rng.integers(0, 4, size=(B, V)).astype(np.int8)
    qs = [rng.integers(0, 4, size=n).astype(np.int8) for n in (8, 5)]

    deltas, ok = pd.exception_pred_deltas(
        *pd.encode_pred_deltas(vpred, nv)[1:], B, V, P
    )
    assert not ok

    built = (vcodes, vpred.astype(np.int16), is_sink, nv,
             [None] * B, [None] * B)
    monkeypatch.delenv("VGALIGNER_POA_WIRE", raising=False)
    wire, version, dims, rest = pd.kernel_prepare(built, qs, V, L)
    assert version == "v3"
    ref = pd.poa_global_kernel_packed(
        jnp.asarray((vcodes | (is_sink << 5)).astype(np.int8)),
        jnp.asarray(vpred.astype(np.int16)), jnp.asarray(nv),
        *map(jnp.asarray, pd._pad_queries(qs, B, L)),
    )
    got = pd.poa_global_kernel_wire3(jnp.asarray(wire), *dims)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r), np.asarray(g))


def test_single_trip_fetch_overflow_refetch(monkeypatch):
    """kernel_finish_all fetches tapes sliced to a static guess in ONE
    transfer; a traceback longer than the guess (deletion-heavy global
    path) must transparently refetch and still decode correctly.  A
    200-base linear graph vs a 24-base query forces ~180 deletions; with
    slack pushed negative the guess floors at 64 columns < tlen."""
    from vgaligner_tpu.ops.poa import align_global_host
    from vgaligner_tpu.ops.poa_device import align_global_batch

    rng = np.random.default_rng(7)
    alpha = "ACGT"
    seq = "".join(alpha[i] for i in rng.integers(0, 4, size=200))
    nodes = [seq[i : i + 50] for i in range(0, 200, 50)]
    edges = [(i, i + 1) for i in range(3)]
    query = seq[30:54]

    monkeypatch.setenv("VGALIGNER_POA_TAPE_SLACK", "-100000")
    got = align_global_batch([(nodes, edges, query)])[0]
    monkeypatch.delenv("VGALIGNER_POA_TAPE_SLACK")
    ref = align_global_host(nodes, edges, query)
    assert got.best_score == ref.best_score
    assert got.cigar == ref.cigar
    assert got.node_path == ref.node_path


def test_mesh_wire_dispatch_matches_host():
    """The wire-packed POA path stays enabled under a mesh: chunks split
    into per-device wire buffers, each launched on its own device, results
    identical to the scalar oracle.  (Round 1 bypassed the wire path when
    a mesh was set, so the sharded run exercised non-wire code only.)"""
    import jax

    from vgaligner_tpu.native import available, build_poa_batch_native
    from vgaligner_tpu.ops.poa_device import (
        P_MAX, kernel_dispatch_chunked, kernel_finish_all, padded_rows,
        wire2_path_available,
    )
    from vgaligner_tpu.parallel.mesh import make_mesh
    from vgaligner_tpu.utils.dna import encode_seq

    if not available():
        pytest.skip("native lib unavailable")
    assert wire2_path_available()  # CPU backend supports the wire path

    mesh = make_mesh(4)
    rng = np.random.default_rng(11)
    problems = []
    for _ in range(13):  # odd count: exercises padding rows
        q = "".join(rng.choice(list("ACGT"), size=int(rng.integers(5, 30))))
        problems.append((DIAMOND_NODES, DIAMOND_EDGES, q))
    qs = [encode_seq(q) for _, _, q in problems]
    v_pad, l_pad = 256, 128
    built = build_poa_batch_native(
        [(n, e) for n, e, _ in problems], v_pad, P_MAX,
        rows=padded_rows(len(problems), v_pad, l_pad),
    )
    assert built is not None
    pendings = kernel_dispatch_chunked(built, qs, v_pad, l_pad, mesh=mesh)
    # the chunk really was split across devices
    devs = {next(iter(p[0][0].devices())) for p in pendings}
    assert len(devs) > 1, "wire dispatch did not spread across the mesh"
    results = kernel_finish_all(pendings)
    assert len(results) == len(problems)
    for prob, res_d in zip(problems, results):
        _assert_same(res_d, align_global_host(*prob))


def test_native_v4_wire_matches_numpy_pipeline(monkeypatch):
    """The single-pass native wire packer must produce byte-identical
    v4 wires (and dims incl. the pin plan) to the numpy pipeline."""
    from vgaligner_tpu import native as _native
    from vgaligner_tpu.ops.poa_device import kernel_prepare

    if not _native.available():
        pytest.skip("native runtime unavailable")

    rng = np.random.default_rng(31)
    B, V, P, l_pad = 8, 128, 2, 127
    nv = rng.integers(5, V, B).astype(np.int32)
    nv[3] = 0  # pad-style row
    vcodes = rng.integers(0, 4, (B, V)).astype(np.int8)
    vpred = np.full((B, V, P), -1, np.int32)
    for b in range(B):
        for v in range(1, int(nv[b])):
            vpred[b, v, 0] = v - 1
        # sprinkle fan-in + far preds (exceptions, some needing pins)
        for v in range(20, int(nv[b]), 17):
            vpred[b, v, 1] = max(0, v - int(rng.integers(2, 60)))
    is_sink = np.zeros((B, V), np.int8)
    for b in range(B):
        if nv[b]:
            is_sink[b, nv[b] - 1] = 1
    node_of = np.zeros((B, V), np.int32)
    off_in = np.zeros((B, V), np.int32)
    built = (vcodes, vpred, is_sink, nv, node_of, off_in)
    qs = [rng.integers(0, 4, 60).astype(np.int8) for _ in range(B)]

    wire_n, ver_n, dims_n, _ = kernel_prepare(built, qs, V, l_pad)
    monkeypatch.setenv("VGALIGNER_NO_NATIVE", "1")
    wire_p, ver_p, dims_p, _ = kernel_prepare(built, qs, V, l_pad)
    assert ver_n == ver_p == "v4"
    assert dims_n == dims_p
    np.testing.assert_array_equal(
        np.frombuffer(wire_n, np.uint8), np.frombuffer(wire_p, np.uint8)
    )
