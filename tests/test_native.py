"""Native (C++) host runtime vs the pure-Python reference paths.

Every native entry point must be byte/value-identical to its Python
fallback; these tests build both and compare exactly.
"""

import os

import numpy as np
import pytest

from conftest import DATA_DIR

from vgaligner_tpu import native
from vgaligner_tpu.graph import graph_from_gfa
from vgaligner_tpu.graph.handlegraph import HashGraph, handle_pack
from vgaligner_tpu.graph.linearize import find_forward_sequence
from vgaligner_tpu.index.kmer_gen import generate_kmers, generate_pos_on_ref
from vgaligner_tpu.utils.dna import kmer_code

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library unavailable"
)

TEST_GFA = os.path.join(DATA_DIR, "test.gfa")


def _python_kmer_index(graph, k, e, d, r):
    lin = find_forward_sequence(graph)
    kmers = generate_kmers(graph, k, edge_max=e, degree_max=d, sampling_rate=r)
    seqs, offsets, counts, positions = generate_pos_on_ref(
        graph, kmers, lin.seq_len, lin.node_starts
    )
    codes = np.asarray([kmer_code(s) for s in seqs], dtype=np.int64)
    return codes, offsets, counts, positions


def _native_kmer_index(graph, k, e, d, r):
    lin = find_forward_sequence(graph)
    return native.kmer_index_native(
        graph, k, e, d, r, lin.node_starts, lin.seq_len
    )[:4]


def _diamond():
    g = HashGraph()
    h1 = g.create_handle("ACT", 1)
    h2 = g.create_handle("CT", 2)
    h3 = g.create_handle("GA", 3)
    h4 = g.create_handle("GCAC", 4)
    g.create_edge(h1, h2)
    g.create_edge(h1, h3)
    g.create_edge(h2, h4)
    g.create_edge(h3, h4)
    return g


@pytest.mark.parametrize("k", [3, 5, 11])
def test_kmer_index_matches_python_diamond(k):
    g = _diamond()
    for e, d, r in [(100, 100, None), (None, None, None), (1, 2, None), (100, 100, 3)]:
        pc, po, pn, pp = _python_kmer_index(g, k, e, d, r)
        nc, no, nn, npos = _native_kmer_index(g, k, e, d, r)
        np.testing.assert_array_equal(pc, nc)
        np.testing.assert_array_equal(po, no)
        np.testing.assert_array_equal(pn, nn)
        np.testing.assert_array_equal(pp, npos)


@pytest.mark.skipif(not os.path.exists(TEST_GFA), reason="fixture missing")
@pytest.mark.parametrize("k", [5, 11])
def test_kmer_index_matches_python_test_gfa(k):
    g = graph_from_gfa(TEST_GFA)
    pc, po, pn, pp = _python_kmer_index(g, k, 100, 100, None)
    nc, no, nn, npos = _native_kmer_index(g, k, 100, 100, None)
    np.testing.assert_array_equal(pc, nc)
    np.testing.assert_array_equal(po, no)
    np.testing.assert_array_equal(pn, nn)
    np.testing.assert_array_equal(pp, npos)


def test_kmer_index_random_graphs():
    rng = np.random.default_rng(7)
    for trial in range(4):
        g = HashGraph()
        n = int(rng.integers(4, 20))
        for i in range(1, n + 1):
            ln = int(rng.integers(1, 8))
            g.create_handle("".join("ACGT"[c] for c in rng.integers(0, 4, ln)), i)
        for b in range(2, n + 1):
            for a in rng.choice(b - 1, size=min(b - 1, 2), replace=False) + 1:
                g.create_edge(handle_pack(int(a), False), handle_pack(b, False))
        pc, po, pn, pp = _python_kmer_index(g, 7, 100, 100, None)
        nc, no, nn, npos = _native_kmer_index(g, 7, 100, 100, None)
        np.testing.assert_array_equal(pc, nc)
        np.testing.assert_array_equal(pp, npos)
        np.testing.assert_array_equal(po, no)
        np.testing.assert_array_equal(pn, nn)


def test_build_poa_batch_matches_python():
    from vgaligner_tpu.ops.poa import build_base_graph
    from vgaligner_tpu.ops.poa_device import P_MAX, prepare_problem

    rng = np.random.default_rng(3)
    problems = []
    for _ in range(6):
        nn = int(rng.integers(2, 10))
        nodes = ["".join("ACGT"[c] for c in rng.integers(0, 4, int(rng.integers(1, 6)))) for _ in range(nn)]
        edges = []
        for b in range(1, nn):
            for a in rng.choice(b, size=min(b, int(rng.integers(1, 3))), replace=False):
                edges.append((int(a), b))
        problems.append((nodes, edges))

    v_pad = 64
    built = native.build_poa_batch_native(problems, v_pad, P_MAX)
    assert built is not None
    vcodes, vpred, is_sink, nv, node_of, off_in = built
    for p, (nodes, edges) in enumerate(problems):
        bg = build_base_graph(nodes, edges)
        prob = prepare_problem(bg, np.zeros(1, np.int8), v_pad, 8)
        np.testing.assert_array_equal(vcodes[p], prob.vcodes)
        np.testing.assert_array_equal(vpred[p], prob.vpred)
        np.testing.assert_array_equal(is_sink[p].astype(bool), prob.is_sink)
        assert int(nv[p]) == prob.nv
        V = len(bg.codes)
        np.testing.assert_array_equal(node_of[p, :V], bg.node_of)
        np.testing.assert_array_equal(off_in[p, :V], bg.offset_in_node)


def test_align_global_batch_native_matches_host():
    """End-to-end device batch through the native prep/decode path."""
    from vgaligner_tpu.ops.poa import align_global_host
    from vgaligner_tpu.ops.poa_device import align_global_batch

    problems = [
        (["A", "CT", "GA", "GCA"], [(0, 1), (0, 2), (1, 3), (2, 3)], "ACTGCA"),
        (["A", "CT", "GA", "GCA"], [(0, 1), (0, 2), (1, 3), (2, 3)], "AGAGCC"),
        (["ACT", "GGGG", "CA"], [(0, 1), (1, 2)], "ACTCA"),
        (["ACTGACTG"], [], "ACTGCTG"),
    ]
    res = align_global_batch(problems)
    for prob, rd in zip(problems, res):
        rh = align_global_host(*prob)
        assert rd.best_score == rh.best_score
        assert rd.cigar == rh.cigar
        assert rd.cs == rh.cs
        assert rd.node_path == rh.node_path
        assert rd.path_vertices == rh.path_vertices
        assert rd.aln_start_offset == rh.aln_start_offset
        assert rd.aln_end_offset == rh.aln_end_offset
        assert rd.n_aligned == rh.n_aligned
        assert rd.path_start_offset == rh.path_start_offset
        assert rd.path_end_offset == rh.path_end_offset
        assert rd.residue_matches == rh.residue_matches


def test_index_build_native_matches_python_fallback(monkeypatch):
    """Index.build arrays must not depend on the native toggle."""
    from vgaligner_tpu.index import Index

    g = _diamond()
    idx_native = Index.build(g, 5, 100, 100)
    monkeypatch.setenv("VGALIGNER_NO_NATIVE", "1")
    idx_py = Index.build(g, 5, 100, 100)
    np.testing.assert_array_equal(idx_native.kmer_codes, idx_py.kmer_codes)
    np.testing.assert_array_equal(idx_native.kmer_offsets, idx_py.kmer_offsets)
    np.testing.assert_array_equal(idx_native.kmer_counts, idx_py.kmer_counts)
    np.testing.assert_array_equal(idx_native.positions, idx_py.positions)
    np.testing.assert_array_equal(idx_native.fo_positions, idx_py.fo_positions)
    np.testing.assert_array_equal(idx_native.fo_offsets, idx_py.fo_offsets)
    np.testing.assert_array_equal(idx_native.fo_counts, idx_py.fo_counts)


def test_also_align_native_matches_python_pipeline():
    """Full --also-align over test.gfa: the native extraction+prep+decode
    path must emit byte-identical GAF to the pure-Python path."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = r"""
import sys
sys.path.insert(0, REPO)
from vgaligner_tpu.graph import graph_from_gfa
from vgaligner_tpu.index import Index
from vgaligner_tpu.io.fastx import QuerySequence
from vgaligner_tpu.models.mapper import Mapper
from vgaligner_tpu.models.poa_aligner import PoaAligner, PoaEngine

g = graph_from_gfa(GFA)
index = Index.build(g, 11, 100, 100)
reads = []
for pid in g.paths_iter():
    seq = ''.join(g.sequence(h) for h in g.get_path(pid).nodes)
    for s in range(0, max(len(seq) - 30, 1), 7):
        reads.append(seq[s:s + 30])
queries = [QuerySequence.from_name_and_string(f'r{i}', s) for i, s in enumerate(reads)]
mapper = Mapper(index, chain_min_n_anchors=2)
chains = mapper.map_reads(queries)
aligner = PoaAligner(index, PoaEngine.ABPOA)
for a in aligner.best_alignments_for_queries(chains):
    print(a.to_string())
""".replace("REPO", repr(repo)).replace("GFA", repr(TEST_GFA))
    env_native = dict(os.environ)
    env_native.pop("VGALIGNER_NO_NATIVE", None)
    env_py = dict(os.environ, VGALIGNER_NO_NATIVE="1")
    for e in (env_native, env_py):
        e["JAX_PLATFORMS"] = "cpu"
    r1 = subprocess.run([sys.executable, "-c", code], capture_output=True, env=env_native)
    r2 = subprocess.run([sys.executable, "-c", code], capture_output=True, env=env_py)
    assert r1.returncode == 0, r1.stderr.decode()[-2000:]
    assert r2.returncode == 0, r2.stderr.decode()[-2000:]
    assert r1.stdout == r2.stdout
    assert len(r1.stdout.splitlines()) > 10


def test_count_anchors_matches_python(monkeypatch):
    from vgaligner_tpu.graph import graph_from_gfa
    from vgaligner_tpu.index import Index
    from vgaligner_tpu.models.mapper import Mapper

    g = graph_from_gfa(TEST_GFA)
    index = Index.build(g, 11, 100, 100)
    lin = index.seq_fwd
    seqs = [lin[i : i + 40] for i in range(0, 40, 3)] + ["NNNNNNNNNNNN", "ACGT"]
    m = Mapper(index)
    native_totals = m._anchor_totals(seqs)
    monkeypatch.setenv("VGALIGNER_NO_NATIVE", "1")
    py_totals = m._anchor_totals(seqs)
    np.testing.assert_array_equal(native_totals, py_totals)


def test_anchor_coords_matches_python_and_device_sort():
    """Native sorted-position->coords vs the numpy fallback vs the
    ground truth: host anchor enumeration (chain.rs:134-173 order)
    stable-sorted by target_end exactly as the chaining DP sorts
    (ops/chain.py, chain.rs:386-389) — including a read truncated by
    the device anchor cap."""
    from vgaligner_tpu.index import Index
    from vgaligner_tpu.io.fastx import QuerySequence
    from vgaligner_tpu.models.mapper import (
        _anchor_coords_host,
        anchors_for_query_host,
    )
    from vgaligner_tpu.native import anchor_coords_native

    g = graph_from_gfa(TEST_GFA)
    index = Index.build(g, 11, 100, 100)
    lin = index.seq_fwd
    seqs = [lin[i : i + 48] for i in range(0, 36, 3)] + [lin[2:30] + "N" + lin[40:70]]
    rng = np.random.default_rng(7)
    mem_off = [0]
    mem_slots = []
    expected = []
    a_max = []
    for ri, s in enumerate(seqs):
        anchors = anchors_for_query_host(
            index, QuerySequence.from_name_and_string("q", s)
        )
        cap = len(anchors) if ri % 3 else max(len(anchors) - 2, 1)
        a_max.append(cap)
        anchors = anchors[:cap]
        te_all = np.asarray([a.te for a in anchors], dtype=np.int64)
        order = np.argsort(te_all, kind="stable")
        positions = rng.permutation(len(anchors))  # sorted positions, scrambled
        mem_slots.extend(int(p) for p in positions)
        expected.extend(
            (anchors[order[p]].qb, anchors[order[p]].tb, anchors[order[p]].te)
            for p in positions
        )
        mem_off.append(len(mem_slots))
    mem_off = np.asarray(mem_off, dtype=np.int64)
    mem_slots = np.asarray(mem_slots, dtype=np.int32)
    a_max = np.asarray(a_max, dtype=np.int64)
    exp = np.asarray(expected, dtype=np.int64).reshape(-1, 3)

    qb_n, tb_n, te_n = anchor_coords_native(seqs, index, a_max, mem_off, mem_slots)
    qb_p, tb_p, te_p = _anchor_coords_host(seqs, index, a_max, mem_off, mem_slots)
    np.testing.assert_array_equal(qb_n, exp[:, 0])
    np.testing.assert_array_equal(tb_n, exp[:, 1])
    np.testing.assert_array_equal(te_n, exp[:, 2])
    np.testing.assert_array_equal(qb_p, qb_n)
    np.testing.assert_array_equal(tb_p, tb_n)
    np.testing.assert_array_equal(te_p, te_n)


def test_backtrack_matches_python():
    from vgaligner_tpu.native import backtrack_native

    rng = np.random.default_rng(5)
    B, A = 16, 64
    pred = np.full((B, A), -1, np.int32)
    starts = np.zeros((B, A), np.uint8)
    for b in range(B):
        # random forests of chains
        for i in range(1, A):
            if rng.random() < 0.7:
                pred[b, i] = rng.integers(max(0, i - 10), i)
        for i in range(A):
            if rng.random() < 0.3 and pred[b, i] != -1:
                starts[b, i] = 1
    n_valid = rng.integers(A // 2, A + 1, B).astype(np.int32)

    # python reference (Mapper._backtrack_positions semantics)
    def py_backtrack(pred_b, starts_b, n, min_anchors):
        pred_b = pred_b.copy()
        chains = []
        for i in np.nonzero(starts_b[:n])[0][::-1]:
            if pred_b[i] != -1:
                pos = []
                cur = int(i)
                while pred_b[cur] != -1:
                    p = int(pred_b[cur])
                    pred_b[cur] = -1
                    pos.append(cur)
                    cur = p
                pos.append(cur)
                if len(pos) >= min_anchors:
                    pos.reverse()
                    chains.append(pos)
        return chains

    read_off, chain_off, positions = backtrack_native(pred, starts, n_valid, 3)
    for b in range(B):
        expected = py_backtrack(pred[b], starts[b], int(n_valid[b]), 3)
        got = [
            positions[chain_off[c] : chain_off[c + 1]].tolist()
            for c in range(read_off[b], read_off[b + 1])
        ]
        assert got == expected, b


def test_poa_global_host_native_matches_oracle():
    """The native host POA (used for oversized subgraphs) must be
    bit-identical to the Python oracle, including tie rules."""
    from vgaligner_tpu.native import poa_global_host_native
    from vgaligner_tpu.ops.poa import align_global_host

    rng = np.random.default_rng(21)
    problems = [
        (["A", "CT", "GA", "GCA"], [(0, 1), (0, 2), (1, 3), (2, 3)], "ACTGCA"),
        (["ACTGACTG"], [], "ACTGCTG"),
        # wide fan-in beyond the device P_MAX
        (
            ["A"] + ["C", "G", "T", "AC", "GT", "CA", "TG", "AT", "CG"] + ["TTT"],
            [(0, i) for i in range(1, 10)] + [(i, 10) for i in range(1, 10)],
            "ACGTTT",
        ),
    ]
    for _ in range(6):
        n = int(rng.integers(3, 12))
        nodes = ["".join("ACGT"[c] for c in rng.integers(0, 4, int(rng.integers(1, 9)))) for _ in range(n)]
        edges = []
        for b in range(1, n):
            for a in rng.choice(b, size=min(b, int(rng.integers(1, 4))), replace=False):
                edges.append((int(a), b))
        q = "".join("ACGT"[c] for c in rng.integers(0, 4, int(rng.integers(5, 40))))
        problems.append((nodes, edges, q))
    for prob in problems:
        rn = poa_global_host_native(*prob)
        rh = align_global_host(*prob)
        assert rn.best_score == rh.best_score, prob
        assert rn.cigar == rh.cigar, prob
        assert rn.cs == rh.cs, prob
        assert rn.node_path == rh.node_path, prob
        assert rn.path_vertices == rh.path_vertices, prob
        assert rn.aln_start_offset == rh.aln_start_offset
        assert rn.aln_end_offset == rh.aln_end_offset
        assert rn.residue_matches == rh.residue_matches


def test_kmer_state_cap_native_matches_python(monkeypatch):
    """With a binding DFS state cap, the native and Python enumerations
    must truncate identically (same LIFO order, same cap accounting)."""
    from vgaligner_tpu.graph.handlegraph import HashGraph
    from vgaligner_tpu.index import Index

    # dense hub: 1bp nodes all cross-connected so the DFS branches hard
    g = HashGraph()
    hs = []
    for i, base in enumerate("ACGTACGTACGTACG", start=1):
        hs.append(g.create_handle(base, i))
    for i in range(len(hs)):
        for j in range(i + 1, min(i + 5, len(hs))):
            g.create_edge(hs[i], hs[j])

    native_idx = Index.build(g, 5, 100, 100, state_cap=50)
    monkeypatch.setenv("VGALIGNER_NO_NATIVE", "1")
    py_idx = Index.build(g, 5, 100, 100, state_cap=50)
    np.testing.assert_array_equal(native_idx.kmer_codes, py_idx.kmer_codes)
    np.testing.assert_array_equal(native_idx.positions, py_idx.positions)
    np.testing.assert_array_equal(native_idx.kmer_counts, py_idx.kmer_counts)
    # uncapped runs must also agree and be supersets of capped ones
    monkeypatch.delenv("VGALIGNER_NO_NATIVE")
    full = Index.build(g, 5, 100, 100, state_cap=0)
    assert full.n_kmers >= native_idx.n_kmers


@pytest.mark.parametrize("label", ["acT", "AUG"])
def test_kmer_index_non_acgt_fallback_matches_python(label):
    """Lowercase/U labels force the native sort off the packed-key fast
    path (2-bit keys are memcmp-equivalent only for uppercase ACGT);
    the memcmp fallback must still match the Python path exactly."""
    g = HashGraph()
    h1 = g.create_handle("ACT", 1)
    h2 = g.create_handle(label, 2)
    h3 = g.create_handle("GCAC", 3)
    g.create_edge(h1, h2)
    g.create_edge(h2, h3)
    k = 4
    pc, po, pn, pp = _python_kmer_index(g, k, 100, 100, None)
    nc, no, nn, npos = _native_kmer_index(g, k, 100, 100, None)
    np.testing.assert_array_equal(pc, nc)
    np.testing.assert_array_equal(po, no)
    np.testing.assert_array_equal(pn, nn)
    np.testing.assert_array_equal(pp, npos)


def test_baseline_map_align_matches_host_pipeline():
    """vg_baseline_map_align (the bench.py CPU baseline) must find exactly
    the chains the scalar Python restatement finds (same chain counts per
    read) and produce a POA tape for every aligned read."""
    from vgaligner_tpu.index import Index
    from vgaligner_tpu.models.host_pipeline import map_read_host
    from vgaligner_tpu.native import available, baseline_map_align_native

    if not available():
        pytest.skip("native lib unavailable")
    g = graph_from_gfa(os.path.join(DATA_DIR, "test.gfa"))
    index = Index.build(g, 11, 100, 100)
    reads = []
    for pid in g.paths_iter():
        seq = "".join(g.sequence(h) for h in g.get_path(pid).nodes)
        for st in range(0, len(seq) - 30, 7):
            reads.append(seq[st : st + 30])
    # include a read with no hits -> 0 chains, no tape
    reads.append("GGGGGGGGGGGGGGGGGGGG")
    nc, tl = baseline_map_align_native(index, reads, min_anchors=3, also_align=True)
    for i, s in enumerate(reads):
        chains, _, _ = map_read_host(index, s, 50, 1000, 3)
        assert nc[i] == len(chains), s
        assert (tl[i] > 0) == (len(chains) > 0)
    assert nc[-1] == 0 and tl[-1] == 0


def test_path_kmers_native_matches_python():
    """vg_path_kmers must reproduce generate_kmers_linearly +
    generate_pos_on_ref exactly (same codes, counts, rows)."""
    from vgaligner_tpu.index.kmer_gen import generate_kmers_linearly

    g = HashGraph()
    h1 = g.create_handle("ACTGAC", 1)
    h2 = g.create_handle("T", 2)
    h3 = g.create_handle("G", 3)
    h4 = g.create_handle("CCATTA", 4)
    for a, b in ((h1, h2), (h1, h3), (h2, h4), (h3, h4)):
        g.create_edge(a, b)
    for name, nodes in (("x", [h1, h2, h4]), ("y", [h1, h3, h4])):
        pid = g.create_path(name)
        for h in nodes:
            g.append_step(pid, h)
    lin = find_forward_sequence(g)

    kmers = generate_kmers_linearly(g, 5)
    seqs, off_p, cnt_p, pos_p = generate_pos_on_ref(
        g, kmers, lin.seq_len, lin.node_starts
    )
    codes_p = np.asarray([kmer_code(s) for s in seqs], dtype=np.int64)

    got = native.path_kmers_native(g, 5, lin.node_starts, lin.seq_len,
                                   dedup_positions=False)
    assert got is not None
    codes_n, off_n, cnt_n, pos_n = got
    np.testing.assert_array_equal(codes_n, codes_p)
    np.testing.assert_array_equal(cnt_n, cnt_p)
    np.testing.assert_array_equal(pos_n, pos_p)

    # dedup mode drops exact duplicate rows only
    got_d = native.path_kmers_native(g, 5, lin.node_starts, lin.seq_len,
                                     dedup_positions=True)
    codes_d, _off_d, cnt_d, pos_d = got_d
    np.testing.assert_array_equal(codes_d, codes_p)
    assert cnt_d.sum() <= cnt_p.sum()


@pytest.mark.skipif(not native.available(), reason="native unavailable")
def test_chains_gaf_blob_matches_python():
    """vg_chains_gaf must be byte-identical to joining
    from_chain/from_placeholder_chain + to_string — forward chains,
    placeholder rows, both-strands '-' chains, and mixed-orient
    anchors (align.rs:762-930, 971-1027)."""
    from vgaligner_tpu.graph import graph_from_gfa
    from vgaligner_tpu.index import Index
    from vgaligner_tpu.io.fastx import QuerySequence, read_seqs_from_file
    from vgaligner_tpu.models.mapper import Chain, ChainAnchor, Mapper

    g = graph_from_gfa(os.path.join(DATA_DIR, "test.gfa"))
    index = Index.build(g, 11, 100, 100)
    path_seqs = [
        "".join(g.sequence(h) for h in g.get_path(p).nodes)
        for p in g.paths_iter()
    ]
    from vgaligner_tpu.utils.dna import reverse_complement

    queries = [
        QuerySequence.from_name_and_string(f"p{i}", s)
        for i, s in enumerate(path_seqs)
    ] + [
        # revcomp reads exercise the '-' strand flip via both_strands
        QuerySequence.from_name_and_string(
            f"rc{i}", reverse_complement(s)
        )
        for i, s in enumerate(path_seqs)
    ] + list(read_seqs_from_file(os.path.join(DATA_DIR, "multiple-read-test.fa")))

    for both in (False, True):
        mapper = Mapper(index, chain_min_n_anchors=3, precision="fast",
                        both_strands=both)
        chains = mapper.map_reads(queries)
        want = "".join(
            r.to_string() for r in mapper.chains_to_gaf(chains)
        ).encode("ascii")
        got = native.chains_gaf_blob_native(chains, index)
        assert got is not None
        assert got == want, f"both_strands={both}"
        assert mapper.chains_gaf_text(chains) == want

    # synthetic mixed-orient anchors (the host full-orientation API)
    from vgaligner_tpu.io.gaf import GAFAlignment

    q = QuerySequence.from_name_and_string("mix", "A" * 30)
    anchors = [
        ChainAnchor(id=0, qb=0, qe=11, tb=3, te=14, so=0, eo=1),
        ChainAnchor(id=1, qb=5, qe=16, tb=9, te=20, so=1, eo=0),
        ChainAnchor(id=2, qb=9, qe=20, tb=30, te=41, so=1, eo=1),
    ]
    ch = Chain.from_anchor_list(q, anchors)
    want1 = GAFAlignment.from_chain(ch, index).to_string().encode("ascii")
    got1 = native.chains_gaf_blob_native([[ch]], index)
    assert got1 == want1
