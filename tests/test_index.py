"""Index tests ported from the reference inline tests.

Golden values from /root/reference/src/index.rs:826-840 (k-mer counts),
1108-1170 (fwd/rev position lookups), 1218-1243 (rank from seqpos),
1077-1106 (serialization round trip), and src/kmer.rs position
semantics.
"""

import numpy as np
import pytest

from vgaligner_tpu.graph import find_forward_sequence, graph_from_gfa
from vgaligner_tpu.graph.handlegraph import HashGraph, handle_pack
from vgaligner_tpu.index import Index, generate_kmers, generate_pos_on_ref
from vgaligner_tpu.index.kmer_gen import FORWARD, REVERSE

from conftest import DATA_DIR


def test_kmers_graph_generation(simple_graph):
    # index.rs:826-840 (sequential variant counts; graph has no Ns so the
    # parallel/production N-policy is identical)
    assert len(generate_kmers(simple_graph, 3, 100, 100)) == 14
    assert len(generate_kmers(simple_graph, 6, 100, 100)) == 4
    assert len(generate_kmers(simple_graph, 100, 100, 100)) == 0


def test_kmers_simple_path():
    # index.rs:885-889
    g = HashGraph()
    h1 = g.create_handle("ACG", 1)
    h2 = g.create_handle("TTT", 2)
    h3 = g.create_handle("CA", 3)
    g.create_edge(h1, h2)
    g.create_edge(h2, h3)
    assert len(generate_kmers(g, 3, 100, 100)) == 12


def test_kmer_positions_validity(simple_graph_2):
    """test_table analog (index.rs:966-1075): every indexed position's
    substring borders match the k-mer's first/last base."""
    lin = find_forward_sequence(simple_graph_2)
    from vgaligner_tpu.utils.dna import reverse_complement

    seq_fwd = lin.seq_fwd
    seq_rev = reverse_complement(seq_fwd)
    kmers = generate_kmers(simple_graph_2, 3, 100, 100)
    seqs, offsets, counts, positions = generate_pos_on_ref(
        simple_graph_2, kmers, lin.seq_len, lin.node_starts
    )
    assert len(seqs) == len(offsets) == len(counts)
    for g_i, seq in enumerate(seqs):
        rows = positions[offsets[g_i] : offsets[g_i] + counts[g_i]]
        assert len(rows) > 0
        for so, sp, eo, ep in rows:
            ref = seq_fwd if so == FORWARD else seq_rev
            sub = ref[sp:ep]
            assert seq[0] == sub[0]
            assert seq[2] == sub[-1]


def test_index_access(simple_graph):
    # index.rs:1108-1129
    index = Index.build(simple_graph, 3, 100, 100)
    pos = index.find_positions_for_query_kmer("ACT")
    assert pos == [(FORWARD, 0, FORWARD, 3)]


def test_index_access_2():
    # index.rs:1131-1170: TTT -> AAA
    g = HashGraph()
    h1 = g.create_handle("TTT", 1)
    h2 = g.create_handle("AAA", 2)
    g.create_edge(h1, h2)
    index = Index.build(g, 3, 100, 100)
    pos = index.find_positions_for_query_kmer("TTT")
    assert pos == [(FORWARD, 0, FORWARD, 3), (REVERSE, 0, REVERSE, 3)]


def test_index_access_nodes(simple_graph):
    # index.rs:1218-1243
    index = Index.build(simple_graph, 3, 100, 100)
    assert index.node_id_from_seqpos(FORWARD, 0) == 1
    assert index.node_id_from_seqpos(FORWARD, 2) == 2
    assert index.node_id_from_seqpos(REVERSE, 0) == 4


def test_select(simple_graph):
    index = Index.build(simple_graph, 3, 100, 100)
    assert index.get_bv_select(1) == 0
    assert index.get_bv_select(2) == 1
    assert index.get_bv_select(4) == 5
    assert index.get_bv_select(5) == 8  # end marker
    assert index.get_bv_select(6) == 0  # reference fallthrough
    with pytest.raises(ValueError):
        index.get_bv_select(0)


def test_seq_from_handle(simple_graph):
    index = Index.build(simple_graph, 3, 100, 100)
    assert index.seq_from_handle(handle_pack(2, False)) == "CT"
    assert index.seq_from_handle(handle_pack(2, True)) == "AG"
    assert index.seq_from_handle(handle_pack(4, False)) == "GCA"
    assert index.seq_from_handle(handle_pack(4, True)) == "TGC"


def test_edges_from_handle(simple_graph):
    index = Index.build(simple_graph, 3, 100, 100)
    h = lambda i, r=False: handle_pack(i, r)
    assert index.incoming_edges_from_handle(h(2)) == [h(1)]
    assert index.outgoing_edges_from_handle(h(2)) == [h(4)]
    assert index.incoming_edges_from_handle(h(1)) == []
    assert index.outgoing_edges_from_handle(h(1)) == [h(2), h(3)]
    # reverse handles: flipped + reversed views (index.rs:559-606)
    assert index.outgoing_edges_from_handle(h(4, True)) == [h(3, True), h(2, True)]
    assert index.incoming_edges_from_handle(h(2, True)) == [h(4, True)]


def test_serialization_roundtrip(tmp_path, simple_graph):
    # index.rs:1077-1106
    index = Index.build(simple_graph, 3, 100, 100)
    path = str(tmp_path / "test.idx.npz")
    index.save(path)
    loaded = Index.load(path)
    assert loaded.kmer_length == index.kmer_length
    assert loaded.seq_length == index.seq_length
    assert loaded.seq_fwd == index.seq_fwd
    assert loaded.seq_rev == index.seq_rev
    np.testing.assert_array_equal(loaded.node_starts, index.node_starts)
    assert loaded.n_edges == index.n_edges
    np.testing.assert_array_equal(loaded.edges, index.edges)
    assert loaded.n_nodes == index.n_nodes
    assert loaded.n_kmers == index.n_kmers
    assert loaded.n_kmer_pos == index.n_kmer_pos
    np.testing.assert_array_equal(loaded.kmer_codes, index.kmer_codes)
    np.testing.assert_array_equal(loaded.positions, index.positions)
    np.testing.assert_array_equal(loaded.fo_positions, index.fo_positions)
    assert loaded.loaded


def test_index_test_gfa():
    """Index over the reference test fixture builds and is self-consistent."""
    g = graph_from_gfa(f"{DATA_DIR}/test.gfa")
    index = Index.build(g, 11, 100, 100)
    assert index.n_kmers > 0
    # forward-only table consistency
    assert index.fo_counts.sum() == len(index.fo_positions)
    assert (index.fo_counts <= index.kmer_counts).all()
    # every k-mer of the forward linearization must be findable
    seq = index.seq_fwd
    k = 11
    found = 0
    for i in range(len(seq) - k + 1):
        if index.find_positions_for_query_kmer(seq[i : i + k]):
            found += 1
    assert found > 0


def test_test_gfa_kmer_count_matches_reference():
    """340 k-mers at k=11 on the reference's test.gfa: the count earlier
    builds recorded against the reference's own copy of the file, so it
    pins the rebuilt fixture to it."""
    g = graph_from_gfa(f"{DATA_DIR}/test.gfa")
    assert Index.build(g, 11, 100, 100).n_kmers == 340


def test_generate_kmers_linearly_matches_dfs_on_single_path():
    """On a single-path chain every k-mer is path-covered, so the
    path-guided generator (kmer.rs:510-728) yields the same sequence
    multiset as the DFS generator (the reference's disabled equivalence
    test, index.rs:731-758, restricted to the case where it holds)."""
    from vgaligner_tpu.graph.handlegraph import HashGraph
    from vgaligner_tpu.index.kmer_gen import generate_kmers, generate_kmers_linearly

    g = HashGraph()
    hs = [g.create_handle(s, i + 1) for i, s in enumerate(["ACTG", "TT", "GACA"])]
    for a, b in zip(hs, hs[1:]):
        g.create_edge(a, b)
    pid = g.create_path("p")
    for h in hs:
        g.append_step(pid, h)

    dfs = generate_kmers(g, 4, 100, 100)
    lin = generate_kmers_linearly(g, 4)
    assert sorted(km.seq for km in lin) == sorted(km.seq for km in dfs)
    # positions of forward-strand kmers agree too
    dfs_fwd = {(km.seq, km.first_handle, km.begin_offset)
               for km in dfs if km.handle_orient}
    lin_fwd = {(km.seq, km.first_handle, km.begin_offset)
               for km in lin if km.handle_orient}
    assert lin_fwd == dfs_fwd


def test_path_guided_fallback_on_dfs_cap():
    """When the k-mer DFS state cap truncates enumeration, every
    embedded-path k-mer must still be indexed via the path-guided
    fallback merge (Index.build), in both native and Python paths."""
    import os

    import numpy as np

    from vgaligner_tpu.graph import graph_from_gfa
    from vgaligner_tpu.index.build import Index

    from conftest import DATA_DIR

    g = graph_from_gfa(f"{DATA_DIR}/test.gfa")
    full = Index.build(g, 11, 100, 100)

    for no_native in ("", "1"):
        if no_native:
            os.environ["VGALIGNER_NO_NATIVE"] = no_native
        try:
            capped = Index.build(g, 11, 100, 100, state_cap=4)
        finally:
            os.environ.pop("VGALIGNER_NO_NATIVE", None)
        # strictly sorted codes and consistent offsets survive the merge
        assert (np.diff(capped.kmer_codes) > 0).all()
        assert (capped.kmer_offsets[1:]
                == (capped.kmer_offsets + capped.kmer_counts)[:-1]).all()
        # every k-mer of every embedded path is findable
        for pid in g.paths_iter():
            seq = "".join(g.sequence(h) for h in g.get_path(pid).nodes)
            for i in range(len(seq) - 11 + 1):
                assert capped.find_positions_for_query_kmer(seq[i : i + 11]), (
                    no_native, i,
                )
        # sanity: the capped+merged index is a subset of the full one
        assert len(capped.kmer_codes) <= len(full.kmer_codes)


def test_merge_kmer_tables_edges():
    """_merge_kmer_tables: duplicates in the primary are preserved,
    additions are set-unioned, new codes insert in sorted order."""
    import numpy as np

    from vgaligner_tpu.index.build import _merge_kmer_tables

    # primary: codes 5 (two identical rows — legal duplicate), 9
    c1 = np.asarray([5, 9], dtype=np.int64)
    n1 = np.asarray([2, 1], dtype=np.int64)
    o1 = np.asarray([0, 2], dtype=np.int64)
    p1 = np.asarray(
        [[0, 10, 0, 21], [0, 10, 0, 21], [0, 40, 0, 51]], dtype=np.int64
    )
    # secondary: code 3 (new, with an internal duplicate kept as-is?
    # no — np.unique dedups additions), 5 (one dup of existing + one new
    # row), 9 (fully duplicate)
    c2 = np.asarray([3, 5, 9], dtype=np.int64)
    n2 = np.asarray([2, 2, 1], dtype=np.int64)
    o2 = np.asarray([0, 2, 4], dtype=np.int64)
    p2 = np.asarray(
        [
            [0, 1, 0, 12], [0, 1, 0, 12],           # code 3
            [0, 10, 0, 21], [0, 5, 0, 16],          # code 5
            [0, 40, 0, 51],                          # code 9
        ],
        dtype=np.int64,
    )

    c, o, n, p = _merge_kmer_tables(c1, o1, n1, p1, c2, o2, n2, p2)
    assert c.tolist() == [3, 5, 9]
    # code 3: secondary-internal duplicate rows dedup to one;
    # code 5: one exact duplicate skipped, one new row sorted in, the
    #   primary's legal internal duplicate preserved;
    # code 9: fully duplicate secondary row NOT re-added
    assert n.tolist() == [1, 3, 1]
    assert o.tolist() == [0, 1, 4]
    assert p.tolist() == [
        [0, 1, 0, 12],
        [0, 5, 0, 16], [0, 10, 0, 21], [0, 10, 0, 21],
        [0, 40, 0, 51],
    ]


def test_n_policy_drop_kmer_vs_drop_handle():
    """N policy (build extension): the reference's production DFS drops
    EVERY k-mer of a handle whose enumeration meets an N
    (kmer.rs:400-403); its path-guided generator only skips the
    N-containing k-mer (kmer.rs:161-163).  Index.build exposes both,
    defaulting to drop-kmer, which keeps the N-free flanks of
    N-containing nodes indexed (without it, HLA-zoo 4-A3105 loses 93%
    of its sequence: two ~53 kb nodes with interior N runs)."""
    g = HashGraph()
    h1 = g.create_handle("ACGT", 1)
    # 4 N-free kmer starts at offsets 0-3, then an N, then 6 more at 9-14
    h2 = g.create_handle("ACGTACGTANCCGGCCAAGGTTAA", 2)
    h3 = g.create_handle("TGCA", 3)
    g.create_edge(h1, h2)
    g.create_edge(h2, h3)

    strict = Index.build(g, 11, 100, 100, n_policy="drop-handle")
    lenient = Index.build(g, 11, 100, 100, n_policy="drop-kmer")

    def fwd_starts_in(index, lo, hi):
        pos = index.fo_positions
        return int(((pos[:, 0] >= lo) & (pos[:, 0] < hi)).sum())

    start2 = strict.get_bv_select(2)
    # drop-handle: no k-mer starting inside node 2 at all
    assert fwd_starts_in(strict, start2, start2 + 24) == 0
    # drop-kmer: every N-free window starting in node 2 is indexed
    # (24 starts, minus 11 windows covering the N at offset 9, minus
    # dedup of identical full records — count positions, not kmers)
    n_lenient = fwd_starts_in(lenient, start2, start2 + 24)
    assert n_lenient > 0
    # exact: starts 0..24 except those whose window [s, s+11) crosses
    # offset 9 within the node or runs past the graph end
    seq = "ACGTACGTANCCGGCCAAGGTTAA" + "TGCA"
    expected = sum(
        1
        for s in range(24)
        if "N" not in seq[s : s + 11] and s + 11 <= len(seq)
    )
    assert n_lenient == expected
    # the k-mers themselves resolve to the right positions
    km = seq[12:23]
    hits = lenient.find_positions_for_query_kmer(km)
    assert any(p[0] == 0 and p[1] == start2 + 12 for p in hits)
    assert strict.find_positions_for_query_kmer(km) == []


def test_duplicate_position_dedup_default_and_parity_optout():
    """Fork-dense graphs generate the same (kmer, position) record via
    many DFS paths; the reference's adjacent-only dedup (kmer.rs:299-301)
    misses the non-adjacent ones (measured 104x duplicated rows on
    HLA-zoo 5-B3106).  The default build drops exact duplicate rows
    (and state-merges the DFS); dedup_positions=False restores the
    reference's literal table."""
    import numpy as np

    from vgaligner_tpu.graph.handlegraph import HashGraph
    from vgaligner_tpu.index import Index

    # A -> {B1,B2} (same label) -> {C,D} (same label): the k-mer
    # AAGTT via B1/C equals the one via B2/C record-for-record, but the
    # LIFO interleaves the C- and D-completions (…D2,C2,D1,C1…), so the
    # duplicates are NOT adjacent after the stable seq sort and survive
    # the reference's Vec::dedup
    g = HashGraph()
    a = g.create_handle("AA", 1)
    b1 = g.create_handle("G", 2)
    b2 = g.create_handle("G", 3)
    c = g.create_handle("TT", 4)
    d = g.create_handle("TT", 5)
    for x in (b1, b2):
        g.create_edge(a, x)
        g.create_edge(x, c)
        g.create_edge(x, d)

    dd = Index.build(g, 5, 100, 100)
    keep = Index.build(g, 5, 100, 100, dedup_positions=False)

    def rows(idx):
        grp = np.repeat(np.arange(len(idx.kmer_counts)), idx.kmer_counts)
        return np.concatenate([grp[:, None], idx.positions], axis=1)

    rd, rk = rows(dd), rows(keep)
    # the parity build retains duplicates; the default build has none
    assert len(np.unique(rk, axis=0)) < len(rk)
    assert len(np.unique(rd, axis=0)) == len(rd)
    # deduping the parity table reproduces the default table's rows
    np.testing.assert_array_equal(np.unique(rk, axis=0),
                                  np.unique(rd, axis=0))
