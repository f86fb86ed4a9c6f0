"""POA engine and base-level alignment tests.

Scoring model: abPOA defaults (match 2, mismatch -4, convex gaps
4/2 + 24/1); hand-computed expectations on tiny graphs, plus an
end-to-end --also-align flow over test.gfa.
"""

import os

import pytest

from vgaligner_tpu.graph import graph_from_gfa
from vgaligner_tpu.index import Index
from vgaligner_tpu.io.fastx import QuerySequence
from vgaligner_tpu.models.mapper import Mapper
from vgaligner_tpu.models.poa_aligner import (
    PoaAligner,
    PoaEngine,
    RangeOrient,
    extend_range_chain,
    find_nodes_edges,
    find_range_chain,
)
from vgaligner_tpu.ops.poa import (
    align_global_host,
    align_local_no_gap_host,
    build_base_graph,
    gap_cost,
)

from conftest import DATA_DIR

DIAMOND_NODES = ["A", "CT", "GA", "GCA"]
DIAMOND_EDGES = [(0, 1), (0, 2), (1, 3), (2, 3)]


def test_gap_cost_convex():
    assert gap_cost(0) == 0
    assert gap_cost(1) == 6  # 4+2 < 24+1
    assert gap_cost(10) == 24  # piece1: 24, piece2: 34 -> 24
    assert gap_cost(30) == 54  # piece2 wins: 24+30 < 4+60


def test_base_graph_topology():
    bg = build_base_graph(DIAMOND_NODES, DIAMOND_EDGES)
    assert len(bg.codes) == 8
    assert bg.is_source[0]
    # sinks: last base of node 3 (GCA)
    assert bg.is_sink.sum() == 1
    # first base of CT has pred = vertex of A
    assert bg.preds[1] == [0]


def test_global_exact_match():
    res = align_global_host(["ACT"], [], "ACT")
    assert res.cigar == "3M"
    assert res.cs == "cs:Z::3"
    assert res.best_score == 6
    assert res.node_path == [0]
    assert res.n_aligned == 3


def test_global_diamond_paths():
    res = align_global_host(DIAMOND_NODES, DIAMOND_EDGES, "ACTGCA")
    assert res.cigar == "6M"
    assert res.best_score == 12
    assert res.node_path == [0, 1, 3]

    res = align_global_host(DIAMOND_NODES, DIAMOND_EDGES, "AGAGCA")
    assert res.cigar == "6M"
    assert res.node_path == [0, 2, 3]


def test_global_mismatch():
    res = align_global_host(DIAMOND_NODES, DIAMOND_EDGES, "ACTGCC")
    assert res.cigar == "6M"
    assert res.best_score == 5 * 2 - 4
    assert "*" in res.cs  # one substitution


def test_global_insertion():
    res = align_global_host(DIAMOND_NODES, DIAMOND_EDGES, "ACTTGCA")
    assert res.best_score == 6 * 2 - gap_cost(1)
    assert "I" in res.cigar
    assert "+" in res.cs


def test_global_deletion():
    res = align_global_host(["ACT", "GGGG", "CA"], [(0, 1), (1, 2)], "ACTCA")
    # delete the middle node entirely: 5 matches - gap(4)
    assert res.best_score == 10 - gap_cost(4)
    assert "4D" in res.cigar
    assert "-gggg" in res.cs


def test_local_no_gap():
    res = align_local_no_gap_host(DIAMOND_NODES, DIAMOND_EDGES, "TTACTGCATT")
    assert res.query_start == 2
    assert res.query_end == 8
    assert res.residue_matches == 6
    assert res.node_path == [0, 1, 3]


def _chain_for(index, mapper, seq, name="r"):
    chains = mapper.map_reads([QuerySequence.from_name_and_string(name, seq)])[0]
    return chains[0]


@pytest.fixture(scope="module")
def tindex():
    g = graph_from_gfa(f"{DATA_DIR}/test.gfa")
    return g, Index.build(g, 11, 100, 100)


def test_find_range_chain(tindex):
    g, index = tindex
    mapper = Mapper(index, chain_min_n_anchors=3)
    path_x_seq = "".join(g.sequence(h) for h in g.get_path(0).nodes)
    chain = _chain_for(index, mapper, path_x_seq)
    rng = find_range_chain(index, chain)
    assert rng.orient == RangeOrient.FORWARD
    from vgaligner_tpu.graph.handlegraph import handle_id

    ids = [handle_id(h) for h in rng.handles]
    assert ids == list(range(min(ids), max(ids) + 1))
    assert min(ids) == 1 and max(ids) == 19


def test_extend_range_noop_when_full_cover(tindex):
    g, index = tindex
    mapper = Mapper(index, chain_min_n_anchors=3)
    path_x_seq = "".join(g.sequence(h) for h in g.get_path(0).nodes)
    chain = _chain_for(index, mapper, path_x_seq)
    rng = find_range_chain(index, chain)
    ext = extend_range_chain(index, chain, rng)
    assert ext.handles == rng.handles  # chain covers the whole read


def test_find_nodes_edges(tindex):
    g, index = tindex
    mapper = Mapper(index, chain_min_n_anchors=3)
    path_x_seq = "".join(g.sequence(h) for h in g.get_path(0).nodes)
    chain = _chain_for(index, mapper, path_x_seq)
    ext = extend_range_chain(index, chain, find_range_chain(index, chain))
    nodes, edges = find_nodes_edges(index, ext)
    assert len(nodes) == 19
    assert all(a < b for a, b in edges)  # forward orient: loops removed
    assert nodes[0] == "CAAATAAG"


def test_also_align_end_to_end(tindex, tmp_path, monkeypatch):
    """map --also-align analog over test.gfa: alignment GAF rows with POA
    notes for a path read (both engines)."""
    g, index = tindex
    monkeypatch.chdir(tmp_path)
    mapper = Mapper(index, chain_min_n_anchors=3)
    path_x_seq = "".join(g.sequence(h) for h in g.get_path(0).nodes)
    chains = mapper.map_reads(
        [QuerySequence.from_name_and_string("px", path_x_seq)]
    )

    for engine in (PoaEngine.ABPOA, PoaEngine.RSPOA):
        aligner = PoaAligner(index, engine, export_subgraphs=True, graph=g)
        aln = aligner.best_alignment_for_query(chains[0], align_best_n=1)
        s = aln.to_string()
        cols = s.rstrip("\n").split("\t")
        assert len(cols) == 13
        assert cols[0] == "px"
        assert cols[11] == "255"
        # the alignment path must be exactly path x's nodes
        from vgaligner_tpu.io.validate import parse_nodes_from_path_matching

        assert parse_nodes_from_path_matching(cols[5]) == [
            1, 3, 5, 6, 8, 9, 11, 12, 13, 15, 16, 18, 19,
        ]
        if engine == PoaEngine.ABPOA:
            assert "cg:Z:50M" in cols[12]
            assert "cs:Z::50" in cols[12]
    # subgraph export side effect (align.rs:104-120)
    assert os.path.exists(tmp_path / "subgraphs" / "px-subgraph-40.gfa")


def test_placeholder_chain_alignment(tindex):
    g, index = tindex
    mapper = Mapper(index, chain_min_n_anchors=3)
    chains = mapper.map_reads(
        [QuerySequence.from_name_and_string("nope", "GGGGGGGGGGGGGGGG")]
    )
    aligner = PoaAligner(index, PoaEngine.ABPOA)
    aln = aligner.best_alignment_for_query(chains[0])
    assert aln.to_string().startswith("nope\t16\t*")


def test_bubble_closure_recovers_distant_alt_allele():
    """A SNP bubble whose alt node id is far from its flanks (the
    spoa/smooth HLA graph layout): the reference's contiguous-id range
    forces the ref allele with a substitution; with bubble closure the
    POA routes through the alt node exactly."""
    from vgaligner_tpu.graph.handlegraph import HashGraph
    from vgaligner_tpu.index import Index
    from vgaligner_tpu.io.fastx import QuerySequence
    from vgaligner_tpu.models.mapper import Mapper
    from vgaligner_tpu.models.poa_aligner import PoaAligner, PoaEngine

    g = HashGraph()
    h1 = g.create_handle("CCAGGACAGCCAGGCCAGCA", 1)
    h2 = g.create_handle("T", 2)  # ref allele
    h3 = g.create_handle("GATGGGGATGGTGGGCTGGG", 3)
    h4 = g.create_handle("TTACGGATTCAGGCAACTGA", 4)
    h5 = g.create_handle("C", 5)  # alt allele, id outside the chain range
    g.create_edge(h1, h2)
    g.create_edge(h1, h5)
    g.create_edge(h2, h3)
    g.create_edge(h5, h3)
    g.create_edge(h3, h4)
    index = Index.build(g, 11, 100, 100)

    read = "CCAGGACAGCCAGGCCAGCA" + "C" + "GATGGGGATGGTGGGCTGGG" + "TTACGGATTCAGGCAACTGA"
    q = QuerySequence.from_name_and_string("alt", read)
    mapper = Mapper(index, chain_min_n_anchors=3)
    chains = mapper.map_reads([q])

    with_closure = PoaAligner(index, PoaEngine.ABPOA, bubble_closure=True)
    aln = with_closure.best_alignments_for_queries(chains)[0]
    assert aln.path_matching == ">1>5>3>4", aln.path_matching
    assert "cg:Z:61M" in (aln.notes or ""), aln.notes

    # the corridor range (default) recovers the alt allele too
    corridor = PoaAligner(index, PoaEngine.ABPOA, range_mode="corridor")
    aln_c = corridor.best_alignments_for_queries(chains)[0]
    assert aln_c.path_matching == ">1>5>3>4", aln_c.path_matching
    assert "cg:Z:61M" in (aln_c.notes or ""), aln_c.notes

    parity = PoaAligner(index, PoaEngine.ABPOA, range_mode="id")
    aln_p = parity.best_alignments_for_queries(chains)[0]
    # reference-parity subgraph misses node 5 -> substitution via node 2
    assert ">5" not in (aln_p.path_matching or ""), aln_p.path_matching


def test_find_range_chain_reverse_and_both(tindex):
    """align.rs:267-402's Reverse and Both cases: a chain whose anchors
    sit on reverse-orient handles yields a reverse contiguous range; a
    mixed-orient chain yields BOTH (fwd+rev handle pair per id)."""
    from vgaligner_tpu.graph.handlegraph import handle_id, handle_is_reverse
    from vgaligner_tpu.models.mapper import anchors_for_query_host
    from vgaligner_tpu.models.mapper import Chain
    from vgaligner_tpu.utils.dna import reverse_complement

    g, index = tindex
    path_x_seq = "".join(g.sequence(h) for h in g.get_path(0).nodes)
    # a read from the reverse strand anchors on reverse-orient positions
    rc = reverse_complement(path_x_seq[:40])
    q = QuerySequence.from_name_and_string("rev", rc)
    anchors = [
        a for a in anchors_for_query_host(index, q, only_forward=False)
        if a.so != 0 and a.eo != 0
    ]
    assert anchors, "expected reverse-orient anchors for an RC read"
    chain = Chain.from_anchor_list(q, anchors)
    rng = find_range_chain(index, chain)
    assert rng.orient == RangeOrient.REVERSE
    assert all(handle_is_reverse(h) for h in rng.handles)
    ids = sorted(handle_id(h) for h in rng.handles)
    assert ids == list(range(min(ids), max(ids) + 1))

    # mixed orientation -> BOTH: every id appears in both orients
    fwd_anchors = anchors_for_query_host(
        index, QuerySequence.from_name_and_string("f", path_x_seq[:40])
    )
    mixed = Chain.from_anchor_list(q, anchors[:1] + fwd_anchors[:1])
    rng2 = find_range_chain(index, mixed)
    assert rng2.orient == RangeOrient.BOTH
    by_id = {}
    for h in rng2.handles:
        by_id.setdefault(handle_id(h), set()).add(handle_is_reverse(h))
    assert all(v == {False, True} for v in by_id.values())


def test_trimmed_poa_score():
    """Flank-penalty-free cs re-scoring (PoaAligner.trimmed_poa_score):
    leading/trailing deletion runs stripped, interior ops scored at
    abPOA defaults (match +2, mismatch -4, two-piece gap)."""
    from vgaligner_tpu.models.poa_aligner import PoaAligner

    f = PoaAligner.trimmed_poa_score
    assert f("cs:Z::50") == 100
    # leading deletion stripped; mismatch -4
    assert f("cs:Z:-acg:10*at:5") == 20 - 4 + 10
    # trailing deletion stripped
    assert f("cs:Z::10-acgt") == 20
    # interior deletion pays gap cost min(4+2g, 24+g): g=3 -> 10
    assert f("cs:Z::10-acg:10") == 40 - 10
    # insertion: g=2 -> 8
    assert f("cs:Z::5+ac:5") == 20 - 8
    # long gap crosses the two-piece crossover: g=25 -> 24+25 = 49
    assert f("cs:Z::20-" + "a" * 25 + ":20") == 80 - 49
    # both flanks + prefix-less string (no cs:Z: header)
    assert f(":-aaaa:7-cc"[1:]) == 14
    # flank-only alignment degenerates to 0
    assert f("cs:Z:-acgt") == 0
