"""Graph-layer tests ported from the reference's inline test modules.

Golden values come from /root/reference/src/index.rs:760-890 and
src/dna.rs:42-51; they validate linearization order, node_ref contents,
the flat edge vector layout, and reverse-complement.
"""

import numpy as np

from vgaligner_tpu.graph import find_forward_sequence, find_graph_seq_length, graph_from_gfa
from vgaligner_tpu.graph.handlegraph import HashGraph, handle_pack
from vgaligner_tpu.utils.dna import encode_seq, decode_seq, kmer_code, reverse_complement

from conftest import DATA_DIR


def test_revcomp():
    # dna.rs:47-51
    assert reverse_complement("ATGC") == "GCAT"
    # switch_base's fallthrough maps any N (upper or lower) to 'N' (dna.rs:31)
    assert reverse_complement("acgtn") == "Nacgt"


def test_encode_roundtrip():
    codes = encode_seq("ACGTN")
    assert codes.tolist() == [0, 1, 2, 3, 4]
    assert decode_seq(codes) == "ACGTN"
    assert kmer_code("ACT") == (0 << 4) | (1 << 2) | 3
    assert kmer_code("ANT") == -1


def test_forward_creation(simple_graph):
    # index.rs:760-824
    lin = find_forward_sequence(simple_graph)
    assert find_graph_seq_length(simple_graph) == 8
    assert lin.seq_fwd == "ACTGAGCA"
    # bitvector marks node starts + end: positions {0,1,3,5,8}
    assert lin.node_starts.tolist() == [0, 1, 3, 5, 8]
    # NodeRef golden values
    assert lin.edge_idx.tolist() == [0, 2, 4, 6, 8]
    assert lin.edges_to_node.tolist() == [0, 1, 1, 2]
    # edges: node1 [right: 2+,3+], node2 [left: 1+, right: 4+],
    # node3 [left: 1+, right: 4+], node4 [left: 2+,3+]
    h = lambda i: handle_pack(i, False)
    assert lin.edges.tolist() == [h(2), h(3), h(1), h(4), h(1), h(4), h(2), h(3)]


def test_simple_path():
    # index.rs:842-890: ACG -> TTT -> CA
    g = HashGraph()
    h1 = g.create_handle("ACG", 1)
    h2 = g.create_handle("TTT", 2)
    h3 = g.create_handle("CA", 3)
    g.create_edge(h1, h2)
    g.create_edge(h2, h3)
    lin = find_forward_sequence(g)
    assert lin.seq_fwd == "ACGTTTCA"
    assert lin.node_starts.tolist() == [0, 3, 6, 8]
    assert lin.edge_idx[1] == 1 and lin.edges_to_node[1] == 1
    assert lin.edge_idx[2] == 3 and lin.edges_to_node[2] == 1


def test_gfa_parse():
    g = graph_from_gfa(f"{DATA_DIR}/test.gfa")
    assert g.n_nodes == 19
    assert g.min_id == 1 and g.max_id == 19
    assert g.sequence(handle_pack(1, False)) == "CAAATAAG"
    assert g.sequence(handle_pack(19, False)) == "CCAACTCTCTG"
    # reverse orientation = revcomp
    assert g.sequence(handle_pack(1, True)) == "CTTATTTG"
    assert len(g.paths) == 3
    # path x: 13 steps
    assert len(g.get_path(0).nodes) == 13
    # total length
    assert find_graph_seq_length(g) == sum(
        len(g.sequence(h)) for h in g.handles()
    )


def test_edges_iter_reverse(simple_graph):
    """Orientation-consistent neighbor iteration for reverse handles."""
    h4r = handle_pack(4, True)
    # going right from 4- = going left from 4+ = [2+, 3+] flipped
    assert simple_graph.right_neighbors(h4r) == [handle_pack(2, True), handle_pack(3, True)]
    h1r = handle_pack(1, True)
    assert simple_graph.right_neighbors(h1r) == []
    assert simple_graph.left_neighbors(h1r) == [handle_pack(2, True), handle_pack(3, True)]


def test_bfs_linearization_linear_graph():
    """On a linear id-ordered chain, BFS order equals sorted-handle order
    (utils.rs:38-76)."""
    from vgaligner_tpu.graph.linearize import (
        find_forward_sequence,
        find_forward_sequence_bfs,
    )

    g = HashGraph()
    handles = [g.create_handle(s, i + 1) for i, s in enumerate(["ACT", "G", "TTAC"])]
    for a, b in zip(handles, handles[1:]):
        g.create_edge(a, b)
    fwd, starts, order = find_forward_sequence_bfs(g)
    lin = find_forward_sequence(g)
    assert fwd == lin.seq_fwd == "ACTGTTAC"
    assert list(starts) == list(lin.node_starts)
    assert list(order) == [1, 2, 3]


def test_bfs_linearization_diamond_order():
    """Diamond: BFS visits both branches before the join (FIFO queue)."""
    from vgaligner_tpu.graph.linearize import find_forward_sequence_bfs

    g = HashGraph()
    h1 = g.create_handle("A", 1)
    h2 = g.create_handle("CT", 2)
    h3 = g.create_handle("GA", 3)
    h4 = g.create_handle("GCA", 4)
    g.create_edge(h1, h2)
    g.create_edge(h1, h3)
    g.create_edge(h2, h4)
    g.create_edge(h3, h4)
    fwd, starts, order = find_forward_sequence_bfs(g)
    assert list(order) == [1, 2, 3, 4]
    assert fwd == "ACTGAGCA"
