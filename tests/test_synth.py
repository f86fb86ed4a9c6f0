"""The seeded graph and read generator (experiments/synth.py)."""

import pytest

from vgaligner_tpu.experiments.synth import (
    path_sequences, sample_reads, synth_graph, to_hash_graph, write_fasta,
    write_gfa,
)
from vgaligner_tpu.graph import graph_from_gfa
from vgaligner_tpu.graph.handlegraph import handle_id
from vgaligner_tpu.io.fastx import read_seqs_from_file


@pytest.fixture(scope="module")
def drb1():
    return synth_graph(seed=1)


def test_deterministic_per_seed(drb1):
    assert synth_graph(seed=1) == drb1
    assert synth_graph(seed=2) != drb1


def test_drb1_shape(drb1):
    """About 4,792 nodes and 22.6 kb, as the DRB1-3123 graph."""
    n_nodes = len(drb1.segments)
    n_bp = sum(len(s) for _, s in drb1.segments)
    assert abs(n_nodes - 4792) < 0.05 * 4792
    assert abs(n_bp - 22_600) < 0.05 * 22_600
    assert [nid for nid, _ in drb1.segments] == list(range(1, n_nodes + 1))
    assert all(s and set(s) <= set("ACGT") for _, s in drb1.segments)


def test_paths_are_walks(drb1):
    """Every step follows an edge, ids rise (topological order), and
    every path runs from the first node to the last."""
    edges = set(drb1.links)
    last = len(drb1.segments)
    for _name, walk in drb1.paths:
        assert walk[0] == 1 and walk[-1] == last
        assert all((a, b) in edges for a, b in zip(walk, walk[1:]))
        assert all(a < b for a, b in zip(walk, walk[1:]))
    assert all(a < b for a, b in drb1.links)


def test_gfa_round_trip(drb1, tmp_path):
    gfa = tmp_path / "g.gfa"
    write_gfa(drb1, str(gfa))
    loaded, direct = graph_from_gfa(str(gfa)), to_hash_graph(drb1)
    assert loaded.n_nodes == direct.n_nodes == len(drb1.segments)
    assert path_sequences(loaded) == path_sequences(direct)
    for pid, (_name, walk) in zip(loaded.paths_iter(), drb1.paths):
        assert [handle_id(h) for h in loaded.get_path(pid).nodes] == walk


def test_reads_are_path_windows(drb1, tmp_path):
    graph = to_hash_graph(drb1)
    reads = sample_reads(graph, 50, 100, seed=77)
    assert reads == sample_reads(graph, 50, 100, seed=77)
    paths = path_sequences(graph)
    assert all(len(r) == 100 and any(r in p for p in paths) for r in reads)
    fa = tmp_path / "r.fa"
    write_fasta(str(fa), reads)
    assert [q.seq for q in read_seqs_from_file(str(fa))] == reads
    with pytest.raises(ValueError):
        sample_reads(graph, 1, 10**6)
