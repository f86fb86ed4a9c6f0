"""Long reads (>127 bp) through the full map + --also-align pipeline.

The reference maps reads of any length (abPOA's banded DP keeps long
base-level alignments tractable, align.rs:190-202).  These tests drive
1,000 bp reads end to end on the seeded DRB1-3123-shaped graph
(experiments/synth.py): mapping (~990 k-mers/read), chaining, corridor
extraction, and the global POA at W = 1024, checking the device-path
result against the host oracle and the read's source window.
"""

import numpy as np
import pytest


@pytest.fixture(scope="module")
def drb1_index():
    from vgaligner_tpu.experiments.synth import synth_graph, to_hash_graph
    from vgaligner_tpu.index import Index

    g = to_hash_graph(synth_graph(seed=1))
    return g, Index.build(g, 11, 100, 100)


def _path_reads(graph, n, read_len, seed=101):
    rng = np.random.default_rng(seed)
    seqs = []
    for pid in graph.paths_iter():
        s = "".join(graph.sequence(h) for h in graph.get_path(pid).nodes)
        if len(s) >= read_len:
            seqs.append(s)
    reads = []
    for _ in range(n):
        s = seqs[int(rng.integers(len(seqs)))]
        start = int(rng.integers(0, len(s) - read_len + 1))
        reads.append((s[start : start + read_len], start))
    return reads


def test_long_reads_map_and_align(drb1_index):
    from vgaligner_tpu.io.fastx import QuerySequence
    from vgaligner_tpu.models.mapper import Mapper
    from vgaligner_tpu.models.poa_aligner import PoaAligner, PoaEngine

    graph, index = drb1_index
    reads = _path_reads(graph, 4, 1000)
    queries = [
        QuerySequence.from_name_and_string(f"L{i}", s)
        for i, (s, _start) in enumerate(reads)
    ]
    mapper = Mapper(index, chain_min_n_anchors=3)
    chains = mapper.map_reads(queries)
    for per_read in chains:
        assert not per_read[0].is_placeholder
        c = per_read[0]
        # an exact 1 kb read should chain essentially end to end
        assert int(c.aqb[-1]) + c.k - int(c.aqb[0]) > 900

    import re

    aligner = PoaAligner(index, PoaEngine.ABPOA)
    alns = aligner.best_alignments_for_queries(chains)
    for (read, _start), aln in zip(reads, alns):
        assert aln.path_matching not in (None, "*")
        # exact path windows align full-length, >=99% matches (global
        # mode may add flank deletions against corridor slack bases and
        # may route a flank base through an equal-scoring detour)
        cigar = aln.notes.split("cg:Z:")[1]
        n_m = sum(int(n) for n, op in re.findall(r"(\d+)([MIDX=])", cigar)
                  if op == "M")
        assert n_m >= 0.99 * len(read)
        assert aln.alignment_block_length == len(read)


def test_long_read_device_path_matches_host_oracle(drb1_index):
    """The batched device POA at W=1024 must equal the scalar host
    oracle on the same chain-implied subgraph (score, cigar, path)."""
    from vgaligner_tpu.io.fastx import QuerySequence
    from vgaligner_tpu.models.mapper import Mapper
    from vgaligner_tpu.models.poa_aligner import (
        PoaAligner,
        PoaEngine,
        find_nodes_edges,
    )
    from vgaligner_tpu.ops.poa import align_global_host

    graph, index = drb1_index
    # one mutated read (SNPs + a small deletion) so the DP is nontrivial
    (seq, _start) = _path_reads(graph, 1, 1000, seed=7)[0]
    mutated = list(seq)
    rng = np.random.default_rng(3)
    for pos in rng.integers(10, 990, 8):
        mutated[int(pos)] = "ACGT"[int(rng.integers(4))]
    mutated = "".join(mutated[:500] + mutated[503:])  # 3 bp deletion
    q = QuerySequence.from_name_and_string("mut", mutated)

    mapper = Mapper(index, chain_min_n_anchors=3)
    chains = mapper.map_reads([q])[0]
    assert not chains[0].is_placeholder

    aligner = PoaAligner(index, PoaEngine.ABPOA)
    aln_dev = aligner.best_alignments_for_queries([chains])[0]

    rng_range = aligner._range_for_chain(chains[0])
    nodes, edges = find_nodes_edges(index, rng_range)
    res = align_global_host(nodes, edges, mutated)
    from vgaligner_tpu.models.poa_aligner import _rebase_trimmed_offsets
    from vgaligner_tpu.io.gaf import GAFAlignment

    _rebase_trimmed_offsets(res, rng_range)
    aln_host = GAFAlignment.from_abpoa_result(res, chains[0], rng_range.handles)
    assert aln_dev.to_string() == aln_host.to_string()


def test_longread_chunks_fit_the_gpu_kernel(drb1_index):
    """Every chunk the 1 kb align pipeline prepares has a shape the GPU
    POA kernel takes (ops/poa_cuda.block_geometry): W = L+1 a multiple
    of 32 within the block's column budget, fan-in within its slots."""
    from vgaligner_tpu.io.fastx import QuerySequence
    from vgaligner_tpu.models.mapper import Mapper
    from vgaligner_tpu.models.poa_aligner import PoaAligner, PoaEngine
    from vgaligner_tpu.ops import poa_device as PD
    from vgaligner_tpu.ops.poa_cuda import block_geometry

    graph, index = drb1_index
    queries = [
        QuerySequence.from_name_and_string(f"l{i}", s)
        for i, (s, _start) in enumerate(_path_reads(graph, 16, 1000, seed=79))
    ]
    chains = Mapper(index, chain_min_n_anchors=3, precision="fast").map_reads(
        queries)
    aligner = PoaAligner(index, PoaEngine.ABPOA)

    captured = []
    orig = PD.kernel_launch_wires

    def capture(prepared):
        captured.extend(prepared)
        return orig(prepared)

    PD.kernel_launch_wires = capture
    try:
        aligner.best_alignments_for_queries(chains)
    finally:
        PD.kernel_launch_wires = orig

    assert captured
    for _wire, version, dims, _rest in captured:
        assert version == "v4"
        b_pad, V, P, l_pad = dims[:4]
        threads, cols = block_geometry(l_pad + 1)
        assert threads * cols == l_pad + 1 and 1 <= P <= PD.P_MAX
    assert max(d[3] for _w, _v, d, _r in captured) + 1 == 1024
