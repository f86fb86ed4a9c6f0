"""Streaming pipeline (models/stream.py): batched + software-pipelined
map/align must reproduce the unbatched path's records exactly."""

import numpy as np
import pytest

from vgaligner_tpu.graph import graph_from_gfa
from vgaligner_tpu.index import Index
from vgaligner_tpu.io.fastx import QuerySequence
from vgaligner_tpu.models.mapper import Mapper
from vgaligner_tpu.models.poa_aligner import PoaAligner, PoaEngine
from vgaligner_tpu.models.stream import stream_map_align

from conftest import DATA_DIR


def _reads(graph, n=17, read_len=24, seed=3):
    rng = np.random.default_rng(seed)
    seqs = []
    for pid in list(graph.paths_iter()):
        s = "".join(graph.sequence(h) for h in graph.get_path(pid).nodes)
        if len(s) >= read_len:
            seqs.append(s)
    out = []
    for i in range(n):
        s = seqs[int(rng.integers(len(seqs)))]
        start = int(rng.integers(0, len(s) - read_len + 1))
        out.append(QuerySequence.from_name_and_string(f"r{i}", s[start : start + read_len]))
    return out


@pytest.mark.parametrize("engine", [PoaEngine.ABPOA, PoaEngine.RSPOA])
def test_stream_matches_unbatched(engine):
    g = graph_from_gfa(f"{DATA_DIR}/test.gfa")
    index = Index.build(g, 11, 100, 100)
    queries = _reads(g)
    mapper = Mapper(index, chain_min_n_anchors=2)
    aligner = PoaAligner(index, engine)

    ref_chains = mapper.map_reads(queries)
    ref_chain_gaf = [r.to_string() for r in mapper.chains_to_gaf(ref_chains)]
    ref_aln_gaf = [
        a.to_string() for a in aligner.best_alignments_for_queries(ref_chains)
    ]

    got_chain_gaf, got_aln_gaf = [], []
    stream_map_align(
        mapper, queries, aligner, batch_size=5,
        on_chains=lambda ch: got_chain_gaf.extend(
            r.to_string() for r in mapper.chains_to_gaf(ch)
        ),
        on_alignments=lambda al: got_aln_gaf.extend(a.to_string() for a in al),
    )
    assert got_chain_gaf == ref_chain_gaf
    assert got_aln_gaf == ref_aln_gaf


def test_stream_chains_only():
    g = graph_from_gfa(f"{DATA_DIR}/test.gfa")
    index = Index.build(g, 11, 100, 100)
    queries = _reads(g, n=7)
    mapper = Mapper(index, chain_min_n_anchors=2)
    ref = [r.to_string() for r in mapper.chains_to_gaf(mapper.map_reads(queries))]
    got = []
    stream_map_align(
        mapper, queries, None, batch_size=3,
        on_chains=lambda ch: got.extend(r.to_string() for r in mapper.chains_to_gaf(ch)),
    )
    assert got == ref


def test_begin_finish_map_split_matches_map_reads():
    """map_reads(q) == finish_map(begin_map(q)) under the flag
    combinations the split must preserve (the pipelined map-only
    stream rides these halves)."""
    g = graph_from_gfa(f"{DATA_DIR}/test.gfa")
    index = Index.build(g, 11, 100, 100)
    queries = _reads(g, n=9)
    for kw in ({}, {"both_strands": True}, {"mapq": True},
               {"both_strands": True, "mapq": True}):
        mapper = Mapper(index, chain_min_n_anchors=2, **kw)
        ref = [r.to_string() for r in mapper.chains_to_gaf(mapper.map_reads(queries))]
        got = [
            r.to_string()
            for r in mapper.chains_to_gaf(mapper.finish_map(mapper.begin_map(queries)))
        ]
        assert got == ref, kw


def test_stream_chains_only_sync_mode(monkeypatch):
    monkeypatch.setenv("VGALIGNER_STREAM_ASYNC", "0")
    g = graph_from_gfa(f"{DATA_DIR}/test.gfa")
    index = Index.build(g, 11, 100, 100)
    queries = _reads(g, n=8)
    mapper = Mapper(index, chain_min_n_anchors=2)
    ref = [r.to_string() for r in mapper.chains_to_gaf(mapper.map_reads(queries))]
    got = []
    stream_map_align(
        mapper, queries, None, batch_size=3,
        on_chains=lambda ch: got.extend(r.to_string() for r in mapper.chains_to_gaf(ch)),
    )
    assert got == ref


def test_stream_chains_only_short_and_empty_batches():
    """Placeholder-only batches (reads shorter than k) flow through the
    pipelined map stream without stalling emission order."""
    g = graph_from_gfa(f"{DATA_DIR}/test.gfa")
    index = Index.build(g, 11, 100, 100)
    queries = _reads(g, n=4)
    # a batch of all-placeholder reads in the middle
    queries = queries[:2] + [
        QuerySequence.from_name_and_string("tiny0", "ACG"),
        QuerySequence.from_name_and_string("tiny1", "T"),
    ] + queries[2:]
    mapper = Mapper(index, chain_min_n_anchors=2)
    ref = [r.to_string() for r in mapper.chains_to_gaf(mapper.map_reads(queries))]
    got = []
    stream_map_align(
        mapper, queries, None, batch_size=2,
        on_chains=lambda ch: got.extend(r.to_string() for r in mapper.chains_to_gaf(ch)),
    )
    assert got == ref
