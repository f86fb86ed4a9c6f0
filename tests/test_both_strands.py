"""Both-strands mapping extension (--both-strands).

The reference's production path is forward-only (map.rs:62): a
reverse-strand read gets no anchors and emits the placeholder row.
The extension maps each read's reverse complement too and keeps the
better-scoring strand, reporting reverse hits on the ORIGINAL read
(strand '-', mirrored coordinates).  These tests pin:

  * parity: default off — a revcomp read stays unmapped;
  * a forward read behaves identically with the flag on (tie -> fwd);
  * a revcomp read maps with strand '-' and its GAF path is the
    forward read's path reversed with orientations flipped;
  * the POA (--also-align) row is flipped consistently;
  * chain_dp_score recomputes curr_max exactly (vs the host oracle).
"""

import re

import pytest

from vgaligner_tpu.graph import graph_from_gfa
from vgaligner_tpu.index import Index
from vgaligner_tpu.io.fastx import QuerySequence
from vgaligner_tpu.models.mapper import Mapper, chain_dp_score
from vgaligner_tpu.utils.dna import reverse_complement

from conftest import DATA_DIR

K = 11


@pytest.fixture(scope="module")
def index():
    g = graph_from_gfa(f"{DATA_DIR}/test.gfa")
    return Index.build(g, K, 100, 100)


@pytest.fixture(scope="module")
def fwd_read(index):
    # a linearization window long enough to chain (>= 3 anchors)
    return index.seq_fwd[4:44]


def test_reverse_read_unmapped_without_flag(index, fwd_read):
    q = QuerySequence.from_name_and_string("r", reverse_complement(fwd_read))
    chains = Mapper(index).map_reads([q])[0]
    assert chains[0].is_placeholder  # map.rs:62 forward-only parity


def test_forward_read_identical_with_flag(index, fwd_read):
    q = QuerySequence.from_name_and_string("r", fwd_read)
    base = Mapper(index).map_reads([q])[0]
    both = Mapper(index, both_strands=True).map_reads([q])[0]
    assert not base[0].is_placeholder
    assert len(base) == len(both)
    for a, b in zip(base, both):
        assert b.strand == "+"
        assert (a.aqb == b.aqb).all()
        assert (a.atb == b.atb).all()
        assert (a.ate == b.ate).all()


def test_reverse_read_maps_with_flag(index, fwd_read):
    rc = reverse_complement(fwd_read)
    qf = QuerySequence.from_name_and_string("rf", fwd_read)
    qr = QuerySequence.from_name_and_string("rr", rc)
    mapper = Mapper(index, both_strands=True)
    cf = mapper.map_reads([qf])[0]
    cr = mapper.map_reads([qr])[0]
    assert not cr[0].is_placeholder
    assert cr[0].strand == "-"
    # the reverse chain is the forward chain computed on the revcomp
    assert (cf[0].atb == cr[0].atb).all()
    assert (cf[0].aqb == cr[0].aqb).all()

    gf = mapper.chains_to_gaf([cf])[0]
    gr = mapper.chains_to_gaf([cr])[0]
    assert gf.strand == "+" and gr.strand == "-"
    # query interval flipped back to the original read's coordinates
    L = len(fwd_read)
    assert (gr.query_start, gr.query_end) == (
        L - gf.query_end, L - gf.query_start
    )
    # path: same node ids, signs flipped, order reversed
    node_re = re.compile(r"(>|<)(\d+)")
    f_ids = [(s, n) for s, n in node_re.findall(gf.path_matching)]
    r_ids = [(s, n) for s, n in node_re.findall(gr.path_matching)]
    flip = {">": "<", "<": ">"}
    assert r_ids == [(flip[s], n) for s, n in reversed(f_ids)]


def test_reverse_offsets_mirrored(index, fwd_read):
    """Each reverse tuple's offset is node_len - 1 - forward offset."""
    rc = reverse_complement(fwd_read)
    mapper = Mapper(index, both_strands=True)
    cf = mapper.map_reads([QuerySequence.from_name_and_string("a", fwd_read)])[0]
    cr = mapper.map_reads([QuerySequence.from_name_and_string("a", rc)])[0]
    gf = mapper.chains_to_gaf([cf])[0]
    gr = mapper.chains_to_gaf([cr])[0]
    tup_re = re.compile(r"\((>|<)(\d+):(\d+),(>|<)(\d+):(\d+)\)")
    f_tups = tup_re.findall(gf.path_matching)
    r_tups = tup_re.findall(gr.path_matching)
    assert len(f_tups) == len(r_tups)
    starts = index.node_starts
    for ft, rt in zip(f_tups, reversed(r_tups)):
        # reverse tuple is (end, start) of the mirrored anchor
        fs_sign, fs_id, fs_off, fe_sign, fe_id, fe_off = ft
        rs_sign, rs_id, rs_off, re_sign, re_id, re_off = rt
        assert (rs_id, re_id) == (fe_id, fs_id)
        for nid, f_off, r_off in (
            (int(fe_id), int(fe_off), int(rs_off)),
            (int(fs_id), int(fs_off), int(re_off)),
        ):
            nlen = int(starts[nid] - starts[nid - 1])
            assert r_off == nlen - 1 - f_off


def test_poa_row_flipped(index, fwd_read):
    from vgaligner_tpu.models.poa_aligner import PoaAligner, PoaEngine

    rc = reverse_complement(fwd_read)
    mapper = Mapper(index, both_strands=True)
    aligner = PoaAligner(index, PoaEngine.ABPOA)
    cf = mapper.map_reads([QuerySequence.from_name_and_string("a", fwd_read)])
    cr = mapper.map_reads([QuerySequence.from_name_and_string("a", rc)])
    af = aligner.best_alignments_for_queries(cf)[0]
    ar = aligner.best_alignments_for_queries(cr)[0]
    assert af.strand == "+" and ar.strand == "-"
    node_re = re.compile(r"(>|<)(\d+)")
    flip = {">": "<", "<": ">"}
    f_steps = node_re.findall(af.path_matching)
    r_steps = node_re.findall(ar.path_matching)
    assert r_steps == [(flip[s], n) for s, n in reversed(f_steps)]
    assert ar.path_length == af.path_length
    assert (ar.path_start, ar.path_end) == (
        af.path_length - af.path_end, af.path_length - af.path_start
    )
    # cigar runs reversed
    runs = re.findall(r"\d+[A-Z=]", af.notes.split("cg:Z:")[1])
    r_runs = re.findall(r"\d+[A-Z=]", ar.notes.split("cg:Z:")[1])
    assert r_runs == runs[::-1]


def test_chain_dp_score_matches_oracle(index, fwd_read):
    from vgaligner_tpu.models.host_pipeline import map_read_host

    q = QuerySequence.from_name_and_string("r", fwd_read)
    chains = Mapper(index).map_reads([q])[0]
    _, curr_max, _ = map_read_host(index, fwd_read)
    assert chain_dp_score(chains[0], 1000) == curr_max


def test_mixed_batch_selection(index, fwd_read):
    """One batch containing forward, reverse, and unmappable reads."""
    rc = reverse_complement(fwd_read)
    qs = [
        QuerySequence.from_name_and_string("f", fwd_read),
        QuerySequence.from_name_and_string("r", rc),
        QuerySequence.from_name_and_string("n", "N" * len(fwd_read)),
    ]
    out = Mapper(index, both_strands=True).map_reads(qs)
    assert out[0][0].strand == "+" and not out[0][0].is_placeholder
    assert out[1][0].strand == "-" and not out[1][0].is_placeholder
    assert out[2][0].is_placeholder
