"""End-to-end mapping tests: test.gfa + reference read fixtures -> chains GAF.

Analog of test_map_no_alignment (/root/reference/src/map.rs:243-259) plus
GAF-format assertions; the produced GAF is also snapshotted so future
kernel changes cannot silently alter output (golden file committed under
tests/golden/).
"""

import os
import re

import pytest

from vgaligner_tpu.graph import graph_from_gfa
from vgaligner_tpu.index import Index
from vgaligner_tpu.io.fastx import read_seqs_from_file
from vgaligner_tpu.io.gaf import write_gaf_to_file
from vgaligner_tpu.models.mapper import Mapper

from conftest import DATA_DIR

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _map_fixture(reads_file, **kwargs):
    g = graph_from_gfa(f"{DATA_DIR}/test.gfa")
    index = Index.build(g, 11, 100, 100)
    mapper = Mapper(index, bandwidth=50, max_gap=1000, **kwargs)
    queries = read_seqs_from_file(f"{DATA_DIR}/{reads_file}")
    chains = mapper.map_reads(queries)
    return mapper.chains_to_gaf(chains), chains


def test_map_single_read(tmp_path):
    # map.rs:243-259 parameters: bandwidth 50, max_gap 1000, min anchors 3
    gaf, chains = _map_fixture("single-read-test.fa", chain_min_n_anchors=3)
    assert len(gaf) >= 1
    lines = [a.to_string() for a in gaf]
    for ln in lines:
        assert len(ln.rstrip("\n").split("\t")) == 13
    out = tmp_path / "out-chains.gaf"
    write_gaf_to_file(gaf, str(out))
    assert out.read_text() == "".join(lines)


def test_map_fwd_linearization_gaf_structure():
    gaf, chains = _map_fixture("single-read-test.fa", chain_min_n_anchors=2)
    # read AAAAACGTTAAATTTGGCATCGTAGCAAAAA has few 11-mer hits on test.gfa;
    # whatever rows exist must be placeholder or valid chain rows
    for a in gaf:
        s = a.to_string()
        cols = s.rstrip("\n").split("\t")
        if cols[2] == "*":  # placeholder
            assert cols[11] == "0" and cols[12] == "*"
        else:
            assert cols[4] == "+"
            assert re.fullmatch(r"(\([<>]\d+:\d+,[<>]\d+:\d+\),)+", cols[5])
            assert cols[12].startswith("ta:Z:chain,n_anchors: ")


def test_map_multiple_reads_golden():
    """Snapshot the multi-read chains GAF (self-golden regression; these
    reads have no 11-mer hits on test.gfa so both rows are placeholders —
    the real-chain coverage lives in the path-window goldens below)."""
    gaf, _ = _map_fixture("multiple-read-test.fa", chain_min_n_anchors=2)
    text = "".join(a.to_string() for a in gaf)
    golden_path = os.path.join(GOLDEN_DIR, "multiple-read-chains.gaf")
    with open(golden_path) as fh:
        assert fh.read() == text


def _map_path_window_fixture():
    g = graph_from_gfa(f"{DATA_DIR}/test.gfa")
    index = Index.build(g, 11, 100, 100)
    mapper = Mapper(index, bandwidth=50, max_gap=1000, chain_min_n_anchors=2)
    queries = read_seqs_from_file(os.path.join(GOLDEN_DIR, "path-window-reads.fa"))
    chains = mapper.map_reads(queries)
    return g, index, mapper, queries, chains


def test_map_path_window_chains_golden():
    """Real multi-anchor chain rows over test.gfa path windows, pinned
    byte-for-byte (golden committed; regenerate explicitly if semantics
    change, never silently)."""
    _, _, mapper, _, chains = _map_path_window_fixture()
    text = "".join(a.to_string() for a in mapper.chains_to_gaf(chains))
    with open(os.path.join(GOLDEN_DIR, "path-window-chains.gaf")) as fh:
        golden = fh.read()
    assert golden == text
    # the golden itself must contain real chain rows, not placeholders
    assert "ta:Z:chain,n_anchors: 40" in golden


def test_map_path_window_alignments_golden():
    """--also-align POA rows over the same reads, pinned byte-for-byte —
    once per range mode: "id" is the reference's contiguous-id range
    (align.rs:267-402 parity), "corridor" the topology-aware default
    (the two differ only in path-coordinate columns on this graph)."""
    from vgaligner_tpu.models.poa_aligner import PoaAligner, PoaEngine

    _, index, _, _, chains = _map_path_window_fixture()
    for mode, golden_name in (
        ("id", "path-window-alignments.gaf"),
        ("corridor", "path-window-alignments-corridor.gaf"),
    ):
        aligner = PoaAligner(index, PoaEngine.ABPOA, range_mode=mode)
        aligns = aligner.best_alignments_for_queries(chains, align_best_n=1)
        text = "".join(a.to_string() for a in aligns)
        with open(os.path.join(GOLDEN_DIR, golden_name)) as fh:
            assert fh.read() == text, f"range_mode={mode}"


def test_poa_full_reads_recover_gfa_paths():
    """External-truth pin: a read that IS path x/y/z of test.gfa must POA-
    align to exactly that path's node sequence (the P-lines of the GFA),
    with a perfect-match CIGAR."""
    from vgaligner_tpu.graph.handlegraph import handle_id
    from vgaligner_tpu.models.poa_aligner import PoaAligner, PoaEngine

    g, index, _, queries, chains = _map_path_window_fixture()
    aligner = PoaAligner(index, PoaEngine.ABPOA)
    aligns = aligner.best_alignments_for_queries(chains, align_best_n=1)
    by_name = {q.name: a for q, a in zip(queries, aligns)}
    for pid in g.paths_iter():
        p = g.get_path(pid)
        expected = "".join(f">{handle_id(h)}" for h in p.nodes)
        row = by_name[f"path-{p.name}-full"].to_string().split("\t")
        assert row[5] == expected
        # exact CIGAR: full-length match (row[1] is the query length column)
        assert f"cg:Z:{row[1]}M" in row[12]


def test_map_query_is_graph_path():
    """A read that IS a path of the graph must produce a non-placeholder
    chain covering (nearly) the whole read."""
    g = graph_from_gfa(f"{DATA_DIR}/test.gfa")
    index = Index.build(g, 11, 100, 100)
    mapper = Mapper(index, chain_min_n_anchors=3)
    path_x = g.get_path(0)
    seq = "".join(g.sequence(h) for h in path_x.nodes)
    from vgaligner_tpu.io.fastx import QuerySequence

    chains = mapper.map_reads([QuerySequence.from_name_and_string("x", seq)])[0]
    assert not chains[0].is_placeholder
    best = chains[0]
    assert best.anchors[0].qb == 0
    assert best.anchors[-1].qe == len(seq)


def test_long_reads_over_8kb():
    """Query positions are gathered device-side, so read length is
    unbounded (the old packed transfer capped reads at 8 kb)."""
    from vgaligner_tpu.io.fastx import QuerySequence

    g = graph_from_gfa(f"{DATA_DIR}/test.gfa")
    index = Index.build(g, 11, 100, 100)
    # synthesize a long read by tiling the linearization's first path-run
    base = index.seq_fwd[:40]
    long_read = (base * 300)[:10000]
    assert len(long_read) == 10000
    mapper = Mapper(index, chain_min_n_anchors=2)
    chains = mapper.map_reads(
        [QuerySequence.from_name_and_string("long", long_read)]
    )
    assert len(chains) == 1  # must not raise; chains may be placeholder


def test_device_chains_match_host_oracle_on_repeats():
    """Device mapper vs the scalar host pipeline on a graph whose
    linearization repeats a long substring: multi-position k-mers make
    the chaining DP's stable sort by target_end differ from anchor
    generation order, so this guards the sorted-position -> coordinate
    translation (regression: host coords once used generation order)."""
    import numpy as np

    from vgaligner_tpu.graph.handlegraph import HashGraph
    from vgaligner_tpu.io.fastx import QuerySequence
    from vgaligner_tpu.models.host_pipeline import map_read_host

    rep = "TTGACGTAGCTAGCTGATCGA"
    g = HashGraph()
    h1 = g.create_handle(rep, 1)
    h2 = g.create_handle("CCC", 2)
    h3 = g.create_handle(rep, 3)
    h4 = g.create_handle("GGGAT", 4)
    h5 = g.create_handle(rep, 5)
    g.create_edge(h1, h2)
    g.create_edge(h2, h3)
    g.create_edge(h3, h4)
    g.create_edge(h4, h5)
    index = Index.build(g, 11, 100, 100)

    path_seq = rep + "CCC" + rep + "GGGAT" + rep
    reads = [path_seq[i : i + 40] for i in range(0, len(path_seq) - 40, 5)]
    reads.append(path_seq)

    mapper = Mapper(index, chain_min_n_anchors=3)
    queries = [
        QuerySequence.from_name_and_string(f"r{i}", s) for i, s in enumerate(reads)
    ]
    per_read = mapper.map_reads(queries)

    for s, chains in zip(reads, per_read):
        host_chains, _, _ = map_read_host(index, s)
        # host anchors in generation order for id -> coords
        gen = []
        k = index.kmer_length
        for i in range(len(s) - k + 1):
            for so, sp, eo, ep in index.find_positions_for_query_kmer(s[i : i + k]):
                if so == 0 and eo == 0:
                    gen.append((i, sp, ep))
        dev = [c for c in chains if not c.is_placeholder]
        assert len(dev) == len(host_chains), (s, len(dev), len(host_chains))
        for dc, hc in zip(dev, host_chains):
            exp = np.asarray([gen[a] for a in hc], dtype=np.int64)
            np.testing.assert_array_equal(dc.aqb, exp[:, 0])
            np.testing.assert_array_equal(dc.atb, exp[:, 1])
            np.testing.assert_array_equal(dc.ate, exp[:, 2])


def test_packed_channel_int32_path_matches_uint16():
    """The mapping result channel is uint16 for a_max <= 16384 and int32
    above (models/mapper.py _device_map); both layouts must decode to
    identical chains.  Forces the int32 path by shrinking the uint16
    threshold via a low max_anchors_cap... not possible statically, so
    instead call _device_map at both a_max values on the same batch and
    compare decoded pred/is_start."""
    import jax.numpy as jnp
    import numpy as np

    from vgaligner_tpu.io.fastx import QuerySequence
    from vgaligner_tpu.ops.chain import make_gap_cost_table
    from vgaligner_tpu.ops.encode import encode_reads_host

    g = graph_from_gfa(f"{DATA_DIR}/test.gfa")
    index = Index.build(g, 11, 100, 100)
    path_x = g.get_path(0)
    seq = "".join(g.sequence(h) for h in path_x.nodes)
    codes, lens = encode_reads_host([seq], max(len(seq), 11))
    dindex = index.device()
    gap = jnp.asarray(make_gap_cost_table(11, 1000))

    out = {}
    for a_max in (256, 32768):
        packed, counts = Mapper._device_map(
            jnp.asarray(codes), jnp.asarray(lens), dindex, gap,
            11, a_max, 50, "exact",
        )
        packed = np.asarray(packed)
        shift = 15 if packed.dtype == np.uint16 else 17
        arr = packed.astype(np.int32)
        n = int(np.asarray(counts)[0, 0])
        out[a_max] = (
            (arr[0, :n] & ((1 << shift) - 1)) - 1,
            (arr[0, :n] >> shift) & 1,
            n,
        )
    assert out[256][2] == out[32768][2]
    np.testing.assert_array_equal(out[256][0], out[32768][0])
    np.testing.assert_array_equal(out[256][1], out[32768][1])


def test_dense_lut_matches_searchsorted(monkeypatch):
    """The direct-address LUT lookup must produce chains identical to
    the binary-search path (ops/lookup.py)."""
    import numpy as np

    from vgaligner_tpu.io.fastx import QuerySequence

    g = graph_from_gfa(f"{DATA_DIR}/test.gfa")
    index = Index.build(g, 11, 100, 100)
    seq = "".join(g.sequence(h) for h in g.get_path(0).nodes)
    queries = [
        QuerySequence.from_name_and_string(f"r{i}", seq[i : i + 24])
        for i in range(0, len(seq) - 24, 5)
    ]

    def run():
        mapper = Mapper(index, chain_min_n_anchors=2)
        return mapper.map_reads(queries)

    monkeypatch.setenv("VGALIGNER_DENSE_LUT_MAX", "0")
    ref = run()
    monkeypatch.setenv("VGALIGNER_DENSE_LUT_MAX", str(1 << 24))
    got = run()
    assert got[0][0].query.name == ref[0][0].query.name
    for rc, gc in zip(ref, got):
        assert len(rc) == len(gc)
        for a, b in zip(rc, gc):
            assert a.is_placeholder == b.is_placeholder
            if not a.is_placeholder:
                np.testing.assert_array_equal(a.aqb, b.aqb)
                np.testing.assert_array_equal(a.atb, b.atb)
                np.testing.assert_array_equal(a.ate, b.ate)


def test_map_wire_dispatch_matches_unpacked():
    """The single-buffer map dispatch (_device_map_wire) must produce
    bit-identical packed channels to _device_map — locks the
    codes+lens byte layout."""
    import jax.numpy as jnp
    import numpy as np

    from vgaligner_tpu.ops.encode import encode_reads_host
    from vgaligner_tpu.ops.poa_device import wire_bitcast_supported

    if not wire_bitcast_supported():
        pytest.skip("wire bitcast unsupported on this backend; fallback path covers it")
    g = graph_from_gfa(f"{DATA_DIR}/test.gfa")
    index = Index.build(g, 11, 100, 100)
    mapper = Mapper(index, chain_min_n_anchors=2)
    seq = "".join(g.sequence(h) for h in g.get_path(0).nodes)
    seqs = [seq[i : i + 24] for i in range(0, len(seq) - 24, 3)]
    codes, lens = encode_reads_host(seqs, 32)
    B, L = codes.shape
    k, a_max = index.kmer_length, 256
    ref = Mapper._device_map(
        jnp.asarray(codes), jnp.asarray(lens), mapper.dindex,
        mapper._gap_table_dev, k, a_max, mapper.bandwidth, mapper.precision,
    )
    from vgaligner_tpu.ops.poa_device import pack_wire

    wire = pack_wire(((codes, np.int8), (lens, np.int32)))
    flat, none_counts = Mapper._device_map_wire(
        jnp.asarray(wire), B, L, mapper.dindex, mapper._gap_table_dev,
        k, a_max, mapper.bandwidth, mapper.precision,
    )
    # the wire variant fuses (u8 plane, counts) into one buffer
    assert none_counts is None
    flat = np.asarray(flat)
    plane = flat[: B * a_max].reshape(B, a_max)
    counts = flat[B * a_max :].view(np.int32).reshape(B, 2)
    np.testing.assert_array_equal(np.asarray(ref[0]), plane)
    np.testing.assert_array_equal(np.asarray(ref[1]), counts)


def test_fused_bucket_ladder_matches_unfused(monkeypatch):
    """The fused multi-bucket map (one upload/executable/fetch, a_max
    ladder {64,128,256,...}) must produce chains identical to the
    per-bucket dispatch path."""
    import numpy as np

    from vgaligner_tpu.graph import graph_from_gfa
    from vgaligner_tpu.index import Index
    from vgaligner_tpu.io.fastx import QuerySequence
    from vgaligner_tpu.models import mapper as mapper_mod
    from vgaligner_tpu.models.mapper import Mapper

    graph = graph_from_gfa(os.path.join(DATA_DIR, "test.gfa"))
    index = Index.build(graph, 11, 100, 100)
    rng = np.random.default_rng(17)
    fwd = index.seq_fwd
    reads = []
    for i in range(40):
        ln = int(rng.integers(15, min(60, len(fwd) - 1)))
        start = int(rng.integers(0, max(len(fwd) - ln, 1)))
        reads.append(fwd[start : start + ln])
    # a repetitive read to push the anchor count into a bigger bucket
    reads.append(("A" * 30))
    queries = [
        QuerySequence.from_name_and_string(f"q{i}", s)
        for i, s in enumerate(reads)
    ]

    mapper = Mapper(index, chain_min_n_anchors=3)
    got = mapper.map_reads(queries)

    # force the per-bucket path by pretending bitcast is unsupported
    monkeypatch.setattr(mapper_mod, "_fused_map_fn", None)
    from vgaligner_tpu.ops import poa_device as PD

    monkeypatch.setitem(PD._WIRE_BITCAST_OK, "cpu", False)
    mapper2 = Mapper(index, chain_min_n_anchors=3)
    want = mapper2.map_reads(queries)

    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert len(a) == len(b)
        for ca, cb in zip(a, b):
            assert ca.is_placeholder == cb.is_placeholder
            if not ca.is_placeholder:
                np.testing.assert_array_equal(ca.aqb, cb.aqb)
                np.testing.assert_array_equal(ca.atb, cb.atb)
                np.testing.assert_array_equal(ca.ate, cb.ate)
