"""One-device vs mesh equivalence of the multi-device paths.

Runs a read set through each path a user reaches with several devices —
the data mesh (`map -t 0`), the offset-sharded index (`--shard-index`),
and the per-device POA dispatch under `--also-align` — and asserts that
each GAF equals the one-device run of the same reads byte for byte.
The tests call it on virtual CPU devices and chip_smoke.py
(`--four-cards`) on real GPUs.
"""

from __future__ import annotations

from typing import Sequence


def check_mesh_matches_single(index, reads, devices: Sequence) -> str:
    """Raises AssertionError on the first divergence; returns a summary.

    reads: QuerySequence list (reverse-strand reads map only through
    the both-strands extension, which is on here).
    """
    from ..models.mapper import Mapper
    from ..models.poa_aligner import PoaAligner, PoaEngine
    from .distributed import merge_gaf_shards
    from .mesh import make_mesh

    mesh = make_mesh(devices=list(devices))
    # max_anchors_cap=512 sends the busiest reads through the exact
    # unbounded host-overflow path alongside the device buckets
    mk = dict(chain_min_n_anchors=3, both_strands=True, max_anchors_cap=512)
    single = Mapper(index, **mk)
    chains_1 = single.map_reads(reads)
    gaf_1 = [a.to_string() for a in single.chains_to_gaf(chains_1)]

    mapper = Mapper(index, mesh=mesh, **mk)
    chains_n = mapper.map_reads(reads)
    gaf_n = [a.to_string() for a in mapper.chains_to_gaf(chains_n)]
    assert gaf_n == gaf_1, "mesh chains diverge from single-device"

    # offset-sharded index: position table sharded over the mesh,
    # reassembled with all_gather + psum_scatter at the batch boundary
    sharded = Mapper(index, mesh=mesh, shard_index=True, **mk)
    gaf_s = [a.to_string()
             for a in sharded.chains_to_gaf(sharded.map_reads(reads))]
    assert gaf_s == gaf_1, "offset-sharded chains diverge"

    # base-level POA over the mesh (per-device dispatch)
    aligner_1 = PoaAligner(index, PoaEngine.ABPOA)
    aln_1 = [a.to_string()
             for a in aligner_1.best_alignments_for_queries(chains_1)]
    aligner_n = PoaAligner(index, PoaEngine.ABPOA, mesh=mesh)
    alns_n = aligner_n.best_alignments_for_queries(chains_n)
    aln_n = [a.to_string() for a in alns_n]
    assert aln_n == aln_1, "mesh POA GAF diverges from single-device"

    # deterministic GAF merge path (single-process: identity ordering)
    merged = merge_gaf_shards(alns_n)
    assert merged is not None and len(merged) == len(reads)

    n_aligned = sum(1 for a in aln_n if a.split("\t")[2] != "*")
    n_rev = sum(1 for a in aln_n if a.split("\t")[4] == "-")
    return (
        f"{len(mesh.devices.flat)} devices, {len(reads)} reads "
        f"({n_rev} reverse-strand alignments, overflow cap 512): "
        f"{len(gaf_1)} chain rows, {n_aligned} base-level alignments; "
        f"mesh, offset-sharded index and mesh POA GAFs == one device "
        f"byte for byte"
    )


def sample_mixed_strand_reads(index, n: int):
    """n 100 bp windows of the forward linearization (seed 77); every
    4th read is reverse-complemented (it maps only via --both-strands)."""
    import numpy as np

    from ..io.fastx import QuerySequence
    from ..utils.dna import reverse_complement

    rng = np.random.default_rng(77)
    reads = []
    for i in range(n):
        s = int(rng.integers(0, max(index.seq_length - 100, 1)))
        w = index.seq_fwd[s : s + 100]
        if i % 4 == 3:
            w = reverse_complement(w)
        reads.append(QuerySequence.from_name_and_string(f"r{i}", w))
    return reads
