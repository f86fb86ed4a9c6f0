"""Seeded variation-graph and read generator.

Builds an HLA-zoo-shaped graph without any outside data: a random
backbone cut by variant sites, each site an SNV bubble (ref and alt
base), an insertion (an alt node beside a bare edge) or a deletion (a
ref node beside a bare edge), plus haplotype paths that each pick one
allele per site.  The default size follows the DRB1-3123 graph of the
reference's HLA-zoo protocol: about 4,792 nodes and 22.6 kb of
sequence.  Node ids are 1-based and topologically ordered, as the
graphs `vg construct` writes.

Reads are error-free, forward-strand windows cut from the haplotype
paths (the reference's `vg sim` protocol with seed 77 at 100 bp).

    python -m vgaligner_tpu.experiments.synth --out-prefix drb1 --seed 1
    # writes drb1.gfa and drb1-reads.fa
"""

from __future__ import annotations

import argparse
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np

_BASES = np.array(list("ACGT"))

# DRB1-3123 shape (bench.py's reference workload): 4,792 nodes, 22.6 kb
DRB1_SITES = 1960
DRB1_BACKBONE = 20_430
N_PATHS = 12
ALT_FREQ = 0.3


class SynthGraph(NamedTuple):
    segments: List[Tuple[int, str]]  # (node id, sequence), id order
    links: List[Tuple[int, int]]  # forward-forward edges, sorted
    paths: List[Tuple[str, List[int]]]  # (name, forward node ids)


def _random_seq(rng: np.random.Generator, n: int) -> str:
    return "".join(_BASES[rng.integers(0, 4, n)])


def synth_graph(seed: int, n_sites: int = DRB1_SITES,
                backbone_len: int = DRB1_BACKBONE) -> SynthGraph:
    """A bubble-chain graph with up to n_sites variant sites (sites
    too close to the previous one are dropped) on a random backbone of
    backbone_len bases, and N_PATHS haplotype paths.

    Sites are 70% SNVs, 15% insertions (1-6 bp) and 15% deletions
    (1-6 bp); every haplotype takes each site's alt allele with
    probability ALT_FREQ.  Path 0 is all-ref.
    """
    rng = np.random.default_rng(seed)
    backbone = _random_seq(rng, backbone_len)
    cut = np.sort(rng.choice(np.arange(1, backbone_len), n_sites,
                             replace=False))
    kinds = rng.choice(3, n_sites, p=[0.7, 0.15, 0.15])  # snv / ins / del

    # keep a site only if a flank base separates it from the previous
    # one and from the backbone's end, so every bubble has two ends
    kept = []  # (cut, ref allele, alt allele, end of the ref span)
    end = 0
    for c, kind in zip(cut.tolist(), kinds.tolist()):
        if kind == 0:
            ref_base = backbone[c]
            alt = "ACGT"["ACGT".index(ref_base) - int(rng.integers(1, 4))]
            site = (c, ref_base, alt, c + 1)
        elif kind == 1:
            site = (c, None, _random_seq(rng, int(rng.integers(1, 7))), c)
        else:
            dl = int(rng.integers(1, 7))
            site = (c, backbone[c : c + dl], None, c + dl)
        if c > end and site[3] < backbone_len:
            kept.append(site)
            end = site[3]

    segments: List[Tuple[int, str]] = []
    links = set()

    def add(seq: str) -> int:
        segments.append((len(segments) + 1, seq))
        return len(segments)

    flank_ids = [add(backbone[: kept[0][0]])]
    sites: List[Tuple[int, int]] = []  # (ref node or None, alt node or None)
    for i, (c, ref_seq, alt_seq, end) in enumerate(kept):
        ref = add(ref_seq) if ref_seq is not None else None
        alt = add(alt_seq) if alt_seq is not None else None
        nxt = kept[i + 1][0] if i + 1 < len(kept) else backbone_len
        before = flank_ids[-1]
        flank = add(backbone[end:nxt])
        for allele in (ref, alt):
            if allele is None:
                links.add((before, flank))
            else:
                links.add((before, allele))
                links.add((allele, flank))
        sites.append((ref, alt))
        flank_ids.append(flank)

    paths: List[Tuple[str, List[int]]] = []
    for p in range(N_PATHS):
        take_alt = (rng.random(len(sites)) < ALT_FREQ) if p else np.zeros(
            len(sites), bool)
        walk = [flank_ids[0]]
        for (ref, alt), alt_on, flank in zip(sites, take_alt, flank_ids[1:]):
            allele = alt if alt_on else ref
            if allele is not None:
                walk.append(allele)
            walk.append(flank)
        paths.append((f"hap{p}", walk))
    return SynthGraph(segments, sorted(links), paths)


def write_gfa(graph: SynthGraph, path: str) -> None:
    """GFA1: header, S lines in id order, P lines, then L lines."""
    with open(path, "w") as fh:
        fh.write("H\tVN:Z:1.0\n")
        for nid, seq in graph.segments:
            fh.write(f"S\t{nid}\t{seq}\n")
        for name, walk in graph.paths:
            steps = ",".join(f"{v}+" for v in walk)
            fh.write(f"P\t{name}\t{steps}\t*\n")
        for a, b in graph.links:
            fh.write(f"L\t{a}\t+\t{b}\t+\t0M\n")


def to_hash_graph(graph: SynthGraph):
    """The HashGraph that graph_from_gfa would load from write_gfa's
    file."""
    from ..graph.gfa import graph_from_records

    return graph_from_records(
        graph.segments,
        [(a, False, b, False) for a, b in graph.links],
        [(name, [(v, False) for v in walk]) for name, walk in graph.paths],
    )


def path_sequences(graph) -> List[str]:
    """Spelled sequence of every embedded path of a HashGraph."""
    return [
        "".join(graph.sequence(h) for h in graph.get_path(pid).nodes)
        for pid in graph.paths_iter()
    ]


def sample_reads(graph, n: int, read_len: int, seed: int = 77) -> List[str]:
    """n error-free forward windows of read_len bases, each cut from a
    uniformly chosen embedded path at a uniform start (vg sim analog)."""
    rng = np.random.default_rng(seed)
    seqs = [s for s in path_sequences(graph) if len(s) >= read_len]
    if not seqs:
        raise ValueError(f"no embedded path is {read_len} bp long")
    reads = []
    for _ in range(n):
        seq = seqs[int(rng.integers(len(seqs)))]
        start = int(rng.integers(0, len(seq) - read_len + 1))
        reads.append(seq[start : start + read_len])
    return reads


def write_fasta(path: str, reads: Sequence[str], prefix: str = "r") -> None:
    with open(path, "w") as fh:
        for i, s in enumerate(reads):
            fh.write(f">{prefix}{i}\n{s}\n")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-prefix", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--n-reads", type=int, default=4096)
    ap.add_argument("--read-len", type=int, default=100)
    ap.add_argument("--read-seed", type=int, default=77)
    args = ap.parse_args(argv)

    from ..graph import graph_from_gfa

    gfa = args.out_prefix + ".gfa"
    write_gfa(synth_graph(args.seed), gfa)
    reads = sample_reads(graph_from_gfa(gfa), args.n_reads, args.read_len,
                         args.read_seed)
    write_fasta(args.out_prefix + "-reads.fa", reads)


if __name__ == "__main__":
    main()
