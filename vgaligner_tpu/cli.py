"""Command-line interface: `vgaligner index` / `vgaligner map`.

Behavioral reference: rs-vgaligner src/main.rs:30-39 +
subcommands/cli.yml (flag surface) + subcommands/index_main.rs /
map_main.rs (defaults and dispatch).  Flag names, shorthands and
defaults mirror cli.yml:5-175; reference quirks preserved:

  * out-prefix defaults to the input path with its extension stripped
    (index_main.rs:17-20, map_main.rs:21-30);
  * `--chain-overlap-max` is parsed but never read (cli.yml:110-116 has
    no consumer in map_main.rs) — kept as an accepted no-op;
  * bandwidth=50, secondary_chain_threshold=0.5 and max_mapq=60.0 are
    hard-coded at the map call site (map_main.rs:100-117); the latter
    two feed the mapq logic that the reference ships commented out
    (chain.rs:560-642) — inert by default here too, enabled by the
    opt-in --mapq extension (models/mapper.py assign_mapq);
  * --also-align requires -G/--graph (map.rs:155-159) and always
    exports per-read subgraph GFAs (map.rs:165 passes true).

`-t/--threads` is dead in the reference (rayon compiled out); here it
caps the number of mesh devices used for data-parallel mapping (0 = all).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

log = logging.getLogger("vgaligner")


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vgaligner", description="Aligns reads to a Variation Graph"
    )
    sub = p.add_subparsers(dest="command")

    ip = sub.add_parser("index", help="creates the index")
    ip.add_argument("-i", "--input", required=True, metavar="FILE")
    ip.add_argument("-o", "--output", dest="out_prefix", metavar="STRING")
    ip.add_argument("-k", "--kmer-length", required=True, type=int, metavar="INTEGER")
    ip.add_argument("-e", "--max-furcations", type=int, default=100, metavar="INTEGER")
    ip.add_argument("-m", "--max-degree", type=int, default=100, metavar="INTEGER")
    ip.add_argument("-r", "--sampling-rate", type=int, default=None, metavar="INTEGER")
    ip.add_argument("-g", "--generate-mappings", action="store_true")
    ip.add_argument("-p", "--mappings-path", metavar="FILE")
    ip.add_argument("-t", "--threads", type=int, default=0, metavar="INTEGER")
    ip.add_argument("--n-policy", choices=["drop-kmer", "drop-handle"],
                    default="drop-handle",
                    help="N handling in DFS k-mer enumeration: drop-handle "
                         "(default, reference parity) drops every k-mer of "
                         "an N-containing handle (kmer.rs:400-403); "
                         "drop-kmer skips only N-containing k-mers "
                         "(kmer.rs:161-163, the reference's path-guided "
                         "generator policy)")
    ip.add_argument("--modimizer", choices=["ahash", "code"],
                    default="ahash",
                    help="k-mer sampler under -r: 'ahash' (default) "
                         "reproduces the reference's ahash-0.7.6 "
                         "zero-seed hash %% r (kmer.rs:931-934; "
                         "reconstruction, see utils/ahash.py); 'code' "
                         "uses splitmix64 of the 2-bit k-mer code")
    ip.add_argument("--keep-duplicate-positions", action="store_true",
                    help="keep exact duplicate position rows within a "
                         "k-mer group (the reference's adjacent-only "
                         "dedup quirk, kmer.rs:299-301; ~100x table "
                         "blowup on fork-dense graphs).  Default drops "
                         "them")

    mp = sub.add_parser("map", help="map sequences to a graph")
    mp.add_argument("-i", "--index", required=True, metavar="FILE")
    mp.add_argument("-f", "--input-file", required=True, metavar="FILE")
    mp.add_argument("-o", "--out", dest="out_prefix", metavar="STRING")
    mp.add_argument("-g", "--max-gap-length", type=int, default=1000, metavar="INTEGER")
    mp.add_argument("-r", "--max-mismatch-rate", type=float, default=0.1, metavar="FLOAT")
    mp.add_argument("-c", "--chain-overlap-max", type=float, default=None,
                    metavar="FLOAT", help="accepted but unused (reference parity)")
    mp.add_argument("-a", "--chain-min-anchors", type=int, default=3, metavar="INTEGER")
    mp.add_argument("-b", "--align-best-n", type=int, default=1, metavar="INTEGER")
    mp.add_argument("-C", "--write-console", action="store_true")
    mp.add_argument("-D", "--also-align", action="store_true")
    mp.add_argument("-t", "--threads", type=int, default=0, metavar="INTEGER")
    mp.add_argument("-v", "--also-validate", action="store_true")
    mp.add_argument("-G", "--graph", dest="input_graph", metavar="FILE")
    mp.add_argument("-P", "--validation-path", metavar="FILE")
    mp.add_argument("-p", "--poa-aligner", required=True, metavar="ALIGNER_NAME",
                    choices=["rspoa", "abpoa"])
    mp.add_argument("--mapq", action="store_true",
                    help="extension (default off, reference emits mapq 0 on "
                         "chain rows): primary/secondary chain identification "
                         "per the reference's disabled logic — unambiguous "
                         "chains get mapq 60, query-overlap-ambiguous get 0")
    mp.add_argument("--shard-index", action="store_true",
                    help="offset-shard the k-mer position table across "
                         "the device mesh instead of replicating it "
                         "(pangenome-scale indexes; chains are "
                         "bit-identical to replicated mode — see "
                         "parallel/mesh.py place_index)")
    mp.add_argument("--range-mode", default=None,
                    choices=("corridor", "id"),
                    help="chain->POA subgraph strategy: 'corridor' "
                         "(default) is the topology-aware range between "
                         "the chain's first and last anchors — an "
                         "accuracy extension that keeps every bubble "
                         "branch and drops unrelated backbone; 'id' is "
                         "the reference's contiguous node-id range "
                         "(align.rs:267-402, strict parity)")
    mp.add_argument("--bubble-closure", action="store_true",
                    help="splice out-of-range bubble alt-alleles into the "
                         "chain-implied POA subgraph (extension beyond the "
                         "reference; helps isolated SNP bubbles, can hurt "
                         "on bubble-dense graphs)")
    mp.add_argument("--resume", action="store_true",
                    help="resume an interrupted map run: completed batches "
                         "recorded in <out>.progress.json are skipped and "
                         "output GAFs are appended to (extension beyond the "
                         "reference)")
    mp.add_argument("--both-strands", action="store_true",
                    help="extension (default off = reference parity, "
                         "map.rs:62 is forward-only): also map each "
                         "read's reverse complement and keep the "
                         "better-scoring strand; reverse hits are "
                         "reported on the original read with strand '-'")
    mp.add_argument("--precision", choices=["auto", "exact", "fast"],
                    default="auto",
                    help="chaining DP arithmetic (framework knob; the "
                         "reference has no analog): 'exact' reproduces the "
                         "reference's f64 scores bit-for-bit; 'fast' is the "
                         "scaled-int32 DP — identical chains except for "
                         "ties within 1e-3 of each other (see "
                         "ARCHITECTURE.md).  'auto' (default) picks exact "
                         "on CPU and fast on accelerators")
    return p


def _resolve_precision(precision: str) -> str:
    """'auto' -> exact on CPU (native IEEE f64 — reference bit-parity
    is free), fast on accelerators — a default carried from an
    accelerator that emulated f64; on the H100 the two map at similar
    rates (CHANGES.md), so the default is open (ROADMAP Queue 1
    item 7)."""
    if precision != "auto":
        return precision
    import jax

    resolved = "exact" if jax.default_backend() == "cpu" else "fast"
    log.info("precision auto -> %s (backend %s)",
             resolved, jax.default_backend())
    return resolved


def _strip_ext(path: str) -> str:
    for ext in (".gfa", ".fasta", ".fa", ".fastq", ".fq"):
        if path.endswith(ext):
            return path[: -len(ext)]
    return path


def index_main(args) -> None:
    from .graph import graph_from_gfa
    from .index import Index

    out_prefix = args.out_prefix or _strip_ext(args.input)
    graph = graph_from_gfa(args.input)
    Index.build(
        graph,
        args.kmer_length,
        max_furcations=args.max_furcations,
        max_degree=args.max_degree,
        out_prefix=out_prefix,
        sampling_rate=args.sampling_rate,
        generate_mappings=args.generate_mappings,
        mappings_path=args.mappings_path,
        n_policy=args.n_policy,
        dedup_positions=not args.keep_duplicate_positions,
        modimizer=args.modimizer,
    )


def map_main(args) -> None:
    from .index import Index
    from .io.fastx import read_seqs_from_file
    from .models.mapper import Mapper
    from .models.poa_aligner import PoaAligner, PoaEngine

    idx_path = args.index
    if idx_path.endswith(".idx.npz"):
        index = Index.load(idx_path)
    else:
        index = Index.load_from_prefix(idx_path)

    queries = read_seqs_from_file(args.input_file)
    out_prefix = args.out_prefix or _strip_ext(args.input_file)

    mesh = None
    if args.threads != 1:
        import jax

        n_dev = len(jax.devices())
        use = n_dev if args.threads == 0 else min(args.threads, n_dev)
        if use > 1:
            from .parallel.mesh import make_mesh

            mesh = make_mesh(use)

    precision = _resolve_precision(args.precision)
    mapper = Mapper(
        index,
        bandwidth=50,  # map_main.rs:100-117 hard-codes these
        max_gap=args.max_gap_length,
        chain_min_n_anchors=args.chain_min_anchors,
        mesh=mesh,
        mapq=args.mapq,
        precision=precision,
        both_strands=args.both_strands,
        shard_index=args.shard_index,
    )

    aligner = None
    if args.also_align:
        if not args.input_graph:
            sys.exit("--also-align requires -G/--graph (map.rs:155-159)")
        from .graph import graph_from_gfa

        graph = graph_from_gfa(args.input_graph)
        engine = PoaEngine.ABPOA if args.poa_aligner == "abpoa" else PoaEngine.RSPOA
        aligner = PoaAligner(index, engine, export_subgraphs=True, graph=graph,
                             bubble_closure=args.bubble_closure, mesh=mesh,
                             range_mode=args.range_mode)

    # large read sets stream through a two-stage software pipeline
    # (device POA for batch N overlaps host mapping of batch N+1);
    # outputs are identical, memory stays bounded by the batch size.
    # Each batch is appended + flushed with transactional progress, so
    # --resume restarts an interrupted run at the last complete batch.
    from .io.resume import ResumableGafWriter
    from .models.stream import DEFAULT_BATCH, stream_map_align

    if args.resume and args.also_validate:
        sys.exit("--resume cannot be combined with --also-validate "
                 "(validation needs the full in-memory alignment list)")

    chains_file = (
        out_prefix if out_prefix.endswith(".gaf") else out_prefix + "-chains.gaf"
    )
    align_file = (
        out_prefix if out_prefix.endswith(".gaf") else out_prefix + "-alignments.gaf"
    ) if args.also_align else None
    if align_file == chains_file:
        # a literal .gaf out path names ONE file; with --also-align the
        # base-level GAF is the single final product (matches the
        # pre-streaming behavior where the alignments write replaced
        # the chains write) — chain records are not written to disk
        chains_file = None
    writer = ResumableGafWriter(
        out_prefix, chains_file, align_file, resume=args.resume
    )
    if writer.skip_reads:
        log.info("Resuming: %d reads already done", writer.skip_reads)
    pending_queries = queries[writer.skip_reads :]

    # records are retained in memory only for the flags that need them
    # (console echo, validation) — otherwise memory stays bounded by the
    # batch size no matter the read-stream length
    keep_chains = args.write_console
    keep_alns = args.write_console or args.also_validate
    chains_gaf = []
    alignments = []
    n_chains = 0
    n_alignments = 0
    t0 = time.monotonic()

    def _on_chains(batch_chains):
        nonlocal n_chains
        n_chains += sum(len(c) for c in batch_chains)
        if keep_chains:
            # console echo retains records; the record path feeds the
            # writer too so echoed and written rows come from one source
            recs = mapper.chains_to_gaf(batch_chains)
            writer.write_chains(len(batch_chains), recs)
            chains_gaf.extend(recs)
        else:
            writer.write_chains(
                len(batch_chains), mapper.chains_gaf_text(batch_chains)
            )

    def _on_alignments(batch_alns):
        nonlocal n_alignments
        n_alignments += len(batch_alns)
        writer.write_alignments(batch_alns)
        if keep_alns:
            alignments.extend(batch_alns)

    # opt-in device tracing (the SURVEY §5 analog of the reference's
    # RUST_LOG phase logging): VGALIGNER_TRACE=<dir> wraps the run in a
    # jax profiler trace for xprof/tensorboard
    import contextlib

    trace_dir = os.environ.get("VGALIGNER_TRACE")
    trace_cm = contextlib.nullcontext()
    if trace_dir:
        import jax

        trace_cm = jax.profiler.trace(trace_dir)
    with trace_cm:
        stream_map_align(
            mapper, pending_queries, aligner,
            batch_size=DEFAULT_BATCH,
            align_best_n=args.align_best_n,
            on_chains=_on_chains,
            on_alignments=_on_alignments if aligner else None,
        )
    writer.close(done=True)
    log.info("Chaining%s took: %d ms",
             " + alignment" if aligner else "", (time.monotonic() - t0) * 1000)
    log.info("Found %d chains!", n_chains)
    if chains_file is not None:
        log.info("Chains stored correctly in %s!", chains_file)
    if args.write_console:
        for rec in chains_gaf:
            print(rec.to_string(), end="")

    if args.also_align:
        log.info("Found %d alignments!", n_alignments)
        log.info("Alignments stored correctly in %s!", align_file)

        if args.also_validate:
            from .io.validate import create_validation_records, write_validation_to_file

            records = create_validation_records(graph, alignments, queries)
            write_validation_to_file(records, args.validation_path)
            log.info("Validation stored correctly in %s!", args.validation_path)

        if args.write_console:
            for rec in alignments:
                print(rec.to_string(), end="")


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    args = _build_parser().parse_args(argv)
    if args.command == "index":
        index_main(args)
    elif args.command == "map":
        map_main(args)
    else:
        print("Missing subcommand, please add [index|map]")
