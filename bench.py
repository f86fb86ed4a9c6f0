"""Benchmark: map + --also-align throughput on a DRB1-3123-shaped graph.

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline"}.
The headline is the better of the single-batch rate and the pipelined
streaming rate over 3 batches (models/stream.py — the CLI's production
execution path, which overlaps host mapping with device POA).

Workload (BASELINE.json config 4 analog): index the seeded
DRB1-3123-shaped graph of vgaligner_tpu/experiments/synth.py (~4,800
nodes, ~22.6 kb) at k=11 and map a batch of 100bp reads sampled
deterministically from the graph's embedded paths (the same read model
as the reference's `vg sim` protocol, Snakefile:25-32).  Needs an
accelerator; exits non-zero on the CPU.

vs_baseline: the reference is a single-threaded CPU program (rayon
compiled out, SURVEY.md §1) and no Rust toolchain exists in this image,
so the baseline is a single-threaded NATIVE C++ restatement of the
reference's per-read loop (native/host_kernels.cpp
vg_baseline_map_align: anchoring + chaining DP + subgraph POA,
map.rs:56-111 + align.rs:58-145), compiled -O3 -march=native and timed
on the same machine over BASELINE_READS reads.  It is deliberately
generous to the reference (binary-search lookup instead of the
reference's O(n_kmers) membership scan, searchsorted rank/select
instead of its O(seq_len) loops).
vs_baseline = device map+align reads/s ÷ native-baseline reads/s.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

K = 11
READ_LEN = 100
N_READS = 4096
N_BATCHES = 3
BASELINE_READS = 512
N_ALIGN = 4096


def main():
    import jax

    if jax.default_backend() == "cpu":
        sys.exit("bench: no accelerator found (JAX runs on the CPU)")
    from vgaligner_tpu.experiments.synth import (
        sample_reads, synth_graph, to_hash_graph,
    )
    from vgaligner_tpu.index import Index
    from vgaligner_tpu.io.fastx import QuerySequence
    from vgaligner_tpu.models.mapper import Mapper

    graph = to_hash_graph(synth_graph(seed=1))
    t0 = time.monotonic()
    index = Index.build(graph, K, 100, 100)
    index_build_s = time.monotonic() - t0

    reads = sample_reads(graph, N_READS, READ_LEN)
    queries = [QuerySequence.from_name_and_string(f"r{i}", s) for i, s in enumerate(reads)]

    # fast precision: the scaled-integer DP, the accelerators' default
    mapper = Mapper(index, chain_min_n_anchors=3, precision="fast")

    # warm-up (compile)
    mapper.map_reads(queries)

    # best-of-N
    batch_times = []
    for _ in range(N_BATCHES):
        t0 = time.monotonic()
        chains = mapper.map_reads(queries)
        batch_times.append(time.monotonic() - t0)
    device_s = min(batch_times)
    device_rps = len(queries) / device_s

    # production map-only path: the pipelined map stream (begin/finish
    # halves overlapped — the CLI's map-without-align shape).  The
    # unpipelined number above serializes host work behind every
    # batch's device wait.
    from vgaligner_tpu.models.stream import stream_map_align as _stream

    stream_map_reads = sample_reads(graph, 3 * N_READS, READ_LEN, seed=81)
    stream_map_qs = [
        QuerySequence.from_name_and_string(f"m{i}", s)
        for i, s in enumerate(stream_map_reads)
    ]
    map_stream_rps = 0.0
    for _ in range(2):
        got: list = []
        t0 = time.monotonic()
        _stream(mapper, stream_map_qs, None, batch_size=N_READS,
                on_chains=got.extend)
        dt = time.monotonic() - t0
        assert len(got) == len(stream_map_qs)
        map_stream_rps = max(map_stream_rps, len(stream_map_qs) / dt)
    map_only_rps = max(device_rps, map_stream_rps)

    # single-threaded NATIVE baseline (C++ restatement of the reference
    # per-read loop) over BASELINE_READS reads; best-of-2
    from vgaligner_tpu.native import baseline_map_align_native

    sub = reads[:BASELINE_READS]
    baseline_map_align_native(index, sub[:8], also_align=False)  # warm
    host_map_s = float("inf")
    for _ in range(2):
        t0 = time.monotonic()
        base_chains, _ = baseline_map_align_native(index, sub, also_align=False)
        host_map_s = min(host_map_s, time.monotonic() - t0)
    host_rps = len(sub) / host_map_s

    # ---- headline: map + --also-align (abPOA engine, device POA) -------
    from vgaligner_tpu.models.poa_aligner import PoaAligner, PoaEngine

    aligner = PoaAligner(index, PoaEngine.ABPOA)
    n_align = min(len(queries), N_ALIGN)
    chains_sub = chains[:n_align]
    aligner.best_alignments_for_queries(chains_sub)  # warm-up/compile

    align_times = []
    for _ in range(N_BATCHES):
        t0 = time.monotonic()
        alignments = aligner.best_alignments_for_queries(chains_sub)
        align_times.append(time.monotonic() - t0)
    align_s = min(align_times)
    # full pipeline rate: map (device_s prorated) + align
    map_align_rps = n_align / (align_s + device_s * n_align / len(queries))

    # native baseline for map + --also-align over the same reads
    baseline_map_align_native(index, sub[:4], also_align=True)  # warm
    host_ma_s = float("inf")
    for _ in range(2):
        t0 = time.monotonic()
        _, base_tapes = baseline_map_align_native(index, sub, also_align=True)
        host_ma_s = min(host_ma_s, time.monotonic() - t0)
    host_ma_rps = len(sub) / host_ma_s

    # ---- production path: pipelined streaming over 3 batches ----------
    # (the CLI streams map+align; batch N+1's host mapping overlaps
    # batch N's device POA, so the sustained rate beats the single-batch
    # rate measured above)
    from vgaligner_tpu.models.stream import stream_map_align

    stream_reads = sample_reads(graph, 3 * N_READS, READ_LEN, seed=78)
    stream_qs = [
        QuerySequence.from_name_and_string(f"s{i}", s)
        for i, s in enumerate(stream_reads)
    ]
    stream_rps = 0.0
    for _ in range(3):
        done: list = []
        t0 = time.monotonic()
        stream_map_align(
            mapper, stream_qs, aligner, batch_size=N_READS,
            on_alignments=done.extend,
        )
        dt = time.monotonic() - t0
        assert len(done) == len(stream_qs)
        stream_rps = max(stream_rps, len(stream_qs) / dt)
    map_align_rps = max(map_align_rps, stream_rps)

    # ---- long reads: 1 kb map + --also-align (W = 1024 POA) -----------
    long_reads = sample_reads(graph, 256, 1000, seed=79)
    long_qs = [
        QuerySequence.from_name_and_string(f"l{i}", s)
        for i, s in enumerate(long_reads)
    ]
    long_chains = mapper.map_reads(long_qs)
    aligner.best_alignments_for_queries(long_chains)  # warm-up/compile
    long_rps = 0.0
    for _ in range(2):
        t0 = time.monotonic()
        lc = mapper.map_reads(long_qs)
        aligner.best_alignments_for_queries(lc)
        long_rps = max(long_rps, len(long_qs) / (time.monotonic() - t0))
    for _ in range(2):
        # streamed variant (the CLI's shape); report the better of batch
        # and streamed, as the 100 bp metric does
        done_l: list = []
        t0 = time.monotonic()
        stream_map_align(mapper, long_qs, aligner, batch_size=128,
                         on_alignments=done_l.extend)
        dt = time.monotonic() - t0
        assert len(done_l) == len(long_qs)
        long_rps = max(long_rps, len(long_qs) / dt)

    n_chains = sum(len(c) for c in chains)
    sys.stderr.write(
        f"graph=synth-drb1 device={jax.devices()[0].device_kind} "
        f"index_build={index_build_s:.1f}s n_kmers={index.n_kmers} "
        f"reads={len(queries)} chains={n_chains} "
        f"map_only={map_only_rps:.1f} r/s "
        f"(batch {device_rps:.1f}, streamed {map_stream_rps:.1f}, "
        f"host {host_rps:.1f}) "
        f"map+align={map_align_rps:.1f} r/s "
        f"(streamed {stream_rps:.1f}, host {host_ma_rps:.1f}, "
        f"{n_align} aligned) "
        f"longread_1kb={long_rps:.1f} r/s\n"
    )
    print(
        json.dumps(
            {
                "metric": "reads/sec/card (map + --also-align), "
                          "DRB1-3123-shaped synthetic graph",
                "value": round(map_align_rps, 2),
                "unit": "reads/s",
                "vs_baseline": round(map_align_rps / host_ma_rps, 2),
            }
        )
    )


if __name__ == "__main__":
    main()
