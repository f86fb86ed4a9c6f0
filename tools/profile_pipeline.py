"""Ad-hoc profiling of the map and map+align pipelines on real hardware.

Prints per-phase wall-clock for the bench workload so optimization
effort lands where the time actually goes. Not part of the test suite.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from bench import K, N_READS, READ_LEN  # noqa: E402


def main():
    from vgaligner_tpu.experiments.synth import (
        sample_reads, synth_graph, to_hash_graph,
    )
    from vgaligner_tpu.index import Index
    from vgaligner_tpu.io.fastx import QuerySequence
    from vgaligner_tpu.models.mapper import Mapper
    from vgaligner_tpu.models.poa_aligner import PoaAligner, PoaEngine

    graph = to_hash_graph(synth_graph(seed=1))
    index = Index.build(graph, K, 100, 100)
    reads = sample_reads(graph, N_READS, READ_LEN)
    queries = [QuerySequence.from_name_and_string(f"r{i}", s) for i, s in enumerate(reads)]

    mapper = Mapper(index, chain_min_n_anchors=3, precision="fast")
    chains = mapper.map_reads(queries)  # warm-up
    mapper.timer.totals.clear()
    mapper.timer.counts.clear()
    t0 = time.monotonic()
    chains = mapper.map_reads(queries)
    map_s = time.monotonic() - t0
    print(f"map: {map_s*1000:.1f} ms total ({len(queries)/map_s:.0f} r/s)")
    print("  " + mapper.timer.report())

    aligner = PoaAligner(index, PoaEngine.ABPOA)
    aligner.best_alignments_for_queries(chains)  # warm-up
    from vgaligner_tpu.ops import poa_device as _pd

    best = float("inf")
    for _ in range(int(os.environ.get("PROFILE_REPS", "2"))):
        _pd.timer.totals.clear()
        _pd.timer.counts.clear()
        t0 = time.monotonic()
        aligner.best_alignments_for_queries(chains)
        align_s = time.monotonic() - t0
        print(f"align: {align_s*1000:.1f} ms total "
              f"({len(queries)/align_s:.0f} r/s)")
        print("  poa phases: " + _pd.timer.report())
        best = min(best, align_s)
    if os.environ.get("PROFILE_QUICK") == "1":
        return

    # align sub-phases, instrumented inline
    from vgaligner_tpu.models.poa_aligner import _V_DEVICE_CAP  # noqa
    from vgaligner_tpu import native
    from vgaligner_tpu.ops.poa_device import (
        P_MAX, _l_pad_for, _next_pow2, kernel_dispatch_chunked,
        kernel_finish_all,
    )
    from vgaligner_tpu.native import build_poa_batch_arrays, extract_subgraphs_native
    from vgaligner_tpu.utils.dna import encode_seq

    sel = [(qi, cs[0]) for qi, cs in enumerate(chains) if not cs[0].is_placeholder]
    chains_flat = [c for _, c in sel]
    t0 = time.monotonic()
    n_anchors = np.asarray([c.n_anchors for c in chains_flat], dtype=np.int64)
    anchor_off = np.concatenate([[0], np.cumsum(n_anchors)])
    aqb = np.concatenate([c.aqb for c in chains_flat])
    atb = np.concatenate([c.atb for c in chains_flat])
    ate = np.concatenate([c.ate for c in chains_flat])
    qlen = np.asarray([len(c.query.seq) for c in chains_flat], dtype=np.int64)
    handle_off, handles, label_off, _lbase, labels, edge_off, edges, status = (
        extract_subgraphs_native(index, anchor_off, aqb, atb, ate, None, None, qlen, K)
    )
    t_extract = time.monotonic() - t0

    qs = [encode_seq(c.query.seq) for c in chains_flat]
    v_per = label_off[handle_off[1:]] - label_off[handle_off[:-1]]
    print(f"  extract: {t_extract*1000:.1f} ms; V dist: "
          f"p50={int(np.percentile(v_per,50))} p90={int(np.percentile(v_per,90))} "
          f"p99={int(np.percentile(v_per,99))} max={int(v_per.max())} n={len(v_per)}")
    buckets = {}
    for i in range(len(chains_flat)):
        key = (_next_pow2(max(int(v_per[i]), 256)), _l_pad_for(len(qs[i])))
        buckets.setdefault(key, []).append(i)
    edges_flat = np.ascontiguousarray(edges.reshape(-1), dtype=np.int64)

    from vgaligner_tpu.ops import poa_device
    poa_device.timer.totals.clear()
    poa_device.timer.counts.clear()
    t0 = time.monotonic()
    pending = []
    t_build = 0.0
    for (v_pad, l_pad), idxs in sorted(buckets.items()):
        selarr = np.asarray(idxs, dtype=np.int64)
        tb = time.monotonic()
        built = build_poa_batch_arrays(
            labels, label_off, handle_off.astype(np.int64),
            edge_off.astype(np.int64), edges_flat, selarr, v_pad, P_MAX,
        )
        t_build += time.monotonic() - tb
        pending.append(((v_pad, l_pad, len(idxs)),
                        kernel_dispatch_chunked(built, [qs[i] for i in idxs], v_pad, l_pad)))
    t_dispatch = time.monotonic() - t0
    t0 = time.monotonic()
    # production drain: ONE device_get across all buckets' chunks
    flat = [p for _key, ps in pending for p in ps]
    n_res = len(kernel_finish_all(flat))
    t_finish = time.monotonic() - t0
    print(f"  drained {n_res} problems in one pass")
    print(f"  build_arrays: {t_build*1000:.1f} ms | dispatch(total): {t_dispatch*1000:.1f} ms "
          f"| finish(fetch+decode): {t_finish*1000:.1f} ms")
    from vgaligner_tpu.ops import poa_device
    print("  poa phases: " + poa_device.timer.report())


if __name__ == "__main__":
    main()
