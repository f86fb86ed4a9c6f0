"""Decompose the longread_1kb bench: where do the milliseconds go?

Runs bench.py's long-read protocol (256 x 1 kb reads on the seeded
DRB1-3123-shaped graph, map +
--also-align) and prints the phase timers of the mapper, the POA device
drain, and the aligner, separated for the map and align stages.

Usage: python tools/profile_longread.py [n_reads] [read_len]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vgaligner_tpu.experiments.synth import (
    sample_reads, synth_graph, to_hash_graph,
)
from vgaligner_tpu.index import Index
from vgaligner_tpu.io.fastx import QuerySequence
from vgaligner_tpu.models.mapper import Mapper
from vgaligner_tpu.models.poa_aligner import PoaAligner, PoaEngine
from vgaligner_tpu.ops import poa_device
from vgaligner_tpu.utils.timing import PhaseTimer

def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    rl = int(sys.argv[2]) if len(sys.argv) > 2 else 1000
    graph = to_hash_graph(synth_graph(seed=1))
    index = Index.build(graph, 11, 100, 100)
    reads = sample_reads(graph, n, rl, seed=79)
    qs = [QuerySequence.from_name_and_string(f"l{i}", s)
          for i, s in enumerate(reads)]
    mapper = Mapper(index, chain_min_n_anchors=3, precision="fast")
    aligner = PoaAligner(index, PoaEngine.ABPOA)

    # warm (compile)
    lc = mapper.map_reads(qs)
    aligner.best_alignments_for_queries(lc)

    best = None
    for _ in range(2):
        mapper.timer = PhaseTimer()
        poa_device.timer = PhaseTimer()
        aligner.timer = PhaseTimer()
        t0 = time.monotonic()
        lc = mapper.map_reads(qs)
        t_map = time.monotonic() - t0
        t0 = time.monotonic()
        aligner.best_alignments_for_queries(lc)
        t_align = time.monotonic() - t0
        if best is None or t_map + t_align < best[0] + best[1]:
            best = (t_map, t_align, mapper.timer.report(),
                    aligner.timer.report(), poa_device.timer.report())
    t_map, t_align, rm, ra, rp = best
    print(f"n={n} len={rl}  map {t_map*1e3:.0f} ms  align {t_align*1e3:.0f} ms "
          f"  total {n/(t_map+t_align):.1f} r/s")
    print("mapper:", rm)
    print("aligner:", ra)
    print("poa_device:", rp)


if __name__ == "__main__":
    main()
