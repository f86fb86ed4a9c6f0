"""Software-pipelined map + --also-align over large read streams.

The reference processes reads one at a time (map.rs:56-111); the batched
device pipeline (models/mapper.py + models/poa_aligner.py) processes a
whole read set at once.  For production-scale read sets this module adds
the third shape: fixed-size batches driven through a two-stage software
pipeline, overlapping the device's POA compute for batch N with the
host-side mapping work (anchor counting, backtracking, coordinate
derivation, subgraph extraction) for batch N+1:

    map N -> dispatch POA N -> [device computes N] || [host maps N+1]
          -> drain POA N -> dispatch POA N+1 -> ...

This hides host work and result transfers behind device compute.
Memory stays bounded by the
batch size (chains and problem arrays for at most two batches are
live), so read streams of any length can be processed.

Outputs are emitted in input order, batch by batch, through the
callbacks — identical records to the unbatched path.
"""

from __future__ import annotations

import logging
from typing import Callable, List, Optional, Sequence

from ..io.fastx import QuerySequence
from ..io.gaf import GAFAlignment
from .mapper import Chain, Mapper
from .poa_aligner import PoaAligner

log = logging.getLogger(__name__)

DEFAULT_BATCH = 8192


def stream_map_align(
    mapper: Mapper,
    queries: Sequence[QuerySequence],
    aligner: Optional[PoaAligner] = None,
    batch_size: int = DEFAULT_BATCH,
    align_best_n: int = 1,
    on_chains: Optional[Callable[[List[List[Chain]]], None]] = None,
    on_alignments: Optional[Callable[[List[GAFAlignment]], None]] = None,
) -> None:
    """Drive queries through the pipelined map(+align) in input order.

    on_chains(batch_chains) fires per batch right after mapping;
    on_alignments(batch_alignments) fires per batch after the POA drain
    (only when an aligner is given).  Callbacks receive batches in input
    order, so appending to a list or writing to a file reproduces the
    unbatched output exactly.
    """
    import os
    import threading

    n = len(queries)
    if n == 0:
        return

    # The drain moves off the main thread: finish_alignments(batch N)
    # blocks in device_get and in native decode — GIL released — while
    # the main thread does batch N+1's host mapping.  Emission order is preserved by joining
    # the worker before the next batch's drain starts.
    use_async = os.environ.get("VGALIGNER_STREAM_ASYNC", "1") != "0"

    worker: Optional[threading.Thread] = None
    box: List = [None, None]  # (result, exception) from the worker

    def join_worker():
        nonlocal worker
        if worker is None:
            return
        worker.join()
        worker = None
        done, exc = box
        box[0] = box[1] = None
        if exc is not None:
            raise exc
        if on_alignments is not None:
            on_alignments(done)

    def start_worker(state):
        nonlocal worker

        def run():
            try:
                box[0] = aligner.finish_alignments(state)
            except BaseException as e:  # surfaced on join
                box[1] = e

        worker = threading.Thread(target=run, daemon=True)
        worker.start()

    if aligner is None:
        # map-only stream: pipeline the map's own begin/finish halves —
        # finish_map(N) blocks in device_get (GIL released) on the
        # worker while begin_map(N+1) runs host encode + dispatch on
        # the main thread.  The unpipelined loop serializes host work
        # behind every batch's device wait, which is why batch-mode
        # map-only used to lose to the single-thread native baseline.
        def finish_on_worker(state):
            nonlocal worker

            def run():
                try:
                    box[0] = mapper.finish_map(state)
                except BaseException as e:
                    box[1] = e

            worker = threading.Thread(target=run, daemon=True)
            worker.start()

        def join_map_worker():
            nonlocal worker
            if worker is not None:
                worker.join()
                worker = None
            done, exc = box
            box[0] = box[1] = None
            if exc is not None:
                raise exc
            if done is not None and on_chains is not None:
                on_chains(done)

        first = True
        for s in range(0, n, batch_size):
            state = mapper.begin_map(queries[s : s + batch_size])
            if not first:
                join_map_worker()  # emit batch N-1 before draining N
            first = False
            if use_async:
                finish_on_worker(state)
            else:
                box[0] = mapper.finish_map(state)
        join_map_worker()
        return

    pending = None  # (state from begin_alignments)
    for s in range(0, n, batch_size):
        batch = queries[s : s + batch_size]
        chains = mapper.map_reads(batch)
        if on_chains is not None:
            on_chains(chains)
        if aligner is not None:
            state = aligner.begin_alignments(chains, align_best_n)
            join_worker()
            if pending is not None:
                if use_async:
                    start_worker(pending)
                else:
                    done = aligner.finish_alignments(pending)
                    if on_alignments is not None:
                        on_alignments(done)
            pending = state
    if aligner is not None:
        join_worker()
        if pending is not None:
            done = aligner.finish_alignments(pending)
            if on_alignments is not None:
                on_alignments(done)
