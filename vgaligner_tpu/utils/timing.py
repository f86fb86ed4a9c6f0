"""Phase timers (tracing/profiling subsystem).

Reference analog: the Instant-based wall-clock phase timers around k-mer
generation/conversion (index.rs:161-172,212-224), chaining (map.rs:47,112)
and alignment substeps (align.rs:68-98).  Unlike the reference's
unconditional println! debugging (which would destroy device throughput),
everything here is opt-in via logging level or explicit collection.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict

log = logging.getLogger(__name__)


class PhaseTimer:
    """Accumulates wall-clock per named phase; logs at INFO.

    Thread-safe: the pipelined map stream (models/stream.py) runs
    finish_map(N) on a worker thread while begin_map(N+1) times phases
    on the main thread against the same Mapper's timer, so the
    accumulation is guarded by a lock (the defaultdict += pairs are not
    atomic under the GIL across the read-modify-write)."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    @contextmanager
    def phase(self, name: str):
        t0 = time.monotonic()
        try:
            yield
        finally:
            dt = time.monotonic() - t0
            with self._lock:
                self.totals[name] += dt
                self.counts[name] += 1
            log.info("%s took: %d ms", name, dt * 1000)

    def summary(self) -> Dict[str, float]:
        return dict(self.totals)

    def report(self) -> str:
        return " | ".join(
            f"{k}: {v*1000:.1f}ms/{self.counts[k]}x" for k, v in self.totals.items()
        )


@contextmanager
def jax_profile(out_dir: str):
    """Optional XLA trace capture (view with TensorBoard/xprof)."""
    import jax

    jax.profiler.start_trace(out_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
