"""The mapping pipeline: reads -> anchors -> chains -> GAF.

Behavioral reference: map_reads (rs-vgaligner src/map.rs:27-216) and
the chain backtracking of chain_anchors (chain.rs:452-655).

Device/host split:
  * encode + lookup + anchor materialization + chaining DP run jitted on
    device, batched over reads (ops/encode.py, ops/lookup.py,
    ops/chain.py); batches are bucketed by padded read length and anchor
    capacity (powers of two) to bound recompiles;
  * backtracking and GAF formatting run on host — chains per read are
    tiny and the reference's predecessor-nulling walk (chain.rs:466-557)
    is inherently sequential and mutating.

Backtracking semantics reproduced exactly:
  * only anchors whose final score equals the global `curr_max` (exact
    f64 equality, chain.rs:469) start a chain, scanning anchors from the
    last sorted position downward;
  * visited anchors have their predecessor nulled so later chains
    truncate at (but still include) already-consumed anchors
    (chain.rs:476-498);
  * chains shorter than chain_min_n_anchors are dropped (chain.rs:545);
  * the final per-read sort by chain score (chain.rs:563) is a stable
    no-op because Chain::score is never assigned by the reference (it
    stays 0.0), so discovery order is emitted;
  * reads with no chains emit the placeholder row (chain.rs:644-649).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from functools import partial
from typing import List, NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..index.build import Index
from ..index.kmer_gen import FORWARD
from ..io.fastx import QuerySequence
from ..io.gaf import GAFAlignment
from ..ops.chain import chain_scores, make_gap_cost_table
from ..ops.encode import encode_reads_host, window_kmer_codes
from ..ops.lookup import lookup_and_materialize_anchors

log = logging.getLogger(__name__)

F64_MIN = -np.finfo(np.float64).max  # mapping_quality sentinel (f64::MIN)

SECONDARY_CHAIN_THRESHOLD = 0.5  # map_main.rs:100-117 (hard-coded)
MAX_MAPQ = 60.0


def assign_mapq(
    chains,
    secondary_chain_threshold: float = SECONDARY_CHAIN_THRESHOLD,
    max_mapq: float = MAX_MAPQ,
) -> None:
    """Opt-in mapq extension (--mapq): a working restatement of the
    reference's commented-out primary/secondary identification
    (chain.rs:582-640; map_main.rs:100-117 hard-codes threshold 0.5 /
    max mapq 60, and neither is reachable in the release build).

    The dead code cannot run as written — it marks secondaries on a
    CLONE pulled out of the interval tree, divides score by score on
    the always-score-tied chains the live backtrack emits
    (chain.rs:469 keeps only global-max chains), and its
    min(1, n_anchors/10) integer division zeroes the formula for every
    sub-10-anchor chain.  This extension implements the intent on the
    real chain list: a chain whose query interval is overlapped by
    another chain of the read (by more than secondary_chain_threshold
    of that other chain's length, chain.rs:615) is ambiguous — it gets
    mapq 0 and lower-ranked overlapping chains are flagged
    is_secondary — while an unambiguous chain gets max_mapq.
    Inverted query intervals are skipped as in the reference
    (chain.rs:588-592), leaving the sentinel (GAF mapq 0).  Default
    OFF: the reference's release emits mapq 0 on every chain row
    (align.rs:904)."""
    real = [c for c in chains if not c.is_placeholder and c.n_anchors]
    spans = [(int(c.aqb[0]), int(c.aqb[-1]) + c.k) for c in real]
    for i, c in enumerate(real):
        qb, qe = spans[i]
        if qb >= qe:
            continue
        ambiguous = False
        for j, (ob, oe) in enumerate(spans):
            if j == i or ob >= oe:
                continue
            ovlp = min(qe, oe) - max(qb, ob)
            if ovlp <= 0:
                continue
            # ANY overlapping (score-tied) chain makes this one
            # ambiguous — the reference's best_secondary tracking is
            # not gated by the threshold (chain.rs:619-625), and with
            # tied scores its formula yields 0; the threshold only
            # governs the secondary FLAG on the overlapped chain
            # (chain.rs:613-617)
            ambiguous = True
            if ovlp > (oe - ob) * secondary_chain_threshold:
                real[j].is_secondary = True
        c.mapping_quality = 0.0 if ambiguous else max_mapq
    # a flagged secondary is never a confident mapping, whatever its own
    # view of the overlap (reference zeroes the overlapped chain's mapq
    # at flag time, chain.rs:616)
    for c in real:
        if c.is_secondary and c.mapping_quality == max_mapq:
            c.mapping_quality = 0.0


class ChainAnchor(NamedTuple):
    """An anchor inside a chain (chain.rs:29-75), forward-only production
    path so both orients are Forward."""

    id: int
    qb: int
    qe: int
    tb: int
    te: int
    so: int = FORWARD
    eo: int = FORWARD


@dataclass
class Chain:
    """chain.rs:177-272.

    Anchor data is stored as arrays (aqb/atb/ate, ascending chain order,
    forward-only orients) so batch emission never builds per-anchor
    Python objects; `.anchors` materializes ChainAnchor views on demand
    for the POA path and tests."""

    query: QuerySequence
    aqb: Optional[np.ndarray] = None  # int64 [n] query begins
    atb: Optional[np.ndarray] = None  # int64 [n] target begins
    ate: Optional[np.ndarray] = None  # int64 [n] target ends
    aso: Optional[np.ndarray] = None  # int8 [n] start orients (None = fwd)
    aeo: Optional[np.ndarray] = None  # int8 [n] end orients (None = fwd)
    k: int = 0
    score: float = 0.0
    mapping_quality: float = F64_MIN
    is_secondary: bool = False
    is_placeholder: bool = False
    # "+" = query as given; "-" = chain maps the reverse complement
    # (both-strands extension; `query.seq` then holds the revcomp the
    # anchors refer to, and GAF emission flips coordinates back)
    strand: str = "+"

    @classmethod
    def from_anchor_list(cls, query, anchors: List[ChainAnchor]) -> "Chain":
        return cls(
            query=query,
            aqb=np.asarray([a.qb for a in anchors], dtype=np.int64),
            atb=np.asarray([a.tb for a in anchors], dtype=np.int64),
            ate=np.asarray([a.te for a in anchors], dtype=np.int64),
            aso=np.asarray([a.so for a in anchors], dtype=np.int8),
            aeo=np.asarray([a.eo for a in anchors], dtype=np.int8),
            k=(anchors[0].qe - anchors[0].qb) if anchors else 0,
        )

    @property
    def n_anchors(self) -> int:
        return 0 if self.aqb is None else len(self.aqb)

    @property
    def anchors(self) -> List[ChainAnchor]:
        if self.aqb is None:
            return []
        return [
            ChainAnchor(
                id=i,
                qb=int(self.aqb[i]),
                qe=int(self.aqb[i]) + self.k,
                tb=int(self.atb[i]),
                te=int(self.ate[i]),
                so=FORWARD if self.aso is None else int(self.aso[i]),
                eo=FORWARD if self.aeo is None else int(self.aeo[i]),
            )
            for i in range(len(self.aqb))
        ]


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p <<= 1
    return p


def chain_dp_score(chain: "Chain", max_gap: int) -> float:
    """Recompute a chain's final DP score from its member anchors.

    Walking the backtracked path re-applies score_anchor (chain.rs:
    274-368) link by link, so for an UNTRUNCATED chain (the first one
    discovered per read — later chains may stop early at consumed
    anchors) this equals the read's global best score `curr_max`
    exactly, in f64, regardless of which device/host path produced the
    chain.  Used by the both-strands extension to pick the better
    strand without shipping scores off device."""
    if chain.is_placeholder or chain.n_anchors == 0:
        return -np.inf
    from .host_pipeline import HAnchor, score_anchor

    k = chain.k
    f = float(k)
    for i in range(1, chain.n_anchors):
        a = HAnchor(id=0, qb=int(chain.aqb[i - 1]), qe=int(chain.aqb[i - 1]) + k,
                    tb=int(chain.atb[i - 1]), te=int(chain.ate[i - 1]), f=f)
        b = HAnchor(id=1, qb=int(chain.aqb[i]), qe=int(chain.aqb[i]) + k,
                    tb=int(chain.atb[i]), te=int(chain.ate[i]))
        f = score_anchor(a, b, k, max_gap)
    return f


def anchors_for_query_host(
    index: Index, query: QuerySequence, only_forward: bool = True
) -> List[ChainAnchor]:
    """Host reference path for anchor generation (chain.rs:134-173).

    Used by tests and by the full-orientation API; the production device
    path (ops/lookup.py) is the vectorized forward-only equivalent.
    """
    k = index.kmer_length
    anchors: List[ChainAnchor] = []
    aid = 0
    for i, kmer in enumerate(query.split_into_kmers(k)):
        for so, sp, eo, ep in index.find_positions_for_query_kmer(kmer):
            if (not only_forward) or (so == FORWARD and eo == FORWARD):
                anchors.append(
                    ChainAnchor(id=aid, qb=i, qe=i + k, tb=sp, te=ep, so=so, eo=eo)
                )
                aid += 1
    return anchors


def _anchor_coords_host(seqs, index, a_max: np.ndarray, mem_off: np.ndarray,
                        mem_slots: np.ndarray):
    """Python fallback for native.anchor_coords_native: re-derive the
    device anchor set (ops/lookup.py generation order, truncated at
    a_max) and the chaining DP's stable sort by target_end, then map
    member *sorted positions* to (qb, tb, te)."""
    from ..ops.encode import encode_reads_host

    k = index.kmer_length
    out_qb = np.zeros(len(mem_slots), dtype=np.int64)
    out_tb = np.zeros(len(mem_slots), dtype=np.int64)
    out_te = np.zeros(len(mem_slots), dtype=np.int64)
    if not len(mem_slots):
        return out_qb, out_tb, out_te
    l_pad = max(max(len(s) for s in seqs), k)
    codes, lens = encode_reads_host(seqs, l_pad)
    B, W = len(seqs), l_pad - k + 1
    w = np.zeros((B, W), dtype=np.int64)
    ok = np.ones((B, W), dtype=bool)
    c64 = codes.astype(np.int64)
    for j in range(k):
        b = c64[:, j : j + W]
        ok &= b < 4
        w = (w << 2) | np.where(b < 4, b, 0)
    ok &= (np.arange(W)[None, :] + k) <= lens[:, None]
    n = len(index.kmer_codes)
    g = np.searchsorted(index.kmer_codes, w.ravel()).reshape(B, W)
    gc = np.minimum(g, max(n - 1, 0))
    found = ok & (g < n) & (index.kmer_codes[gc] == w)
    counts = np.where(found, index.fo_counts[gc], 0).astype(np.int64)
    offsets = np.where(found, index.fo_offsets[gc], 0).astype(np.int64)
    for r in range(B):
        m0, m1 = int(mem_off[r]), int(mem_off[r + 1])
        if m0 == m1:
            continue
        # generation-order anchors: window index repeated by its count,
        # table rows offset + within; truncated at the device cap
        cnt_r = counts[r]
        qb_all = np.repeat(np.arange(W, dtype=np.int64), cnt_r)
        within = np.arange(len(qb_all), dtype=np.int64) - np.repeat(
            np.cumsum(cnt_r) - cnt_r, cnt_r
        )
        rows = np.repeat(offsets[r], cnt_r) + within
        qb_all = qb_all[: int(a_max[r])]
        rows = rows[: int(a_max[r])]
        tb_all = index.fo_positions[rows, 0]
        te_all = index.fo_positions[rows, 1]
        order = np.argsort(te_all, kind="stable")
        sl = mem_slots[m0:m1].astype(np.int64)
        sel = order[sl]
        out_qb[m0:m1] = qb_all[sel]
        out_tb[m0:m1] = tb_all[sel]
        out_te[m0:m1] = te_all[sel]
    return out_qb, out_tb, out_te


def _fetch_bucket_outputs(outs):
    """Drain [(a_max, packed, counts), ...] bucket outputs to host numpy
    with a minimal number of device-to-host transfers (ops.poa_device.
    fetch_grouped groups by dtype).  The wire path fuses each bucket's
    u8 plane and its counts into ONE device buffer (counts is None
    here) — split back after the fetch; legacy two-output buckets pass
    through unchanged.  Returns [(packed, counts), ...]."""
    from ..ops.poa_device import fetch_grouped

    parts = []
    for _a_max, p, c in outs:
        parts.append(p)
        if c is not None:
            parts.append(c)
    fetched = fetch_grouped(parts)
    res = []
    i = 0
    for a_max, _p, c in outs:
        arr = fetched[i]
        i += 1
        if c is None:
            B = arr.size // (a_max + 8)
            plane = arr[: B * a_max].reshape(B, a_max)
            counts = (
                arr[B * a_max :].view(np.int32).reshape(B, 2)
            )
            res.append((plane, counts))
        else:
            res.append((arr, fetched[i]))
            i += 1
    return res


# jitted shard_map executables for the offset-sharded index path,
# keyed by (mesh, static knobs) — rebuilding the shard_map wrapper per
# batch would retrace every call
_SHARDED_MAP_CACHE: dict = {}

# fused multi-bucket map executables, keyed by (bucket layout, knobs)
_FUSED_MAP_CACHE: dict = {}


def _fused_map_fn(layout, k, bandwidth, precision):
    """One jitted executable running EVERY anchor-capacity bucket of a
    mapping batch: per bucket, slice its (codes, lens) wire segment
    from the mega buffer at static offsets, run the fused map core, and
    concatenate every bucket's u8 delta plane + bitcast counts into ONE
    output buffer.  This holds the whole map step at one device_put +
    one device_get regardless of how many buckets the anchor-capacity
    ladder splits the batch into, so the {64,128,256} ladder costs no
    extra transfers (smaller a_max = ~linearly less chain DP and lookup
    work for the ~60%% of reads with few anchors).

    layout: tuple of (B, L, a_max, wsize) per bucket, ladder-quantized
    upstream so executables repeat across batches."""
    key = (layout, k, bandwidth, precision)
    fn = _FUSED_MAP_CACHE.get(key)
    if fn is not None:
        return fn
    import jax
    import jax.numpy as jnp

    def fused(mega, dindex, gap_table):
        outs = []
        off = 0
        for B, L, a_max, wsize in layout:
            wire = mega[off : off + wsize]
            off += wsize
            codes = jax.lax.bitcast_convert_type(
                wire[: B * L], jnp.int8
            ).reshape(B, L)
            lens = jax.lax.bitcast_convert_type(
                wire[B * L : B * L + B * 4].reshape(B, 4), jnp.int32
            )
            packed, counts = Mapper._map_core(
                codes, lens, dindex, gap_table, k, a_max, bandwidth,
                precision,
            )
            outs.append(packed.reshape(-1))  # u8 (bandwidth < 127)
            outs.append(
                jax.lax.bitcast_convert_type(counts, jnp.uint8).reshape(-1)
            )
        return jnp.concatenate(outs)

    jf = jax.jit(fused)
    _FUSED_MAP_CACHE[key] = jf
    return jf


class Mapper:
    """Batched read mapper over a built index."""

    def __init__(
        self,
        index: Index,
        bandwidth: int = 50,
        max_gap: int = 1000,
        chain_min_n_anchors: int = 3,
        max_anchors_cap: int = 65536,
        mesh=None,
        precision: str = "exact",
        mapq: bool = False,
        both_strands: bool = False,
        shard_index: bool = False,
    ) -> None:
        self.index = index
        self.bandwidth = bandwidth
        self.max_gap = max_gap
        self.chain_min_n_anchors = chain_min_n_anchors
        self.max_anchors_cap = max_anchors_cap
        self.mesh = mesh
        self.precision = precision
        self.mapq = mapq
        self.both_strands = both_strands
        # shard_index: offset-shard the position table over the mesh
        # (pangenome-scale indexes; see parallel/mesh.py place_index)
        self.shard_index = shard_index and mesh is not None
        self.dindex = index.device()
        if mesh is not None:
            from ..parallel.mesh import place_index

            self.dindex = place_index(
                mesh, self.dindex, shard_positions=self.shard_index
            )
        self._gap_table = make_gap_cost_table(index.kmer_length, max_gap)
        # one upload, reused by every bucket launch
        if mesh is not None:
            from ..parallel.mesh import replicate

            self._gap_table_dev = replicate(mesh, jnp.asarray(self._gap_table))
        else:
            self._gap_table_dev = jnp.asarray(self._gap_table)
        from ..utils.timing import PhaseTimer

        self.timer = PhaseTimer()

    # ---- device pipeline ----------------------------------------------

    @staticmethod
    def _map_core(codes, lens, dindex, gap_table, k, a_max, bandwidth,
                  precision="exact", position_gather=None):
        """One fused mapping step (trace-level body shared by the
        replicated and offset-sharded index paths).  The host-bound
        payload is a single integer channel per anchor plus per-read
        counts:

          packed[B, A]: uint8 (delta | is_start<<7) when the DP window
            fits 7 bits (bandwidth < 127, the production case — the
            predecessor always lives within `bandwidth` slots), else
            (pred+1) | is_start<<S as uint16/int32
          counts[B, 2] int32: (n_valid, n_anchors_total)

        is_start encodes the reference's chain-start test
        (pred.is_some() && f == curr_max, chain.rs:469) evaluated on
        device.  Anchor coordinates for the few anchors that end up in
        chains are re-derived host-side from the index arrays
        (native anchor_coords / _anchor_coords_host), so nothing else
        leaves the device (pred is capped at 2^17 = max_anchors_cap).
        """
        import jax.numpy as jnp

        wcodes, wvalid = window_kmer_codes(codes, lens, k)
        anchors = lookup_and_materialize_anchors(
            dindex, wcodes, wvalid, a_max, position_gather=position_gather
        )
        scores = chain_scores(
            anchors.qb, anchors.tb, anchors.te, anchors.valid,
            gap_table, seed_length=k, bandwidth=bandwidth, precision=precision,
        )
        is_start = (
            scores.valid
            & (scores.pred != -1)
            & (scores.f == scores.curr_max[:, None])
        )
        if bandwidth < 127:
            # predecessors live within the DP's `bandwidth`-slot window
            # (chain.rs:403-417), so the pointer fits 7 bits as a slot
            # DELTA — one uint8 per anchor halves the dominant
            # device->host payload of the map stage.  0 = no
            # predecessor; bit 7 = is_start.
            slot = jnp.arange(a_max, dtype=jnp.int32)[None, :]
            delta = jnp.where(scores.pred >= 0, slot - scores.pred, 0)
            packed = (delta | (is_start.astype(jnp.int32) << 7)).astype(
                jnp.uint8
            )
        elif a_max <= 16384:
            packed = (
                (scores.pred + 1) | (is_start.astype(jnp.int32) << 15)
            ).astype(jnp.uint16)
        else:
            packed = (scores.pred + 1) | (is_start.astype(jnp.int32) << 17)
        counts = jnp.stack(
            [
                jnp.sum(scores.valid, axis=1).astype(jnp.int32),
                anchors.n_anchors.astype(jnp.int32),
            ],
            axis=1,
        )
        return packed, counts

    @staticmethod
    @partial(jax.jit, static_argnames=("k", "a_max", "bandwidth", "precision"))
    def _device_map(codes, lens, dindex, gap_table, k, a_max, bandwidth,
                    precision="exact"):
        return Mapper._map_core(
            codes, lens, dindex, gap_table, k, a_max, bandwidth, precision
        )

    @staticmethod
    def _device_map_sharded(mesh, codes, lens, dindex, gap_table, k, a_max,
                            bandwidth, precision="exact"):
        """Offset-sharded index variant (SPMD over the mesh): the
        position table (fo_start/fo_end — the index's dominant memory at
        pangenome scale, the in-RAM analog is index.rs:37-90) lives
        SHARDED along the data axis, one contiguous row range per
        device; everything else (code table, counts/offsets, dense LUT)
        stays replicated.  Each device gathers the rows it owns for the
        whole of its read shard's anchor slots and a psum over the data
        axis assembles the full rows — the only collective in the
        mapping step, at the batch boundary.  Bit-identical packed
        output to the replicated path."""
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        index_specs = type(dindex)(
            kmer_codes=P(), fo_offsets=P(), fo_counts=P(),
            fo_start=P("data"), fo_end=P("data"), node_starts=P(),
            dense_lut=None if dindex.dense_lut is None else P(),
        )

        def step(codes_l, lens_l, dindex_l, gap_table_l):
            import jax.numpy as jnp

            shard_len = dindex_l.fo_start.shape[0]
            lo = jax.lax.axis_index("data").astype(jnp.int32) * shard_len

            def pgather(rows, valid):
                # Distributed gather: all_gather every device's row
                # indices, contribute the rows THIS shard owns for the
                # whole batch, then psum_scatter hands each device back
                # exactly its own reads' rows (tile order == device
                # order == batch shard order).  `valid` is deliberately
                # unused — invalid slots must read row 0 exactly like
                # the replicated gather (table_row is already 0 there),
                # or the chaining DP's stable sort by target_end would
                # order the padding slots differently and permute every
                # predecessor index.
                del valid
                r_all = jax.lax.all_gather(rows, "data", axis=0, tiled=True)
                local = r_all - lo
                ok = (local >= 0) & (local < shard_len)
                lc = jnp.clip(local, 0, shard_len - 1)
                tb = jnp.where(ok, dindex_l.fo_start[lc], 0)
                te = jnp.where(ok, dindex_l.fo_end[lc], 0)
                tb = jax.lax.psum_scatter(
                    tb, "data", scatter_dimension=0, tiled=True
                )
                te = jax.lax.psum_scatter(
                    te, "data", scatter_dimension=0, tiled=True
                )
                return tb, te

            return Mapper._map_core(
                codes_l, lens_l, dindex_l, gap_table_l, k, a_max,
                bandwidth, precision, position_gather=pgather,
            )

        # keyed on the mesh's stable identity (device ids + axis names),
        # not id(mesh): a GC'd Mesh's address can be reused by a new
        # Mesh, which would return an executable bound to dead devices
        mesh_key = (
            tuple(d.id for d in mesh.devices.flat),
            tuple(mesh.axis_names),
            mesh.devices.shape,
        )
        key = (mesh_key, k, a_max, bandwidth, precision,
               dindex.dense_lut is None)
        fn = _SHARDED_MAP_CACHE.get(key)
        if fn is None:
            fn = jax.jit(shard_map(
                step,
                mesh=mesh,
                in_specs=(P("data"), P("data"), index_specs, P()),
                out_specs=(P("data"), P("data")),
                check_vma=False,
            ))
            _SHARDED_MAP_CACHE[key] = fn
        return fn(codes, lens, dindex, gap_table)

    @staticmethod
    @partial(jax.jit, static_argnames=("B", "L", "k", "a_max", "bandwidth",
                                       "precision"))
    def _device_map_wire(wire, B, L, dindex, gap_table, k, a_max, bandwidth,
                         precision="exact"):
        """Single-buffer variant of _device_map: codes[B,L] int8 and
        lens[B] int32 arrive as ONE uint8 buffer (device_put pays
        per-buffer cost), unpacked by static slicing
        + bitcast.  Layout must match the packer in _dispatch_bucket."""
        codes = jax.lax.bitcast_convert_type(
            wire[: B * L], jnp.int8
        ).reshape(B, L)
        lens = jax.lax.bitcast_convert_type(
            wire[B * L :].reshape(B, 4), jnp.int32
        )
        packed, counts = Mapper._map_core(
            codes, lens, dindex, gap_table, k, a_max, bandwidth, precision
        )
        # outputs ride back as ONE buffer too: u8 plane rows + bitcast
        # counts tail.
        # Only the u8 (delta) plane qualifies — u16/i32 planes keep the
        # two-output layout (bitcasting them to u8 is fine, but they
        # only occur for bandwidth >= 127, off the production path).
        if packed.dtype == jnp.uint8:
            flat = jnp.concatenate([
                packed.reshape(-1),
                jax.lax.bitcast_convert_type(counts, jnp.uint8).reshape(-1),
            ])
            return flat, None
        return packed, counts

    # ---- public API ----------------------------------------------------

    def _anchor_totals(self, seqs: Sequence[str]) -> np.ndarray:
        """Exact anchor count per read, batch-vectorized on host numpy.

        One searchsorted over the whole batch's window codes; used to
        bucket reads by anchor capacity so one repetitive read does not
        inflate the scan length and transfer size of the entire batch.
        """
        from ..native import available as _native_ok

        if _native_ok():
            from ..native import count_anchors_native

            return count_anchors_native(
                seqs, self.index.kmer_codes, self.index.fo_counts,
                self.index.kmer_length, lut=self.index.host_lut(),
            )
        k = self.index.kmer_length
        l_pad = max(max(len(s) for s in seqs), k)
        codes, lens = encode_reads_host(seqs, l_pad)
        B, W = len(seqs), l_pad - k + 1
        w = np.zeros((B, W), dtype=np.int64)
        ok = np.ones((B, W), dtype=bool)
        c64 = codes.astype(np.int64)
        for j in range(k):
            b = c64[:, j : j + W]
            ok &= b < 4
            w = (w << 2) | np.where(b < 4, b, 0)
        ok &= (np.arange(W)[None, :] + k) <= lens[:, None]
        n = len(self.index.kmer_codes)
        g = np.searchsorted(self.index.kmer_codes, w.ravel()).reshape(B, W)
        gc = np.minimum(g, max(n - 1, 0))
        found = ok & (g < n) & (self.index.kmer_codes[gc] == w)
        return np.where(found, self.index.fo_counts[gc], 0).sum(axis=1)

    def map_reads(self, queries: Sequence[QuerySequence]) -> List[List[Chain]]:
        """Chains per query, in input order (map.rs:56-111).

        With both_strands (extension — the reference's production path
        is forward-only, map.rs:62): each read and its reverse
        complement are mapped in ONE combined device pass; per read the
        strand whose (untruncated) best chain has the higher recomputed
        DP score wins, ties and all-placeholder going to forward so
        forward-strand reads behave exactly as without the flag.
        Winning reverse chains are marked strand="-" (GAF emission
        flips coordinates back to the original read)."""
        return self.finish_map(self.begin_map(queries))

    def begin_map(self, queries: Sequence[QuerySequence]):
        """Host-side prep + device dispatch for a batch, WITHOUT
        blocking on device results.  Pair with finish_map:
        map_reads(q) == finish_map(begin_map(q)).

        The split exists for the software-pipelined map stream
        (models/stream.py): batch N's device program runs while
        finish_map(N) blocks in device_get on a worker thread —
        overlapping it with begin_map(N+1)'s host encode on the main
        thread."""
        if not self.both_strands:
            return (queries, None, self._begin_oriented(queries))
        from ..utils.dna import reverse_complement

        rc = [
            QuerySequence(name=q.name, seq=reverse_complement(q.seq))
            for q in queries
        ]
        return (
            queries, len(queries),
            self._begin_oriented(list(queries) + rc),
        )

    def finish_map(self, state) -> List[List[Chain]]:
        """Drain + decode a begin_map batch (see begin_map)."""
        queries, n, ostate = state
        both = self._finish_oriented(ostate)
        if n is None:
            out = both
        else:
            out = []
            for i in range(n):
                fwd, rev = both[i], both[n + i]
                f_real = not fwd[0].is_placeholder
                r_real = not rev[0].is_placeholder
                take_rev = r_real and (
                    not f_real
                    or chain_dp_score(rev[0], self.max_gap)
                    > chain_dp_score(fwd[0], self.max_gap)
                )
                if take_rev:
                    for c in rev:
                        c.strand = "-"
                    out.append(rev)
                else:
                    out.append(fwd)
        if self.mapq:
            for chains in out:
                assign_mapq(chains)
        return out

    def _map_oriented(self, queries: Sequence[QuerySequence]) -> List[List[Chain]]:
        """One mapping pass over the given query orientations."""
        return self._finish_oriented(self._begin_oriented(queries))

    def _begin_oriented(self, queries: Sequence[QuerySequence]):
        """Dispatch half of _map_oriented: placeholder/overflow
        handling, bucketing, host encode, and the async device launch.
        Returns an opaque state for _finish_oriented."""
        log.info("Found %d reads!", len(queries))
        k = self.index.kmer_length
        out: List[List[Chain]] = [None] * len(queries)  # type: ignore

        mappable = [i for i, q in enumerate(queries) if len(q.seq) >= k]
        for i, q in enumerate(queries):
            if len(q.seq) < k:
                out[i] = [Chain(query=q, is_placeholder=True)]

        if not mappable:
            return (queries, out, "done", None)

        with self.timer.phase("count"):
            totals = self._anchor_totals([queries[i].seq for i in mappable])

        # reads whose anchor count exceeds the device bucket cap are mapped
        # on host with the exact unbounded native chainer — reference
        # semantics (unbounded anchor list) with no truncation
        overflow = [
            (local, qi)
            for local, qi in enumerate(mappable)
            if totals[local] > self.max_anchors_cap
        ]
        if overflow:
            log.info(
                "%d reads exceed the %d-anchor device cap; mapping them "
                "host-side (exact, unbounded)",
                len(overflow), self.max_anchors_cap,
            )
            ov_set = set(local for local, _ in overflow)
            for _, qi in overflow:
                out[qi] = self._map_read_overflow(queries[qi])
            mappable = [qi for local, qi in enumerate(mappable) if local not in ov_set]
            totals = np.asarray(
                [t for local, t in enumerate(totals) if local not in ov_set],
                dtype=totals.dtype,
            )
            if not mappable:
                return (queries, out, "done", None)

        from ..ops.poa_device import wire_bitcast_supported

        big = int(totals.max())
        big_a_max = min(max(_next_pow2(max(big, 1)), 256), self.max_anchors_cap)
        use_fused = (
            self.mesh is None
            and self.bandwidth < 127  # u8 delta plane guaranteed
            and wire_bitcast_supported()
        )
        buckets: dict = {}
        for local, qi in enumerate(mappable):
            t = int(totals[local])
            if use_fused:
                # {64,128,256,big} ladder: with the fused single-launch
                # drain below, extra buckets cost no transfers, and a
                # smaller a_max means ~linearly less DP/lookup/transfer
                # for the majority of reads
                a_max = 64 if t <= 64 else (128 if t <= 128 else (
                    256 if t <= 256 else big_a_max))
            else:
                # two buckets: every extra bucket costs its own transfers
                # on the unfused paths (mesh, no-bitcast)
                a_max = 256 if t <= 256 else big_a_max
            buckets.setdefault(a_max, []).append(qi)

        if use_fused:
            return (
                queries, out, "fused",
                self._map_buckets_fused_begin(queries, buckets),
            )
        # dispatch every bucket's device program; _finish_oriented
        # drains all results in ONE device_get (bucket outputs are first
        # concatenated on device into one flat buffer per dtype, see
        # _fetch_bucket_outputs)
        dispatched = []
        for a_max, qidx in sorted(buckets.items()):
            dispatched.append(self._dispatch_bucket(queries, qidx, a_max))
        return (queries, out, "buckets", dispatched)

    def _finish_oriented(self, state) -> List[List[Chain]]:
        """Blocking half of _map_oriented: device fetch, backtrack,
        coordinate re-derivation, Chain emission."""
        queries, out, mode, payload = state
        if mode == "done":
            return out
        if mode == "fused":
            pending = self._map_buckets_fused_finish(*payload)
        else:
            dispatched = payload
            with self.timer.phase("gather"):
                fetched = _fetch_bucket_outputs(
                    [(d[1], d[2], d[3]) for d in dispatched]
                )
            pending = [
                self._collect_bucket(d[0], d[1], pc[0], pc[1])
                for d, pc in zip(dispatched, fetched)
            ]
        self._finalize_chains(queries, pending, out)
        return out

    def _map_buckets_fused_begin(self, queries, buckets: dict):
        """Dispatch half of the fused-bucket map: ONE device_put + ONE
        executable launch (see _fused_map_fn); the device_get happens
        in _map_buckets_fused_finish."""
        import jax.numpy as jnp

        from ..ops.poa_device import _ladder_bytes

        k = self.index.kmer_length
        plan = []  # (qidx, B, L, a_max, wsize)
        segs: List[np.ndarray] = []
        with self.timer.phase("encode"):
            for a_max, qidx in sorted(buckets.items()):
                seqs = [queries[i].seq for i in qidx]
                l_pad = _next_pow2(max(max(len(s) for s in seqs), k))
                codes, lens = encode_reads_host(seqs, l_pad)
                b_pow2 = _next_pow2(max(codes.shape[0], 8))
                if b_pow2 != codes.shape[0]:
                    codes = np.pad(
                        codes, ((0, b_pow2 - codes.shape[0]), (0, 0)),
                        constant_values=4,
                    )
                    lens = np.pad(lens, (0, b_pow2 - lens.shape[0]))
                seg = np.concatenate([
                    codes.reshape(-1).view(np.uint8),
                    lens.astype(np.int32).view(np.uint8),
                ])
                wsize = _ladder_bytes(len(seg))
                if wsize != len(seg):
                    seg = np.concatenate(
                        [seg, np.zeros(wsize - len(seg), np.uint8)]
                    )
                plan.append((qidx, b_pow2, l_pad, a_max, wsize))
                segs.append(seg)
        layout = tuple((B, L, a, w) for _q, B, L, a, w in plan)
        fn = _fused_map_fn(layout, k, self.bandwidth, self.precision)
        with self.timer.phase("device_map"):
            mega = np.concatenate(segs)
            out_d = fn(jnp.asarray(mega), self.dindex, self._gap_table_dev)
        return plan, out_d

    def _map_buckets_fused_finish(self, plan, out_d):
        """Drain half of the fused-bucket map: ONE device_get + the
        native backtrack.  Returns collected
        (mappable, a_max, per_read_chains) tuples per bucket."""
        with self.timer.phase("gather"):
            flat = np.asarray(out_d)
        pending = []
        off = 0
        for qidx, B, _L, a_max, _w in plan:
            plane = flat[off : off + B * a_max].reshape(B, a_max)
            off += B * a_max
            counts = flat[off : off + B * 8].view(np.int32).reshape(B, 2)
            off += B * 8
            pending.append(self._collect_bucket(qidx, a_max, plane, counts))
        return pending

    def _map_read_overflow(self, query: QuerySequence) -> List[Chain]:
        """Exact unbounded host mapping for a read whose anchor count
        exceeds the device bucket cap (reference semantics: the anchor
        list is unbounded, chain.rs:134-173).  Native when available,
        scalar Python otherwise."""
        from ..native import available as _native_ok

        if _native_ok():
            from ..native import map_read_chains_native

            triples = map_read_chains_native(
                self.index, query.seq, self.bandwidth, self.max_gap,
                self.chain_min_n_anchors,
            )
            chains = [
                Chain(query=query, aqb=qb, atb=tb, ate=te,
                      k=self.index.kmer_length)
                for qb, tb, te in triples
            ]
        else:
            from .host_pipeline import map_read_host

            id_chains, _, anchors = map_read_host(
                self.index, query.seq, self.bandwidth, self.max_gap,
                self.chain_min_n_anchors,
            )
            by_id = {a.id: a for a in anchors}
            chains = []
            for ids in id_chains:
                mem = [by_id[i] for i in ids]
                chains.append(Chain(
                    query=query,
                    aqb=np.asarray([a.qb for a in mem], dtype=np.int64),
                    atb=np.asarray([a.tb for a in mem], dtype=np.int64),
                    ate=np.asarray([a.te for a in mem], dtype=np.int64),
                    k=self.index.kmer_length,
                ))
        if not chains:
            return [Chain(query=query, is_placeholder=True)]
        return chains

    def _dispatch_bucket(self, queries, qidx: List[int], a_max: int):
        k = self.index.kmer_length
        mappable = qidx
        seqs = [queries[i].seq for i in mappable]
        l_pad = _next_pow2(max(max(len(s) for s in seqs), k))

        with self.timer.phase("encode"):
            codes, lens = encode_reads_host(seqs, l_pad)
        # pad the batch dimension to a power of two so executables are
        # cached across batches with varying bucket occupancy
        b_pow2 = _next_pow2(max(codes.shape[0], 8))
        if b_pow2 != codes.shape[0]:
            codes = np.pad(
                codes, ((0, b_pow2 - codes.shape[0]), (0, 0)), constant_values=4
            )
            lens = np.pad(lens, (0, b_pow2 - lens.shape[0]))
        import jax.numpy as jnp

        if self.mesh is not None:
            # data-parallel: pad rows to the mesh size and shard along reads
            from ..parallel.mesh import pad_batch_to_multiple, shard_batch

            nd = self.mesh.devices.size
            b_pad = pad_batch_to_multiple(codes.shape[0], nd)
            if b_pad != codes.shape[0]:
                codes = np.pad(codes, ((0, b_pad - codes.shape[0]), (0, 0)), constant_values=4)
                lens = np.pad(lens, (0, b_pad - lens.shape[0]))
            codes_d, lens_d = shard_batch(self.mesh, jnp.asarray(codes), jnp.asarray(lens))
            with self.timer.phase("device_map"):
                if self.shard_index:
                    packed_d, counts_d = self._device_map_sharded(
                        self.mesh, codes_d, lens_d, self.dindex,
                        self._gap_table_dev, k, a_max, self.bandwidth,
                        self.precision,
                    )
                else:
                    packed_d, counts_d = self._device_map(
                        codes_d, lens_d, self.dindex, self._gap_table_dev,
                        k, a_max, self.bandwidth, self.precision,
                    )
            return mappable, a_max, packed_d, counts_d

        from ..ops.poa_device import pack_wire, wire_bitcast_supported

        with self.timer.phase("device_map"):
            if wire_bitcast_supported():
                # ONE device_put per bucket launch instead of two
                B, L = codes.shape
                wire = pack_wire(((codes, np.int8), (lens, np.int32)))
                packed_d, counts_d = self._device_map_wire(
                    jnp.asarray(wire), B, L, self.dindex, self._gap_table_dev,
                    k, a_max, self.bandwidth, self.precision,
                )
            else:
                packed_d, counts_d = self._device_map(
                    jnp.asarray(codes), jnp.asarray(lens), self.dindex,
                    self._gap_table_dev, k, a_max, self.bandwidth,
                    self.precision,
                )
        return mappable, a_max, packed_d, counts_d

    def _collect_bucket(self, mappable, a_max, packed, counts):
        from ..native import available as _native_ok

        with self.timer.phase("backtrack"):
            triple = None
            if packed.dtype == np.uint8 and _native_ok():
                # walk the u8 delta plane directly (native, GIL
                # released) — the int32 decode below materializes ~4x
                # the plane in numpy temporaries per batch.  The walk
                # nulls predecessors in place, so copy: the fetched
                # buffer may be a zero-copy view of the device output
                from ..native import backtrack_delta_native

                plane = np.array(packed[: len(mappable)], dtype=np.uint8)
                triple = backtrack_delta_native(
                    plane, counts[: len(mappable), 0],
                    self.chain_min_n_anchors,
                )
            else:
                arr = packed.astype(np.int32)
                if packed.dtype == np.uint8:
                    # delta plane (see _device_map): 0 = none, bit 7 start
                    delta = arr & 0x7F
                    slot = np.arange(arr.shape[1], dtype=np.int32)[None, :]
                    pred = np.where(delta > 0, slot - delta, -1)
                    starts = (arr >> 7) & 1
                else:
                    shift = 15 if packed.dtype == np.uint16 else 17
                    pred = (arr & ((1 << shift) - 1)) - 1
                    starts = (arr >> shift) & 1
                if _native_ok():
                    from ..native import backtrack_native

                    triple = backtrack_native(
                        pred[: len(mappable)],
                        starts[: len(mappable)].astype(np.uint8),
                        counts[: len(mappable), 0],
                        self.chain_min_n_anchors,
                    )

            # pointer walks, visiting only chain-start anchors
            per_read_chains: List[List[List[int]]] = []
            if triple is not None:
                read_off, chain_off, positions = triple
                for b in range(len(mappable)):
                    per_read_chains.append([
                        positions[chain_off[c] : chain_off[c + 1]].tolist()
                        for c in range(read_off[b], read_off[b + 1])
                    ])
            else:
                for b in range(len(mappable)):
                    per_read_chains.append(
                        self._backtrack_positions(pred[b], starts[b], int(counts[b, 0]))
                    )

        return mappable, a_max, per_read_chains

    def _finalize_chains(self, queries, pending, out) -> None:
        """Re-derive chain-member coordinates host-side from the index
        arrays (no device round trip) and build Chain objects."""
        from ..native import available as _native_ok

        k = self.index.kmer_length
        with self.timer.phase("coords"):
            # flatten all buckets' members into one coords call
            read_ids: List[int] = []
            read_amax: List[int] = []
            mem_counts: List[int] = []
            slot_parts: List[np.ndarray] = []
            for mappable, a_max, per_read_chains in pending:
                for b, read_chains in enumerate(per_read_chains):
                    n_mem = sum(len(c) for c in read_chains)
                    if n_mem:
                        read_ids.append(mappable[b])
                        read_amax.append(a_max)
                        mem_counts.append(n_mem)
                        slot_parts.append(
                            np.concatenate([
                                np.asarray(c, dtype=np.int32)
                                for c in read_chains
                            ])
                        )
            qb = tb = te = np.zeros(0, dtype=np.int64)
            if read_ids:
                mem_off = np.zeros(len(read_ids) + 1, dtype=np.int64)
                np.cumsum(mem_counts, out=mem_off[1:])
                mem_slots = np.concatenate(slot_parts)
                a_max_arr = np.asarray(read_amax, dtype=np.int64)
                seqs = [queries[i].seq for i in read_ids]
                if _native_ok():
                    from ..native import anchor_coords_native

                    qb, tb, te = anchor_coords_native(
                        seqs, self.index, a_max_arr, mem_off, mem_slots
                    )
                else:
                    qb, tb, te = _anchor_coords_host(
                        seqs, self.index, a_max_arr, mem_off, mem_slots
                    )

        with self.timer.phase("emit"):
            flat = 0
            for mappable, _a_max, per_read_chains in pending:
                for b, qi in enumerate(mappable):
                    chains: List[Chain] = []
                    for chain in per_read_chains[b]:
                        n = len(chain)
                        chains.append(
                            Chain(
                                query=queries[qi],
                                aqb=qb[flat : flat + n],
                                atb=tb[flat : flat + n],
                                ate=te[flat : flat + n],
                                k=k,
                            )
                        )
                        flat += n
                    if not chains:
                        chains.append(Chain(query=queries[qi], is_placeholder=True))
                    out[qi] = chains

    def _backtrack_positions(self, pred, starts, n: int) -> List[List[int]]:
        """Reference backtrack (chain.rs:464-557) over sorted positions.

        `starts[i]` encodes (pred != -1 and f == curr_max) computed on
        device; the walk nulls predecessors so shared prefixes truncate at
        (but include) already-consumed anchors, exactly as the reference.
        Only start positions are visited (descending, like the reference's
        full scan — non-start positions can never open a chain).  Returns
        ascending position lists per surviving chain, in discovery order
        (the reference's by-score sort is a stable no-op, score 0).
        """
        chains: List[List[int]] = []
        start_positions = np.nonzero(starts[:n])[0]
        for i in start_positions[::-1]:
            if pred[i] != -1:
                positions: List[int] = []
                cur = int(i)
                while pred[cur] != -1:
                    p = int(pred[cur])
                    pred[cur] = -1
                    positions.append(cur)
                    cur = p
                positions.append(cur)
                if len(positions) >= self.chain_min_n_anchors:
                    positions.reverse()
                    chains.append(positions)
        return chains

    def chains_to_gaf(self, per_read_chains: List[List[Chain]]) -> List[GAFAlignment]:
        """map.rs:123-133."""
        records: List[GAFAlignment] = []
        for chains in per_read_chains:
            for c in chains:
                if c.is_placeholder:
                    records.append(GAFAlignment.from_placeholder_chain(c))
                else:
                    records.append(GAFAlignment.from_chain(c, self.index))
        return records

    def chains_gaf_text(self, per_read_chains: List[List[Chain]]) -> bytes:
        """The chains-GAF rows as one text blob — byte-identical to
        joining chains_to_gaf's to_string()s, assembled natively in one
        pass when the runtime is built (the per-row from_chain path was
        the map stream's largest remaining host phase: ~770 ms per
        4,096-read DRB1 batch vs ~35 ms native).  map.rs:123-145."""
        from ..native import chains_gaf_blob_native

        with self.timer.phase("gaf"):
            blob = chains_gaf_blob_native(per_read_chains, self.index)
            if blob is None:
                blob = "".join(
                    r.to_string() for r in self.chains_to_gaf(per_read_chains)
                ).encode("ascii")
        return blob
