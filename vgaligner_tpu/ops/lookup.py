"""Device-side k-mer lookup and anchor materialization.

Behavioral reference: anchors_for_query (rs-vgaligner src/chain.rs:
134-173) + find_positions_for_query_kmer (index.rs:353-382).  The
reference does, per query k-mer: a hash, an O(n_kmers) membership scan,
an MPHF probe, and a delimiter walk.  Here the whole batch does one
vectorized binary search against the sorted code table and one gather
from the forward-only position sub-table (the production path always
passes only_forward=true, map.rs:62, so that filter is baked into the
table at build time).

Anchor order matches the reference exactly: ascending query k-mer
index, then index-table position order (which is the per-k-mer sorted
position order of kmer.rs:892-894).  The anchor id is its slot number
in this order (chain.rs:146-166).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..index.build import DeviceIndex


class AnchorBatch(NamedTuple):
    """Per-read anchor arrays in *generation order* (id order), padded to
    a static A_max.  qe = qb + k always (anchors are single k-mers)."""

    qb: jnp.ndarray  # [B, A] int32 query begin
    tb: jnp.ndarray  # [B, A] int64 target begin (forward linearization)
    te: jnp.ndarray  # [B, A] int64 target end (exclusive)
    valid: jnp.ndarray  # [B, A] bool
    n_anchors: jnp.ndarray  # [B] int32 true anchor count (pre-truncation)


def lookup_and_materialize_anchors(
    index: DeviceIndex,
    wcodes: jnp.ndarray,
    wvalid: jnp.ndarray,
    a_max: int,
    position_gather=None,
) -> AnchorBatch:
    """wcodes/wvalid: [B, W] from window_kmer_codes.

    position_gather: optional (table_row [B,A] i32, valid [B,A] bool) ->
    (tb, te) override for the position-table gather — the
    offset-sharded index path (parallel/mesh.py shard_index) resolves
    rows against per-device table shards with a psum."""
    n_kmers = index.kmer_codes.shape[0]

    if index.dense_lut is not None:
        # direct-address lookup: one gather per window.  searchsorted's
        # ~17 binary-search gather steps measured 226 ms of the 255 ms
        # mapping program on the bench workload; this path runs them as
        # a single [B, W] gather from the 4^k table.
        space = index.dense_lut.shape[0]
        wc = jnp.clip(wcodes, 0, space - 1)
        g_clip = index.dense_lut[wc]  # [B, W], -1 = absent
        found = wvalid & (g_clip >= 0)
        g_clip = jnp.maximum(g_clip, 0)
    else:
        g = jnp.searchsorted(index.kmer_codes, wcodes)  # [B, W]
        g_clip = jnp.minimum(g, n_kmers - 1)
        found = wvalid & (g < n_kmers) & (index.kmer_codes[g_clip] == wcodes)
    counts = jnp.where(found, index.fo_counts[g_clip], 0).astype(jnp.int32)  # [B, W]
    offsets = index.fo_offsets[g_clip]  # [B, W]

    cum = jnp.cumsum(counts, axis=1)  # [B, W]
    total = cum[:, -1] if cum.shape[1] else jnp.zeros(cum.shape[0], jnp.int32)

    # slot a -> (kmer window w, within-kmer position): window w's anchors
    # occupy slots [cum[w-1], cum[w]), so the owning window of slot s is
    # the count of windows with cum[w] <= s: a dense [B, W, A] compare +
    # reduce in place of a scatter-max + cummax formulation.
    B, W = counts.shape
    cum_prev = cum - counts  # run start per window
    slots = jnp.arange(a_max, dtype=jnp.int32)
    w_of = jnp.sum(
        (cum[:, :, None] <= slots[None, None, :]).astype(jnp.int32), axis=1
    )  # [B, A]

    valid = slots[None, :] < total[:, None]
    w_clip = jnp.clip(w_of, 0, max(W - 1, 0))
    # one fused take_along_axis: row = (offsets - run_start)[w] + slot
    row_base = offsets.astype(jnp.int32) - cum_prev
    table_row = jnp.take_along_axis(row_base, w_clip, axis=1) + slots[None, :]
    table_row = jnp.where(valid, table_row, 0)
    if position_gather is not None:
        tb, te = position_gather(table_row, valid)
    else:
        tb = index.fo_start[table_row]
        te = index.fo_end[table_row]
    qb = w_clip.astype(jnp.int32)

    return AnchorBatch(qb=qb, tb=tb, te=te, valid=valid, n_anchors=total)
