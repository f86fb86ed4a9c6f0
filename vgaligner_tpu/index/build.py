"""The k-mer index: build, query, (de)serialization, device arrays.

Behavioral reference: /root/reference/src/index.rs (struct Index,
Index::build, query and graph-accessor methods) and
src/serialization.rs.

Device re-design decisions:

* {ahash + boomphf MPHF + `kmer_pos_ref` membership scan}
  (index.rs:229-236, 319) → one sorted array of 2-bit-packed k-mer codes
  plus (offset, count) per unique k-mer.  Exact-match lookup is a binary
  search; on device it is a vectorized `jnp.searchsorted`.  Because
  ASCII 'A'<'C'<'G'<'T' matches code order 0<1<2<3, the sorted-by-
  sequence k-mer order of the reference *is* the sorted-code order.
* The node-start bitvector + O(L) rank/select loops (index.rs:427-480)
  → `node_starts` prefix array; rank = searchsorted, select = lookup.
* The delimiter-flattened `kmer_pos_table` (kmer.rs:901-923) → explicit
  (offset, count); additionally a pre-filtered forward-only sub-table is
  materialized at build time because the production mapping path always
  uses only_forward=true (map.rs:62, chain.rs:154).
* bincode `.idx` → a single compressed `.idx.npz` of the arrays.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from ..graph.handlegraph import (
    HashGraph,
    handle_flip,
    handle_id,
    handle_is_reverse,
    handle_pack,
)
from ..graph.linearize import find_forward_sequence, find_graph_seq_length
from ..utils.dna import encode_seq, reverse_complement
from .kmer_gen import FORWARD, REVERSE, generate_kmers, generate_pos_on_ref

log = logging.getLogger(__name__)


def _merge_kmer_tables(c1, o1, n1, p1, c2, o2, n2, p2):
    """Merge a secondary (code -> position rows) table into the primary.

    Used only by the path-guided DFS-cap fallback (Index.build): rows of
    a code already present are set-unioned (primary's internal row
    multiplicities preserved — the reference's fork-field dedup quirk
    can legitimately leave duplicates); new codes are inserted in sorted
    order.  Per-group rows stay sorted by the (so, start, eo, end)
    tuple order of generate_pos_on_ref.
    """
    def _pack_layout(ca, ra, cb, rb):
        """Shared packed-int64 layout for (code, so, start, eo, end)
        rows across both tables, or None when the field widths exceed
        63 bits (only for k > ~20 on megabase linearizations).  Packed
        keys make every set op scalar AND globally sorted (codes sorted
        + per-group tuple order), which the fast merge path exploits."""
        maxs = np.zeros(5, dtype=np.int64)
        neg = False
        for c, r in ((ca, ra), (cb, rb)):
            if len(r):
                maxs = np.maximum(
                    maxs,
                    np.concatenate([[c.max()], r.max(axis=0)]),
                )
                neg = neg or int(c.min()) < 0 or int(r.min()) < 0
        if neg:
            return None
        bits = [max(int(m).bit_length(), 1) for m in maxs]
        if sum(bits) > 63:
            return None

        def pack(codes, rows):
            key = np.ascontiguousarray(codes, dtype=np.int64).copy()
            for j in range(4):
                key <<= bits[j + 1]
                key |= np.ascontiguousarray(rows[:, j], dtype=np.int64)
            return key

        return pack

    # gather table-2 rows group-contiguously (o2 may be non-contiguous
    # when the caller filtered groups out), fully vectorized
    if len(c2):
        row_idx = np.repeat(o2, n2) + (
            np.arange(int(n2.sum())) - np.repeat(np.cumsum(n2) - n2, n2)
        )
        rows2 = p2[row_idx]
    else:
        rows2 = np.zeros((0, 4), np.int64)
    code2_per_row = np.repeat(c2, n2)

    if len(c1) == 0:
        offsets2 = np.concatenate([[0], np.cumsum(n2)[:-1]]).astype(np.int64)
        return c2.copy(), offsets2, n2.astype(np.int64).copy(), rows2

    code1_per_row = np.repeat(c1, n1)
    pack = _pack_layout(code1_per_row, p1, code2_per_row, rows2)
    if pack is not None:
        # fast path: packed keys are GLOBALLY sorted for table 1 (codes
        # ascending, rows in tuple order within each group), so the
        # whole merge is one searchsorted + one np.insert — the
        # per-merge-event Python splice below walked ~800k groups on
        # MICB (40s+)
        keyed1 = pack(code1_per_row, p1)
        keyed2 = pack(code2_per_row, rows2)
        fresh_mask = ~np.isin(keyed2, keyed1)
        if not fresh_mask.any():
            return c1, o1, n1, p1
        fk, fidx = np.unique(keyed2[fresh_mask], return_index=True)
        fresh_rows = rows2[fresh_mask][fidx]
        fresh_codes = code2_per_row[fresh_mask][fidx]

        uniq_codes, fresh_counts = np.unique(fresh_codes, return_counts=True)
        g1 = np.searchsorted(c1, uniq_codes)
        g1c = np.minimum(g1, len(c1) - 1)
        exists = c1[g1c] == uniq_codes
        n_out = n1.astype(np.int64).copy()
        n_out[g1[exists]] += fresh_counts[exists]
        c_out = np.insert(c1, g1[~exists], uniq_codes[~exists]).astype(np.int64)
        n_out = np.insert(n_out, g1[~exists], fresh_counts[~exists])
        o_out = np.concatenate([[0], np.cumsum(n_out)[:-1]]).astype(np.int64)
        p_out = np.insert(p1, np.searchsorted(keyed1, fk), fresh_rows, axis=0)
        return c_out, o_out, n_out.astype(np.int64), p_out

    # void-view fallback for >63-bit field layouts
    def _full(codes_per_row: np.ndarray, rows: np.ndarray):
        full = np.concatenate([codes_per_row[:, None], rows], axis=1)
        return np.ascontiguousarray(full, dtype=np.int64)

    def _void(full):
        return np.ascontiguousarray(full).view(
            [("", np.int64)] * 5
        ).reshape(-1)

    full2 = _full(code2_per_row, rows2)
    full1 = _full(code1_per_row, p1)
    keyed1, keyed2 = _void(full1), _void(full2)

    # additions = unique table-2 rows absent from table 1
    fresh_mask = ~np.isin(keyed2, keyed1)
    fresh = np.unique(full2[fresh_mask], axis=0) if fresh_mask.any() else full2[:0]
    if len(fresh) == 0:
        return c1, o1, n1, p1

    fresh_codes = fresh[:, 0]
    uniq_codes, first_idx, fresh_counts = np.unique(
        fresh_codes, return_index=True, return_counts=True
    )
    g1_of = np.searchsorted(c1, uniq_codes)
    g1_clip = np.minimum(g1_of, len(c1) - 1)
    exists = c1[g1_clip] == uniq_codes

    # assemble by splicing: copy untouched [row-span, group-span] blocks
    # of table 1 wholesale between merge events (augmented or new groups)
    out_codes: List[np.ndarray] = []
    out_counts: List[np.ndarray] = []
    pos_parts: List[np.ndarray] = []
    prev_g = 0
    for t in np.argsort(g1_of, kind="stable"):
        g = int(g1_of[t])
        rows_new = fresh[first_idx[t] : first_idx[t] + fresh_counts[t], 1:]
        if g > prev_g:
            out_codes.append(c1[prev_g:g])
            out_counts.append(n1[prev_g:g])
            pos_parts.append(p1[o1[prev_g] : o1[g - 1] + n1[g - 1]])
        if exists[t]:  # fresh_codes[first_idx[t]] == uniq_codes[t]
            merged = np.concatenate(
                [p1[o1[g] : o1[g] + n1[g]], rows_new]
            )
            order = np.lexsort(merged.T[::-1])
            out_codes.append(c1[g : g + 1])
            out_counts.append(np.asarray([len(merged)], dtype=n1.dtype))
            pos_parts.append(merged[order])
            prev_g = g + 1
        else:
            out_codes.append(fresh_codes[first_idx[t] : first_idx[t] + 1])
            out_counts.append(np.asarray([len(rows_new)], dtype=n1.dtype))
            pos_parts.append(rows_new)  # np.unique already sorted them
            prev_g = g
    if prev_g < len(c1):
        out_codes.append(c1[prev_g:])
        out_counts.append(n1[prev_g:])
        pos_parts.append(p1[o1[prev_g] :])

    codes = np.concatenate(out_codes)
    counts = np.concatenate(out_counts).astype(np.int64)
    positions = (
        np.concatenate(pos_parts) if pos_parts else np.zeros((0, 4), np.int64)
    )
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    return codes, offsets, counts, positions


class DeviceIndex(NamedTuple):
    """Replicated HBM-resident arrays consumed by the device kernels."""

    kmer_codes: "np.ndarray"  # int64 [n_kmers], sorted unique codes
    fo_offsets: "np.ndarray"  # int32 [n_kmers], into fo_* arrays
    fo_counts: "np.ndarray"  # int32 [n_kmers]
    # int32 when every linearized position fits (always, until a single
    # host's shard exceeds 2 GB of sequence) — the [B, A] position
    # gathers are the mapping kernel's hottest memory op and int64
    # doubles both their bytes and their emulated-op count; int64 only
    # for giant indexes
    fo_start: "np.ndarray"  # int32/int64 [n_fo_pos] forward-only starts
    fo_end: "np.ndarray"  # int32/int64 [n_fo_pos]
    node_starts: "np.ndarray"  # int64 [n_nodes + 1]
    # direct-address lookup table, int32 [4^k] code -> group id or -1.
    # Present when the code space fits the memory budget (k <= 12 by
    # default): one gather replaces the ~17 gather steps of the
    # binary-search lookup, which measured as the whole mapping
    # pipeline's dominant device cost.  None for large k.
    dense_lut: "Optional[np.ndarray]" = None


@dataclass
class Index:
    """Index over the k-mers of a variation graph (index.rs:30-90)."""

    kmer_length: int
    seq_length: int
    seq_fwd: str
    seq_rev: str
    node_starts: np.ndarray  # int64 [n_nodes + 1] (seq_bv equivalent)
    n_edges: int
    edges: np.ndarray  # int64 packed handles
    n_nodes: int
    edge_idx: np.ndarray  # int64 [n_nodes + 1]
    edges_to_node: np.ndarray  # int64 [n_nodes]
    # k-mer table
    n_kmers: int
    n_kmer_pos: int  # positions incl. one delimiter per kmer (reference metric)
    kmer_codes: np.ndarray  # int64 [n_kmers] sorted
    kmer_offsets: np.ndarray  # int64 [n_kmers] into `positions`
    kmer_counts: np.ndarray  # int64 [n_kmers]
    positions: np.ndarray  # int64 [n_pos, 4] (so, start, eo, end)
    sampling_rate: Optional[int]
    # forward-only sub-table (production mapping path, map.rs:62)
    fo_offsets: np.ndarray  # int64 [n_kmers]
    fo_counts: np.ndarray  # int64 [n_kmers]
    fo_positions: np.ndarray  # int64 [n_fo, 2] (start, end)
    loaded: bool = False

    # ---- build --------------------------------------------------------

    @classmethod
    def build(
        cls,
        graph: HashGraph,
        kmer_length: int,
        max_furcations: int = 100,
        max_degree: int = 100,
        out_prefix: Optional[str] = None,
        sampling_rate: Optional[int] = None,
        generate_mappings: bool = False,
        mappings_path: Optional[str] = None,
        state_cap: int = 500_000,
        n_policy: str = "drop-handle",
        dedup_positions: bool = True,
        modimizer: str = "ahash",
    ) -> "Index":
        """Build the index (Index::build, index.rs:109-281).

        n_policy controls N handling in the DFS k-mer generator:
        "drop-handle" (default) reproduces the reference's production
        DFS behavior of aborting the WHOLE handle+orientation on the
        first N-containing k-mer (kmer.rs:400-403), leaving every
        k-mer of an N-containing node unindexed; "drop-kmer" skips
        only k-mers that contain an N — the policy of the reference's
        own path-guided generator (kmer.rs:161-163).  Default is the
        reference quirk: parity, and measured no worse on the one
        N-containing HLA-zoo graph (4-A3105: drop-handle 0.885 vs
        drop-kmer 0.850 path Jaccard at 128 reads — unindexing the two
        N-run ~53 kb nodes removes their duplicate-allele ambiguity,
        see NOTES.md).

        dedup_positions (default True) drops EXACT duplicate position
        rows within a k-mer group (and lets the native DFS merge the
        equivalent fork-path states that generate them).  The
        reference intends this dedup ("exact duplicates only waste
        space", kmer.rs:299-301) but its adjacent-only Vec::dedup after
        a sort on seq alone misses non-adjacent records; on fork-dense
        HLA-zoo graphs that leaves ~100x duplicated rows (measured
        6.5M rows / 62k distinct on 5-B3106), blowing up both index
        build time and per-read anchor counts.  False restores the
        reference's literal quirk (--keep-duplicate-positions).
        """
        n_nodes = graph.n_nodes
        lin = find_forward_sequence(graph)
        seq_length = lin.seq_len
        assert seq_length == find_graph_seq_length(graph)

        if not np.array_equal(lin.node_ids, np.arange(1, n_nodes + 1)):
            raise ValueError(
                "node ids must be contiguous 1..n (the reference indexes "
                "NodeRef by id-1, index.rs:489-498)"
            )

        seq_rev = reverse_complement(lin.seq_fwd)

        if generate_mappings:
            from ..io.mappings import generate_json_mappings, store_mappings_in_file

            store_mappings_in_file(
                generate_json_mappings(graph), mappings_path or "mappings.json"
            )
            log.info("Mappings correctly stored in %s!", mappings_path or "mappings.json")

        if n_policy not in ("drop-kmer", "drop-handle"):
            raise ValueError(f"unknown n_policy {n_policy!r}")
        drop_handle_on_n = n_policy == "drop-handle"

        from ..native import available as native_available

        if native_available():
            from ..native import kmer_index_native

            t0 = time.monotonic()
            codes, offsets, counts, positions, n_capped = kmer_index_native(
                graph, kmer_length, max_furcations, max_degree,
                sampling_rate, lin.node_starts, seq_length,
                drop_handle_on_n=drop_handle_on_n,
                dedup_positions=dedup_positions,
                state_cap=state_cap,
                modimizer=modimizer,
            )
            log.info(
                "Finding + converting the kmers required: %d ms (native)",
                (time.monotonic() - t0) * 1000,
            )
        else:
            from . import kmer_gen as _kg

            cap_hits_before = len(_kg._CAP_HITS)
            t0 = time.monotonic()
            kmers = generate_kmers(
                graph,
                kmer_length,
                edge_max=max_furcations,
                degree_max=max_degree,
                sampling_rate=sampling_rate,
                drop_handle_on_n=drop_handle_on_n,
                state_cap=state_cap,
                merge_states=dedup_positions,
                modimizer=modimizer,
            )
            n_capped = len(_kg._CAP_HITS) - cap_hits_before
            log.info("Finding the kmers required: %d ms", (time.monotonic() - t0) * 1000)

            t0 = time.monotonic()
            unique_seqs, offsets, counts, positions = generate_pos_on_ref(
                graph, kmers, seq_length, lin.node_starts
            )
            log.info("Converting the kmers required: %d ms", (time.monotonic() - t0) * 1000)

            from ..utils.dna import kmer_code

            codes = np.asarray([kmer_code(s) for s in unique_seqs], dtype=np.int64)

        if n_capped and graph.paths and sampling_rate is None:
            # The DFS budget truncated dense hub regions (e.g. MICB-class
            # graphs whose full walk count is in the billions — the
            # reference's unbounded enumeration cannot finish there
            # either).  Guarantee every embedded-path k-mer is still
            # indexed by merging in the reference's path-guided
            # generator (generate_kmers_linearly, kmer.rs:510-728 —
            # present but disabled in its production build,
            # index.rs:174-199).  Healthy graphs never hit the cap, so
            # their tables stay bit-identical to the reference.
            t0 = time.monotonic()
            table2 = None
            if native_available():
                from ..native import path_kmers_native

                table2 = path_kmers_native(
                    graph, kmer_length, lin.node_starts, seq_length,
                    dedup_positions=dedup_positions,
                )
            if table2 is None:
                from .kmer_gen import generate_kmers_linearly
                from ..utils.dna import kmer_code as _kc

                lin_kmers = generate_kmers_linearly(graph, kmer_length)
                if lin_kmers:
                    u2, off2, cnt2, pos2 = generate_pos_on_ref(
                        graph, lin_kmers, seq_length, lin.node_starts
                    )
                    codes2 = np.asarray([_kc(s) for s in u2], dtype=np.int64)
                    table2 = (codes2, off2, cnt2, pos2)
            if table2 is not None:
                codes2, off2, cnt2, pos2 = table2
                ok2 = codes2 >= 0
                n_before = len(codes)
                codes, offsets, counts, positions = _merge_kmer_tables(
                    codes, offsets, counts, positions,
                    codes2[ok2], off2[ok2], cnt2[ok2], pos2,
                )
                log.info(
                    "path-guided fallback merged %d extra kmer groups for "
                    "%d truncated handle orientations (%d ms)",
                    len(codes) - n_before, n_capped,
                    (time.monotonic() - t0) * 1000,
                )
        if dedup_positions and len(positions):
            # duplicate-row dedup for the Python generator and the
            # path-guided merge output (the native path already deduped;
            # this pass is then an idempotent no-op).  Rows are sorted
            # within each group and groups are disjoint, so adjacent
            # comparison over (group, row) finds every duplicate.
            grp = np.repeat(np.arange(len(counts)), counts)
            full = np.concatenate([grp[:, None], positions], axis=1)
            keep = np.ones(len(full), bool)
            keep[1:] = (full[1:] != full[:-1]).any(axis=1)
            if not keep.all():
                positions = positions[keep]
                counts = np.bincount(
                    grp[keep], minlength=len(counts)
                ).astype(counts.dtype)
                offsets = np.concatenate(
                    [[0], np.cumsum(counts)[:-1]]
                ).astype(np.int64)
        if len(codes) > 1 and not (np.diff(codes) > 0).all():
            raise AssertionError(
                "unique k-mer codes not strictly increasing — sorted-seq / "
                "sorted-code equivalence violated"
            )

        # Forward-only sub-table: keep positions with both orients Forward,
        # preserving per-group order (the only_forward filter in
        # chain.rs:154 applied at build time).
        fo_mask = (positions[:, 0] == FORWARD) & (positions[:, 2] == FORWARD)
        fo_positions = positions[fo_mask][:, [1, 3]].copy()
        if len(counts):
            cum = np.concatenate([[0], np.cumsum(fo_mask)]).astype(np.int64)
            fo_counts = (cum[offsets + counts] - cum[offsets]).astype(counts.dtype)
        else:
            fo_counts = np.zeros_like(counts)
        fo_offsets = np.concatenate([[0], np.cumsum(fo_counts)[:-1]]).astype(np.int64)

        index = cls(
            kmer_length=kmer_length,
            seq_length=seq_length,
            seq_fwd=lin.seq_fwd,
            seq_rev=seq_rev,
            node_starts=lin.node_starts,
            n_edges=len(lin.edges),
            edges=lin.edges,
            n_nodes=n_nodes,
            edge_idx=lin.edge_idx,
            edges_to_node=lin.edges_to_node,
            n_kmers=len(codes),
            n_kmer_pos=len(positions) + len(codes),  # + delimiters (index.rs:252)
            kmer_codes=codes,
            kmer_offsets=offsets,
            kmer_counts=counts,
            positions=positions,
            sampling_rate=sampling_rate,
            fo_offsets=fo_offsets,
            fo_counts=fo_counts,
            fo_positions=fo_positions,
        )

        log.info("Index with k=%d built correctly!", kmer_length)
        log.info(
            "Found %d different kmers, which appear in %d positions!",
            index.n_kmers,
            index.n_kmer_pos,
        )

        if out_prefix is not None:
            path = out_prefix if out_prefix.endswith(".idx.npz") else out_prefix + ".idx.npz"
            index.save(path)
            log.info("Index correctly stored in %s!", path)
        return index

    # ---- serialization ------------------------------------------------

    def save(self, path: str) -> None:
        np.savez_compressed(
            path if path.endswith(".npz") else path + ".npz",
            kmer_length=self.kmer_length,
            seq_length=self.seq_length,
            seq_fwd=np.frombuffer(self.seq_fwd.encode("ascii"), dtype=np.uint8),
            seq_rev=np.frombuffer(self.seq_rev.encode("ascii"), dtype=np.uint8),
            node_starts=self.node_starts,
            n_edges=self.n_edges,
            edges=self.edges,
            n_nodes=self.n_nodes,
            edge_idx=self.edge_idx,
            edges_to_node=self.edges_to_node,
            n_kmers=self.n_kmers,
            n_kmer_pos=self.n_kmer_pos,
            kmer_codes=self.kmer_codes,
            kmer_offsets=self.kmer_offsets,
            kmer_counts=self.kmer_counts,
            positions=self.positions,
            sampling_rate=-1 if self.sampling_rate is None else self.sampling_rate,
            fo_offsets=self.fo_offsets,
            fo_counts=self.fo_counts,
            fo_positions=self.fo_positions,
        )

    @classmethod
    def load(cls, path: str) -> "Index":
        with np.load(path) as data:
            sampling = int(data["sampling_rate"])
            return cls(
                kmer_length=int(data["kmer_length"]),
                seq_length=int(data["seq_length"]),
                seq_fwd=data["seq_fwd"].tobytes().decode("ascii"),
                seq_rev=data["seq_rev"].tobytes().decode("ascii"),
                node_starts=data["node_starts"],
                n_edges=int(data["n_edges"]),
                edges=data["edges"],
                n_nodes=int(data["n_nodes"]),
                edge_idx=data["edge_idx"],
                edges_to_node=data["edges_to_node"],
                n_kmers=int(data["n_kmers"]),
                n_kmer_pos=int(data["n_kmer_pos"]),
                kmer_codes=data["kmer_codes"],
                kmer_offsets=data["kmer_offsets"],
                kmer_counts=data["kmer_counts"],
                positions=data["positions"],
                sampling_rate=None if sampling < 0 else sampling,
                fo_offsets=data["fo_offsets"],
                fo_counts=data["fo_counts"],
                fo_positions=data["fo_positions"],
                loaded=True,
            )

    @classmethod
    def load_from_prefix(cls, prefix: str) -> "Index":
        return cls.load(prefix + ".idx.npz")

    # ---- cached host views ---------------------------------------------

    def fo_columns(self):
        """Contiguous int64 (start, end) columns of fo_positions, cached
        (the coords hot path calls per batch; host memory is burst-
        throttled so repeated strided copies are costly)."""
        cols = getattr(self, "_fo_cols", None)
        if cols is None:
            cols = (
                np.ascontiguousarray(self.fo_positions[:, 0], dtype=np.int64),
                np.ascontiguousarray(self.fo_positions[:, 1], dtype=np.int64),
            )
            self._fo_cols = cols
        return cols

    # ---- device -------------------------------------------------------

    def host_lut(self):
        """Cached host-side dense 4^k code->group table (int32, -1 =
        absent), shared with the native count/coords helpers so each
        window lookup is one load instead of a binary search.  None
        when the code space exceeds the memory budget (k > 12 by
        default, same gate as the device LUT)."""
        lut = getattr(self, "_host_lut", None)
        if lut is None and not getattr(self, "_host_lut_absent", False):
            space = 4 ** self.kmer_length
            max_space = int(os.environ.get("VGALIGNER_DENSE_LUT_MAX", 1 << 24))
            if 0 < space <= max_space and len(self.kmer_codes):
                lut = np.full(space, -1, dtype=np.int32)
                lut[self.kmer_codes] = np.arange(
                    len(self.kmer_codes), dtype=np.int32
                )
                self._host_lut = lut
            else:
                self._host_lut_absent = True
        return lut

    def device(self) -> DeviceIndex:
        """The replicated device-resident view used by the mapping kernels.

        Arrays are padded to powers of two (codes with int64-max
        sentinels — never equal to a real <=62-bit code — positions with
        zeros) so the jitted mapping step's executables are shared
        across graphs of comparable size instead of recompiling per
        index."""
        import jax.numpy as jnp

        def p2(n: int) -> int:
            p = 1
            while p < n:
                p <<= 1
            return p

        nk = max(len(self.kmer_codes), 1)
        nk_pad = p2(nk)
        codes = np.full(nk_pad, np.iinfo(np.int64).max, dtype=np.int64)
        codes[: len(self.kmer_codes)] = self.kmer_codes
        fo_off = np.zeros(nk_pad, dtype=np.int32)
        fo_off[: len(self.fo_offsets)] = self.fo_offsets
        fo_cnt = np.zeros(nk_pad, dtype=np.int32)
        fo_cnt[: len(self.fo_counts)] = self.fo_counts

        np_pos = max(len(self.fo_positions), 1)
        np_pad = p2(np_pos)
        # positions live on the fwd+rev linearization, so 2*seq_length
        # bounds them; int32 as long as that fits (see DeviceIndex)
        pos_dt = np.int32 if 2 * self.seq_length + 2 < 2**31 else np.int64
        fo_start = np.zeros(np_pad, dtype=pos_dt)
        fo_end = np.zeros(np_pad, dtype=pos_dt)
        if len(self.fo_positions):
            fo_start[: len(self.fo_positions)] = self.fo_positions[:, 0]
            fo_end[: len(self.fo_positions)] = self.fo_positions[:, 1]

        nn_pad = p2(len(self.node_starts))
        starts = np.full(nn_pad, self.seq_length, dtype=np.int64)
        starts[: len(self.node_starts)] = self.node_starts

        lut = None
        space = 4 ** self.kmer_length
        max_space = int(os.environ.get("VGALIGNER_DENSE_LUT_MAX", 1 << 24))
        if 0 < space <= max_space and len(self.kmer_codes):
            lut_np = np.full(space, -1, dtype=np.int32)
            lut_np[self.kmer_codes] = np.arange(
                len(self.kmer_codes), dtype=np.int32
            )
            lut = jnp.asarray(lut_np)

        return DeviceIndex(
            kmer_codes=jnp.asarray(codes),
            fo_offsets=jnp.asarray(fo_off),
            fo_counts=jnp.asarray(fo_cnt),
            fo_start=jnp.asarray(fo_start),
            fo_end=jnp.asarray(fo_end),
            node_starts=jnp.asarray(starts),
            dense_lut=lut,
        )

    # ---- k-mer queries (host reference path) ---------------------------

    def _find_kmer_group(self, seq: str) -> int:
        """Group id of a query k-mer, or -1 (find_start_position_in_index,
        index.rs:309-325)."""
        if len(seq) != self.kmer_length:
            return -1
        from ..utils.dna import kmer_code

        code = kmer_code(seq)
        if code < 0:
            return -1
        if self.sampling_rate is not None:
            from .kmer_gen import _mix64

            if _mix64(code) % self.sampling_rate != 0:
                return -1
        g = int(np.searchsorted(self.kmer_codes, code))
        if g >= len(self.kmer_codes) or self.kmer_codes[g] != code:
            return -1
        return g

    def find_positions_for_query_kmer(self, seq: str) -> List[Tuple[int, int, int, int]]:
        """All (so, start, eo, end) positions of a query k-mer
        (index.rs:353-382)."""
        g = self._find_kmer_group(seq)
        if g < 0:
            return []
        o, c = int(self.kmer_offsets[g]), int(self.kmer_counts[g])
        return [tuple(int(v) for v in row) for row in self.positions[o : o + c]]

    # ---- rank/select & graph accessors (index.rs:388-627) ---------------

    def node_id_from_seqpos(self, orient: int, pos: int) -> int:
        """Node id owning a linearized position (index.rs:388-411)."""
        if orient == FORWARD:
            return int(np.searchsorted(self.node_starts, pos, side="right"))
        return int(
            np.searchsorted(self.node_starts[: self.n_nodes], self.seq_length - pos, side="left")
        )

    def node_ids_from_seqpos_vec(self, orients, pos):
        """Vectorized node_id_from_seqpos + node-start offsets.

        Returns (ids, offsets) where offsets = pos - node_start-on-forward
        (the AnchorPosOnGraph convention for both orients, chain.rs:89-128).
        """
        fwd_ids = np.searchsorted(self.node_starts, pos, side="right")
        rev_ids = np.searchsorted(
            self.node_starts[: self.n_nodes], self.seq_length - pos, side="left"
        )
        ids = np.where(np.asarray(orients) == FORWARD, fwd_ids, rev_ids)
        offs = pos - self.node_starts[np.maximum(ids - 1, 0)]
        return ids, offs

    def handle_from_seqpos(self, orient: int, pos: int) -> int:
        node_id = self.node_id_from_seqpos(orient, pos)
        return handle_pack(node_id, orient == REVERSE)

    def get_bv_select(self, element_no: int) -> int:
        """Start of the element_no-th node (1-based); n_nodes+1 selects the
        end marker; past-the-end returns 0 like the reference's fallthrough
        (index.rs:461-480)."""
        if element_no == 0:
            raise ValueError("element_no should be > 0")
        if element_no > self.n_nodes + 1:
            return 0
        return int(self.node_starts[element_no - 1])

    def seq_from_handle(self, handle: int) -> str:
        """Node label in handle orientation without the graph
        (index.rs:503-533)."""
        nid = handle_id(handle)
        assert 1 <= nid <= self.n_nodes, f"handle id {nid} out of range"
        start = int(self.node_starts[nid - 1])
        end = int(self.node_starts[nid])
        if handle_is_reverse(handle):
            return self.seq_rev[self.seq_length - end : self.seq_length - start]
        return self.seq_fwd[start:end]

    def _edges_interval(self, handle: int) -> Tuple[int, int]:
        nid = handle_id(handle)
        return int(self.edge_idx[nid - 1]), int(self.edge_idx[nid])

    def edges_from_handle(self, handle: int) -> List[int]:
        lo, hi = self._edges_interval(handle)
        return [int(h) for h in self.edges[lo:hi]]

    def incoming_edges_from_handle(self, handle: int) -> List[int]:
        """index.rs:559-579."""
        if handle_is_reverse(handle):
            return [handle_flip(h) for h in self.outgoing_edges_from_handle(handle_flip(handle))][::-1]
        lo, _ = self._edges_interval(handle)
        etn = int(self.edges_to_node[handle_id(handle) - 1])
        return [int(h) for h in self.edges[lo : lo + etn]]

    def outgoing_edges_from_handle(self, handle: int) -> List[int]:
        """index.rs:584-606."""
        if handle_is_reverse(handle):
            return [handle_flip(h) for h in self.incoming_edges_from_handle(handle_flip(handle))][::-1]
        lo, hi = self._edges_interval(handle)
        etn = int(self.edges_to_node[handle_id(handle) - 1])
        return [int(h) for h in self.edges[lo + etn : hi]]

    def seq_from_start_end_seqpos(self, begin: Tuple[int, int], end: Tuple[int, int]) -> str:
        """index.rs:609-626 (mixed-orient falls back to fwd, a reference TODO)."""
        bo, bp = begin
        eo, ep = end
        if bo == REVERSE and eo == REVERSE:
            return self.seq_rev[bp:ep]
        return self.seq_fwd[bp:ep]
