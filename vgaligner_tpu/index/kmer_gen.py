"""K-mer enumeration over the graph and conversion to linearized positions.

Behavioral reference: /root/reference/src/kmer.rs.

* `generate_kmers` mirrors generate_kmers_parallel → ...
  generate_kmer_with_handle_orient (kmer.rs:277-505): for every sorted
  forward handle and both orientations, enumerate every k-mer *starting*
  in that handle, completing across right-edges with a LIFO stack
  (fork-bounded by max_furcations/max_degree), then globally stable-sort
  by sequence and dedup consecutive fully-equal k-mers
  (kmer.rs:295-301).  N-handling follows the production (parallel)
  variant: any N aborts the whole handle+orientation
  (kmer.rs:400-403,459-461); pass `drop_handle_on_n=False` for the
  sequential variant's per-k-mer skip (kmer.rs:161-163,219-221).
* `generate_pos_on_ref` mirrors generate_pos_on_ref_2 (kmer.rs:816-928):
  graph positions → positions on the fwd/rev linearization
  (get_seq_pos, kmer.rs:752-770), grouped per unique k-mer sequence with
  per-group sorted positions.  Instead of the u64::MAX delimiter rows we
  store explicit (offset, count) pairs — the device-friendly layout.

The modimizer (`hash % sampling_rate == 0`, kmer.rs:409,464-466)
defaults to a bit-exact reconstruction of ahash 0.7.6's zero-seed
fallback hash (utils/ahash.py + its native twin; `--modimizer code`
selects the earlier deterministic 64-bit code mix instead), so the
sampled k-mer *set* matches the reference when sampling is enabled.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..graph.handlegraph import (
    HashGraph,
    handle_flip,
    handle_id,
    handle_is_reverse,
)

FORWARD = 0
REVERSE = 1


@dataclass
class GraphKmer:
    """A k-mer anchored on graph handles (kmer.rs:48-65).

    Equality spans *all* fields (the derived PartialEq in the reference),
    including `forks` — this matters because dedup only removes fully
    identical entries, so the same sequence+position reached through
    fork-paths with different fork counts is kept twice and yields
    duplicate index positions, exactly as the reference does.
    """

    seq: str
    begin_orient: int
    begin_offset: int
    end_orient: int
    end_offset: int
    first_handle: int
    last_handle: int
    handle_orient: bool
    forks: int

    def key(self) -> tuple:
        return (
            self.seq,
            self.begin_orient,
            self.begin_offset,
            self.end_orient,
            self.end_offset,
            self.first_handle,
            self.last_handle,
            self.handle_orient,
            self.forks,
        )


def _mix64(x: int) -> int:
    """Deterministic 64-bit mix (splitmix64 finalizer) for the modimizer."""
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def _sampling_keep(seq: str, sampling_rate: Optional[int],
                   modimizer: str = "ahash") -> bool:
    if sampling_rate is None:
        return True
    if modimizer == "ahash":
        # the reference's sampled set: ahash 0.7.6 of the seq string
        # with zero seeds (kmer.rs:931-934; see utils/ahash.py)
        from ..utils.ahash import ahash07_str

        return ahash07_str(seq) % sampling_rate == 0
    from ..utils.dna import kmer_code

    code = kmer_code(seq)
    return _mix64(code) % sampling_rate == 0


def _kmers_for_handle_orient(
    graph: HashGraph,
    handle: int,
    orient: bool,
    k: int,
    edge_max: Optional[int],
    degree_max: Optional[int],
    sampling_rate: Optional[int],
    drop_handle_on_n: bool,
    state_cap: int = 0,
    merge_states: bool = False,
    modimizer: str = "ahash",
) -> List[GraphKmer]:
    """All k-mers starting in `handle` (kmer.rs:347-505).

    state_cap > 0 bounds the DFS states per call: the reference's fork
    cap never binds at k <= max_furcations, so dense hubs of 1 bp nodes
    enumerate paths exponentially (framework extension; the native
    runtime applies the same cap — see host_kernels.cpp).

    merge_states (dedup-positions mode) merges pending DFS states with
    identical (begin_offset, prefix, pending handle): they complete to
    identical position rows, so walking one suffices — the native
    runtime's state merging, mirrored exactly (same push-attempt state
    accounting, k <= 27, uppercase-ACGT prefixes only) so a binding
    cap truncates both paths identically."""
    global _STATES_USED
    _STATES_USED = 0
    out_neighbors = graph.right_neighbors(handle)
    if degree_max is not None and len(out_neighbors) > degree_max:
        return []

    handle_seq = graph.sequence(handle)
    handle_len = len(handle_seq)
    h_rev = handle_is_reverse(handle)

    complete: List[GraphKmer] = []
    incomplete: List[GraphKmer] = []
    limits = edge_max is not None or degree_max is not None
    states = 0
    seen_states: set = set()
    _ACGT = frozenset("ACGT")

    def try_push(inc: GraphKmer) -> None:
        nonlocal states
        states += 1  # attempts count as work (native parity)
        if merge_states and k <= 27 and set(inc.seq) <= _ACGT:
            key = (inc.begin_offset, len(inc.seq), inc.last_handle, inc.seq)
            if key in seen_states:
                return
            seen_states.add(key)
        incomplete.append(inc)

    for i in range(handle_len):
        end = min(i + k, handle_len)
        kmer = GraphKmer(
            seq=handle_seq[i:end],
            begin_orient=REVERSE if h_rev else FORWARD,
            begin_offset=i,
            end_orient=REVERSE if h_rev else FORWARD,
            end_offset=end,
            first_handle=handle,
            last_handle=handle,
            handle_orient=orient,
            forks=0,
        )
        if "N" in kmer.seq:
            if drop_handle_on_n:
                _STATES_USED = states
                return []
            continue
        if len(kmer.seq) == k:
            if _sampling_keep(kmer.seq, sampling_rate, modimizer):
                complete.append(kmer)
        else:
            next_count = len(out_neighbors) if limits else 0
            if (
                (edge_max is None and degree_max is None)
                or (degree_max is not None and next_count < degree_max)
                or (edge_max is not None and kmer.forks < edge_max)
            ):
                for neighbor in out_neighbors:
                    inc = GraphKmer(**{**kmer.__dict__})
                    inc.last_handle = neighbor
                    if next_count > 1:
                        inc.forks += 1
                    try_push(inc)

    # LIFO completion across edges (kmer.rs:449-497)
    while incomplete:
        states += 1
        _STATES_USED = states
        if state_cap > 0 and states > state_cap:
            _CAP_HITS.append(handle)
            break
        kmer = incomplete.pop()
        h = kmer.last_handle
        h_seq = graph.sequence(h)
        h_len = len(h_seq)
        end = min(k - len(kmer.seq), h_len)
        kmer.seq += h_seq[:end]
        kmer.end_orient = REVERSE if handle_is_reverse(h) else FORWARD
        kmer.end_offset = end
        kmer.last_handle = h

        if "N" in kmer.seq:
            if drop_handle_on_n:
                _STATES_USED = states
                return []
            continue
        if len(kmer.seq) == k:
            if _sampling_keep(kmer.seq, sampling_rate, modimizer):
                complete.append(kmer)
        else:
            neighbors = graph.right_neighbors(h)
            for neighbor in neighbors:
                next_count = len(neighbors) if limits else 0
                if (
                    (edge_max is None and degree_max is None)
                    or (degree_max is not None and next_count < degree_max)
                    or (edge_max is not None and kmer.forks < edge_max)
                ):
                    inc = GraphKmer(**{**kmer.__dict__})
                    inc.last_handle = neighbor
                    if next_count > 1:
                        inc.forks += 1
                    try_push(inc)

    _STATES_USED = states
    return complete


_CAP_HITS: list = []  # handles whose DFS hit the state cap (diagnostics)
_STATES_USED = 0  # LIFO states consumed by the last enumeration call


def generate_kmers(
    graph: HashGraph,
    k: int,
    edge_max: Optional[int] = None,
    degree_max: Optional[int] = None,
    sampling_rate: Optional[int] = None,
    drop_handle_on_n: bool = True,
    state_cap: int = 0,
    merge_states: bool = False,
    modimizer: str = "ahash",
) -> List[GraphKmer]:
    """Enumerate, stable-sort by sequence, and dedup graph k-mers.

    state_cap > 0 also sets a global budget of 8x the per-call cap
    across the whole build (deterministic first-come deduction),
    mirroring the native runtime."""
    kmers: List[GraphKmer] = []
    budget = state_cap * 8 if state_cap > 0 else 0
    for fwd_handle in graph.handles():
        for orient in (True, False):
            handle = fwd_handle if orient else handle_flip(fwd_handle)
            cap = state_cap
            if state_cap > 0:
                if budget <= 0:
                    _CAP_HITS.append(handle)
                    continue
                cap = min(state_cap, budget)
            kmers.extend(
                _kmers_for_handle_orient(
                    graph, handle, orient, k, edge_max, degree_max,
                    sampling_rate, drop_handle_on_n, cap,
                )
            )
            if state_cap > 0:
                budget -= _STATES_USED

    kmers.sort(key=lambda km: km.seq)  # stable, seq only (kmer.rs:295-298)

    deduped: List[GraphKmer] = []
    for km in kmers:
        if deduped and deduped[-1].key() == km.key():
            continue
        deduped.append(km)
    return deduped


def generate_kmers_linearly(
    graph: HashGraph,
    k: int,
    edge_max: Optional[int] = None,
    degree_max: Optional[int] = None,
) -> List[GraphKmer]:
    """Path-guided k-mer enumeration (kmer.rs:510-728).

    The reference's alternative generator, disabled in its production
    build path (index.rs:174-199): walk each embedded path linearly on
    the forward strand, then each reversed path on the reverse strand,
    completing k-mers across consecutive path steps; merge, sort by
    sequence, dedup.  edge_max/degree_max are accepted but unused, as in
    the reference (the underscore-prefixed params).  Reference quirks
    reproduced: freshly started reverse-strand k-mers store `begin` in
    their end_offset (kmer.rs:685), and extension overwrites end_offset
    with the *added* length (extend_kmer, kmer.rs:80-84).
    """
    assert graph.paths, "generate_kmers_linearly requires embedded paths"

    def one_strand(reverse: bool) -> List[GraphKmer]:
        out: List[GraphKmer] = []
        for pid in graph.paths_iter():
            nodes = graph.get_path(pid).nodes
            handles = [handle_flip(h) for h in reversed(nodes)] if reverse else list(nodes)
            prev_incomplete: List[GraphKmer] = []
            for handle in handles:
                h_rev = handle_is_reverse(handle)
                handle_seq = graph.sequence(handle)
                h_len = len(handle_seq)
                curr_incomplete: List[GraphKmer] = []

                for km in prev_incomplete:  # FIFO completion
                    end = min(k - len(km.seq), h_len)
                    km.seq += handle_seq[:end]
                    km.end_orient = REVERSE if h_rev else FORWARD
                    km.end_offset = end  # extend_kmer: length added
                    km.last_handle = handle
                    if "N" in km.seq:
                        continue
                    if len(km.seq) == k:
                        out.append(km)
                    else:
                        curr_incomplete.append(km)

                for i in range(h_len):
                    end = min(i + k, h_len)
                    km = GraphKmer(
                        seq=handle_seq[i:end],
                        begin_orient=REVERSE if h_rev else FORWARD,
                        begin_offset=i,
                        end_orient=REVERSE if h_rev else FORWARD,
                        # reference quirk: the reverse generator stores
                        # `begin` as the end offset (kmer.rs:685)
                        end_offset=i if reverse else end,
                        first_handle=handle,
                        last_handle=handle,
                        handle_orient=not reverse,
                        forks=0,
                    )
                    if "N" in km.seq:
                        continue
                    if len(km.seq) == k:
                        out.append(km)
                    else:
                        curr_incomplete.append(km)
                prev_incomplete = curr_incomplete
        return out

    kmers = one_strand(False) + one_strand(True)
    kmers.sort(key=lambda km: km.seq)
    deduped: List[GraphKmer] = []
    for km in kmers:
        if deduped and deduped[-1].key() == km.key():
            continue
        deduped.append(km)
    return deduped


def get_seq_pos(
    handle: int, node_starts: np.ndarray, ref_len: int, handle_len: int
) -> int:
    """Start of `handle`'s label on the fwd/rev linearization (kmer.rs:752-770).

    node_starts is indexed by node_id - 1 (the reference assumes
    contiguous 1-based ids, index.rs:489-498).
    """
    start = int(node_starts[handle_id(handle) - 1])
    if handle_is_reverse(handle):
        return ref_len - start - handle_len
    return start


def generate_pos_on_ref(
    graph: HashGraph,
    kmers: List[GraphKmer],
    seq_len: int,
    node_starts: np.ndarray,
) -> Tuple[List[str], np.ndarray, np.ndarray, np.ndarray]:
    """Convert graph k-mers to grouped, sorted linearized positions.

    Returns (unique_seqs, offsets, counts, positions) where positions is
    an int64 [n_pos, 4] array of (start_orient, start, end_orient, end)
    rows; group g for unique_seqs[g] is positions[offsets[g] :
    offsets[g]+counts[g]].  Mirrors generate_pos_on_ref_2
    (kmer.rs:816-928) with explicit counts instead of delimiter rows.
    Position rows within a group are sorted by (start_orient, start,
    end_orient, end) — SeqPos/KmerPos derived Ord (kmer.rs:27-44,732-738).
    """
    unique_seqs: List[str] = []
    group_positions: List[List[Tuple[int, int, int, int]]] = []

    for km in kmers:
        first_len = len(graph.sequence(km.first_handle))
        last_len = len(graph.sequence(km.last_handle))
        start_ref = get_seq_pos(km.first_handle, node_starts, seq_len, first_len) + km.begin_offset
        end_ref = get_seq_pos(km.last_handle, node_starts, seq_len, last_len) + km.end_offset
        row = (km.begin_orient, start_ref, km.end_orient, end_ref)

        if unique_seqs and unique_seqs[-1] == km.seq:
            group_positions[-1].append(row)
        else:
            unique_seqs.append(km.seq)
            group_positions.append([row])

    offsets = np.zeros(len(unique_seqs), dtype=np.int64)
    counts = np.zeros(len(unique_seqs), dtype=np.int64)
    flat: List[Tuple[int, int, int, int]] = []
    for g, rows in enumerate(group_positions):
        rows.sort()
        offsets[g] = len(flat)
        counts[g] = len(rows)
        flat.extend(rows)

    positions = (
        np.asarray(flat, dtype=np.int64).reshape(-1, 4)
        if flat
        else np.zeros((0, 4), dtype=np.int64)
    )
    return unique_seqs, offsets, counts, positions
