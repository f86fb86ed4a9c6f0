"""Chain -> subgraph extraction -> partial-order alignment -> GAF.

Behavioral reference: rs-vgaligner src/align.rs.

  * find_range_chain (align.rs:267-402): anchor endpoint handles -> the
    contiguous node-id range in the chain's orientation(s);
  * extend_range_chain (align.rs:523-665, the "_2" variant used in
    production): widen the range left/right by the unaligned query
    prefix/suffix, BFS over incoming/outgoing edges until enough
    sequence is collected (with the reference's u64 wrapping on the
    per-node corrections);
  * find_nodes_edges (align.rs:670-724): node labels + 0-based edge
    pairs restricted to the range, loop-removed by orientation;
  * POA engines: abPOA-style global convex-gap alignment and
    rspoa-style local no-gap alignment (ops/poa.py kernels; the
    reference calls the abPOA C library via FFI, align.rs:202, and the
    rspoa crate's align_local_no_gap, align.rs:160-164);
  * best_alignment_for_query (align.rs:34-55): align the first
    align_best_n chains, keep the longest path_length.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from enum import Enum
from typing import List, Optional, Tuple

from ..graph.handlegraph import handle_flip, handle_id, handle_is_reverse, handle_pack
from ..index.build import Index
from ..index.kmer_gen import FORWARD
from ..io.gaf import GAFAlignment
from .mapper import Chain

log = logging.getLogger(__name__)

_U64 = 1 << 64


class RangeOrient(Enum):
    FORWARD = 0
    REVERSE = 1
    BOTH = 2


@dataclass
class OrientedGraphRange:
    orient: RangeOrient
    handles: List[int]
    # corridor-mode flank-node label trims: handle -> (from, to) within
    # the node label (None = whole labels; see find_range_chain_corridor)
    label_trims: Optional[dict] = None

    @property
    def first_handle(self) -> int:
        return self.handles[0]

    @property
    def last_handle(self) -> int:
        return self.handles[-1]


def find_range_chain(index: Index, chain: Chain) -> OrientedGraphRange:
    """Min/max anchor-endpoint handle -> node-id range (align.rs:267-402)."""
    import numpy as np

    n = chain.n_anchors
    pos = np.concatenate([chain.atb, chain.ate - 1])
    if chain.aso is None:
        orients = np.zeros(2 * n, dtype=np.int8)
    else:
        orients = np.concatenate([chain.aso, chain.aeo])
    ids, _ = index.node_ids_from_seqpos_vec(orients, pos)
    handles = (ids.astype(np.int64) << 1) | (orients != 0)
    min_handle = int(handles.min())
    max_handle = int(handles.max())
    lo, hi = handle_id(min_handle), handle_id(max_handle)

    min_rev = handle_is_reverse(min_handle)
    max_rev = handle_is_reverse(max_handle)
    if not min_rev and not max_rev:
        handles = [handle_pack(i, False) for i in range(lo, hi + 1)]
        orient = RangeOrient.FORWARD
    elif min_rev and max_rev:
        handles = [handle_pack(i, True) for i in range(lo, hi + 1)]
        orient = RangeOrient.REVERSE
    else:
        fwd = [handle_pack(i, False) for i in range(lo, hi + 1)]
        rev = [handle_pack(i, True) for i in range(lo, hi + 1)]
        handles = sorted(fwd + rev)
        orient = RangeOrient.BOTH

    if not handles and min_handle == max_handle:
        handles.append(min_handle)
    return OrientedGraphRange(orient=orient, handles=handles)


def _bfs_extend(index: Index, seeds: List[Tuple[int, int]], incoming: bool) -> List[int]:
    """Walk left (incoming) or right (outgoing), collecting every visited
    handle until the remaining length is covered (align.rs:551-656).

    The frontier is deduped per level keeping the max remaining budget:
    a handle reached with budget r covers a superset of any smaller
    budget, and callers only consume the collected handle SET — the
    reference's naive walk is exponential in bubbly regions."""
    collected: List[int] = []
    frontier = seeds
    guard = 0
    while frontier:
        guard += 1
        if guard > 10_000:  # the reference has no cycle guard; we fail loud
            raise RuntimeError("range extension did not converge (cyclic region?)")
        best: dict = {}
        for remaining, handle in frontier:
            if best.get(handle, -1) < remaining:
                best[handle] = remaining
        nxt: List[Tuple[int, int]] = []
        for remaining, handle in frontier:
            collected.append(handle)
            if best.get(handle) != remaining:
                continue
            best[handle] = None  # expand each handle once per level
            seq_len = len(index.seq_from_handle(handle))
            if seq_len < remaining:
                rem = remaining - seq_len
                neighbors = (
                    index.incoming_edges_from_handle(handle)
                    if incoming
                    else index.outgoing_edges_from_handle(handle)
                )
                nxt.extend((rem, h) for h in neighbors)
        frontier = nxt
    return collected


def extend_range_chain(index: Index, chain: Chain, old_range: OrientedGraphRange) -> OrientedGraphRange:
    """Widen the range by the unaligned query prefix/suffix
    (extend_range_chain_2, align.rs:523-665).

    The per-node corrections use u64 arithmetic that can wrap in the
    reference (release build); the wrap is reproduced so the
    "already-enough-sequence-on-node" test behaves identically.
    """
    handles = list(old_range.handles)

    prefix_diff = int(chain.aqb[0])
    first_handle = old_range.first_handle
    start_prefix_on_node = (
        int(chain.atb[0]) - index.get_bv_select(handle_id(first_handle))
    ) % _U64
    if start_prefix_on_node < prefix_diff:
        prefix_diff -= start_prefix_on_node
    else:
        prefix_diff = 0

    if prefix_diff > 0:
        seeds = [
            (prefix_diff, h) for h in index.incoming_edges_from_handle(first_handle)
        ]
        handles.extend(_bfs_extend(index, seeds, incoming=True))

    suffix_diff = len(chain.query.seq) - (int(chain.aqb[-1]) + chain.k)
    last_handle = old_range.last_handle
    end_suffix_on_node = (
        index.get_bv_select(handle_id(last_handle) + 1) - 1 - (int(chain.ate[-1]) - 1)
    ) % _U64
    if end_suffix_on_node > suffix_diff:
        suffix_diff = 0
    else:
        suffix_diff -= end_suffix_on_node

    if suffix_diff > 0:
        seeds = [
            (suffix_diff, h) for h in index.outgoing_edges_from_handle(last_handle)
        ]
        handles.extend(_bfs_extend(index, seeds, incoming=False))

    handles = sorted(set(handles))
    return OrientedGraphRange(orient=old_range.orient, handles=handles)


def _bfs_budget(index: Index, start_handle: int, budget: int, incoming: bool) -> dict:
    """Budgeted orientation-preserving walk from start_handle; returns
    {handle: best remaining budget at entry}.  Budget is measured in
    sequence bases consumed; the frontier dedupes per handle keeping the
    max remaining (a larger budget reaches a superset)."""
    best: dict = {}
    orient_bit = start_handle & 1
    frontier = [(budget, start_handle)]
    while frontier:
        nxt = []
        for rem, h in frontier:
            if best.get(h, -1) >= rem:
                continue
            best[h] = rem
            rem2 = rem - len(index.seq_from_handle(h))
            if rem2 > 0:
                nbrs = (
                    index.incoming_edges_from_handle(h)
                    if incoming
                    else index.outgoing_edges_from_handle(h)
                )
                nxt.extend((rem2, t) for t in nbrs if (t & 1) == orient_bit)
        frontier = nxt
    return best


def _topo_order(index: Index, members: set) -> List[int]:
    """Kahn topological order of the subgraph induced by `members`
    (successors = same-orientation outgoing edges), smallest handle
    first on ties; any cyclic remainder is appended in id order with
    its unresolved in-edges implicitly dropped by the position filter
    (mirrors build_base_graph's cycle handling)."""
    import heapq

    indeg = {h: 0 for h in members}
    succs = {h: [] for h in members}
    for h in members:
        for t in index.outgoing_edges_from_handle(h):
            if t in indeg and t != h:
                succs[h].append(t)
                indeg[t] += 1
    ready = [h for h, d in indeg.items() if d == 0]
    heapq.heapify(ready)
    out: List[int] = []
    while ready:
        h = heapq.heappop(ready)
        out.append(h)
        for t in succs[h]:
            indeg[t] -= 1
            if indeg[t] == 0:
                heapq.heappush(ready, t)
    if len(out) < len(members):
        done = set(out)
        out.extend(sorted(h for h in members if h not in done))
    return out


def find_range_chain_corridor(
    index: Index, chain: Chain, slack: int = 128
) -> Optional[OrientedGraphRange]:
    """Topology-aware replacement for the contiguous-id range (accuracy
    extension beyond the reference; VGALIGNER_RANGE_MODE=id restores
    strict parity).

    The reference's find_range_chain (align.rs:267-402) takes the
    min/max anchor-endpoint node ID: on graphs whose bubble alt-alleles
    carry ids far from their flanks (vg construct appends them after
    the backbone) that range either omits un-anchored alts entirely or
    — when an anchor lands on a high-id alt — spans the whole backbone
    between, forcing the global POA through kilobases of unrelated
    sequence, and the id-order edge filter (align.rs:717-721) turns
    every high-id alt into a dead-end sink that truncates alignments
    (the allele/truncate failure class dominating 5-B3106 / 8-C3107 /
    9-G-3135).

    The corridor instead intersects two budgeted orientation-preserving
    walks — forward from the chain's FIRST anchor node, backward from
    its LAST (budget = query length + slack bases each) — so it contains
    every branch of every bubble between the anchors and nothing else,
    then orders it topologically so the position-order edge filter
    keeps all real DAG edges.  Forward-orient chains only (production
    anchors are forward-only, map.rs:62); reverse/mixed chains return
    None and keep the reference range."""
    import numpy as np

    if chain.aso is not None and (
        np.any(chain.aso != 0) or np.any(chain.aeo != 0)
    ):
        return None

    # A chain's anchors can ladder across tandem repeat copies far
    # beyond the read (measured: 90 anchors of a 100 bp read spanning
    # 2.8 kb of DRB1 — the gap cost bounds each LINK, not the total).
    # Aligning the read globally against such a stretch is hopeless and
    # blows the subgraph up; keep only the densest anchor window whose
    # target span fits the read (+ slack both sides) and build the
    # corridor between ITS first and last anchors.
    atb_all = np.asarray(chain.atb, dtype=np.int64)
    ate_all = np.asarray(chain.ate, dtype=np.int64)
    na = len(atb_all)
    span_cap = len(chain.query.seq) + 2 * slack
    bi, bj = 0, na - 1
    if na and int(ate_all[-1] - atb_all[0]) > span_cap:
        best_cnt, i = 0, 0
        for j in range(na):
            while int(ate_all[j] - atb_all[i]) > span_cap:
                i += 1
            if j - i + 1 > best_cnt:
                best_cnt, bi, bj = j - i + 1, i, j

    a_tb0 = int(atb_all[bi])
    a_te1 = int(ate_all[bj])
    a_qb0 = int(chain.aqb[bi])
    a_qb1 = int(chain.aqb[bj])
    ids_b, _ = index.node_ids_from_seqpos_vec(
        np.zeros(1, np.int8), np.asarray([a_tb0], dtype=np.int64)
    )
    ids_e, _ = index.node_ids_from_seqpos_vec(
        np.zeros(1, np.int8), np.asarray([a_te1 - 1], dtype=np.int64)
    )
    start_h = int(ids_b[0]) << 1
    end_h = int(ids_e[0]) << 1
    budget = len(chain.query.seq) + slack
    # walk budgets are anchored-offset-based: the remaining budget after
    # consuming the start node is qlen + slack minus the start node's
    # bases past the anchor, so anchors deep inside a huge node keep
    # the corridor inside it (mirrors host_kernels.cpp)
    start_off = a_tb0 - index.get_bv_select(int(ids_b[0]))
    end_gap = index.get_bv_select(int(ids_e[0]) + 1) - a_te1
    fwd = _bfs_budget(index, start_h, start_off + budget, incoming=False)
    bwd = _bfs_budget(index, end_h, end_gap + budget, incoming=True)
    members = set(fwd) & set(bwd)
    members.add(start_h)
    members.add(end_h)

    # unaligned query prefix/suffix beyond the anchored nodes
    # (extend_range_chain_2 analog, align.rs:523-665)
    prefix = a_qb0
    start_off = a_tb0 - index.get_bv_select(int(ids_b[0]))
    prefix = max(0, prefix - max(0, start_off))
    if prefix > 0:
        for h in index.incoming_edges_from_handle(start_h):
            if (h & 1) == 0:
                members |= set(_bfs_budget(index, h, prefix, incoming=True))
    suffix = len(chain.query.seq) - (a_qb1 + chain.k)
    end_tail = index.get_bv_select(int(ids_e[0]) + 1) - a_te1
    suffix = max(0, suffix - max(0, end_tail))
    if suffix > 0:
        for h in index.outgoing_edges_from_handle(end_h):
            if (h & 1) == 0:
                members |= set(_bfs_budget(index, h, suffix, incoming=False))

    handles = _topo_order(index, members)

    # flank-node label trimming (mirrors host_kernels.cpp): a huge
    # start/end node would otherwise force the global POA through
    # kilobases of deletions — trim its label to at most `budget` bases
    # around the anchored window.  Emitted GAF node offsets stay in
    # UNTRIMMED node coordinates: label_trims feeds the offset rebase
    # (_rebase_trimmed_offsets / the native lbase channel).
    trims: dict = {}
    s_len = len(index.seq_from_handle(start_h))
    t_from = a_tb0 - index.get_bv_select(int(ids_b[0])) - budget
    if t_from > 0:
        trims[start_h] = (t_from, s_len)
    e_len = len(index.seq_from_handle(end_h))
    t_to = a_te1 - index.get_bv_select(int(ids_e[0])) + budget
    if t_to < e_len:
        f0 = trims.get(end_h, (0, 0))[0]
        trims[end_h] = (f0, t_to)
    return OrientedGraphRange(
        orient=RangeOrient.FORWARD, handles=handles,
        label_trims=trims or None,
    )


def close_bubbles(index: Index, po_range: OrientedGraphRange) -> OrientedGraphRange:
    """Surgical bubble closure (accuracy extension beyond the reference).

    Two reference behaviors lose bubble alt-alleles on graphs whose
    alt-node ids sit far from their flanks: the contiguous node-id
    range omits un-anchored alt nodes entirely (align.rs:267-402), and
    the id-increasing edge filter (align.rs:717-721) drops the return
    edge of an in-range alt node whose id exceeds its successor's.
    Forward ranges only: a forward node x whose in-range predecessors P
    and successors S are both nonempty with max(P) < min(S) is a bubble
    alt between those flanks; if its id does not already sit between
    them (or it is out of range) it is (re)placed right after max(P).
    Everything else keeps id order — the id filter doubles as a
    linearity prior that prunes spurious long-range shortcuts, so a
    full topological reorder measurably hurts.  Mirrors the native
    runtime (host_kernels.cpp vg_extract_subgraphs)."""
    if po_range.orient != RangeOrient.FORWARD:
        return po_range
    handles = list(po_range.handles)
    inset = set(handles)
    cands = set()
    for h in handles:
        for t in index.outgoing_edges_from_handle(h):
            if not (t & 1) and t not in inset:
                cands.add(t)
    anchor: dict = {}
    children: dict = {}
    for x in sorted(cands) + handles:
        preds = [p for p in index.incoming_edges_from_handle(x) if p in inset]
        succs = [m for m in index.outgoing_edges_from_handle(x) if m in inset]
        if not preds or not succs:
            continue
        max_p, min_s = max(preds), min(succs)
        if max_p >= min_s:
            continue
        if x in inset and max_p < x < min_s:
            continue  # already correctly placed
        anchor[x] = max_p
        children.setdefault(max_p, []).append(x)
    if not anchor:
        return po_range
    merged: List[int] = []
    emitted = set()

    def emit(h0: int) -> None:
        stack = [h0]
        while stack:
            h = stack.pop()
            if h in emitted:
                continue
            emitted.add(h)
            merged.append(h)
            for c in sorted(children.get(h, ()), reverse=True):
                stack.append(c)

    for h in handles:
        if h not in anchor:
            emit(h)
    for h in sorted(x for x in anchor if x not in emitted):
        emit(h)
    return OrientedGraphRange(orient=po_range.orient, handles=merged)


def find_nodes_edges(index: Index, po_range: OrientedGraphRange) -> Tuple[List[str], List[Tuple[int, int]]]:
    """Node labels + 0-based edges within the range, loops removed by
    orientation (align.rs:670-724).  Corridor-mode flank trims apply."""
    handles = po_range.handles
    pos_of = {h: i for i, h in enumerate(handles)}
    seqs = [index.seq_from_handle(h) for h in handles]
    if po_range.label_trims:
        for h, (f, t) in po_range.label_trims.items():
            i = pos_of.get(h)
            if i is not None:
                seqs[i] = seqs[i][f:t]

    edges: List[Tuple[int, int]] = []
    for h in handles:
        for target in index.outgoing_edges_from_handle(h):
            if target in pos_of:
                edges.append((pos_of[h], pos_of[target]))

    if po_range.orient == RangeOrient.FORWARD:
        edges = [e for e in edges if e[0] < e[1]]
    elif po_range.orient == RangeOrient.REVERSE:
        edges = [e for e in edges if e[1] < e[0]]
    return seqs, edges


def get_subgraph_paths(graph, po_range: OrientedGraphRange):
    """Paths restricted to the range, ids rebased to it (align.rs:1170-1189)."""
    in_range = set(po_range.handles)
    min_in_range = min(handle_id(h) for h in po_range.handles)
    out = {}
    for pid in graph.paths_iter():
        nodes = [
            handle_id(h) - min_in_range + 1
            for h in graph.get_path(pid).nodes
            if h in in_range
        ]
        out[pid] = nodes
    return out



def _rebase_trimmed_offsets(res, rng: "OrientedGraphRange") -> None:
    """Corridor flank trims cut the front of the start node's label;
    rebase the result's per-node path offsets to UNTRIMMED node
    coordinates so emitted GAF offsets mean the same thing in every
    range mode (mirrors the native path's lbase correction)."""
    if not rng.label_trims or not res.node_path:
        return

    def base(ni: int) -> int:
        return rng.label_trims.get(rng.handles[ni], (0, 0))[0]

    res.path_start_offset += base(res.node_path[0])
    res.path_end_offset += base(res.node_path[-1])


def _corridor_score_key(a) -> int:
    """Corridor-mode candidate ordering: the flank-penalty-free trimmed
    score when computable (see PoaAligner.trimmed_poa_score — evaluated
    lazily here, so single-candidate reads never pay the cs parse),
    else the raw global score, else bottom (placeholders)."""
    t = getattr(a, "poa_score_trim", None)
    if t is not None:
        return t
    cs = getattr(a, "poa_cs", None)
    if cs is not None:
        t = PoaAligner.trimmed_poa_score(cs)
        a.poa_score_trim = t
        return t
    s = getattr(a, "poa_score", None)
    return -(1 << 60) if s is None else s


class PoaEngine(Enum):
    ABPOA = "abpoa"
    RSPOA = "rspoa"


# subgraphs above this base-vertex count run on the host oracle instead
# of compiling a one-off device executable for an outlier shape
_V_DEVICE_CAP = 8192


class PoaAligner:
    """Base-level aligner over chain-implied subgraphs (align.rs:34-228)."""

    def __init__(self, index: Index, engine: PoaEngine = PoaEngine.ABPOA,
                 export_subgraphs: bool = False, graph=None,
                 bubble_closure: bool = False, mesh=None,
                 range_mode: Optional[str] = None):
        import os

        self.index = index
        self.engine = engine
        self.export_subgraphs = export_subgraphs
        self.graph = graph  # needed only for subgraph-path export
        # data-parallel mesh: POA chunks are sharded along the batch dim
        # (problems are independent; no collectives)
        self.mesh = mesh
        # opt-in: splice one-hop bubble alt-alleles into the
        # chain-implied subgraph (close_bubbles).  Recovers alt alleles
        # the reference's contiguous-id range drops, but on bubble-dense
        # spoa/smooth graphs the extra edges let the global POA wander
        # into degenerate regions (measured net accuracy LOSS on
        # 8-C3107), so it is not the default.
        self.bubble_closure = bubble_closure
        # chain->subgraph strategy: "corridor" (default) is the
        # topology-aware range (find_range_chain_corridor) — a
        # documented accuracy divergence from the reference's
        # contiguous-id range, which both loses bubble alt-alleles and
        # blows subgraphs up to the whole backbone when an anchor lands
        # on a high-id alt node (measured: 9-G-3135 path Jaccard
        # 0.88 -> 1.00, max subgraph 4147 -> 442 vertices).  "id" is
        # strict reference parity (align.rs:267-402).
        explicit_mode = range_mode is not None
        if range_mode is None:
            range_mode = os.environ.get("VGALIGNER_RANGE_MODE", "corridor")
        if bubble_closure:
            if explicit_mode and range_mode == "corridor":
                log.warning(
                    "--bubble-closure operates on the contiguous-id "
                    "range; overriding the requested "
                    "--range-mode corridor with 'id'"
                )
            range_mode = "id"  # closure operates on the id range
        if range_mode not in ("corridor", "id"):
            raise ValueError(f"unknown range_mode {range_mode!r}")
        self.range_mode = range_mode
        # corridor-mode tie-break width: align up to this many tied
        # chains and keep the best POA score (_chains_for_alignment /
        # _select_best).  DEFAULT 1 (earliest copy only): global-mode
        # POA scores are NOT comparable across chains — each chain's
        # corridor has different flank slack, and the global alignment
        # pays subgraph-dependent flank-deletion penalties (measured:
        # width 4 moved 4-A3105 path Jaccard 0.887 -> 0.780 and
        # 20-C3107-smooth 0.948 -> 0.921).  Kept as an experimentation
        # knob; a principled version needs flank-penalty-free scoring.
        self.tie_align_n = int(os.environ.get("VGALIGNER_TIE_ALIGN_N", "1"))

    def _chains_for_alignment(self, chains: List[Chain], n: int) -> List[Chain]:
        """Pick the chains to base-level align (align.rs:34-55 takes the
        first align_best_n).

        Every chain in the list achieved the global max chain score
        (chain.rs:469 backtracks only those), so on multi-copy regions
        (e.g. 4-A3105's duplicated gene) the list holds one tied chain
        per copy — and the reference's backtrack order (chain.rs:465,
        last anchor first) puts the HIGHEST-position copy first, while
        the embedded-path coordinate convention (vg sim reads, P-lines)
        is the earliest copy.  In corridor (accuracy) mode, prefer the
        earliest target start among the tied chains AND base-level
        align up to tie_align_n of them — _select_best then keeps the
        best POA score, which picks the copy the read actually matches
        when the tied copies' spellings differ; id (parity) mode keeps
        the reference order and width."""
        if self.range_mode == "corridor" and len(chains) > 1:
            order = sorted(
                range(len(chains)),
                key=lambda i: (
                    (1 << 62) if chains[i].is_placeholder
                    else int(chains[i].atb[0]),
                    i,
                ),
            )
            chains = [chains[i] for i in order]
            n = max(n, self.tie_align_n)
        return chains[: min(n, len(chains))]

    def _range_for_chain(self, chain: Chain) -> OrientedGraphRange:
        """Chain -> subgraph range under this aligner's range_mode
        (Python path; mirrors the native vg_extract_subgraphs modes)."""
        if self.range_mode == "corridor":
            rng = find_range_chain_corridor(self.index, chain)
            if rng is not None:
                return rng
        rng = extend_range_chain(
            self.index, chain, find_range_chain(self.index, chain)
        )
        if self.bubble_closure:
            rng = close_bubbles(self.index, rng)
        return rng

    def best_alignment_for_query(self, chains: List[Chain], align_best_n: int = 1) -> GAFAlignment:
        """align.rs:34-55."""
        alignments: List[GAFAlignment] = []
        for chain in self._chains_for_alignment(chains, align_best_n):
            if chain.is_placeholder:
                alignments.append(GAFAlignment.from_placeholder_chain(chain))
            else:
                alignments.append(self.obtain_base_level_alignment(chain))
        if len(alignments) == 1:
            return alignments[0]
        if self.range_mode == "corridor" and any(
            getattr(a, "poa_score", None) is not None for a in alignments
        ):
            alignments.sort(
                key=_corridor_score_key,
                reverse=True,
            )
        else:
            alignments.sort(
                key=lambda a: -1 if a.path_length is None else a.path_length,
                reverse=True,
            )
        return alignments[0]

    def best_alignments_for_queries(
        self, per_read_chains: List[List[Chain]], align_best_n: int = 1
    ) -> List[GAFAlignment]:
        """Batched --also-align: all chain subgraphs extracted (natively
        when built), then aligned in ONE device POA batch — global
        convex-gap for the abPOA engine, local no-gap for rspoa.  Per
        read, the longest path_length wins (align.rs:52-54)."""
        return self.finish_alignments(
            self.begin_alignments(per_read_chains, align_best_n)
        )

    def begin_alignments(
        self, per_read_chains: List[List[Chain]], align_best_n: int = 1
    ):
        """Dispatch a batch's POA work to the device WITHOUT draining it.

        Returns an opaque state for finish_alignments.  With the native
        abPOA path the device kernels are queued asynchronously, so a
        caller can overlap this batch's compute with host work on the
        next batch (the streaming pipeline in models/stream.py); other
        engine/fallback combinations compute eagerly inside begin and
        finish just returns the stored result.
        """
        if self.engine != PoaEngine.ABPOA:
            return ("eager", self._best_alignments_rspoa(per_read_chains, align_best_n))

        from ..native import available as _native_ok

        selected: List[Tuple[int, Chain]] = []
        placeholders: dict = {}
        for qi, chains in enumerate(per_read_chains):
            for chain in self._chains_for_alignment(chains, align_best_n):
                if chain.is_placeholder:
                    placeholders.setdefault(qi, GAFAlignment.from_placeholder_chain(chain))
                    continue
                selected.append((qi, chain))

        if selected and _native_ok():
            pending_state = self._dispatch_chains_native([c for _, c in selected])
            return ("native", per_read_chains, selected, placeholders, pending_state)
        return ("fallback", per_read_chains, selected, placeholders)

    def finish_alignments(self, state) -> List[GAFAlignment]:
        """Drain a begin_alignments batch and emit per-read best GAF."""
        if state[0] == "eager":
            return state[1]
        if state[0] == "native":
            _tag, per_read_chains, selected, placeholders, pending_state = state
            per_read: dict = {qi: [a] for qi, a in placeholders.items()}
            for (qi, chain), (res, handles) in zip(
                selected, self._finish_chains_native(pending_state)
            ):
                a = GAFAlignment.from_abpoa_result(res, chain, handles)
                a.poa_score = res.best_score
                a.poa_cs = res.cs  # trim scored lazily, ties only
                per_read.setdefault(qi, []).append(a)
            return self._select_best(per_read_chains, per_read)
        _tag, per_read_chains, selected, placeholders = state
        per_read = {qi: [a] for qi, a in placeholders.items()}
        if selected:
            problems = []
            owners: List[Tuple[int, Chain, OrientedGraphRange]] = []
            for qi, chain in selected:
                rng = self._range_for_chain(chain)
                nodes, edges = find_nodes_edges(self.index, rng)
                if self.export_subgraphs and self.graph is not None:
                    from ..io.validate import create_subgraph_gfa, export_gfa

                    export_gfa(
                        create_subgraph_gfa(nodes, edges, get_subgraph_paths(self.graph, rng)),
                        f"{chain.query.name}-subgraph-{chain.n_anchors}.gfa",
                    )
                problems.append((nodes, edges, chain.query.seq))
                owners.append((qi, chain, rng))

            from ..ops.poa_device import align_global_batch

            results = align_global_batch(problems)
            for (qi, chain, rng), res in zip(owners, results):
                _rebase_trimmed_offsets(res, rng)
                a = GAFAlignment.from_abpoa_result(res, chain, rng.handles)
                a.poa_score = res.best_score
                a.poa_cs = res.cs  # trim scored lazily, ties only
                per_read.setdefault(qi, []).append(a)

        return self._select_best(per_read_chains, per_read)

    @staticmethod
    def trimmed_poa_score(cs: str) -> int:
        """Flank-penalty-free POA score from a cs difference string:
        the global score of ONLY the matched span, with leading and
        trailing deletion runs (the corridor's flank slack, which the
        global alignment deletes through) stripped.

        Raw global scores are NOT comparable across tied chains — each
        chain's corridor carries different flank slack, so the r4
        best-raw-score tie-break measured WORSE (NOTES.md: 4-A3105
        0.887 -> 0.780).  Trimming the flank deletions makes the
        candidates commensurable: what remains scores exactly the
        read-vs-copy alignment (match +2, mismatch -4, two-piece gaps
        min(4+2g, 24+g) — abPOA defaults, ops/poa.py:35-45)."""
        from ..ops.poa import MATCH, MISMATCH, gap_cost

        runs = []  # (op, length) with op in ':*+-'
        i = 0
        if cs.startswith("cs:Z:"):
            i = 5
        n = len(cs)
        while i < n:
            op = cs[i]
            i += 1
            if op == ":":
                j = i
                while j < n and cs[j].isdigit():
                    j += 1
                runs.append((op, int(cs[i:j])))
                i = j
            elif op == "*":
                runs.append((op, 1))
                i += 2  # ref base + query base
            elif op in "+-":
                j = i
                while j < n and cs[j] not in ":*+-":
                    j += 1
                runs.append((op, j - i))
                i = j
            else:  # unknown tail (e.g. ',cg:Z:...' suffix): stop
                break
        # strip flank deletion runs
        a, b = 0, len(runs)
        while a < b and runs[a][0] == "-":
            a += 1
        while b > a and runs[b - 1][0] == "-":
            b -= 1
        score = 0
        for op, ln in runs[a:b]:
            if op == ":":
                score += MATCH * ln
            elif op == "*":
                score += MISMATCH * ln
            else:
                score -= gap_cost(ln)
        return score

    def _select_best(self, per_read_chains, per_read: dict) -> List[GAFAlignment]:
        """Per read, keep the longest path_length (align.rs:52-54); in
        corridor mode, the best POA score wins first (ties keep the
        earliest-copy order, which the candidate list is already in)."""
        out: List[GAFAlignment] = []
        corridor = self.range_mode == "corridor"
        for qi in range(len(per_read_chains)):
            alns = per_read.get(qi, [])
            if len(alns) == 1:
                out.append(alns[0])
                continue
            if corridor and any(
                getattr(a, "poa_score", None) is not None for a in alns
            ):
                alns.sort(
                    key=_corridor_score_key,
                    reverse=True,
                )
            else:
                alns.sort(
                    key=lambda a: -1 if a.path_length is None else a.path_length,
                    reverse=True,
                )
            out.append(alns[0])
        return out

    def _best_alignments_rspoa(
        self, per_read_chains: List[List[Chain]], align_best_n: int
    ) -> List[GAFAlignment]:
        """rspoa engine: batched local no-gap device alignment."""
        from ..ops.poa_device import align_local_batch

        problems = []
        owners: List[Tuple[int, Chain, OrientedGraphRange]] = []
        per_read: dict = {}
        for qi, chains in enumerate(per_read_chains):
            for chain in self._chains_for_alignment(chains, align_best_n):
                if chain.is_placeholder:
                    per_read.setdefault(qi, []).append(
                        GAFAlignment.from_placeholder_chain(chain)
                    )
                    continue
                rng = self._range_for_chain(chain)
                nodes, edges = find_nodes_edges(self.index, rng)
                problems.append((nodes, edges, chain.query.seq))
                owners.append((qi, chain, rng))

        if problems:
            for (qi, chain, rng), res in zip(owners, align_local_batch(problems)):
                _rebase_trimmed_offsets(res, rng)
                a = GAFAlignment.from_rspoa_result(res, chain, rng.handles)
                a.poa_score = res.best_score
                per_read.setdefault(qi, []).append(a)

        return self._select_best(per_read_chains, per_read)

    def _align_chains_native(self, chains: List[Chain]):
        """Fully native --also-align batch: dispatch + drain in one call.
        Returns a list of (PoaResult, range_handles) aligned with
        `chains`."""
        return self._finish_chains_native(self._dispatch_chains_native(chains))

    def _dispatch_chains_native(self, chains: List[Chain]):
        """Fully native --also-align batch: C++ subgraph extraction +
        problem prep around the device POA kernel, dispatched WITHOUT a
        host sync (host-oracle oversize/fan-in outliers complete
        eagerly).  Node labels never materialize as Python strings.
        Returns the pending state for _finish_chains_native."""
        import numpy as np

        from ..native import build_poa_batch_arrays, extract_subgraphs_native
        from ..ops.poa_device import P_MAX, _l_pad_for, _next_pow2
        from ..utils.dna import encode_seq

        n = len(chains)
        n_anchors = np.asarray([c.n_anchors for c in chains], dtype=np.int64)
        anchor_off = np.concatenate([[0], np.cumsum(n_anchors)])
        aqb = np.concatenate([c.aqb for c in chains])
        atb = np.concatenate([c.atb for c in chains])
        ate = np.concatenate([c.ate for c in chains])
        any_orient = any(c.aso is not None for c in chains)
        aso = aeo = None
        if any_orient:
            aso = np.concatenate(
                [c.aso if c.aso is not None else np.zeros(c.n_anchors, np.int8) for c in chains]
            )
            aeo = np.concatenate(
                [c.aeo if c.aeo is not None else np.zeros(c.n_anchors, np.int8) for c in chains]
            )
        qlen = np.asarray([len(c.query.seq) for c in chains], dtype=np.int64)
        k = chains[0].k

        (handle_off, handles, label_off, lbase, labels, edge_off, edges,
         status) = (
            extract_subgraphs_native(
                self.index, anchor_off, aqb, atb, ate, aso, aeo, qlen, k,
                bubble_closure=self.bubble_closure,
                range_mode=self.range_mode,
            )
        )
        if status.any():
            # reproduce the Python path's failure (BFS guard): it raises
            bad = int(np.nonzero(status)[0][0])
            extend_range_chain(
                self.index, chains[bad], find_range_chain(self.index, chains[bad])
            )
            raise RuntimeError("native extraction failed but Python path succeeded")

        if self.export_subgraphs and self.graph is not None:
            # the reference exports every chain's subgraph unconditionally
            # (map.rs:164 passes true; align.rs:104-120)
            from ..io.validate import create_subgraph_gfa, export_gfa

            for i, chain in enumerate(chains):
                nodes = [
                    labels[label_off[j] : label_off[j + 1]].decode("ascii")
                    for j in range(handle_off[i], handle_off[i + 1])
                ]
                prob_edges = [
                    (int(a), int(b)) for a, b in edges[edge_off[i] : edge_off[i + 1]]
                ]
                rng = OrientedGraphRange(
                    orient=RangeOrient.FORWARD,
                    handles=handles[handle_off[i] : handle_off[i + 1]].tolist(),
                )
                export_gfa(
                    create_subgraph_gfa(
                        nodes, prob_edges, get_subgraph_paths(self.graph, rng)
                    ),
                    f"{chain.query.name}-subgraph-{chain.n_anchors}.gfa",
                )

        qs = [encode_seq(c.query.seq) for c in chains]
        v_per = label_off[handle_off[1:]] - label_off[handle_off[:-1]]
        buckets: dict = {}
        oversize: List[int] = []
        for i in range(n):
            if int(v_per[i]) > _V_DEVICE_CAP:
                # rare huge subgraphs (e.g. smoothed graphs with long
                # merged nodes): the host oracle beats compiling a
                # one-off multi-minute executable for an outlier shape
                oversize.append(i)
                continue
            key = (
                _next_pow2(max(int(v_per[i]), 256)),
                _l_pad_for(len(qs[i])),
            )
            buckets.setdefault(key, []).append(i)
        for idxs in buckets.values():
            # ascending V: the DP loop runs to each chunk's max nv, so
            # grouping small problems keeps chunk bounds tight
            idxs.sort(key=lambda i: int(v_per[i]))

        out = [None] * n
        edges_flat = np.ascontiguousarray(edges.reshape(-1), dtype=np.int64)
        # dispatch every bucket before any host sync: kernels queue on
        # device back-to-back, then one fetch pass drains them.  On the
        # wire path, chunk buffers are PREPARED per bucket but uploaded
        # in one device_put for the whole drain.
        from ..ops.poa_device import (
            kernel_dispatch_chunked,
            kernel_launch_wires,
            kernel_prepare_chunked,
            padded_rows,
            wire2_path_available,
        )

        pending = []
        use_wire = wire2_path_available(self.mesh)
        prepared_all = []  # flattened prepared chunks across buckets
        deferred = []  # (index into pending, n_chunks) per wire bucket

        for (v_pad, l_pad), idxs in sorted(buckets.items()):
            sel = np.asarray(idxs, dtype=np.int64)
            built = build_poa_batch_arrays(
                labels, label_off, handle_off.astype(np.int64),
                edge_off.astype(np.int64), edges_flat, sel, v_pad, P_MAX,
                rows=padded_rows(len(idxs), v_pad, l_pad),
            )
            if built is None:
                # fan-in above P_MAX: decode these problems to Python
                # objects and use the host oracle (rare)
                from ..ops.poa import align_global_host

                for i in idxs:
                    nodes = [
                        labels[label_off[j] : label_off[j + 1]].decode("ascii")
                        for j in range(handle_off[i], handle_off[i + 1])
                    ]
                    prob_edges = [
                        (int(a), int(b))
                        for a, b in edges[edge_off[i] : edge_off[i + 1]]
                    ]
                    out[i] = align_global_host(nodes, prob_edges, chains[i].query.seq)
                continue
            if use_wire:
                prep = kernel_prepare_chunked(
                    built, [qs[i] for i in idxs], v_pad, l_pad
                )
                deferred.append((len(pending), len(prep)))
                prepared_all.extend(prep)
                pending.append((idxs, prep))  # placeholder, filled below
            else:
                pending.append(
                    (idxs, kernel_dispatch_chunked(
                        built, [qs[i] for i in idxs], v_pad, l_pad,
                        mesh=self.mesh,
                    ))
                )
        if prepared_all:
            ps_flat = kernel_launch_wires(prepared_all)
            pos = 0
            for pi, n_chunks in deferred:
                pending[pi] = (pending[pi][0], ps_flat[pos : pos + n_chunks])
                pos += n_chunks
        if oversize:
            from ..native import poa_global_host_native

            for i in oversize:
                nodes = [
                    labels[label_off[j] : label_off[j + 1]].decode("ascii")
                    for j in range(handle_off[i], handle_off[i + 1])
                ]
                prob_edges = [
                    (int(a), int(b)) for a, b in edges[edge_off[i] : edge_off[i + 1]]
                ]
                out[i] = poa_global_host_native(nodes, prob_edges, chains[i].query.seq)

        return (n, out, pending, handles, handle_off, lbase)

    def _finish_chains_native(self, state):
        """Drain a _dispatch_chains_native batch (ONE device_get for all
        buckets' chunks) and pair results with their range handles."""
        from ..ops.poa_device import kernel_finish_all

        n, out, pending, handles, handle_off, lbase = state
        if pending:
            flat_ps = [p for _idxs, ps in pending for p in ps]
            res_flat = kernel_finish_all(flat_ps)
            pos = 0
            for idxs, ps in pending:
                n_bucket = sum(p[7] for p in ps)  # n_real per chunk
                for i, res in zip(idxs, res_flat[pos : pos + n_bucket]):
                    out[i] = res
                pos += n_bucket

        res_handles = []
        for i in range(n):
            res = out[i]
            lb = lbase[handle_off[i] : handle_off[i + 1]]
            if res.node_path and lb.any():
                # rebase node offsets to UNTRIMMED node coordinates:
                # corridor flank trims cut the front of the start node's
                # label, so offsets computed on the trimmed label
                # under-report by the trim start
                res.path_start_offset += int(lb[res.node_path[0]])
                res.path_end_offset += int(lb[res.node_path[-1]])
            res_handles.append(
                (res, handles[handle_off[i] : handle_off[i + 1]].tolist())
            )
        return res_handles

    def obtain_base_level_alignment(self, chain: Chain) -> GAFAlignment:
        """align.rs:58-145."""
        extended = self._range_for_chain(chain)
        nodes, edges = find_nodes_edges(self.index, extended)

        if self.export_subgraphs and self.graph is not None:
            from ..io.validate import create_subgraph_gfa, export_gfa

            paths = get_subgraph_paths(self.graph, extended)
            export_gfa(
                create_subgraph_gfa(nodes, edges, paths),
                f"{chain.query.name}-subgraph-{chain.n_anchors}.gfa",
            )

        if self.engine == PoaEngine.RSPOA:
            from ..ops.poa import align_local_no_gap_host

            res = align_local_no_gap_host(nodes, edges, chain.query.seq)
            _rebase_trimmed_offsets(res, extended)
            a = GAFAlignment.from_rspoa_result(res, chain, extended.handles)
            a.poa_score = res.best_score
            return a

        from ..ops.poa import align_global_host

        res = align_global_host(nodes, edges, chain.query.seq)
        _rebase_trimmed_offsets(res, extended)
        a = GAFAlignment.from_abpoa_result(res, chain, extended.handles)
        a.poa_score = res.best_score
        a.poa_cs = res.cs  # trim scored lazily, ties only
        return a
