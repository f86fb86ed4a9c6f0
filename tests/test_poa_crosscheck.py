"""Independent cross-validation of the POA scoring engine.

Every device/native POA path is tested against `ops/poa.py`, written
by the same author to the same assumptions — a systematic misreading
of abPOA's semantics would pass every test.  This file is the antidote: a **textbook implementation of
partial-order alignment with two-piece (convex) affine gaps, written
directly from the published recurrences** — Lee, Grasso & Sharlow 2002
(POA: the DP runs over DAG vertices in topological order, predecessors
replace the single "previous cell" of Needleman-Wunsch) combined with
Gotoh's affine-gap state machine, extended to two gap classes exactly
as the abPOA paper describes its convex mode (Gao et al. 2021,
Bioinformatics 37(15), "abPOA: an SIMD-based C library for fast
partial order alignment using adaptive banded dynamic programming";
gap(l) = min(o1 + l*e1, o2 + l*e2), scores M=2, X=4, O=4,24, E=2,1 —
the library's documented defaults, which `AbpoaAligner::
new_with_example_params` adopts unchanged from abpoa_init_para, see
/root/reference/src/align.rs:1076).

Deliberately naive: serial per-column F loops (no closed forms), dense
per-vertex E/F/H tables, its own base-level graph expansion and its own
topological sort.  Shares NOTHING with ops/poa.py except the published
parameter values.  If the oracle's closed-form in-row recurrence, its
predecessor handling, or its virtual-source conventions misread the
semantics, the 1,000-case randomized battery below will diverge.
"""

import numpy as np
import pytest

from vgaligner_tpu.ops import poa as ORACLE
from vgaligner_tpu.ops.poa import align_global_host

# abPOA's documented default scoring (abPOA README "Usage": -M 2 -X 4
# -O 4,24 -E 2,1; abpoa.h ABPOA_MATCH/ABPOA_MISMATCH/ABPOA_GAP_OPEN1/
# ABPOA_GAP_EXT1/ABPOA_GAP_OPEN2/ABPOA_GAP_EXT2).  rs-abpoa's
# new_with_example_params wraps abpoa_init_para without overriding the
# scoring, so these are the reference's effective parameters.
ABPOA_MATCH = 2
ABPOA_MISMATCH = 4  # penalty (positive in abPOA's convention)
ABPOA_GAP_OPEN1, ABPOA_GAP_EXT1 = 4, 2
ABPOA_GAP_OPEN2, ABPOA_GAP_EXT2 = 24, 1

NEG = float("-inf")


def test_oracle_constants_match_abpoa_defaults():
    """Pin ops/poa.py's constants to abPOA's published defaults."""
    assert ORACLE.MATCH == ABPOA_MATCH
    assert ORACLE.MISMATCH == -ABPOA_MISMATCH
    assert ORACLE.GAP_OPEN1 == ABPOA_GAP_OPEN1
    assert ORACLE.GAP_EXT1 == ABPOA_GAP_EXT1
    assert ORACLE.GAP_OPEN2 == ABPOA_GAP_OPEN2
    assert ORACLE.GAP_EXT2 == ABPOA_GAP_EXT2
    # convex combination: gap_cost must be the min of the two pieces
    for l in (1, 2, 9, 10, 11, 40):
        assert ORACLE.gap_cost(l) == min(
            ABPOA_GAP_OPEN1 + l * ABPOA_GAP_EXT1,
            ABPOA_GAP_OPEN2 + l * ABPOA_GAP_EXT2,
        )


# ---------------------------------------------------------------------------
# The independent checker
# ---------------------------------------------------------------------------


def _expand(nodes, edges):
    """Abstraction nodes -> base-level DAG (own code: one vertex per
    base; intra-node chain edges; node edge (a,b) connects a's last base
    to b's first).  Returns (bases, preds) in a topological order
    computed here by Kahn's algorithm over the NODE graph."""
    n = len(nodes)
    indeg = [0] * n
    out = [[] for _ in range(n)]
    for a, b in edges:
        if a == b:
            continue
        out[a].append(b)
        indeg[b] += 1
    order, queue = [], [i for i in range(n) if indeg[i] == 0]
    while queue:
        a = queue.pop(0)
        order.append(a)
        for b in sorted(out[a]):
            indeg[b] -= 1
            if indeg[b] == 0:
                queue.append(b)
    assert len(order) == n, "cyclic input"

    first, last = {}, {}
    bases, preds = [], []
    for nid in order:
        prev = None
        for ch in nodes[nid]:
            vid = len(bases)
            bases.append(ch)
            preds.append([] if prev is None else [prev])
            if prev is None:
                first[nid] = vid
            prev = vid
        last[nid] = prev
    for a, b in edges:
        if a != b:
            preds[first[b]].append(last[a])
    node_sinks = set(range(n)) - {a for a, b in edges if a != b}
    sinks = [last[nid] for nid in node_sinks]
    sources = [v for v in range(len(bases)) if not preds[v]]
    return bases, preds, sources, sinks


def poa_global_score_reference(nodes, edges, query):
    """Best global POA score, straight from the published recurrences.

    States per vertex v and query position j (1-based j over query):
      Hs[v][j]  best score of an alignment of q[:j] to a source->v path
                ending with v matched/mismatched or v's row gap states;
      E1/E2[v][j]  ... ending with v DELETED (graph gap, class c);
      F1/F2[v][j]  ... ending with q[j] INSERTED (query gap, class c).
    The virtual source row H0 handles leading insertions serially via
    its own F states (no closed form).  Global answer: max over sink
    vertices of Hs[sink][L].
    """
    bases, preds, sources, sinks = _expand(nodes, edges)
    L = len(query)
    o1, e1 = ABPOA_GAP_OPEN1, ABPOA_GAP_EXT1
    o2, e2 = ABPOA_GAP_OPEN2, ABPOA_GAP_EXT2

    # virtual source row: j leading insertions, per-class serial Gotoh
    H0 = [0.0] * (L + 1)
    f1 = f2 = NEG
    for j in range(1, L + 1):
        f1 = max(H0[j - 1] - o1 - e1, f1 - e1)
        f2 = max(H0[j - 1] - o2 - e2, f2 - e2)
        H0[j] = max(f1, f2)

    V = len(bases)
    H = [[NEG] * (L + 1) for _ in range(V)]
    E1 = [[NEG] * (L + 1) for _ in range(V)]
    E2 = [[NEG] * (L + 1) for _ in range(V)]
    for v in range(V):
        pv = preds[v]
        ph = [H0] if not pv else [H[p] for p in pv]
        pe1 = [None] if not pv else [E1[p] for p in pv]
        pe2 = [None] if not pv else [E2[p] for p in pv]
        for j in range(L + 1):
            best_e1 = best_e2 = NEG
            for hp, ep1, ep2 in zip(ph, pe1, pe2):
                best_e1 = max(best_e1, hp[j] - o1 - e1)
                best_e2 = max(best_e2, hp[j] - o2 - e2)
                if ep1 is not None:
                    best_e1 = max(best_e1, ep1[j] - e1)
                    best_e2 = max(best_e2, ep2[j] - e2)
            E1[v][j] = best_e1
            E2[v][j] = best_e2
        f1 = f2 = NEG
        for j in range(L + 1):
            m = NEG
            if j > 0:
                ok = query[j - 1] == bases[v] and query[j - 1] in "ACGT"
                s = ABPOA_MATCH if ok else -ABPOA_MISMATCH
                for hp in ph:
                    m = max(m, hp[j - 1] + s)
            h = max(m, E1[v][j], E2[v][j])
            if j > 0:
                f1 = max(H[v][j - 1] - o1 - e1, f1 - e1)
                f2 = max(H[v][j - 1] - o2 - e2, f2 - e2)
                h = max(h, f1, f2)
            H[v][j] = h
    return max(H[s][L] for s in sinks)


# ---------------------------------------------------------------------------
# Randomized battery
# ---------------------------------------------------------------------------


def _random_case(rng):
    n_nodes = int(rng.integers(1, 7))
    nodes = [
        "".join("ACGT"[c] for c in rng.integers(0, 4, int(rng.integers(1, 6))))
        for _ in range(n_nodes)
    ]
    edges = []
    for b in range(1, n_nodes):
        n_in = min(b, int(rng.integers(1, 3)))
        for a in rng.choice(b, size=n_in, replace=False):
            edges.append((int(a), b))
    # query: a mutated random source->sink walk (indels + substitutions),
    # occasionally pure random (stress far-from-graph inputs)
    if rng.random() < 0.15:
        q = "".join("ACGTN"[c] for c in rng.integers(0, 5, int(rng.integers(1, 15))))
    else:
        succ = {}
        for a, b in edges:
            succ.setdefault(a, []).append(b)
        cur, seq = 0, nodes[0]
        while cur in succ:
            cur = int(rng.choice(succ[cur]))
            seq += nodes[cur]
        s = list(seq)
        for i in range(len(s)):
            r = rng.random()
            if r < 0.08:
                s[i] = "ACGTN"[int(rng.integers(0, 5))]
            elif r < 0.13:
                s[i] = s[i] + "ACGT"[int(rng.integers(0, 4))]
            elif r < 0.20:
                s[i] = ""
        q = "".join(s) or "A"
    return nodes, edges, q


@pytest.mark.parametrize("chunk", range(4))
def test_global_scores_match_independent_reference(chunk):
    """1,000 random (graph, query) cases: ops/poa.py's global score must
    equal the independently-derived textbook score exactly."""
    rng = np.random.default_rng(1000 + chunk)
    for i in range(250):
        nodes, edges, q = _random_case(rng)
        want = poa_global_score_reference(nodes, edges, q)
        got = align_global_host(nodes, edges, q).best_score
        assert got == want, (
            f"case {chunk}:{i}: oracle {got} != independent {want} "
            f"nodes={nodes} edges={edges} q={q!r}"
        )


def poa_local_nogap_score_reference(nodes, edges, query):
    """Best local gapless score, straight from the definition: a
    Smith-Waterman recurrence restricted to match/mismatch moves over
    DAG predecessors, zero floor, best cell anywhere (the rspoa
    align_local_no_gap engine, /root/reference/src/align.rs:160-164)."""
    bases, preds, _sources, _sinks = _expand(nodes, edges)
    L = len(query)
    H = [[0.0] * (L + 1) for _ in range(len(bases))]
    best = 0.0
    for v in range(len(bases)):
        for j in range(1, L + 1):
            p_best = 0.0
            for p in preds[v]:
                p_best = max(p_best, H[p][j - 1])
            ok = query[j - 1] == bases[v] and query[j - 1] in "ACGT"
            s = ABPOA_MATCH if ok else -ABPOA_MISMATCH
            H[v][j] = max(0.0, p_best + s)
            best = max(best, H[v][j])
    return best


@pytest.mark.parametrize("chunk", range(2))
def test_local_nogap_scores_match_independent_reference(chunk):
    from vgaligner_tpu.ops.poa import align_local_no_gap_host

    rng = np.random.default_rng(2000 + chunk)
    for i in range(250):
        nodes, edges, q = _random_case(rng)
        want = poa_local_nogap_score_reference(nodes, edges, q)
        got = align_local_no_gap_host(nodes, edges, q).best_score
        assert got == want, (
            f"case {chunk}:{i}: oracle {got} != independent {want} "
            f"nodes={nodes} edges={edges} q={q!r}"
        )


def test_long_gap_switches_to_second_affine_piece():
    """A 12-base deletion costs o2 + 12*e2 = 36 (not o1 + 12*e1 = 28?
    no: min(4+24, 24+12) = 28 vs 36 -> piece 1 still wins at 12; at
    l=21 piece 2 wins: min(4+42, 24+21) = 45).  Check the crossover
    against both engines on a two-branch bubble."""
    for l, cost in ((3, 10), (10, 24), (21, 45), (30, 54)):
        middle = "G" * l
        nodes = ["AC", middle, "TT"]
        edges = [(0, 1), (1, 2)]
        q = "ACTT"  # deletes the whole middle node
        want = poa_global_score_reference(nodes, edges, q)
        got = align_global_host(nodes, edges, q).best_score
        assert got == want
        assert want == 4 * ABPOA_MATCH - cost
