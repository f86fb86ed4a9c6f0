"""Batched device kernel for global partial-order alignment.

The device replacement for the abPOA C library call (the reference's
only FFI boundary, rs-vgaligner src/align.rs:170-224): many chain-implied
subgraph alignments run as ONE jitted program, vmapped over problems.

Formulation (see ops/poa.py for the scalar oracle with identical
scoring and tie-breaks):

  * the base-level DAG is topologically ordered host-side; vertex
    predecessors are padded slot lists [V, P];
  * one lax.scan step per vertex; predecessor rows are gathered from the
    carried H/E1/E2 matrices (virtual-source row stored at index V);
  * the within-row insertion recurrence (F1/F2 with two-piece affine
    gaps) is solved in *closed form*: under abPOA's defaults every
    in-row gap run opens from an h_pre column (cross-class switches and
    re-opens are strictly dominated whenever o1,o2>0, o1+e1>e2 and
    o2+e2>e1), so f_c[j] = max_{m<j}(h_pre[m] + e_c*m) - o_c - e_c*j —
    two shifted prefix-maxes replace the serial L-step loop (the
    "anti-diagonal" trick of SURVEY §5 folded into closed form);
  * per-cell traceback decisions are packed into one int32 and the
    traceback itself runs on device as a fixed-length scan emitting the
    op tape (traceback_batch), so only the compact tape reaches the
    host;
  * on NVIDIA GPUs the DP runs as a CUDA kernel (ops/poa_cuda.py) with
    the same outputs; poa_dp_xla is the CPU path and its parity oracle.

Scores are int32-valued f32 (match 2 / mismatch -4 / gaps 4,2 + 24,1 —
abPOA defaults); every value is exactly representable.
"""

from __future__ import annotations

import functools
import logging
import os
from functools import partial
from typing import List, NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .poa import (
    GAP_EXT1,
    GAP_EXT2,
    GAP_OPEN1,
    GAP_OPEN2,
    MATCH,
    MISMATCH,
    BaseGraph,
    build_base_graph,
)

NEGF = np.float32(-1.0e9)
P_MAX = 8  # predecessor slots per vertex (fan-in above this is rejected)

# module-level phase timer for the dispatch/finish hot path (shared with
# profile_pipeline.py; negligible overhead when unused)
from ..utils.timing import PhaseTimer

timer = PhaseTimer()
log = logging.getLogger(__name__)

# op codes on the traceback tape
OP_M, OP_I, OP_D, OP_END = 0, 1, 2, 3

# traceback bit layout (int32):
#   0-2   case at H (0 match, 1 E1, 2 E2, 3 F1, 4 F2)
#   3-6   match predecessor slot (15 = virtual source)
#   7     E1 opened (vs extended)      8-11  E1 predecessor slot
#   12    E2 opened                    13-16 E2 predecessor slot
#   17    F1 opened                    18    F2 opened
_CASE_M, _CASE_E1, _CASE_E2, _CASE_F1, _CASE_F2 = 0, 1, 2, 3, 4
_VIRT_SLOT = 15


def _slice_preds(vpred: np.ndarray, n_real: int = -1) -> np.ndarray:
    """Slice the predecessor slot dim to the batch's max live fan-in
    (pow2 ladder 2/4/8).  Base-graph vertices almost always have 1-2
    predecessors; the DP's per-step cost scales with the slot count, so
    shipping 8 slots for a fan-in-2 batch more than triples the kernel
    time.  P is shape-derived (static) in the kernels.

    n_real bounds the fan-in scan to the REAL batch rows: ladder-padded
    rows are calloc'd to zero, and a zero slot reads as live predecessor
    0, which silently forced p_use back to 8 on any padded chunk."""
    if vpred.size == 0:
        return vpred
    live = vpred if n_real < 0 else vpred[:n_real]
    fan = int((live >= 0).sum(axis=-1).max()) if live.size else 1
    p_use = 2 if fan <= 2 else (4 if fan <= 4 else P_MAX)
    if p_use == vpred.shape[-1]:
        return vpred
    return np.ascontiguousarray(vpred[..., :p_use])


class PoaProblem(NamedTuple):
    """One padded POA problem (host side)."""

    vcodes: np.ndarray  # int8 [V]
    vpred: np.ndarray  # int32 [V, P_MAX] predecessor vertex ids, -1 pad/virtual
    is_sink: np.ndarray  # bool [V]
    nv: int
    q: np.ndarray  # int8 [L]
    nq: int


def prepare_problem(bg: BaseGraph, qcodes: np.ndarray, v_pad: int, l_pad: int) -> PoaProblem:
    V = len(bg.codes)
    if V > v_pad or len(qcodes) > l_pad:
        raise ValueError("problem exceeds pad")
    vcodes = np.full(v_pad, 4, dtype=np.int8)
    vcodes[:V] = bg.codes
    vpred = np.full((v_pad, P_MAX), -1, dtype=np.int32)
    for v, ps in enumerate(bg.preds):
        if len(ps) > P_MAX:
            raise ValueError(f"vertex fan-in {len(ps)} exceeds {P_MAX}")
        vpred[v, : len(ps)] = ps
    is_sink = np.zeros(v_pad, dtype=bool)
    is_sink[:V] = bg.is_sink
    q = np.full(l_pad, 4, dtype=np.int8)
    q[: len(qcodes)] = qcodes
    return PoaProblem(vcodes, vpred, is_sink, V, q, len(qcodes))


@jax.jit
def poa_dp_xla(vcodes, vpred, is_sink, nv, q, nq, init_row):
    """The DP section of one batch of global POA problems (XLA path).

    vcodes [B,V] int8, vpred [B,V,P], is_sink [B,V], nv [B], q [B,L] int8,
    nq [B], init_row [L+1] f32 (leading-insertion costs).
    Returns (score [B] f32, best_sink [B] i32, tbits [B,V,L+1] i32).

    The vertex loop runs to the *batch max* nv (a traced bound — XLA's
    while lowering costs the same per step as the static scan but skips
    the padding tail entirely; callers sort problems by V so chunk
    maxima stay tight).
    """
    B, V = vcodes.shape
    L = q.shape[1]
    P = vpred.shape[-1]  # static; callers slice to the chunk's max
    # fan-in (almost always 1-2 on base graphs), shrinking the per-step
    # predecessor row gather — the DP's dominant cost — from the 8-slot
    # worst case
    nv_max = jnp.max(nv)
    # vertices per loop step (one predecessor gather per block); must
    # divide V so dynamic_slice never clamps — production v_pads are
    # pow2 >= 256, so the default 8 always holds there
    K = int(os.environ.get("VGALIGNER_POA_DP_BLOCK", "8"))
    while V % K:
        K >>= 1
    oe1 = np.float32(GAP_OPEN1 + GAP_EXT1)
    oe2 = np.float32(GAP_OPEN2 + GAP_EXT2)
    e1 = np.float32(GAP_EXT1)
    e2 = np.float32(GAP_EXT2)

    def one(vcodes_b, vpred_b, is_sink_b, nv_b, q_b, nq_b):
        # H/E1/E2 packed along the row: one [V+1, 3W] state means ONE
        # predecessor row gather per vertex instead of three.
        W = L + 1
        S = jnp.full((V + 1, 3 * W), NEGF, dtype=jnp.float32)
        S = S.at[V, :W].set(init_row)  # virtual source row (H plane)
        tbits = jnp.zeros((V, W), dtype=jnp.int32)
        jcol = jnp.arange(W, dtype=jnp.float32)

        def compute(preds, vcode_v, Sp):
            """One vertex's row from its (already gathered and
            in-block-substituted) predecessor rows Sp [P, 3W]."""
            Hp = Sp[:, :W]
            E1p_raw = Sp[:, W : 2 * W]
            E2p_raw = Sp[:, 2 * W :]
            E1p = jnp.where(preds[:, None] >= 0, E1p_raw, NEGF)
            E2p = jnp.where(preds[:, None] >= 0, E2p_raw, NEGF)
            # mask out empty slots entirely EXCEPT slot 0 when the vertex
            # has no predecessors (then slot 0 acts as the virtual source)
            has_any = preds[0] >= 0
            slot_live = (preds >= 0) | ((jnp.arange(P) == 0) & ~has_any)
            live = slot_live[:, None]
            Hp = jnp.where(live, Hp, NEGF)
            E1p = jnp.where(live, E1p, NEGF)
            E2p = jnp.where(live, E2p, NEGF)

            # E states (graph gaps); per-column best slot + open/ext bit.
            # Slots and flags are recovered with compare + one-hot-select
            # reductions rather than per-column argmax/take_along_axis
            # gathers.
            p_iota = jnp.arange(P, dtype=jnp.int32)[:, None]

            def slot_min(cand, best):
                """First slot achieving the column max (argmax tie rule)."""
                return jnp.min(
                    jnp.where(cand == best[None, :], p_iota, P), axis=0
                ).astype(jnp.int32)

            def at_slot(flags, slot):
                """flags[slot[j], j] via one-hot select (bool flags)."""
                return jnp.max(flags & (p_iota == slot[None, :]), axis=0)

            open1 = Hp - oe1
            ext1 = E1p - e1
            cand1 = jnp.maximum(open1, ext1)
            best1 = jnp.max(cand1, axis=0)
            slot1 = slot_min(cand1, best1)
            opn1 = at_slot(open1 >= ext1, slot1)

            open2 = Hp - oe2
            ext2 = E2p - e2
            cand2 = jnp.maximum(open2, ext2)
            best2 = jnp.max(cand2, axis=0)
            slot2 = slot_min(cand2, best2)
            opn2 = at_slot(open2 >= ext2, slot2)

            # match/mismatch from (p, j-1)
            sub = jnp.where(q_b == vcode_v, np.float32(MATCH), np.float32(MISMATCH))
            sub = jnp.where((q_b >= 4) | (vcode_v >= 4), np.float32(MISMATCH), sub)
            m_cand = jnp.full((P, L + 1), NEGF, dtype=jnp.float32)
            m_cand = m_cand.at[:, 1:].set(Hp[:, :-1] + sub[None, :])
            m_best = jnp.max(m_cand, axis=0)
            m_slot = slot_min(m_cand, m_best)

            # combine M/E1/E2 (tie order M > E1 > E2)
            h_pre = jnp.maximum(m_best, jnp.maximum(best1, best2))
            case_pre = jnp.where(
                m_best >= jnp.maximum(best1, best2),
                _CASE_M,
                jnp.where(best1 >= best2, _CASE_E1, _CASE_E2),
            )

            # in-row F recurrence in closed form (see module docstring):
            # f_c[j] = max_{m<j}(h_pre[m] + e_c*m) - o_c - e_c*j.  The
            # traceback-visited values and decisions are identical to the
            # serial recurrence; only unreachable stored F values differ.
            c1 = jax.lax.cummax(h_pre + e1 * jcol)
            c2 = jax.lax.cummax(h_pre + e2 * jcol)
            neg1 = jnp.full((1,), NEGF, jnp.float32)
            f1_row = jnp.concatenate(
                [neg1, c1[:-1] - np.float32(GAP_OPEN1) - e1 * jcol[1:]]
            )
            f2_row = jnp.concatenate(
                [neg1, c2[:-1] - np.float32(GAP_OPEN2) - e2 * jcol[1:]]
            )
            h_row = jnp.maximum(h_pre, jnp.maximum(f1_row, f2_row))

            # decisions recovered from values (ties: hpre > F1 > F2;
            # open >= extend)
            case = jnp.where(
                h_row <= h_pre,
                case_pre,
                jnp.where(h_row == f1_row, _CASE_F1, _CASE_F2),
            )
            prev_h = jnp.concatenate([jnp.full((1,), NEGF, jnp.float32), h_row[:-1]])
            f1_open = f1_row == prev_h - oe1
            f2_open = f2_row == prev_h - oe2

            pred_live = jnp.broadcast_to(preds[:, None] >= 0, (P, L + 1))
            m_slot_store = jnp.where(
                at_slot(pred_live, m_slot), m_slot, _VIRT_SLOT
            ).astype(jnp.int32)
            slot1_store = jnp.where(at_slot(pred_live, slot1), slot1, _VIRT_SLOT).astype(jnp.int32)
            slot2_store = jnp.where(at_slot(pred_live, slot2), slot2, _VIRT_SLOT).astype(jnp.int32)

            bits = (
                case.astype(jnp.int32)
                | (m_slot_store << 3)
                | (opn1.astype(jnp.int32) << 7)
                | (slot1_store << 8)
                | (opn2.astype(jnp.int32) << 12)
                | (slot2_store << 13)
                | (f1_open.astype(jnp.int32) << 17)
                | (f2_open.astype(jnp.int32) << 18)
            )
            row = jnp.concatenate([h_row, best1, best2])  # [3W]
            return row, bits

        def step(i, carry):
            # Block-unrolled vertex loop: ONE predecessor row gather per
            # K vertices.
            # In-block predecessor references (preds are strictly
            # lower-ranked, so only rows bs..bs+t-1 can be stale) are
            # patched by compare+select against the block's fresh rows.
            # Rows past a problem's nv are junk exactly as in the
            # 1-step loop (never read by sink selection or traceback).
            S, tbits = carry
            bs = (i * K).astype(jnp.int32) if hasattr(i, "astype") else i * K
            z = jnp.int32(0)
            preds_blk = jax.lax.dynamic_slice(vpred_b, (bs, z), (K, P))
            codes_blk = jax.lax.dynamic_slice(vcodes_b, (bs,), (K,))
            idx_blk = jnp.where(preds_blk >= 0, preds_blk, V)  # [K, P]
            G = S[idx_blk.reshape(-1)].reshape(K, P, 3 * W)  # one gather
            rows, bits_out = [], []
            for t in range(K):
                Sp = G[t]
                for s in range(t):
                    m = (idx_blk[t] == bs + s)[:, None]
                    Sp = jnp.where(m, rows[s][None, :], Sp)
                row_t, bits_t = compute(preds_blk[t], codes_blk[t], Sp)
                rows.append(row_t)
                bits_out.append(bits_t)
            S = jax.lax.dynamic_update_slice(S, jnp.stack(rows), (bs, z))
            tbits = jax.lax.dynamic_update_slice(
                tbits, jnp.stack(bits_out), (bs, z)
            )
            return (S, tbits)

        S, tbits = jax.lax.fori_loop(
            0, (nv_max + K - 1) // K, step, (S, tbits)
        )

        # best sink at column nq (first in topo order on ties)
        v_ids = jnp.arange(V)
        sink_scores = jnp.where(
            is_sink_b & (v_ids < nv_b), S[jnp.minimum(v_ids, V - 1), nq_b], NEGF
        )
        best_sink = jnp.argmax(sink_scores)
        best_score = sink_scores[best_sink]
        return best_score, best_sink.astype(jnp.int32), tbits

    return jax.vmap(one)(vcodes, vpred, is_sink, nv, q, nq)


@jax.jit
def traceback_batch(tbits, vpred, best_sink, nq):
    """Device traceback over the packed decision bits.

    Fixed-size scan BLOCKS inside a while_loop: each iteration runs a
    K-step batched scan (state carried as [B] vectors, tape entries
    emitted as scan outputs) and writes its block into the carried
    tape, exiting as soon as every walk is done.  A real traceback
    walks ~nq + deletions steps, but the worst-case tape is
    T = V + C + 1 — on big-V corridor chunks (V 2048-4096 with ~100 bp
    reads) the old full-length scan burned ~40x more steps than any
    walk used.  The per-iteration tape copy the while_loop forces is a
    [B, T] u16 move per BLOCK (fine), not per step (what the original
    while-free design avoided).

    Each tape entry packs op (2 bits) and vertex id (vid+2, 14 bits —
    vid < V <= 8192, sentinel -1 maps to 1) into ONE uint16: the tape
    is the dominant device->host payload of the --also-align path, and
    2 bytes/step replace the 5 of separate (i8 op, i32 vid) streams.
    Unwritten blocks stay at the OP_END fill.

    tbits [B,V,C] i32 (C >= nq+1), vpred [B,V,P] i32, best_sink [B] i32,
    nq [B] i32.  Returns (tape [B,T] u16, tlen [B] i32) with
    T = V + C + 1; unpack as op = tape & 3, vid = (tape >> 2) - 2.
    """
    B, V, C = tbits.shape
    P = vpred.shape[-1]
    T = V + C + 1
    K = 128
    n_blocks = (T + K - 1) // K
    b_iota = jnp.arange(B, dtype=jnp.int32)

    def tb_step(state, _):
        v, j, st = state
        done = (v == -2) & (j == 0)
        vc = jnp.maximum(v, 0)
        bits = tbits[b_iota, vc, j]
        case = bits & 7

        # state H (st == 0): resolve the case; non-match cases merely
        # switch state without consuming a step (emit nothing yet)
        m_slot = (bits >> 3) & 15
        at_h = st == 0
        is_match = at_h & (case == _CASE_M)
        switch_to = jnp.where(at_h & ~is_match, case, st)

        # E states (st 1/2): graph deletion, follow the stored slot
        in_e = (switch_to == 1) | (switch_to == 2)
        e_opn = jnp.where(switch_to == 1, (bits >> 7) & 1, (bits >> 12) & 1)
        e_slot = jnp.where(switch_to == 1, (bits >> 8) & 15, (bits >> 13) & 15)

        # one vpred gather for the slot the walk actually follows (the
        # step is HBM-gather-latency-bound; the old separate m_nxt +
        # e_nxt gathers fetched a pred the state machine then discarded)
        go_slot = jnp.where(in_e, e_slot, m_slot)
        go_nxt = jnp.where(
            go_slot == _VIRT_SLOT, jnp.int32(-2),
            vpred[b_iota, vc, jnp.minimum(go_slot, P - 1)],
        )

        # F states (st 3/4): in-row insertion
        in_f = (switch_to == 3) | (switch_to == 4)
        f_opn = jnp.where(switch_to == 3, (bits >> 17) & 1, (bits >> 18) & 1)

        from_virtual = v == -2  # leading insertion against the source

        op = jnp.where(
            from_virtual | in_f, jnp.int8(OP_I),
            jnp.where(in_e, jnp.int8(OP_D), jnp.int8(OP_M)),
        )
        vid = jnp.where(from_virtual, jnp.int32(-1), v)
        v2 = jnp.where(from_virtual | in_f, v, go_nxt)
        j2 = jnp.where(from_virtual | in_f | is_match, j - 1, j)
        st2 = jnp.where(
            from_virtual | is_match, jnp.int32(0),
            jnp.where(
                in_e, jnp.where(e_opn == 1, jnp.int32(0), switch_to),
                jnp.where(in_f, jnp.where(f_opn == 1, jnp.int32(0), switch_to), st),
            ),
        )

        op = jnp.where(done, jnp.int8(OP_END), op)
        vid = jnp.where(done, jnp.int32(-1), vid)
        v2 = jnp.where(done, v, v2)
        j2 = jnp.where(done, j, j2)
        st2 = jnp.where(done, st, st2)
        entry = (op.astype(jnp.uint16)
                 | ((vid + 2).astype(jnp.uint16) << 2))
        return (v2, j2, st2), entry

    def blk_cond(carry):
        blk, v, j, st, tape = carry
        return (blk < n_blocks) & jnp.any(~((v == -2) & (j == 0)))

    def blk_body(carry):
        blk, v, j, st, tape = carry
        (v, j, st), entries = jax.lax.scan(
            tb_step, (v, j, st), None, length=K, unroll=4
        )
        tape = jax.lax.dynamic_update_slice(
            tape, entries.T, (jnp.int32(0), blk * K)
        )
        return (blk + 1, v, j, st, tape)

    end_fill = jnp.uint16(OP_END | (1 << 2))  # done entry: op END, vid -1
    tape0 = jnp.full((B, n_blocks * K), end_fill, jnp.uint16)
    init = (
        jnp.int32(0),
        best_sink.astype(jnp.int32),
        nq.astype(jnp.int32),
        jnp.zeros(B, jnp.int32),
        tape0,
    )
    _blk, _v, _j, _st, tape = jax.lax.while_loop(blk_cond, blk_body, init)
    tape = tape[:, :T]
    t_f = jnp.sum((tape & 3) != OP_END, axis=1).astype(jnp.int32)
    return tape, t_f


def unpack_tape(tape: np.ndarray):
    """Host-side unpack of the uint16 tape into (ops i8, vids i32)."""
    t32 = tape.astype(np.int32)
    return (t32 & 3).astype(np.int8), (t32 >> 2) - 2


@partial(jax.jit, static_argnums=(1, 2, 3, 4))
def poa_global_kernel_wire(wire, B, V, P, L):
    """Single-buffer wire variant: the chunk's five input arrays are
    packed host-side into ONE uint8 buffer (see pack_chunk_wire) and
    unpacked here by static slicing + bitcast: one transfer per launch
    instead of five."""
    o = 0
    vcodes_p = jax.lax.bitcast_convert_type(
        wire[o : o + B * V], jnp.int8
    ).reshape(B, V)
    o += B * V
    vpred16 = jax.lax.bitcast_convert_type(
        wire[o : o + B * V * P * 2].reshape(B, V, P, 2), jnp.int16
    )
    o += B * V * P * 2
    nv = jax.lax.bitcast_convert_type(
        wire[o : o + B * 4].reshape(B, 4), jnp.int32
    )
    o += B * 4
    q = jax.lax.bitcast_convert_type(wire[o : o + B * L], jnp.int8).reshape(B, L)
    o += B * L
    nq = jax.lax.bitcast_convert_type(
        wire[o : o + B * 4].reshape(B, 4), jnp.int32
    )
    return poa_global_kernel_packed(vcodes_p, vpred16, nv, q, nq)


def encode_pred_deltas(vpred, nv, max_delta: int = 255):
    """Delta-compress the dense predecessor table for the wire.

    The dense [B,V,P] int16 table is ~85% of a POA chunk's upload bytes,
    but it is extremely redundant: measured on DRB1-3123, 92% of live
    slots are "previous vertex" (delta 1), 100% of live deltas fit in a
    byte, and only ~4% of vertices have more than one predecessor.  So
    the wire carries:

      * dplane uint8 [B,V]: slot-0 delta (pred = v - dplane), 0 = none;
      * a COO exception list for every other live slot (fan-in >= 2, or
        a slot-0 delta that does not fit 1..max_delta): flat indices into the
        [B*V*P] table plus the predecessor ids, padded to a pow2 ladder
        (pad entries point one past the table; the decoder scatters
        into a +1 scratch slot).

    Entries at v >= nv[b] (V-padding and batch-pad rows) are dropped —
    they are calloc zeros upstream, decode to "no predecessor", and are
    never read by the traceback.  Returns (dplane, exc_idx, exc_pred).
    """
    B, V, P = vpred.shape
    v_idx = np.arange(V, dtype=np.int32)[None, :]
    real = v_idx < np.asarray(nv).reshape(B, 1)
    pred = vpred.astype(np.int32)
    live = (pred >= 0) & real[:, :, None]
    delta0 = np.where(live[:, :, 0], v_idx - pred[:, :, 0], 0)
    simple0 = (delta0 >= 1) & (delta0 <= max_delta)
    dplane = np.where(simple0, delta0, 0).astype(np.uint8)
    exc_mask = live
    exc_mask[:, :, 0] &= ~simple0
    b_i, v_i, s_i = np.nonzero(exc_mask)
    exc_idx = ((b_i.astype(np.int64) * V + v_i) * P + s_i).astype(np.int32)
    exc_pred = pred[b_i, v_i, s_i]
    e = len(exc_idx)
    e_pad = max(8, 1 << (e - 1).bit_length()) if e else 8
    if e_pad != e:
        scratch = np.int32(B * V * P)  # decoder's +1 scratch slot
        exc_idx = np.concatenate(
            [exc_idx, np.full(e_pad - e, scratch, np.int32)]
        )
        exc_pred = np.concatenate(
            [exc_pred, np.full(e_pad - e, -1, np.int32)]
        )
    return dplane, exc_idx, exc_pred


@partial(jax.jit, static_argnums=(1, 2, 3, 4, 5))
def _decode_wire2(wire, B, V, P, L, E):
    """Unpack the delta-compressed wire (see poa_global_kernel_wire2).
    A SEPARATE jit from the DP on purpose: its signature includes the
    pow2 exception count E, which varies across chunks of identical
    (B,V,P,L) — keeping it out of the DP kernel's signature means the
    expensive DP+traceback executable compiles once per shape while
    this trivial decode recompiles per E bucket."""
    o = 0
    vcodes_p = jax.lax.bitcast_convert_type(
        wire[o : o + B * V], jnp.int8
    ).reshape(B, V)
    o += B * V
    dplane = wire[o : o + B * V].reshape(B, V)
    o += B * V
    nv = jax.lax.bitcast_convert_type(
        wire[o : o + B * 4].reshape(B, 4), jnp.int32
    )
    o += B * 4
    q = jax.lax.bitcast_convert_type(wire[o : o + B * L], jnp.int8).reshape(B, L)
    o += B * L
    nq = jax.lax.bitcast_convert_type(
        wire[o : o + B * 4].reshape(B, 4), jnp.int32
    )
    o += B * 4
    exc_idx = jax.lax.bitcast_convert_type(
        wire[o : o + E * 4].reshape(E, 4), jnp.int32
    )
    o += E * 4
    exc_pred = jax.lax.bitcast_convert_type(
        wire[o : o + E * 4].reshape(E, 4), jnp.int32
    )
    v_iota = jnp.arange(V, dtype=jnp.int32)[None, :]
    slot0 = jnp.where(dplane > 0, v_iota - dplane.astype(jnp.int32), -1)
    vpred = jnp.full((B, V, P), -1, dtype=jnp.int32)
    vpred = vpred.at[:, :, 0].set(slot0)
    flat = jnp.concatenate(
        [vpred.reshape(-1), jnp.full((1,), -1, jnp.int32)]
    )
    flat = flat.at[exc_idx].set(exc_pred, mode="promise_in_bounds")
    vpred16 = flat[:-1].reshape(B, V, P).astype(jnp.int16)
    return vcodes_p, vpred16, nv, q, nq


def poa_global_kernel_wire2(wire, B, V, P, L, E):
    """Delta-compressed single-buffer wire variant: like
    poa_global_kernel_wire, but the predecessor table travels as a
    uint8 delta plane + COO exceptions (see encode_pred_deltas) instead
    of dense int16 — ~3.4x fewer bytes per launch on pred-heavy
    chunks.  Two async device calls: a trivial decode keyed by
    (B,V,P,L,E) rebuilds the dense table (slot 0 from the delta plane,
    exceptions scattered into a one-slot-extended scratch buffer), then
    the unchanged DP executable — compiled once per (B,V,P,L) — runs on
    the device-resident unpacked arrays."""
    return poa_global_kernel_packed(*_decode_wire2(wire, B, V, P, L, E))


def pack_chunk_wire2(vcodes_p, dplane, nv, q_pad, nq, exc_idx, exc_pred):
    """pack_wire layout for poa_global_kernel_wire2."""
    return pack_wire(
        (
            (vcodes_p, np.int8),
            (dplane, np.uint8),
            (nv, np.int32),
            (q_pad, np.int8),
            (nq, np.int32),
            (exc_idx, np.int32),
            (exc_pred, np.int32),
        )
    )


def pack_rows(plane: np.ndarray, nv) -> np.ndarray:
    """Concatenate each row's first nv[b] entries (drop the batch/V
    ladder padding, which is ~60-90% of a [B,V] plane's slots)."""
    B, V = plane.shape
    mask = np.arange(V, dtype=np.int32)[None, :] < np.asarray(nv).reshape(B, 1)
    return np.ascontiguousarray(plane[mask])


@partial(jax.jit, static_argnums=(2, 3))
def _unpack_rows(flat, nv, B, V):
    """Rebuild the dense [B,V] plane from row-packed entries: compute
    each flat position's (b, v) from the running nv prefix sum and
    scatter into a one-slot-extended buffer (ladder-pad tail entries
    land in the scratch slot).  Inverse of pack_rows."""
    t_pad = flat.shape[0]
    cum = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(nv.astype(jnp.int32))]
    )
    pos = jnp.arange(t_pad, dtype=jnp.int32)
    b_of = jnp.searchsorted(cum, pos, side="right").astype(jnp.int32) - 1
    v_of = pos - cum[b_of]
    target = jnp.where(pos < cum[-1], b_of * V + v_of, B * V)
    out = jnp.zeros(B * V + 1, dtype=flat.dtype)
    out = out.at[target].set(flat, mode="promise_in_bounds")
    return out[:-1].reshape(B, V)


def pack_chunk_wire3(vcodes_f, dplane_f, nv, q_pad, nq, exc_idx, exc_pred):
    """pack_wire layout for poa_global_kernel_wire3 (row-packed planes)."""
    return pack_wire(
        (
            (nv, np.int32),
            (q_pad, np.int8),
            (nq, np.int32),
            (exc_idx, np.int32),
            (exc_pred, np.int32),
            (vcodes_f, np.int8),
            (dplane_f, np.uint8),
        )
    )


@partial(jax.jit, static_argnums=(1, 2, 3, 4, 5, 6))
def _decode_wire3(wire, B, V, P, L, E, T):
    """Unpack the row-packed delta wire (see poa_global_kernel_wire3).
    Separate jit from the DP for the same reason as _decode_wire2: its
    signature carries the per-chunk pow2 ladders (E exceptions, T
    packed vertex entries) that must not key the DP executable."""
    o = 0
    nv = jax.lax.bitcast_convert_type(
        wire[o : o + B * 4].reshape(B, 4), jnp.int32
    )
    o += B * 4
    q = jax.lax.bitcast_convert_type(wire[o : o + B * L], jnp.int8).reshape(B, L)
    o += B * L
    nq = jax.lax.bitcast_convert_type(
        wire[o : o + B * 4].reshape(B, 4), jnp.int32
    )
    o += B * 4
    exc_idx = jax.lax.bitcast_convert_type(
        wire[o : o + E * 4].reshape(E, 4), jnp.int32
    )
    o += E * 4
    exc_pred = jax.lax.bitcast_convert_type(
        wire[o : o + E * 4].reshape(E, 4), jnp.int32
    )
    o += E * 4
    vcodes_f = jax.lax.bitcast_convert_type(wire[o : o + T], jnp.int8)
    o += T
    dplane_f = wire[o : o + T]
    vcodes_p = _unpack_rows(vcodes_f, nv, B, V)
    dplane = _unpack_rows(dplane_f, nv, B, V)
    v_iota = jnp.arange(V, dtype=jnp.int32)[None, :]
    slot0 = jnp.where(dplane > 0, v_iota - dplane.astype(jnp.int32), -1)
    vpred = jnp.full((B, V, P), -1, dtype=jnp.int32)
    vpred = vpred.at[:, :, 0].set(slot0)
    flat = jnp.concatenate(
        [vpred.reshape(-1), jnp.full((1,), -1, jnp.int32)]
    )
    flat = flat.at[exc_idx].set(exc_pred, mode="promise_in_bounds")
    vpred16 = flat[:-1].reshape(B, V, P).astype(jnp.int16)
    return vcodes_p, vpred16, nv, q, nq


def poa_global_kernel_wire3(wire, B, V, P, L, E, T):
    """Row-packed delta wire: wire2 with the two [B,V] planes (vertex
    codes + delta plane) shipped as row-packed entries — batch/V ladder
    padding is 60-90% of those planes' slots on real drains, so
    dropping it cuts the dominant remaining upload bytes.  Decode
    (cheap, per-ladder signature) and the DP (compiled once per
    (B,V,P,L)) stay separate executables."""
    return poa_global_kernel_packed(*_decode_wire3(wire, B, V, P, L, E, T))


def nibble_fold(arr: np.ndarray) -> np.ndarray:
    """Fold an array of 4-bit values (flattened, even total length)
    into bytes (even entry = low nibble)."""
    a = np.ascontiguousarray(arr).astype(np.uint8, copy=False).reshape(-1)
    return (a[0::2] & 15) | ((a[1::2] & 15) << 4)


def exception_pred_deltas(exc_idx, exc_pred, B: int, V: int, P: int):
    """uint16 vertex-relative encoding of the exception predecessors.

    Real entries store ``delta = v - pred`` where ``v = (idx // P) % V``
    is the entry's own vertex (subgraph vertices are rank-ordered and
    the id-order edge filter makes every predecessor strictly earlier,
    align.rs:717-721, so delta >= 1 in practice); pad entries (idx one
    past the [B*V*P] table) scatter into the decoder's dropped scratch
    slot, so their stored value is free (0).  Returns (deltas_u16, ok);
    ok is False when V exceeds uint16 or any real delta falls outside
    [1, 65535] — callers then fall back to the int32-pred wire3.
    """
    idx = np.asarray(exc_idx, dtype=np.int64)
    pred = np.asarray(exc_pred, dtype=np.int64)
    real = idx < B * V * P
    v = (idx // P) % V
    delta = np.where(real, v - pred, 0)
    ok = bool(
        V <= 0xFFFF
        and (not real.any() or ((delta[real] >= 1) & (delta[real] <= 0xFFFF)).all())
    )
    return delta.astype(np.uint16), ok


def pack_chunk_wire4(vnib, dnib, nv, qnib, nq, exc_idx, exc_pd16):
    """pack_wire layout for poa_global_kernel_wire4 (nibble planes,
    nibble query codes, uint16 exception pred-deltas)."""
    return pack_wire(
        (
            (nv, np.int32),
            (qnib, np.uint8),
            (nq, np.int32),
            (exc_idx, np.int32),
            (exc_pd16, np.uint16),
            (vnib, np.uint8),
            (dnib, np.uint8),
        )
    )


@partial(jax.jit, static_argnums=(1, 2, 3, 4, 5, 6))
def _decode_wire4(wire, B, V, P, L, E, T):
    """Unpack the nibble-plane wire (see poa_global_kernel_wire4);
    separate jit from the DP as in _decode_wire2/_decode_wire3."""
    o = 0
    nv = jax.lax.bitcast_convert_type(
        wire[o : o + B * 4].reshape(B, 4), jnp.int32
    )
    o += B * 4

    def expand(nib):  # [n] bytes -> [2n] 4-bit values
        return jnp.stack([nib & 15, nib >> 4], axis=1).reshape(-1)

    q = expand(wire[o : o + B * L // 2]).astype(jnp.int8).reshape(B, L)
    o += B * L // 2
    nq = jax.lax.bitcast_convert_type(
        wire[o : o + B * 4].reshape(B, 4), jnp.int32
    )
    o += B * 4
    exc_idx = jax.lax.bitcast_convert_type(
        wire[o : o + E * 4].reshape(E, 4), jnp.int32
    )
    o += E * 4
    exc_pd = jax.lax.bitcast_convert_type(
        wire[o : o + E * 2].reshape(E, 2), jnp.int16
    ).astype(jnp.int32) & 0xFFFF
    o += E * 2

    vq = expand(wire[o : o + T // 2])
    o += T // 2
    dp_f = expand(wire[o : o + T // 2])
    # 4-bit vertex value: code in bits 0-2, sink in bit 3 -> rebuild the
    # packed-kernel layout (sink in bit 5)
    vcodes_f = ((vq & 7) | ((vq >> 3) << 5)).astype(jnp.int8)
    vcodes_p = _unpack_rows(vcodes_f, nv, B, V)
    dplane = _unpack_rows(dp_f, nv, B, V)
    v_iota = jnp.arange(V, dtype=jnp.int32)[None, :]
    slot0 = jnp.where(dplane > 0, v_iota - dplane.astype(jnp.int32), -1)
    vpred = jnp.full((B, V, P), -1, dtype=jnp.int32)
    vpred = vpred.at[:, :, 0].set(slot0)
    # exception pred = own vertex - uint16 delta (pad entries land in
    # the dropped scratch slot, their value is irrelevant)
    exc_pred = (exc_idx // P) % V - exc_pd
    flat = jnp.concatenate(
        [vpred.reshape(-1), jnp.full((1,), -1, jnp.int32)]
    )
    flat = flat.at[exc_idx].set(exc_pred, mode="promise_in_bounds")
    vpred16 = flat[:-1].reshape(B, V, P).astype(jnp.int16)
    return vcodes_p, vpred16, nv, q, nq


def poa_global_kernel_wire4(wire, B, V, P, L, E, T):
    """Nibble-plane wire (the production entry point): wire3 with
    both row-packed planes at 4 bits per vertex — the vertex value is
    code (3b) + sink (1b) exactly, and slot-0 deltas are capped at 14
    (larger ones ride the exception list; measured 92% of live deltas
    are 1).  Halves the plane bytes again."""
    return poa_global_kernel_packed(*_decode_wire4(wire, B, V, P, L, E, T))


def pack_wire(parts) -> np.ndarray:
    """Concatenate (array, dtype) pairs into one uint8 wire buffer (a
    single host memcpy, in place of one transfer per array).  The single source of truth for the byte layout every
    *_wire kernel slices back with bitcast_convert_type: little-endian
    (guarded by wire_bitcast_supported), C order, dtypes pinned by the
    caller (x64 mode would otherwise widen int arrays)."""
    return np.concatenate(
        [
            np.ascontiguousarray(a, dtype=dt).reshape(-1).view(np.uint8)
            for a, dt in parts
        ]
    )


def pack_chunk_wire(vcodes_p, vpred16, nv, q_pad, nq) -> np.ndarray:
    """pack_wire layout for poa_global_kernel_wire."""
    return pack_wire(
        (
            (vcodes_p, np.int8),
            (vpred16, np.int16),
            (nv, np.int32),
            (q_pad, np.int8),
            (nq, np.int32),
        )
    )


_WIRE_BITCAST_OK: dict = {}


def wire_bitcast_supported() -> bool:
    """Per-backend probe that the backend's u8->i16/i32 bitcast matches
    the host's little-endian byte order (XLA's layout here is backend-
    defined in principle); mismatch falls back to per-array dispatch.
    Keyed by the default backend so a mid-process platform switch
    (e.g. jax.default_device / JAX_PLATFORMS juggling in tests) cannot
    reuse a stale verdict from a different backend."""
    try:
        key = jax.default_backend()
    except Exception:
        key = "?"
    if key not in _WIRE_BITCAST_OK:
        pat = np.arange(1, 9, dtype=np.uint8)
        try:
            got16 = np.asarray(
                jax.jit(
                    lambda b: jax.lax.bitcast_convert_type(
                        b.reshape(4, 2), jnp.int16
                    )
                )(jnp.asarray(pat))
            )
            got32 = np.asarray(
                jax.jit(
                    lambda b: jax.lax.bitcast_convert_type(
                        b.reshape(2, 4), jnp.int32
                    )
                )(jnp.asarray(pat))
            )
            _WIRE_BITCAST_OK[key] = bool(
                (got16 == pat.view(np.int16)).all()
                and (got32 == pat.view(np.int32)).all()
            )
        except Exception:
            _WIRE_BITCAST_OK[key] = False
    return _WIRE_BITCAST_OK[key]


def _poa_dp(vcodes, vpred, is_sink, nv, q, nq, init_row):
    """The DP for the backend: the CUDA kernel on NVIDIA GPUs,
    poa_dp_xla everywhere else (same outputs)."""
    if jax.default_backend() == "gpu":
        from .poa_cuda import poa_dp_cuda

        return poa_dp_cuda(vcodes, vpred, is_sink, nv, q, nq, init_row)
    return poa_dp_xla(vcodes, vpred, is_sink, nv, q, nq, init_row)


@jax.jit
def poa_global_kernel_packed(vcodes_p, vpred16, nv, q, nq):
    """Packed-input variant of poa_global_kernel: ONE device launch per
    chunk for DP + traceback, on compact inputs:

      * vcodes_p int8 [B,V]: base code in bits 0-2, is_sink in bit 5
        (saves shipping a [B,V] bool plane);
      * vpred16 int16 [B,V,P]: vertex ids < 8192 and the -1 sentinel fit
        int16 — halves the largest input array;
      * the leading-insertion cost row is a closed-form formula, so it
        is computed on device rather than shipped.
    """
    L = q.shape[1]
    j = jnp.arange(1, L + 1, dtype=jnp.float32)
    costs = jnp.minimum(
        np.float32(GAP_OPEN1) + j * np.float32(GAP_EXT1),
        np.float32(GAP_OPEN2) + j * np.float32(GAP_EXT2),
    )
    init_row = jnp.concatenate([jnp.zeros(1, jnp.float32), -costs])
    vcodes = (vcodes_p & 7).astype(jnp.int8)
    is_sink = (vcodes_p >> 5) != 0
    vpred = vpred16.astype(jnp.int32)
    score, best_sink, tbits = _poa_dp(
        vcodes, vpred, is_sink, nv, q, nq, init_row
    )
    tape, tlen = traceback_batch(tbits, vpred, best_sink, nq)
    return score, tape, tlen


def poa_global_kernel(vcodes, vpred, is_sink, nv, q, nq, init_row):
    """One batch of global POA problems: DP + traceback.

    Returns (score [B], tape [B,T] uint16, tlen [B]); see
    traceback_batch for the tape packing.
    """
    vpred = jnp.asarray(vpred)
    score, best_sink, tbits = _poa_dp(
        jnp.asarray(vcodes), vpred, jnp.asarray(is_sink), jnp.asarray(nv),
        jnp.asarray(q), jnp.asarray(nq), jnp.asarray(init_row),
    )
    tape, tlen = traceback_batch(tbits, vpred, best_sink, jnp.asarray(nq))
    return score, tape, tlen


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p <<= 1
    return p


def _l_pad_for(n: int) -> int:
    """Query-length pad ladder 127/255/511/...: W = l_pad+1 is then a
    power of two >= 128, a whole number of warps for the GPU kernel's
    block (ops/poa_cuda.block_geometry)."""
    p = 128
    while p - 1 < n:
        p <<= 1
    return p - 1


# ---------------------------------------------------------------------------
# Local gapless POA (rspoa align_local_no_gap, align.rs:160-164)
# ---------------------------------------------------------------------------


@jax.jit
def poa_local_kernel(vcodes, vpred, nv, q, nq):
    """Batched local gapless POA DP + traceback.

    Mirrors ops/poa.py align_local_no_gap_host exactly: zero-floored
    match/mismatch DP over the base DAG, strict-improvement source
    updates in predecessor-list order, best cell = earliest (v, j) in
    scan order.  Returns (best [B] f32, tape [B,T] u16, tlen [B] i32,
    qend [B] i32) with T = L + 1 and the tape packed as in
    traceback_batch.  The vertex loop runs to the batch max nv (traced
    bound, as in poa_dp_xla).
    """
    B, V = vcodes.shape
    L = q.shape[1]
    P = vpred.shape[-1]
    nv_max = jnp.max(nv)

    def one(vcodes_b, vpred_b, nv_b, q_b, nq_b):
        H = jnp.zeros((V + 1, L + 1), dtype=jnp.float32)  # row V: virtual 0s
        cells = jnp.zeros((V, L + 1), dtype=jnp.int32)  # slot | pos<<4
        p_iota = jnp.arange(P, dtype=jnp.int32)[:, None]

        def step(v, carry):
            H, cells, best, bv, bj = carry
            preds = vpred_b[v]
            idx = jnp.where(preds >= 0, preds, V)
            Hp = H[idx]  # [P, L+1]; dead slots read the virtual 0 row
            live = preds[:, None] >= 0
            cand = jnp.concatenate(
                [jnp.zeros((P, 1), jnp.float32), Hp[:, :-1]], axis=1
            )
            cand = jnp.where(live, cand, 0.0)
            m_best = jnp.maximum(jnp.max(cand, axis=0), 0.0)
            # first live slot achieving the max, only when max > 0
            slot = jnp.min(
                jnp.where((cand == m_best[None, :]) & live, p_iota, P),
                axis=0,
            ).astype(jnp.int32)
            slot = jnp.where(m_best > 0.0, slot, jnp.int32(_VIRT_SLOT))
            slot = jnp.where(slot >= P, jnp.int32(_VIRT_SLOT), slot)

            sub = jnp.where(
                q_b == vcodes_b[v], np.float32(MATCH), np.float32(MISMATCH)
            )
            sub = jnp.where(
                (q_b >= 4) | (vcodes_b[v] >= 4), np.float32(MISMATCH), sub
            )
            row = jnp.concatenate(
                [
                    jnp.zeros((1,), jnp.float32),
                    jnp.maximum(m_best[1:] + sub, 0.0),
                ]
            )
            bits = slot | ((row > 0.0).astype(jnp.int32) << 4)

            m = jnp.max(row)
            jstar = jnp.argmax(row).astype(jnp.int32)  # first max
            in_range = v < nv_b
            better = (m > best) & in_range
            best = jnp.where(better, m, best)
            bv = jnp.where(better, v, bv)
            bj = jnp.where(better, jstar, bj)

            H = H.at[v].set(jnp.where(in_range, row, 0.0))
            cells = cells.at[v].set(bits)
            return (H, cells, best, bv, bj)

        init = (H, cells, jnp.float32(0), jnp.int32(0), jnp.int32(0))
        H, cells, best, bv, bj = jax.lax.fori_loop(0, nv_max, step, init)

        # traceback: matches only, until the zero floor (or j == 0)
        T = L + 1

        def tb_step(state, _):
            v, j = state
            alive = (v >= 0) & (j > 0)
            vc = jnp.maximum(v, 0)
            bits = cells[vc, j]
            alive = alive & ((bits >> 4) > 0)
            op = jnp.where(alive, jnp.int8(OP_M), jnp.int8(OP_END))
            vid = jnp.where(alive, v, jnp.int32(-1))
            slot = bits & 15
            nxt = jnp.where(
                slot == _VIRT_SLOT, jnp.int32(-2),
                vpred_b[vc][jnp.minimum(slot, P - 1)],
            )
            v2 = jnp.where(alive, nxt, v)
            j2 = jnp.where(alive, j - 1, j)
            entry = (op.astype(jnp.uint16)
                     | ((vid + 2).astype(jnp.uint16) << 2))
            return (v2, j2), entry

        _, tape = jax.lax.scan(
            tb_step, (bv, bj), None, length=T, unroll=4
        )
        t_f = jnp.sum((tape & 3) != OP_END).astype(jnp.int32)
        return best, tape, t_f, bj

    return jax.vmap(one)(vcodes, vpred, nv, q, nq)


def align_local_batch(
    problems: Sequence[Tuple[Sequence[str], Sequence[Tuple[int, int]], str]],
):
    """Batched local no-gap alignment (rspoa engine) on device.

    Same bucketing/problem prep as align_global_batch; results equal
    align_local_no_gap_host per problem (tests/test_poa_device.py).
    """
    from ..utils.dna import encode_seq as _enc

    qs_all = [_enc(q) for _, _, q in problems]
    bgs_all = [build_base_graph(n, e) for n, e, _ in problems]
    buckets: dict = {}
    out = [None] * len(problems)
    for i, (bg, q) in enumerate(zip(bgs_all, qs_all)):
        if len(bg.codes) > 8192:
            # outlier shapes: host DP beats a one-off compile (and the
            # uint16 tape packing caps device vertex ids at 14 bits)
            from .poa import align_local_no_gap_host

            out[i] = align_local_no_gap_host(*problems[i])
            continue
        key = (
            _next_pow2(max(len(bg.codes), 256)),
            _l_pad_for(len(q)),
        )
        buckets.setdefault(key, []).append(i)

    # dispatch every bucket (async), then drain through one device_get
    pend = []
    for (v_pad, l_pad), idxs in sorted(buckets.items()):
        pend.append((idxs, _dispatch_local_bucket(
            [bgs_all[i] for i in idxs], [qs_all[i] for i in idxs], v_pad, l_pad
        )))
    fetched = jax.device_get([p[1][0] for p in pend])
    for (idxs, (_out_d, bgs, qs)), got in zip(pend, fetched):
        for i, res in zip(idxs, _decode_local_bucket(bgs, qs, got)):
            out[i] = res
    return out


def _dispatch_local_bucket(bgs, qs, v_pad: int, l_pad: int):
    probs = [prepare_problem(bg, q, v_pad, l_pad) for bg, q in zip(bgs, qs)]
    b_pad = _next_pow2(max(len(probs), 4))
    while len(probs) < b_pad:
        probs.append(probs[0])

    out_d = poa_local_kernel(
        jnp.asarray(np.stack([p.vcodes for p in probs])),
        jnp.asarray(_slice_preds(np.stack([p.vpred for p in probs]))),
        jnp.asarray(np.asarray([p.nv for p in probs], dtype=np.int32)),
        jnp.asarray(np.stack([p.q for p in probs])),
        jnp.asarray(np.asarray([p.nq for p in probs], dtype=np.int32)),
    )
    return (out_d, bgs, qs)


def _align_local_bucket(bgs, qs, v_pad: int, l_pad: int):
    out_d, bgs, qs = _dispatch_local_bucket(bgs, qs, v_pad, l_pad)
    return _decode_local_bucket(bgs, qs, jax.device_get(out_d))


def _decode_local_bucket(bgs, qs, fetched):
    from .poa import _finish_result

    best, tape, tlens, qends = fetched
    ops, vids = unpack_tape(tape)

    results = []
    for i, (bg, q) in enumerate(zip(bgs, qs)):
        t = int(tlens[i])
        qe = int(qends[i])
        qs_ = qe - t
        tape_ops = ops[i][:t][::-1]
        tape_vids = vids[i][:t][::-1]
        triples = []
        qpos = qs_
        for op, v in zip(tape_ops, tape_vids):
            kind = "M" if v >= 0 and q[qpos] == bg.codes[v] else "X"
            triples.append((kind, int(v), qpos))
            qpos += 1
        results.append(_finish_result(bg, q, triples, int(best[i]), qs_, qe))
    return results


def align_global_batch(
    problems: Sequence[Tuple[Sequence[str], Sequence[Tuple[int, int]], str]],
):
    """Align a batch of (nodes, edges, query) subgraph problems on device.

    Returns a list of PoaResult (ops/poa.py) equal to align_global_host on
    each problem.  Problems are bucketed by pow2-padded (V, L) so one
    outlier subgraph does not inflate the whole batch.  Host-side problem
    preparation and tape decoding run in the native runtime when built
    (vgaligner_tpu/native), with the Python path as fallback.
    """
    from ..utils.dna import encode_seq as _enc
    from ..native import available as _native_ok

    qs_all = [_enc(q) for _, _, q in problems]

    from .poa import align_global_host

    if _native_ok():
        vs = [sum(len(s) for s in nodes) for nodes, _, _ in problems]
        buckets: dict = {}
        out = [None] * len(problems)
        from ..native import poa_global_host_native

        for i, (v, q) in enumerate(zip(vs, qs_all)):
            if v > 8192:  # outlier shapes: native host DP beats a one-off compile
                out[i] = poa_global_host_native(*problems[i])
                continue
            key = (_next_pow2(max(v, 256)), _l_pad_for(len(q)))
            buckets.setdefault(key, []).append(i)
        for (v_pad, l_pad), idxs in sorted(buckets.items()):
            res = _align_bucket_native(
                [(problems[i][0], problems[i][1]) for i in idxs],
                [qs_all[i] for i in idxs], v_pad, l_pad,
            )
            if res is None:  # pads exceeded (e.g. fan-in > P_MAX)
                res = _align_bucket(
                    [build_base_graph(problems[i][0], problems[i][1]) for i in idxs],
                    [qs_all[i] for i in idxs], v_pad, l_pad,
                )
            for i, r in zip(idxs, res):
                out[i] = r
        return out

    bgs_all = [build_base_graph(n, e) for n, e, _ in problems]
    buckets = {}
    out = [None] * len(problems)
    for i, (bg, q) in enumerate(zip(bgs_all, qs_all)):
        if len(bg.codes) > 8192:
            # outlier shapes: host DP beats a one-off compile (and the
            # uint16 tape packing caps device vertex ids at 14 bits)
            out[i] = align_global_host(*problems[i])
            continue
        key = (
            _next_pow2(max(len(bg.codes), 256)),
            _l_pad_for(len(q)),
        )
        buckets.setdefault(key, []).append(i)

    for (v_pad, l_pad), idxs in sorted(buckets.items()):
        for i, res in zip(idxs, _align_bucket(
            [bgs_all[i] for i in idxs], [qs_all[i] for i in idxs], v_pad, l_pad
        )):
            out[i] = res
    return out


def _align_bucket_native(node_edge_probs, qs, v_pad: int, l_pad: int):
    """Native-runtime bucket path: C++ problem prep + tape decode around
    the device kernel.  Returns None if a problem exceeds the pads."""
    from ..native import build_poa_batch_native

    built = build_poa_batch_native(
        node_edge_probs, v_pad, P_MAX,
        rows=padded_rows(len(node_edge_probs), v_pad, l_pad),
    )
    if built is None:
        return None
    return kernel_and_finish(built, qs, v_pad, l_pad)


# batch-dim pads: few executables.  V-sorted chunks of at most 1024
# keep each launch's batch-max nv bound tight for the XLA scan, which
# runs every problem of a chunk to that bound.
_B_LADDER = (8, 32, 128, 256, 512, 1024)


@functools.cache
def _hbm_budget() -> int:
    """Device bytes one POA launch may hold: a quarter of what the
    device lets XLA allocate (bytes_limit); 6 GiB of host memory where
    the backend reports no limit (the CPU)."""
    stats = jax.devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    return limit // 4 if limit else 6 << 30


def _b_chunk_for(v_pad: int, l_pad: int) -> int:
    # the DP holds ~7 [V, L+1] f32/i32 planes per problem (tbits, the
    # H/E1/E2 rows and the traceback's copies)
    per_problem = v_pad * (l_pad + 1) * 4 * 7
    b = _hbm_budget() // max(per_problem, 1)
    if v_pad >= 2048:
        # big-V buckets: the XLA scan's vertex loop runs to each chunk's
        # max nv, and V spreads widely inside a pow2 bucket — small
        # V-sorted chunks keep most launches' bounds far below the
        # bucket max
        b = min(b, 128)
    for cand in reversed(_B_LADDER):
        if cand <= b:
            return cand
    return _B_LADDER[0]


def _b_pad_for(n: int) -> int:
    for b in _B_LADDER:
        if n <= b:
            return b
    return _next_pow2(n)  # unchunked callers above the ladder


def padded_rows(n: int, v_pad: int, l_pad: int) -> int:
    """Batch rows the problem builder should allocate so every chunk of
    kernel_dispatch_chunked — including the ladder-padded last one — is
    a zero-copy view (builders calloc the extra rows; all-zero problems
    are valid throwaways for the kernel)."""
    if n <= 0:
        return n
    b_chunk = _b_chunk_for(v_pad, l_pad)
    s_last = (n - 1) // b_chunk * b_chunk
    return s_last + _b_pad_for(n - s_last)


def _iter_chunks(built, qs, v_pad: int, l_pad: int):
    """Yield (chunk_arrays, chunk_qs) with batch dims drawn from a small
    ladder (sized to the HBM budget for this problem shape) so POA
    executables are shared across datasets instead of recompiling for
    every distinct problem count.  Chunks are sliced as views when the
    builder over-allocated rows (padded_rows); host memory on the target
    VMs is burst-throttled, so avoiding batch-dim copies matters."""
    vcodes, vpred, is_sink, nv, node_of, off_in = built
    n = len(qs)
    b_chunk = _b_chunk_for(v_pad, l_pad)
    for s in range(0, n, b_chunk):
        e = min(s + b_chunk, n)
        b_pad = _b_pad_for(e - s)
        with timer.phase("d_pad"):
            if vcodes.shape[0] >= s + b_pad:
                chunk = (vcodes[s : s + b_pad], vpred[s : s + b_pad],
                         is_sink[s : s + b_pad], nv[s : s + b_pad],
                         node_of[s : s + b_pad], off_in[s : s + b_pad])
            else:  # builder did not over-allocate: zero-pad (copies)
                def zpad(a):
                    out = np.zeros((b_pad,) + a.shape[1:], dtype=a.dtype)
                    out[: e - s] = a[s:e]
                    return out

                chunk = tuple(zpad(a) for a in built)
        yield chunk, qs[s:e]


def kernel_dispatch_chunked(built, qs, v_pad: int, l_pad: int, mesh=None):
    """Dispatch a bucket as ladder-sized chunks (see _iter_chunks).
    Returns pending states for kernel_finish.

    Under a mesh the wire-packed path stays enabled: each chunk is split
    into per-device subchunks, each packed into its own wire buffer and
    launched on its device (problems are independent — no collectives;
    the row-packed wire has no uniform per-problem stride, so batch-dim
    sharding of ONE buffer cannot express it)."""
    if mesh is not None and wire2_path_available():
        devices = list(mesh.devices.flat)
        pendings = []
        for chunk, cqs in _iter_chunks(built, qs, v_pad, l_pad):
            pendings.extend(
                _dispatch_wire_per_device(chunk, cqs, v_pad, l_pad, devices)
            )
        return pendings
    return [
        kernel_dispatch(chunk, cqs, v_pad, l_pad, mesh=mesh)
        for chunk, cqs in _iter_chunks(built, qs, v_pad, l_pad)
    ]


def _dispatch_wire_per_device(chunk, cqs, v_pad: int, l_pad: int, devices):
    """Split one ladder chunk across devices and launch each slice's wire
    kernel on its own device.  Slices whose rows are all batch padding
    are skipped (nothing real to decode)."""
    b_pad = chunk[0].shape[0]
    ndev = max(1, min(len(devices), b_pad))
    while b_pad % ndev:
        ndev -= 1
    per = b_pad // ndev
    n_real = len(cqs)
    kerns = {
        "v2": poa_global_kernel_wire2,
        "v3": poa_global_kernel_wire3,
        "v4": poa_global_kernel_wire4,
    }
    pendings = []
    for d in range(ndev):
        s = d * per
        if s >= n_real:
            break  # all remaining rows are padding
        sub = tuple(a[s : s + per] for a in chunk)
        sub_qs = cqs[s : min(s + per, n_real)]
        wire, version, dims, rest = kernel_prepare(sub, sub_qs, v_pad, l_pad)
        with timer.phase("d_upload"):
            wire_d = jax.device_put(wire, devices[d])
        with timer.phase("d_launch"):
            out_d = kerns[version](wire_d, *dims)
        pendings.append((out_d,) + rest)
    return pendings


def kernel_prepare_chunked(built, qs, v_pad: int, l_pad: int):
    """Prepare a bucket's chunks for kernel_launch_wires WITHOUT
    uploading (see kernel_prepare) — batch callers collect prepared
    chunks across buckets so a whole drain shares one device_put."""
    return [
        kernel_prepare(chunk, cqs, v_pad, l_pad)
        for chunk, cqs in _iter_chunks(built, qs, v_pad, l_pad)
    ]


def make_init_row(l_pad: int) -> np.ndarray:
    """Leading-insertion cost row [l_pad+1] f32 (cached per l_pad —
    recomputing the Python gap_cost loop per dispatch showed up in
    profiles)."""
    row = _INIT_ROW_CACHE.get(l_pad)
    if row is None:
        j = np.arange(1, l_pad + 1, dtype=np.int64)
        costs = np.minimum(GAP_OPEN1 + j * GAP_EXT1, GAP_OPEN2 + j * GAP_EXT2)
        row = np.concatenate([[0.0], -costs]).astype(np.float32)
        row.setflags(write=False)
        _INIT_ROW_CACHE[l_pad] = row
    return row


_INIT_ROW_CACHE: dict = {}


def wire2_path_available(mesh=None) -> bool:
    """True when dispatch will take the delta-compressed single-buffer
    wire path (the production route): single device, no dense-wire
    escape hatch, and the backend bitcast probe passes.  Callers use this to batch many chunks' uploads into one
    device_put (kernel_prepare_chunked + kernel_launch_wires)."""
    return (
        mesh is None
        and os.environ.get("VGALIGNER_POA_WIRE") != "v1"
        and wire_bitcast_supported()
    )


def _pad_queries(qs, b_pad: int, l_pad: int):
    """Ladder-padded query codes + lengths for one chunk."""
    n_real = len(qs)
    q_pad = np.full((b_pad, l_pad), 4, dtype=np.int8)
    nq = np.zeros(b_pad, dtype=np.int32)
    lens = [len(qc) for qc in qs]
    nq[:n_real] = lens
    if n_real and min(lens) == max(lens):
        # common case (fixed-length read batches): one bulk copy
        q_pad[:n_real, : lens[0]] = qs
    else:
        for i, qc in enumerate(qs):
            q_pad[i, : len(qc)] = qc
    return q_pad, nq


def _native_pack_v4(vcodes_p, vpred_s, nv, q_pad, nq, b_pad, V, P, l_pad):
    """Single-native-pass v4 wire build (host_kernels.cpp
    vg_pack_poa_wire): row-packed nibble planes + exception list in one
    traversal, with the GIL released (the numpy pipeline serializes
    against the streaming worker).  Returns (wire, dims) or None (native
    unavailable, or a pred delta outside uint16 -> caller's numpy/v3
    route)."""
    from ..native import available as _native_ok

    if not _native_ok():
        return None
    from ..native import pack_poa_wire_native

    T = int(np.asarray(nv, dtype=np.int64).sum())
    t_pad = _ladder_bytes(max(T, 1))
    packed = pack_poa_wire_native(vcodes_p, vpred_s, nv, 14, t_pad)
    if packed is None:
        return None
    vnib, dnib, exc_idx, exc_pd16 = packed
    e = len(exc_idx)
    e_pad = max(8, 1 << (e - 1).bit_length()) if e else 8
    if e_pad != e:
        scratch = np.int32(b_pad * V * P)
        exc_idx = np.concatenate(
            [exc_idx, np.full(e_pad - e, scratch, np.int32)]
        )
        exc_pd16 = np.concatenate(
            [exc_pd16, np.zeros(e_pad - e, np.uint16)]
        )
    wire = pack_chunk_wire4(
        vnib, dnib, nv, nibble_fold(q_pad), nq, exc_idx, exc_pd16
    )
    return wire, (b_pad, V, P, l_pad, e_pad, t_pad)


def kernel_prepare(built, qs, v_pad: int, l_pad: int):
    """Pad + delta-pack ONE chunk's wire buffer WITHOUT uploading or
    launching.  Returns (wire, version, dims, rest) for
    kernel_launch_wires, which uploads many prepared chunks in a single
    device_put.  version selects the kernel: "v4" nibble planes
    (production), "v3" row-packed int32-pred (escape hatch + per-chunk
    overflow fallback), "v2" dense planes."""
    vcodes, vpred, is_sink, nv, node_of, off_in = built
    n_real = len(qs)
    b_pad = vcodes.shape[0]
    with timer.phase("d_pad"):
        q_pad, nq = _pad_queries(qs, b_pad, l_pad)
    with timer.phase("d_pack"):
        vcodes_p = (vcodes | (is_sink.astype(np.int8) << 5)).astype(np.int8)
        vpred_s = _slice_preds(vpred, n_real)
        version = os.environ.get("VGALIGNER_POA_WIRE", "v4")
        if version not in ("v2", "v3"):
            version = "v4"
        V, P = vcodes.shape[1], vpred_s.shape[-1]
        if version == "v4" and V <= 0xFFFF and not (b_pad * l_pad) % 2:
            native_wire = _native_pack_v4(
                vcodes_p, vpred_s, nv, q_pad, nq, b_pad, V, P, l_pad
            )
            if native_wire is not None:
                wire, dims = native_wire
                rest = (vcodes, node_of, off_in, q_pad, v_pad, b_pad,
                        n_real, qs)
                return wire, "v4", dims, rest
        max_delta = 14 if version == "v4" else 255
        dplane, exc_idx, exc_pred = encode_pred_deltas(
            vpred_s, nv, max_delta=max_delta
        )
        exc_pd16 = None
        if version == "v4":
            exc_pd16, ok = exception_pred_deltas(
                exc_idx, exc_pred, b_pad, V, P
            )
            if not ok or (b_pad * l_pad) % 2:
                # a pred-delta outside uint16 (or an odd query plane):
                # this chunk rides the int32-pred wire3
                version = "v3"
        if version == "v2":
            wire = pack_chunk_wire2(
                vcodes_p, dplane, nv, q_pad, nq, exc_idx, exc_pred
            )
            dims = (b_pad, V, P, l_pad, len(exc_idx))

        else:
            vcodes_f = pack_rows(vcodes_p, nv)
            dplane_f = pack_rows(dplane, nv)
            t_pad = _ladder_bytes(max(len(vcodes_f), 1))
            if t_pad != len(vcodes_f):
                pad = t_pad - len(vcodes_f)
                vcodes_f = np.concatenate(
                    [vcodes_f, np.zeros(pad, np.int8)]
                )
                dplane_f = np.concatenate(
                    [dplane_f, np.zeros(pad, np.uint8)]
                )
            dims = (b_pad, V, P, l_pad, len(exc_idx), t_pad)
            if version == "v3":
                wire = pack_chunk_wire3(
                    vcodes_f, dplane_f, nv, q_pad, nq, exc_idx, exc_pred
                )
            else:
                # 4-bit vertex values: code (3b) + sink bit 5 -> 3
                vnib = nibble_fold(
                    (vcodes_f & 7) | (((vcodes_f >> 5) & 1) << 3)
                )
                dnib = nibble_fold(dplane_f)
                wire = pack_chunk_wire4(
                    vnib, dnib, nv, nibble_fold(q_pad), nq,
                    exc_idx, exc_pd16,
                )
    rest = (vcodes, node_of, off_in, q_pad, v_pad, b_pad, n_real, qs)
    return wire, version, dims, rest


@partial(jax.jit, static_argnums=(2,))
def _slice_wire(mega, off, size):
    return jax.lax.dynamic_slice(mega, (off,), (size,))


def _ladder_bytes(n: int) -> int:
    """Round n up to a pow2/8 ladder (pad waste <= 12.5%) so the
    mega-upload buffer reuses a small set of _slice_wire signatures
    instead of recompiling per drain layout."""
    if n <= 4096:
        return 4096
    step = max(4096, (1 << (n.bit_length() - 1)) // 8)
    return -(-n // step) * step


_WIRE_MEGA_CAP = 32 << 20  # flush mega-uploads in <=32 MB groups


class _FusedOut(NamedTuple):
    """Shared device handle for one fused-drain launch (see
    kernel_launch_fused): concatenated outputs plus the static split
    plan, referenced by every chunk's pending state."""

    scores: object  # f32 [sum b_pad]
    tapes: object  # u8 delta tape [sum b_pad * t_guess_i] (u16 when the
    #   delta encoding is disabled, VGALIGNER_POA_TAPE_U8=0)
    tlens: object  # i32 [sum b_pad]
    fulls: tuple  # per-chunk full [b_pad, T] tapes (device, fetched only on overflow)
    plan: tuple  # per-chunk (b_pad, t_guess, e_cap); e_cap == 0 -> u16 tape
    starts: object  # i32 [sum b_pad] first-entry vids (u8 tape only)
    excs: object  # i32 [sum 2*(e_cap_i+1)] exception (pos, val) pairs
    nexcs: object  # i32 [n_chunks] true exception counts


_FUSED_CACHE: dict = {}


def _tape_u8_enabled() -> bool:
    """Whether the fused drain ships the traceback tape as a u8
    op+delta stream (halves the dominant device->host payload) instead
    of raw u16 entries.  Kill switch: VGALIGNER_POA_TAPE_U8=0."""
    return os.environ.get("VGALIGNER_POA_TAPE_U8", "1") != "0"


# u8 delta-tape constants: entry = op (2 bits) | code (6 bits); code
# 1..61 is delta+31 (vid step vs the previous tape entry, in [-30, 30]),
# code _EXC_CODE marks an exception whose absolute vid rides the side
# channel.  Measured on the corridor pipeline, step-to-step vid deltas
# are almost always 0 (insertions) or -1/+1 (match/deletion to the
# adjacent rank), so one byte per step replaces two; exceptions (far
# pin-crossing deletions, the real-vid -> -1 virtual-source switch) are
# a handful per problem.
_EXC_CODE = 62
_DELTA_MAX = 30


def _encode_tape_u8(cut, e_cap: int):
    """Device-side delta encoding of a [b, t] u16 tape slice.

    Returns (u8tape [b,t], starts i32 [b], excs i32 [2*(e_cap+1)],
    n_exc i32 []).  excs holds (flat position, vid) pairs for entries
    whose delta leaves [-_DELTA_MAX, _DELTA_MAX]; entries past e_cap
    are dropped on device and the chunk refetches its full u16 tape
    (n_exc carries the true count for that detection).  Trailing
    OP_END fill encodes as delta 0 so the tail never spends exception
    slots; its reconstructed vids are garbage and never read (the host
    walk stops at tlen)."""
    t32 = cut.astype(jnp.int32)
    ops = t32 & 3
    vids = (t32 >> 2) - 2
    b, t = cut.shape
    valid = ops != OP_END
    prev = jnp.concatenate([vids[:, :1], vids[:, :-1]], axis=1)
    d = jnp.where(valid, vids - prev, 0)
    d = d.at[:, 0].set(0)  # column 0 is absolute, shipped via starts
    exc = valid & ((d < -_DELTA_MAX) | (d > _DELTA_MAX))
    code = jnp.where(exc, _EXC_CODE, d + (_DELTA_MAX + 1))
    u8 = (ops | (code << 2)).astype(jnp.uint8)
    starts = vids[:, 0].astype(jnp.int32)
    flat_exc = exc.reshape(-1)
    n_exc = jnp.sum(flat_exc).astype(jnp.int32)
    slot = jnp.cumsum(flat_exc) - 1
    # overflow slots collide at e_cap (sliced off) rather than clobber
    idx = jnp.where(flat_exc, jnp.minimum(slot, e_cap), e_cap)
    pos_buf = jnp.zeros(e_cap + 1, jnp.int32).at[idx].set(
        jnp.arange(b * t, dtype=jnp.int32), mode="drop"
    )
    val_buf = jnp.zeros(e_cap + 1, jnp.int32).at[idx].set(
        vids.reshape(-1), mode="drop"
    )
    return u8, starts, jnp.concatenate([pos_buf, val_buf]), n_exc


def _decode_tape_u8(u8: np.ndarray, starts: np.ndarray,
                    excpos: np.ndarray, excval: np.ndarray):
    """Host-side inverse of _encode_tape_u8 -> (ops i8, vids i32).

    Reconstruction: prefix-sum the deltas (exception deltas as 0), then
    anchor every segment on its latest absolute value — column 0
    (starts) or an exception — via a forward-filled anchor index."""
    t32 = u8.astype(np.int32)
    ops = (t32 & 3).astype(np.int8)
    code = t32 >> 2
    d = np.where(code == _EXC_CODE, 0, code - (_DELTA_MAX + 1))
    d[:, 0] = 0
    c = np.cumsum(d, axis=1, dtype=np.int32)
    b, t = u8.shape
    sentinel = np.iinfo(np.int32).min
    base = np.full((b, t), sentinel, np.int32)
    base[:, 0] = starts.astype(np.int32)  # c[:, 0] == 0
    if len(excpos):
        r = excpos // t
        j = excpos % t
        base[r, j] = excval - c[r, j]
    idx = np.where(base != sentinel, np.arange(t, dtype=np.int32)[None, :], 0)
    np.maximum.accumulate(idx, axis=1, out=idx)
    vids = base[np.arange(b)[:, None], idx] + c
    return ops, vids


def _fused_drain_fn(layout):
    """One jitted executable running EVERY chunk of a drain: per chunk,
    slice its wire from the mega buffer (static offsets), decode, DP,
    traceback, and column-slice the tape to its static guess; concatenate
    the per-chunk scores/tapes/tlens so the host drains THREE buffers in
    one device_get: ONE execution in place of ~4 executables for each of
    N chunks.

    layout: tuple of (version, dims, t_guess, wsize) per chunk — all
    ladder-quantized upstream so executables repeat across drains.
    Traced with x64 off (pure i32/f32 kernel; the package enables x64
    globally for the exact chain DP, which would widen every iota/new
    literal here to emulated i64)."""
    u8_mode = _tape_u8_enabled()
    key = (layout, u8_mode)
    fn = _FUSED_CACHE.get(key)
    if fn is not None:
        return fn
    kerns = {
        "v2": poa_global_kernel_wire2,
        "v3": poa_global_kernel_wire3,
        "v4": poa_global_kernel_wire4,
    }

    def fused(mega):
        scores, tapes, tlens, fulls = [], [], [], []
        starts, excs, nexcs = [], [], []
        off = 0
        for version, dims, t_guess, wsize, e_cap in layout:
            wire = mega[off : off + wsize]
            off += wsize
            score, tape, tlen = kerns[version](wire, *dims)
            scores.append(score)
            tlens.append(tlen)
            t_cap = tape.shape[1]
            cut = tape[:, :t_guess] if t_guess < t_cap else tape
            if e_cap:
                u8, st, ex, ne = _encode_tape_u8(cut, e_cap)
                tapes.append(u8.reshape(-1))
                starts.append(st)
                excs.append(ex)
                nexcs.append(ne.reshape(1))
            else:
                tapes.append(cut.reshape(-1))
            fulls.append(tape)
        return (
            jnp.concatenate(scores),
            jnp.concatenate(tapes),
            jnp.concatenate(tlens),
            tuple(fulls),
            jnp.concatenate(starts) if starts else jnp.zeros(0, jnp.int32),
            jnp.concatenate(excs) if excs else jnp.zeros(0, jnp.int32),
            jnp.concatenate(nexcs) if nexcs else jnp.zeros(0, jnp.int32),
        )

    jf = jax.jit(fused)

    def call(mega_d):
        with jax.enable_x64(False):
            return jf(mega_d)

    _FUSED_CACHE[key] = call
    return call


def kernel_launch_fused(prepared):
    """Launch a whole drain of prepared chunks as ONE upload + ONE
    executable (see _fused_drain_fn).  Per-chunk wire buffers are packed
    back-to-back at ladder-quantized offsets into one mega buffer so the
    (layout -> executable) cache hits across drains.  Returns pending
    states in kernel_finish layout, with each out_d a (_FusedOut, i)
    pair that kernel_finish_all recognizes."""
    pendings = []
    group: list = []
    gbytes = 0

    def flush():
        nonlocal group, gbytes
        if not group:
            return
        sizes = [_ladder_bytes(len(g[0])) for g in group]
        offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        layout = []
        plan = []
        u8_mode = _tape_u8_enabled()
        with timer.phase("d_pad"):
            mega = np.zeros(_ladder_bytes(int(offs[-1])), np.uint8)
            for (w, version, dims, rest), o, sz in zip(group, offs[:-1], sizes):
                mega[o : o + len(w)] = w
                t_cap = dims[1] + dims[3] + 2  # tape cols: V + (L+1) + 1
                qlens = [len(q) for q in rest[7] if q is not None]
                t_guess = (
                    _tape_guess_cols(t_cap, max(qlens), dims[1])
                    if qlens else t_cap
                )
                b_pad = rest[5]
                # exception budget: ~1 slot/row covers the worst case of
                # one virtual-source switch per problem plus far jumps
                e_cap = max(256, b_pad) if u8_mode else 0
                layout.append((version, dims, t_guess, sz, e_cap))
                plan.append((b_pad, t_guess, e_cap))
        fn = _fused_drain_fn(tuple(layout))
        with timer.phase("d_upload"):
            mega_d = jnp.asarray(mega)
        with timer.phase("d_launch"):
            scores, tapes, tlens, fulls, starts, excs, nexcs = fn(mega_d)
        shared = _FusedOut(scores, tapes, tlens, fulls, tuple(plan),
                           starts, excs, nexcs)
        for i, (w, version, dims, rest) in enumerate(group):
            pendings.append(((shared, i),) + rest)
        group, gbytes = [], 0

    for item in prepared:
        if group and _ladder_bytes(gbytes + _ladder_bytes(len(item[0]))) > _WIRE_MEGA_CAP:
            flush()
        group.append(item)
        gbytes += _ladder_bytes(len(item[0]))
    flush()
    return pendings


def kernel_launch_wires(prepared):
    """Upload MANY prepared chunks' wire buffers in ONE device_put and
    launch them.  Default: the fused single-executable drain
    (kernel_launch_fused); VGALIGNER_POA_FUSED=0 falls back to one
    executable chain per chunk on device-side dynamic slices of the
    mega buffer.  Returns pending states (kernel_finish layout), in
    input order."""
    if os.environ.get("VGALIGNER_POA_FUSED", "1") != "0":
        return kernel_launch_fused(prepared)
    pendings = []
    group: list = []
    gbytes = 0

    kerns = {
        "v2": poa_global_kernel_wire2,
        "v3": poa_global_kernel_wire3,
        "v4": poa_global_kernel_wire4,
    }

    def flush():
        nonlocal group, gbytes
        if not group:
            return
        if len(group) == 1:
            wire, version, dims, rest = group[0]
            with timer.phase("d_upload"):
                wire_d = jnp.asarray(wire)
            with timer.phase("d_launch"):
                out_d = kerns[version](wire_d, *dims)
            pendings.append((out_d,) + rest)
        else:
            sizes = [len(g[0]) for g in group]
            offs = np.concatenate([[0], np.cumsum(sizes)])
            mega = np.zeros(_ladder_bytes(int(offs[-1])), np.uint8)
            for (w, _, _, _), o in zip(group, offs[:-1]):
                mega[o : o + len(w)] = w
            with timer.phase("d_upload"):
                mega_d = jnp.asarray(mega)
            with timer.phase("d_launch"):
                for (w, version, dims, rest), o in zip(group, offs[:-1]):
                    wire_d = _slice_wire(mega_d, int(o), len(w))
                    out_d = kerns[version](wire_d, *dims)
                    pendings.append((out_d,) + rest)
        group, gbytes = [], 0

    for item in prepared:
        # cap the PADDED upload size (ladder padding adds up to 12.5%)
        if group and _ladder_bytes(gbytes + len(item[0])) > _WIRE_MEGA_CAP:
            flush()
        group.append(item)
        gbytes += len(item[0])
    flush()
    return pendings


def kernel_dispatch(built, qs, v_pad: int, l_pad: int, mesh=None):
    """Launch the device POA kernel (async) on a ladder-padded chunk.
    Returns the pending state consumed by kernel_finish — split so
    multiple buckets queue on device back-to-back before any host sync.

    On the production wire path this is prepare + launch for a single
    chunk; batch callers use kernel_prepare_chunked + kernel_launch_wires
    to share one upload across chunks.  With a mesh, chunk arrays are
    sharded along the batch dim (problems are independent, so SPMD
    compilation inserts no collectives) — ladder pads are pow2, so any
    pow2 mesh divides them evenly."""
    if wire2_path_available(mesh):
        return kernel_launch_wires([kernel_prepare(built, qs, v_pad, l_pad)])[0]
    vcodes, vpred, is_sink, nv, node_of, off_in = built
    n_real = len(qs)
    b_pad = vcodes.shape[0]
    with timer.phase("d_pad"):
        q_pad, nq = _pad_queries(qs, b_pad, l_pad)
    with timer.phase("d_launch"):
        # dense wire format (see poa_global_kernel_packed): sink bit
        # folded into vcodes, predecessors as int16
        vcodes_p = (vcodes | (is_sink.astype(np.int8) << 5)).astype(np.int8)
        vpred16 = _slice_preds(vpred, n_real).astype(np.int16)
        if mesh is None and wire_bitcast_supported():
            # VGALIGNER_POA_WIRE=v1 escape hatch: dense int16 preds
            P = vpred16.shape[-1]
            wire = pack_chunk_wire(vcodes_p, vpred16, nv, q_pad, nq)
            out_d = poa_global_kernel_wire(
                jnp.asarray(wire), b_pad, vcodes.shape[1], P, l_pad
            )
            return (out_d, vcodes, node_of, off_in, q_pad, v_pad,
                    b_pad, n_real, qs)
        args = (vcodes_p, vpred16, nv, q_pad, nq)
        if mesh is not None and b_pad % mesh.devices.size == 0:
            from ..parallel.mesh import shard_batch

            args = shard_batch(mesh, *(jnp.asarray(a) for a in args))
        else:
            args = tuple(jnp.asarray(a) for a in args)
        out_d = poa_global_kernel_packed(*args)
    return (out_d, vcodes, node_of, off_in, q_pad, v_pad, b_pad, n_real, qs)


def _on_one_device(arr) -> bool:
    try:
        return len(arr.devices()) == 1
    except Exception:
        return True  # plain np arrays (CPU fallbacks)


@jax.jit
def _concat_dtype_groups(groups):
    return tuple(
        jnp.concatenate([x.reshape(-1) for x in g]) for g in groups
    )


def fetch_grouped(arrays):
    """Fetch many device arrays with a minimal number of transfers:
    group by dtype, concatenate each group on device into one flat
    buffer, drain all buffers in a single device_get, and split back
    host-side: O(n_dtypes) transfers instead of O(n_arrays); the concat is a cheap on-device copy, and the jit
    caches one executable per (dtype, shape) structure (shape ladders
    upstream keep that set small).  Plain fetch when there is nothing
    to merge or any array is mesh-sharded (the concat would force a
    cross-device gather).  Returns np arrays — original shapes, input
    order."""
    arrays = list(arrays)
    if len(arrays) <= 1 or not all(_on_one_device(a) for a in arrays):
        return list(jax.device_get(arrays))

    def _dev_of(a):
        try:
            return next(iter(a.devices()))
        except Exception:
            return None

    # group by (device, dtype): per-device wire dispatch (mesh path)
    # leaves chunk outputs on different single devices, and a concat jit
    # cannot mix them — each device gets its own flat buffer per dtype,
    # still drained in one device_get
    groups: dict = {}  # (device, dtype) -> list of device arrays
    offset: dict = {}  # (device, dtype) -> running flat offset
    plan = []  # (key, start, shape) per input, in order
    for a in arrays:
        key = (_dev_of(a), np.dtype(a.dtype))
        g = groups.setdefault(key, [])
        plan.append((key, offset.get(key, 0), a.shape))
        offset[key] = offset.get(key, 0) + int(np.prod(a.shape))
        g.append(a)
    n_devices = len({key[0] for key in groups})
    if n_devices == 1:  # common path: one jit call covering all dtypes
        cats = list(
            _concat_dtype_groups(tuple(tuple(g) for g in groups.values()))
        )
    else:
        cats = []
        for g in groups.values():
            cats.extend(_concat_dtype_groups((tuple(g),)))
    cats = jax.device_get(cats)
    bufs = dict(zip(groups.keys(), cats))
    return [
        bufs[key][start : start + int(np.prod(shape))].reshape(shape)
        for key, start, shape in plan
    ]


@partial(jax.jit, static_argnums=(1,))
def _slice_tape(tape, t_used):
    return tape[:, :t_used]


def _tape_guess_cols(t_cap: int, max_q: int, V: int = 0) -> int:
    """Static column guess for the single-trip tape fetch: a global
    alignment's traceback walks nq matches/insertions plus one step per
    deletion, so ~query length + slack covers all but deletion-heavy
    paths (those refetch in one batched device_get, kernel_finish_all).

    Measured traceback lengths on the corridor pipeline (1,024 DRB1
    reads, r4): V=256 p99 173; V=512 max 503 and V=1024 max 556 (the
    mid-V chunks are sparse-anchor reads that delete through ~V
    vertices — they overflowed the query-based guess on EVERY drain);
    V>=2048 max 148 at 100 bp (the corridor keeps huge-V subgraphs'
    alignments compact — the old fetch-the-full-tape rule shipped
    4,225 columns for ~150 used, ~3 MB of dead bytes per drain).
    Hence: query-based guess everywhere except 512 <= V < 2048, which
    gets ~V columns.  r5: LONG queries (> 256 bp) on V >= 2048 chunks
    walk ~nq + over-a-thousand deletions (measured used=2340 at 1 kb /
    V=4096 — overflowing the 2048 guess and paying a full-tape refetch
    EVERY drain), so they get ~V columns too — the extra u8 tape bytes
    are KBs, the saved refetch is a whole second transfer."""
    slack = int(os.environ.get("VGALIGNER_POA_TAPE_SLACK", "64"))
    base = min(t_cap, max(64, 1 << max(0, max_q + slack - 1).bit_length()))
    if 512 <= V < 2048 or (V >= 2048 and max_q > 256):
        return min(t_cap, max(base, 1 << max(0, V - 1).bit_length()))
    return base


def _finish_fused(pendings):
    """Drain fused-launch pendings: ONE device_get of the drain's three
    concatenated buffers, host-side split by the static plan, rare
    per-chunk full-tape refetch on traceback overflow, then decode."""
    # group by shared _FusedOut (usually one per drain)
    shared_ids: dict = {}
    for p in pendings:
        shared, _ci = p[0]
        shared_ids.setdefault(id(shared), shared)
    fetched: dict = {}
    with timer.phase("f_fetch"):
        got = jax.device_get(
            [(s.scores, s.tapes, s.tlens, s.starts, s.excs, s.nexcs)
             for s in shared_ids.values()]
        )
    for key, vals in zip(shared_ids, got):
        fetched[key] = vals
    out: List = []
    decoded: List = []
    refetch = []  # (decoded index, device tape slice)
    for p in pendings:
        shared, ci = p[0]
        (scores_cat, tapes_cat, tlens_cat,
         starts_cat, excs_cat, nexcs_cat) = fetched[id(shared)]
        b0 = sum(b for b, _t, _e in shared.plan[:ci])
        t0 = sum(b * t for b, t, _e in shared.plan[:ci])
        e0 = sum(2 * (e + 1) for _b, _t, e in shared.plan[:ci] if e)
        b_pad, t_guess, e_cap = shared.plan[ci]
        scores = scores_cat[b0 : b0 + b_pad]
        tlens = tlens_cat[b0 : b0 + b_pad]
        tape = tapes_cat[t0 : t0 + b_pad * t_guess].reshape(b_pad, t_guess)
        n_real = p[7]
        used = int(tlens[:n_real].max()) if n_real else 1
        exc_over = False
        if e_cap:
            # nexcs/excs carry entries ONLY for e_cap != 0 chunks, so
            # index them by the e_cap-chunk ordinal (mirroring e0), not
            # by the raw chunk index — a mixed-e_cap plan would silently
            # misalign the exception slices otherwise
            ei = sum(1 for _b, _t, e in shared.plan[:ci] if e)
            n_exc = int(nexcs_cat[ei])
            exc_over = n_exc > e_cap
            if not exc_over and used <= t_guess:
                pair = excs_cat[e0 : e0 + 2 * (e_cap + 1)]
                with timer.phase("f_decode"):
                    from ..native import available as _native_ok

                    try:
                        if _native_ok():
                            from ..native import decode_tape_u8_native

                            tape = decode_tape_u8_native(
                                tape, starts_cat[b0 : b0 + b_pad],
                                pair[:n_exc],
                                pair[e_cap + 1 : e_cap + 1 + n_exc],
                            )
                        else:
                            tape = _decode_tape_u8(
                                tape, starts_cat[b0 : b0 + b_pad],
                                pair[:n_exc],
                                pair[e_cap + 1 : e_cap + 1 + n_exc],
                            )
                    except ValueError as e:
                        # corrupt exception stream: a safe fallback (the
                        # retained full u16 tape, same as exc_over)
                        # exists one level up — use it instead of
                        # aborting the whole drain
                        log.warning(
                            "u8 tape decode failed (%s); refetching the "
                            "full u16 tape for chunk %d", e, ci,
                        )
                        exc_over = True
        if os.environ.get("VGALIGNER_POA_DEBUG_TAPE"):
            import sys as _sys

            _sys.stderr.write(
                f"tape chunk b_pad={b_pad} t_guess={t_guess} "
                f"used={used} overflow={used > t_guess} "
                f"exc_over={exc_over}\n"
            )
        if used > t_guess or exc_over:
            # deletion-heavy chunk (traceback ran past the guess):
            # queue its real-length tape; ALL such chunks refetch in
            # ONE device_get below — big-V chunks overflow together
            t_cap = shared.fulls[ci].shape[1]
            t_used = min(t_cap, max(64, 1 << max(0, used - 1).bit_length()))
            refetch.append((
                len(decoded),
                _slice_tape(shared.fulls[ci], t_used)
                if t_used < t_cap
                else shared.fulls[ci],
            ))
        decoded.append((p, (scores, tape, tlens)))
    if refetch:
        with timer.phase("f_fetch"):
            full = jax.device_get([t for _i, t in refetch])
        for (i, _t), tape in zip(refetch, full):
            p, (scores, _old, tlens) = decoded[i]
            decoded[i] = (p, (scores, tape, tlens))
    for p, f in decoded:
        out.extend(_decode_finished(p, f))
    return out


def _is_fused_pending(p) -> bool:
    return isinstance(p[0], tuple) and isinstance(p[0][0], _FusedOut)


def pending_outputs(p):
    """Per-chunk (score [b_pad], tape [b_pad, t], tlen [b_pad]) device
    arrays of one pending state, for either launch path (test/debug
    utility; the fused path slices the shared buffers on device)."""
    if not _is_fused_pending(p):
        return p[0]
    shared, ci = p[0]
    b0 = sum(b for b, _t, _e in shared.plan[:ci])
    b_pad, t_guess, _e_cap = shared.plan[ci]
    # slice the retained full u16 tape rather than the fetch payload:
    # the payload is the u8 delta encoding in the default mode
    return (
        shared.scores[b0 : b0 + b_pad],
        shared.fulls[ci][:, :t_guess],
        shared.tlens[b0 : b0 + b_pad],
    )


def kernel_finish_all(pendings):
    """Fetch MANY dispatched chunks with a minimal number of
    transfers, then decode.  Fused-launch pendings (kernel_launch_fused)
    drain via ONE device_get of pre-concatenated buffers; per-chunk
    pendings go through a grouped fetch pass (fetch_grouped — one flat
    buffer per dtype) carrying scores, tlens, and the tapes
    column-sliced ON DEVICE to a static guess of each chunk's traceback
    length (~max query length + slack, pow2-laddered).

    The tape buffer is sized worst-case (T = V + nq + 1, every vertex
    visited) but a global alignment walks ~query-length steps, so the
    guess fetches 10-20x fewer bytes on big-V chunks while keeping the
    drain at a single transfer.  A chunk whose real max traceback exceeds
    the guess (deletion-heavy path; requires > slack deletions) pays a
    rare second fetch of its full-length tape.  Returns the
    concatenated per-chunk result lists, in order."""
    if pendings and any(_is_fused_pending(p) for p in pendings):
        if all(_is_fused_pending(p) for p in pendings):
            return _finish_fused(pendings)
        # mixed drain (e.g. wire chunks + mesh chunks): finish each kind
        # with its own path, then restore input order
        order = [(i, p) for i, p in enumerate(pendings)]
        fused = [(i, p) for i, p in order if _is_fused_pending(p)]
        plain = [(i, p) for i, p in order if not _is_fused_pending(p)]
        res: dict = {}
        for (group, finisher) in ((fused, _finish_fused), (plain, kernel_finish_all)):
            if not group:
                continue
            got = finisher([p for _i, p in group])
            pos = 0
            for i, p in group:
                n_real = p[7]
                res[i] = got[pos : pos + n_real]
                pos += n_real
        out: List = []
        for i in range(len(pendings)):
            out.extend(res[i])
        return out
    outs = [p[0] for p in pendings]
    guesses = []
    parts = []
    for o, p in zip(outs, pendings):
        t_cap = o[1].shape[1]
        max_q = max((len(q) for q in p[8]), default=1)
        # p[5] is the chunk's real V (v_pad) — reconstructing it from
        # t_cap - max_q - 2 overestimated V by (l_pad - max_q) and sent
        # short-query large-l_pad chunks down the fetch-everything path
        t_guess = _tape_guess_cols(t_cap, max_q, p[5])
        guesses.append(t_guess)
        parts.extend(
            (o[0], o[2], _slice_tape(o[1], t_guess) if t_guess < t_cap else o[1])
        )
    with timer.phase("f_fetch"):
        fetched = fetch_grouped(parts)
    scores_l, tlens_l, tapes_l = fetched[0::3], fetched[1::3], fetched[2::3]
    # rare overflow pass: refetch any chunk whose real traceback ran past
    # the guess, sliced to the real max this time
    refetch = []
    for i, (o, tlens, p) in enumerate(zip(outs, tlens_l, pendings)):
        n_real = p[7]
        used = int(tlens[:n_real].max()) if n_real else 1
        if used > guesses[i]:
            t_cap = o[1].shape[1]
            t_used = min(t_cap, max(64, 1 << max(0, used - 1).bit_length()))
            refetch.append(
                (i, _slice_tape(o[1], t_used) if t_used < t_cap else o[1])
            )
    if refetch:
        with timer.phase("f_fetch"):
            full = fetch_grouped([t for _i, t in refetch])
        for (i, _t), tape in zip(refetch, full):
            tapes_l[i] = tape
    out: List = []
    for i, pending in enumerate(pendings):
        out.extend(
            _decode_finished(pending, (scores_l[i], tapes_l[i], tlens_l[i]))
        )
    return out


def kernel_finish(pending):
    """Fetch ONE dispatched chunk's results and decode (single-pending
    convenience over kernel_finish_all, sharing its two-phase fetch)."""
    return kernel_finish_all([pending])


def _decode_finished(pending, fetched):
    from ..native import finish_tapes_native
    from .poa import PoaResult

    _out_d, vcodes, node_of, off_in, q_pad, v_pad, b_pad, n_real, qs = pending
    scores, tape, tlens = fetched
    if isinstance(tape, tuple):  # pre-decoded u8 delta tape (ops, vids)
        ops, vids = tape
    else:
        ops, vids = unpack_tape(tape)

    with timer.phase("f_decode"):
        # decode only the real rows: batch-pad rows are zeroed throwaway
        # problems whose tapes are garbage (and must not be walked)
        bg_off = np.arange(n_real + 1, dtype=np.int64) * v_pad
        cigars, css, node_paths, path_vertices, scalars = finish_tapes_native(
            ops[:n_real], vids[:n_real], tlens[:n_real].astype(np.int32),
            bg_off, vcodes[:n_real].reshape(-1), node_of[:n_real].reshape(-1),
            off_in[:n_real].reshape(-1), q_pad[:n_real],
        )
    with timer.phase("f_build"):
        results = []
        for i in range(n_real):
            results.append(
                PoaResult(
                    cigar=cigars[i],
                    cs=css[i],
                    path_vertices=path_vertices[i],
                    node_path=node_paths[i],
                    aln_start_offset=int(scalars[i, 2]),
                    aln_end_offset=int(scalars[i, 3]),
                    n_aligned=int(scalars[i, 0]),
                    best_score=int(scores[i]),
                    query_start=0,
                    query_end=len(qs[i]),
                    path_start_offset=int(scalars[i, 4]),
                    path_end_offset=int(scalars[i, 5]),
                    residue_matches=int(scalars[i, 1]),
                )
            )
    return results


def kernel_and_finish(built, qs, v_pad: int, l_pad: int):
    """Run the device POA kernel over prebuilt problem arrays and decode
    the tapes natively into PoaResults.  On the wire path, a
    multi-chunk bucket shares one upload (kernel_launch_wires)."""
    if wire2_path_available():
        pendings = kernel_launch_wires(
            kernel_prepare_chunked(built, qs, v_pad, l_pad)
        )
    else:
        pendings = kernel_dispatch_chunked(built, qs, v_pad, l_pad)
    return kernel_finish_all(pendings)


def _align_bucket(bgs, qs, v_pad: int, l_pad: int):
    from .poa import _finish_result

    probs = [prepare_problem(bg, q, v_pad, l_pad) for bg, q in zip(bgs, qs)]
    # pad the batch dim so executables cache across batches
    b_pad = _next_pow2(max(len(probs), 4))
    while len(probs) < b_pad:
        probs.append(probs[0])
    init_row = make_init_row(l_pad)

    scores, tape, tlens = jax.device_get(
        poa_global_kernel(
            jnp.asarray(np.stack([p.vcodes for p in probs])),
            jnp.asarray(_slice_preds(np.stack([p.vpred for p in probs]))),
            jnp.asarray(np.stack([p.is_sink for p in probs])),
            jnp.asarray(np.asarray([p.nv for p in probs], dtype=np.int32)),
            jnp.asarray(np.stack([p.q for p in probs])),
            jnp.asarray(np.asarray([p.nq for p in probs], dtype=np.int32)),
            jnp.asarray(init_row),
        )
    )
    ops, vids = unpack_tape(tape)

    results = []
    for i, (bg, q) in enumerate(zip(bgs, qs)):
        t = int(tlens[i])
        tape_ops = ops[i][:t][::-1]
        tape_vids = vids[i][:t][::-1]
        # rebuild (op, vertex, query_pos) triples in forward order
        triples = []
        qpos = 0
        for op, v in zip(tape_ops, tape_vids):
            if op == OP_M:
                kind = "M" if v >= 0 and q[qpos] == bg.codes[v] else "X"
                triples.append((kind, int(v), qpos))
                qpos += 1
            elif op == OP_I:
                triples.append(("I", int(v), qpos))
                qpos += 1
            elif op == OP_D:
                triples.append(("D", int(v), qpos))
        results.append(_finish_result(bg, q, triples, int(scores[i]), 0, len(q)))
    return results
