"""The chaining DP as a device kernel (lax.scan + vectorized window).

Behavioral reference: chain_anchors / score_anchor
(rs-vgaligner src/chain.rs:274-655).  The reference runs, per read, a
scalar double loop: for each anchor i, score the previous `bandwidth`
anchors j and keep the best strictly-improving predecessor, while
tracking the global best proposed score `curr_max`; backtracking then
extracts exactly the chains whose final score equals `curr_max`
(chain.rs:469).

Device formulation:
  * anchors are sorted by target_end ascending with a *stable* sort (the
    reference sorts by (orient desc, target_end asc), chain.rs:386-389;
    the production forward-only path makes the orient key constant, so
    stable-by-target_end is exact);
  * one lax.scan step per anchor i; the bandwidth-50 predecessor window
    is a dynamic_slice over the carried f-array and scored as one masked
    f64 vector op, batched over reads via vmap;
  * the gap cost 0.01*k*g + 0.5*log2(g) (chain.rs:348-354) is a host-
    precomputed f64 table indexed by gap length — bit-identical to CPU
    libm and free of device transcendentals;
  * the 3-decimal rounding is Rust's round-half-away-from-zero
    (chain.rs:361-363), reproduced with floor/ceil;
  * predecessor tie-breaks reproduce the reference's descending-j scan
    with strict improvement: the *largest* j among window maxima wins.

Scores stay f64 end to end because chain selection tests exact f64
equality with curr_max.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

NEG = -np.float64(np.finfo(np.float64).max)  # reference's -f64::MAX


def make_gap_cost_table(seed_length: int, max_gap: int) -> np.ndarray:
    """gap -> gamma_c(gap) for gap in [0, max_gap] (chain.rs:348-354)."""
    g = np.arange(max_gap + 1, dtype=np.float64)
    with np.errstate(divide="ignore"):
        cost = 0.01 * float(seed_length) * g + 0.5 * np.log2(g)
    cost[0] = 0.0
    return cost


def _round3(x: jnp.ndarray, thousand: jnp.ndarray) -> jnp.ndarray:
    """Rust f64::round(x*1000)/1000 — half away from zero (chain.rs:361-363).

    `thousand` must be a *traced* 1000.0: XLA strength-reduces division by a
    constant into multiplication by the reciprocal, which is not IEEE
    division and breaks bit-identity with the reference's f64 math; a
    runtime operand forces a true divide.
    """
    y = x * thousand
    r = jnp.where(y >= 0.0, jnp.floor(y + 0.5), jnp.ceil(y - 0.5))
    return r / thousand


class ChainScores(NamedTuple):
    order: jnp.ndarray  # [B, A] int32: sorted position -> generation slot
    qb: jnp.ndarray  # [B, A] int32 (sorted order)
    tb: jnp.ndarray  # [B, A] int64
    te: jnp.ndarray  # [B, A] int64
    valid: jnp.ndarray  # [B, A] bool
    f: jnp.ndarray  # [B, A] float64 max chain score per anchor
    pred: jnp.ndarray  # [B, A] int32 predecessor *sorted position*, -1 = none
    curr_max: jnp.ndarray  # [B] float64 global best proposed score


@partial(jax.jit, static_argnames=("seed_length", "bandwidth", "precision"))
def chain_scores(
    qb: jnp.ndarray,
    tb: jnp.ndarray,
    te: jnp.ndarray,
    valid: jnp.ndarray,
    gap_table: jnp.ndarray,
    seed_length: int,
    bandwidth: int = 50,
    precision: str = "exact",
) -> ChainScores:
    """Batched chaining DP. Inputs are AnchorBatch arrays [B, A].

    precision:
      * "exact" — f64, the reference's exact op sequence (bit-identical
        scores on IEEE backends; the parity mode);
      * "fast" — f32 with scores pre-scaled by 1000 so every value is an
        exactly-representable integer (< 2^24): no division and no
        f64.  Gap costs are f32-rounded, so proposals within
        ~0.01 milli-units of a rounding boundary may differ from exact
        mode — chains can differ only at such ties.  f/curr_max are
        returned in the scaled domain (consistent for the == test).
    """
    if precision == "fast":
        return _chain_scores_fast(qb, tb, te, valid, gap_table, seed_length, bandwidth)

    max_gap = gap_table.shape[0] - 1
    # runtime scalar defeating XLA's div-by-constant strength reduction
    thousand = gap_table[0] + 1000.0

    # stable sort by target_end; invalid slots sink to the end.  Slot order
    # within equal te is generation order == anchor id order, matching the
    # reference's stable sort_by (chain.rs:386-389).
    sort_key = jnp.where(valid, te, jnp.iinfo(te.dtype).max)
    order = jnp.argsort(sort_key, axis=1, stable=True).astype(jnp.int32)
    qb_s = jnp.take_along_axis(qb, order, axis=1)
    tb_s = jnp.take_along_axis(tb, order, axis=1)
    te_s = jnp.take_along_axis(te, order, axis=1)
    valid_s = jnp.take_along_axis(valid, order, axis=1)

    k_f = jnp.float64(seed_length)
    qe_s = qb_s.astype(jnp.int64) + seed_length

    def one_read(qb_r, tb_r, te_r, qe_r, valid_r):
        A = qb_r.shape[0]
        w = min(bandwidth, A)  # static window size; masked below
        f0 = jnp.full((A,), k_f, dtype=jnp.float64)

        def step(carry, i):
            f, curr_max = carry
            s = jnp.maximum(i - w, 0)
            j_ids = s + jnp.arange(w, dtype=jnp.int32)
            in_window = (j_ids < i) & (j_ids >= i - bandwidth)

            qb_j = jax.lax.dynamic_slice(qb_r, (s,), (w,))
            tb_j = jax.lax.dynamic_slice(tb_r, (s,), (w,))
            te_j = jax.lax.dynamic_slice(te_r, (s,), (w,))
            qe_j = jax.lax.dynamic_slice(qe_r, (s,), (w,))
            f_j = jax.lax.dynamic_slice(f, (s,), (w,))
            v_j = jax.lax.dynamic_slice(valid_r, (s,), (w,))

            qb_i, tb_i, te_i, qe_i = qb_r[i], tb_r[i], te_r[i], qe_r[i]
            mask = in_window & v_j & valid_r[i]

            # -f64::MAX cases (chain.rs:277-311); orients are uniform in the
            # forward-only production path so the orient clauses are constant
            bad = (qe_j >= qe_i) | (te_j >= te_i)

            ql = jnp.minimum(qb_i - qb_j.astype(jnp.int64), qe_i - qe_j)
            tl = jnp.minimum(jnp.abs(tb_i - tb_j), jnp.abs(te_i - te_j))
            gap = jnp.abs(ql - tl)
            bad = bad | (gap > max_gap)
            gcost = gap_table[jnp.clip(gap, 0, max_gap)]
            mlen = jnp.minimum(jnp.minimum(ql, tl), seed_length).astype(jnp.float64)

            prop = _round3(f_j + mlen - gcost, thousand)
            prop = jnp.where(mask & ~bad, prop, NEG)

            m = jnp.max(prop)
            # largest j among maxima = last occurrence in ascending window
            j_star_rev = jnp.argmax(prop[::-1])
            j_star = s + (w - 1 - j_star_rev).astype(jnp.int32)

            improved = m > k_f  # strict (> initial score, chain.rs:430)
            f_i = jnp.where(improved, m, k_f)
            pred_i = jnp.where(improved, j_star, jnp.int32(-1))
            f = jax.lax.dynamic_update_slice(f, f_i[None], (i,))
            curr_max = jnp.maximum(curr_max, m)
            return (f, curr_max), pred_i

        (f_fin, curr_max), preds = jax.lax.scan(
            step, (f0, jnp.float64(0.0)), jnp.arange(1, A, dtype=jnp.int32),
            unroll=8,
        )
        preds = jnp.concatenate([jnp.full((1,), -1, jnp.int32), preds])
        return f_fin, preds, curr_max

    f, pred, curr_max = jax.vmap(one_read)(qb_s, tb_s, te_s, qe_s, valid_s)
    return ChainScores(
        order=order, qb=qb_s, tb=tb_s, te=te_s, valid=valid_s,
        f=f, pred=pred, curr_max=curr_max,
    )


# Degree-7 polynomial for log2(x) on [1, 2), least-squares fit; max abs
# error 1.75e-6 over the full mantissa range.  Evaluated with plain f32
# multiply/add (IEEE-rounded per op on every XLA backend),
# so the SAME bits come out on every XLA backend —
# unlike jnp.log2, whose implementation is backend-defined.
_LOG2_COEF = (
    8.121406e-07, 1.4426336, -0.72020257, 0.47172138,
    -0.32148254, 0.18865165, -0.07592032, 0.01459849,
)


def _log2_poly_f32(gf):
    """Deterministic f32 log2 via exponent extraction + Horner poly."""
    bits = jax.lax.bitcast_convert_type(gf, jnp.int32)
    e = ((bits >> 23) & 0xFF) - 127
    x = jax.lax.bitcast_convert_type(
        (bits & 0x7FFFFF) | (127 << 23), jnp.float32
    )
    t = x - jnp.float32(1.0)
    acc = jnp.full(t.shape, jnp.float32(_LOG2_COEF[7]))
    for d in range(6, -1, -1):
        acc = acc * t + jnp.float32(_LOG2_COEF[d])
    return e.astype(jnp.float32) + acc


def gap_cost_scaled_i32(gap, seed_length: int):
    """Fast-mode gap cost as a pre-rounded scaled integer (i32):
    round(1000 * (0.01*k*g + 0.5*log2(g))) = 10*k*g + round(500*log2(g)).

    The 10*k*g term is exact integer math; the log2 term uses the
    deterministic poly above and rounds once, here — so fast-mode DP
    becomes pure integer arithmetic (no per-step float rounding, exact
    up to 2^31 instead of f32's 2^24) and, wherever the poly-rounded
    integer equals the f64 table's (verified exhaustively for every
    g <= 1000 in test_chain.py), fast-mode scores equal exact-mode
    scores times 1000."""
    gf = gap.astype(jnp.float32)
    lg = jnp.floor(
        jnp.float32(500.0) * _log2_poly_f32(gf) + jnp.float32(0.5)
    ).astype(jnp.int32)
    cost = jnp.int32(10 * seed_length) * gap.astype(jnp.int32) + lg
    return jnp.where(gap == 0, jnp.int32(0), cost)


def _chain_scores_fast(qb, tb, te, valid, gap_table, seed_length, bandwidth):
    """Scaled-integer (i32) variant of the DP (see chain_scores
    docstring).  Anchors are fixed-length k-mers (qe = qb + k), so the
    reference's min(qb_i-qb_j, qe_i-qe_j) collapses to qb_i-qb_j and
    the qe_j >= qe_i overlap test to qb_j >= qb_i."""
    NEGI = jnp.int32(-(1 << 30))
    max_gap = int(gap_table.shape[0]) - 1

    sort_key = jnp.where(valid, te, jnp.iinfo(te.dtype).max)
    order = jnp.argsort(sort_key, axis=1, stable=True).astype(jnp.int32)
    qb_s = jnp.take_along_axis(qb, order, axis=1)
    tb_s = jnp.take_along_axis(tb, order, axis=1).astype(jnp.int32)
    te_s = jnp.take_along_axis(te, order, axis=1).astype(jnp.int32)
    valid_s = jnp.take_along_axis(valid, order, axis=1)

    k_i = jnp.int32(seed_length * 1000)

    def one_read(qb_r, tb_r, te_r, valid_r):
        A = qb_r.shape[0]
        w = min(bandwidth, A)
        f0 = jnp.full((A,), k_i, dtype=jnp.int32)

        def step(carry, i):
            f, curr_max = carry
            s = jnp.maximum(i - w, 0)
            j_ids = s + jnp.arange(w, dtype=jnp.int32)
            in_window = j_ids < i

            qb_j = jax.lax.dynamic_slice(qb_r, (s,), (w,))
            tb_j = jax.lax.dynamic_slice(tb_r, (s,), (w,))
            te_j = jax.lax.dynamic_slice(te_r, (s,), (w,))
            f_j = jax.lax.dynamic_slice(f, (s,), (w,))
            v_j = jax.lax.dynamic_slice(valid_r, (s,), (w,))

            qb_i, tb_i, te_i = qb_r[i], tb_r[i], te_r[i]
            mask = in_window & v_j & valid_r[i]

            bad = (qb_j >= qb_i) | (te_j >= te_i)
            ql = qb_i - qb_j
            tl = jnp.minimum(jnp.abs(tb_i - tb_j), jnp.abs(te_i - te_j))
            gap = jnp.abs(ql - tl)
            bad = bad | (gap > max_gap)
            gcost = gap_cost_scaled_i32(gap, seed_length)
            mlen = jnp.minimum(jnp.minimum(ql, tl), seed_length) * 1000

            prop = jnp.where(mask & ~bad, f_j + (mlen - gcost), NEGI)

            m = jnp.max(prop)
            j_star_rev = jnp.argmax(prop[::-1])
            j_star = s + (w - 1 - j_star_rev).astype(jnp.int32)

            improved = m > k_i
            f_i = jnp.where(improved, m, k_i)
            pred_i = jnp.where(improved, j_star, jnp.int32(-1))
            f = jax.lax.dynamic_update_slice(f, f_i[None], (i,))
            curr_max = jnp.maximum(curr_max, m)
            return (f, curr_max), pred_i

        (f_fin, curr_max), preds = jax.lax.scan(
            step, (f0, jnp.int32(0)), jnp.arange(1, A, dtype=jnp.int32),
            unroll=8,
        )
        preds = jnp.concatenate([jnp.full((1,), -1, jnp.int32), preds])
        return f_fin, preds, curr_max

    qb32 = qb_s.astype(jnp.int32)
    with jax.enable_x64(False):
        f, pred, curr_max = jax.vmap(one_read)(qb32, tb_s, te_s, valid_s)
    return ChainScores(
        order=order, qb=qb_s, tb=tb_s.astype(jnp.int64), te=te_s.astype(jnp.int64),
        valid=valid_s, f=f, pred=pred, curr_max=curr_max,
    )
