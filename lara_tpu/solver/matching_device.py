"""Greedy lookahead matching on device (JAX), bit-equal to the reference.

Re-implements ``computeGreedyMatching`` + ``solveConflicts``
(``/root/reference/src/matching.hpp:99-192``) as vectorized JAX control flow
so the whole subgradient loop can stay inside one ``lax.while_loop`` on the
device:

* the sorted interaction queue becomes a 3-key ``lax.sort`` (weight desc,
  lineL asc, lineR asc -- the ``std::set<Interaction>`` order),
* the monotone queue scan with lookahead selection becomes a while_loop with
  per-lane pointers (one queue entry per step; total steps bounded by the
  true per-lane candidate count, not the padded size),
* ``solveConflicts`` -- a recursive branch-and-prune search -- is evaluated
  by memoized subset enumeration (:func:`_solve_conflicts_enum`): every
  recursion state is a pure function of the remaining-conflict mask, which
  is always ``full & ~OR(touch[e] for e in eliminated)``, so the <= 2^lh
  distinct states are filled bottom-up (popcount-descending) in one static
  unrolled pass of [B]-vector ops -- no data-dependent control flow at all.
  Fuzzing showed no simple tie-break rule reproduces the recursion on exact
  weight ties (~0.2% of resolutions), so the recursion's exact branch
  structure is replayed per state.

All lanes of the batch run their own state machine under masks; lanes without
work finish immediately.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np

import jax
import jax.numpy as jnp

I32 = jnp.int32
# All weights fit int32 (2*structScore <= ~2^27; sums bounded by
# lines * 2^18 in practice, like the reference's int32 ScoreType).
I64 = jnp.int32


def _conflict_tables(lh: int) -> Tuple[np.ndarray, np.ndarray]:
    """Static pair enumeration in reference order: (0,1),(0,2),..,(1,2),..."""
    cx, cy = [], []
    for x in range(lh):
        for y in range(x + 1, lh):
            cx.append(x)
            cy.append(y)
    return np.asarray(cx, np.int32), np.asarray(cy, np.int32)


def _solve_conflicts_enum(sel_l, sel_m, sel_w, sel_cnt, engaged, lh: int):
    """Vectorized ``solveConflicts`` via memoized subset enumeration.

    Inputs: selection slots [B, LH] (line ids l < m, weights w = 2*score) and
    per-lane live counts; ``engaged`` masks lanes that resolve this round.
    Returns ``elim`` [B, LH]-bit mask of eliminated slots.

    The recursion (``matching.hpp:99-141``) branches on the first remaining
    conflict, preferring to eliminate edgeS (the tuple-greater = lighter
    interaction; since the selection is in queue order, the higher slot
    index), exploring the edgeL branch only when the S branch is strictly
    heavier, with the equal-subtree prune.  Every recursive call's conflict
    list is the original list filtered by the eliminated-slot set E, so
    ``solve(mask(E))`` is memoized over the 2^lh subsets E, evaluated
    popcount-descending; each state is straight-line vector math over [B]
    (gathers into the [B, 2^lh] memo), replacing the former per-lane stack
    machine whose nested while_loop dominated the solver iteration.
    """
    b = sel_l.shape[0]
    n_conf = lh * (lh - 1) // 2
    if n_conf == 0:  # lookahead 1: a single selected edge never conflicts
        return jnp.zeros((b,), I32)
    cx_np, cy_np = _conflict_tables(lh)
    cx = jnp.asarray(cx_np)
    cy = jnp.asarray(cy_np)

    live = jnp.arange(lh, dtype=I32)[None, :] < sel_cnt[:, None]  # [B, LH]

    # conflict c active iff both slots live and they share a line endpoint
    def share(a_idx, b_idx):
        la_ = jnp.take_along_axis(sel_l, a_idx[None, :].repeat(b, 0), axis=1)
        ma_ = jnp.take_along_axis(sel_m, a_idx[None, :].repeat(b, 0), axis=1)
        lb_ = jnp.take_along_axis(sel_l, b_idx[None, :].repeat(b, 0), axis=1)
        mb_ = jnp.take_along_axis(sel_m, b_idx[None, :].repeat(b, 0), axis=1)
        return (la_ == lb_) | (la_ == mb_) | (ma_ == lb_) | (ma_ == mb_)

    both_live = jnp.take_along_axis(live, cx[None, :].repeat(b, 0), axis=1) & \
        jnp.take_along_axis(live, cy[None, :].repeat(b, 0), axis=1)
    conf_active = both_live & share(cx, cy)  # [B, C]

    conf_bits = jnp.left_shift(jnp.ones((), I32), jnp.arange(n_conf, dtype=I32))[None, :]
    full_mask = jnp.sum(jnp.where(conf_active, conf_bits, 0), axis=1).astype(I32)

    # touch[e] = bitmask of active conflicts involving slot e
    slot_ids = jnp.arange(lh, dtype=I32)[None, :, None]  # [1, LH, C]
    involves = (cx[None, None, :] == slot_ids) | (cy[None, None, :] == slot_ids)
    touch = jnp.sum(
        jnp.where(involves & conf_active[:, None, :], conf_bits[:, None, :], 0), axis=2
    ).astype(I32)  # [B, LH]

    n_sub = 1 << lh

    # remaining-conflict mask per elimination subset E:
    # mask(E) = full & ~OR(touch[e] for e in E), built by lowest-bit recursion
    mask_cols = [full_mask]
    for e_set in range(1, n_sub):
        low = (e_set & -e_set).bit_length() - 1
        mask_cols.append(mask_cols[e_set & (e_set - 1)] & ~touch[:, low])
    mask_e = jnp.stack(mask_cols, axis=1)  # [B, 2^lh]

    def lowest_bit_index(mask):
        # index of least-significant set bit (mask != 0); n_conf < 2^24 so
        # the float32 log2 is exact
        return jnp.int32(jnp.round(jnp.log2(jnp.float32(mask & -mask) + (mask == 0))))

    # first conflict per state and its S/L slots (S = higher slot: selection
    # is in queue order, so the higher slot is the tuple-greater = lighter)
    c0 = lowest_bit_index(mask_e)  # [B, 2^lh]
    c0c = jnp.clip(c0, 0, n_conf - 1)
    s_slot = cy[c0c]  # cy > cx by construction
    l_slot = cx[c0c]
    w_s = jnp.take_along_axis(sel_w, s_slot, axis=1).astype(I64)
    w_l = jnp.take_along_axis(sel_w, l_slot, axis=1).astype(I64)
    empty = mask_e == 0
    single = ~empty & ((mask_e & (mask_e - 1)) == 0)
    s_bit = jnp.left_shift(jnp.ones((), I32), s_slot)
    l_bit = jnp.left_shift(jnp.ones((), I32), l_slot)
    sub_s_idx = jnp.arange(n_sub, dtype=I32)[None, :] | s_bit
    sub_l_idx = jnp.arange(n_sub, dtype=I32)[None, :] | l_bit
    mask_after_s = jnp.take_along_axis(mask_e, sub_s_idx, axis=1)
    mask_after_l = jnp.take_along_axis(mask_e, sub_l_idx, axis=1)

    # memo over subsets, filled popcount-descending (supersets first); all
    # subsets of one popcount level are independent, so each level is one
    # vectorized slab: 4 gathers into the memo + fused elementwise math
    res_w = jnp.zeros((b, n_sub), I64)
    res_elim = jnp.zeros((b, n_sub), I32)
    by_level: dict = {}
    for e_set in range(n_sub - 1):  # full set: mask empty, memo already 0
        by_level.setdefault(bin(e_set).count("1"), []).append(e_set)
    for level in sorted(by_level, reverse=True):
        cols = np.asarray(by_level[level], np.int32)  # static
        sub_s = jnp.take_along_axis(res_w, sub_s_idx[:, cols], axis=1)
        sub_s_elim = jnp.take_along_axis(res_elim, sub_s_idx[:, cols], axis=1)
        sub_l = jnp.take_along_axis(res_w, sub_l_idx[:, cols], axis=1)
        sub_l_elim = jnp.take_along_axis(res_elim, sub_l_idx[:, cols], axis=1)
        weight_s = w_s[:, cols] + sub_s
        weight_l = w_l[:, cols] + sub_l
        # explore the L branch only when the S branch is strictly heavier and
        # the two filtered conflict lists differ (matching.hpp:121-133)
        explore = (weight_s > w_l[:, cols]) & \
            (mask_after_s[:, cols] != mask_after_l[:, cols])
        l_wins = explore & (weight_s > weight_l)
        val_w = jnp.where(
            empty[:, cols], I64(0),
            jnp.where(single[:, cols], w_s[:, cols],
                      jnp.where(l_wins, weight_l, weight_s)))
        val_elim = jnp.where(
            empty[:, cols], 0,
            jnp.where(single[:, cols], s_bit[:, cols],
                      jnp.where(l_wins, sub_l_elim | l_bit[:, cols],
                                sub_s_elim | s_bit[:, cols])))
        res_w = res_w.at[:, cols].set(val_w)
        res_elim = res_elim.at[:, cols].set(val_elim)

    return jnp.where(engaged, res_elim[:, 0], 0)  # [B] slot bitmask


class RoundsResult(NamedTuple):
    score: jax.Array      # [B] int32: sum of accepted 2*score weights
    used_slot: jax.Array  # [B, LCAP] bool: line slot is matched


def _rounds_loop(lq, mq, wq, live, line_edges, n_cand, lookahead: int,
                 width: int) -> RoundsResult:
    """Round loop over queue-ordered compacted columns (position == rank).

    Columns are in queue order, so the "next ``lh`` unblocked entries" are
    the first ``lh`` live columns at index >= the scan pointer -- extracted
    with one cumsum + one-hot masked sums instead of chained min-reductions.
    Matched state is tracked per line slot with value compares; the round
    body touches no gather/scatter at all.
    """
    b, _ = lq.shape
    lh = max(1, min(int(lookahead), 8))
    lh_lane = jnp.minimum(I32(lh), n_cand)  # matching.hpp:153-156
    k_idx = jnp.arange(lh, dtype=I32)[None, :]
    idx = jnp.arange(width, dtype=I32)[None, :]

    class _St(NamedTuple):
        ptr: jax.Array      # [B] scan pointer in compact rank space
        blocked: jax.Array  # [B, W] column dead (not live / endpoint matched)
        score: jax.Array    # [B] i32

    state = _St(
        ptr=jnp.zeros((b,), I32),
        blocked=~live,
        score=jnp.zeros((b,), I32),
    )

    def cond(s):
        st, _used = s
        return jnp.any(st.ptr < width)

    def body(s):
        st, used = s
        engaged = st.ptr < width
        ok = ~st.blocked & (idx >= st.ptr[:, None])
        srank = jnp.cumsum(ok.astype(I32), axis=1)
        navail = srank[:, -1]

        sel_l_ks, sel_m_ks, sel_w_ks, rank_ks = [], [], [], []
        for k in range(lh):
            onehot = ok & (srank == k + 1)
            sel_l_ks.append(jnp.sum(jnp.where(onehot, lq, 0), axis=1))
            sel_m_ks.append(jnp.sum(jnp.where(onehot, mq, 0), axis=1))
            sel_w_ks.append(jnp.sum(jnp.where(onehot, wq, 0), axis=1))
            rank_ks.append(jnp.where(
                navail > k, jnp.sum(jnp.where(onehot, idx, 0), axis=1),
                width))
        sel_l = jnp.stack(sel_l_ks, axis=1)  # [B, LH]
        sel_m = jnp.stack(sel_m_ks, axis=1)
        sel_w = jnp.stack(sel_w_ks, axis=1)
        sel_rank = jnp.stack(rank_ks, axis=1)
        valid_k = (sel_rank < width) & (k_idx < lh_lane[:, None])
        sel_cnt = jnp.sum(valid_k, axis=1).astype(I32)
        any_sel = sel_cnt > 0
        sel_l = jnp.where(valid_k, sel_l, 0)
        sel_m = jnp.where(valid_k, sel_m, 0)
        sel_w = jnp.where(valid_k, sel_w, 0)

        elim_mask = _solve_conflicts_enum(
            sel_l, sel_m, sel_w, sel_cnt, engaged & any_sel, lh)
        kept = (engaged & any_sel)[:, None] & valid_k & \
            (((elim_mask[:, None] >> k_idx) & 1) == 0)

        score = st.score + jnp.sum(jnp.where(kept, sel_w, 0), axis=1)

        # newly matched endpoints: block sharing columns and mark the line
        # slots they touch -- value compares only, no scatter
        blocked = st.blocked
        for k in range(lh):
            lk = sel_l[:, k : k + 1]
            mk = sel_m[:, k : k + 1]
            hit = (lq == lk) | (lq == mk) | (mq == lk) | (mq == mk)
            blocked = blocked | (kept[:, k : k + 1] & hit)
            used = used | (kept[:, k : k + 1]
                           & ((line_edges == lk) | (line_edges == mk)))

        sel_end = jnp.max(jnp.where(valid_k, sel_rank, -1), axis=1)
        full_sel = any_sel & (sel_cnt >= lh_lane)
        new_ptr = jnp.where(full_sel, sel_end + 1, width)
        ptr = jnp.where(engaged, new_ptr, st.ptr)
        return _St(ptr=ptr, blocked=blocked, score=score), used

    used0 = jnp.zeros(line_edges.shape, bool)
    (final, used_slot) = jax.lax.while_loop(cond, body, (state, used0))
    return RoundsResult(score=final.score, used_slot=used_slot)


@functools.partial(jax.jit, static_argnames=("lookahead",))
def greedy_matching_queue(lq, mq, wq, live, line_edges,
                          lookahead: int) -> RoundsResult:
    """Greedy lookahead matching over statically queue-ordered columns.

    The caller pre-sorts the dual table by the static queue rank once per
    batch (the queue key never involves duals, ``matching.hpp:149-151``), so
    the per-iteration candidate set arrives as a ``live`` mask over the
    queue-ordered columns -- no per-iteration sort or compaction at all.
    """
    b, d = lq.shape
    n_cand = jnp.sum(live, axis=1).astype(I32)
    return _rounds_loop(lq, mq, wq, live, line_edges, n_cand, lookahead, d)
