"""The batched on-device subgradient solver.

One ``jax.lax.while_loop`` runs the *entire* Lagrangian loop for a batch of
pairwise problems: PSSM assembly (segmented run scan + one gather), the
wavefront alignment DP, subgradient extraction, greedy matching, bound
bookkeeping and dual updates.  Converged lanes freeze under masks; the loop
ends when every lane converged or exhausted its iterations -- the batched
replacement for the reference's OpenMP work stealing + SIMD lane masking
(``/root/reference/src/subgradient_solver.hpp:206-331``, ``_simd.hpp``).

Layout invariants (set up by :mod:`lara_tpu.solver.interactions` and the
driver): the dual table is edge-major -- entries sorted by (l, m), one
contiguous run per alignment edge, partner ids ascending within a run.
The iteration avoids dynamic row gathers and scatters where it can and
leans on compare-reduce streams, static-key sorts and batched matmuls
(whether each of these beats the plain gather on the GPU is not measured):

* per-edge queue top (max profit; ties -> smallest partner id == smallest
  entry index; ``lagrange.hpp:121,305-309``) = one segmented doubling scan
  capped at the true maximum run length (static ``scan_steps``),
* the dense PSSM grid = run-start values compacted by a static-key sort and
  placed by an exact one-hot matmul (five 7-bit limbs as int8 operands with
  int32 accumulation; every cell has at most one contributor, so each
  output cell is a single exact product),
* the DP + traceback = one CUDA kernel launch per iteration on the GPU
  (:mod:`lara_tpu.ops.gotoh_cuda`), the XLA wavefront scan elsewhere,
* line membership of an entry = fused compare-reduce against the <= LA line
  edge ids; all per-line state lives on dense position slots ([B, LA]):
  slot a is the line (a, partner[a]),
* per-line "consistent branch" state is derived at entry level from the
  unique run-top entry (at it, profits == run max and dual_m == partner),
* greedy matching runs as a ``lax`` rounds loop over statically
  queue-ordered candidate columns (:mod:`lara_tpu.solver.matching_device`).

Numeric parity notes:
* all profits int32; duals int32 with float32 step arithmetic and
  trunc-toward-zero writeback (``subgradient_solver.hpp:265-271``),
* step size = stepFactor * float(bestUpper - bestLower) / float(#subgradient
  entries); the entry count is 2 x (number of inconsistent directed picks),
* convergence is exact bound equality or iteration exhaustion
  (``subgradient_solver.hpp:286``); epsilon is unused, as in the reference,
* ``dual_at_queue`` snapshots the dual values the PSSM last reflected, which
  is what linear-mode output weights must read (the reference skips
  ``updateScores`` on the terminating iteration).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from lara_tpu.ops import gotoh_cuda
from lara_tpu.solver.matching_device import greedy_matching_queue
from lara_tpu.types import INFINITY, PSSM_INIT

I32 = jnp.int32
F32 = jnp.float32
NEG_INF = np.int32(-int(INFINITY))  # np scalar: a jnp constant would init the backend at import


class BatchModel(NamedTuple):
    """Static per-batch problem data (padded).

    Dual arrays are edge-major (sorted by (l, m): one contiguous run per
    alignment edge, partner ids ascending within the run); ``qrank`` is each
    entry's position in the static matching-queue order (see
    :mod:`lara_tpu.solver.interactions`).

    Invariant: every row of ``rev`` must be an involution of [0, D) --
    identity on padded/invalid entries -- because the solver applies it via
    a key sort (x[rev] == sort-by-rev for involutions).
    """

    seq_score: jax.Array   # [B, NE] int32 (flat la*lb grid padded to LA*LB)
    active: jax.Array      # [B, NE] bool
    dual_l: jax.Array      # [B, D] int32
    dual_m: jax.Array      # [B, D] int32
    sscore: jax.Array      # [B, D] int32
    rev: jax.Array         # [B, D] int32
    dvalid: jax.Array      # [B, D] bool
    qrank: jax.Array       # [B, D] int32
    la: jax.Array          # [B] int32
    lb: jax.Array          # [B] int32


def _shift_right(x: jax.Array, s: int, fill) -> jax.Array:
    return jnp.concatenate(
        [jnp.full((x.shape[0], s), fill, x.dtype), x[:, :-s]], axis=1)


def _shift_left(x: jax.Array, s: int, fill) -> jax.Array:
    return jnp.concatenate(
        [x[:, s:], jnp.full((x.shape[0], s), fill, x.dtype)], axis=1)


def _same_segment_masks(seg: jax.Array, steps: int):
    """Loop-invariant window masks for the segmented doubling scan: for each
    shift 2^k, whether the neighbour 2^k to the left/right is in the same
    edge run.  Hoisted out of the iteration loop (``seg`` is static)."""
    masks = []
    s = 1
    for _ in range(steps):
        masks.append((_shift_right(seg, s, -1) == seg,
                      _shift_left(seg, s, -1) == seg))
        s *= 2
    return masks


def _run_top(p, idx, same_masks, p_fill, idx_fill):
    """Segmented scan over edge-major runs with the queue-top monoid: max
    profit, ties broken by smallest entry index -- which equals smallest
    partner id, because partner ids ascend within a run.  Computes the
    reference's per-edge priority-queue *top* (``lagrange.hpp:121,305-309``)
    at every position of the run in ``len(same_masks)`` doubling passes
    (capped by the true max run length).  Returns (run max p, index of the
    top entry)."""

    def combine(p1, i1, p2, i2):
        take1 = (p1 > p2) | ((p1 == p2) & (i1 <= i2))
        return jnp.where(take1, p1, p2), jnp.where(take1, i1, i2)

    fp, fi = p, idx
    bp_, bi = p, idx
    s = 1
    for (same_r, same_l) in same_masks:
        fp, fi = combine(
            fp, fi,
            jnp.where(same_r, _shift_right(fp, s, p_fill), p_fill),
            jnp.where(same_r, _shift_right(fi, s, idx_fill), idx_fill))
        bp_, bi = combine(
            bp_, bi,
            jnp.where(same_l, _shift_left(bp_, s, p_fill), p_fill),
            jnp.where(same_l, _shift_left(bi, s, idx_fill), idx_fill))
        s *= 2
    return combine(fp, fi, bp_, bi)


class SolveConfig(NamedTuple):
    go: int
    ge: int
    num_iterations: int
    max_nondecr: int
    step_factor: float
    lookahead: int         # static: greedy matching lookahead


class BatchResult(NamedTuple):
    best_upper: jax.Array    # [B] int32
    best_lower: jax.Array    # [B] int32
    best_partner: jax.Array  # [B, LA_MAX] int32: partner[a] = b or -1
    best_nlines: jax.Array   # [B] int32
    best_matched: jax.Array  # [B, LA_MAX] bool (per position slot)
    dual_at_queue: jax.Array  # [B, D] int32
    iterations: jax.Array    # [B] int32


class _Carry(NamedTuple):
    dual: jax.Array
    dual_at_queue: jax.Array
    step_factor: jax.Array
    nondecr: jax.Array
    remaining: jax.Array
    lane_active: jax.Array
    best_lower: jax.Array
    best_upper: jax.Array
    best_score: jax.Array
    best_partner: jax.Array
    best_nlines: jax.Array
    best_matched: jax.Array
    iterations: jax.Array


def _init_carry(b: int, d: int, la_max: int, step_factor0,
                num_iterations: int) -> "_Carry":
    return _Carry(
        dual=jnp.zeros((b, d), I32),
        dual_at_queue=jnp.zeros((b, d), I32),
        step_factor=jnp.full((b,), step_factor0, F32),
        nondecr=jnp.zeros((b,), I32),
        remaining=jnp.full((b,), num_iterations, I32),
        lane_active=jnp.ones((b,), bool),
        best_lower=jnp.full((b,), NEG_INF, I32),
        best_upper=jnp.full((b,), -NEG_INF, I32),
        best_score=jnp.full((b,), NEG_INF, I32),
        best_partner=jnp.full((b, la_max), -1, I32),
        best_nlines=jnp.zeros((b,), I32),
        best_matched=jnp.zeros((b, la_max), bool),
        iterations=jnp.zeros((b,), I32),
    )


def _result_of(final: "_Carry") -> BatchResult:
    return BatchResult(
        best_upper=final.best_upper,
        best_lower=final.best_lower,
        best_partner=final.best_partner,
        best_nlines=final.best_nlines,
        best_matched=final.best_matched,
        dual_at_queue=final.dual_at_queue,
        iterations=final.iterations,
    )


def solve_batch(
    model: BatchModel,
    go,
    ge,
    step_factor0,
    la_max: int,
    lb_max: int,
    num_iterations: int,
    max_nondecr: int,
    lookahead: int,
    chunk: int = 125,
    scan_steps: int = 0,
    e_cap: int = 0,
) -> BatchResult:
    """Host-chunked fused solve: the device while_loop runs at most ``chunk``
    iterations per dispatch; the carry stays on device between dispatches,
    and converged batches stop at the next chunk boundary.  The chunk size
    and the late flag read below are not measured on the GPU.  LARA_CHUNK
    overrides the dispatch size for experiments."""
    import os

    chunk = int(os.environ.get("LARA_CHUNK", chunk))
    b, _ = model.seq_score.shape
    d = model.dual_l.shape[1]
    carry = _init_carry(b, d, la_max, step_factor0, num_iterations)
    total = 0
    pending_flag = None  # any-lane-active flag of the PREVIOUS chunk
    while total < num_iterations:
        carry = solve_batch_chunk(
            model, carry, go, ge, la_max, lb_max,
            min(chunk, num_iterations - total), max_nondecr, lookahead,
            scan_steps, e_cap,
        )
        total += chunk
        # read the flag one chunk late: the next dispatch is already queued
        # when the device->host sync happens, so the round trip overlaps
        # device compute instead of serialising every chunk
        if pending_flag is not None and not bool(pending_flag):
            break
        pending_flag = jnp.any(carry.lane_active) if total < num_iterations else None
    return _result_of(carry)


@functools.partial(
    jax.jit,
    static_argnames=("la_max", "lb_max", "max_steps", "max_nondecr",
                     "lookahead", "scan_steps", "e_cap"),
    donate_argnames=("carry",),
)
def solve_batch_chunk(
    model: BatchModel,
    carry: "_Carry",
    go,
    ge,
    la_max: int,
    lb_max: int,
    max_steps: int,
    max_nondecr: int,
    lookahead: int,
    scan_steps: int = 0,
    e_cap: int = 0,
) -> "_Carry":
    """Up to ``max_steps`` fused iterations; resumable.

    ``scan_steps``: number of doubling passes for the per-edge run scan;
    must satisfy 2**scan_steps >= the longest per-edge run in the batch.
    0 (default) = full depth ceil(log2(D)), always safe.
    ``e_cap``: static capacity for the compacted run-start array (>= the
    batch's max number of edges with dual entries) enabling the matmul grid
    placement; 0 = scatter placement.
    """
    b, ne = model.seq_score.shape
    d = model.dual_l.shape[1]
    go = I32(go)
    ge = I32(ge)
    full_depth = max(1, (d - 1).bit_length())
    steps = full_depth if scan_steps <= 0 else min(scan_steps, full_depth)

    lane = jnp.arange(b, dtype=I32)

    # ---- loop-invariant precomputation (hoisted out of the while body) ----
    same_masks = _same_segment_masks(model.dual_l, steps)
    iota_d = jnp.broadcast_to(jnp.arange(d, dtype=I32), (b, d))
    # run starts (static): first entry of each contiguous dual_l run
    prev_l = jnp.concatenate(
        [jnp.full((b, 1), -1, I32), model.dual_l[:, :-1]], axis=1)
    is_start = model.dvalid & (model.dual_l != prev_l)
    # scatter destination per entry: run starts write their grid cell, all
    # others aim out of bounds (dropped); unique within a lane by definition
    start_dst = jnp.where(is_start, model.dual_l, ne)
    if e_cap > 0:
        # matmul grid placement: compact the <= e_cap run starts to the
        # front (static sort key), then place values with an exact one-hot
        # matmul (each grid cell receives at most one contribution; values
        # are split into five 7-bit limbs as int8 operands with int32
        # accumulation -- see the placement in the loop body below)
        n_starts = jnp.sum(is_start, axis=1).astype(I32)
        start_rank = jnp.cumsum(is_start.astype(I32), axis=1) - 1
        compact_key = jnp.where(is_start, start_rank, d + iota_d)
        _, cells_sorted = jax.lax.sort(
            (compact_key, model.dual_l), dimension=1, num_keys=1)
        iota_e = jnp.arange(e_cap, dtype=I32)[None, :]
        cells = jnp.where(iota_e < n_starts[:, None],
                          cells_sorted[:, :e_cap], ne)       # [B, E]
        cell_a = cells // lb_max
        cell_b = cells - cell_a * lb_max
        cell_ok = cells < ne
        rowhot = ((cell_a[:, None, :] == jnp.arange(la_max, dtype=I32)[None, :, None])
                  & cell_ok[:, None, :]).astype(jnp.int8)     # [B, LA, E]
        colhot = ((cell_b[:, :, None] == jnp.arange(lb_max, dtype=I32)[None, None, :])
                  & cell_ok[:, :, None]).astype(jnp.int8)     # [B, E, LB]
    slot_base = (jnp.arange(la_max, dtype=I32) * lb_max)[None, :]  # [1, S]
    # matching queue, statically ordered once per dispatch (the queue key
    # never involves duals, matching.hpp:149-151): one sort by qrank gives
    # queue-ordered candidate columns; a second static sort compacts the
    # l < m half (each undirected interaction enters the queue once), so
    # the per-iteration matching runs at half width with no sort at all
    cand_base = (model.dvalid & (model.dual_l < model.dual_m)).astype(I32)
    _, lq_s, mq_s, wq_s, candq_base = jax.lax.sort(
        (model.qrank, model.dual_l, model.dual_m, 2 * model.sscore,
         cand_base), dimension=1, num_keys=1)
    cw = max(1, d // 2)
    ckey = jnp.where(candq_base != 0, iota_d, d + iota_d)
    _, lq_c, mq_c, wq_c = jax.lax.sort(
        (ckey, lq_s, mq_s, wq_s), dimension=1, num_keys=1)
    lq_c = lq_c[:, :cw]
    mq_c = mq_c[:, :cw]
    wq_c = wq_c[:, :cw]
    nc_base = jnp.sum(candq_base, axis=1).astype(I32)
    iota_cw = jnp.arange(cw, dtype=I32)[None, :]
    # rev applied as a single-array key sort: keys 2*rev[i] (unique) with the
    # pick bit riding in bit 0; sorted position j then holds pick[rev[j]]
    # (rev is an involution)
    rev_packed = model.rev * 2

    def body(state):
        steps_done, c = state
        act = c.lane_active
        dual_at_queue = jnp.where(act[:, None], c.dual, c.dual_at_queue)

        # ---- per-edge queue top: capped segmented doubling scan ----
        profits = model.sscore + c.dual
        masked = jnp.where(model.dvalid, profits, NEG_INF)
        run_p, run_idx = _run_top(masked, iota_d, same_masks, NEG_INF, I32(d))
        is_top = model.dvalid & (profits == run_p)

        # ---- PSSM grid: place max(run max, 0) of each edge at its cell
        # (run starts carry the full-run aggregate).  The uncovered-cell
        # default is 0, which is exactly what max(mpp, 0) collapses to ----
        bonus = jnp.maximum(run_p, 0)
        if e_cap > 0:
            # one static sort compacts start values; one batched matmul
            # places them.  Values split into five 7-bit limbs as int8
            # operands with exact int32 accumulation; every grid cell has
            # at most one contributor, so the sum per cell is a single
            # exact product
            _, vc = jax.lax.sort(
                (compact_key, bonus), dimension=1, num_keys=1)
            vc = vc[:, :e_cap]
            colval = jnp.concatenate(
                [colhot * ((vc >> s) & 0x7F).astype(jnp.int8)[:, :, None]
                 for s in (28, 21, 14, 7, 0)],
                axis=2)                                  # [B, E, 5*LB]
            out = jnp.matmul(rowhot, colval,
                             preferred_element_type=I32)  # [B, LA, 5*LB]
            placed = (out[:, :, :lb_max] << 28) \
                | (out[:, :, lb_max:2 * lb_max] << 21) \
                | (out[:, :, 2 * lb_max:3 * lb_max] << 14) \
                | (out[:, :, 3 * lb_max:4 * lb_max] << 7) \
                | out[:, :, 4 * lb_max:]
            placed = placed.reshape(b, ne)
        else:
            placed = jnp.maximum(
                jnp.full((b, ne), NEG_INF, I32).at[
                    lane[:, None], start_dst
                ].set(run_p, mode="drop", unique_indices=True), 0)
        pssm = jnp.where(
            model.active, model.seq_score + placed,
            I32(PSSM_INIT)).reshape(b, la_max, lb_max)

        # ---- relaxed problem: wavefront DP + traceback, which also sums
        # the sequence scores of the matched cells (the lower bound's
        # sequence term, lagrange.hpp:376-378) ----
        with jax.named_scope("dp_traceback"):
            tb = gotoh_cuda.align(pssm, model.la, model.lb, go, ge, la_max,
                                  lb_max, seq_scores=model.seq_score)
        upper = tb.upper
        partner = tb.partner                                  # [B, S]
        seq_part = tb.seq_part

        # ---- current solution on dense position slots ----
        slot_valid = partner >= 0
        slot_edge = jnp.where(slot_valid, slot_base + partner, ne)  # [B, S]

        # ---- line membership per entry: fused compare-reduce against the
        # <= S line edge ids.  Edge-major l_in feeds the subgradients; the
        # queue-ordered copies feed the matching candidate mask directly
        # (no reordering) ----
        l_in = jnp.any(
            model.dual_l[:, :, None] == slot_edge[:, None, :], axis=2)
        l_in_q = jnp.any(
            lq_c[:, :, None] == slot_edge[:, None, :], axis=2)
        m_in_q = jnp.any(
            mq_c[:, :, None] == slot_edge[:, None, :], axis=2)

        # ---- subgradients (lagrange.hpp:343-374) ----
        # cycle(i) = pick(rev(i)) by symmetry.  rev is an involution, so
        # x[rev] == sort(x by key rev)
        pick = l_in & (run_p >= 0) & is_top
        pick_rev = (jax.lax.sort(rev_packed | pick.astype(I32), dimension=1)
                    & 1) == 1
        sg_pos = pick & ~pick_rev
        sg = sg_pos.astype(I32) - (pick_rev & ~pick).astype(I32)
        count = 2 * jnp.sum(sg_pos, axis=1).astype(I32)
        any_sg = count > 0

        # ---- consistent branch (lagrange.hpp:397-409): entry-level ----
        # the UNIQUE top entry of a run (index == run_idx: ties in profit
        # break to the smallest partner, matching the queue order) carries
        # everything the per-line state needs: at that entry, profits ==
        # per-edge max and dual_m == the chosen partner.  top-is-self =
        # the self queue entry (profit 0, partner == own id) outranks it.
        is_top_exact = model.dvalid & (iota_d == run_idx)
        tis_entry = (profits < 0) | ((profits == 0)
                                     & (model.dual_l < model.dual_m))
        contrib = is_top_exact & l_in & ~tis_entry
        consistent_sum = jnp.sum(jnp.where(contrib, model.sscore, 0), axis=1)

        # a line slot is matched in the consistent case iff its own top
        # contributes, or some contributing line chose it as partner
        matched_cons_slot = slot_valid & jnp.any(
            contrib[:, :, None]
            & ((model.dual_l[:, :, None] == slot_edge[:, None, :])
               | (model.dual_m[:, :, None] == slot_edge[:, None, :])),
            axis=1)

        # ---- matching branch (lagrange.hpp:380-395) ----
        cand_q = (iota_cw < nc_base[:, None]) & l_in_q & m_in_q \
            & any_sg[:, None] & act[:, None]
        with jax.named_scope("greedy_matching"):
            match_res = greedy_matching_queue(
                lq_c, mq_c, wq_c, cand_q, slot_edge, lookahead,
            )
        struct_part = jnp.where(any_sg, match_res.score, consistent_sum)

        lower = seq_part + struct_part + tb.gap_score

        # ---- best primal tracking (lagrange.hpp:416-421) ----
        better = act & (lower > c.best_score)
        slot_matched = jnp.where(
            any_sg[:, None], match_res.used_slot, matched_cons_slot
        ) & slot_valid
        best_score = jnp.where(better, lower, c.best_score)
        best_partner = jnp.where(better[:, None], partner, c.best_partner)
        best_nlines = jnp.where(better, tb.n_lines, c.best_nlines)
        best_matched = jnp.where(better[:, None], slot_matched, c.best_matched)

        # ---- bound bookkeeping (subgradient_solver.hpp:247-263) ----
        improved_u = act & (upper < c.best_upper)
        improved_l = act & (lower > c.best_lower)
        best_upper = jnp.where(improved_u, upper, c.best_upper)
        best_lower = jnp.where(improved_l, lower, c.best_lower)
        nondecr = jnp.where(improved_u | improved_l, 0, c.nondecr)
        halve = act & (nondecr >= max_nondecr)
        step_factor = jnp.where(halve, c.step_factor / F32(2.0), c.step_factor)
        nondecr = jnp.where(act, jnp.where(halve, 0, nondecr + 1), c.nondecr)

        # ---- dual update (subgradient_solver.hpp:265-271) ----
        step = step_factor * (best_upper - best_lower).astype(F32) / \
            jnp.maximum(count, 1).astype(F32)
        upd = act[:, None] & (sg != 0)
        new_dual = (c.dual.astype(F32) - step[:, None] * sg.astype(F32)).astype(I32)
        dual = jnp.where(upd, new_dual, c.dual)

        remaining = jnp.where(act, c.remaining - 1, c.remaining)
        done_now = act & ((best_upper == best_lower) | (remaining == 0))

        return steps_done + 1, _Carry(
            dual=dual,
            dual_at_queue=dual_at_queue,
            step_factor=step_factor,
            nondecr=nondecr,
            remaining=remaining,
            lane_active=act & ~done_now,
            best_lower=best_lower,
            best_upper=best_upper,
            best_score=best_score,
            best_partner=best_partner,
            best_nlines=best_nlines,
            best_matched=best_matched,
            iterations=c.iterations + act.astype(I32),
        )

    def cond(state):
        steps_done, c = state
        return (steps_done < max_steps) & jnp.any(c.lane_active)

    _, final = jax.lax.while_loop(cond, body, (I32(0), carry))
    return final


@functools.partial(jax.jit, donate_argnames=("model", "carry"))
def splice_lanes(
    model: BatchModel,
    carry: "_Carry",
    lane_idx,
    rows: BatchModel,
    step_factor0,
    num_iterations,
):
    """Replace ``len(lane_idx)`` lanes of a live (model, carry) with fresh
    pairs and reset their solver state -- the chunk-boundary work-refill
    that mirrors the reference's shared-iterator steal
    (``subgradient_solver.hpp:286-325``): a converged SIMD lane is reloaded
    with the next pair instead of idling to the batch's end.

    ``lane_idx`` is a fixed-width int32 vector (one compiled program per
    refill width); unused slots point out of range and are dropped.
    """
    new_model = BatchModel(*[
        arr.at[lane_idx].set(r, mode="drop")
        for arr, r in zip(model, rows)
    ])
    d = model.dual_l.shape[1]
    k = lane_idx.shape[0]
    la_cols = carry.best_partner.shape[1]
    fresh = _Carry(
        dual=jnp.zeros((k, d), I32),
        dual_at_queue=jnp.zeros((k, d), I32),
        step_factor=jnp.full((k,), step_factor0, F32),
        nondecr=jnp.zeros((k,), I32),
        remaining=jnp.full((k,), num_iterations, I32),
        lane_active=jnp.ones((k,), bool),
        best_lower=jnp.full((k,), NEG_INF, I32),
        best_upper=jnp.full((k,), -NEG_INF, I32),
        best_score=jnp.full((k,), NEG_INF, I32),
        best_partner=jnp.full((k, la_cols), -1, I32),
        best_nlines=jnp.zeros((k,), I32),
        best_matched=jnp.zeros((k, la_cols), bool),
        iterations=jnp.zeros((k,), I32),
    )
    new_carry = _Carry(*[
        arr.at[lane_idx].set(r, mode="drop")
        for arr, r in zip(carry, fresh)
    ])
    return new_model, new_carry


def solve_batch_traced(
    model: BatchModel,
    go,
    ge,
    step_factor0,
    la_max: int,
    lb_max: int,
    num_iterations: int,
    max_nondecr: int,
    lookahead: int,
    scan_steps: int = 0,
    e_cap: int = 0,
) -> BatchResult:
    """Fully-traced one-shot solve (for shard_map: the whole loop must live
    inside one traced program; per-device dispatches are short because each
    shard is small)."""
    b, _ = model.seq_score.shape
    d = model.dual_l.shape[1]
    carry = _init_carry(b, d, la_max, step_factor0, num_iterations)
    final = solve_batch_chunk.__wrapped__(
        model, carry, go, ge, la_max, lb_max, num_iterations, max_nondecr,
        lookahead, scan_steps, e_cap,
    )
    return _result_of(final)
