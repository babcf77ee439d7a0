"""Batched anti-diagonal Gotoh affine-gap DP in JAX.

The O(L^2) DP is swept along anti-diagonals so each step is a pure vector
operation over (batch, diagonal-offset) -- the reference's SIMD lanes
(``subgradient_solver_simd.hpp``) become a real batch dimension.  This is
the plain XLA path: it runs on the CPU and is the reference the GPU's CUDA
kernel (:mod:`lara_tpu.ops.gotoh_cuda`) must equal.  The score matrix is
pre-skewed
into diagonal-major layout once per call so the scan body does no gathers,
only shifts.

Semantics are identical to :mod:`lara_tpu.solver.oracle` (tested cell-for-
cell): recurrences and border handling follow ``PairwiseGotoh``
(``/root/reference/src/edge_filter.hpp:79-116``), gap convention is SeqAn's
(open includes the first gap character), traceback tie-breaking is the
documented lara-tpu policy (M > H > V at matches; extend-first in gaps).

Shapes: a batch of B problems padded to [LA, LB] with per-lane true lengths
``la, lb``; all shapes static under jit.  Values beyond (la, lb) are garbage
by design -- the DP only flows forward, so the captured cell (la, lb) is
exact (validated against the oracle).

Arithmetic is int32 (the reference's ScoreType); scores stay within +-1.8e9
for L up to ~20k as in the reference, so no wraparound occurs in the valid
region.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from lara_tpu.types import PSSM_INIT

NEG_INF = np.int32(-1431655764)  # np scalar: a jnp constant would init the backend at import
I32 = jnp.int32

# state codes
MAT, HOR, VER = 0, 1, 2


def skew_scores(scores: jax.Array, fill) -> jax.Array:
    """[B, LA, LB] cell scores -> diagonal-major [D+1, B, LA+1] where
    T[d, :, i] = scores[:, i-1, d-i-1... ] for matrix cell (i, j=d-i)."""
    b, la, lb = scores.shape
    num_diag = la + lb + 1
    d_idx = jnp.arange(num_diag, dtype=I32)[:, None]
    i_idx = jnp.arange(la + 1, dtype=I32)[None, :]
    j_idx = d_idx - i_idx
    valid = (i_idx >= 1) & (j_idx >= 1) & (j_idx <= lb)
    flat = jnp.clip((i_idx - 1) * lb + (j_idx - 1), 0, la * lb - 1)
    gathered = scores.reshape(b, la * lb)[:, flat]  # [B, D+1, LA+1]
    skewed = jnp.where(valid[None], gathered, I32(fill))
    return jnp.transpose(skewed, (1, 0, 2))


def _shift(x: jax.Array) -> jax.Array:
    """Shift +1 along the diagonal-offset axis (i-1 lookup)."""
    return jnp.concatenate([jnp.full_like(x[..., :1], NEG_INF), x[..., :-1]], axis=-1)


class DPResult(NamedTuple):
    final_m: jax.Array  # [B] value at (la, lb)
    final_h: jax.Array
    final_v: jax.Array
    aux: jax.Array      # dirs [D+1, B, LA+1] uint8  or  prefix [D+1, B, LA+1] int32


@functools.partial(jax.jit, static_argnames=("la_max", "emit"))
def gotoh_scan(skewed, la, lb, go, ge, la_max: int, emit: str = "dirs") -> DPResult:
    """Run the wavefront DP over pre-skewed scores.

    ``emit='dirs'``: auxiliary output is the packed traceback direction map
    (2 bits per M/H/V source).  ``emit='prefix'``: auxiliary output is
    max(M,H,V) per cell (diagonal-major), for the edge filter.
    """
    num_diag, b, width = skewed.shape
    assert width == la_max + 1
    go = I32(go)
    ge = I32(ge)
    la = la.astype(I32)
    lb = lb.astype(I32)
    i_idx = jnp.arange(width, dtype=I32)[None, :]  # [1, W]

    neg = jnp.full((b, width), NEG_INF, dtype=I32)
    init = (
        neg, neg, neg,  # d-1
        neg, neg, neg,  # d-2
        jnp.full((b,), NEG_INF, I32),
        jnp.full((b,), NEG_INF, I32),
        jnp.full((b,), NEG_INF, I32),
    )

    def border_gap(d):
        return jnp.where(d == 0, I32(0), go + ge * (d - 1))

    def step(carry, inputs):
        d, t_row = inputs  # d scalar, t_row [B, W]
        m1, h1, v1, m2, h2, v2, fm, fh, fv = carry

        # M from diagonal d-2 at i-1
        m2s, h2s, v2s = _shift(m2), _shift(h2), _shift(v2)
        best_prev = jnp.maximum(jnp.maximum(m2s, h2s), v2s)
        m_new = best_prev + t_row
        mdir = jnp.where(m2s == best_prev, MAT, jnp.where(h2s == best_prev, HOR, VER))

        # H from diagonal d-1 at same i (cell (i, j-1)); prefer extension
        hh, hm, hv = h1 + ge, m1 + go, v1 + go
        h_new = jnp.maximum(jnp.maximum(hh, hm), hv)
        hdir = jnp.where(hh == h_new, HOR, jnp.where(hm == h_new, MAT, VER))

        # V from diagonal d-1 at i-1 (cell (i-1, j)); prefer extension
        m1s, h1s, v1s = _shift(m1), _shift(h1), _shift(v1)
        vv, vm, vh = v1s + ge, m1s + go, h1s + go
        v_new = jnp.maximum(jnp.maximum(vv, vm), vh)
        vdir = jnp.where(vv == v_new, VER, jnp.where(vm == v_new, MAT, HOR))

        # border overrides: cell (0, d) and cell (d, 0)
        bg = border_gap(d)
        top = i_idx == 0
        left = i_idx == d
        m_new = jnp.where(top | left, bg, m_new)
        h_new = jnp.where(top, jnp.where(d == 0, NEG_INF, bg),
                          jnp.where(left, NEG_INF, h_new))
        v_new = jnp.where(left, jnp.where(d == 0, NEG_INF, bg),
                          jnp.where(top, NEG_INF, v_new))

        # capture the per-lane terminal cell (la, lb) on its diagonal
        at_end = (d == la + lb)[:, None]
        la_col = la[:, None]
        pick = jnp.take_along_axis
        fm = jnp.where(at_end[:, 0], pick(m_new, la_col, axis=1)[:, 0], fm)
        fh = jnp.where(at_end[:, 0], pick(h_new, la_col, axis=1)[:, 0], fh)
        fv = jnp.where(at_end[:, 0], pick(v_new, la_col, axis=1)[:, 0], fv)

        if emit == "dirs":
            aux = (mdir | (hdir << 2) | (vdir << 4)).astype(jnp.uint8)
        else:
            aux = jnp.maximum(jnp.maximum(m_new, h_new), v_new)

        new_carry = (m_new, h_new, v_new, m1, h1, v1, fm, fh, fv)
        return new_carry, aux

    ds = jnp.arange(num_diag, dtype=I32)
    carry, aux = jax.lax.scan(step, init, (ds, skewed))
    _, _, _, _, _, _, fm, fh, fv = carry
    return DPResult(fm, fh, fv, aux)


def unskew(diag_major: jax.Array, la_max: int, lb_max: int) -> jax.Array:
    """[D+1, B, LA+1] diagonal-major -> [B, LA+1, LB+1] rectangular."""
    num_diag, b, width = diag_major.shape
    x = jnp.transpose(diag_major, (1, 0, 2)).reshape(b, num_diag * width)
    i_idx = jnp.arange(la_max + 1)[:, None]
    j_idx = jnp.arange(lb_max + 1)[None, :]
    flat = (i_idx + j_idx) * width + i_idx  # [LA+1, LB+1]
    return x[:, flat.reshape(-1)].reshape(b, la_max + 1, lb_max + 1)


class Traceback(NamedTuple):
    upper: jax.Array      # [B] optimal score
    lines: jax.Array      # [B, LCAP, 2] matched (a, b) pairs, ascending
    n_lines: jax.Array    # [B]
    gap_score: jax.Array  # [B]
    partner: jax.Array    # [B, LA_MAX] dense line map: partner[a] = b or -1
    # sum of the seq scores over the matched cells, when the DP was handed
    # the seq-score grid (gotoh_cuda.align fills it; the XLA traceback
    # leaves it None)
    seq_part: jax.Array | None = None


@functools.partial(jax.jit, static_argnames=("la_max", "lb_max"))
def traceback(dirs, final_m, final_h, final_v, la, lb, go, ge,
              la_max: int, lb_max: int) -> Traceback:
    """Walk the packed direction map from (la, lb) back to (0, 0).

    Emits matched lines (ascending), the affine gap score of the alignment
    (``evaluateLines`` semantics, ``lagrange.hpp:147-221``), and the optimal
    score.  Batched: every lane walks its own path under a mask.
    """
    num_diag, b, width = dirs.shape
    lcap = min(la_max, lb_max)
    go = I32(go)
    ge = I32(ge)
    la = la.astype(I32)
    lb = lb.astype(I32)

    upper = jnp.maximum(jnp.maximum(final_m, final_h), final_v)
    state0 = jnp.where(final_m == upper, MAT, jnp.where(final_h == upper, HOR, VER)).astype(I32)

    dirs_flat = dirs.reshape(-1)
    lane = jnp.arange(b, dtype=I32)

    def cond(carry):
        i, j, _state, _cnt, _buf, _gap = carry
        return jnp.any((i > 0) | (j > 0))

    def body(carry):
        i, j, state, cnt, buf, gap = carry
        done = (i == 0) & (j == 0)
        # border forcing (oracle policy)
        state = jnp.where(i == 0, HOR, jnp.where(j == 0, VER, state))

        d = i + j
        code = dirs_flat[(d * b + lane) * width + i].astype(I32)
        mdir = code & 3
        hdir = (code >> 2) & 3
        vdir = (code >> 4) & 3
        pred = jnp.where(state == MAT, mdir, jnp.where(state == HOR, hdir, vdir))

        is_m = (state == MAT) & ~done
        pos = jnp.clip(lcap - 1 - cnt, 0, lcap - 1)
        line_val = jnp.stack([i - 1, j - 1], axis=-1)
        old = buf[lane, pos]
        buf = buf.at[lane, pos].set(jnp.where(is_m[:, None], line_val, old))
        cnt = cnt + is_m.astype(I32)

        gap_h = jnp.where(pred == HOR, ge, go)
        gap_v = jnp.where(pred == VER, ge, go)
        gap = gap + jnp.where(~done & (state == HOR), gap_h, 0) \
                  + jnp.where(~done & (state == VER), gap_v, 0)

        ni = jnp.where(state != HOR, i - 1, i)
        nj = jnp.where(state != VER, j - 1, j)
        i = jnp.where(done, i, ni)
        j = jnp.where(done, j, nj)
        state = jnp.where(done, state, pred)
        return i, j, state, cnt, buf, gap

    buf0 = jnp.zeros((b, lcap, 2), dtype=I32)
    init = (la, lb, state0, jnp.zeros((b,), I32), buf0, jnp.zeros((b,), I32))
    _i, _j, _s, cnt, buf, gap = jax.lax.while_loop(cond, body, init)

    # lines were written right-aligned in reverse order; shift left by lcap-cnt
    k_idx = jnp.arange(lcap, dtype=I32)[None, :]
    src = jnp.clip(k_idx + (lcap - cnt[:, None]), 0, lcap - 1)
    lines = jnp.take_along_axis(buf, src[:, :, None], axis=1)
    lines = jnp.where(k_idx[:, :, None] < cnt[:, None, None], lines, -1)
    # dense per-position line map (what the CUDA kernel emits natively)
    partner = jnp.full((b, la_max + 1), -1, I32).at[
        lane[:, None], jnp.where(lines[:, :, 0] >= 0, lines[:, :, 0], la_max)
    ].set(lines[:, :, 1])[:, :la_max]
    return Traceback(upper=upper, lines=lines, n_lines=cnt, gap_score=gap,
                     partner=partner)


@functools.partial(jax.jit, static_argnames=("la_max", "lb_max"))
def align_pssm_batch(pssm, la, lb, go, ge, la_max: int, lb_max: int) -> Traceback:
    """Batched equivalent of the per-iteration ``globalAlignment`` call
    (``subgradient_solver.hpp:223-225``) plus line/gap extraction."""
    skewed = skew_scores(pssm, PSSM_INIT)
    res = gotoh_scan(skewed, la, lb, go, ge, la_max, emit="dirs")
    return traceback(res.aux, res.final_m, res.final_h, res.final_v,
                     la, lb, go, ge, la_max, lb_max)


def seq_part_dense(partner, seq_scores, lb_max: int):
    """Sum of ``seq_scores`` ([B, LA, LB] or [B, LA*LB]) over the matched
    cells of a dense partner map -- the lower bound's sequence term
    (``lagrange.hpp:376-378``), which the CUDA kernel sums in its
    traceback."""
    b, la_max = partner.shape
    pmask = partner[:, :, None] == jnp.arange(lb_max, dtype=I32)[None, None, :]
    grid = jnp.asarray(seq_scores, I32).reshape(b, la_max, lb_max)
    return jnp.sum(jnp.where(pmask, grid, 0), axis=(1, 2))


def suffix_scan(sub_shifted, la, lb, go, ge, la_max: int):
    """Reverse wavefront: aggregate suffix-DP values in FORWARD skewed
    coordinates.

    ``sub_shifted[d', :, x] = sub(x, d'-x)`` (the forward skewed scores
    shifted by (+2 diagonals, +1 offset); NEG_INF where out of range).
    Returns ``S_agg[d', :, x] = max(M,H,V) of the best affine-gap global
    alignment of A[x:la] vs B[d'-x:lb]`` -- exactly the value the
    prefix-DP-of-reversed-sequences path produces at the double-flipped
    cell, but with no sequence reversal and no reversed-coordinate
    gather to consume it (the edge filter reads it with one STATIC
    shift).  Recurrences and border conventions mirror
    :func:`gotoh_scan` cell for cell, so values are bit-identical to
    the old ``unskew + flip-gather`` formulation (asserted in
    ``tests/test_gotoh_jax.py``).
    """
    num_diag, b, width = sub_shifted.shape
    assert width == la_max + 1
    go = I32(go)
    ge = I32(ge)
    la = la.astype(I32)
    lb = lb.astype(I32)
    x_idx = jnp.arange(width, dtype=I32)[None, :]  # [1, W]

    neg = jnp.full((b, width), NEG_INF, dtype=I32)
    init = (neg, neg, neg, neg, neg, neg)  # states at d'+1 then d'+2

    def shift_left(x):
        return jnp.concatenate(
            [x[:, 1:], jnp.full_like(x[:, :1], NEG_INF)], axis=1)

    def step(carry, inputs):
        dprime, t_row = inputs
        m1, h1, v1, m2, h2, v2 = carry

        # M: (x, y) matched, continue at (x+1, y+1) = diag d'+2, offset x+1
        m2s, h2s, v2s = shift_left(m2), shift_left(h2), shift_left(v2)
        best_next = jnp.maximum(jnp.maximum(m2s, h2s), v2s)
        m_new = best_next + t_row

        # H: B[y] gapped, continue at (x, y+1) = diag d'+1, same offset
        h_new = jnp.maximum(jnp.maximum(h1 + ge, m1 + go), v1 + go)

        # V: A[x] gapped, continue at (x+1, y) = diag d'+1, offset x+1
        m1s, h1s, v1s = shift_left(m1), shift_left(h1), shift_left(v1)
        v_new = jnp.maximum(jnp.maximum(v1s + ge, m1s + go), h1s + go)

        # borders: the mirrored images of gotoh_scan's top/left overrides
        # (reversed-prefix diagonal dd = la+lb-d'; x==la <-> reversed top,
        # y==lb <-> reversed left)
        dd = (la + lb)[:, None] - dprime                      # [B, 1]
        bg = jnp.where(dd == 0, I32(0), go + ge * (dd - 1))
        top = x_idx == la[:, None]
        left = x_idx == (dprime - lb)[:, None]
        m_new = jnp.where(top | left, bg, m_new)
        h_new = jnp.where(top, jnp.where(dd == 0, NEG_INF, bg),
                          jnp.where(left, NEG_INF, h_new))
        v_new = jnp.where(left, jnp.where(dd == 0, NEG_INF, bg),
                          jnp.where(top, NEG_INF, v_new))

        aux = jnp.maximum(jnp.maximum(m_new, h_new), v_new)
        return (m_new, h_new, v_new, m1, h1, v1), aux

    ds = jnp.arange(num_diag, dtype=I32)
    _, s_agg = jax.lax.scan(step, init, (ds, sub_shifted), reverse=True)
    return s_agg


def _shift_diag2(t):
    """``out[d, :, i] = t[d+2, :, i+1]`` with NEG_INF fill -- the static
    realignment between a cell (a, b2) at skewed index (a+b2, a) and its
    (a+1, b2+1) neighbour."""
    num_diag, b, width = t.shape
    out = jnp.full_like(t, NEG_INF)
    return out.at[: num_diag - 2, :, : width - 1].set(t[2:, :, 1:])


@functools.partial(jax.jit, static_argnames=("la_max", "lb_max"))
def edge_filter_skewed_words(seq_a, seq_b, la, lb, submat, go, ge, subopt,
                             la_max: int, lb_max: int):
    """Gather-free edge filter: one packed int32 download.

    Same semantics as :func:`edge_filter_batch`, but the whole
    prefix + substitution + suffix sum is evaluated in SKEWED coordinates
    (the forward aux, the shifted skewed scores, and the reverse
    :func:`suffix_scan` are all naturally aligned by static shifts), so
    the three dense gathers of the grid formulation -- two unskews and the
    per-lane double-flip suffix lookup, ~1.5 s at the 16S batch shape --
    disappear.  Returns ``[B, K+1]`` int32: K packed words of skewed
    active bits plus the per-lane optimum; the host rectangularises with
    :func:`unskew_active_words` (a free numpy strided view).
    """
    la = la.astype(I32)
    lb = lb.astype(I32)
    submat = submat.astype(I32)

    sub = _sub_grid(submat, seq_a, seq_b)
    skewed_f = skew_scores(sub, NEG_INF)
    res_f = gotoh_scan(skewed_f, la, lb, go, ge, la_max, emit="prefix")
    opt = jnp.maximum(jnp.maximum(res_f.final_m, res_f.final_h),
                      res_f.final_v)

    sub_shifted = _shift_diag2(skewed_f)   # sub(a, b2) at index (a+b2, a)
    s_agg = suffix_scan(sub_shifted, la, lb, go, ge, la_max)
    suf = _shift_diag2(s_agg)              # S(a+1, b2+1) at index (a+b2, a)

    num_diag, b, width = skewed_f.shape
    d_idx = jnp.arange(num_diag, dtype=I32)[:, None]
    a_idx = jnp.arange(width, dtype=I32)[None, :]
    b2_idx = d_idx - a_idx
    in_bounds = ((a_idx[None] < la[:, None, None])
                 & (b2_idx[None] >= 0)
                 & (b2_idx[None] < lb[:, None, None]))  # [B, D, W]
    total = res_f.aux + sub_shifted + suf               # [D, B, W]
    thresh = (opt - I32(subopt))[None, :, None]
    act = in_bounds & jnp.transpose(total >= thresh, (1, 0, 2))

    flat = act.reshape(b, -1)
    pad = (-flat.shape[1]) % 32
    if pad:
        flat = jnp.pad(flat, ((0, 0), (0, pad)))
    bits = flat.reshape(b, -1, 32).astype(jnp.uint32)
    words = jnp.sum(bits << jnp.arange(32, dtype=jnp.uint32)[None, None, :],
                    axis=2).astype(I32)
    return jnp.concatenate([words, opt[:, None].astype(I32)], axis=1)


def unskew_active_words(packed_np: np.ndarray, la_max: int, lb_max: int):
    """Host side of :func:`edge_filter_skewed_words`: unpack the skewed
    bit words and rectangularise via a numpy strided view (the unskew
    index map (a, b2) -> (a+b2)*W + a has constant strides (W+1, W), so
    no gather is needed anywhere).  Returns (active [B, LA, LB] bool,
    opt [B])."""
    b = packed_np.shape[0]
    width = la_max + 1
    num_diag = la_max + lb_max + 1
    # int32 words little-endian: byte view + unpackbits(bitorder='little')
    # reproduces the device's (value >> k) & 1 order without the [B, K, 32]
    # broadcast intermediate (which is GBs at 16S batch shapes)
    words = np.ascontiguousarray(packed_np[:, :-1]).view(np.uint8)
    flat = np.unpackbits(words, axis=1, bitorder="little").view(bool)
    flat = np.ascontiguousarray(flat[:, : num_diag * width])
    s0, s1 = flat.strides
    active = np.lib.stride_tricks.as_strided(
        flat, shape=(b, la_max, lb_max),
        strides=(s0, s1 * (width + 1), s1 * width)).copy()
    return active, packed_np[:, -1]


def _sub_grid(submat, sa, sb):
    """[B, LA, LB] substitution scores by exact one-hot matmul lookup
    (whether this beats the plain gather on the GPU is not measured).  f32
    products of int-valued operands < 2^24 are exact; HIGHEST precision
    keeps the matmul out of reduced-precision (TF32/bf16) arithmetic."""
    nk = submat.shape[0]
    ranks = jnp.arange(nk, dtype=I32)
    oh_a = (sa[:, :, None] == ranks).astype(jnp.float32)
    oh_b = (sb[:, :, None] == ranks).astype(jnp.float32)
    return jnp.einsum(
        "bif,fg,bjg->bij", oh_a, submat.astype(jnp.float32), oh_b,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    ).astype(I32)


@functools.partial(jax.jit, static_argnames=("la_max", "lb_max"))
def edge_filter_batch(seq_a, seq_b, la, lb, submat, go, ge, subopt,
                      la_max: int, lb_max: int):
    """Batched ``generateEdges`` (``edge_filter.hpp:131-158``).

    Returns (active [B, LA, LB] bool, opt [B] int32).  Forward and reversed
    DPs run over the substitution scores; an edge (a, b) survives iff
    prefix + s(a,b) + suffix >= opt - subopt.
    """
    b = seq_a.shape[0]
    la = la.astype(I32)
    lb = lb.astype(I32)
    submat = submat.astype(I32)

    def sub_grid(sa, sb):
        return _sub_grid(submat, sa, sb)

    sub = sub_grid(seq_a, seq_b)  # [B, LA, LB]

    # forward
    skewed_f = skew_scores(sub, NEG_INF)
    res_f = gotoh_scan(skewed_f, la, lb, go, ge, la_max, emit="prefix")
    fwd = unskew(res_f.aux, la_max, lb_max)  # [B, LA+1, LB+1]

    # reversed per-lane sequences (pad token N beyond the true length)
    def rev(seq, length, size):
        idx = jnp.clip(length[:, None] - 1 - jnp.arange(size)[None, :], 0, size - 1)
        vals = jnp.take_along_axis(seq, idx, axis=1)
        return jnp.where(jnp.arange(size)[None, :] < length[:, None], vals, 4)

    sub_r = sub_grid(rev(seq_a, la, la_max), rev(seq_b, lb, lb_max))
    skewed_b = skew_scores(sub_r, NEG_INF)
    res_b = gotoh_scan(skewed_b, la, lb, go, ge, la_max, emit="prefix")
    bwd = unskew(res_b.aux, la_max, lb_max)

    opt = jnp.maximum(jnp.maximum(res_f.final_m, res_f.final_h), res_f.final_v)

    # suffix(a, b) = bwd[la-1-a, lb-1-b]
    a_idx = jnp.arange(la_max, dtype=I32)[None, :, None]
    b_idx = jnp.arange(lb_max, dtype=I32)[None, None, :]
    ra = jnp.clip(la[:, None, None] - 1 - a_idx, 0, la_max)
    rb = jnp.clip(lb[:, None, None] - 1 - b_idx, 0, lb_max)
    bwd_flat = bwd.reshape(b, -1)
    suffix = jnp.take_along_axis(
        bwd_flat, (ra * (lb_max + 1) + rb).reshape(b, -1), axis=1
    ).reshape(b, la_max, lb_max)

    in_bounds = (a_idx < la[:, None, None]) & (b_idx < lb[:, None, None])
    total = fwd[:, :la_max, :lb_max] + sub + suffix
    active = in_bounds & (total >= (opt[:, None, None] - I32(subopt)))
    return active, opt
