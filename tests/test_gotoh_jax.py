"""Batched JAX wavefront DP vs. the NumPy oracle (bit-exact, incl. ties)."""

import numpy as np
import pytest

from lara_tpu.ops import gotoh
from lara_tpu.solver import oracle
from lara_tpu.types import PSSM_INIT

GO = -6 * 8192
GE = -2 * 8192


def random_pssm(rng, la, lb, la_max, lb_max, tie_prone=False):
    full = np.full((la_max, lb_max), int(PSSM_INIT), dtype=np.int32)
    if tie_prone:
        # coarse values force frequent ties to exercise the tie policy
        vals = rng.integers(-4, 5, (la, lb)).astype(np.int64) * GE
    else:
        vals = rng.integers(-60000, 60000, (la, lb))
    # sprinkle inactive cells
    mask = rng.random((la, lb)) < 0.2
    vals = np.where(mask, int(PSSM_INIT), vals)
    full[:la, :lb] = vals
    return full


@pytest.mark.parametrize("tie_prone", [False, True])
def test_align_pssm_batch_matches_oracle(tie_prone):
    rng = np.random.default_rng(42 if tie_prone else 7)
    la_max, lb_max = 24, 20
    batch = 9
    las = rng.integers(1, la_max + 1, batch)
    lbs = rng.integers(1, lb_max + 1, batch)
    pssms = np.stack(
        [random_pssm(rng, las[k], lbs[k], la_max, lb_max, tie_prone) for k in range(batch)]
    )

    out = gotoh.align_pssm_batch(
        pssms, np.asarray(las), np.asarray(lbs), GO, GE, la_max, lb_max
    )
    for k in range(batch):
        score, lines, gaps_a, gaps_b = oracle.align_pssm(
            pssms[k][: las[k], : lbs[k]].astype(np.int64), GO, GE
        )
        gap_score = oracle.evaluate_lines(gaps_a, gaps_b, GO, GE)
        assert int(out.upper[k]) == score, f"lane {k} score"
        n = int(out.n_lines[k])
        got_lines = [tuple(x) for x in np.asarray(out.lines[k][:n])]
        assert got_lines == lines, f"lane {k} lines"
        assert int(out.gap_score[k]) == gap_score, f"lane {k} gap score"


def test_edge_filter_batch_matches_oracle():
    rng = np.random.default_rng(3)
    from lara_tpu.scoring.ribosum import ribosum65n_fixed

    submat = ribosum65n_fixed()
    la_max, lb_max = 18, 15
    batch = 6
    las = rng.integers(2, la_max + 1, batch)
    lbs = rng.integers(2, lb_max + 1, batch)
    # enforce la >= lb like the driver does
    for k in range(batch):
        if las[k] < lbs[k]:
            las[k], lbs[k] = lbs[k], las[k]
    lbs = np.minimum(lbs, lb_max)
    seq_a = rng.integers(0, 5, (batch, la_max))
    seq_b = rng.integers(0, 5, (batch, lb_max))
    subopt = 5 * 8192

    active, opt = gotoh.edge_filter_batch(
        seq_a, seq_b, np.asarray(las), np.asarray(lbs), submat, GO, GE, subopt,
        la_max, lb_max,
    )
    for k in range(batch):
        want_active, want_opt = oracle.generate_edges(
            seq_a[k][: las[k]], seq_b[k][: lbs[k]], submat.astype(np.int64),
            GO, GE, subopt,
        )
        assert int(opt[k]) == want_opt
        got = np.asarray(active[k][: las[k], : lbs[k]])
        np.testing.assert_array_equal(got, want_active)
        # padding region fully inactive
        assert not np.asarray(active[k])[las[k]:, :].any()
        assert not np.asarray(active[k])[:, lbs[k]:].any()


def test_single_cell_and_degenerate_shapes():
    pssm = np.full((1, 4, 4), int(PSSM_INIT), dtype=np.int32)
    pssm[0, 0, 0] = 100
    out = gotoh.align_pssm_batch(pssm, np.array([1]), np.array([1]), GO, GE, 4, 4)
    assert int(out.upper[0]) == 100
    assert int(out.n_lines[0]) == 1
    assert tuple(np.asarray(out.lines[0][0])) == (0, 0)
    assert int(out.gap_score[0]) == 0

    # 1 x n: either match + gaps or all gaps
    pssm2 = np.full((1, 4, 4), int(PSSM_INIT), dtype=np.int32)
    pssm2[0, 0, :] = [-100, 50, -100, -100]
    out2 = gotoh.align_pssm_batch(pssm2, np.array([1]), np.array([4]), GO, GE, 4, 4)
    score, lines, ga, gb = oracle.align_pssm(pssm2[0, :1, :4].astype(np.int64), GO, GE)
    assert int(out2.upper[0]) == score
    n = int(out2.n_lines[0])
    assert [tuple(x) for x in np.asarray(out2.lines[0][:n])] == lines


def test_edge_filter_skewed_words_matches_grid_path():
    """The gather-free skewed-space edge filter (one packed download +
    host strided-view unskew) is bit-identical to the grid formulation,
    including uneven per-lane lengths."""
    import numpy as np
    from lara_tpu.params import Parameters
    from lara_tpu.types import f2i

    rng = np.random.default_rng(23)
    params = Parameters(in_file="x")
    submat = np.asarray(params.score_matrix)
    go, ge = int(params.gap_open_int), int(params.gap_extend_int)
    subopt = int(f2i(40.0))
    for _ in range(4):
        b = int(rng.integers(1, 6))
        la_max = int(rng.integers(8, 40))
        lb_max = int(rng.integers(8, 40))
        seq_a = rng.integers(0, 4, (b, la_max)).astype(np.int32)
        seq_b = rng.integers(0, 4, (b, lb_max)).astype(np.int32)
        la = rng.integers(4, la_max + 1, b).astype(np.int32)
        lb = rng.integers(4, lb_max + 1, b).astype(np.int32)
        for k in range(b):
            seq_a[k, la[k]:] = 4
            seq_b[k, lb[k]:] = 4
        act_old, opt_old = gotoh.edge_filter_batch(
            seq_a, seq_b, la, lb, submat, go, ge, subopt, la_max, lb_max)
        packed = np.asarray(gotoh.edge_filter_skewed_words(
            seq_a, seq_b, la, lb, submat, go, ge, subopt, la_max, lb_max))
        act_new, opt_new = gotoh.unskew_active_words(packed, la_max, lb_max)
        assert np.array_equal(np.asarray(act_old), act_new)
        assert np.array_equal(np.asarray(opt_old), opt_new)
        # the reference's forward/backward-optimum invariant
        # (edge_filter.hpp:141): the suffix scan's (0,0) aggregate equals
        # the forward optimum -- both live in the packed artifact
        assert np.array_equal(opt_new, np.asarray(opt_old))


def _oracle_lane(pssm, la, lb):
    score, lines, ga, gb = oracle.align_pssm(
        pssm[:la, :lb].astype(np.int64), GO, GE)
    return score, lines, oracle.evaluate_lines(ga, gb, GO, GE)


@pytest.mark.parametrize("b, la_max, lb_max, seed", [
    (4, 12, 10, 3),     # ragged lanes, degenerate 12x1 and 2x2 lanes
    (33, 16, 16, 4),    # a batch wider than one 32-lane block
    (3, 9, 40, 5),      # lb_max >> la_max: diagonals longer than a row
])
def test_align_shapes_match_oracle(b, la_max, lb_max, seed):
    """Batch/width shapes the wavefront paths block differently, against
    the scalar oracle lane by lane (dense partner map included)."""
    rng = np.random.default_rng(seed)
    las = rng.integers(1, la_max + 1, b)
    lbs = rng.integers(1, lb_max + 1, b)
    las[0], lbs[0] = la_max, lb_max
    if b > 2:
        las[1], lbs[1] = la_max, 1
        las[2], lbs[2] = 2, 2
    pssms = np.stack([random_pssm(rng, las[k], lbs[k], la_max, lb_max,
                                  tie_prone=bool(k % 2)) for k in range(b)])
    out = gotoh.align_pssm_batch(pssms, las, lbs, GO, GE, la_max, lb_max)
    partner = np.asarray(out.partner)
    for k in range(b):
        score, lines, gap = _oracle_lane(pssms[k], las[k], lbs[k])
        assert int(out.upper[k]) == score, f"lane {k}"
        assert int(out.gap_score[k]) == gap, f"lane {k}"
        want = np.full(la_max, -1)
        for (a, p) in lines:
            want[a] = p
        np.testing.assert_array_equal(partner[k], want, err_msg=f"lane {k}")


def test_seq_part_reduce_matches_oracle_lines():
    """The solver's seq-score sum over matched cells (the lower bound's
    sequence term, lagrange.hpp:376-378) == the oracle's line sum."""
    from lara_tpu.ops import gotoh_cuda

    rng = np.random.default_rng(11)
    la_max, lb_max, b = 12, 10, 5
    las = rng.integers(1, la_max + 1, b)
    lbs = rng.integers(1, lb_max + 1, b)
    pssms = np.stack([random_pssm(rng, las[k], lbs[k], la_max, lb_max, True)
                      for k in range(b)])
    seq = rng.integers(-5000, 5000, (b, la_max, lb_max)).astype(np.int32)
    tb = gotoh_cuda.align(pssms, las, lbs, GO, GE, la_max, lb_max,
                          seq_scores=seq.reshape(b, -1))
    for k in range(b):
        _score, lines, _gap = _oracle_lane(pssms[k], las[k], lbs[k])
        assert int(tb.seq_part[k]) == sum(int(seq[k, a, p]) for a, p in lines)


def test_preskewed_scan_and_traceback_match_oracle():
    """The two stages on a once-skewed input (skew_scores -> gotoh_scan ->
    traceback) reproduce the oracle, as align_pssm_batch composes them."""
    rng = np.random.default_rng(12)
    la_max, lb_max, b = 10, 13, 4
    las = rng.integers(1, la_max + 1, b)
    lbs = rng.integers(1, lb_max + 1, b)
    pssms = np.stack([random_pssm(rng, las[k], lbs[k], la_max, lb_max)
                      for k in range(b)])
    skewed = gotoh.skew_scores(pssms, PSSM_INIT)
    assert skewed.shape == (la_max + lb_max + 1, b, la_max + 1)
    res = gotoh.gotoh_scan(skewed, las, lbs, GO, GE, la_max, emit="dirs")
    tb = gotoh.traceback(res.aux, res.final_m, res.final_h, res.final_v,
                         las, lbs, GO, GE, la_max, lb_max)
    for k in range(b):
        score, lines, gap = _oracle_lane(pssms[k], las[k], lbs[k])
        n = int(tb.n_lines[k])
        assert int(tb.upper[k]) == score
        assert [tuple(x) for x in np.asarray(tb.lines[k][:n])] == lines
        assert int(tb.gap_score[k]) == gap
