"""Device greedy matching vs. the exact Python mirror (fuzz, incl. ties).

All tests drive :func:`greedy_matching_queue` -- the path the production
fused solver takes (``device_solver.py``): statically queue-ordered columns
with a live mask, matched by the ``lax`` rounds loop ``_rounds_loop`` on
every platform.
"""

import numpy as np
import pytest

from lara_tpu.solver import matching_ref
from lara_tpu.solver.matching_device import greedy_matching_queue


def run_case(rng, n_lines, n_inter, lookahead, n_edges=64, tie_prone=True):
    """Build a random interaction set over `n_lines` line ids; compare."""
    lines = sorted(rng.choice(n_edges, size=n_lines, replace=False).tolist())
    inter = set()
    for _ in range(n_inter):
        a, b = rng.choice(n_lines, size=2, replace=False)
        l, m = min(lines[a], lines[b]), max(lines[a], lines[b])
        w = int(rng.integers(0, 6)) * 2 if tie_prone else int(rng.integers(0, 10000))
        inter.add((l, m, w))
    inter = sorted(inter)
    return lines, inter


def _queue_sorted(inter):
    return sorted(inter, key=lambda t: (-2 * t[2], t[0], t[1]))


def _mirror(lines, inter, lookahead):
    partners = [[] for _ in lines]
    for (l, m, w) in inter:
        partners[lines.index(l)].append((w // 2, m))
    return matching_ref.greedy_matching(partners, lines, lookahead)


@pytest.mark.parametrize("lookahead", [1, 2, 5])
@pytest.mark.parametrize("seed", range(10))
def test_queue_matching_matches_mirror(seed, lookahead):
    """Compacted queue-ordered columns (live prefix), fuzz vs the mirror."""
    rng = np.random.default_rng(seed * 10 + lookahead)
    n_edges = 64
    batch = 8
    dcap = 24
    lcap = 12

    lq = np.zeros((batch, dcap), np.int32)
    mq = np.zeros((batch, dcap), np.int32)
    wq = np.zeros((batch, dcap), np.int32)
    live = np.zeros((batch, dcap), bool)
    line_edges = np.full((batch, lcap), n_edges, np.int32)  # sentinel = ne
    expected = []

    for k in range(batch):
        n_lines = int(rng.integers(2, 9))
        n_inter = int(rng.integers(0, dcap))
        lines, inter = run_case(rng, n_lines, n_inter, lookahead, n_edges)
        score, contacts = _mirror(lines, inter, lookahead)
        expected.append((score, contacts, lines))
        for slot, line in enumerate(lines[:lcap]):
            line_edges[k, slot] = line
        for idx, (l, m, w) in enumerate(_queue_sorted(inter)):
            lq[k, idx] = l
            mq[k, idx] = m
            wq[k, idx] = w
            live[k, idx] = True

    out = greedy_matching_queue(lq, mq, wq, live, line_edges, lookahead)
    for k in range(batch):
        score, contacts, lines = expected[k]
        assert int(out.score[k]) == score, f"lane {k}"
        used = np.asarray(out.used_slot[k])
        want = np.zeros(lcap, bool)
        for v in contacts:
            want[lines.index(v)] = True
        np.testing.assert_array_equal(used, want, err_msg=f"lane {k}")


@pytest.mark.parametrize("seed", range(7))
def test_queue_matching_sparse_live(seed):
    """Sparse live masks over queue-ordered columns -- the exact calling
    shape of the fused solver (dead columns interleaved, queue order kept)."""
    rng = np.random.default_rng(500 + seed)
    n_edges = 512
    batch, dcap, lcap = 6, 64, 16
    lq = np.zeros((batch, dcap), np.int32)
    mq = np.zeros((batch, dcap), np.int32)
    wq = np.zeros((batch, dcap), np.int32)
    live = np.zeros((batch, dcap), bool)
    line_edges = np.full((batch, lcap), n_edges, np.int32)
    expected = []
    for k in range(batch):
        n_lines = int(rng.integers(2, 10))
        lines, inter = run_case(rng, n_lines, int(rng.integers(0, dcap // 2)),
                                5, n_edges)
        score, contacts = _mirror(lines, inter, 5)
        expected.append((score, contacts, lines))
        for slot, line in enumerate(lines[:lcap]):
            line_edges[k, slot] = line
        slots = np.sort(rng.choice(dcap, size=len(inter), replace=False))
        for idx, (l, m, w) in enumerate(_queue_sorted(inter)):
            s = int(slots[idx])
            lq[k, s] = l
            mq[k, s] = m
            wq[k, s] = w
            live[k, s] = True
    out = greedy_matching_queue(lq, mq, wq, live, line_edges, 5)
    for k, (score, contacts, lines) in enumerate(expected):
        assert int(out.score[k]) == score, f"lane {k}"
        want = np.zeros(lcap, bool)
        for v in contacts:
            want[lines.index(v)] = True
        np.testing.assert_array_equal(
            np.asarray(out.used_slot[k]), want, err_msg=f"lane {k}")


def test_queue_matching_empty():
    out = greedy_matching_queue(
        np.zeros((3, 4), np.int32), np.zeros((3, 4), np.int32),
        np.zeros((3, 4), np.int32), np.zeros((3, 4), bool),
        np.full((3, 2), 16, np.int32), 5,
    )
    assert np.all(np.asarray(out.score) == 0)
    assert not np.asarray(out.used_slot).any()


def test_queue_matching_known_chain():
    # the hand-checked chain from test_matching.py: queue order is
    # (0,1)=10, (1,2)=10, (0,2)=4 (weight desc, then lineL, lineR)
    lq = np.array([[0, 1, 0]], np.int32)
    mq = np.array([[1, 2, 2]], np.int32)
    wq = np.array([[10, 10, 4]], np.int32)
    live = np.ones((1, 3), bool)
    line_edges = np.array([[0, 1, 2, 8]], np.int32)
    out = greedy_matching_queue(lq, mq, wq, live, line_edges, 5)
    assert int(out.score[0]) == 10
    used = np.asarray(out.used_slot[0])
    assert used[0] and used[1] and not used[2]


# ---------------------------------------------------------------------------
# width/boundary fuzz: the production queue path is full-width by
# construction -- candidates beyond any historical compaction width
# (an early version silently truncated at 512 candidates) must be matched
# ---------------------------------------------------------------------------


def _build_compact_case(rng, n_cand_target, dcap, lookahead, n_lines=72,
                        n_edges=8192, lcap=80):
    """One lane with ~n_cand_target live candidates among n_lines lines."""
    lines = sorted(rng.choice(n_edges - 1, size=n_lines, replace=False).tolist())
    inter = set()
    attempts = 0
    while len(inter) < n_cand_target and attempts < 20 * n_cand_target:
        a, b = rng.choice(n_lines, size=2, replace=False)
        l, m = min(lines[a], lines[b]), max(lines[a], lines[b])
        inter.add((l, m, int(rng.integers(0, 6)) * 2))
        attempts += 1
    assert len(inter) == n_cand_target, "could not build enough interactions"
    inter = sorted(inter)

    score, contacts = _mirror(lines, inter, lookahead)

    # interleave the candidates among dead entries, preserving queue order
    w2 = np.zeros(dcap, np.int32)
    l_e = np.zeros(dcap, np.int32)
    m_e = np.zeros(dcap, np.int32)
    cand = np.zeros(dcap, bool)
    slots = np.sort(rng.choice(dcap, size=len(inter), replace=False))
    order = _queue_sorted(inter)
    for idx, (l, m, w) in enumerate(order):
        s = int(slots[idx])
        w2[s] = w
        l_e[s] = l
        m_e[s] = m
        cand[s] = True
    # qrank ranks entries in global queue order; dead entries rank after
    qrank = np.full(dcap, -1, np.int32)
    qrank[slots] = np.arange(len(inter), dtype=np.int32)
    dead = qrank < 0
    qrank[dead] = np.arange(len(inter), dcap, dtype=np.int32)

    line_edges = np.full(lcap, n_edges, np.int32)
    line_edges[: len(lines)] = lines
    want_used = np.zeros(lcap, bool)
    for v in contacts:
        want_used[lines.index(v)] = True
    return (w2, l_e, m_e, cand, line_edges, qrank), (score, want_used)


@pytest.mark.parametrize("n_cand", [0, 37, 511, 512, 513, 700, 2000])
def test_queue_matching_boundary_counts(n_cand):
    """Bit-equality with the mirror across historical truncation widths."""
    rng = np.random.default_rng(n_cand + 3)
    dcap = 2304
    lookahead = 5
    n_edges = 8192
    (w2, l_e, m_e, cand, line_edges, qrank), (score, want_used) = \
        _build_compact_case(rng, n_cand, dcap, lookahead, n_edges=n_edges)
    out = greedy_matching_queue(
        l_e[None], m_e[None], w2[None], cand[None], line_edges[None], 5)
    assert int(out.score[0]) == score
    np.testing.assert_array_equal(np.asarray(out.used_slot[0]), want_used)


@pytest.mark.parametrize("seed", range(4))
def test_queue_matching_mixed_batch(seed):
    """A batch mixing small and >512-candidate lanes reproduces every lane."""
    rng = np.random.default_rng(1000 + seed)
    dcap = 1536
    lookahead = 5
    n_edges = 8192
    counts = [20, 562, 300, 700]
    ins, outs = [], []
    for n_cand in counts:
        case, want = _build_compact_case(
            rng, n_cand, dcap, lookahead, n_edges=n_edges)
        ins.append(case)
        outs.append(want)
    w2, l_e, m_e, cand, line_edges, qrank = [np.stack(x) for x in zip(*ins)]
    out = greedy_matching_queue(l_e, m_e, w2, cand, line_edges, lookahead)
    for k, (score, want_used) in enumerate(outs):
        assert int(out.score[k]) == score, f"lane {k}"
        np.testing.assert_array_equal(
            np.asarray(out.used_slot[k]), want_used, err_msg=f"lane {k}")


def test_queue_matching_tail_candidate_cannot_truncate():
    """A lone candidate at the LAST column of a wide queue must be matched:
    the production path scans the full static width (no compaction bound)."""
    dcap = 2304
    n_edges = 8192
    lq = np.zeros((1, dcap), np.int32)
    mq = np.zeros((1, dcap), np.int32)
    wq = np.zeros((1, dcap), np.int32)
    live = np.zeros((1, dcap), bool)
    lq[0, dcap - 1] = 10
    mq[0, dcap - 1] = 20
    wq[0, dcap - 1] = 8
    live[0, dcap - 1] = True
    line_edges = np.array([[10, 20, n_edges, n_edges]], np.int32)
    out = greedy_matching_queue(lq, mq, wq, live, line_edges, 5)
    assert int(out.score[0]) == 8
    np.testing.assert_array_equal(
        np.asarray(out.used_slot[0]), [True, True, False, False])
