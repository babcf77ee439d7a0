"""Native C++ exact maximum-weight matching vs. brute force and networkx."""

import itertools
import random

import numpy as np
import pytest

pytest.importorskip("lara_tpu.native")


def _native():
    from lara_tpu.native import NativeBuildError, blossom

    try:
        blossom._load()
    except NativeBuildError as exc:
        pytest.skip(f"no native toolchain: {exc}")
    return blossom


def brute_force(edges):
    """Exact maximum-weight matching by subset enumeration (small graphs)."""
    best = 0
    for r in range(1, len(edges) + 1):
        for subset in itertools.combinations(edges, r):
            used = set()
            ok = True
            total = 0
            for (u, v, w) in subset:
                if u in used or v in used:
                    ok = False
                    break
                used.add(u)
                used.add(v)
                total += w
            if ok and total > best:
                best = total
    return best


def check_valid(edges, total, pairs):
    edge_w = {}
    for (u, v, w) in edges:
        key = (min(u, v), max(u, v))
        edge_w[key] = max(edge_w.get(key, 0), w)
    used = set()
    s = 0
    for (u, v) in pairs:
        key = (min(u, v), max(u, v))
        assert key in edge_w
        assert u not in used and v not in used
        used.update((u, v))
        s += edge_w[key]
    assert s == total


def test_simple_path():
    blossom = _native()
    total, pairs = blossom.max_weight_matching([(0, 1, 5), (1, 2, 6), (2, 3, 5)])
    assert total == 10
    check_valid([(0, 1, 5), (1, 2, 6), (2, 3, 5)], total, pairs)


def test_triangle_blossom():
    blossom = _native()
    edges = [(0, 1, 6), (1, 2, 6), (0, 2, 6), (2, 3, 10), (1, 4, 10)]
    total, pairs = blossom.max_weight_matching(edges)
    assert total == brute_force(edges)
    check_valid(edges, total, pairs)


def test_nested_blossoms():
    blossom = _native()
    # classic blossom-in-blossom structure
    edges = [
        (0, 1, 8), (1, 2, 8), (0, 2, 8),
        (2, 3, 10), (3, 4, 12), (4, 5, 12), (3, 5, 12),
        (5, 6, 7), (0, 6, 7),
    ]
    total, pairs = blossom.max_weight_matching(edges)
    assert total == brute_force(edges)
    check_valid(edges, total, pairs)


def test_empty_and_degenerate():
    blossom = _native()
    assert blossom.max_weight_matching([]) == (0, [])
    assert blossom.max_weight_matching([(3, 3, 5)]) == (0, [])
    assert blossom.max_weight_matching([(1, 2, -4)]) == (0, [])


def test_arbitrary_vertex_ids():
    blossom = _native()
    edges = [(100, 2000, 9), (2000, 7, 8), (7, 100, 3)]
    total, pairs = blossom.max_weight_matching(edges)
    assert total == 9
    check_valid(edges, total, pairs)


def test_parallel_edges():
    blossom = _native()
    edges = [(0, 1, 4), (0, 1, 9), (1, 2, 5)]
    total, pairs = blossom.max_weight_matching(edges)
    assert total == 9


@pytest.mark.parametrize("seed", range(12))
def test_random_small_vs_brute_force(seed):
    blossom = _native()
    rng = random.Random(seed)
    n = rng.randint(4, 8)
    edges = []
    for u in range(n):
        for v in range(u + 1, n):
            if rng.random() < 0.5:
                edges.append((u, v, rng.randint(1, 50)))
    total, pairs = blossom.max_weight_matching(edges)
    assert total == brute_force(edges)
    check_valid(edges, total, pairs)


@pytest.mark.parametrize("seed", range(8))
def test_random_medium_vs_networkx(seed):
    blossom = _native()
    nx = pytest.importorskip("networkx")
    rng = random.Random(100 + seed)
    n = rng.randint(12, 40)
    edges = {}
    for _ in range(n * 3):
        u, v = rng.randrange(n), rng.randrange(n)
        if u == v:
            continue
        key = (min(u, v), max(u, v))
        edges[key] = max(edges.get(key, 0), rng.randint(1, 10_000))
    edge_list = [(u, v, w) for (u, v), w in edges.items()]
    total, pairs = blossom.max_weight_matching(edge_list)
    check_valid(edge_list, total, pairs)

    graph = nx.Graph()
    for (u, v, w) in edge_list:
        graph.add_edge(u, v, weight=w)
    mate = nx.max_weight_matching(graph, maxcardinality=False)
    nx_total = sum(graph[u][v]["weight"] for (u, v) in mate)
    assert total == nx_total


def test_exact_matching_uses_native():
    """matching_ref.exact_matching returns identical totals either way."""
    from lara_tpu.solver import matching_ref

    possible = [
        [(30, 5), (12, 7)],
        [(30, 4)],
        [(8, 7)],
        [],
    ]
    lines = [4, 5, 6, 7]
    total, contacts = matching_ref.exact_matching(possible, lines)
    assert set(contacts) >= set(lines)
    # heaviest consistent set: (4,5)=60 doubled + (6,7)=16 doubled
    assert total == 2 * 30 + 2 * 8
    assert contacts[4] == 5 and contacts[5] == 4
    assert contacts[6] == 7 and contacts[7] == 6


@pytest.mark.parametrize("seed", range(4))
def test_random_large_vs_networkx(seed):
    """100-160 vertex graphs incl. dense and tie-heavy weight regimes
    (larger-scale blossom fuzz)."""
    blossom = _native()
    nx = pytest.importorskip("networkx")
    rng = random.Random(7000 + seed)
    n = rng.randint(100, 160)
    density = [2, 4, 8, 16][seed % 4]
    tie_heavy = seed % 2 == 0
    edges = {}
    for _ in range(n * density):
        u, v = rng.randrange(n), rng.randrange(n)
        if u == v:
            continue
        key = (min(u, v), max(u, v))
        w = rng.randint(1, 6) * 2 if tie_heavy else rng.randint(1, 100_000)
        edges[key] = max(edges.get(key, 0), w)
    edge_list = [(u, v, w) for (u, v), w in edges.items()]
    total, pairs = blossom.max_weight_matching(edge_list)
    check_valid(edge_list, total, pairs)

    graph = nx.Graph()
    for (u, v, w) in edge_list:
        graph.add_edge(u, v, weight=w)
    mate = nx.max_weight_matching(graph, maxcardinality=False)
    nx_total = sum(graph[u][v]["weight"] for (u, v) in mate)
    assert total == nx_total
