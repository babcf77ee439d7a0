"""Hybrid solver: batched device DP + native host bookkeeping + work stealing.

Each subgradient iteration splits across the hardware the way the work is
shaped (the reference's own CPU split, re-targeted):

* **device**: the batched structure-profit-augmented Gotoh DP + traceback
  (the CUDA wavefront kernel on a GPU) -- the O(L^2 * B) FLOPs,
* **host (C++)**: per-pair sparse bookkeeping -- priority-queue maxima,
  subgradients, greedy matching, dual updates, incremental PSSM refresh --
  touching only O(lines * partners) state (:mod:`lara_tpu.native.lagrange`),
* **work stealing**: a lane whose pair converges is refilled from the pending
  queue immediately (the reference's shared-iterator steal,
  ``subgradient_solver.hpp:298-307``), so the batch never idles on the
  convergence tail the way a fused masked ``while_loop`` does.

The dense [B, D] on-device formulation (:mod:`lara_tpu.solver.device_solver`)
remains the backend for multi-chip ``shard_map`` runs and for CPU testing;
on partner-heavy inputs (base-pair-probability dot plots) its per-iteration
gather/scatter cost scales with the padded dual dimension, while this path
stays proportional to the touched state.

Role: this backend serves the modes whose matching must run on the host --
exact MWM (``-m 0``, per-iteration blossom in
``native/src/lagrange_host.cpp``) and lookahead > 8 -- plus
``LARA_SOLVER=hybrid`` for experiments; the fused device loop is the
default at -m 1..8 (its per-iteration cost against this backend's host
round trip is not measured on the GPU).

Per-iteration host<->device traffic: the PSSM batch up ([B, LA, LB] int32,
written in place by C++ into one pinned buffer), the line lists down
([B, LCAP, 2] + three [B] vectors).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

from lara_tpu.params import Parameters
from lara_tpu.solver.reference_driver import PairResult
from lara_tpu.types import PSSM_INIT
from lara_tpu.utils import log


def solve_all(store, pairs: Sequence[Tuple[int, int]], params: Parameters,
              max_lanes: int = 512) -> Iterator[PairResult]:
    """Solve all pairs with bucketed batching + lane refill."""
    from lara_tpu.solver.device_driver import _pad_dim

    buckets: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
    for (ia, ib) in pairs:
        key = (_pad_dim(len(store[ia].sequence)), _pad_dim(len(store[ib].sequence)))
        buckets.setdefault(key, []).append((ia, ib))

    cell_budget = 128 * 1024 * 1024
    for (la_max, lb_max), bucket_pairs in sorted(buckets.items(), reverse=True):
        lanes = max(1, min(max_lanes, cell_budget // (la_max * lb_max)))
        yield from _solve_bucket(store, bucket_pairs, params, la_max, lb_max, lanes)


def _build_models(store, chunk, params, la_max, lb_max):
    import jax  # noqa: F401  (device selected lazily)

    from lara_tpu.ops import gotoh
    from lara_tpu.scoring.ribosum import encode_rna5
    from lara_tpu.solver import interactions
    from lara_tpu.types import f2i

    b = len(chunk)
    go, ge = int(params.gap_open_int), int(params.gap_extend_int)
    seq_a = np.full((b, la_max), 4, np.int32)
    seq_b = np.full((b, lb_max), 4, np.int32)
    las = np.zeros(b, np.int32)
    lbs = np.zeros(b, np.int32)
    for k, (ia, ib) in enumerate(chunk):
        ea = encode_rna5(store[ia].sequence)
        eb = encode_rna5(store[ib].sequence)
        las[k], lbs[k] = len(ea), len(eb)
        seq_a[k, : len(ea)] = ea
        seq_b[k, : len(eb)] = eb
    active_dev, opt_dev = gotoh.edge_filter_batch(
        seq_a, seq_b, las, lbs, np.asarray(params.score_matrix), go, ge,
        int(f2i(params.suboptimal_diff)), la_max, lb_max,
    )
    active_np = np.asarray(active_dev)
    opt_np = np.asarray(opt_dev)
    return [
        interactions.build_pair_model(
            store[ia], store[ib], params,
            active_np[k, : las[k], : lbs[k]], int(opt_np[k]),
        )
        for k, (ia, ib) in enumerate(chunk)
    ]


#: per-lane sparse PSSM update capacity per iteration; overflow falls back to
#: a full-plane upload for that lane
UPD_CAP = 512


import functools as _functools


@_functools.lru_cache(maxsize=16)
def _device_fns(la_max: int, lb_max: int, lanes: int):
    """Jitted device-side step: apply sparse PSSM updates, run DP+traceback,
    return one packed int32 result array (single download per iteration)."""
    import functools

    import jax
    import jax.numpy as jnp

    from lara_tpu.ops import gotoh_cuda

    ne = la_max * lb_max
    lcap = min(la_max, lb_max)

    def _align_with_lines(pssm, las, lbs, go, ge):
        """Unlike the fused solver, the host bookkeeping consumes the ordered
        line list, so the DP must emit it (``emit_lines=True``)."""
        return gotoh_cuda.align(pssm, las, lbs, go, ge, la_max, lb_max,
                                emit_lines=True)

    @functools.partial(jax.jit, donate_argnames=("pssm_dev",))
    def device_iter(pssm_dev, uidx, uval, un, las, lbs, go, ge):
        k = jnp.arange(UPD_CAP, dtype=jnp.int32)[None, :]
        valid = k < un[:, None]
        lane_off = (jnp.arange(lanes, dtype=jnp.int32) * ne)[:, None]
        flat = jnp.where(valid, uidx + lane_off, lanes * ne)
        pssm_dev = pssm_dev.at[flat.reshape(-1)].set(
            jnp.where(valid, uval, 0).reshape(-1))
        pssm = pssm_dev[: lanes * ne].reshape(lanes, la_max, lb_max)
        tb = _align_with_lines(pssm, las, lbs, go, ge)
        packed = jnp.concatenate(
            [tb.upper[:, None], tb.gap_score[:, None], tb.n_lines[:, None],
             tb.lines.reshape(lanes, 2 * lcap)], axis=1)
        return pssm_dev, packed

    @functools.partial(jax.jit, donate_argnames=("pssm_dev",))
    def set_plane(pssm_dev, lane, plane_flat):
        return jax.lax.dynamic_update_slice(pssm_dev, plane_flat, (lane * ne,))

    return device_iter, set_plane


def _solve_bucket(store, bucket_pairs, params: Parameters,
                  la_max: int, lb_max: int, lanes: int) -> Iterator[PairResult]:
    import jax.numpy as jnp

    from lara_tpu.native.lagrange import PairSolver

    lanes = min(lanes, len(bucket_pairs))
    log(2, f"     hybrid bucket: {len(bucket_pairs)} pairs, {lanes} lanes, "
           f"{la_max}x{lb_max}")
    go, ge = int(params.gap_open_int), int(params.gap_extend_int)
    lcap = min(la_max, lb_max)
    ne = la_max * lb_max
    device_iter, set_plane = _device_fns(la_max, lb_max, lanes)

    # model prefetch: build in chunks so lane refills rarely wait on the host
    pending = list(bucket_pairs)
    model_cache: List = []

    def refill_cache():
        nonlocal pending
        if not model_cache and pending:
            chunk = pending[:max(lanes, 64)]
            pending = pending[len(chunk):]
            models = _build_models(store, chunk, params, la_max, lb_max)
            model_cache.extend(zip(chunk, models))

    pssm_host = np.full((lanes, la_max, lb_max), int(PSSM_INIT), np.int32)
    upd_idx = np.zeros((lanes, UPD_CAP), np.int32)
    upd_val = np.zeros((lanes, UPD_CAP), np.int32)
    upd_n = np.zeros(lanes, np.int32)
    needs_full = np.zeros(lanes, bool)
    slots: List = [None] * lanes  # (pair, PairSolver) or None
    las = np.ones(lanes, np.int32)
    lbs = np.ones(lanes, np.int32)
    lane_active = np.zeros(lanes, bool)

    def fill_lane(k: int) -> None:
        refill_cache()
        if not model_cache:
            return
        pair, model = model_cache.pop(0)
        pssm_host[k] = int(PSSM_INIT)
        solver = PairSolver(model, params, pssm_host[k])
        slots[k] = (pair, solver)
        las[k], lbs[k] = model.la, model.lb
        lane_active[k] = True
        needs_full[k] = True

    for k in range(lanes):
        fill_lane(k)

    pssm_dev = jnp.asarray(
        np.concatenate([pssm_host.reshape(-1), np.zeros(1, np.int32)]))
    needs_full[:] = False  # initial upload covered the planes

    # -j caps the host worker pool (0 = autodetect), mirroring the
    # reference's thread-count resolution (parameters.hpp:124-129)
    threads = int(params.threads) or (os.cpu_count() or 1)
    pool = ThreadPoolExecutor(max_workers=max(1, min(threads, 16, lanes)))
    go_j, ge_j = np.int32(go), np.int32(ge)
    try:
        while lane_active.any():
            for k in np.nonzero(needs_full)[0]:
                pssm_dev = set_plane(pssm_dev, np.int32(k),
                                     jnp.asarray(pssm_host[k].reshape(-1)))
                needs_full[k] = False

            pssm_dev, packed = device_iter(
                pssm_dev, jnp.asarray(upd_idx), jnp.asarray(upd_val),
                jnp.asarray(upd_n), jnp.asarray(las), jnp.asarray(lbs),
                go_j, ge_j,
            )
            out = np.asarray(packed)
            upper = out[:, 0]
            gap = out[:, 1]
            n_lines = out[:, 2]
            lines = out[:, 3:].reshape(lanes, lcap, 2)
            upd_n[:] = 0

            def do_step(k: int) -> int:
                _pair, solver = slots[k]
                status, count = solver.step_sparse(
                    lines[k, : n_lines[k]], int(gap[k]), int(upper[k]),
                    upd_idx[k], upd_val[k],
                )
                if count < 0:
                    needs_full[k] = True
                    upd_n[k] = 0
                else:
                    upd_n[k] = count
                return status

            active_idx = [k for k in range(lanes) if lane_active[k]]
            statuses = list(pool.map(do_step, active_idx))
            for k, status in zip(active_idx, statuses):
                if status != 1:
                    continue
                (ia, ib), solver = slots[k]
                columns, best_lower, best_upper, iters = solver.result(params)
                solver.close()
                slots[k] = None
                lane_active[k] = False
                las[k] = lbs[k] = 1
                upd_n[k] = 0
                swap = ia > ib
                if swap:
                    columns = [(y, x, w) for (x, y, w) in columns]
                yield PairResult(
                    seq_indices=(min(ia, ib), max(ia, ib)),
                    columns=columns,
                    score=best_lower,
                    iterations=iters,
                    best_upper=best_upper,
                    best_lower=best_lower,
                )
                fill_lane(k)  # work stealing: refill immediately
    finally:
        pool.shutdown(wait=False)
        for slot in slots:
            if slot is not None:
                slot[1].close()
