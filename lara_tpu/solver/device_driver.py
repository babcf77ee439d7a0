"""Host orchestration of the batched device solver.

Replaces the reference's thread/work-stealing scheduler
(``subgradient_solver.hpp:110-207``) with length-bucketed device batching:

* pairs are bucketed by padded (LA, LB) tile class (SURVEY §7: "work
  stealing -> length-bucketed batching"),
* each bucket chunk becomes one :func:`solve_batch` call -- a single XLA
  program running every lane's full subgradient loop with convergence masks,
* the edge prefilter runs on device for the whole chunk first; the packed
  interaction models are built host-side (NumPy) from its result,
* results are assembled into the canonical output entries; the enclosing
  ``OutputLibrary`` restores the deterministic (seq1, seq2) order.

Falls back per-pair to the scalar reference driver when a pair needs
semantics the batched path does not cover (exact matching ``-m 0``,
lookahead > 8).
"""

from __future__ import annotations

import functools
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

from lara_tpu.params import Parameters
from lara_tpu.scoring.ribosum import encode_rna5
from lara_tpu.solver import interactions
from lara_tpu.solver.reference_driver import PairResult
from lara_tpu.types import INFINITY, f2i
from lara_tpu.utils import log

#: pairs per device batch (tunable; lanes beyond the pair count are padded).
#: Wide batches amortize the sequential depth of the wavefront DP over many
#: lanes.  Tuned on the earlier accelerator; not measured on the GPU.
DEFAULT_MAX_BATCH = 512


def _round_up(value: int, quantum: int) -> int:
    return ((value + quantum - 1) // quantum) * quantum


def _hybrid_available(forced: bool = False) -> bool:
    """Hybrid = device DP + native C++ bookkeeping + lane refill
    (LARA_SOLVER=hybrid, or automatically for matching modes the fused path
    does not cover).  The fused all-device while_loop is the default: after
    the edge-major/segmented-scan redesign its per-iteration device cost is
    far below one host<->device round trip, so the hybrid split only pays
    off when per-iteration transfers are free (local CPU experiments) or
    when the matching itself must run on the host (exact MWM, ``-m 0``)."""
    import os

    if not forced and os.environ.get("LARA_SOLVER", "") != "hybrid":
        return False
    try:
        from lara_tpu.native import lagrange

        lagrange._load()
        return True
    except Exception as exc:  # no toolchain
        log(2, f"   * hybrid backend unavailable ({exc}); using fused")
        return False


def _pad_dim(length: int) -> int:
    """Bucket quantisation: coarse enough to batch well, fine enough to not
    waste O(L^2) work (the scatter/compare costs scale with LA*LB, so a 96
    bucket between 64 and 128 pays for itself on tRNA-scale input)."""
    if length <= 32:
        return 32
    if length <= 64:
        return 64
    if length <= 96:
        return 96
    return _round_up(length, 64)


def solve_all(store, pairs: Sequence[Tuple[int, int]], params: Parameters
              ) -> Iterator[PairResult]:
    if params.matching == 0 or params.matching > 8:
        # exact MWM / very deep lookahead: the matching must run on the host.
        # Preferred backend: hybrid (batched device DP + native bookkeeping
        # with the blossom exact matcher, the reference's per-iteration LEMON
        # integration, ``matching.hpp:201-238``); scalar mirror otherwise.
        if _hybrid_available(forced=True):
            from lara_tpu.solver import hybrid_driver

            log(1, "   * host matching mode: hybrid backend (device DP + "
                   "native exact/deep matching)")
            yield from hybrid_driver.solve_all(store, pairs, params)
            return
        from lara_tpu.solver import reference_driver

        log(1, "   * matching mode requires the scalar backend; using it")
        for (ia, ib) in pairs:
            yield reference_driver.solve_pair(store[ia], store[ib], params, (ia, ib))
        return

    if _hybrid_available():
        from lara_tpu.solver import hybrid_driver

        log(2, "   * hybrid backend: device DP + native host bookkeeping")
        yield from hybrid_driver.solve_all(store, pairs, params)
        return

    tasks = plan_tasks(store, pairs)

    if len(tasks) <= 1 or os.environ.get("LARA_NO_PIPELINE"):
        for task in tasks:
            if task[0] == "refill":
                _, la_max, lb_max, bucket_pairs, max_batch = task
                yield from _run_refill(store, params, la_max, lb_max,
                                       bucket_pairs, max_batch)
            else:
                _, la_max, lb_max, chunk = task
                yield from _solve_chunk(store, chunk, params, la_max, lb_max)
        return

    # ---- cross-chunk pipeline (the reference's workers never idle,
    # subgradient_solver.hpp:206-331).  Three stages on three threads:
    # the main thread prepares chunk k+1 (edge filter, model build, pack,
    # upload), the solver thread runs chunk k's dispatch loop, and the
    # download thread blocks on chunk k-1's tail sync + result transfer.
    # Device work still serialises on the one device; what's hidden is the
    # host share AND the per-chunk download (the final-dispatch sync
    # overlaps the next chunk's solve; the share each hides is not measured
    # on the GPU).  Depth is 2 chunks with aggregate undrained state capped
    # before each upload, so peak residency stays bounded (pending_budget +
    # one 3 GB chunk + solve scratch; these gates were sized for a 16 GB
    # device and are not measured on the GPU). ----
    pending_budget = 2_500_000_000
    with ThreadPoolExecutor(max_workers=1) as solver_thread, \
            ThreadPoolExecutor(max_workers=1) as download_thread:
        pending: List[tuple] = []  # (download future, est_bytes), task order
        for task in tasks:
            if task[0] == "refill":
                while pending:
                    yield from pending.pop(0)[0].result()
                _, la_max, lb_max, bucket_pairs, max_batch = task
                yield from _run_refill(store, params, la_max, lb_max,
                                       bucket_pairs, max_batch)
                continue
            _, la_max, lb_max, chunk = task
            # bound AGGREGATE residency before the next upload lands: the
            # upload below can add up to the 3 GB _prepare_chunk gate, so
            # peak device state stays <= pending_budget + 3 GB + scratch
            while pending and sum(e for _, e in pending) > pending_budget:
                yield from pending.pop(0)[0].result()
            prep = _prepare_chunk(store, chunk, params, la_max, lb_max)
            if isinstance(prep, _Prepared):
                while len(pending) >= 2:
                    yield from pending.pop(0)[0].result()
                solve_fut = solver_thread.submit(_run_solve, prep, params)
                pending.append((
                    download_thread.submit(
                        lambda sf=solve_fut, p=prep:
                            _download_post(sf.result(), p, params)),
                    prep.est_bytes))
            else:
                # oversized for double-buffered residency: solve
                # synchronously (the build above still overlapped the
                # previous chunk's device time)
                while pending:
                    yield from pending.pop(0)[0].result()
                models, las, lbs = prep
                yield from _solve_models(store, chunk, models, params,
                                         la_max, lb_max, las, lbs)
        while pending:
            yield from pending.pop(0)[0].result()


def plan_tasks(store, pairs: Sequence[Tuple[int, int]]) -> List[tuple]:
    """The device work list: pairs bucketed by padded (LA, LB) class, each
    bucket cut into ``("chunk", la_max, lb_max, pairs)`` batches (or one
    ``("refill", la_max, lb_max, pairs, window)`` task), in solve order."""
    buckets: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
    for (ia, ib) in pairs:
        key = (_pad_dim(len(store[ia].sequence)), _pad_dim(len(store[ib].sequence)))
        buckets.setdefault(key, []).append((ia, ib))

    #: cap device batches so the DP state stays within device memory:
    #: B * LA * LB cells at ~16 bytes live state (pssm + skew + dirs).
    #: Sized for a 16 GB device; not measured on the GPU.
    cell_budget = 128 * 1024 * 1024

    max_batch_cap = int(os.environ.get("LARA_MAX_BATCH", DEFAULT_MAX_BATCH))
    # chunk-boundary lane refill (the reference's work stealing) applies to
    # buckets wider than the batch on the single-device fused path.
    # OPT-IN (LARA_REFILL=1): each chunk boundary pays a flag/result/splice
    # round trip against the idle lanes it reclaims; which side wins on the
    # GPU is not measured.
    refill_ok = bool(os.environ.get("LARA_REFILL")) \
        and not os.environ.get("LARA_NO_REFILL")
    tasks: List[tuple] = []
    for (la_max, lb_max), bucket_pairs in sorted(buckets.items(), reverse=True):
        max_batch = max(1, min(max_batch_cap, cell_budget // (la_max * lb_max)))
        if refill_ok and len(bucket_pairs) > max_batch and max_batch > 1:
            tasks.append(("refill", la_max, lb_max, bucket_pairs, max_batch))
            continue
        for start in range(0, len(bucket_pairs), max_batch):
            tasks.append(("chunk", la_max, lb_max,
                          bucket_pairs[start : start + max_batch]))

    # single long-pair chunk: split in half so the cross-chunk pipeline below
    # engages (build/pack of half 2 and download of half 1 hide behind device
    # solve).  Long pairs only: at tRNA scale the extra dispatch boundaries
    # may cost more than the small host share they hide (the threshold is
    # not measured on the GPU).  The midpoint split keeps both halves in the
    # same padded-batch program class.
    split_env = os.environ.get("LARA_SPLIT_SINGLE", "")
    if (len(tasks) == 1 and tasks[0][0] == "chunk" and split_env != "0"
            and not os.environ.get("LARA_NO_PIPELINE")):
        _, la_max, lb_max, chunk = tasks[0]
        mid = (len(chunk) + 1) // 2
        # only split when both halves round to the SAME padded-batch
        # power-of-two (e.g. 28 -> 14+14, both bp=16); sizes like 2^k+1
        # (9 -> 5+4: bp 8 and 4) would cold-compile two NEW device program
        # shapes where the unsplit path compiles one
        same_class = (1 << max(0, mid - 1).bit_length()) \
            == (1 << max(0, len(chunk) - mid - 1).bit_length())
        if len(chunk) >= 4 and same_class \
                and (la_max * lb_max >= 512 * 512 or split_env == "1"):
            tasks = [("chunk", la_max, lb_max, chunk[:mid]),
                     ("chunk", la_max, lb_max, chunk[mid:])]

    return tasks


def _build_workers(params: Parameters) -> int:
    """Host worker threads for the model build: ``-j`` (0 = autodetect),
    mirroring the reference's thread-count resolution
    (``parameters.hpp:124-129``)."""
    threads = int(params.threads)
    if threads <= 0:
        threads = os.cpu_count() or 1
    return max(1, threads)


@functools.lru_cache(maxsize=1)
def _get_pack_filter():
    """Jitted bit-packer for the edge-filter result: one int32 download of
    [B, NE/32 words + 1 opt column].  Cached: a fresh ``jax.jit`` object per
    call would retrace+recompile every time."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def pack(active, opt):
        b = active.shape[0]
        bits = active.reshape(b, -1, 32).astype(jnp.uint32)
        words = jnp.sum(bits << jnp.arange(32, dtype=jnp.uint32)[None, None, :],
                        axis=2).astype(jnp.int32)
        return jnp.concatenate([words, opt[:, None].astype(jnp.int32)], axis=1)

    return pack


def _pack_filter(active, opt):
    return _get_pack_filter()(active, opt)


def _unpack_filter(packed_np: np.ndarray, la_max: int, lb_max: int):
    b = packed_np.shape[0]
    words = packed_np[:, :-1].astype(np.uint32)
    bits = (words[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    active = bits.astype(bool).reshape(b, la_max, lb_max)
    return active, packed_np[:, -1]


def _filter_and_build(store, chunk, params: Parameters, la_max: int,
                      lb_max: int):
    """Device edge filter + host model build for one chunk:
    (models, las, lbs)."""
    from lara_tpu.ops import gotoh
    from lara_tpu.utils import timing

    b = len(chunk)
    go, ge = int(params.gap_open_int), int(params.gap_extend_int)
    subopt = int(f2i(params.suboptimal_diff))

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

    log(2, f"     device chunk: {b} pairs padded to {la_max}x{lb_max}")

    with timing.phase("edge filter (device)"):
        if os.environ.get("LARA_FILTER_GATHER"):
            # legacy grid-space formulation (A/B reference): two unskew
            # gathers + the per-lane flip suffix gather on device
            active_dev, opt_dev = gotoh.edge_filter_batch(
                seq_a, seq_b, las, lbs, np.asarray(params.score_matrix),
                go, ge, subopt, la_max, lb_max,
            )
            packed_np = np.asarray(_pack_filter(active_dev, opt_dev))
            active_np, opt_np = _unpack_filter(packed_np, la_max, lb_max)
        else:
            # gather-free: prefix + substitution + reverse suffix scan all
            # evaluated in skewed coordinates (static shifts only), one
            # packed download, free strided-view unskew on the host
            packed_np = np.asarray(gotoh.edge_filter_skewed_words(
                seq_a, seq_b, las, lbs, np.asarray(params.score_matrix),
                go, ge, subopt, la_max, lb_max))
            active_np, opt_np = gotoh.unskew_active_words(
                packed_np, la_max, lb_max)

    # host: packed interaction models, built on -j worker threads
    with timing.phase("interaction build (host)"):
        def build(k_pair):
            k, (ia, ib) = k_pair
            return interactions.build_pair_model(
                store[ia], store[ib], params,
                active_np[k, : las[k], : lbs[k]], int(opt_np[k]),
            )

        workers = min(_build_workers(params), max(1, b))
        if workers > 1:
            with ThreadPoolExecutor(max_workers=workers) as pool:
                models = list(pool.map(build, enumerate(chunk)))
        else:
            models = [build(kp) for kp in enumerate(chunk)]

    return models, las, lbs


def _solve_chunk(store, chunk, params: Parameters, la_max: int, lb_max: int
                 ) -> Iterator[PairResult]:
    models, las, lbs = _filter_and_build(store, chunk, params, la_max, lb_max)
    yield from _solve_models(store, chunk, models, params, la_max, lb_max,
                             las, lbs)


def _model_rows(models, la_max: int, lb_max: int, dcap: int):
    """Raw BatchModel rows ([k, ...] NumPy) for lane splicing."""
    from lara_tpu.solver import device_solver

    k = len(models)
    ne = la_max * lb_max
    seq_score = np.zeros((k, la_max, lb_max), np.int32)
    active = np.zeros((k, la_max, lb_max), bool)
    dual_l = np.zeros((k, dcap), np.int32)
    dual_m = np.zeros((k, dcap), np.int32)
    sscore = np.zeros((k, dcap), np.int32)
    rev = np.broadcast_to(np.arange(dcap, dtype=np.int32), (k, dcap)).copy()
    dvalid = np.zeros((k, dcap), bool)
    qrank = np.broadcast_to(np.arange(dcap, dtype=np.int32), (k, dcap)).copy()
    las = np.ones(k, np.int32)
    lbs = np.ones(k, np.int32)
    for i, m in enumerate(models):
        seq_score[i, : m.la, : m.lb] = m.seq_score
        active[i, : m.la, : m.lb] = m.active
        las[i], lbs[i] = m.la, m.lb
        d = len(m.dual_l)
        if d:
            a_ids, b_ids = np.divmod(m.dual_l, m.lb)
            dual_l[i, :d] = a_ids * lb_max + b_ids
            a_ids, b_ids = np.divmod(m.dual_m, m.lb)
            dual_m[i, :d] = a_ids * lb_max + b_ids
            sscore[i, :d] = m.sscore
            rev[i, :d] = m.rev
            dvalid[i, :d] = True
            qrank[i, :d][m.qperm] = np.arange(d, dtype=np.int32)
    return device_solver.BatchModel(
        seq_score=seq_score.reshape(k, ne), active=active.reshape(k, ne),
        dual_l=dual_l, dual_m=dual_m, sscore=sscore, rev=rev, dvalid=dvalid,
        qrank=qrank, la=las, lb=lbs)


#: lanes refilled per splice call (fixed width = one compiled program)
REFILL_WIDTH = 32


def _run_refill(store, params: Parameters, la_max: int, lb_max: int,
                bucket_pairs, window: int) -> Iterator[PairResult]:
    """Solve a bucket larger than the batch width with chunk-boundary lane
    refill: converged lanes hand their slot to the next waiting pair (the
    reference's work stealing, ``subgradient_solver.hpp:286-325``) instead
    of splitting the bucket into sequential full-depth batches."""
    import jax.numpy as jnp

    from lara_tpu.solver import device_solver
    from lara_tpu.utils import timing

    # build every model up front: refill needs bucket-wide dual capacity,
    # scan depth and edge caps so the one compiled program covers any pair
    models: List = []
    las_all = []
    lbs_all = []
    for start in range(0, len(bucket_pairs), window):
        m, la_s, lb_s = _filter_and_build(
            store, bucket_pairs[start:start + window], params, la_max, lb_max)
        models.extend(m)
        las_all.extend(la_s.tolist())
        lbs_all.extend(lb_s.tolist())
    dcap = _chunk_dcap(models)

    if _chunk_est_bytes(window, la_max, lb_max, dcap) > 6_000_000_000:
        # bucket too wide to refill within device memory: plain sequential
        # chunks (the 6 GB gate is not measured on the GPU)
        for start in range(0, len(bucket_pairs), window):
            chunk = bucket_pairs[start:start + window]
            yield from _solve_models(
                store, chunk, models[start:start + window], params, la_max,
                lb_max, np.asarray(las_all[start:start + window], np.int32),
                np.asarray(lbs_all[start:start + window], np.int32))
        return

    prep = _pack_models(
        store, list(bucket_pairs[:window]), models[:window], params, la_max,
        lb_max, np.asarray(las_all[:window], np.int32),
        np.asarray(lbs_all[:window], np.int32), dcap)
    # widen the static scan/placement caps to cover the WHOLE bucket (the
    # window prep only saw its own pairs)
    max_run, max_edges = 1, 1
    for m in models:
        if len(m.dual_l):
            counts = np.unique(m.dual_l, return_counts=True)[1]
            max_run = max(max_run, int(counts.max()))
            max_edges = max(max_edges, len(counts))
    steps_needed = max(1, (max_run - 1).bit_length())
    prep.scan_steps = min(steps_needed + (steps_needed & 1),
                          max(1, (dcap - 1).bit_length()))
    e_cap = min(dcap, max(256, _round_up(max_edges, 256)))
    if 4 * prep.bp * e_cap * (la_max + 2 * lb_max) > 256 * 1024 * 1024:
        e_cap = 0
    prep.e_cap = e_cap

    go, ge = prep.go, prep.ge
    step0 = np.float32(params.step_size_factor)
    n_iter = int(params.num_iterations)
    bp = prep.bp
    model = prep.batch
    carry = device_solver._init_carry(bp, dcap, la_max, step0, n_iter)
    # lane k currently holds (pair, model) or None (padding / harvested)
    lane_pair: List = [None] * bp
    for k in range(window):
        lane_pair[k] = (bucket_pairs[k], models[k])
    next_i = window
    dispatches = 0
    occupied = 0
    solve_timer = timing.phase("subgradient solve (device)")
    solve_timer.__enter__()
    while True:
        carry = device_solver.solve_batch_chunk(
            model, carry, go, ge, la_max, lb_max, 125,
            int(params.max_nondecr_iterations), int(params.matching),
            prep.scan_steps, prep.e_cap)
        flags = np.asarray(carry.lane_active)
        dispatches += 1
        occupied += sum(1 for k in range(bp)
                        if lane_pair[k] is not None and flags[k])
        finished = [k for k in range(bp)
                    if lane_pair[k] is not None and not flags[k]]
        if finished:
            packed, s = _download_result(
                device_solver._result_of(carry), params)
            for k in finished:
                pair, mdl = lane_pair[k]
                lane_pair[k] = None
                yield _postprocess_lane(packed, s, k, pair, mdl, params,
                                        mdl.la)
        # every empty slot is refillable: just-harvested lanes AND the
        # batch-rounding padding lanes
        free = [k for k in range(bp) if lane_pair[k] is None]
        while free and next_i < len(bucket_pairs):
            take = min(len(free), len(bucket_pairs) - next_i,
                       REFILL_WIDTH)
            lanes = free[:take]
            free = free[take:]
            new_models = models[next_i:next_i + take]
            rows = _model_rows(new_models, la_max, lb_max, dcap)
            lane_idx = np.full(REFILL_WIDTH, bp, np.int32)  # drop slots
            lane_idx[:take] = lanes
            import jax

            rows = jax.tree.map(
                lambda a: jnp.asarray(np.concatenate(
                    [a, np.zeros((REFILL_WIDTH - take,) + a.shape[1:],
                                 a.dtype)])) if take < REFILL_WIDTH
                else jnp.asarray(a), rows)
            model, carry = device_solver.splice_lanes(
                model, carry, jnp.asarray(lane_idx), rows, step0,
                np.int32(n_iter))
            for j, k in enumerate(lanes):
                lane_pair[k] = (bucket_pairs[next_i + j],
                                new_models[j])
            next_i += take
        if not any(lane_pair):
            break
    solve_timer.__exit__(None, None, None)
    log(1, f"   * refill bucket {la_max}x{lb_max}: {len(bucket_pairs)} pairs "
           f"through {bp} lanes, mean occupancy "
           f"{occupied / max(1, dispatches * bp):.2f} over {dispatches} "
           f"dispatches")


def _prepare_chunk(store, chunk, params: Parameters, la_max: int,
                   lb_max: int):
    """Pipeline front half: filter + build + pack + upload.  Returns a
    :class:`_Prepared` ready for the solver thread, or the raw
    (models, las, lbs) tuple when the chunk is too large to double-buffer
    in device memory (caller then solves it synchronously via :func:`_solve_models`,
    which also handles the split-in-half guard).  The 3 GB gate was sized
    for a 16 GB device and is not measured on the GPU."""
    models, las, lbs = _filter_and_build(store, chunk, params, la_max, lb_max)
    dcap = _chunk_dcap(models)
    if len(chunk) > 1 and _chunk_est_bytes(
            len(chunk), la_max, lb_max, dcap) > 3_000_000_000:
        return models, las, lbs
    return _pack_models(store, chunk, models, params, la_max, lb_max,
                        las, lbs, dcap)


@functools.lru_cache(maxsize=64)
def _get_unpack_model(ne: int, d: int, la_max: int, lb_max: int,
                      mode: str, nk: int = 5):
    """Jitted slicer: one uploaded int32 buffer -> BatchModel device arrays
    (one transfer instead of one per array).  lru-cached per shape class:
    rebuilding the jit object per chunk retraced+recompiled.

    ``mode``:
    * ``"packed15"`` (requires ne, d <= 32768): the upload carries
      sequences instead of the dense seq-score grid (recomputed on device
      by an exact one-hot matmul lookup -- f32 products of int-valued
      operands < 2^24 are exact, and the single scale multiply + trunc
      matches the host's float32 math bit-for-bit) and the dual table's
      (l, m) / (rev, qrank) columns share one word each: the upload drops
      from ~10 MB to ~3.4 MB at bench scale (counted from the shapes).
    * ``"packed_seq"``: same device-side seq-score rebuild but full-width
      dual columns (flat edge ids exceed 15 bits).  For long pairs this
      removes the dominant transfer entirely: the dense [B, LA, LB] grid
      (~300 MB at 16S batch width) never crosses to the device.
    * ``"full"``: dense grid in the buffer (multi-device raw path only).
    """
    import jax
    import jax.numpy as jnp

    from lara_tpu.solver import device_solver

    nw = ne // 32

    if mode == "full":
        @jax.jit
        def unpack(buf, submat_f):
            seq_score = buf[:, :ne]
            words = jax.lax.bitcast_convert_type(
                buf[:, ne:ne + nw], jnp.uint32)
            active = ((words[:, :, None]
                       >> jnp.arange(32, dtype=jnp.uint32)[None, None, :])
                      & 1).astype(bool).reshape(buf.shape[0], ne)
            off = ne + nw
            dual_l = buf[:, off:off + d]
            dual_m = buf[:, off + d:off + 2 * d]
            sscore = buf[:, off + 2 * d:off + 3 * d]
            rev = buf[:, off + 3 * d:off + 4 * d]
            qrank = buf[:, off + 4 * d:off + 5 * d]
            la = buf[:, off + 5 * d]
            lb = buf[:, off + 5 * d + 1]
            nd = buf[:, off + 5 * d + 2]
            dvalid = jnp.arange(d, dtype=jnp.int32)[None, :] < nd[:, None]
            return device_solver.BatchModel(
                seq_score=seq_score, active=active, dual_l=dual_l,
                dual_m=dual_m, sscore=sscore, rev=rev, dvalid=dvalid,
                qrank=qrank, la=la, lb=lb)

        return unpack

    packed15 = mode == "packed15"

    @jax.jit
    def unpack(buf, submat_f):
        bp = buf.shape[0]
        words = jax.lax.bitcast_convert_type(buf[:, :nw], jnp.uint32)
        active = ((words[:, :, None]
                   >> jnp.arange(32, dtype=jnp.uint32)[None, None, :])
                  & 1).astype(bool).reshape(bp, ne)
        off = nw
        if packed15:
            lm = buf[:, off:off + d]
            sscore = buf[:, off + d:off + 2 * d]
            rq = buf[:, off + 2 * d:off + 3 * d]
            off += 3 * d
            dual_l = lm >> 15
            dual_m = lm & 0x7FFF
            rev = rq >> 15
            qrank = rq & 0x7FFF
        else:
            dual_l = buf[:, off:off + d]
            dual_m = buf[:, off + d:off + 2 * d]
            sscore = buf[:, off + 2 * d:off + 3 * d]
            rev = buf[:, off + 3 * d:off + 4 * d]
            qrank = buf[:, off + 4 * d:off + 5 * d]
            off += 5 * d
        sa = buf[:, off:off + la_max]
        sb = buf[:, off + la_max:off + la_max + lb_max]
        off += la_max + lb_max
        scale = jax.lax.bitcast_convert_type(buf[:, off], jnp.float32)
        la = buf[:, off + 1]
        lb = buf[:, off + 2]
        nd = buf[:, off + 3]
        dvalid = jnp.arange(d, dtype=jnp.int32)[None, :] < nd[:, None]
        ranks = jnp.arange(nk, dtype=jnp.int32)
        oh_a = (sa[:, :, None] == ranks).astype(jnp.float32)
        oh_b = (sb[:, :, None] == ranks).astype(jnp.float32)
        # HIGHEST precision: a reduced-precision f32 matmul path (TF32 on
        # the GPU) rounds the operands, which corrupts score-matrix entries
        # and drifts the scores away from the mirror's
        mat = jnp.einsum("bif,fg,bjg->bij", oh_a, submat_f, oh_b,
                         preferred_element_type=jnp.float32,
                         precision=jax.lax.Precision.HIGHEST)
        seq_score = (scale[:, None, None] * mat).astype(jnp.int32)
        return device_solver.BatchModel(
            seq_score=seq_score.reshape(bp, ne), active=active,
            dual_l=dual_l, dual_m=dual_m, sscore=sscore, rev=rev,
            dvalid=dvalid, qrank=qrank, la=la, lb=lb)

    return unpack


@functools.lru_cache(maxsize=1)
def _get_pack_result():
    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, static_argnames=("linear",))
    def pack(result, linear):
        parts = [
            result.best_partner,
            result.best_matched.astype(jnp.int32),
            jnp.stack([result.best_nlines, result.best_lower,
                       result.best_upper, result.iterations], axis=1),
        ]
        if linear:
            parts.append(result.dual_at_queue)
        return jnp.concatenate(parts, axis=1)

    return pack


def _pack_result(result, linear: bool):
    """Concatenate the result arrays into one int32 download (cached jit)."""
    return _get_pack_result()(result, linear)


def _chunk_dcap(models) -> int:
    """Quantised dual capacity: compiled programs are reused across chunks
    (each new capacity is a new compile).  1024-step
    quantisation: recompiles stay rare while D-proportional work (doubling
    scans, matching, gathers) avoids the up-to-2x power-of-two pad."""
    dcap = max(1, max(len(m.dual_l) for m in models))
    return ((dcap + 1023) // 1024) * 1024 if dcap > 512 else 512


def _chunk_est_bytes(b: int, la_max: int, lb_max: int, dcap: int) -> int:
    """Peak device-memory residents of one chunk: the diagonal-major dirs + skewed
    tensors (~8 bytes per (diag, lane, offset) cell) plus the [B, NE] grids
    and [B, D] dual arrays."""
    ne = la_max * lb_max
    return b * ((la_max + lb_max + 8) * (la_max + 128) * 8
                + ne * 24 + dcap * 48)


@dataclass
class _Prepared:
    """A chunk packed and uploaded, ready to solve (the pipeline boundary:
    everything before this is host/filter work, everything after is the
    device subgradient loop + result download)."""

    chunk: list
    models: list
    batch: object
    la_max: int
    lb_max: int
    las: np.ndarray
    lbs: np.ndarray
    b: int
    bp: int
    go: int
    ge: int
    scan_steps: int
    e_cap: int
    n_dev: int
    est_bytes: int = 0
    #: (``_get_unpack_model`` key, packed buffer shape) of the one-device
    #: upload, None for the multi-device raw upload
    upload: tuple = None


def _solve_models(store, chunk, models, params: Parameters,
                  la_max: int, lb_max: int, las, lbs) -> Iterator[PairResult]:
    b = len(chunk)
    dcap = _chunk_dcap(models)
    # memory guard for long pairs (16S-scale; the 6 GB gate was sized for a
    # 16 GB device and is not measured on the GPU)
    if b > 1 and _chunk_est_bytes(b, la_max, lb_max, dcap) > 6_000_000_000:
        mid = b // 2
        yield from _solve_models(store, chunk[:mid], models[:mid], params,
                                 la_max, lb_max, las[:mid], lbs[:mid])
        yield from _solve_models(store, chunk[mid:], models[mid:], params,
                                 la_max, lb_max, las[mid:], lbs[mid:])
        return
    prep = _pack_models(store, chunk, models, params, la_max, lb_max,
                        las, lbs, dcap)
    yield from _run_packed(prep, store, params)


def _pack_models(store, chunk, models, params: Parameters,
                 la_max: int, lb_max: int, las, lbs, dcap: int) -> _Prepared:
    import jax
    import jax.numpy as jnp

    from lara_tpu.solver import device_solver
    from lara_tpu.utils import timing

    b = len(chunk)
    go, ge = int(params.gap_open_int), int(params.gap_extend_int)
    ne = la_max * lb_max

    n_dev = len(jax.local_devices())  # sharding is per-host (mesh.pair_mesh)
    bp = 1 << (max(b, n_dev if (n_dev > 1 and b > 1) else 1) - 1).bit_length()

    pack_timer = timing.phase("model packing (host)")
    pack_timer.__enter__()
    raw_path = n_dev > 1  # multi-device sharding uploads raw arrays
    # the dense [B, LA, LB] seq-score grid is only materialised on the host
    # for the raw path: packed uploads rebuild it on device from the
    # sequences (at 16S batch width the grid is ~300 MB -- filling and
    # shipping it dominated the packing phase)
    seq_score = np.zeros((bp, la_max, lb_max), np.int32) if raw_path else None
    active = np.zeros((bp, la_max, lb_max), bool)
    dual_l = np.zeros((bp, dcap), np.int32)
    dual_m = np.zeros((bp, dcap), np.int32)
    sscore = np.zeros((bp, dcap), np.int32)
    # rev rows must stay involutions (identity on padding) -- solver invariant
    rev = np.broadcast_to(np.arange(dcap, dtype=np.int32), (bp, dcap)).copy()
    dvalid = np.zeros((bp, dcap), bool)
    qrank = np.broadcast_to(np.arange(dcap, dtype=np.int32), (bp, dcap)).copy()
    las = np.concatenate([las, np.ones(bp - b, np.int32)])
    lbs = np.concatenate([lbs, np.ones(bp - b, np.int32)])
    max_run = 1
    max_edges = 1
    for k, m in enumerate(models):
        if raw_path:
            seq_score[k, : m.la, : m.lb] = m.seq_score
        active[k, : m.la, : m.lb] = m.active
        d = len(m.dual_l)
        if d:
            # remap flat edge ids from (la, lb) to padded (la_max, lb_max)
            a_ids, b_ids = np.divmod(m.dual_l, m.lb)
            dual_l[k, :d] = a_ids * lb_max + b_ids
            a_ids, b_ids = np.divmod(m.dual_m, m.lb)
            dual_m[k, :d] = a_ids * lb_max + b_ids
            sscore[k, :d] = m.sscore
            rev[k, :d] = m.rev
            dvalid[k, :d] = True
            qrank[k, :d][m.qperm] = np.arange(d, dtype=np.int32)
            counts = np.unique(m.dual_l, return_counts=True)[1]
            max_run = max(max_run, int(counts.max()))
            max_edges = max(max_edges, len(counts))
    # run-scan depth: 2**steps must cover the longest per-edge run; round up
    # to even so compiled programs are reused across similar chunks
    steps_needed = max(1, (max_run - 1).bit_length())
    scan_steps = min(steps_needed + (steps_needed & 1),
                     max(1, (dcap - 1).bit_length()))
    # compacted run-start capacity for the matmul grid placement (256-step
    # quantisation: programs are reused across chunks while the placement
    # matmul operands avoid the up-to-2x power-of-two pad)
    e_cap = min(dcap, max(256, _round_up(max_edges, 256)))
    # the one-hot placement operands are [B, LA, E] + [B, E, 2*LB] f32; for
    # dense long-pair batches they outgrow their use -- fall back to the
    # scatter path beyond ~256 MB of operand traffic (a gate sized on the
    # earlier accelerator; not measured on the GPU)
    if 4 * bp * e_cap * (la_max + 2 * lb_max) > 256 * 1024 * 1024:
        e_cap = 0

    if n_dev == 1:
        # single packed upload: one transfer instead of one per array
        bits = active.reshape(bp, ne // 32, 32).astype(np.uint32)
        words = (bits << np.arange(32, dtype=np.uint32)).sum(
            axis=2, dtype=np.uint32).view(np.int32)
        nd = np.array([len(m.dual_l) for m in models] + [0] * (bp - b),
                      np.int32)
        submat_f = jnp.asarray(np.asarray(params.score_matrix),
                               dtype=jnp.float32)
        nk = submat_f.shape[0]
        # both packed layouts drop the dense seq-score grid (recomputed on
        # device from the sequences); "packed15" additionally shares one
        # word per (l, m) / (rev, qrank) pair when flat ids fit 15 bits
        mode = "packed15" if (ne <= 32768 and dcap <= 32768) else "packed_seq"
        sa = np.full((bp, la_max), nk - 1, np.int32)
        sb = np.full((bp, lb_max), nk - 1, np.int32)
        scale_bits = np.zeros(bp, np.float32)
        for k, m in enumerate(models):
            sa[k, : m.la] = m.seq_a
            sb[k, : m.lb] = m.seq_b
            scale_bits[k] = np.float32(m.scale)
        if mode == "packed15":
            dual_cols = [(dual_l << 15) | dual_m, sscore, (rev << 15) | qrank]
        else:
            dual_cols = [dual_l, dual_m, sscore, rev, qrank]
        buf = np.concatenate(
            [words, *dual_cols, sa, sb,
             scale_bits.view(np.int32)[:, None], las[:, None],
             lbs[:, None], nd[:, None]], axis=1)
        upload = ((ne, dcap, la_max, lb_max, mode, nk), buf.shape)
        batch = _get_unpack_model(*upload[0])(jnp.asarray(buf), submat_f)
    else:
        upload = None
        batch = device_solver.BatchModel(
            seq_score=jnp.asarray(seq_score.reshape(bp, ne)),
            active=jnp.asarray(active.reshape(bp, ne)),
            dual_l=jnp.asarray(dual_l),
            dual_m=jnp.asarray(dual_m),
            sscore=jnp.asarray(sscore),
            rev=jnp.asarray(rev),
            dvalid=jnp.asarray(dvalid),
            qrank=jnp.asarray(qrank),
            la=jnp.asarray(las),
            lb=jnp.asarray(lbs),
        )
    jax.block_until_ready(batch.seq_score)  # uploads accounted to packing
    pack_timer.__exit__(None, None, None)
    return _Prepared(chunk=chunk, models=models, batch=batch,
                     la_max=la_max, lb_max=lb_max, las=las, lbs=lbs,
                     b=b, bp=bp, go=go, ge=ge, scan_steps=scan_steps,
                     e_cap=e_cap, n_dev=n_dev,
                     est_bytes=_chunk_est_bytes(bp, la_max, lb_max, dcap),
                     upload=upload)


def _run_solve(prep: _Prepared, params: Parameters):
    """Pipeline middle stage: the device dispatch loop only (no download).
    Returns the on-device :class:`BatchResult`."""
    from lara_tpu.solver import device_solver
    from lara_tpu.utils import timing

    la_max, lb_max = prep.la_max, prep.lb_max
    with timing.phase("subgradient solve (device)"):
        if prep.n_dev > 1 and prep.b > 1:
            from lara_tpu.parallel import mesh as mesh_mod

            return mesh_mod.solve_batch_sharded(
                prep.batch, prep.go, prep.ge,
                np.float32(params.step_size_factor),
                la_max, lb_max, int(params.num_iterations),
                int(params.max_nondecr_iterations), int(params.matching),
                scan_steps=prep.scan_steps, e_cap=prep.e_cap,
            )
        return device_solver.solve_batch(
            prep.batch, prep.go, prep.ge,
            np.float32(params.step_size_factor),
            la_max, lb_max, int(params.num_iterations),
            int(params.max_nondecr_iterations), int(params.matching),
            scan_steps=prep.scan_steps, e_cap=prep.e_cap,
        )


def _download_post(result, prep: _Prepared, params: Parameters
                   ) -> List[PairResult]:
    """Pipeline back half: blocking result download + host postprocess.
    Runs on the download thread so the device tail sync + transfer of chunk
    k overlaps chunk k+1's solve dispatches."""
    from lara_tpu.utils import timing

    with timing.phase("result download (host)"):
        packed, s = _download_result(result, params)
    return [
        _postprocess_lane(packed, s, k, (ia, ib), prep.models[k], params,
                          int(prep.las[k]))
        for k, (ia, ib) in enumerate(prep.chunk)
    ]


def _run_packed(prep: _Prepared, store, params: Parameters
                ) -> Iterator[PairResult]:
    yield from _download_post(_run_solve(prep, params), prep, params)


def _download_result(result, params: Parameters):
    """One packed transfer instead of six per-array downloads;
    returns (packed ndarray, partner column count)."""
    linear = bool(params.library_score_is_linear)
    s = result.best_partner.shape[1]
    return np.asarray(_pack_result(result, linear)), s


def _postprocess_lane(packed, s: int, k: int, pair, model,
                      params: Parameters, la_len: int) -> PairResult:
    """One lane of a packed result download -> PairResult."""
    ia, ib = pair
    linear = bool(params.library_score_is_linear)
    pk = packed[k, :s][:la_len]
    a_pos = np.nonzero(pk >= 0)[0]
    best_nlines = int(packed[k, 2 * s])
    assert len(a_pos) == best_nlines, "partner/count mismatch"
    lines = [(int(a), int(pk[a])) for a in a_pos]
    matched = packed[k, s:2 * s].astype(bool)[a_pos]
    dual_q = packed[k, 2 * s + 4:][: len(model.dual_l)] if linear else None
    columns = _structure_columns(model, params, lines, matched, dual_q)
    if ia > ib:
        columns = [(y, x, w) for (x, y, w) in columns]
    best_lower = int(packed[k, 2 * s + 1])
    return PairResult(
        seq_indices=(min(ia, ib), max(ia, ib)),
        columns=columns,
        score=best_lower,
        iterations=int(packed[k, 2 * s + 3]),
        best_upper=int(packed[k, 2 * s + 2]),
        best_lower=best_lower,
    )


def _structure_columns(model, params: Parameters, lines, matched, dual_q):
    """``getStructureLines`` (``lagrange.hpp:437-487``) from device outputs."""
    if not params.library_score_is_linear:
        return [
            (int(a), int(b), (500 if m else 0) + 500)
            for (a, b), m in zip(lines, matched)
        ]

    # linear mode: per-edge top profits at the last queue-visible duals
    ne = model.la * model.lb
    mpp = np.full(ne, -int(INFINITY), np.int64)
    if len(model.dual_l):
        np.maximum.at(mpp, model.dual_l, model.sscore.astype(np.int64) + dual_q)
    tops_all = model.seq_score.reshape(-1).astype(np.int64) + np.maximum(mpp, 0)
    active_flat = model.active.reshape(-1)
    tops_active = tops_all[active_flat]
    min_score = int(tops_active.min())
    max_score = int(tops_active.max())
    if max_score > min_score:
        div = np.float32(
            np.float32(1.0)
            * np.float32(params.library_score_max - params.library_score_min)
            / np.float32(max_score - min_score)
        )
    else:
        div = np.float32(0.0)
    columns = []
    for (a, b), m in zip(lines, matched):
        top_val = int(tops_all[a * model.lb + b])
        val = int(np.int32(np.trunc(np.float32(int(m) * (top_val - min_score)) * div)))
        columns.append((int(a), int(b), params.library_score_min + val))
    return columns
