"""Multi-chip execution: data-parallel sharding of the pair batch.

The reference's only parallelism is shared-memory threads + SIMD lanes over
independent pairwise problems (SURVEY §2); there is nothing to communicate
during a solve.  The multi-GPU scaling story is therefore pure data
parallelism over a 1-D device mesh (every card reaches every other at the
same rate, so the mesh follows the algorithm alone):

* the batch dimension of :class:`~lara_tpu.solver.device_solver.BatchModel`
  is sharded over the ``pairs`` axis with ``jax.shard_map``,
* each device runs its *own* ``while_loop`` over its shard -- no cross-device
  synchronisation at all, so a device whose lanes converge early goes idle
  instead of lock-stepping with the slowest shard (unlike a pjit'd global
  loop, whose ``any(active)`` condition would all-reduce every iteration),
* per-pair results are gathered to the host and merged into the canonically
  sorted library, preserving the reference's determinism guarantee
  (``io.hpp:372``, SURVEY §3.5).

Multi-host runs extend this transparently: ``jax.distributed.initialize``
+ the same mesh over each host's devices; each host feeds its addressable
shard.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from lara_tpu.solver import device_solver


def distributed_init() -> bool:
    """Initialise ``jax.distributed`` for multi-host runs when the standard
    coordinator environment is present (JAX_COORDINATOR_ADDRESS, with
    JAX_NUM_PROCESSES and JAX_PROCESS_ID).  Safe to call unconditionally: single
    -host runs return False and proceed on local devices only.

    The reference's only cross-worker state is the merged, canonically
    sorted library (``io.hpp:372``); with pure data parallelism over pairs
    each host solves its own shard and process 0 gathers the per-pair
    results (``gather_results``) before writing.
    """
    import os

    if os.environ.get("LARA_NO_DISTRIBUTED"):
        return False
    if not (os.environ.get("JAX_COORDINATOR_ADDRESS")
            or os.environ.get("COORDINATOR_ADDRESS")):
        return False
    coordinator = os.environ.get("JAX_COORDINATOR_ADDRESS") or \
        os.environ.get("COORDINATOR_ADDRESS")
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=int(os.environ.get("JAX_NUM_PROCESSES", "0")) or None,
        process_id=int(os.environ.get("JAX_PROCESS_ID", "0"))
        if os.environ.get("JAX_PROCESS_ID") else None,
    )
    return jax.process_count() > 1


def process_pair_shard(pairs, process_id: int = None, process_count: int = None):
    """Split the all-pairs work list across hosts (strided so every host
    gets a mix of long and short pairs from the length-sorted list)."""
    pid = jax.process_index() if process_id is None else process_id
    pcount = jax.process_count() if process_count is None else process_count
    return [p for k, p in enumerate(pairs) if k % pcount == pid]


def gather_results(local_entries, mesh: "Mesh" = None):
    """All-gather the per-pair result entries across hosts via one padded
    device all_gather, then return every host's entries (each
    host can then merge into the canonically sorted library, preserving the
    reference's determinism guarantee regardless of scheduling).

    ``local_entries`` is a list of (ia, ib, score, columns) tuples with
    ragged column lists; they are packed into one int32 payload per host and
    padded to the global maximum before the gather.
    """
    import jax.numpy as jnp

    if jax.process_count() == 1:
        return list(local_entries)

    # pack: [n_entries, 4 + 3*MAXCOL] int32 rows
    rows = []
    for (ia, ib, score, columns) in local_entries:
        flat = [v for col in columns for v in col]
        rows.append([ia, ib, int(score), len(columns)] + flat)
    max_len = max((len(r) for r in rows), default=4)
    # global max row length and count via a tiny all_gather
    from jax.experimental import multihost_utils

    dims = multihost_utils.process_allgather(
        jnp.asarray([len(rows), max_len], jnp.int32))
    g_rows = int(np.max(np.asarray(dims)[:, 0]))
    g_len = int(np.max(np.asarray(dims)[:, 1]))
    payload = np.full((g_rows, g_len + 1), -1, np.int32)
    for r, row in enumerate(rows):
        payload[r, 0] = len(row)
        payload[r, 1 : 1 + len(row)] = row
    gathered = np.asarray(multihost_utils.process_allgather(
        jnp.asarray(payload)))
    out = []
    for host_block in gathered.reshape(-1, g_rows, g_len + 1):
        for row in host_block:
            n = int(row[0])
            if n < 4:
                continue
            vals = row[1 : 1 + n]
            ia, ib, score, ncol = int(vals[0]), int(vals[1]), int(vals[2]), int(vals[3])
            cols = [tuple(int(x) for x in vals[4 + 3 * c : 7 + 3 * c])
                    for c in range(ncol)]
            out.append((ia, ib, score, cols))
    return out


def pair_mesh(devices=None) -> Mesh:
    """1-D mesh over this process's addressable devices.

    Local, not global, on purpose: each host solves an independent shard of
    the pair list (there is no cross-pair communication in the solve), so a
    global mesh would only force every host to lock-step compile and feed
    globally-shaped arrays.  Cross-host merging happens once, at the end,
    in :func:`gather_results`."""
    devices = list(devices if devices is not None else jax.local_devices())
    return Mesh(np.asarray(devices), ("pairs",))


@functools.lru_cache(maxsize=32)
def _sharded_solver(mesh: Mesh, la_max: int, lb_max: int, num_iterations: int,
                    max_nondecr: int, lookahead: int, scan_steps: int = 0,
                    e_cap: int = 0):
    """Build the sharded solve function for one static configuration."""

    def impl(model, go, ge, step0):
        return device_solver.solve_batch_traced(
            model, go, ge, step0, la_max, lb_max, num_iterations,
            max_nondecr, lookahead, scan_steps, e_cap,
        )

    shard = jax.shard_map(
        impl,
        mesh=mesh,
        in_specs=(
            device_solver.BatchModel(
                seq_score=P("pairs"), active=P("pairs"),
                dual_l=P("pairs"), dual_m=P("pairs"), sscore=P("pairs"),
                rev=P("pairs"), dvalid=P("pairs"), qrank=P("pairs"),
                la=P("pairs"), lb=P("pairs"),
            ),
            P(), P(), P(),
        ),
        out_specs=device_solver.BatchResult(
            best_upper=P("pairs"), best_lower=P("pairs"),
            best_partner=P("pairs"), best_nlines=P("pairs"),
            best_matched=P("pairs"), dual_at_queue=P("pairs"),
            iterations=P("pairs"),
        ),
        check_vma=False,
    )
    return jax.jit(shard)


def solve_batch_sharded(
    model: device_solver.BatchModel,
    go: int,
    ge: int,
    step0,
    la_max: int,
    lb_max: int,
    num_iterations: int,
    max_nondecr: int,
    lookahead: int,
    mesh: Optional[Mesh] = None,
    scan_steps: int = 0,
    e_cap: int = 0,
) -> device_solver.BatchResult:
    """Shard the batch over all devices; pads the batch to a multiple of the
    mesh size with dummy lanes (la=lb=1, empty models) that converge in one
    iteration."""
    mesh = mesh if mesh is not None else pair_mesh()
    n_dev = mesh.devices.size
    b = model.seq_score.shape[0]
    pad = (-b) % n_dev
    if pad:
        model = pad_batch(model, pad)
    fn = _sharded_solver(mesh, la_max, lb_max, num_iterations, max_nondecr,
                         lookahead, scan_steps, e_cap)
    import jax.numpy as jnp

    result = fn(model, jnp.int32(go), jnp.int32(ge), jnp.float32(step0))
    if pad:
        result = jax.tree.map(lambda x: x[:b], result)
    return result


def pad_batch(model: device_solver.BatchModel, pad: int) -> device_solver.BatchModel:
    """Append `pad` trivial lanes (1x1 problems, no interactions)."""
    import jax.numpy as jnp

    def ext(arr, fill=0):
        pad_block = jnp.full((pad,) + arr.shape[1:], fill, arr.dtype)
        return jnp.concatenate([arr, pad_block], axis=0)

    d = model.qrank.shape[1]
    qpad = jnp.broadcast_to(jnp.arange(d, dtype=jnp.int32), (pad, d))
    return device_solver.BatchModel(
        seq_score=ext(model.seq_score),
        active=ext(model.active, False),
        dual_l=ext(model.dual_l),
        dual_m=ext(model.dual_m),
        sscore=ext(model.sscore),
        # identity rows keep the rev-involution invariant on padded lanes
        rev=jnp.concatenate([jnp.asarray(model.rev), qpad], axis=0),
        dvalid=ext(model.dvalid, False),
        qrank=jnp.concatenate([jnp.asarray(model.qrank), qpad], axis=0),
        la=ext(model.la, 1),
        lb=ext(model.lb, 1),
    )
