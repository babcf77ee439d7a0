"""Whole-program flow: the equivalent of ``main`` (``/root/reference/src/lara.cpp:44-61``).

``run(params)``: read inputs -> solve all pairs -> write the library.
Pair enumeration mirrors ``solve`` (``subgradient_solver.hpp:112-120``): every
unordered pair of input records, with the longer sequence first (ties keep
the original index order, per the ``>=`` comparison).
"""

from __future__ import annotations

import os
import time
from typing import List, Tuple

from lara_tpu.io.records import InputStorage
from lara_tpu.io.writers import OutputLibrary
from lara_tpu.params import Parameters
from lara_tpu.utils import log


def enumerate_pairs(store) -> List[Tuple[int, int]]:
    """All index pairs, longer sequence first; processed longest-first
    (the reference's length-sorted work queue, ``io.hpp:352-365``)."""
    pairs = []
    for idx_a in range(len(store) - 1):
        for idx_b in range(idx_a + 1, len(store)):
            if len(store[idx_a].sequence) >= len(store[idx_b].sequence):
                pairs.append((idx_a, idx_b))
            else:
                pairs.append((idx_b, idx_a))
    pairs.sort(key=lambda p: (-len(store[p[0]].sequence), -len(store[p[1]].sequence)))
    return pairs


def load_input(params: Parameters) -> InputStorage:
    log(1, "2) Read input files...")
    return InputStorage(
        in_file=params.in_file,
        ref_file=params.ref_file,
        dotplot_files=params.dotplot_files,
        structure_scoring=params.structure_scoring,
        out_format=params.out_format,
        predict_structures=params.predict,
        threads=int(params.threads),
    )


#: the persistent compilation cache when ``JAX_COMPILATION_CACHE_DIR`` is
#: not set: a fixed directory inside the checkout (git-ignored), so every
#: run from the same checkout finds the programs earlier runs compiled
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def _apply_platform_env() -> None:
    """Persistent compilation cache: the solver is one large XLA program
    (plus the CUDA kernel on a GPU), so CLI processes reuse compiles across
    runs.  ``JAX_COMPILATION_CACHE_DIR``, when set, is honoured by JAX
    itself and no other directory is set here; otherwise the cache goes to
    :data:`DEFAULT_CACHE_DIR`.  The CPU platform (tests) keeps it off.
    The platform itself is JAX's own ``JAX_PLATFORMS``.  Initialises the
    backend (the ``default_backend()`` probe) -- call only after any
    ``jax.distributed.initialize``."""
    import jax

    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    if jax.default_backend() != "cpu":
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)


def run(params: Parameters) -> OutputLibrary:
    from lara_tpu.utils import timing

    time_start = time.monotonic()
    timing.reset()
    # multi-host runs: initialise jax.distributed when a coordinator is
    # configured -- BEFORE anything touches a jax backend
    # (jax.distributed.initialize must precede backend initialisation, which
    # _apply_platform_env's default_backend() probe would trigger)
    multihost = False
    if params.backend == "device":
        try:
            from lara_tpu.parallel import mesh as mesh_mod

            multihost = mesh_mod.distributed_init()
        except Exception as exc:
            log(1, f"   * jax.distributed unavailable ({exc}); single host")
    _apply_platform_env()
    log(1, "1) Parse parameters...")
    with timing.phase("read input"):
        store = load_input(params)
    outlib = OutputLibrary(store, params.out_format)
    pairs = enumerate_pairs(store)

    all_pairs = pairs
    if multihost:
        pairs = mesh_mod.process_pair_shard(pairs)
        log(1, f"   * host shard: {len(pairs)}/{len(all_pairs)} pairs")
    log(1, f"3) Solve {len(pairs)} structural alignments...")

    backend = params.backend
    if backend == "device":
        from lara_tpu.solver import device_driver

    with timing.maybe_trace(), timing.phase("solve"):
        if backend == "reference":
            from lara_tpu.solver import reference_driver

            for (ia, ib) in pairs:
                result = reference_driver.solve_pair(
                    store[ia], store[ib], params, (ia, ib))
                outlib.add_alignment(result.seq_indices, result.columns, result.score)
        else:
            if multihost:
                local = [
                    (r.seq_indices[0], r.seq_indices[1], r.score, r.columns)
                    for r in device_driver.solve_all(store, pairs, params)
                ]
                with timing.phase("gather results (hosts)"):
                    for (ia, ib, score, cols) in mesh_mod.gather_results(local):
                        outlib.add_alignment((ia, ib), cols, score)
            else:
                for result in device_driver.solve_all(store, pairs, params):
                    outlib.add_alignment(
                        result.seq_indices, result.columns, result.score)

    log(1, "4) Write results...")
    import jax as _jax

    if params.prewarm:
        log(0, "   * --prewarm: compilation cache primed for these input "
               "shapes; no output written")
    elif multihost and _jax.process_index() != 0:
        log(1, "   * non-zero host: process 0 writes the library")
    else:
        with timing.phase("write results"):
            outlib.print(params.out_file if params.out_file else None)

    if params.msa_file and not params.prewarm \
            and (not multihost or _jax.process_index() == 0):
        from lara_tpu import msa as msa_mod

        log(1, "5) Assemble multiple alignment...")
        with timing.phase("assemble MSA"):
            alignment = msa_mod.align(msa_mod.from_output_library(outlib))
            with open(params.msa_file, "w") as handle:
                msa_mod.write_fasta(alignment, handle)

    timing.report()
    log(1, f"lara-tpu has run for {time.monotonic() - time_start:.1f} seconds.")
    return outlib
