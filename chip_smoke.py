#!/usr/bin/env python3
"""Smoke test of lara-tpu's main path on NVIDIA GPUs.

Drives the batched Lagrangian solver through its normal entry points
(``app.run`` / ``device_driver.solve_all``) at the widths users run, checks
every result by the repository's own references, and prints as its last
line one JSON object::

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

It exits non-zero without that line on any mismatch, when JAX finds no GPU,
or when the ``lara_tpu`` package beside this script is missing.

    python chip_smoke.py               one card, phases 1-5 (below)
    python chip_smoke.py --quick       one card, phases 1-3 only
    python chip_smoke.py --compare-dp  phases 1-5, then the end-to-end solve
                                       time with the CUDA DP kernel against
                                       XLA's plain scan, in both workloads
    python chip_smoke.py --multi       four cards: the sharded path only

Phases (one card):
  1. device line: JAX's platform, device kind and count, and the card's
     name and power limit from nvidia-smi;
  2. compile: build the CUDA kernel library, lower and compile the edge
     filter, the model-unpack program and ``solve_batch_chunk`` at both
     workloads' shapes, print ``compiled.memory_analysis()`` of each;
  3. kernel parity: the CUDA DP kernel against ``gotoh.align_pssm_batch``
     (XLA) at 96x96/B=512 and 1536x1536/B=32, tie-prone int32 PSSMs with
     ragged lengths; every output exactly equal;
  4. tRNA family (``bench.make_family(n=16)``, 120 pairs, 72 nt, 500
     iterations) through ``app.run`` as the CLI builds it: the T-Coffee lib
     byte-equal to the scalar mirror's (``--backend reference``);
  5. 16S batch (``bench.make_long_family(n=8, length=1530)``, 28 pairs,
     500 iterations): 2 lanes full-depth equal to the native C++ oracle,
     plus the 300 nt golden ``tests/golden/parity_300nt_full.json``.

With ``--multi`` (four cards): the tRNA family through ``app.run`` and the
16S batch through ``device_driver.solve_all``, each library byte-equal to
the native C++ oracle's, and every card shown to have done device work.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def fail(message: str) -> None:
    print(f"FAIL: {message}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(message: str) -> None:
    print(message, flush=True)


def import_repo():
    """The lara_tpu package that sits beside this script, or fail."""
    sys.path.insert(0, HERE)
    try:
        import lara_tpu
    except ImportError as exc:
        fail(f"lara_tpu is not beside this script ({exc})")
    where = os.path.dirname(os.path.abspath(lara_tpu.__file__))
    if where != os.path.join(HERE, "lara_tpu"):
        fail(f"lara_tpu imported from {where}, not from {HERE}")
    import bench  # noqa: F401  (the workload generators)


# --------------------------------------------------------------------------
# phase 1
# --------------------------------------------------------------------------

def device_line(expect_count: int = 0):
    import jax

    devices = jax.devices()
    dev = devices[0]
    say(f"device: platform={dev.platform} kind={dev.device_kind} "
        f"count={len(devices)}")
    if dev.platform != "gpu":
        fail(f"JAX found no GPU (platform {dev.platform!r})")
    if expect_count and len(devices) < expect_count:
        fail(f"need {expect_count} GPUs, JAX sees {len(devices)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    say("nvidia-smi name, power.limit:")
    say(smi.stdout.strip() or f"(nvidia-smi failed: {smi.stderr.strip()})")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(devices)}


# --------------------------------------------------------------------------
# workloads
# --------------------------------------------------------------------------

def write_ebpseq(records, path: str) -> None:
    """Records -> the extended-bpseq input format (``io/readers.py``); the
    edge weights are written at full precision, so reading the file back
    gives the same records."""
    lines = [f"## S{k + 1}: {r.name}" for k, r in enumerate(records)]
    for k, rec in enumerate(records):
        lines.append(f"# S{k + 1} M{k + 1}")
        partners: dict = {}
        for (i, j, w) in rec.bpp_edges:
            partners.setdefault(i, []).append(f"{w!r}/{j + 1}")
        for pos, base in enumerate(rec.sequence):
            cell = ",".join(partners.get(pos, [])) or "-"
            lines.append(f"{pos + 1} {base} {cell}")
    with open(path, "w") as handle:
        handle.write("\n".join(lines) + "\n")


def workload_files(tmp: str):
    """(name, ebpseq path) of the tRNA family and the 16S batch."""
    import bench

    trna = os.path.join(tmp, "trna.ebpseq")
    write_ebpseq(bench.make_family(n=16), trna)
    long16s = os.path.join(tmp, "16s.ebpseq")
    write_ebpseq(bench.make_long_family(n=8, length=1530), long16s)
    return [("trna-72nt", trna), ("16S-1530nt", long16s)]


def load(path: str, extra=()):
    from lara_tpu.app import load_input
    from lara_tpu.params import parse_args

    params = parse_args(["-i", path, *extra])
    return load_input(params), params


# --------------------------------------------------------------------------
# phase 2
# --------------------------------------------------------------------------

def _memory(label: str, compiled) -> None:
    mem = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    parts = [f"{f.replace('_size_in_bytes', '')}="
             f"{getattr(mem, f, 0) / 2**20:.1f}MiB" for f in fields]
    say(f"  memory {label}: " + " ".join(parts))


def compile_phase(files) -> None:
    import jax

    from lara_tpu.app import enumerate_pairs
    from lara_tpu.ops import gotoh, gotoh_cuda
    from lara_tpu.solver import device_driver, device_solver
    from lara_tpu.types import f2i

    t0 = time.perf_counter()
    gotoh_cuda.register()
    say(f"  CUDA kernel library built and registered in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, path in files:
        store, params = load(path)
        tasks = device_driver.plan_tasks(store, enumerate_pairs(store))
        kind, la_max, lb_max, chunk = tasks[0][:4]
        assert kind == "chunk", kind
        b = len(chunk)
        say(f"  {name}: {len(tasks)} task(s), first chunk {b} pairs at "
            f"{la_max}x{lb_max}")
        go, ge = int(params.gap_open_int), int(params.gap_extend_int)
        t0 = time.perf_counter()
        filt = gotoh.edge_filter_skewed_words.lower(
            np.full((b, la_max), 4, np.int32), np.full((b, lb_max), 4, np.int32),
            np.zeros(b, np.int32), np.zeros(b, np.int32),
            np.asarray(params.score_matrix), go, ge,
            int(f2i(params.suboptimal_diff)), la_max, lb_max).compile()
        say(f"  compiled edge filter in {time.perf_counter() - t0:.1f} s")
        _memory(f"{name} edge filter", filt)

        models, las, lbs = device_driver._filter_and_build(
            store, chunk, params, la_max, lb_max)
        dcap = device_driver._chunk_dcap(models)
        prep = device_driver._pack_models(store, chunk, models, params,
                                          la_max, lb_max, las, lbs, dcap)
        key, shape = prep.upload
        unpack = device_driver._get_unpack_model(*key).lower(
            jax.ShapeDtypeStruct(shape, np.int32),
            jax.ShapeDtypeStruct((key[-1], key[-1]), np.float32)).compile()
        _memory(f"{name} model unpack ({key[4]}, {shape})", unpack)

        carry = device_solver._init_carry(
            prep.bp, dcap, la_max, np.float32(params.step_size_factor),
            int(params.num_iterations))
        t0 = time.perf_counter()
        solver = device_solver.solve_batch_chunk.lower(
            prep.batch, carry, prep.go, prep.ge, la_max, lb_max, 125,
            int(params.max_nondecr_iterations), int(params.matching),
            prep.scan_steps, prep.e_cap).compile()
        say(f"  compiled solve_batch_chunk (B={prep.bp}, D={dcap}, "
            f"e_cap={prep.e_cap}, scan_steps={prep.scan_steps}) in "
            f"{time.perf_counter() - t0:.1f} s")
        _memory(f"{name} solve_batch_chunk", solver)


# --------------------------------------------------------------------------
# phase 3
# --------------------------------------------------------------------------

def _parity_case(rng, b: int, la_max: int, lb_max: int, go: int, ge: int):
    from lara_tpu.types import PSSM_INIT

    la = rng.integers(max(1, la_max // 3), la_max + 1, b).astype(np.int32)
    lb = rng.integers(max(1, lb_max // 3), lb_max + 1, b).astype(np.int32)
    la[0], lb[0] = la_max, lb_max          # full-width lane
    la[1], lb[1] = 1, lb_max               # degenerate lanes
    la[2], lb[2] = la_max, 1
    # coarse values force ties everywhere; some cells inactive
    pssm = (rng.integers(-4, 5, (b, la_max, lb_max)) * ge).astype(np.int32)
    pssm[rng.random(pssm.shape) < 0.2] = PSSM_INIT
    seq = rng.integers(-5000, 5000, (b, la_max, lb_max)).astype(np.int32)
    return pssm, seq, la, lb


def kernel_parity(go: int, ge: int) -> None:
    import jax

    from lara_tpu.ops import gotoh, gotoh_cuda

    rng = np.random.default_rng(2024)
    for (b, la_max, lb_max) in ((512, 96, 96), (32, 1536, 1536)):
        pssm, seq, la, lb = _parity_case(rng, b, la_max, lb_max, go, ge)
        args = [jax.device_put(x) for x in (pssm, seq, la, lb)]

        def kernel():
            return gotoh_cuda.align_pssm_batch_cuda(
                args[0], args[2], args[3], go, ge, la_max, lb_max,
                seq_scores=args[1], emit_lines=True)

        def xla():
            tb = gotoh.align_pssm_batch(args[0], args[2], args[3], go, ge,
                                        la_max, lb_max)
            return tb._replace(seq_part=gotoh.seq_part_dense(
                tb.partner, args[1], lb_max))

        times = {}
        outs = {}
        for label, fn in (("kernel", kernel), ("xla", xla)):
            jax.block_until_ready(fn())             # compile + warm
            t0 = time.perf_counter()
            outs[label] = jax.block_until_ready(fn())
            times[label] = time.perf_counter() - t0
        for field in ("upper", "partner", "n_lines", "gap_score", "seq_part",
                      "lines"):
            got = np.asarray(getattr(outs["kernel"], field))
            want = np.asarray(getattr(outs["xla"], field))
            if got.shape != want.shape or not np.array_equal(got, want):
                bad = np.argwhere(got != want)[:5] if got.shape == want.shape \
                    else "shape"
                fail(f"DP kernel != XLA at {la_max}x{lb_max} B={b}: "
                     f"{field} differs ({bad})")
        say(f"  DP parity {la_max}x{lb_max} B={b}: exact (one call: kernel "
            f"{times['kernel'] * 1e3:.3f} ms, XLA {times['xla'] * 1e3:.3f} ms)")


# --------------------------------------------------------------------------
# phases 4 and 5
# --------------------------------------------------------------------------

def _phase_times(label: str) -> None:
    from lara_tpu.utils import timing

    parts = ", ".join(f"{k} {v:.3f}" for k, v in timing.snapshot().items())
    say(f"  {label} phases (s): {parts}")


def trna_vs_mirror(path: str, tmp: str) -> None:
    from lara_tpu.app import run
    from lara_tpu.params import parse_args

    dev_lib = os.path.join(tmp, "trna_device.lib")
    ref_lib = os.path.join(tmp, "trna_mirror.lib")
    t0 = time.perf_counter()
    run(parse_args(["-i", path, "-w", dev_lib]))
    say(f"  tRNA device run (app.run, cold) {time.perf_counter() - t0:.3f} s")
    _phase_times("tRNA device")
    t0 = time.perf_counter()
    run(parse_args(["-i", path, "-w", dev_lib]))
    say(f"  tRNA device run (app.run, warm) {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    run(parse_args(["-i", path, "-w", ref_lib, "--backend", "reference"]))
    say(f"  tRNA mirror run {time.perf_counter() - t0:.1f} s")
    with open(dev_lib, "rb") as a, open(ref_lib, "rb") as b:
        dev, ref = a.read(), b.read()
    if dev != ref:
        fail("tRNA T-Coffee lib differs from the scalar mirror's")
    say(f"  tRNA lib byte-equal to the mirror ({len(dev)} bytes)")


def solve(store, params):
    from lara_tpu.app import enumerate_pairs
    from lara_tpu.solver import device_driver
    from lara_tpu.utils import timing

    pairs = enumerate_pairs(store)
    timing.reset()
    t0 = time.perf_counter()
    results = list(device_driver.solve_all(store, pairs, params))
    elapsed = time.perf_counter() - t0
    if len(results) != len(pairs):
        fail(f"{len(results)} results for {len(pairs)} pairs")
    return {r.seq_indices: r for r in results}, elapsed


def long_vs_oracle(path: str) -> None:
    import bench
    from lara_tpu.app import enumerate_pairs
    from lara_tpu.native import baseline
    from lara_tpu.params import Parameters

    store, params = load(path)
    results, elapsed = solve(store, params)
    iters = sum(r.iterations for r in results.values())
    say(f"  16S batch: {len(results)} pairs in {elapsed:.3f} s (cold), "
        f"{iters} iterations")
    _phase_times("16S")
    for (ia, ib) in enumerate_pairs(store)[:2]:
        nat = baseline.solve_pair(store[ia], store[ib], params, (ia, ib))
        dev = results[nat.seq_indices]
        if not bench._full_depth_ok(dev, nat.columns, nat.best_lower,
                                    nat.best_upper, nat.iterations):
            fail(f"16S lane {nat.seq_indices} differs from the native oracle")
        say(f"  16S lane {nat.seq_indices}: full depth equal to the native "
            f"oracle ({dev.iterations} iterations)")

    golden_path = os.path.join(HERE, "tests", "golden",
                               "parity_300nt_full.json")
    with open(golden_path) as handle:
        golden = json.load(handle)
    store300 = bench.make_long_family(n=8, length=300, seed=31, mutations=12)
    results300, elapsed = solve(store300, Parameters(in_file="<smoke>"))
    dev = results300[tuple(golden["seq_indices"])]
    if not bench._full_depth_ok(dev, golden["columns"], golden["best_lower"],
                                golden["best_upper"],
                                golden["iterations_run"]):
        fail("300 nt golden pair differs at full depth")
    say(f"  300 nt golden {tuple(golden['seq_indices'])}: full depth equal "
        f"({dev.iterations} iterations; 28 pairs in {elapsed:.3f} s)")


# --------------------------------------------------------------------------
# --compare-dp
# --------------------------------------------------------------------------

def compare_dp(files) -> None:
    """End-to-end solve time of each workload with the CUDA DP kernel and
    with XLA's plain ``gotoh.align_pssm_batch``, in one process on one card
    (kernel, XLA, kernel).  Each side is warmed up first; the XLA warm-up
    runs 125 iterations, which compiles the same programs."""
    import jax

    from lara_tpu.ops import gotoh_cuda
    from lara_tpu.params import parse_args

    kernel_choice = gotoh_cuda.use_cuda

    def set_dp(use_kernel: bool) -> None:
        gotoh_cuda.use_cuda = kernel_choice if use_kernel else (lambda: False)
        jax.clear_caches()

    try:
        for name, path in files:
            store, params = load(path)
            warm = parse_args(["-i", path, "-n", "125"])
            rows = []
            for use_kernel in (True, False, True):
                set_dp(use_kernel)
                solve(store, warm)
                _, elapsed = solve(store, params)
                label = "kernel" if use_kernel else "xla"
                rows.append(f"{label} {elapsed:.3f} s")
                _phase_times(f"dp-compare {name} {label}")
            say(f"  dp-compare {name} (solve_all, warm, 500 iterations): "
                + ", ".join(rows))
    finally:
        set_dp(True)


# --------------------------------------------------------------------------
# --multi
# --------------------------------------------------------------------------

def _native_lib(store, params) -> str:
    """The T-Coffee lib of the native C++ oracle over all pairs (pairs run
    on host threads; the oracle releases the GIL inside its solve)."""
    from concurrent.futures import ThreadPoolExecutor

    from lara_tpu.app import enumerate_pairs
    from lara_tpu.io.writers import OutputLibrary
    from lara_tpu.native import baseline

    pairs = enumerate_pairs(store)
    with ThreadPoolExecutor(max_workers=min(16, os.cpu_count() or 1)) as pool:
        results = list(pool.map(
            lambda p: baseline.solve_pair(store[p[0]], store[p[1]], params, p),
            pairs))
    lib = OutputLibrary(store, params.out_format)
    for res in results:
        lib.add_alignment(res.seq_indices, res.columns, res.score)
    return lib.to_string()


def multi(files, tmp: str) -> None:
    import jax

    from lara_tpu.app import run
    from lara_tpu.io.writers import OutputLibrary
    from lara_tpu.params import parse_args

    (_, trna), (_, long16s) = files
    dev_lib = os.path.join(tmp, "trna_4gpu.lib")
    t0 = time.perf_counter()
    run(parse_args(["-i", trna, "-w", dev_lib]))
    say(f"  tRNA on {len(jax.devices())} cards (app.run, cold) "
        f"{time.perf_counter() - t0:.3f} s")
    _phase_times("tRNA 4 cards")
    store, params = load(trna)
    with open(dev_lib) as handle:
        if handle.read() != _native_lib(store, params):
            fail("4-card tRNA lib differs from the native oracle's")
    say("  tRNA lib (4 cards) byte-equal to the native oracle")

    store, params = load(long16s)
    results, elapsed = solve(store, params)
    say(f"  16S batch on 4 cards: {len(results)} pairs in {elapsed:.3f} s "
        f"(cold)")
    _phase_times("16S 4 cards")
    lib = OutputLibrary(store, params.out_format)
    for res in results.values():
        lib.add_alignment(res.seq_indices, res.columns, res.score)
    if lib.to_string() != _native_lib(store, params):
        fail("4-card 16S lib differs from the native oracle's")
    say("  16S lib (4 cards) byte-equal to the native oracle")

    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0)
             for d in jax.devices()]
    say("  peak device memory per card (MiB): "
        + ", ".join(f"{p / 2**20:.0f}" for p in peaks))
    if min(peaks) < 64 * 2**20:
        fail("a card did no solver work: the batch did not shard")


# --------------------------------------------------------------------------

def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--multi", action="store_true",
                      help="four cards: the sharded path only")
    mode.add_argument("--quick", action="store_true",
                      help="phases 1-3 only (compile and kernel parity)")
    mode.add_argument("--compare-dp", action="store_true",
                      help="also time the solve with the CUDA DP kernel "
                           "against XLA's plain scan")
    args = parser.parse_args()

    import_repo()
    from lara_tpu.app import _apply_platform_env

    t_start = time.perf_counter()
    say("[1] device")
    device = device_line(expect_count=4 if args.multi else 0)
    _apply_platform_env()  # persistent compile cache
    with tempfile.TemporaryDirectory() as tmp:
        files = workload_files(tmp)
        if args.multi:
            say("[multi] tRNA family and 16S batch on 4 cards")
            multi(files, tmp)
        else:
            from lara_tpu.params import Parameters

            params = Parameters(in_file="<smoke>")
            say("[2] compile and memory")
            compile_phase(files)
            say("[3] DP kernel parity")
            kernel_parity(int(params.gap_open_int), int(params.gap_extend_int))
            if not args.quick:
                say("[4] tRNA family through app.run vs the mirror")
                trna_vs_mirror(files[0][1], tmp)
                say("[5] 16S batch and 300 nt golden at full depth")
                long_vs_oracle(files[1][1])
            if args.compare_dp:
                say("[dp] CUDA DP kernel vs XLA scan, end to end")
                compare_dp(files)
    say(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
