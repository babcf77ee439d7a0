"""Device-time breakdown of one warm solve, from a ``jax.profiler`` trace.

    python benchmark/trace_phases.py [--workload trna|16s] [--out DIR]

Runs the workload once to warm up (compiles), then once more inside
``jax.profiler.trace`` and reduces the trace's GPU plane:

* busy time = the union of kernel intervals on the device's streams, and
  the idle share of the traced window (first to last kernel);
* device time per named scope of the solver's iteration body
  (``dp_traceback``, ``greedy_matching``; every other kernel counts as
  ``other``): a kernel's scope is read from its own name or, for XLA's
  fused kernels, from the ``op_name`` metadata of the same-named
  instruction in the compiled ``solve_batch_chunk`` program;
* the kernels with the most device time.

Workloads: ``trna`` = ``bench.make_family(n=16)`` (120 pairs, 72 nt, 500
iterations); ``16s`` = ``bench.make_long_family(n=8, length=1530)`` (28
pairs) cut to one 125-iteration dispatch per batch, which keeps the trace
small and runs the same compiled programs as the full solve.  Needs a GPU;
the summary goes to stdout and ``<out>/trace_<workload>.json``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import tempfile
import time
from collections import defaultdict

SCOPES = ("dp_traceback", "greedy_matching")
#: kernel-name fragments that identify a scope by themselves
KERNEL_SCOPES = {"gotoh_wavefront": "dp_traceback"}


def _texts(event):
    out = [event.name]
    for _name, value in event.stats:
        if isinstance(value, str):
            out.append(value)
    return out


def _kernel_name(instruction: str) -> str:
    """HLO instruction name -> the GPU kernel name XLA gives it."""
    return re.sub(r"[.\-]", "_", instruction)


def scopes_from_hlo(hlo_text: str) -> dict:
    """{kernel name: scope} for the instructions of a compiled program whose
    ``op_name`` metadata lies in one of :data:`SCOPES`."""
    out = {}
    pattern = re.compile(r'%([\w.\-]+) = .*op_name="([^"]*)"')
    for line in hlo_text.splitlines():
        match = pattern.search(line)
        if not match:
            continue
        for scope in SCOPES:
            if f"/{scope}/" in match.group(2):
                out[_kernel_name(match.group(1))] = scope
    return out


def _scope_in(texts):
    for text in texts:
        for frag, scope in KERNEL_SCOPES.items():
            if frag in text:
                return scope
        for scope in SCOPES:
            if f"/{scope}/" in text or text.endswith(f"/{scope}"):
                return scope
    return None


def reduce_trace(path: str, hlo_scopes=None, top: int = 15) -> dict:
    """Per-device busy/idle and per-scope device time of an xplane.pb;
    ``hlo_scopes`` is :func:`scopes_from_hlo` of the solver program."""
    from jax.profiler import ProfileData

    hlo_scopes = hlo_scopes or {}
    data = ProfileData.from_file(path)
    devices = {}
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        # op metadata lines (e.g. "XLA Ops") name HLO ops with their scope
        scope_of = {}
        streams = []
        lines = {}
        for line in plane.lines:
            events = list(line.events)
            lines[line.name] = len(events)
            if line.name.startswith("Stream"):
                streams.append(events)
                continue
            for ev in events:
                scope = _scope_in(_texts(ev))
                if scope:
                    scope_of[ev.name] = scope
        intervals = []
        by_scope = defaultdict(int)
        by_kernel = defaultdict(int)
        for events in streams:
            for ev in events:
                texts = _texts(ev)
                scope = _scope_in(texts) or next(
                    (scope_of[t] for t in texts if t in scope_of), None) \
                    or next((hlo_scopes[_kernel_name(t)] for t in texts
                             if _kernel_name(t) in hlo_scopes), "other")
                by_scope[scope] += ev.duration_ns
                by_kernel[ev.name[:80]] += ev.duration_ns
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
        intervals.sort()
        busy = 0
        end = None
        for (s, e) in intervals:
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        window = (intervals[-1][1] - intervals[0][0]) if intervals else 0
        sample = streams[0][:3] if streams else []
        devices[plane.name] = {
            "lines": lines,
            "sample_event_stats": [
                {"name": ev.name, **{k: str(v)[:120] for k, v in ev.stats}}
                for ev in sample],
            "kernels": len(intervals),
            "window_s": window / 1e9,
            "busy_s": busy / 1e9,
            "idle_share": 1 - busy / window if window else None,
            "scope_s": {k: v / 1e9 for k, v in sorted(by_scope.items())},
            "top_kernels_s": {k: v / 1e9 for k, v in sorted(
                by_kernel.items(), key=lambda kv: -kv[1])[:top]},
        }
    return devices


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", choices=("trna", "16s"), default="trna")
    parser.add_argument("--out", default="chiprun_out")
    args = parser.parse_args()

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import jax

    import bench
    from lara_tpu.app import enumerate_pairs
    from lara_tpu.params import Parameters
    from lara_tpu.solver import device_driver, device_solver

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"needs a GPU, JAX found {dev.platform!r}")
    # compile afresh: a persistent-cache hit returns the executable of an
    # earlier build, whose op metadata (the scopes read below) may be stale
    jax.config.update("jax_enable_compilation_cache", False)
    if args.workload == "trna":
        store = bench.make_family(n=16)
        params = Parameters(in_file="<trace>")
    else:
        store = bench.make_long_family(n=8, length=1530)
        params = Parameters(in_file="<trace>", num_iterations=125)
    pairs = enumerate_pairs(store)
    calls = []
    solve_chunk = device_solver.solve_batch_chunk

    def recording(*args, **kwargs):
        if not calls:  # the program's avals, before the carry is donated
            calls.append(jax.tree.map(
                lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype)
                if isinstance(x, jax.Array) else x, (args, kwargs)))
        return solve_chunk(*args, **kwargs)

    device_solver.solve_batch_chunk = recording
    try:
        list(device_driver.solve_all(store, pairs, params))  # warm
    finally:
        device_solver.solve_batch_chunk = solve_chunk
    call_args, call_kwargs = calls[0]
    hlo_scopes = scopes_from_hlo(
        solve_chunk.lower(*call_args, **call_kwargs).compile().as_text())
    trace_dir = tempfile.mkdtemp(prefix="trace_")
    t0 = time.perf_counter()
    with jax.profiler.trace(trace_dir):
        results = list(device_driver.solve_all(store, pairs, params))
    wall = time.perf_counter() - t0
    path = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                     recursive=True)[0]
    summary = {
        "workload": args.workload,
        "device_kind": dev.device_kind,
        "pairs": len(pairs),
        "iterations": sum(r.iterations for r in results),
        "traced_wall_s": wall,
        "hlo_instructions_scoped": len(hlo_scopes),
        "devices": reduce_trace(path, hlo_scopes),
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"trace_{args.workload}.json"),
              "w") as handle:
        json.dump(summary, handle, indent=1)
    print(json.dumps(summary, indent=1))


if __name__ == "__main__":
    main()
