"""Regenerate ``tests/golden/parity_300nt_full.json`` from the NumPy mirror.

Run when mirror semantics intentionally change:

    LARA_SLOW=1 python tests/golden/make_full_depth_golden.py

and commit the refreshed artifact together with the semantic change —
``bench.py`` and ``chip_smoke.py`` re-assert it fatally on the GPU, and
``tests/test_full_depth_parity.py`` re-asserts it under ``LARA_SLOW=1``.
The pair (0, 2) is the slowest-converging pair of the bench 300nt family
(500 iterations, bounds never meet).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

OUT = os.path.join(os.path.dirname(__file__), "parity_300nt_full.json")


def main() -> None:
    if not os.environ.get("LARA_SLOW"):
        raise SystemExit("set LARA_SLOW=1 to confirm the minutes-long mirror run")
    import bench
    from lara_tpu.params import Parameters
    from lara_tpu.solver import reference_driver

    store = bench.make_long_family(n=8, length=300, seed=31, mutations=12)
    params = Parameters(in_file="<bench>")
    ia, ib = 0, 2
    # driver pair order: longer sequence first (subgradient_solver.hpp:115-120)
    rec_a, rec_b = store[ia], store[ib]
    if len(rec_b.sequence) > len(rec_a.sequence):
        rec_a, rec_b = rec_b, rec_a
    t0 = time.perf_counter()
    res = reference_driver.solve_pair(rec_a, rec_b, params, (ia, ib))
    secs = time.perf_counter() - t0
    golden = {
        "pair_spec": "make_long_family(n=8, length=300, seed=31, mutations=12)",
        "seq_indices": [ia, ib],
        "num_iterations": int(params.num_iterations),
        "iterations_run": int(res.iterations),
        "best_lower": int(res.best_lower),
        "best_upper": int(res.best_upper),
        "columns": [list(c) for c in res.columns],
        "mirror_seconds": round(secs, 1),
    }
    with open(OUT, "w") as fh:
        json.dump(golden, fh)
        fh.write("\n")
    print(f"wrote {OUT} ({res.iterations} iters, {secs:.1f}s)")


if __name__ == "__main__":
    main()
