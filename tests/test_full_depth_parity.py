"""Full-depth (500-iteration) device/mirror parity at 300 nt.

Round-2 verdict: the >=300 nt parity gates only ran at truncated iteration
budgets; late-trajectory divergence would pass them.  The golden artifact
``tests/golden/parity_300nt_full.json`` pins the scalar mirror's full-depth
result on the slowest-converging bench pair (500 iterations, no convergence).
The device run is slow on CPU (the fused loop at 320x320 for 500
iterations), so it is gated behind ``LARA_SLOW=1``; ``chip_smoke.py``
runs the same comparison on the GPU.
"""

import json
import os

import pytest


def _load_golden():
    path = os.path.join(os.path.dirname(__file__), "golden",
                        "parity_300nt_full.json")
    with open(path) as fh:
        return json.load(fh)


def test_golden_artifact_sane():
    g = _load_golden()
    assert g["iterations_run"] == 500, "must be a full-depth, non-converged run"
    assert len(g["columns"]) >= 250
    assert g["best_upper"] >= g["best_lower"]


@pytest.mark.skipif(not os.environ.get("LARA_SLOW"),
                    reason="full-depth 300nt device run (set LARA_SLOW=1)")
def test_full_depth_device_matches_mirror():
    import bench
    from lara_tpu.app import _apply_platform_env
    from lara_tpu.params import Parameters
    from lara_tpu.solver import device_driver

    _apply_platform_env()
    g = _load_golden()
    ia, ib = g["seq_indices"]
    store = bench.make_long_family(n=8, length=300, seed=31, mutations=12)
    params = Parameters(in_file="<bench>")
    res = list(device_driver.solve_all(store, [(ia, ib)], params))[0]
    assert res.iterations == g["iterations_run"]
    assert res.best_lower == g["best_lower"]
    assert res.best_upper == g["best_upper"]
    assert [list(c) for c in res.columns] == [list(c) for c in g["columns"]]


@pytest.mark.skipif(not os.environ.get("LARA_SLOW"),
                    reason="full-depth 16S mirror run (set LARA_SLOW=1)")
def test_full_depth_16s_native_matches_mirror():
    """Native C++ baseline vs NumPy mirror at 16S scale, FULL depth.

    Closes the chain behind bench.py's 16S gate: bench.py pins the 500-iter
    device trajectory against the native baseline on the GPU; this test
    pins that same native baseline against the executable-spec mirror at the
    same scale and depth (the mirror is minutes-slow, hence LARA_SLOW).
    """
    import bench
    from lara_tpu.native import baseline as native_baseline
    from lara_tpu.params import Parameters
    from lara_tpu.solver import reference_driver

    try:
        native_baseline._load()
    except Exception:
        pytest.skip("no native toolchain")
    store = bench.make_long_family(n=2, length=1530, seed=47)
    params = Parameters(in_file="<bench>")
    nat = native_baseline.solve_pair(store[0], store[1], params, (0, 1))
    mir = reference_driver.solve_pair(store[0], store[1], params, (0, 1))
    assert nat.iterations == mir.iterations
    assert nat.best_lower == mir.best_lower
    assert nat.best_upper == mir.best_upper
    assert nat.columns == mir.columns
