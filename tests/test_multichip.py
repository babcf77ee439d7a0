"""Sharded multi-device execution on the 8-way virtual CPU mesh."""

import numpy as np
import pytest

import jax


def test_virtual_mesh_available():
    assert len(jax.devices()) == 8


def test_sharded_solver_matches_single_device(tmp_path):
    from tests.test_device_solver import run_backend, write_family

    path = write_family(tmp_path, n=5, seed=2)
    # run_backend('device') auto-uses the sharded path with 8 CPU devices;
    # the reference backend is the single-threaded oracle
    ref = run_backend(path, "reference", num_iterations=50)
    dev = run_backend(path, "device", num_iterations=50)
    assert dev == ref


def test_sharded_solver_pads_odd_batches():
    from lara_tpu.parallel import mesh as mesh_mod
    from lara_tpu.solver import device_solver

    b, ne, d = 3, 16, 4  # 3 lanes on an 8-device mesh -> pad to 8
    la = lb = 4
    model = device_solver.BatchModel(
        seq_score=np.zeros((b, ne), np.int32),
        active=np.zeros((b, ne), bool),
        dual_l=np.zeros((b, d), np.int32),
        dual_m=np.zeros((b, d), np.int32),
        sscore=np.zeros((b, d), np.int32),
        rev=np.broadcast_to(np.arange(d, dtype=np.int32), (b, d)).copy(),
        dvalid=np.zeros((b, d), bool),
        qrank=np.broadcast_to(np.arange(d, dtype=np.int32), (b, d)).copy(),
        la=np.full(b, la, np.int32),
        lb=np.full(b, lb, np.int32),
    )
    res = mesh_mod.solve_batch_sharded(
        model, -6 * 8192, -2 * 8192, 1.0, la, lb, 10, 5, 5
    )
    assert res.best_upper.shape == (b,)
    # empty problems converge immediately: all-gap alignment, equal bounds
    assert np.all(np.asarray(res.iterations) == 1)
    assert np.all(np.asarray(res.best_upper) == np.asarray(res.best_lower))


def _run_cli(args):
    from lara_tpu import cli

    rc = cli.main(args)
    assert rc == 0
    return rc


def test_full_cli_8dev_matches_mirror(tmp_path):
    """Drive the REAL CLI entry end-to-end over the
    8-virtual-device mesh and require the written .lib byte-identical to
    the scalar mirror (single-lane semantics)."""
    from tests.test_device_solver import write_family

    path = write_family(tmp_path, n=5, seed=7)
    dev_lib = tmp_path / "dev.lib"
    ref_lib = tmp_path / "ref.lib"
    _run_cli(["-i", path, "-n", "40", "-w", str(dev_lib),
              "--backend", "device"])
    _run_cli(["-i", path, "-n", "40", "-w", str(ref_lib),
              "--backend", "reference"])
    assert dev_lib.read_text() == ref_lib.read_text()


def test_full_cli_fewer_pairs_than_devices(tmp_path):
    """3 pairs on 8 devices: the sharded batch pads lanes AND devices."""
    from tests.test_device_solver import write_family

    path = write_family(tmp_path, n=3, seed=11)  # 3 pairs < 8 devices
    dev_lib = tmp_path / "dev.lib"
    ref_lib = tmp_path / "ref.lib"
    _run_cli(["-i", path, "-n", "40", "-w", str(dev_lib),
              "--backend", "device"])
    _run_cli(["-i", path, "-n", "40", "-w", str(ref_lib),
              "--backend", "reference"])
    assert dev_lib.read_text() == ref_lib.read_text()


def test_process_pair_shard_empty_and_ragged():
    from lara_tpu.parallel import mesh as mesh_mod

    pairs = [(0, 1), (0, 2), (1, 2)]
    # more processes than pairs: trailing processes get EMPTY shards
    shards = [mesh_mod.process_pair_shard(pairs, pid, 5) for pid in range(5)]
    assert shards[3] == [] and shards[4] == []
    # strided, disjoint, complete
    flat = [p for s in shards for p in s]
    assert sorted(flat) == sorted(pairs)
    # non-divisible: 3 pairs over 2 processes -> 2 + 1
    s2 = [mesh_mod.process_pair_shard(pairs, pid, 2) for pid in range(2)]
    assert [len(s) for s in s2] == [2, 1]
