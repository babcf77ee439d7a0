"""True multi-process distributed run: 2 ``jax.distributed`` processes on
CPU drive the full CLI, exercising ``mesh.process_pair_shard`` (strided host
sharding), ``mesh.gather_results`` (padded cross-host all-gather + unpack)
and the host-0-writes gating in ``app.run``.

The reference merges per-pair results under ``omp critical`` into one
``std::set`` (``subgradient_solver.hpp:289-296``, ``io.hpp:372``); here the
same determinism guarantee must hold across *processes*: the 2-process
merged library must be byte-identical to the single-process run.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from tests.test_device_solver import write_family

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _base_env(n_local_devices: int) -> dict:
    env = dict(os.environ)
    env.pop("JAX_COORDINATOR_ADDRESS", None)
    env.pop("COORDINATOR_ADDRESS", None)
    env.pop("LARA_NO_DISTRIBUTED", None)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={n_local_devices}"
    )
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.mark.slow
def test_two_process_run_matches_single_process(tmp_path):
    family = write_family(tmp_path, n=4, seed=3)

    # --- single-process golden ---
    single_lib = tmp_path / "single.lib"
    env1 = _base_env(2)
    env1["LARA_NO_DISTRIBUTED"] = "1"
    res = subprocess.run(
        [sys.executable, "-m", "lara_tpu", "-i", str(family), "-n", "20",
         "-w", str(single_lib)],
        env=env1, capture_output=True, text=True, timeout=600,
    )
    assert res.returncode == 0, res.stderr[-2000:]

    # --- 2-process distributed run (2 local devices each) ---
    port = _free_port()
    multi_lib = tmp_path / "multi.lib"
    procs = []
    for pid in range(2):
        env = _base_env(2)
        env["JAX_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
        env["JAX_NUM_PROCESSES"] = "2"
        env["JAX_PROCESS_ID"] = str(pid)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "lara_tpu", "-i", str(family), "-n", "20",
             "-v", "1", "-w", str(multi_lib)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        ))
    outs = []
    for proc in procs:
        try:
            out, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            raise
        outs.append((proc.returncode, out, err))
    for rc, _out, err in outs:
        assert rc == 0, err[-2000:]
    # both hosts took a real, non-empty shard of the 6 pairs
    for _rc, _out, err in outs:
        assert "host shard: 3/6 pairs" in err, err[-2000:]

    assert multi_lib.exists()
    assert multi_lib.read_text() == single_lib.read_text()


@pytest.mark.slow
def test_three_process_empty_shards(tmp_path):
    """1 pair over 3 processes: two hosts get EMPTY shards and must still
    participate in the padded all-gather; process 0 writes the identical
    library (the ragged edges of the distributed path)."""
    family = tmp_path / "pair.dbn"
    family.write_text(
        ">a\nGGGCGCAAGCCUUAAGGCGCCC\n(((((((......)))))))..\n"
        ">b\nGGGCGCAAGCCUUCAGGCGCCC\n(((((((......)))))))..\n"
    )

    single_lib = tmp_path / "single.lib"
    env1 = _base_env(1)
    env1["LARA_NO_DISTRIBUTED"] = "1"
    res = subprocess.run(
        [sys.executable, "-m", "lara_tpu", "-i", str(family), "-n", "20",
         "-w", str(single_lib)],
        env=env1, capture_output=True, text=True, timeout=600,
    )
    assert res.returncode == 0, res.stderr[-2000:]

    port = _free_port()
    multi_lib = tmp_path / "multi.lib"
    procs = []
    for pid in range(3):
        env = _base_env(1)
        env["JAX_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
        env["JAX_NUM_PROCESSES"] = "3"
        env["JAX_PROCESS_ID"] = str(pid)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "lara_tpu", "-i", str(family), "-n", "20",
             "-v", "1", "-w", str(multi_lib)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        ))
    outs = []
    for proc in procs:
        try:
            out, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            raise
        outs.append((proc.returncode, out, err))
    for rc, _out, err in outs:
        assert rc == 0, err[-2000:]
    shard_lines = [err for _rc, _out, err in outs]
    assert sum("host shard: 0/1 pairs" in e for e in shard_lines) == 2
    assert sum("host shard: 1/1 pairs" in e for e in shard_lines) == 1
    assert multi_lib.read_text() == single_lib.read_text()
