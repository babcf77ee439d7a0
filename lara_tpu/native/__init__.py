"""Native (C++ and CUDA) runtime components.

The reference is C++ end to end; lara-tpu keeps the device compute path in
JAX/XLA and implements the serial host-side hot spots natively:

* ``blossom`` -- exact maximum-weight matching (the ``-m 0`` escape hatch,
  LEMON-equivalent; ``/root/reference/src/matching.hpp:201-238``),
* ``gotoh_wavefront`` (CUDA) -- the per-iteration DP + traceback kernel on
  the GPU, called through ``jax.ffi`` (:mod:`lara_tpu.ops.gotoh_cuda`).

Shared libraries are compiled on first use with the system toolchain
(``g++``, or ``nvcc`` for ``.cu`` sources) into the git-ignored ``lib/``
directory.  Host-library consumers fall back to pure-Python paths when no
compiler is available (mirroring the reference's optional-LEMON gating,
``matching.hpp:48-54``); the CUDA kernel has no fallback.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import threading

_SRC_DIR = os.path.join(os.path.dirname(__file__), "src")
_LIB_DIR = os.path.join(os.path.dirname(__file__), "lib")
_BUILD_LOCK = threading.Lock()
_CUDA_HOME = "/usr/local/cuda"


class NativeBuildError(RuntimeError):
    pass


def _build(name: str, sources: list, cmd_of) -> str:
    """Build ``lib<name>.so`` from ``sources`` unless an up-to-date build
    exists; ``cmd_of(output_path)`` gives the compiler command.  The output
    is written under a temporary name and renamed, so a concurrent loader
    never sees a half-written library."""
    target = os.path.join(_LIB_DIR, f"lib{name}.so")
    with _BUILD_LOCK:
        if os.path.exists(target) and all(
            os.path.getmtime(target) >= os.path.getmtime(src)
            for src in sources
        ):
            return target
        os.makedirs(_LIB_DIR, exist_ok=True)
        tmp = f"{target}.{os.getpid()}.tmp"
        cmd = cmd_of(tmp)
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        except (OSError, subprocess.TimeoutExpired) as exc:
            raise NativeBuildError(f"cannot build {name}: {exc}") from exc
        if proc.returncode != 0:
            raise NativeBuildError(
                f"{os.path.basename(cmd[0])} failed for {name}:\n"
                f"{proc.stderr[-4000:]}"
            )
        os.replace(tmp, target)
        return target


def shared_library(name: str, extra_sources: tuple = ()) -> str:
    """Path to the compiled shared library for ``src/<name>.cpp`` (plus any
    ``extra_sources`` linked into the same object), building it if any source
    is newer or no build exists yet."""
    sources = [os.path.join(_SRC_DIR, f"{name}.cpp")] + [
        os.path.join(_SRC_DIR, f"{extra}.cpp") for extra in extra_sources
    ]
    return _build(name, sources, lambda out: [
        "g++", "-std=c++17", "-O2", "-fPIC", "-shared", "-o", out, *sources])


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default
    install location."""
    return shutil.which("nvcc") or os.path.join(_CUDA_HOME, "bin", "nvcc")


def cuda_library(name: str) -> str:
    """Path to the compiled shared library for ``src/<name>.cu``, built for
    Hopper (``sm_90a``) against XLA's FFI headers; raises
    :class:`NativeBuildError` when ``nvcc`` is missing or fails."""
    import jax.ffi

    source = os.path.join(_SRC_DIR, f"{name}.cu")
    nvcc = nvcc_path()
    if not os.path.exists(nvcc):
        raise NativeBuildError(f"cannot build {name}: nvcc not found")
    return _build(name, [source], lambda out: [
        nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-I", jax.ffi.include_dir(), "-o", out, source])
