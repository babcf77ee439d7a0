"""The GPU wavefront DP: a CUDA kernel behind the XLA reference's interface.

:func:`align_pssm_batch_cuda` is a drop-in for
:func:`lara_tpu.ops.gotoh.align_pssm_batch` that runs the whole DP forward
pass and traceback of every lane in ONE kernel launch
(``native/src/gotoh_wavefront.cu``): the XLA path is a ``lax.scan`` over
LA+LB+1 anti-diagonals plus a data-dependent traceback ``while_loop``, and
XLA:GPU launches every step of those loops as separate kernels.

What surrounds the kernel stays in Python that CPU tests reach:
:func:`kernel_operands` (input layout, dtypes and the direction-map
scratch), :func:`unpack` (outputs -> :class:`~lara_tpu.ops.gotoh.Traceback`)
and :func:`lines_from_partner` (the ordered line list the hybrid backend
consumes).  :func:`use_cuda` is the one implementation choice: the kernel
on the ``gpu`` platform, the XLA reference elsewhere.  On a GPU a kernel
that cannot be built is an error, never a fallback.
"""

from __future__ import annotations

import functools
import threading

import jax
import jax.numpy as jnp

from lara_tpu.ops import gotoh

I32 = jnp.int32
TARGET = "lara_gotoh_wavefront"

#: dynamic shared memory one thread block may opt into on Hopper (H100 /
#: H200: 227 KB); the kernel re-checks the device's own limit at launch
SMEM_BYTES = 232448

_REGISTER_LOCK = threading.Lock()
_registered = False


def use_cuda() -> bool:
    """The kernel runs where JAX's default backend is a GPU."""
    return jax.default_backend() == "gpu"


def register() -> None:
    """Build (first use) and register the kernel as an XLA FFI target;
    raises :class:`lara_tpu.native.NativeBuildError` when it cannot be
    built."""
    global _registered
    with _REGISTER_LOCK:
        if _registered:
            return
        import ctypes

        from lara_tpu.native import cuda_library

        lib = ctypes.CDLL(cuda_library("gotoh_wavefront"))
        jax.ffi.register_ffi_target(
            TARGET, jax.ffi.pycapsule(lib.LaraGotohWavefront),
            platform="CUDA")
        _registered = True


def dirs_in_smem(la_max: int, lb_max: int) -> bool:
    """Whether one lane's packed direction map ([LA+LB+1, LA+1] bytes) fits
    in shared memory beside the three rotating M/H/V diagonals."""
    width = la_max + 1
    return 9 * 4 * width + (la_max + lb_max + 1) * width <= SMEM_BYTES


def kernel_operands(pssm, la, lb, go, ge, la_max: int, lb_max: int,
                    seq_scores=None):
    """The kernel's operands and result shapes.

    Inputs are row-major as the solver builds them (no skew, no padding):
    ``pssm`` [B, LA, LB] int32, ``seq`` [B, LA*LB] int32 (a one-element
    placeholder when no seq-score sum is wanted), ``la``/``lb`` [B] int32,
    ``gaps`` = (go, ge).  Results: ``partner`` [B, LA], ``scalars`` [B, 4]
    = (upper, gap_score, n_lines, seq_part), and the direction-map scratch:
    [B, (LA+LB+1)*(LA+1)] bytes in device memory when a lane's map does not
    fit shared memory, a one-byte placeholder otherwise.
    """
    b = pssm.shape[0]
    pssm = jnp.asarray(pssm, I32).reshape(b, la_max, lb_max)
    if seq_scores is None:
        seq = jnp.zeros((1,), I32)
    else:
        seq = jnp.asarray(seq_scores, I32).reshape(b, la_max * lb_max)
    gaps = jnp.stack([jnp.asarray(go, I32), jnp.asarray(ge, I32)])
    operands = (pssm, seq, jnp.asarray(la, I32), jnp.asarray(lb, I32), gaps)
    scratch = (1,) if dirs_in_smem(la_max, lb_max) else (
        b, (la_max + lb_max + 1) * (la_max + 1))
    results = (jax.ShapeDtypeStruct((b, la_max), I32),
               jax.ShapeDtypeStruct((b, 4), I32),
               jax.ShapeDtypeStruct(scratch, jnp.uint8))
    return operands, results


def lines_from_partner(partner, n_lines, lcap: int):
    """Dense partner map -> ordered [B, LCAP, 2] line list (a ascending,
    -1 padded), the form :func:`lara_tpu.ops.gotoh.traceback` emits."""
    la_max = partner.shape[1]
    valid = partner >= 0
    order = jnp.argsort(~valid, axis=1, stable=True)[:, :lcap]
    lines_a = jnp.take_along_axis(
        jnp.broadcast_to(jnp.arange(la_max, dtype=I32)[None, :],
                         partner.shape), order, axis=1)
    lines_b = jnp.take_along_axis(partner, order, axis=1)
    keep = jnp.arange(lines_a.shape[1], dtype=I32)[None, :] < n_lines[:, None]
    lines = jnp.stack([jnp.where(keep, lines_a, -1),
                       jnp.where(keep, lines_b, -1)], axis=-1)
    return lines


def unpack(partner, scalars, lb_max: int, emit_lines: bool,
           has_seq: bool) -> gotoh.Traceback:
    """Kernel results -> :class:`~lara_tpu.ops.gotoh.Traceback`."""
    b, la_max = partner.shape
    n_lines = scalars[:, 2]
    lcap = min(la_max, lb_max)
    lines = (lines_from_partner(partner, n_lines, lcap) if emit_lines
             else jnp.zeros((b, 0, 2), I32))
    return gotoh.Traceback(
        upper=scalars[:, 0], lines=lines, n_lines=n_lines,
        gap_score=scalars[:, 1], partner=partner,
        seq_part=scalars[:, 3] if has_seq else None)


@functools.partial(jax.jit,
                   static_argnames=("la_max", "lb_max", "emit_lines"))
def align_pssm_batch_cuda(pssm, la, lb, go, ge, la_max: int, lb_max: int,
                          seq_scores=None,
                          emit_lines: bool = False) -> gotoh.Traceback:
    """:func:`lara_tpu.ops.gotoh.align_pssm_batch` as one CUDA launch.

    ``seq_scores`` ([B, LA, LB] or [B, LA*LB] int32) makes the traceback
    also sum the sequence scores of the matched cells (``seq_part``, the
    lower bound's sequence term, ``lagrange.hpp:376-378``).
    ``emit_lines=False`` leaves ``lines`` empty (the fused solver reads the
    dense ``partner`` map only)."""
    register()
    operands, results = kernel_operands(pssm, la, lb, go, ge, la_max, lb_max,
                                        seq_scores)
    partner, scalars, _dirs = jax.ffi.ffi_call(TARGET, results)(*operands)
    return unpack(partner, scalars, lb_max, emit_lines,
                  has_seq=seq_scores is not None)


def align(pssm, la, lb, go, ge, la_max: int, lb_max: int, seq_scores=None,
          emit_lines: bool = False) -> gotoh.Traceback:
    """The DP + traceback the solvers call: the CUDA kernel on a GPU, the
    XLA reference elsewhere.  ``seq_part`` is filled whenever
    ``seq_scores`` is given."""
    if use_cuda():
        return align_pssm_batch_cuda(pssm, la, lb, go, ge, la_max, lb_max,
                                     seq_scores=seq_scores,
                                     emit_lines=emit_lines)
    tb = gotoh.align_pssm_batch(pssm, la, lb, go, ge, la_max, lb_max)
    if seq_scores is not None:
        tb = tb._replace(seq_part=gotoh.seq_part_dense(tb.partner, seq_scores,
                                                       lb_max))
    return tb

