"""The CUDA DP kernel's wrapper (CPU) and its parity on a GPU (``gpu``).

The kernel itself has no interpret mode, so on the CPU these tests cover
what surrounds it -- operand layout and scratch sizing, output unpacking,
the line list the hybrid backend reads, the choice of implementation by
platform and the error when the library cannot be built -- while the
``gpu``-marked tests compare the compiled kernel with the XLA reference
and the scalar mirror on a card (``JAX_PLATFORMS=cuda python -m pytest -m
gpu``).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lara_tpu import native
from lara_tpu.ops import gotoh, gotoh_cuda
from lara_tpu.types import PSSM_INIT

GO, GE = -6 * 8192, -2 * 8192


def _problem(rng, b, la_max, lb_max):
    la = rng.integers(1, la_max + 1, b).astype(np.int32)
    lb = rng.integers(1, lb_max + 1, b).astype(np.int32)
    la[0], lb[0] = la_max, lb_max
    pssm = (rng.integers(-4, 5, (b, la_max, lb_max)) * GE).astype(np.int32)
    pssm[rng.random(pssm.shape) < 0.2] = PSSM_INIT
    seq = rng.integers(-5000, 5000, (b, la_max, lb_max)).astype(np.int32)
    return pssm, seq, la, lb


@pytest.mark.parametrize("la_max, lb_max, in_smem", [
    (96, 96, True),        # tRNA bucket: the direction map stays on chip
    (320, 320, True),      # ~300 nt bucket: still fits (217 KB)
    (384, 384, False),
    (1536, 1536, False),   # 16S bucket: 4.7 MB per lane in device memory
])
def test_kernel_operands_layout_and_scratch(la_max, lb_max, in_smem):
    b = 3
    pssm = np.zeros((b, la_max * lb_max), np.int32)  # flat, as the solver has it
    seq = np.zeros((b, la_max * lb_max), np.int32)
    la = np.array([la_max, 1, 2])
    lb = np.array([lb_max, 2, 1])
    ops, results = gotoh_cuda.kernel_operands(
        pssm, la, lb, np.int32(GO), np.int32(GE), la_max, lb_max,
        seq_scores=seq)
    assert [x.shape for x in ops] == [(b, la_max, lb_max),
                                      (b, la_max * lb_max), (b,), (b,), (2,)]
    assert all(x.dtype == jnp.int32 for x in ops)
    assert ops[4].tolist() == [GO, GE]
    assert gotoh_cuda.dirs_in_smem(la_max, lb_max) is in_smem
    partner, scalars, scratch = results
    assert partner.shape == (b, la_max) and partner.dtype == jnp.int32
    assert scalars.shape == (b, 4) and scalars.dtype == jnp.int32
    want = (1,) if in_smem else (b, (la_max + lb_max + 1) * (la_max + 1))
    assert scratch.shape == want and scratch.dtype == jnp.uint8


def test_kernel_operands_without_seq_scores():
    ops, _ = gotoh_cuda.kernel_operands(
        np.zeros((2, 4, 5), np.int32), np.array([4, 3]), np.array([5, 2]),
        GO, GE, 4, 5)
    assert ops[1].shape == (1,)  # placeholder: the kernel skips the sum


def test_unpack_and_lines_match_xla_traceback():
    """Kernel-shaped outputs (the XLA reference's partner map and scalars)
    unpack to the reference's Traceback, lines included."""
    rng = np.random.default_rng(5)
    la_max, lb_max = 14, 11
    pssm, seq, la, lb = _problem(rng, 6, la_max, lb_max)
    ref = gotoh.align_pssm_batch(pssm, la, lb, GO, GE, la_max, lb_max)
    seq_part = gotoh.seq_part_dense(ref.partner, seq, lb_max)
    scalars = jnp.stack([ref.upper, ref.gap_score, ref.n_lines, seq_part],
                        axis=1)
    tb = gotoh_cuda.unpack(ref.partner, scalars, lb_max, emit_lines=True,
                           has_seq=True)
    for field in ("upper", "lines", "n_lines", "gap_score", "partner"):
        np.testing.assert_array_equal(np.asarray(getattr(tb, field)),
                                      np.asarray(getattr(ref, field)))
    np.testing.assert_array_equal(np.asarray(tb.seq_part),
                                  np.asarray(seq_part))
    bare = gotoh_cuda.unpack(ref.partner, scalars, lb_max, emit_lines=False,
                             has_seq=False)
    assert bare.lines.shape == (6, 0, 2) and bare.seq_part is None


@pytest.mark.parametrize("backend, want", [("gpu", True), ("cpu", False)])
def test_implementation_choice_by_platform(monkeypatch, backend, want):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert gotoh_cuda.use_cuda() is want


def test_align_on_cpu_is_the_xla_reference():
    rng = np.random.default_rng(8)
    pssm, seq, la, lb = _problem(rng, 4, 9, 12)
    tb = gotoh_cuda.align(pssm, la, lb, GO, GE, 9, 12, seq_scores=seq)
    ref = gotoh.align_pssm_batch(pssm, la, lb, GO, GE, 9, 12)
    np.testing.assert_array_equal(np.asarray(tb.partner),
                                  np.asarray(ref.partner))
    want = [sum(int(seq[k, a, p]) for a, p in enumerate(np.asarray(
        ref.partner[k])) if p >= 0) for k in range(4)]
    np.testing.assert_array_equal(np.asarray(tb.seq_part), want)


def test_align_on_gpu_calls_the_kernel(monkeypatch):
    calls = []

    def fake_kernel(*args, **kwargs):
        calls.append(kwargs)
        return "kernel"

    monkeypatch.setattr(gotoh_cuda, "use_cuda", lambda: True)
    monkeypatch.setattr(gotoh_cuda, "align_pssm_batch_cuda", fake_kernel)
    out = gotoh_cuda.align(np.zeros((1, 2, 2), np.int32), np.ones(1),
                           np.ones(1), GO, GE, 2, 2, emit_lines=True)
    assert out == "kernel" and calls == [{"seq_scores": None,
                                          "emit_lines": True}]


def test_missing_nvcc_is_an_error(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_LIB_DIR", str(tmp_path))
    monkeypatch.setattr(native, "nvcc_path",
                        lambda: str(tmp_path / "no-such-nvcc"))
    monkeypatch.setattr(gotoh_cuda, "_registered", False)
    with pytest.raises(native.NativeBuildError, match="nvcc not found"):
        gotoh_cuda.register()


def test_failing_nvcc_is_an_error_not_a_fallback(monkeypatch, tmp_path):
    """On a GPU a kernel that cannot be built stops the solve; it never
    falls back to the XLA scan."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'fatal: no sm_90a' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(native, "_LIB_DIR", str(tmp_path / "lib"))
    monkeypatch.setattr(native, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(gotoh_cuda, "_registered", False)
    monkeypatch.setattr(gotoh_cuda, "use_cuda", lambda: True)
    gotoh_cuda.align_pssm_batch_cuda.clear_cache()
    with pytest.raises(native.NativeBuildError, match="no sm_90a"):
        gotoh_cuda.align(np.zeros((1, 3, 3), np.int32), np.array([3]),
                         np.array([3]), GO, GE, 3, 3)
    assert not (tmp_path / "lib" / "libgotoh_wavefront.so").exists()


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("b, la_max, lb_max", [
    (64, 96, 96), (8, 384, 320), (4, 700, 1100)])
def test_cuda_kernel_matches_xla(gpu, b, la_max, lb_max):
    rng = np.random.default_rng(la_max + lb_max)
    pssm, seq, la, lb = _problem(rng, b, la_max, lb_max)
    ker = gotoh_cuda.align_pssm_batch_cuda(pssm, la, lb, GO, GE, la_max,
                                           lb_max, seq_scores=seq,
                                           emit_lines=True)
    ref = gotoh.align_pssm_batch(pssm, la, lb, GO, GE, la_max, lb_max)
    for field in ("upper", "lines", "n_lines", "gap_score", "partner"):
        np.testing.assert_array_equal(np.asarray(getattr(ker, field)),
                                      np.asarray(getattr(ref, field)))
    np.testing.assert_array_equal(
        np.asarray(ker.seq_part),
        np.asarray(gotoh.seq_part_dense(ref.partner, seq, lb_max)))


@pytest.mark.gpu
def test_cuda_solver_matches_mirror(gpu, tmp_path):
    """``app.run`` with the CUDA DP writes the scalar mirror's library on
    conflicting structures (the subgradient + matching path)."""
    from lara_tpu.app import run
    from lara_tpu.params import parse_args

    path = tmp_path / "conflict.dbn"
    path.write_text(
        ">x\nGGGAAAGGGAAACCCAAACCC\n(((...(((...)))...)))\n"
        ">y\nGGGAAAGGGAAACCCAAACCC\n(((...)))...(((...)))\n"
        ">z\nGGGAAAGGGAAACCCAAACC\n((....((....))....))\n")
    libs = []
    for backend in ("device", "reference"):
        out = tmp_path / f"{backend}.lib"
        run(parse_args(["-i", str(path), "-n", "80", "--backend", backend,
                        "-w", str(out)]))
        libs.append(out.read_text())
    assert libs[0] == libs[1]
