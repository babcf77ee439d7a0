"""lara-tpu: an RNA sequence-structure alignment engine for the GPU.

A from-scratch JAX/XLA re-design of the capabilities of LaRA 2
(Lagrangian Relaxed structural Alignment; reference C++ implementation under
/root/reference): all-pairs pairwise sequence-structure alignment by
Lagrangian relaxation with subgradient ascent, emitting T-Coffee libraries /
MAFFT pair files.

Architecture (batched on the device, not a port):
* pairwise problems are batched along a device axis and solved inside one
  ``lax.while_loop`` -- per-lane convergence masks replace the reference's
  OpenMP work stealing + SIMD lanes,
* the per-iteration affine-gap DP runs as an anti-diagonal wavefront (one
  CUDA kernel launch per iteration on the GPU; a skewed ``lax.scan`` on the
  CPU, which is also the reference the kernel must equal),
* priority queues become dense segment-max recomputation over a packed dual
  array; matching runs as a vectorized lookahead loop on device,
* multi-GPU scaling is pure data parallelism over pairs on a
  ``jax.sharding.Mesh``.
"""

__version__ = "0.1.0"
