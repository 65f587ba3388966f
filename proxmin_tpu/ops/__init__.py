"""Hand-written Pallas kernels for the hot paths (NVIDIA GPUs, through
Triton).

* ``fused_nmf_pgm_step`` — a whole PGM iteration (S-side) in one pass over
  the pixel data, emitting the *next* iteration's Gram so the Lipschitz
  recursion stays exact. Drives ``proxmin_tpu.nmf.nmf_pgm_fused``.
* ``fused_nmf_adaprox_step`` — the proximal-Adam sibling. Drives
  ``proxmin_tpu.nmf.nmf_adaprox_fused``.

Both are parity-tested against the jnp reference path in Pallas's
interpreter; ``engine='auto'`` routes a solve to them only on a CUDA GPU
and only where they measured faster than XLA's code for the plain step.
"""

from .nmf_kernels import fused_nmf_adaprox_step, fused_nmf_pgm_step  # noqa: F401

__all__ = ["fused_nmf_pgm_step", "fused_nmf_adaprox_step"]
