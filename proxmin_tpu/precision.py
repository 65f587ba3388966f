"""Matmul-precision policy shared by every solver driver and engine.

On an NVIDIA GPU a float32 matmul may run in reduced precision (TF32
keeps about three decimal digits) unless told otherwise, and that puts a
noise floor on the iterate movement near the reference stopping
tolerances. The reference unmixing-style problem (C=16, K=4, N=512,
``prox_unity_plus`` on A, ``e_rel=1e-4``; ``tests/test_precision.py``)
converges in 1794 iterations on the CPU in f32 — identical to the NumPy
reference's fixed-point rule (reference ``algorithms.py:130-133``). The
public entry points (`pgm`/`adaprox`/`admm`/`sdmm`/`bsdmm`, `nmf`, the
fused engines, the functional makers, the AOT exporters, the sharded
whole-solve) therefore trace their compiled programs under a 'highest'
policy, with the per-dot exceptions below.

This lives in its own module (not ``utils``) so ``linop`` — which
``utils`` imports — can use the policy without a circular import.
"""

import functools

import jax

_MATMUL_PRECISION = "highest"

# Per-dot annotations for the NMF data path (explicit ``precision=``
# always overrides the ambient policy). Measured on an H100
# (chip_smoke.py, phases (d) and (e)):
#
# - The K-axis product ``A @ S`` inside the residual is
#   ABSOLUTE-error-critical: a reduced-precision product rounds A and S
#   themselves, so the residual carries a noise floor ~eps * |A S| that
#   does not decay as the gradient does. At HIGH the unmixing problem
#   above converged in 2021 iterations instead of 1794; at HIGHEST in
#   1794, the CPU count. With K this small its FLOPs cost nothing.
# - Pixel-axis contractions (``D S^T``, ``A^T D``, ``S S^T`` Grams,
#   weighted power-iteration matvecs) are RELATIVE-error ops: their error
#   is proportional to the operand magnitudes, which shrink with the
#   gradient or are covered by the steppers' 0.9 safety margins. They
#   keep the platform DEFAULT: the unmixing problem converged in 1794
#   iterations either way, while HIGHEST made the XLA engine's flagship
#   solves 1.3-1.9x slower (weighted PGM 0.24 -> 0.46 ms/iter).
# - Tiny Grams (K x K, C x K) cost nothing at HIGHEST.
#
# The fused kernels compute every product as exact f32 multiply-adds.
RESIDUAL_PRECISION = jax.lax.Precision.HIGHEST
STREAM_PRECISION = jax.lax.Precision.DEFAULT
TINY_PRECISION = jax.lax.Precision.HIGHEST


def set_matmul_precision(precision):
    """Set the matmul precision the solver drivers trace with.

    ``precision`` is any value accepted by
    ``jax.default_matmul_precision`` ('default' | 'high' | 'highest'),
    or ``None`` to leave JAX's ambient setting untouched (opt back into
    the platform default, e.g. to trade convergence accuracy for
    tensor-core throughput on compute-bound custom problems). Returns the previous
    policy. Changing the policy re-specializes the compiled drivers
    automatically (the precision config participates in the jit cache
    key)."""
    global _MATMUL_PRECISION
    prev = _MATMUL_PRECISION
    _MATMUL_PRECISION = precision
    return prev


class _NullCtx:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def matmul_precision_scope():
    """Context manager applying the solver matmul-precision policy
    (no-op when the policy is ``None``). Entered by every public
    driver/engine around trace + execution; nesting is harmless."""
    if _MATMUL_PRECISION is None:
        return _NullCtx()
    return jax.default_matmul_precision(_MATMUL_PRECISION)


def with_matmul_precision(fn):
    """Decorator: run ``fn`` under :func:`matmul_precision_scope`.
    Applied to the public solver entry points so both tracing and
    dispatch see the policy."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with matmul_precision_scope():
            return fn(*args, **kwargs)

    return wrapper
