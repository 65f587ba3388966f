"""Special functions needed by the proximal operator library.

The reference implementation (``proxmin/operators.py:174``)
relies on ``scipy.special.lambertw`` for the max-entropy prox. There is no
Lambert-W in ``jax.scipy``, so we provide a jit/grad-compatible one here.

Design note: the operators only ever need ``W(exp(t))`` for real ``t``
(the prox argument is ``exp(X/gamma - 1)/gamma``).  Computing ``W(exp(t))``
directly — i.e. solving ``w + log(w) = t`` — avoids overflow of ``exp(t)``
for large ``t`` and keeps everything in vectorized elementwise math with a
fixed iteration count (XLA-friendly: no data-dependent loops).
"""

import jax
import jax.numpy as jnp

__all__ = ["lambertw_exp", "lambertw"]

_NEWTON_ITERS = 24


def lambertw_exp(t):
    """Principal-branch Lambert W of ``exp(t)`` for real ``t``.

    Solves ``w * exp(w) = exp(t)``, i.e. ``w + log(w) = t``, for ``w > 0``.
    Stable for arbitrarily large ``t`` (never materializes ``exp(t)`` when
    it would overflow).

    Uses a log1p-based initial guess followed by a fixed number of Newton
    iterations on ``f(w) = w + log(w) - t`` (monotone and convex in
    ``log w``, so Newton converges globally from our init).
    """
    t = jnp.asarray(t)
    dtype = jnp.result_type(t, jnp.float32)
    t = t.astype(dtype)

    # Initial guess:
    #   t small/negative: w ~= exp(t)           (since w + log w = t, w -> 0)
    #   t large:          w ~= t - log(t)
    # log1p(exp(t)) interpolates well across the whole range; compute it
    # stably with the softplus identity.
    softplus = jnp.where(t > 30.0, t, jnp.log1p(jnp.exp(jnp.minimum(t, 30.0))))
    w = jnp.where(t > 30.0, t - jnp.log(jnp.maximum(t, 1.0)), softplus)
    w = jnp.maximum(w, jnp.finfo(dtype).tiny)

    # Newton on f(w) = w + log(w) - t; f'(w) = 1 + 1/w:
    #   w_next = w * (1 + t - log(w)) / (1 + w)
    # fori_loop (not an unrolled Python loop) so the transcendental body is
    # compiled exactly once — XLA unrolling 24 copies of log() costs seconds
    # of compile time per call site.
    def newton(_, w):
        w = w * (1.0 + t - jnp.log(w)) / (1.0 + w)
        return jnp.maximum(w, jnp.finfo(dtype).tiny)

    return jax.lax.fori_loop(0, _NEWTON_ITERS, newton, w)


def lambertw(z):
    """Principal-branch Lambert W for real ``z >= 0``.

    ``w`` such that ``w * exp(w) = z``. Matches
    ``scipy.special.lambertw(z).real`` on the non-negative real axis.
    """
    z = jnp.asarray(z)
    dtype = jnp.result_type(z, jnp.float32)
    z = z.astype(dtype)
    safe = jnp.maximum(z, jnp.finfo(dtype).tiny)
    w = lambertw_exp(jnp.log(safe))
    return jnp.where(z == 0, jnp.zeros_like(w), w)
