"""Proximal operator library — pure-functional, jit/vmap/shard-compatible.

accelerator-native re-design of the reference operator library
(``proxmin/operators.py``). Semantics match operator by
operator (same signatures, same relative/absolute threshold convention via
``_step_gamma``), with two deliberate differences:

* **No in-place mutation.** The reference mutates ``X`` in place
  (e.g. ``operators.py:29,37,44``); JAX arrays are immutable, so every
  operator here returns a new array. All solvers in this package thread the
  result through functional state, and XLA's buffer donation recovers the
  in-place memory behavior under jit.
* **``prox_components`` is fixed.** The reference version is broken (it
  refers to an undefined ``prox_list`` name, ``operators.py:94-101`` —
  ``NameError`` if ever called). The version here implements the documented
  behavior.

Every operator is elementwise (or a cheap reduction), so XLA fuses it into
the surrounding matmul epilogues with no extra round trip through device
memory; the fused NMF kernels in ``proxmin_tpu.ops`` call them inside the
kernel body.
"""

import functools

import jax.numpy as jnp

from .special import lambertw_exp

__all__ = [
    "prox_id",
    "prox_zero",
    "prox_plus",
    "prox_unity",
    "prox_unity_plus",
    "prox_min",
    "prox_max",
    "prox_components",
    "prox_hard",
    "prox_hard_plus",
    "prox_soft",
    "prox_soft_plus",
    "prox_max_entropy",
    "AlternatingProjections",
    "get_thresh",
]


#### CAUTION ####
def _step_gamma(step, gamma):
    """Scale a continuous penalty parameter by the algorithm step size.

    Every proximal operator for a function with a continuous parameter,
    e.g. ``gamma * ||x||_1``, needs to rescale that parameter by the step
    size of the algorithm (reference semantics: ``operators.py:4-14``).
    """
    return gamma * step


def get_thresh(step, thresh, type):
    """Resolve the relative-vs-absolute threshold convention.

    ``type == 'relative'``: the penalty is expressed in units of the
    function value -> multiply by the step size. ``type == 'absolute'``:
    expressed in units of the variable ``X`` -> used as-is.
    """
    if type not in ("relative", "absolute"):
        raise ValueError(f"type must be 'relative' or 'absolute', got {type!r}")
    if type == "relative":
        return _step_gamma(step, thresh)
    return thresh


#################


def prox_id(X, step):
    """Identity proximal operator."""
    return X


def prox_zero(X, step):
    """Proximal operator projecting onto zero."""
    return jnp.zeros_like(X)


def prox_plus(X, step):
    """Projection onto the non-negative orthant."""
    return jnp.maximum(X, 0)


def prox_unity(X, step, axis=0):
    """Projection onto sum=1 along an axis (rescaling)."""
    return X / jnp.sum(X, axis=axis, keepdims=True)


def prox_unity_plus(X, step, axis=0):
    """Non-negative projection onto sum=1 along an axis."""
    return prox_unity(prox_plus(X, step), step, axis=axis)


def prox_min(X, step, thresh=0, type="relative"):
    """Projection onto numbers above ``thresh`` (floor)."""
    thresh_ = get_thresh(step, thresh, type)
    return jnp.maximum(X, thresh_)


def prox_max(X, step, thresh=0, type="relative"):
    """Projection onto numbers below ``thresh`` (ceiling)."""
    thresh_ = get_thresh(step, thresh, type)
    return jnp.minimum(X, thresh_)


def prox_components(X, step, prox=None, axis=0):
    """Split ``X`` along ``axis`` and apply a prox to each chunk.

    ``prox`` can be a single callable or a list with one entry per chunk.
    (Fixed version of the reference's broken ``prox_components``,
    ``operators.py:87-103``.)
    """
    K = X.shape[axis]
    if not isinstance(prox, (list, tuple)):
        prox = [prox] * K
    if len(prox) != K:
        raise ValueError(f"need {K} prox operators along axis {axis}, got {len(prox)}")
    prox = [p if p is not None else prox_id for p in prox]

    if axis == 0:
        Pk = [prox[k](X[k], step) for k in range(K)]
    elif axis == 1:
        Pk = [prox[k](X[:, k], step) for k in range(K)]
    else:
        raise NotImplementedError("prox_components supports axis 0 or 1")
    return jnp.stack(Pk, axis=axis)


#### Regularization functions below ####


def prox_hard(X, step, thresh=0, type="relative"):
    """Hard thresholding: ``X`` if ``|X| >= thresh``, otherwise 0."""
    thresh_ = get_thresh(step, thresh, type)
    return jnp.where(jnp.abs(X) < thresh_, jnp.zeros_like(X), X)


def prox_hard_plus(X, step, thresh=0, type="relative"):
    """Hard thresholding then projection onto non-negative numbers."""
    return prox_plus(prox_hard(X, step, thresh=thresh, type=type), step)


def prox_soft(X, step, thresh=0, type="relative"):
    """Soft thresholding (L1 prox): ``sign(X) * max(|X| - thresh, 0)``."""
    thresh_ = get_thresh(step, thresh, type)
    return jnp.sign(X) * jnp.maximum(jnp.abs(X) - thresh_, 0)


def prox_soft_plus(X, step, thresh=0, type="relative"):
    """Soft thresholding then projection onto non-negative numbers."""
    return prox_plus(prox_soft(X, step, thresh=thresh, type=type), step)


def prox_max_entropy(X, step, gamma=1, type="relative"):
    """Proximal operator for maximum entropy regularization.

    ``g(x) = gamma * sum_i x_i ln(x_i)`` has the analytic prox
    ``gamma_ * W(exp(X/gamma_ - 1) / gamma_)`` with W the Lambert function,
    applied where ``X > 0`` (reference semantics: ``operators.py:163-184``).

    Implemented via :func:`proxmin_tpu.special.lambertw_exp` on
    ``t = X/gamma_ - 1 - log(gamma_)`` so it never overflows ``exp`` and
    stays a fixed-iteration elementwise kernel (jit-friendly).
    """
    gamma_ = get_thresh(step, gamma, type)
    t = X / gamma_ - 1.0 - jnp.log(gamma_)
    w = gamma_ * lambertw_exp(t)
    return jnp.where(X > 0, w.astype(X.dtype), X)


class AlternatingProjections:
    """Combine several proximal operators as alternating projections (POCS).

    Applies the operator list in reverse order (first one last, as expected
    from a sequence of ops), ``repeat`` times. Functional: returns the new
    array. Jittable as long as every member operator is.
    """

    def __init__(self, prox_list=None, repeat=1):
        self.operators = []
        self.repeat = repeat
        if prox_list is not None:
            self.operators += list(prox_list)

    def __call__(self, X, step):
        for _ in range(self.repeat):
            for prox in self.operators[::-1]:
                X = prox(X, step)
        return X

    def find(self, cls):
        """Index of the first operator that is (or wraps via partial) ``cls``."""
        for i, prox in enumerate(self.operators):
            if isinstance(prox, functools.partial):
                if prox.func is cls:
                    return i
            elif prox is cls:
                return i
        return -1

    # AlternatingProjections instances close over static operator lists, so
    # they hash/compare by identity — fine as jit-static arguments.


# Separable-prox markers. The scaled proximal problem
# ``min_z g(z) + (1/(2 alpha)) (z - x)^T diag(Psi) (z - x)`` decomposes per
# element into ``prox_{g_i}`` with step ``alpha / Psi_i`` — its exact
# closed form, used by ``adaprox(separable_prox=...)`` instead of the
# prox sub-iteration loop (arXiv:1910.10094 Alg. 1). Validity depends on
# what the operator's ``step`` argument MEANS, so each operator carries a
# ``separable_when(kwargs) -> bool`` predicate over its bound keywords:
#
# * fixed separable constraint sets (the step is ignored; per-element
#   projection is metric-independent): always valid — prox_id, prox_zero,
#   prox_plus; prox_min/prox_max only with ``type="absolute"`` or
#   ``thresh=0`` (their "relative" threshold scales the CONSTRAINT SET by
#   the step, which differs between the sub-loop's scalar gamma and the
#   per-element alpha/Psi_i).
# * step-scaled penalties (``g = thresh * |z|`` etc., threshold
#   proportional to the step): valid with ``type="relative"`` —
#   prox_soft, prox_soft_plus, prox_max_entropy. With "absolute" the
#   operator is a fixed nonlinear map, not the prox of a step-scaled
#   function, and the sub-loop's fixed point differs structurally.
# * prox_hard/prox_hard_plus are excluded outright: L0's nonconvex fixed
#   points need the iteration's semantics.

def _sep_always(kw):
    return True


def _sep_fixed_interval(kw):
    if kw.get("type", "relative") == "absolute":
        return True
    t = kw.get("thresh", 0)
    try:
        return float(t) == 0.0
    except (TypeError, ValueError):
        return False  # array thresholds: be conservative


def _sep_scaled_penalty(kw):
    return kw.get("type", "relative") == "relative"


for _p in (prox_id, prox_zero, prox_plus):
    _p.separable_when = _sep_always
for _p in (prox_min, prox_max):
    _p.separable_when = _sep_fixed_interval
for _p in (prox_soft, prox_soft_plus, prox_max_entropy):
    _p.separable_when = _sep_scaled_penalty
del _p
