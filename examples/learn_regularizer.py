"""Learning a regularization strength through a differentiable solve.

The classic bilevel problem: pick the soft-threshold strength ``lam`` so
that the TV/L1-denoised reconstruction best matches held-out truth —
by GRADIENT DESCENT on the outer loss, with gradients flowing through
the inner optimization via implicit differentiation at its fixed point
(``proxmin_tpu.functional.make_differentiable_pgm_solver``; O(1) memory
in the inner iteration count, no unrolling).

The reference (NumPy loops) has no analogue; here the whole bilevel
program — inner solves, implicit VJP, outer updates — is one
differentiable JAX computation.

Run: PYTHONPATH=. python examples/learn_regularizer.py
"""

import numpy as np
import jax
import jax.numpy as jnp

from proxmin_tpu import operators
from proxmin_tpu.functional import make_differentiable_pgm_solver


def main():
    rng = np.random.default_rng(5)
    n = 256
    truth = np.zeros(n)
    truth[rng.integers(0, n, 12)] = rng.normal(0, 1.0, 12)  # sparse spikes
    truth = jnp.asarray(truth)
    y = truth + 0.1 * jnp.asarray(rng.standard_normal(n))

    # inner problem: min 0.5||x - y||^2 + softplus(lam) ||x||_1
    def grad(x, lam):
        return x - y

    def prox(z, step, lam):
        return operators.prox_soft(z, step,
                                   thresh=jax.nn.softplus(lam))

    solve = make_differentiable_pgm_solver(grad, 0.9, prox=prox,
                                           prox_params=True, e_rel=1e-10)

    def outer(lam):
        x, conv = solve(jnp.zeros(n), lam)
        return 0.5 * jnp.sum((x - truth) ** 2)

    outer_grad = jax.jit(jax.value_and_grad(outer))
    lam = jnp.asarray(-4.0)  # softplus(-4) ~ 0.018: far too weak
    l0 = None
    for it in range(150):
        val, g = outer_grad(lam)
        if l0 is None:
            l0 = val
        lam = lam - 1.0 * g
    l1 = outer(lam)
    print(f"outer loss {float(l0):.4f} -> {float(l1):.4f} "
          f"(learned lam = {float(jax.nn.softplus(lam)):.4f})")
    assert float(l1) < 0.5 * float(l0)

    # the learned lam beats both a too-weak and a too-strong choice
    weak = float(outer(jnp.asarray(-4.0)))
    strong = float(outer(jnp.asarray(2.0)))
    assert float(l1) <= min(weak, strong)
    print(f"vs fixed choices: weak {weak:.4f}, strong {strong:.4f} — "
          "learned wins")


if __name__ == "__main__":
    main()
