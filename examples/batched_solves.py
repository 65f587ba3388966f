"""Batched solving: thousands of independent problems in ONE compiled call.

The reference solves one problem per Python loop
(``proxmin/algorithms.py``); on an accelerator, many *small*
independent solves leave the device idle. ``proxmin_tpu.functional`` exposes
the solver cores as pure functions, so ``jax.vmap`` turns a batch of
problems into a single device program: the ``lax.while_loop`` runs until
every lane converges, masking finished lanes, and each lane's result is
exactly its individual solve.

Demo: fit a disk-constrained quadratic per "source" for a whole catalog —
e.g. thousands of per-object calibration problems from one survey tile.

Run: PYTHONPATH=. python examples/batched_solves.py [batch]
"""

import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

from proxmin_tpu.functional import make_pgm_solver


def prox_disk(x, step, r=0.5):
    nrm = jnp.sqrt(jnp.sum(x ** 2))
    return jnp.where(nrm > r, x * (r / nrm), x)


def main(batch=4096):
    rng = np.random.default_rng(7)
    dim = 8
    centers = jnp.asarray(rng.normal(size=(batch, dim)), jnp.float32)
    # per-problem curvature -> per-problem step sizes and iteration counts
    curv = jnp.asarray(rng.uniform(0.5, 2.0, size=(batch, dim)), jnp.float32)

    def solve_one(x0, c, h):
        def grad(x):
            return h * (x - c)

        step = 1.0 / jnp.max(h)
        return make_pgm_solver(grad, step, prox=prox_disk, accelerated=True,
                               e_rel=1e-6, max_iter=500)(x0)

    solve_all = jax.jit(jax.vmap(solve_one))

    x0s = jnp.zeros((batch, dim), jnp.float32)
    # compile
    xs, its, convs, _ = jax.tree_util.tree_map(
        jax.block_until_ready, solve_all(x0s, centers, curv)
    )
    t0 = time.perf_counter()
    xs, its, convs, _ = solve_all(x0s, centers, curv)
    np.asarray(xs)
    dt = time.perf_counter() - t0

    its = np.asarray(its)
    print(f"{batch} solves in one call: {dt * 1e3:.1f} ms "
          f"({dt / batch * 1e6:.1f} us/solve)")
    print(f"iterations per lane: min {its.min()}, median "
          f"{int(np.median(its))}, max {its.max()}; "
          f"{int(np.asarray(convs).all(axis=-1).sum())}/{batch} converged")

    # spot-check three lanes against individual solves. (Batched
    # reductions can round differently from the single-problem layout in
    # f32, so the stopping iteration may shift near the tolerance
    # boundary; the solutions agree. Pick e_rel with the dtype in mind —
    # 1e-8 in f32 sits at rounding noise and a lane can oscillate at
    # 1 ulp without ever crossing it. On the f64 CPU test backend the
    # lanes are iteration-exact — see tests/test_functional.py.)
    for i in (0, batch // 2, batch - 1):
        xi, iti, _, _ = jax.jit(solve_one)(x0s[i], centers[i], curv[i])
        np.testing.assert_allclose(np.asarray(xs[i]), np.asarray(xi),
                                   rtol=1e-4, atol=1e-6)
        assert abs(int(its[i]) - int(iti)) <= 2
    print("lane results match individual solves (3 spot checks)")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 4096)
