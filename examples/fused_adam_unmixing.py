"""Proximal-Adam unmixing on the fused single-pass engine, with
checkpointed continuation.

The reference's adaprox runs a Python loop with per-block prox
sub-iterations (``proxmin/algorithms.py:248-423``). This package
offers three executions of the same adam recursion:

1. XLA driver with the sub-iteration prox loop (reference semantics);
2. XLA driver with the separable closed-form prox
   (``separable_prox="auto"`` — the exact limit of the sub-loop);
3. the fused Pallas engine (``engine="pallas"``): gradient, both moment
   EMAs, bias correction and the closed-form prox in ONE pass over the
   pixel data per iteration; ``moment_dtype=jnp.bfloat16`` halves the
   Adam-state memory traffic with in-register casts. The fused engine
   compiles for CUDA GPUs only; elsewhere this demo runs the same calls on
   the XLA engine.

The demo fits a K=4 spectral unmixing problem, then CONTINUES the solve
through the fused engine's M/V warm-start — the moments round-trip
exactly like the XLA driver's (reference warm-start analogue:
``algorithms.py:347-359``).

Run: PYTHONPATH=. python examples/fused_adam_unmixing.py [N_pixels]
"""

import sys

import numpy as np
import jax.numpy as jnp

import proxmin_tpu as pt
from proxmin_tpu.ops.nmf_kernels import cuda_available


def make_problem(N, C=6, K=4, seed=11):
    rng = np.random.default_rng(seed)
    # smooth Gaussian-bump spectra + non-negative abundances
    grid = np.linspace(0, 1, C)[:, None]
    centers = rng.random((1, K))
    A_true = np.exp(-((grid - centers) ** 2) / 0.05).astype(np.float32)
    S_true = rng.gamma(2.0, 1.0, (K, N)).astype(np.float32)
    Y = (A_true @ S_true
         + 0.01 * rng.standard_normal((C, N))).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)
    return Y, A0, S0


def main(N=20000):
    engine = "pallas" if cuda_available() else "xla"
    Y, A0, S0 = make_problem(N)

    def loss(X):
        return float(pt.nmf.log_likelihood(*map(jnp.asarray, X),
                                           Y=jnp.asarray(Y)))

    loss0 = loss((A0, S0))

    # one call on the fused engine (bf16 moment storage)
    res = pt.nmf.nmf(Y, A0.copy(), S0.copy(), algorithm="adaprox",
                     engine=engine, separable_prox="auto",
                     moment_dtype=jnp.bfloat16, e_rel=0, max_iter=150)
    loss1 = loss(res.x)
    print(f"adam on {engine}: loss {loss0:.1f} -> {loss1:.1f} "
          f"after {res.iterations} iterations")
    assert loss1 < 0.1 * loss0

    # continuation: warm-start from the returned moments (what a
    # preemption/checkpoint boundary looks like)
    res2 = pt.nmf.nmf(np.asarray(Y), np.array(res.x[0]),
                      np.array(res.x[1]), algorithm="adaprox",
                      engine=engine, separable_prox="auto",
                      moment_dtype=jnp.bfloat16, e_rel=0, max_iter=150,
                      M=res.M, V=res.V)
    loss2 = loss(res2.x)
    print(f"continued:  loss {loss1:.1f} -> {loss2:.1f}")
    assert loss2 < loss1

    # the XLA separable driver solves the same recursion (engine parity
    # at fixed low iteration counts; see tests/test_pallas_ops.py)
    res_x = pt.nmf.nmf(Y, A0.copy(), S0.copy(), algorithm="adaprox",
                       separable_prox="auto", e_rel=0, max_iter=150)
    loss_x = float(pt.nmf.log_likelihood(*res_x.x, Y=jnp.asarray(Y)))
    print(f"xla driver: loss {loss0:.1f} -> {loss_x:.1f}")
    return res2


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 20000)
