"""Matmul-precision policy tests.

A GPU's reduced-precision f32 matmul puts a noise floor on the iterate
movement near the reference stopping tolerances (on an H100 the
unmixing-style problem below needs 2021 iterations with the residual
product at HIGH against 1794 at HIGHEST, the CPU count). The package
therefore traces every public driver under a 'highest' policy
(``proxmin_tpu/precision.py``). CPU executes f32 matmuls exactly either
way, so these tests verify the POLICY MECHANISM — that the lowered
programs actually carry the precision attribute — which is exactly what
protects the GPU behavior, plus the override API.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import proxmin_tpu as pt
from proxmin_tpu import precision


def _lowered_text(policy):
    """Lower a functional PGM solve (a decorated public entry) under
    the given policy and return the StableHLO text."""
    prev = pt.set_matmul_precision(policy)
    try:
        def grad(a, s):
            return (a @ s.T @ s.T.T * 0 + a, s)  # includes real dots

        def step(a, s, it, grads=None):
            return (jnp.asarray(0.1), jnp.asarray(0.1))

        solve = pt.functional.make_pgm_solver(
            grad, step, prox=None, e_rel=1e-4, max_iter=5)
        a0 = jnp.ones((4, 3), jnp.float32)
        s0 = jnp.ones((5, 3), jnp.float32)
        return jax.jit(solve).lower(a0, s0).as_text()
    finally:
        pt.set_matmul_precision(prev)


def test_default_policy_is_highest():
    assert precision._MATMUL_PRECISION == "highest"


def test_set_matmul_precision_roundtrip():
    prev = pt.set_matmul_precision("high")
    try:
        assert prev == "highest"
        assert precision._MATMUL_PRECISION == "high"
    finally:
        pt.set_matmul_precision(prev)
    assert precision._MATMUL_PRECISION == "highest"


def test_lowered_driver_carries_highest_precision():
    txt = _lowered_text("highest")
    assert "HIGHEST" in txt, (
        "public driver lowering does not carry the HIGHEST matmul "
        "precision — the GPU convergence guarantee is lost"
    )


def test_policy_none_leaves_ambient_default():
    txt = _lowered_text(None)
    assert "HIGHEST" not in txt


def test_nmf_driver_lowering_carries_policy():
    """The nmf() XLA driver path (through solvers.pgm) must lower its
    gradient matmuls with the policy — checked via the jitted driver
    the functional NMF maker builds (same body builders)."""
    solve = pt.functional.make_nmf_solver(e_rel=1e-4, max_iter=5)
    A0 = jnp.ones((4, 3), jnp.float32)
    S0 = jnp.ones((3, 64), jnp.float32)
    Y = jnp.ones((4, 64), jnp.float32)
    txt = jax.jit(solve).lower(A0, S0, Y).as_text()
    assert "HIGHEST" in txt


def test_policy_participates_in_jit_cache_key():
    """Toggling the policy must re-specialize compiled drivers (the
    jax precision config is part of the jit cache key), so a stale
    default-precision executable can never serve a 'highest' call."""
    calls = {"n": 0}

    @jax.jit
    def f(a, b):
        calls["n"] += 1
        return a @ b

    a = jnp.ones((4, 4))
    with precision.matmul_precision_scope():
        f(a, a)
    prev = pt.set_matmul_precision("default")
    try:
        with precision.matmul_precision_scope():
            f(a, a)
    finally:
        pt.set_matmul_precision(prev)
    with precision.matmul_precision_scope():
        f(a, a)
    assert calls["n"] == 2


def test_solvers_match_reference_iterations_on_cpu():
    """The reference-parity anchor for the precision work: the
    unmixing-style problem converges in the SAME iteration count as the
    in-place NumPy math (1794 at this seed — also measured from the
    actual reference implementation), establishing that the framework's
    convergence behavior matches the reference at f32 on an
    exactly-multiplying backend. (On an H100 the same count needs the
    residual product at HIGHEST — chip_smoke.py phase (d).)"""
    from functools import partial

    rng = np.random.default_rng(1000)
    C, K, N = 16, 4, 512
    dt = np.float32
    A_true = rng.random((C, K))
    S_true = rng.random((K, N))
    Y = (A_true @ S_true + 0.02 * rng.standard_normal((C, N))).astype(dt)
    A0 = rng.random((C, K)).astype(dt)
    S0 = rng.random((K, N)).astype(dt)

    # NumPy oracle of the same math
    A, S = A0.copy(), S0.copy()
    it_np = None
    for it in range(5000):
        sA = (1.0 / np.linalg.eigvalsh(S @ S.T)[-1]).astype(dt)
        sS = (1.0 / np.linalg.eigvalsh(A.T @ A)[-1]).astype(dt)
        D = A @ S - Y
        A1 = np.maximum(A - sA * (D @ S.T), 0)
        A1 = A1 / np.maximum(A1.sum(1, keepdims=True), np.finfo(dt).tiny)
        S1 = np.maximum(S - sS * (A.T @ D), 0)
        cA = ((A1 - A) ** 2).sum() <= 1e-8 * (A1 ** 2).sum()
        cS = ((S1 - S) ** 2).sum() <= 1e-8 * (S1 ** 2).sum()
        A, S = A1, S1
        if cA and cS:
            it_np = it + 1
            break
    assert it_np is not None

    res = pt.nmf.nmf(
        jnp.asarray(Y), jnp.asarray(A0), jnp.asarray(S0),
        prox_A=partial(pt.operators.prox_unity_plus, axis=1),
        e_rel=1e-4, max_iter=5000,
    )
    assert all(res.converged)
    # identical math, but a different (batched/fused) reduction order:
    # iteration counts agree to a small neighborhood, not bit-exactly
    assert abs(res.iterations - it_np) <= max(5, int(0.01 * it_np)), (
        res.iterations, it_np)
