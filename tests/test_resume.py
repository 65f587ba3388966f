"""ADMM-family warm restart / checkpoint-resume (VERDICT r3 item 5).

The reference has no ADMM-family continuation at all — ``admm``/``sdmm``
always re-init Z, U (``/root/reference/proxmin/algorithms.py:471``), so
a preempted long solve restarts its dual variables from scratch. Here
every ADMM-family driver returns a ``.state`` warm-restart pytree and
accepts it back via ``state=``; a killed-and-resumed solve reproduces
the uninterrupted trajectory exactly (same dual variables, slack,
residual-balancing multiplier), and the pytree round-trips through
``proxmin_tpu.checkpoint``.
"""

import numpy as np
import pytest
import jax.numpy as jnp

import proxmin_tpu as pt
from proxmin_tpu import operators
from proxmin_tpu.nmf import nmf


@pytest.fixture
def quad(rng):
    B = rng.standard_normal((4, 12))

    def prox_f(x, step):
        return (x + step * jnp.asarray(B)) / (1.0 + step)

    return B, prox_f


def _assert_same(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=1e-12, atol=1e-14)


def test_admm_resume_matches_uninterrupted(rng, quad):
    B, prox_f = quad
    x0 = jnp.zeros((4, 12))

    full = pt.admm(x0, prox_f, 0.7, prox_g=operators.prox_plus,
                   e_rel=1e-14, max_iter=50)

    half = pt.admm(x0, prox_f, 0.7, prox_g=operators.prox_plus,
                   e_rel=1e-14, max_iter=25)
    assert half.iterations == 25
    resumed = pt.admm(half.x, prox_f, 0.7, prox_g=operators.prox_plus,
                      e_rel=1e-14, max_iter=25, state=half.state)

    _assert_same(resumed.x, full.x)
    _assert_same(resumed.state["u"], full.state["u"])
    _assert_same(resumed.state["z"], full.state["z"])


def test_admm_adapt_step_resume_keeps_multiplier(rng, quad):
    """With residual balancing, the adapted step multiplier and the
    rescaled duals must survive the resume boundary — a fresh start
    would re-learn the scale and walk a different trajectory."""
    B, prox_f = quad
    x0 = jnp.zeros((4, 12))
    # step mis-scaled 100x: adapt_step corrects it over the first sweeps
    kw = dict(prox_g=operators.prox_plus, e_rel=1e-14, adapt_step=True)

    full = pt.admm(x0, prox_f, 70.0, max_iter=40, **kw)
    half = pt.admm(x0, prox_f, 70.0, max_iter=20, **kw)
    assert float(half.state["step_scale"]) != 1.0
    resumed = pt.admm(half.x, prox_f, 70.0, max_iter=20,
                      state=half.state, **kw)
    _assert_same(resumed.x, full.x)
    _assert_same(resumed.state["step_scale"], full.state["step_scale"])


def test_sdmm_resume_matches_uninterrupted(rng, quad):
    B, prox_f = quad
    x0 = jnp.zeros((4, 12))
    L = rng.standard_normal((3, 4))
    proxs_g = [operators.prox_plus,
               lambda x, step: operators.prox_max(x, step, thresh=1.0)]
    Ls = [None, L]

    full = pt.sdmm(x0, prox_f, 0.7, proxs_g=proxs_g, Ls=Ls,
                   e_rel=1e-14, max_iter=50)
    half = pt.sdmm(x0, prox_f, 0.7, proxs_g=proxs_g, Ls=Ls,
                   e_rel=1e-14, max_iter=25)
    resumed = pt.sdmm(half.x, prox_f, 0.7, proxs_g=proxs_g, Ls=Ls,
                      e_rel=1e-14, max_iter=25, state=half.state)
    _assert_same(resumed.x, full.x)
    for zi, zj in zip(resumed.state["z"], full.state["z"]):
        _assert_same(zi, zj)


def test_bsdmm_resume_matches_uninterrupted(rng):
    """Two-block CMF-style bsdmm with per-block constraints: Z/U and the
    carried per-block steps continue across the resume boundary."""
    from proxmin_tpu.nmf import _bsdmm_adapters

    C, K, N = 4, 3, 24
    Y = (rng.random((C, K)) @ rng.random((K, N))).astype(np.float64)
    A0 = rng.random((C, K))
    S0 = rng.random((K, N))
    prox_f, step_f = _bsdmm_adapters(
        Y, 1, (operators.prox_plus, operators.prox_plus), None)

    def run(a, s, n_iter, state=None):
        return pt.bsdmm([jnp.asarray(a), jnp.asarray(s)], prox_f, step_f,
                        proxs_g=[[operators.prox_plus],
                                 [operators.prox_plus]],
                        e_rel=1e-14, max_iter=n_iter, state=state)

    full = run(A0, S0, 40)
    half = run(A0, S0, 20)
    resumed = run(half.x[0], half.x[1], 20, state=half.state)
    _assert_same(resumed.x[0], full.x[0])
    _assert_same(resumed.x[1], full.x[1])
    _assert_same(resumed.state["steps_f"], full.state["steps_f"])


def test_admm_resume_through_checkpoint(tmp_path, rng, quad):
    """Kill-and-resume across a serialization boundary: the .state
    pytree round-trips through checkpoint.save/load (pickle fallback,
    dependency-free) and the resumed solve equals the uninterrupted
    one."""
    from proxmin_tpu.checkpoint import load_checkpoint, save_checkpoint

    B, prox_f = quad
    x0 = jnp.zeros((4, 12))
    full = pt.admm(x0, prox_f, 0.7, prox_g=operators.prox_plus,
                   e_rel=1e-14, max_iter=50)
    half = pt.admm(x0, prox_f, 0.7, prox_g=operators.prox_plus,
                   e_rel=1e-14, max_iter=25)

    path = save_checkpoint(str(tmp_path / "admm_ckpt"),
                           x=half.x, solver_state=half.state,
                           use_orbax=False)
    ckpt = load_checkpoint(path, use_orbax=False)

    resumed = pt.admm(jnp.asarray(ckpt["x"]), prox_f, 0.7,
                      prox_g=operators.prox_plus, e_rel=1e-14,
                      max_iter=25, state=ckpt["solver_state"])
    _assert_same(resumed.x, full.x)


def test_bsdmm_resume_through_checkpoint(tmp_path, rng):
    from proxmin_tpu.checkpoint import load_checkpoint, save_checkpoint
    from proxmin_tpu.nmf import _bsdmm_adapters

    C, K, N = 3, 2, 16
    Y = (rng.random((C, K)) @ rng.random((K, N))).astype(np.float64)
    A0, S0 = rng.random((C, K)), rng.random((K, N))
    prox_f, step_f = _bsdmm_adapters(
        Y, 1, (operators.prox_plus, operators.prox_plus), None)

    def run(a, s, n_iter, state=None):
        return pt.bsdmm([jnp.asarray(a), jnp.asarray(s)], prox_f, step_f,
                        e_rel=1e-14, max_iter=n_iter, state=state)

    full = run(A0, S0, 30)
    half = run(A0, S0, 15)
    path = save_checkpoint(str(tmp_path / "bsdmm_ckpt"),
                           x=list(half.x), solver_state=half.state,
                           use_orbax=False)
    ckpt = load_checkpoint(path, use_orbax=False)
    resumed = run(ckpt["x"][0], ckpt["x"][1], 15,
                  state=ckpt["solver_state"])
    _assert_same(resumed.x[0], full.x[0])
    _assert_same(resumed.x[1], full.x[1])


# ---------------------------------------------------------------------------
# PGM/FISTA warm restart (round 4): the Nesterov momentum clock, previous
# iterate, backtracking scales, and stepper state continue across the
# resume boundary. The reference has no analogue — re-calling
# algorithms.pgm restarts FISTA momentum from scratch (algorithms.py:80).
# ---------------------------------------------------------------------------

H_ILL = np.diag([1.0, 0.02])
C_ILL = np.array([1.0, 1.0])


def _grad_ill(x):
    return jnp.asarray(H_ILL) @ (x - jnp.asarray(C_ILL))


def _f_ill(x):
    d = x - jnp.asarray(C_ILL)
    return 0.5 * d @ (jnp.asarray(H_ILL) @ d)


def test_pgm_fista_resume_matches_uninterrupted():
    """An accelerated solve split in half equals the uninterrupted one —
    a fresh re-call (momentum clock reset, reference behavior) would
    not."""
    x0 = jnp.asarray([-1.0, -1.0])
    kw = dict(accelerated=True, e_rel=0.0)

    full = pt.pgm(x0, _grad_ill, 1.0, max_iter=40, **kw)
    half = pt.pgm(x0, _grad_ill, 1.0, max_iter=20, **kw)
    resumed = pt.pgm(half.x, _grad_ill, 1.0, max_iter=20,
                     state=half.state, **kw)
    _assert_same(resumed.x, full.x)
    _assert_same(resumed.state["t"], full.state["t"])
    _assert_same(resumed.state["x_prev"][0], full.state["x_prev"][0])

    # a naive re-call (no state) walks a different trajectory
    naive = pt.pgm(half.x, _grad_ill, 1.0, max_iter=20, **kw)
    assert not np.allclose(np.asarray(naive.x), np.asarray(full.x),
                           rtol=1e-12, atol=1e-14)


def test_pgm_backtracking_resume_keeps_scales():
    """The per-block backtracking scale T and last objective survive the
    boundary: with a 50x-too-large step, the first half pays the
    halving sweeps and the resumed half must not re-pay them."""
    x0 = jnp.asarray([-1.0, -1.0])
    kw = dict(backtracking=True, f=_f_ill, e_rel=0.0)

    full = pt.pgm(x0, _grad_ill, 50.0, max_iter=30, **kw)
    half = pt.pgm(x0, _grad_ill, 50.0, max_iter=15, **kw)
    assert float(half.state["T"][0]) < 1.0  # scales were actually halved
    resumed = pt.pgm(half.x, _grad_ill, 50.0, max_iter=15,
                     state=half.state, **kw)
    _assert_same(resumed.x, full.x)
    _assert_same(resumed.state["T"], full.state["T"])


def test_pgm_bb_stepper_resume_keeps_history():
    """Barzilai–Borwein stepper state (previous iterate/gradient pair)
    continues across the boundary."""
    x0 = jnp.asarray([-1.0, -1.0])
    stepper = pt.utils.BarzilaiBorweinStepper(type=1, init_r=0.1)

    full = pt.pgm(x0, _grad_ill, stepper, e_rel=0.0, max_iter=24)
    half = pt.pgm(x0, _grad_ill, stepper, e_rel=0.0, max_iter=12)
    resumed = pt.pgm(half.x, _grad_ill, stepper, e_rel=0.0, max_iter=12,
                     state=half.state)
    _assert_same(resumed.x, full.x)


def test_pgm_resume_through_checkpoint(tmp_path):
    from proxmin_tpu.checkpoint import load_checkpoint, save_checkpoint

    x0 = jnp.asarray([-1.0, -1.0])
    kw = dict(accelerated=True, e_rel=0.0)
    full = pt.pgm(x0, _grad_ill, 1.0, max_iter=40, **kw)
    half = pt.pgm(x0, _grad_ill, 1.0, max_iter=20, **kw)

    path = save_checkpoint(str(tmp_path / "pgm_ckpt"),
                           x=half.x, solver_state=half.state,
                           use_orbax=False)
    ckpt = load_checkpoint(path, use_orbax=False)
    resumed = pt.pgm(jnp.asarray(ckpt["x"]), _grad_ill, 1.0, max_iter=20,
                     state=ckpt["solver_state"], **kw)
    _assert_same(resumed.x, full.x)


def test_pgm_resume_rejects_mismatched_stepper_state():
    x0 = jnp.asarray([-1.0, -1.0])
    half = pt.pgm(x0, _grad_ill, pt.utils.BarzilaiBorweinStepper(type=1),
                  e_rel=0.0, max_iter=10)
    with pytest.raises(ValueError, match="stepper state structure"):
        pt.pgm(half.x, _grad_ill, 1.0, max_iter=10, state=half.state)


# ---------------------------------------------------------------------------
# AdaProx exact warm restart (round 4): unlike the reference-style
# M=/V=/Vhat= moment warm start (which re-fires the t=1 bias-correction
# transient), state= continues the global Adam clock and the stepper
# state, so split == uninterrupted exactly.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheme", ["adam", "radam", "amsgrad", "nadam"])
def test_adaprox_resume_matches_uninterrupted(scheme):
    x0 = jnp.asarray([-1.0, -1.0])
    kw = dict(scheme=scheme, prox=operators.prox_plus,
              check_convergence=False, e_rel=1e-14)

    full = pt.adaprox(x0, _grad_ill, 0.1, max_iter=40, **kw)
    half = pt.adaprox(x0, _grad_ill, 0.1, max_iter=20, **kw)
    resumed = pt.adaprox(half.x, _grad_ill, 0.1, max_iter=20,
                         state=half.state, **kw)
    _assert_same(resumed.x, full.x)
    _assert_same(resumed.state["M"][0], full.state["M"][0])
    _assert_same(resumed.state["V"][0], full.state["V"][0])
    assert int(resumed.state["it"]) == int(full.state["it"]) == 40


def test_adaprox_moment_warmstart_differs_from_exact_resume():
    """M=/V=/Vhat= (reference semantics) resets the bias-correction
    clock; state= does not — on a t-sensitive scheme the two must
    differ, and only state= reproduces the uninterrupted run."""
    x0 = jnp.asarray([-1.0, -1.0])
    kw = dict(scheme="adam", check_convergence=False)

    full = pt.adaprox(x0, _grad_ill, 0.1, max_iter=30, **kw)
    half = pt.adaprox(x0, _grad_ill, 0.1, max_iter=15, **kw)
    exact = pt.adaprox(half.x, _grad_ill, 0.1, max_iter=15,
                       state=half.state, **kw)
    warm = pt.adaprox(half.x, _grad_ill, 0.1, max_iter=15,
                      M=half.M, V=half.V, Vhat=half.Vhat, **kw)
    _assert_same(exact.x, full.x)
    assert not np.allclose(np.asarray(warm.x), np.asarray(full.x),
                           rtol=1e-12, atol=1e-14)


def test_adaprox_resume_through_checkpoint(tmp_path):
    from proxmin_tpu.checkpoint import load_checkpoint, save_checkpoint

    x0 = jnp.asarray([-1.0, -1.0])
    kw = dict(scheme="adam", prox=operators.prox_plus,
              check_convergence=False)
    full = pt.adaprox(x0, _grad_ill, 0.1, max_iter=30, **kw)
    half = pt.adaprox(x0, _grad_ill, 0.1, max_iter=15, **kw)
    path = save_checkpoint(str(tmp_path / "adaprox_ckpt"),
                           x=half.x, solver_state=half.state,
                           use_orbax=False)
    ckpt = load_checkpoint(path, use_orbax=False)
    resumed = pt.adaprox(jnp.asarray(ckpt["x"]), _grad_ill, 0.1,
                         max_iter=15, state=ckpt["solver_state"], **kw)
    _assert_same(resumed.x, full.x)


def test_adaprox_state_and_moments_mutually_exclusive():
    x0 = jnp.asarray([-1.0, -1.0])
    half = pt.adaprox(x0, _grad_ill, 0.1, max_iter=5,
                      check_convergence=False)
    with pytest.raises(AssertionError, match="mutually exclusive"):
        pt.adaprox(half.x, _grad_ill, 0.1, max_iter=5, M=half.M,
                   state=half.state, check_convergence=False)


def test_adaprox_resume_rejects_mismatched_stepper_state():
    x0 = jnp.asarray([-1.0, -1.0])
    half = pt.adaprox(x0, _grad_ill,
                      pt.utils.BarzilaiBorweinStepper(type=1),
                      max_iter=5, check_convergence=False)
    with pytest.raises(ValueError, match="stepper state structure"):
        pt.adaprox(half.x, _grad_ill, 0.1, max_iter=5, state=half.state,
                   check_convergence=False)


# ---------------------------------------------------------------------------
# nmf()-level resume (round 4): the application driver forwards state=
# to the underlying solver, so a preempted factorization resumes exactly
# — including the stepper state of the weighted adaptive-stride path
# (the capacity-scale configuration where preemption actually bites).
# ---------------------------------------------------------------------------


def _nmf_problem(rng, C=4, K=3, N=32):
    Y = (rng.random((C, K)) @ rng.random((K, N))).astype(np.float64)
    A0 = rng.random((C, K))
    S0 = rng.random((K, N))
    return Y, A0, S0


def test_nmf_pgm_resume_matches_uninterrupted(rng):
    # short runs: joint-block Nesterov on this nonconvex problem
    # legitimately collapses the factors to zero past ~15 iterations
    # (overshoot + prox_plus), after which 1/lambda_max steps blow up —
    # the resume contract is exercised in the pre-collapse regime
    Y, A0, S0 = _nmf_problem(rng)

    def run(a, s, n_iter, state=None):
        return nmf(Y, jnp.asarray(a), jnp.asarray(s),
                      algorithm="pgm", accelerated=True, e_rel=0.0,
                      max_iter=n_iter,
                      **({} if state is None else {"state": state}))

    full = run(A0, S0, 10)
    half = run(A0, S0, 5)
    resumed = run(half.x[0], half.x[1], 5, state=half.state)
    _assert_same(resumed.x[0], full.x[0])
    _assert_same(resumed.x[1], full.x[1])

    # a naive re-call (reference behavior: momentum clock resets) differs
    naive = run(half.x[0], half.x[1], 5)
    assert not np.allclose(np.asarray(naive.x[1]), np.asarray(full.x[1]),
                           rtol=1e-12, atol=1e-14)


def test_nmf_pgm_weighted_step_adapt_resume(rng):
    """The weighted adaptive-stride stepper state (cached steps, grown
    refresh interval, next-refresh clock, warm power iterate) continues
    across the boundary: the resumed half must neither re-pay the cold
    48-pass refresh nor walk a different stale-step trajectory."""
    Y, A0, S0 = _nmf_problem(rng)
    W = rng.random(Y.shape) + 0.5

    def run(a, s, n_iter, state=None):
        return nmf(Y, jnp.asarray(a), jnp.asarray(s), W=W,
                      algorithm="pgm", e_rel=0.0, step_adapt=True,
                      max_iter=n_iter,
                      **({} if state is None else {"state": state}))

    full = run(A0, S0, 40)
    half = run(A0, S0, 20)
    # the adaptive interval actually grew (otherwise this tests nothing)
    assert int(half.state["stepper_state"][2]) > 1
    resumed = run(half.x[0], half.x[1], 20, state=half.state)
    _assert_same(resumed.x[0], full.x[0])
    _assert_same(resumed.x[1], full.x[1])
    _assert_same(resumed.state["stepper_state"][2],
                 full.state["stepper_state"][2])


def test_nmf_adaprox_resume_matches_uninterrupted(rng):
    Y, A0, S0 = _nmf_problem(rng)

    def run(a, s, n_iter, state=None):
        return nmf(Y, jnp.asarray(a), jnp.asarray(s),
                      algorithm="adaprox", e_rel=1e-14, max_iter=n_iter,
                      check_convergence=False,
                      **({} if state is None else {"state": state}))

    full = run(A0, S0, 30)
    half = run(A0, S0, 15)
    resumed = run(half.x[0], half.x[1], 15, state=half.state)
    _assert_same(resumed.x[0], full.x[0])
    _assert_same(resumed.x[1], full.x[1])
    assert int(resumed.state["it"]) == 30  # global Adam clock continued


def test_nmf_bsdmm_resume_matches_uninterrupted(rng):
    Y, A0, S0 = _nmf_problem(rng)
    W = rng.random(Y.shape) + 0.5

    def run(a, s, n_iter, state=None):
        return nmf(Y, jnp.asarray(a), jnp.asarray(s), W=W,
                      algorithm="bsdmm", e_rel=0.0, max_iter=n_iter,
                      **({} if state is None else {"state": state}))

    full = run(A0, S0, 30)
    half = run(A0, S0, 15)
    resumed = run(half.x[0], half.x[1], 15, state=half.state)
    _assert_same(resumed.x[0], full.x[0])
    _assert_same(resumed.x[1], full.x[1])


def test_nmf_resume_through_checkpoint(tmp_path, rng):
    """Preemption drill at the application level: checkpoint the weighted
    adaptive solve mid-flight, reload, resume — equals uninterrupted."""
    from proxmin_tpu.checkpoint import load_checkpoint, save_checkpoint

    Y, A0, S0 = _nmf_problem(rng)
    W = rng.random(Y.shape) + 0.5

    def run(a, s, n_iter, state=None):
        return nmf(Y, jnp.asarray(a), jnp.asarray(s), W=W,
                      algorithm="pgm", e_rel=0.0, step_adapt=True,
                      max_iter=n_iter,
                      **({} if state is None else {"state": state}))

    full = run(A0, S0, 40)
    half = run(A0, S0, 20)
    path = save_checkpoint(str(tmp_path / "nmf_ckpt"),
                           x=list(half.x), solver_state=half.state,
                           use_orbax=False)
    ckpt = load_checkpoint(path, use_orbax=False)
    resumed = run(ckpt["x"][0], ckpt["x"][1], 20,
                  state=ckpt["solver_state"])
    _assert_same(resumed.x[0], full.x[0])
    _assert_same(resumed.x[1], full.x[1])


# ---------------------------------------------------------------------------
# Fused-adaprox engine exact resume: the single-pass Pallas engine carries
# its real state (Adam moments + the global bias-correction clock) through
# `state=`, interchangeably with the XLA driver's state for default-step
# scheme='adam' solves.
# ---------------------------------------------------------------------------


def _nmf_problem32(rng, C=4, K=3, N=32):
    Y = (rng.random((C, K)) @ rng.random((K, N))).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)
    return Y, A0, S0


def test_nmf_adaprox_fused_resume_matches_uninterrupted(rng):
    Y, A0, S0 = _nmf_problem32(rng)

    def run(a, s, n_iter, state=None):
        return nmf(Y, jnp.asarray(a), jnp.asarray(s),
                   algorithm="adaprox", engine="pallas", e_rel=0.0,
                   max_iter=n_iter,
                   **({} if state is None else {"state": state}))

    full = run(A0, S0, 20)
    half = run(A0, S0, 10)
    assert int(half.state["it"]) == 10
    resumed = run(half.x[0], half.x[1], 10, state=half.state)
    np.testing.assert_array_equal(np.asarray(resumed.x[0]),
                                  np.asarray(full.x[0]))
    np.testing.assert_array_equal(np.asarray(resumed.x[1]),
                                  np.asarray(full.x[1]))
    assert int(resumed.state["it"]) == 20


def test_nmf_adaprox_fused_state_vs_moment_warmstart(rng):
    """M=/V= (reference semantics) re-fires the t=1 bias-correction
    transient; state= continues the clock — the two must differ and only
    state= reproduces the uninterrupted run."""
    from proxmin_tpu.nmf import nmf_adaprox_fused

    Y, A0, S0 = _nmf_problem32(rng)
    kw = dict(e_rel=0.0)
    full = nmf_adaprox_fused(Y, jnp.asarray(A0), jnp.asarray(S0),
                             max_iter=20, **kw)
    half = nmf_adaprox_fused(Y, jnp.asarray(A0), jnp.asarray(S0),
                             max_iter=10, **kw)
    exact = nmf_adaprox_fused(Y, jnp.asarray(half.x[0]),
                              jnp.asarray(half.x[1]),
                              max_iter=10, state=half.state, **kw)
    warm = nmf_adaprox_fused(Y, jnp.asarray(half.x[0]),
                             jnp.asarray(half.x[1]),
                             max_iter=10, M=half.M, V=half.V, **kw)
    np.testing.assert_array_equal(np.asarray(exact.x[1]),
                                  np.asarray(full.x[1]))
    assert not np.array_equal(np.asarray(warm.x[1]),
                              np.asarray(full.x[1]))


def test_nmf_adaprox_fused_cross_engine_state(rng):
    """XLA-half -> fused-resume lands on the XLA-full trajectory (and a
    fused state round-trips into the XLA driver): the two engines'
    states are interchangeable for default-step adam solves."""
    Y, A0, S0 = _nmf_problem32(rng)

    def xla(a, s, n_iter, state=None):
        return nmf(Y, jnp.asarray(a), jnp.asarray(s),
                   algorithm="adaprox", engine="xla", e_rel=0.0,
                   check_convergence=False, separable_prox="auto",
                   max_iter=n_iter,
                   **({} if state is None else {"state": state}))

    def fused(a, s, n_iter, state=None):
        return nmf(Y, jnp.asarray(a), jnp.asarray(s),
                   algorithm="adaprox", engine="pallas", e_rel=0.0,
                   max_iter=n_iter,
                   **({} if state is None else {"state": state}))

    full = xla(A0, S0, 20)
    half = xla(A0, S0, 10)
    cross = fused(half.x[0], half.x[1], 10, state=half.state)
    np.testing.assert_allclose(np.asarray(cross.x[1]),
                               np.asarray(full.x[1]), atol=5e-5)

    back = xla(cross.x[0], cross.x[1], 5, state=cross.state)
    ref = xla(half.x[0], half.x[1], 15, state=half.state)
    np.testing.assert_allclose(np.asarray(back.x[1]),
                               np.asarray(ref.x[1]), atol=5e-5)


@pytest.mark.parametrize("cfg", ["unweighted", "unweighted_bf16s",
                                 "unweighted_stride", "unweighted_adapt",
                                 "unweighted_stride_bf16s",
                                 "weighted_stride", "weighted_adapt",
                                 "weighted_stride_bf16s"])
def test_nmf_pgm_fused_midsolve_resume_bit_exact(cfg):
    """The fused PGM engine's state= resume: the kernel's S Sᵀ Gram
    (unweighted exact), the frozen steps + carried Gram + refresh
    schedule (unweighted strided) or the frozen Lipschitz steps + warm
    power iterate + refresh schedule (weighted) carry, so a killed
    solve continues the uninterrupted trajectory bit-exactly —
    including the bf16-store capacity configurations no other engine
    can run."""
    from proxmin_tpu.nmf import nmf_pgm_fused

    rng = np.random.default_rng(13005)
    C, K, N = 5, 3, 256
    A_t = rng.random((C, K)).astype(np.float32)
    S_t = rng.random((K, N)).astype(np.float32)
    Y = (A_t @ S_t).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)
    kw = dict(e_rel=1e-3, tile_n=128)
    if cfg.startswith("weighted"):
        kw["W"] = (rng.random((C, N)) + 0.5).astype(np.float32)
    if "stride" in cfg:
        kw["step_stride"] = 4
    if "adapt" in cfg:
        kw["step_adapt"] = True
    if "bf16s" in cfg:
        kw["store_dtype"] = jnp.bfloat16
    total, k = 30, 11  # k NOT on the stride boundary
    full = nmf_pgm_fused(Y, jnp.asarray(A0), jnp.asarray(S0),
                         max_iter=total, **kw)
    half = nmf_pgm_fused(Y, jnp.asarray(A0), jnp.asarray(S0),
                         max_iter=k, **kw)
    res = nmf_pgm_fused(Y, jnp.asarray(half.x[0]),
                        jnp.asarray(half.x[1]),
                        max_iter=total - k, state=half.state, **kw)
    np.testing.assert_array_equal(np.asarray(res.x[0]),
                                  np.asarray(full.x[0]))
    np.testing.assert_array_equal(np.asarray(res.x[1]),
                                  np.asarray(full.x[1]))


def test_nmf_pgm_fused_state_config_mismatches_rejected(rng):
    """Weighting / stride / store_dtype mismatches between the state
    and the resuming call fail loudly in both directions, and nmf()
    routes fused-pgm states to the engine that produced them."""
    from proxmin_tpu.nmf import nmf_pgm_fused

    Y, A0, S0 = _nmf_problem32(rng)
    W = (0.5 + rng.random(Y.shape)).astype(np.float32)
    half = nmf_pgm_fused(Y, jnp.asarray(A0), jnp.asarray(S0),
                         W=W, step_stride=4, max_iter=6, e_rel=0.0,
                         tile_n=128)
    with pytest.raises(ValueError, match="weighting"):
        nmf_pgm_fused(Y, jnp.asarray(A0), jnp.asarray(S0), max_iter=6,
                      state=half.state, tile_n=128)
    with pytest.raises(ValueError, match="stride"):
        nmf_pgm_fused(Y, jnp.asarray(A0), jnp.asarray(S0), W=W,
                      step_stride=7, max_iter=6, state=half.state,
                      tile_n=128)
    with pytest.raises(ValueError, match="store_dtype"):
        nmf_pgm_fused(Y, jnp.asarray(A0), jnp.asarray(S0), W=W,
                      step_stride=4, max_iter=6, state=half.state,
                      store_dtype=jnp.bfloat16, tile_n=128)
    # an XLA pgm state has no fused counterpart
    xla_half = nmf(Y, jnp.asarray(A0), jnp.asarray(S0), e_rel=0.0,
                   max_iter=6)
    with pytest.raises(ValueError, match="nmf_pgm_fused"):
        nmf_pgm_fused(Y, jnp.asarray(A0), jnp.asarray(S0), max_iter=6,
                      state=xla_half.state, tile_n=128)
    # nmf() routing: a fused state pins the fused engine (like sharded
    # states pin the explicit mesh path), whatever engine= says
    for eng in ({}, {"engine": "xla"}, {"engine": "auto"}):
        cont = nmf(Y, jnp.asarray(half.x[0]), jnp.asarray(half.x[1]),
                   W=W, step_stride=4, max_iter=6, state=half.state,
                   tile_n=128, e_rel=0.0, **eng)
        assert "steps" in cont.state \
            and cont.state["kind"] == "nmf_pgm_fused"
    # ...but it cannot resume under a mesh
    from proxmin_tpu.parallel import make_mesh
    with pytest.raises(ValueError, match="mesh"):
        nmf(Y, jnp.asarray(half.x[0]), jnp.asarray(half.x[1]), W=W,
            step_stride=4, max_iter=6, state=half.state,
            mesh=make_mesh(), e_rel=0.0)


def test_nmf_fused_resume_review_findings(rng, monkeypatch):
    """r4 self-review regressions: (a) a no-op resume of a stopped
    fused solve reports the solve's REAL loss, not the inf loop init;
    (b) resuming with the exact kwargs that produced the state through
    engine='auto' store_dtype normalization is accepted (f32 ≡ None) —
    routing as on a CUDA GPU, the only backend where auto picks a
    kernel; (c) a fused-PGM state into algorithm='adaprox' is rejected
    clearly; (d) a tile_n mismatch is rejected instead of silently
    drifting."""
    from proxmin_tpu import nmf as nmf_mod
    from proxmin_tpu.nmf import nmf_adaprox_fused, nmf_pgm_fused

    monkeypatch.setattr(nmf_mod, "cuda_available", lambda: True)

    Y, A0, S0 = _nmf_problem32(rng)

    # (a) no-op resume keeps the real loss
    rng2 = np.random.default_rng(7)
    A_t = rng2.random((4, 3)).astype(np.float32)
    S_t = rng2.random((3, 256)).astype(np.float32)
    Yc = (A_t @ S_t).astype(np.float32)
    A0c = np.abs(A_t * (1 + 0.1 * rng2.standard_normal(A_t.shape))) \
        .astype(np.float32)
    S0c = np.abs(S_t * (1 + 0.1 * rng2.standard_normal(S_t.shape))) \
        .astype(np.float32)
    full = nmf_pgm_fused(Yc, jnp.asarray(A0c), jnp.asarray(S0c),
                         e_rel=0.1, max_iter=200, tile_n=128)
    assert all(full.converged)
    res = nmf_pgm_fused(Yc, jnp.asarray(full.x[0]), jnp.asarray(full.x[1]),
                        e_rel=0.1, max_iter=50, state=full.state,
                        tile_n=128)
    assert res.iterations == 0
    assert np.isfinite(res.loss) and res.loss == full.loss

    # (b) engine='auto' normalizes a full-width store_dtype away; the
    # state must resume with the identical kwargs
    h = nmf(Y, jnp.asarray(A0), jnp.asarray(S0), e_rel=0.0, max_iter=5,
            store_dtype=jnp.float32, tile_n=128, engine="auto")
    assert h.state["kind"] == "nmf_pgm_fused"
    assert h.state["store_dtype"] is None
    r2 = nmf(Y, jnp.asarray(h.x[0]), jnp.asarray(h.x[1]), e_rel=0.0,
             max_iter=5, store_dtype=jnp.float32, tile_n=128,
             engine="auto", state=h.state)
    assert r2.iterations == 5

    # (c) cross-kind: a fused-PGM state cannot resume adaprox
    with pytest.raises(ValueError, match="nmf_pgm_fused"):
        nmf_adaprox_fused(Y, jnp.asarray(A0), jnp.asarray(S0),
                          max_iter=5, state=h.state, tile_n=128)
    with pytest.raises(ValueError, match="algorithm"):
        nmf(Y, jnp.asarray(A0), jnp.asarray(S0), algorithm="adaprox",
            max_iter=5, state=h.state)

    # (d) tile_n mismatches are rejected on both fused engines
    with pytest.raises(ValueError, match="tile_n"):
        nmf_pgm_fused(Y, jnp.asarray(h.x[0]), jnp.asarray(h.x[1]),
                      e_rel=0.0, max_iter=5, state=h.state, tile_n=64)
    ha = nmf_adaprox_fused(Y, jnp.asarray(A0), jnp.asarray(S0),
                           e_rel=0.0, max_iter=5, tile_n=128)
    with pytest.raises(ValueError, match="fused configuration"):
        nmf_adaprox_fused(Y, jnp.asarray(ha.x[0]), jnp.asarray(ha.x[1]),
                          e_rel=0.0, max_iter=5, state=ha.state,
                          tile_n=64)


def test_nmf_pgm_fused_resume_after_stop_stays_stopped():
    """Fused PGM terminal flags: converged and diverged solves resume
    as no-ops."""
    from proxmin_tpu.nmf import nmf_pgm_fused

    rng = np.random.default_rng(7)
    C, K, N = 6, 3, 256
    A_t = rng.random((C, K)).astype(np.float32)
    S_t = rng.random((K, N)).astype(np.float32)
    Y = (A_t @ S_t).astype(np.float32)
    A0 = np.abs(A_t * (1 + 0.2 * rng.standard_normal((C, K)))) \
        .astype(np.float32)
    S0 = np.abs(S_t * (1 + 0.2 * rng.standard_normal((K, N)))) \
        .astype(np.float32)
    kw = dict(e_rel=0.05, tile_n=128)
    full = nmf_pgm_fused(Y, jnp.asarray(A0), jnp.asarray(S0),
                         max_iter=400, **kw)
    assert all(full.converged), "test needs a converging config"
    half = nmf_pgm_fused(Y, jnp.asarray(A0), jnp.asarray(S0),
                         max_iter=full.iterations + 10, **kw)
    res = nmf_pgm_fused(Y, jnp.asarray(half.x[0]),
                        jnp.asarray(half.x[1]),
                        max_iter=50, state=half.state, **kw)
    assert res.iterations == 0 and res.status == "converged"
    np.testing.assert_array_equal(np.asarray(res.x[1]),
                                  np.asarray(full.x[1]))

    Y_bad = Y.copy()
    Y_bad[0, 0] = np.nan
    dead = nmf_pgm_fused(Y_bad, jnp.asarray(A0), jnp.asarray(S0),
                         max_iter=50, **kw)
    assert dead.status == "diverged"
    res2 = nmf_pgm_fused(Y_bad, jnp.asarray(dead.x[0]),
                         jnp.asarray(dead.x[1]),
                         max_iter=50, state=dead.state, **kw)
    assert res2.iterations == 0 and res2.status == "diverged"


@pytest.mark.parametrize("weighted,mdt", [(True, None),
                                          (True, "bfloat16"),
                                          (False, "bfloat16")])
def test_nmf_adaprox_fused_midsolve_resume_bit_exact(weighted, mdt):
    """Mid-solve fused resume is BIT-exact: the kernel's
    tile-accumulated step-heuristic row sums ride the state — before
    the carry, a fresh jnp.sum's different reduction order drifted the
    resumed trajectory by ~1e-7 over tens of iterations (r4 fuzz:
    8/25 random fused kill-resume configs mismatched)."""
    from proxmin_tpu.nmf import nmf_adaprox_fused

    rng = np.random.default_rng(99007)
    C, K, N = 5, 3, 256
    A_t = rng.random((C, K)).astype(np.float32)
    S_t = rng.random((K, N)).astype(np.float32)
    Y = (A_t @ S_t).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)
    kw = dict(e_rel=1e-3, tile_n=128)
    if weighted:
        kw["W"] = (rng.random((C, N)) + 0.5).astype(np.float32)
    if mdt:
        kw["moment_dtype"] = jnp.bfloat16
    total, k = 30, 11
    full = nmf_adaprox_fused(Y, jnp.asarray(A0), jnp.asarray(S0),
                             max_iter=total, **kw)
    half = nmf_adaprox_fused(Y, jnp.asarray(A0), jnp.asarray(S0),
                             max_iter=k, **kw)
    assert "rowsum" in half.state
    res = nmf_adaprox_fused(Y, jnp.asarray(half.x[0]),
                            jnp.asarray(half.x[1]),
                            max_iter=total - k, state=half.state, **kw)
    np.testing.assert_array_equal(np.asarray(res.x[0]),
                                  np.asarray(full.x[0]))
    np.testing.assert_array_equal(np.asarray(res.x[1]),
                                  np.asarray(full.x[1]))


def test_nmf_adaprox_fused_resume_after_stop_stays_stopped(rng):
    """Terminal flags ride the fused-engine state both ways: a
    converged (or diverged) fused solve resumed via state= is a no-op
    instead of taking extra steps the uninterrupted run never took."""
    from proxmin_tpu.nmf import nmf_adaprox_fused

    # near-solution start + loose tolerance: converges in a few
    # iterations, NOT onto an exact fixed point (own seed: whether a
    # draw converges is data-chaotic)
    rng = np.random.default_rng(7)
    C, K, N = 4, 3, 256
    A_t = rng.random((C, K)).astype(np.float32)
    S_t = rng.random((K, N)).astype(np.float32)
    Y = A_t @ S_t
    A0 = np.abs(A_t * (1 + 0.1 * rng.standard_normal((C, K)))) \
        .astype(np.float32)
    S0 = np.abs(S_t * (1 + 0.1 * rng.standard_normal((K, N)))) \
        .astype(np.float32)
    kw = dict(e_rel=0.05, tile_n=128)
    full = nmf_adaprox_fused(Y, jnp.asarray(A0), jnp.asarray(S0),
                             max_iter=300, **kw)
    assert all(full.converged), "test needs a converging config"
    k = full.iterations + 8
    half = nmf_adaprox_fused(Y, jnp.asarray(A0), jnp.asarray(S0),
                             max_iter=k, **kw)
    res = nmf_adaprox_fused(Y, jnp.asarray(half.x[0]),
                            jnp.asarray(half.x[1]),
                            max_iter=40, state=half.state, **kw)
    assert res.iterations == 0
    assert res.status == "converged"
    np.testing.assert_array_equal(np.asarray(res.x[1]),
                                  np.asarray(full.x[1]))

    # diverged: a NaN-poisoned solve stays stopped on resume
    Y_bad = Y.copy()
    Y_bad[0, 0] = np.nan
    dead = nmf_adaprox_fused(Y_bad, jnp.asarray(A0), jnp.asarray(S0),
                             max_iter=50, **kw)
    assert dead.status == "diverged"
    res2 = nmf_adaprox_fused(Y_bad, jnp.asarray(dead.x[0]),
                             jnp.asarray(dead.x[1]),
                             max_iter=50, state=dead.state, **kw)
    assert res2.iterations == 0
    assert res2.status == "diverged"


def test_nmf_adaprox_fused_rejects_strided_state(rng):
    """A strided-stepper XLA state has no fused counterpart — resuming
    it on the fused engine must fail loudly, not silently change the
    step trajectory."""
    from proxmin_tpu.nmf import nmf_adaprox_fused

    Y, A0, S0 = _nmf_problem32(rng)
    half = nmf(Y, jnp.asarray(A0), jnp.asarray(S0), algorithm="adaprox",
               e_rel=0.0, check_convergence=False, step_stride=5,
               max_iter=10)
    with pytest.raises(ValueError, match="stepper state"):
        nmf_adaprox_fused(Y, jnp.asarray(half.x[0]),
                          jnp.asarray(half.x[1]), max_iter=10,
                          state=half.state)


# ---------------------------------------------------------------------------
# Explicit-collective sharded solve resume: the shard_map whole-solve
# (parallel/sharding.py) carries its full strided-segment state through
# `state=` — the preemptible-pod continuation keeps the pinned collective
# layout instead of falling back to auto-SPMD.
# ---------------------------------------------------------------------------


@pytest.fixture
def sharded_problem(rng):
    C, K, N = 6, 3, 64
    Y = rng.random((C, K)) @ rng.random((K, N)) \
        + 0.01 * rng.standard_normal((C, N))
    A0 = rng.random((C, K))
    S0 = rng.random((K, N))
    W = rng.random((C, N)) + 0.5
    return Y, A0, S0, W


def test_sharded_pgm_resume_matches_uninterrupted(rng, sharded_problem):
    from proxmin_tpu.parallel import make_mesh

    Y, A0, S0, _ = sharded_problem
    mesh = make_mesh()

    def run(a, s, n_iter, state=None):
        return nmf(Y, jnp.asarray(a), jnp.asarray(s), mesh=mesh,
                   e_rel=0.0, max_iter=n_iter,
                   **({} if state is None else {"state": state}))

    full = run(A0, S0, 30)
    half = run(A0, S0, 15)
    assert half.state["kind"] == "nmf_pgm_sharded"
    resumed = run(half.x[0], half.x[1], 15, state=half.state)
    np.testing.assert_array_equal(np.asarray(resumed.x[0]),
                                  np.asarray(full.x[0]))
    np.testing.assert_array_equal(np.asarray(resumed.x[1]),
                                  np.asarray(full.x[1]))
    assert int(resumed.state["it"]) == 30
    assert resumed.iterations == 15


def test_sharded_resume_after_convergence_stays_stopped(rng,
                                                        sharded_problem):
    """Kill AFTER the sharded solve converged: the carried terminal
    scalars (conv_A, conv_S, loss) keep the resumed solve stopped —
    zero extra iterations, iterates bit-equal to the uninterrupted
    run's."""
    from proxmin_tpu.parallel import make_mesh, nmf_pgm_sharded

    # a near-solution start converges in a few iterations at a loose
    # tolerance — but NOT onto an exact fixed point, so a resumed loop
    # with fresh flags would visibly move the iterates. Own seed:
    # whether a given draw converges is data-chaotic.
    rng = np.random.default_rng(42)
    C, K, N = 6, 3, 64
    A_t, S_t = rng.random((C, K)), rng.random((K, N))
    Y = A_t @ S_t
    A0 = np.abs(A_t * (1 + 0.2 * rng.standard_normal((C, K))))
    S0 = np.abs(S_t * (1 + 0.2 * rng.standard_normal((K, N))))
    mesh = make_mesh()
    kw = dict(mesh=mesh, e_rel=0.03)

    full = nmf_pgm_sharded(Y, A0.copy(), S0.copy(), max_iter=500, **kw)
    assert all(full.converged), "test needs a converging config"
    k = full.iterations + 10
    half = nmf_pgm_sharded(Y, A0.copy(), S0.copy(), max_iter=k, **kw)
    resumed = nmf_pgm_sharded(Y, half.x[0], half.x[1], max_iter=50,
                              state=half.state, **kw)
    assert resumed.iterations == 0
    assert resumed.status == "converged"
    assert resumed.loss == full.loss
    np.testing.assert_array_equal(np.asarray(resumed.x[0]),
                                  np.asarray(full.x[0]))
    np.testing.assert_array_equal(np.asarray(resumed.x[1]),
                                  np.asarray(full.x[1]))


def test_sharded_weighted_adaptive_resume_mid_segment(rng, sharded_problem):
    """Interrupt the adaptive-stride solve mid-segment: the carried
    frozen steps, refresh interval, segment boundary, and power iterate
    reproduce the uninterrupted trajectory exactly."""
    from proxmin_tpu.parallel import make_mesh, nmf_pgm_sharded

    Y, A0, S0, W = sharded_problem
    mesh = make_mesh()
    kw = dict(W=W, mesh=mesh, e_rel=0.0, step_adapt=True)

    full = nmf_pgm_sharded(Y, A0.copy(), S0.copy(), max_iter=40, **kw)
    half = nmf_pgm_sharded(Y, A0.copy(), S0.copy(), max_iter=19, **kw)
    # 19 is not a refresh boundary: seg_end must lie beyond the clock
    assert int(half.state["seg_end"]) > int(half.state["it"])
    resumed = nmf_pgm_sharded(Y, half.x[0], half.x[1], max_iter=21,
                              state=half.state, **kw)
    np.testing.assert_array_equal(np.asarray(resumed.x[0]),
                                  np.asarray(full.x[0]))
    np.testing.assert_array_equal(np.asarray(resumed.x[1]),
                                  np.asarray(full.x[1]))


def test_sharded_2d_mesh_strided_resume(rng, sharded_problem):
    from proxmin_tpu.parallel import make_mesh, nmf_pgm_sharded

    Y, A0, S0, W = sharded_problem
    mesh = make_mesh(shape=(4, 2))
    kw = dict(W=W, mesh=mesh, e_rel=0.0, step_stride=7,
              model_axis="model")

    full = nmf_pgm_sharded(Y, A0.copy(), S0.copy(), max_iter=30, **kw)
    half = nmf_pgm_sharded(Y, A0.copy(), S0.copy(), max_iter=17, **kw)
    resumed = nmf_pgm_sharded(Y, half.x[0], half.x[1], max_iter=13,
                              state=half.state, **kw)
    np.testing.assert_array_equal(np.asarray(resumed.x[0]),
                                  np.asarray(full.x[0]))
    np.testing.assert_array_equal(np.asarray(resumed.x[1]),
                                  np.asarray(full.x[1]))


def test_sharded_resume_through_checkpoint(tmp_path, rng, sharded_problem):
    """Pod preemption drill: the sharded strided state round-trips
    through proxmin_tpu.checkpoint (host NumPy) and resumes exactly on a
    fresh mesh."""
    from proxmin_tpu.checkpoint import load_checkpoint, save_checkpoint
    from proxmin_tpu.parallel import make_mesh, nmf_pgm_sharded

    Y, A0, S0, W = sharded_problem
    mesh = make_mesh()
    kw = dict(W=W, e_rel=0.0, step_adapt=True)

    full = nmf_pgm_sharded(Y, A0.copy(), S0.copy(), mesh=mesh,
                           max_iter=40, **kw)
    half = nmf_pgm_sharded(Y, A0.copy(), S0.copy(), mesh=mesh,
                           max_iter=19, **kw)
    path = save_checkpoint(str(tmp_path / "pod_ckpt"),
                           x=[np.asarray(half.x[0]), np.asarray(half.x[1])],
                           solver_state=half.state, use_orbax=False)
    ckpt = load_checkpoint(path, use_orbax=False)
    mesh2 = make_mesh()  # "new pod": rebuild the mesh from scratch
    resumed = nmf_pgm_sharded(Y, jnp.asarray(ckpt["x"][0]),
                              jnp.asarray(ckpt["x"][1]), mesh=mesh2,
                              max_iter=21, state=ckpt["solver_state"],
                              **kw)
    np.testing.assert_array_equal(np.asarray(resumed.x[0]),
                                  np.asarray(full.x[0]))
    np.testing.assert_array_equal(np.asarray(resumed.x[1]),
                                  np.asarray(full.x[1]))


def test_sharded_resume_config_mismatch_rejected(rng, sharded_problem):
    from proxmin_tpu.parallel import make_mesh, nmf_pgm_sharded

    Y, A0, S0, W = sharded_problem
    mesh = make_mesh()
    half = nmf_pgm_sharded(Y, A0.copy(), S0.copy(), W=W, mesh=mesh,
                           e_rel=0.0, max_iter=10, step_adapt=True)
    with pytest.raises(ValueError, match="stride"):
        nmf_pgm_sharded(Y, half.x[0], half.x[1], W=W, mesh=mesh,
                        max_iter=5, state=half.state)
    with pytest.raises(ValueError, match="weighting"):
        nmf_pgm_sharded(Y, half.x[0], half.x[1], mesh=mesh,
                        max_iter=5, step_adapt=True, state=half.state)
    # a sharded state never resumes the ordinary drivers
    with pytest.raises(ValueError, match="nmf_pgm_sharded"):
        nmf(Y, half.x[0], half.x[1], mesh=mesh, algorithm="adaprox",
            max_iter=5, state=half.state)
    # and a single-device state never resumes the explicit path
    single = nmf(Y, jnp.asarray(A0), jnp.asarray(S0), e_rel=0.0,
                 max_iter=10)
    with pytest.raises(ValueError, match="nmf_pgm_sharded"):
        nmf_pgm_sharded(Y, A0.copy(), S0.copy(), mesh=mesh, max_iter=5,
                        state=single.state)


def test_single_device_state_resumes_under_mesh_auto_spmd(rng,
                                                          sharded_problem):
    """The documented fallback: a single-device solver state under
    ``mesh=`` resumes via the auto-SPMD path (XLA reshards the carried
    state; tolerance covers sharded reduction order)."""
    from proxmin_tpu.parallel import make_mesh

    Y, A0, S0, _ = sharded_problem
    mesh = make_mesh()
    kw = dict(algorithm="adaprox", e_rel=0.0)

    full = nmf(Y, jnp.asarray(A0), jnp.asarray(S0), max_iter=30, **kw)
    half = nmf(Y, jnp.asarray(A0), jnp.asarray(S0), max_iter=15, **kw)
    resumed = nmf(Y, half.x[0], half.x[1], mesh=mesh, max_iter=15,
                  state=half.state, **kw)
    np.testing.assert_allclose(np.asarray(resumed.x[1]),
                               np.asarray(full.x[1]),
                               rtol=1e-10, atol=1e-12)


# ---------------------------------------------------------------------------
# Review-pass regressions (r4): boundary-kill resume, config-mismatch
# guards, and checkpoint round-trips through the DEFAULT (orbax) store.
# ---------------------------------------------------------------------------


def test_stride_boundary_kill_resume_exact(rng, sharded_problem):
    """Kill landing exactly ON a refresh boundary (checkpoint interval a
    multiple of the stride — the natural choice) must refresh on resume,
    not serve a full segment of stale steps: the carried next-refresh
    clock, not a phase formula, decides."""
    Y, A0, S0, _ = sharded_problem

    def run(a, s, n_iter, state=None):
        return nmf(Y, jnp.asarray(a), jnp.asarray(s), e_rel=0.0,
                   step_stride=5, max_iter=n_iter,
                   **({} if state is None else {"state": state}))

    full = run(A0, S0, 20)
    half = run(A0, S0, 10)  # 10 is a stride multiple: refresh due at 10
    resumed = run(half.x[0], half.x[1], 10, state=half.state)
    np.testing.assert_array_equal(np.asarray(resumed.x[1]),
                                  np.asarray(full.x[1]))


def test_sharded_resume_stride_value_mismatch_rejected(rng,
                                                       sharded_problem):
    from proxmin_tpu.parallel import make_mesh, nmf_pgm_sharded

    Y, A0, S0, W = sharded_problem
    mesh = make_mesh()
    half = nmf_pgm_sharded(Y, A0.copy(), S0.copy(), W=W, mesh=mesh,
                           e_rel=0.0, max_iter=17, step_stride=7)
    with pytest.raises(ValueError, match="stride"):
        nmf_pgm_sharded(Y, half.x[0], half.x[1], W=W, mesh=mesh,
                        e_rel=0.0, max_iter=5, step_stride=10,
                        state=half.state)
    with pytest.raises(ValueError, match="stride"):
        nmf_pgm_sharded(Y, half.x[0], half.x[1], W=W, mesh=mesh,
                        e_rel=0.0, max_iter=5, step_adapt=True,
                        state=half.state)


def test_sharded_state_without_mesh_rejected(rng, sharded_problem):
    """Forgetting mesh= on the resume call gets a clear ValueError, not
    a jit internals TypeError."""
    from proxmin_tpu.parallel import make_mesh, nmf_pgm_sharded

    Y, A0, S0, W = sharded_problem
    half = nmf_pgm_sharded(Y, A0.copy(), S0.copy(), W=W,
                           mesh=make_mesh(), e_rel=0.0, max_iter=10)
    with pytest.raises(ValueError, match="mesh"):
        nmf(Y, half.x[0], half.x[1], W=W, max_iter=5, state=half.state)


def test_state_none_keeps_explicit_sharded_routing(rng, sharded_problem):
    """state=None (the natural first-slice value of `state=maybe_state`)
    must route identically to an absent kwarg — the explicit-collective
    sharded path, whose .state is the sharded kind."""
    from proxmin_tpu.parallel import make_mesh

    Y, A0, S0, _ = sharded_problem
    res = nmf(Y, jnp.asarray(A0), jnp.asarray(S0), mesh=make_mesh(),
              e_rel=0.0, max_iter=5, state=None)
    assert res.state["kind"] == "nmf_pgm_sharded"


def test_pgm_accelerated_mismatch_rejected(rng):
    H = jnp.asarray(np.diag([1.0, 0.02]))
    grad = lambda x: H @ (x - jnp.ones(2))  # noqa: E731
    half = pt.pgm(jnp.asarray([-1.0, -1.0]), grad, 1.0, e_rel=0.0,
                  max_iter=10)
    with pytest.raises(ValueError, match="accelerated"):
        pt.pgm(half.x, grad, 1.0, accelerated=True, e_rel=0.0,
               max_iter=5, state=half.state)
    half_a = pt.pgm(jnp.asarray([-1.0, -1.0]), grad, 1.0,
                    accelerated=True, e_rel=0.0, max_iter=10)
    with pytest.raises(ValueError, match="accelerated"):
        pt.pgm(half_a.x, grad, 1.0, e_rel=0.0, max_iter=5,
               state=half_a.state)


@pytest.mark.skipif(
    __import__("importlib").util.find_spec("orbax") is None,
    reason="orbax not installed")
def test_orbax_state_round_trips_exact_structure(tmp_path, rng,
                                                 sharded_problem):
    """The DEFAULT (orbax) store must round-trip solver .state pytrees
    exactly: string leaves (sharded 'kind'), nested tuples (stepper
    states — the drivers' tree_structure validation rejects orbax's
    list coercion), and resume must then be exact."""
    from proxmin_tpu.checkpoint import load_checkpoint, save_checkpoint

    Y, A0, S0, W = sharded_problem

    def run(a, s, n_iter, state=None):
        return nmf(Y, jnp.asarray(a), jnp.asarray(s), W=W, e_rel=0.0,
                   step_adapt=True, max_iter=n_iter,
                   **({} if state is None else {"state": state}))

    full = run(A0, S0, 40)
    half = run(A0, S0, 19)
    path = save_checkpoint(str(tmp_path / "orbax_ck"),
                           x=list(half.x), solver_state=half.state,
                           use_orbax=True)
    ck = load_checkpoint(path, use_orbax=True)
    sst = ck["solver_state"]["stepper_state"]
    assert isinstance(sst, tuple)  # not orbax's list coercion
    resumed = run(ck["x"][0], ck["x"][1], 21, state=ck["solver_state"])
    np.testing.assert_array_equal(np.asarray(resumed.x[1]),
                                  np.asarray(full.x[1]))

    # sharded state: the string 'kind' leaf survives the array store
    from proxmin_tpu.parallel import make_mesh, nmf_pgm_sharded
    mesh = make_mesh()
    hs = nmf_pgm_sharded(Y, A0.copy(), S0.copy(), W=W, mesh=mesh,
                         e_rel=0.0, max_iter=19, step_adapt=True)
    p2 = save_checkpoint(str(tmp_path / "orbax_sharded"),
                         solver_state=hs.state, use_orbax=True)
    ck2 = load_checkpoint(p2, use_orbax=True)
    assert ck2["solver_state"]["kind"] == "nmf_pgm_sharded"


def test_admm_trace_resume_history_concatenates(rng, quad):
    """Trace-mode resume: this-call history only (no trailing zero rows
    from the carried global clock), concatenating to the uninterrupted
    trace; .iterations/.total_iterations count THIS call."""
    B, prox_f = quad
    x0 = jnp.zeros((4, 12))
    kw = dict(prox_g=operators.prox_plus, e_rel=1e-14, trace=True)

    full = pt.admm(x0, prox_f, 0.7, max_iter=12, **kw)
    half = pt.admm(x0, prox_f, 0.7, max_iter=5, **kw)
    res = pt.admm(half.x, prox_f, 0.7, max_iter=7, state=half.state, **kw)
    assert res.iterations == 7
    assert res.total_iterations == 7
    assert res.history.shape[0] == 7
    np.testing.assert_array_equal(
        np.concatenate([half.history, res.history]), full.history)


def test_bsdmm_stride_mismatch_rejected(rng):
    from proxmin_tpu.nmf import nmf

    C, K, N = 4, 3, 32
    Y = rng.random((C, K)) @ rng.random((K, N))
    A0, S0 = rng.random((C, K)), rng.random((K, N))
    W = rng.random((C, N)) + 0.5
    half = nmf(Y, jnp.asarray(A0), jnp.asarray(S0), W=W,
               algorithm="bsdmm", e_rel=0.0, max_iter=10, step_stride=3)
    with pytest.raises(ValueError, match="stride"):
        nmf(Y, half.x[0], half.x[1], W=W, algorithm="bsdmm",
            e_rel=0.0, max_iter=5, step_stride=5, state=half.state)
    # unweighted path (static `it % steps_f_stride` phase) too
    half_u = nmf(Y, jnp.asarray(A0), jnp.asarray(S0),
                 algorithm="bsdmm", e_rel=0.0, max_iter=10,
                 step_stride=3)
    with pytest.raises(ValueError, match="stride"):
        nmf(Y, half_u.x[0], half_u.x[1], algorithm="bsdmm",
            e_rel=0.0, max_iter=5, step_stride=5, state=half_u.state)


def test_callback_mode_resume_exact(rng, quad):
    """Callback-mode (host-loop) solves resume exactly too, and their
    states interchange with the fused mode's: a callback half + callback
    resume equals the fused uninterrupted run."""
    H = jnp.asarray(np.diag([1.0, 0.05]))
    grad = lambda x: H @ (x - jnp.ones(2))  # noqa: E731
    x0 = jnp.asarray([-1.0, -1.0])
    cb = lambda *X, it=None: None  # noqa: E731

    full = pt.pgm(x0, grad, 1.0, accelerated=True, e_rel=0.0, max_iter=30)
    half = pt.pgm(x0, grad, 1.0, accelerated=True, e_rel=0.0, max_iter=15,
                  callback=cb)
    res = pt.pgm(half.x, grad, 1.0, accelerated=True, e_rel=0.0,
                 max_iter=15, callback=cb, state=half.state)
    np.testing.assert_array_equal(np.asarray(res.x), np.asarray(full.x))

    B, prox_f = quad
    x0b = jnp.zeros((4, 12))
    fa = pt.admm(x0b, prox_f, 0.7, prox_g=operators.prox_plus,
                 e_rel=1e-14, max_iter=30)
    ha = pt.admm(x0b, prox_f, 0.7, prox_g=operators.prox_plus,
                 e_rel=1e-14, max_iter=15, callback=cb)
    ra = pt.admm(ha.x, prox_f, 0.7, prox_g=operators.prox_plus,
                 e_rel=1e-14, max_iter=15, callback=cb, state=ha.state)
    np.testing.assert_array_equal(np.asarray(ra.x), np.asarray(fa.x))


def test_bsdmm_trace_resume_history_concatenates(rng):
    """bsdmm trace-mode resume: local history only, concatenating to the
    uninterrupted trace (the continued sweep clock indexes via it-it0)."""
    def proxs_f(x, step, Xs=None, j=None):
        c = jnp.asarray([1.0, 0.5])
        return (x + step * c) / (1 + step)

    pg = lambda v, step: jnp.maximum(v, 0)  # noqa: E731
    kw = dict(proxs_g=[[pg]], e_rel=0.0, trace=True)
    steps = lambda Xs, j=None: 0.5  # noqa: E731

    full = pt.bsdmm([jnp.zeros(2)], proxs_f, steps, max_iter=20, **kw)
    half = pt.bsdmm([jnp.zeros(2)], proxs_f, steps, max_iter=9, **kw)
    res = pt.bsdmm([half.x[0]], proxs_f, steps, max_iter=11,
                   state=half.state, **kw)
    assert res.iterations == 11
    np.testing.assert_array_equal(
        np.concatenate([half.history, res.history]), full.history)


def test_sharded_elastic_resume_different_mesh_size(rng, sharded_problem):
    """Elastic pod resume: a state checkpointed on an 8-device mesh
    resumes on a 4-device mesh (and vice versa) — the carried pixel-
    sharded power iterate reshards to the new mesh; agreement is at
    reduction-order rounding (different shard counts sum in different
    orders), not bit-exact."""
    import jax
    import jax.tree_util as jtu
    from proxmin_tpu.parallel import make_mesh, nmf_pgm_sharded

    Y, A0, S0, W = sharded_problem
    kw = dict(W=W, e_rel=0.0, step_adapt=True)
    mesh8 = make_mesh(devices=jax.devices()[:8])
    mesh4 = make_mesh(devices=jax.devices()[:4])

    full = nmf_pgm_sharded(Y, A0.copy(), S0.copy(), mesh=mesh8,
                           max_iter=40, **kw)
    half = nmf_pgm_sharded(Y, A0.copy(), S0.copy(), mesh=mesh8,
                           max_iter=19, **kw)
    # host round trip, as a real checkpoint/restore on the new pod would
    state_host = jtu.tree_map(
        lambda a: np.asarray(a) if isinstance(a, jax.Array) else a,
        half.state)
    for mesh in (mesh4, mesh8):
        res = nmf_pgm_sharded(Y, np.asarray(half.x[0]).copy(),
                              np.asarray(half.x[1]).copy(), mesh=mesh,
                              max_iter=21, state=state_host, **kw)
        np.testing.assert_allclose(np.asarray(res.x[0]),
                                   np.asarray(full.x[0]),
                                   rtol=1e-10, atol=1e-12)
