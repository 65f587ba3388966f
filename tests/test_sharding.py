"""Multi-device tests on the 8-device virtual CPU mesh: the sharded NMF
paths must agree with the single-device solver bit-for-tolerance, and the
explicit-collective step must agree with the auto-SPMD path."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import PartitionSpec as P

import proxmin_tpu as pt
from proxmin_tpu import operators
from proxmin_tpu.parallel import (
    make_mesh,
    make_nmf_pgm_step,
    nmf_adaprox_sharded,
    nmf_pgm_sharded,
    prox_unity_sharded,
    shard_nmf_problem,
)


@pytest.fixture
def problem(rng):
    C, N, K = 6, 64, 3
    A_true = rng.random((C, K))
    S_true = rng.random((K, N))
    Y = A_true @ S_true + 0.01 * rng.standard_normal((C, N))
    A0 = rng.random((C, K))
    S0 = rng.random((K, N))
    return Y, A0, S0


def test_eight_devices_available():
    assert jax.device_count() >= 8


def test_make_mesh_1d():
    mesh = make_mesh()
    assert mesh.axis_names == ("data",)
    assert mesh.devices.size == jax.device_count()


def test_make_mesh_2d():
    mesh = make_mesh(shape=(4, 2))
    assert mesh.axis_names == ("data", "model")


def test_shard_problem_layout(problem):
    Y, A0, S0 = problem
    mesh = make_mesh()
    Ys, As, Ss, _ = shard_nmf_problem(mesh, Y, A0, S0)
    assert Ys.sharding.spec == P(None, "data")
    assert Ss.sharding.spec == P(None, "data")
    # A replicated
    assert As.sharding.is_fully_replicated


def test_auto_sharded_nmf_matches_single_device(problem):
    Y, A0, S0 = problem
    # single device
    A1, S1 = A0.copy(), S0.copy()
    pt.nmf.nmf(Y, A1, S1, e_rel=0, max_iter=20)

    # sharded inputs through the same solver (auto-SPMD)
    mesh = make_mesh()
    Ys, As, Ss, _ = shard_nmf_problem(mesh, Y, A0, S0)
    res = pt.nmf.nmf(Ys, As, Ss, e_rel=0, max_iter=20)
    A2, S2 = res.x
    np.testing.assert_allclose(np.asarray(A2), A1, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(S2), S1, rtol=1e-9, atol=1e-12)


def test_explicit_step_matches_reference_math(problem):
    """One explicit shard_map step == one hand-computed PGM step."""
    Y, A0, S0 = problem
    mesh = make_mesh()
    step = make_nmf_pgm_step(mesh)
    Ys, As, Ss, _ = shard_nmf_problem(mesh, Y, A0, S0)
    A1, S1, loss = step(As, Ss, Ys)

    # NumPy oracle for one step
    D = A0 @ S0 - Y
    gA, gS = D @ S0.T, A0.T @ D
    sA = 1.0 / np.linalg.eigvalsh(S0 @ S0.T).max()
    sS = 1.0 / np.linalg.eigvalsh(A0.T @ A0).max()
    A_exp = np.maximum(A0 - sA * gA, 0)
    S_exp = np.maximum(S0 - sS * gS, 0)

    np.testing.assert_allclose(np.asarray(A1), A_exp, rtol=1e-7)
    np.testing.assert_allclose(np.asarray(S1), S_exp, rtol=1e-7)
    np.testing.assert_allclose(float(loss), np.sum(D * D) / 2, rtol=1e-10)


def test_explicit_step_2d_mesh(problem):
    """TP×DP: channel axis sharded over 'model', pixel axis over 'data'."""
    Y, A0, S0 = problem
    mesh = make_mesh(shape=(4, 2))
    step = make_nmf_pgm_step(mesh, model_axis="model")
    Ys, As, Ss, _ = shard_nmf_problem(mesh, Y, A0, S0, model_axis="model")
    A1, S1, loss = step(As, Ss, Ys)

    mesh1 = make_mesh()
    step1 = make_nmf_pgm_step(mesh1)
    Y1, A1r, S1r, _ = shard_nmf_problem(mesh1, Y, A0, S0)
    A1_ref, S1_ref, loss_ref = step1(A1r, S1r, Y1)

    np.testing.assert_allclose(np.asarray(A1), np.asarray(A1_ref), rtol=1e-7)
    np.testing.assert_allclose(np.asarray(S1), np.asarray(S1_ref), rtol=1e-7)
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-10)


def test_full_sharded_solve_matches_single_device(problem):
    Y, A0, S0 = problem
    A1, S1 = A0.copy(), S0.copy()
    pt.nmf.nmf(Y, A1, S1, e_rel=0, max_iter=30)

    mesh = make_mesh()
    res = nmf_pgm_sharded(Y, A0.copy(), S0.copy(), mesh=mesh,
                          e_rel=0, max_iter=30)
    A2, S2 = res.x
    np.testing.assert_allclose(np.asarray(A2), A1, rtol=1e-8, atol=1e-11)
    np.testing.assert_allclose(np.asarray(S2), S1, rtol=1e-8, atol=1e-11)
    assert res.iterations == 30


def test_full_sharded_solve_weighted(problem, rng):
    Y, A0, S0 = problem
    W = 0.5 + rng.random(Y.shape)

    A1, S1 = A0.copy(), S0.copy()
    pt.nmf.nmf(Y, A1, S1, W=W, e_rel=0, max_iter=15)

    res = nmf_pgm_sharded(Y, A0.copy(), S0.copy(), W=W,
                          mesh=make_mesh(), e_rel=0, max_iter=15)
    A2, S2 = res.x
    np.testing.assert_allclose(np.asarray(A2), A1, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(np.asarray(S2), S1, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("W", [0.5, "per_pixel_1d"])
def test_sharded_scalar_and_lower_rank_W_not_dropped(problem, rng, W):
    """Regression: a scalar (or 1-D per-pixel) W used to fall through
    the old ``ndim == 2`` weightedness test in nmf_pgm_sharded /
    nmf_adaprox_sharded and was silently DROPPED — the mesh route
    solved the unweighted problem. Lower-rank W must broadcast against
    Y exactly like the single-device engines' ``_promote_W``."""
    Y, A0, S0 = problem
    if W == "per_pixel_1d":
        W = 0.5 + rng.random(Y.shape[1])
    mesh = make_mesh()

    for algorithm in ("pgm", "adaprox"):
        A1, S1 = A0.copy(), S0.copy()
        pt.nmf.nmf(Y, A1, S1, W=W, algorithm=algorithm,
                   e_rel=0, max_iter=15)
        # guard: the weighting is observable. Uniform W barely moves
        # the ITERATES (pgm is exactly invariant — the inverse-
        # Lipschitz step cancels the gradient scaling; adam only
        # breaks it at eps scale), but the reported loss is
        # 0.5·Σ W R², so a silently dropped W shows as a ~1/W factor
        # in .loss between the weighted and unweighted mesh routes.
        if np.ndim(W) > 0:
            Au, Su = A0.copy(), S0.copy()
            pt.nmf.nmf(Y, Au, Su, algorithm=algorithm, e_rel=0,
                       max_iter=15)
            assert not np.allclose(S1, Su), algorithm
        else:
            solver = (nmf_pgm_sharded if algorithm == "pgm"
                      else nmf_adaprox_sharded)
            res_w = solver(Y, A0.copy(), S0.copy(), W=W, mesh=mesh,
                           e_rel=0, max_iter=15)
            res_u = solver(Y, A0.copy(), S0.copy(), mesh=mesh,
                           e_rel=0, max_iter=15)
            np.testing.assert_allclose(
                float(res_w.loss) / float(res_u.loss), W, rtol=1e-3,
                err_msg=f"{algorithm}: scalar W dropped by the mesh "
                        f"route (loss ratio should be ~W)")

        A2, S2 = A0.copy(), S0.copy()
        pt.nmf.nmf(Y, A2, S2, W=W, algorithm=algorithm,
                   e_rel=0, max_iter=15, mesh=mesh)
        np.testing.assert_allclose(A2, A1, rtol=1e-6, atol=1e-9,
                                   err_msg=algorithm)
        np.testing.assert_allclose(S2, S1, rtol=1e-6, atol=1e-9,
                                   err_msg=algorithm)


def test_unweighted_sharded_W_operand_aliases_Y(problem):
    """The unweighted whole-solves pass Y itself as the dead W operand
    (D = R; the builders never read it) instead of materializing a
    Y-sized all-ones plane — at capacity scale that plane is the
    difference between fitting and OOM."""
    Y, A0, S0 = problem
    from proxmin_tpu.parallel.sharding import (_classify_weight,
                                               _weight_shard)
    weighted, W2 = _classify_weight(1.0, np.shape(Y))
    assert not weighted
    Yj = jnp.asarray(Y)
    out = _weight_shard(None, W2, Yj, make_mesh(), "data", None,
                        weighted)
    assert out is Yj


def test_full_sharded_solve_2d(problem):
    Y, A0, S0 = problem
    A1, S1 = A0.copy(), S0.copy()
    pt.nmf.nmf(Y, A1, S1, e_rel=0, max_iter=20)

    res = nmf_pgm_sharded(Y, A0.copy(), S0.copy(),
                          mesh=make_mesh(shape=(4, 2)), model_axis="model",
                          e_rel=0, max_iter=20)
    A2, S2 = res.x
    np.testing.assert_allclose(np.asarray(A2), A1, rtol=1e-8, atol=1e-11)
    np.testing.assert_allclose(np.asarray(S2), S1, rtol=1e-8, atol=1e-11)


def test_prox_unity_sharded(problem):
    """Simplex projection along the sharded pixel axis needs the psum."""
    Y, A0, S0 = problem
    mesh = make_mesh()

    from jax import shard_map
    from jax.sharding import NamedSharding

    X = jnp.asarray(S0)
    Xs = jax.device_put(X, NamedSharding(mesh, P(None, "data")))

    fn = shard_map(
        lambda x: prox_unity_sharded(x, 0.5, axis=1, axis_name="data"),
        mesh=mesh, in_specs=P(None, "data"), out_specs=P(None, "data"),
    )
    out = np.asarray(jax.jit(fn)(Xs))
    expected = np.asarray(S0) / np.asarray(S0).sum(axis=1, keepdims=True)
    np.testing.assert_allclose(out, expected, rtol=1e-10)


def test_sharded_convergence_early_stop(problem):
    """e_rel > 0: the psum'd convergence flags stop the loop on device."""
    Y, A0, S0 = problem
    res = nmf_pgm_sharded(Y, A0.copy(), S0.copy(), mesh=make_mesh(),
                          e_rel=1e-2, max_iter=5000)
    assert res.iterations < 5000
    assert all(res.converged)


def test_weighted_sharded_loss_matches_likelihood(problem, rng):
    """Regression: the weighted loss is sum(W R^2)/2, not sum((WR)^2)/2."""
    Y, A0, S0 = problem
    W = 0.5 + rng.random(Y.shape)
    mesh = make_mesh()
    step = make_nmf_pgm_step(mesh, weighted=True)
    Ys, As, Ss, Ws = shard_nmf_problem(mesh, Y, A0, S0, W)
    _, _, loss = step(As, Ss, Ys, Ws)
    expected = float(pt.nmf.log_likelihood(
        jnp.asarray(A0), jnp.asarray(S0), Y=jnp.asarray(Y),
        W=jnp.asarray(W)))
    np.testing.assert_allclose(float(loss), expected, rtol=1e-10)

    res = nmf_pgm_sharded(Y, A0.copy(), S0.copy(), W=W, mesh=mesh,
                          e_rel=0, max_iter=2)
    assert np.isfinite(res.loss)


def test_auto_sharded_adaprox(problem):
    """The adaprox driver also runs on sharded inputs (auto-SPMD)."""
    Y, A0, S0 = problem
    A1, S1 = A0.copy(), S0.copy()
    pt.nmf.nmf(Y, A1, S1, algorithm="adaprox", e_rel=0, max_iter=15)

    mesh = make_mesh()
    Ys, As, Ss, _ = shard_nmf_problem(mesh, Y, A0, S0)
    res = pt.nmf.nmf(Ys, As, Ss, algorithm="adaprox", e_rel=0, max_iter=15)
    A2, S2 = res.x
    np.testing.assert_allclose(np.asarray(A2), A1, rtol=1e-8, atol=1e-11)
    np.testing.assert_allclose(np.asarray(S2), S1, rtol=1e-8, atol=1e-11)


def test_full_sharded_solve_weighted_2d(problem, rng):
    """Weighted solve on the 2-D TP×DP mesh exercises the psum+pmax
    assembly of the weighted Lipschitz bounds across both axes."""
    Y, A0, S0 = problem
    W = 0.5 + rng.random(Y.shape)

    A1, S1 = A0.copy(), S0.copy()
    pt.nmf.nmf(Y, A1, S1, W=W, e_rel=0, max_iter=10)

    res = nmf_pgm_sharded(Y, A0.copy(), S0.copy(), W=W,
                          mesh=make_mesh(shape=(4, 2)), model_axis="model",
                          e_rel=0, max_iter=10)
    A2, S2 = res.x
    np.testing.assert_allclose(np.asarray(A2), A1, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(np.asarray(S2), S1, rtol=1e-6, atol=1e-9)


def test_weighted_sharded_masked_pixels(problem, rng):
    """Regression: fully-masked pixels (W[:, n] == 0) must not NaN the
    weighted Lipschitz power iteration."""
    Y, A0, S0 = problem
    W = 0.5 + rng.random(Y.shape)
    W[:, 3] = 0.0   # a fully-masked pixel
    W[:, 17] = 0.0

    A1, S1 = A0.copy(), S0.copy()
    pt.nmf.nmf(Y, A1, S1, W=W, e_rel=0, max_iter=10)
    res = nmf_pgm_sharded(Y, A0.copy(), S0.copy(), W=W, mesh=make_mesh(),
                          e_rel=0, max_iter=10)
    A2, S2 = res.x
    assert np.isfinite(np.asarray(S2)).all()
    np.testing.assert_allclose(np.asarray(A2), A1, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(np.asarray(S2), S1, rtol=1e-6, atol=1e-9)


def test_auto_sharded_admm(problem):
    """The ADMM family also runs on sharded inputs via auto-SPMD."""
    Y, A0, S0 = problem
    x_np = S0.copy()

    def prox_f(v, step):
        return (v + step) / (1 + step)   # prox of 0.5||v - 1||^2

    def prox_g(v, step):
        return jnp.minimum(v, 0.8)

    r1 = pt.admm(jnp.asarray(x_np), prox_f, 0.5, prox_g=prox_g,
                 e_rel=1e-6, max_iter=500)

    from jax.sharding import NamedSharding
    mesh = make_mesh()
    xs = jax.device_put(jnp.asarray(x_np),
                        NamedSharding(mesh, P(None, "data")))
    r2 = pt.admm(xs, prox_f, 0.5, prox_g=prox_g, e_rel=1e-6, max_iter=500)
    np.testing.assert_allclose(np.asarray(r2.x), np.asarray(r1.x),
                               rtol=1e-9, atol=1e-12)
    assert r2.iterations == r1.iterations


def test_explicit_step_weighted_uses_weighted_lipschitz(problem, rng):
    """Regression: the explicit weighted step must use the weighted
    Lipschitz bounds — with W >> 1 the unweighted steps exceed 1/L and the
    iteration diverges."""
    Y, A0, S0 = problem
    W = np.full(Y.shape, 25.0)
    mesh = make_mesh()
    step = make_nmf_pgm_step(mesh, weighted=True)
    Ys, As, Ss, Ws = shard_nmf_problem(mesh, Y, A0, S0, W)
    losses = []
    for _ in range(30):
        As, Ss, loss = step(As, Ss, Ys, Ws)
        losses.append(float(loss))
    # simultaneous (Jacobi) block updates are not strictly monotone, but
    # with the correct weighted bounds the loss must descend overall; the
    # regression (unweighted steps with W=25) exploded to ~1e6 and grew
    assert np.isfinite(losses[-1])
    assert losses[-1] < losses[0] * 0.9
    assert losses[-1] < 1e4


def test_auto_sharded_bsdmm_cmf_1d(problem, rng):
    """VERDICT r1 #5: bsdmm-backed (weighted) CMF on sharded inputs must
    match the single-device solve, like the PGM suite above."""
    Y, A0, S0 = problem
    W = 0.5 + rng.random(Y.shape)

    A1, S1 = A0.copy(), S0.copy()
    pt.nmf.nmf(Y, A1, S1, W=W, algorithm="bsdmm", e_rel=0, max_iter=15)

    mesh = make_mesh()
    Ys, As, Ss, Ws = shard_nmf_problem(mesh, Y, A0, S0, W)
    res = pt.nmf.nmf(Ys, As, Ss, W=Ws, algorithm="bsdmm", e_rel=0,
                     max_iter=15)
    A2, S2 = res.x
    np.testing.assert_allclose(np.asarray(A2), A1, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(S2), S1, rtol=1e-8, atol=1e-10)


def test_auto_sharded_bsdmm_cmf_2d(problem, rng):
    """bsdmm CMF on a 2-D data x model mesh (pixel + channel sharding)."""
    Y, A0, S0 = problem
    A1, S1 = A0.copy(), S0.copy()
    pt.nmf.nmf(Y, A1, S1, algorithm="bsdmm", e_rel=0, max_iter=15)

    mesh = make_mesh(shape=(4, 2), axis_names=("data", "model"))
    Ys, As, Ss, _ = shard_nmf_problem(mesh, Y, A0, S0,
                                      model_axis="model")
    res = pt.nmf.nmf(Ys, As, Ss, algorithm="bsdmm", e_rel=0, max_iter=15)
    A2, S2 = res.x
    np.testing.assert_allclose(np.asarray(A2), A1, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(S2), S1, rtol=1e-8, atol=1e-10)


def test_auto_sharded_sdmm(problem):
    """sdmm (M=2 constraints) on sharded inputs matches single-device."""
    Y, A0, S0 = problem
    x_np = S0.copy()

    def prox_f(v, step):
        return (v + step) / (1 + step)

    proxs_g = [lambda v, s: jnp.minimum(v, 0.8), operators.prox_plus]

    r1 = pt.sdmm(jnp.asarray(x_np), prox_f, 0.5, proxs_g=proxs_g,
                 e_rel=1e-6, max_iter=300)

    from jax.sharding import NamedSharding
    mesh = make_mesh()
    xs = jax.device_put(jnp.asarray(x_np),
                        NamedSharding(mesh, P(None, "data")))
    r2 = pt.sdmm(xs, prox_f, 0.5, proxs_g=proxs_g,
                 e_rel=1e-6, max_iter=300)
    np.testing.assert_allclose(np.asarray(r2.x), np.asarray(r1.x),
                               rtol=1e-9, atol=1e-12)
    assert r2.iterations == r1.iterations


def test_auto_sharded_admm_2d_mesh(problem):
    """ADMM on a 2-D mesh with both axes of x sharded."""
    Y, A0, S0 = problem
    x_np = Y.copy()   # (6, 64): shard channels over 'model', pixels 'data'

    def prox_f(v, step):
        return (v + step) / (1 + step)

    def prox_g(v, step):
        return jnp.minimum(v, 0.8)

    r1 = pt.admm(jnp.asarray(x_np), prox_f, 0.5, prox_g=prox_g,
                 e_rel=1e-6, max_iter=300)

    from jax.sharding import NamedSharding
    mesh = make_mesh(shape=(4, 2), axis_names=("data", "model"))
    xs = jax.device_put(jnp.asarray(x_np),
                        NamedSharding(mesh, P("model", "data")))
    r2 = pt.admm(xs, prox_f, 0.5, prox_g=prox_g, e_rel=1e-6, max_iter=300)
    np.testing.assert_allclose(np.asarray(r2.x), np.asarray(r1.x),
                               rtol=1e-9, atol=1e-12)
    assert r2.iterations == r1.iterations


def test_full_sharded_solve_weighted_stride(problem, rng):
    """step_stride on the all-device sharded solve: same basin as the
    exact-steps run, refreshes in the carry (collective-safe: every
    shard takes the same branch)."""
    Y, A0, S0 = problem
    W = 0.5 + rng.random(Y.shape)
    mesh = make_mesh()

    r_exact = nmf_pgm_sharded(Y, A0.copy(), S0.copy(), W=W, mesh=mesh,
                              e_rel=0, max_iter=60)
    r_strided = nmf_pgm_sharded(Y, A0.copy(), S0.copy(), W=W, mesh=mesh,
                                e_rel=0, max_iter=60, step_stride=10)
    Wj, Yj = jnp.asarray(W), jnp.asarray(Y)
    l0 = float(pt.nmf.log_likelihood(jnp.asarray(A0), jnp.asarray(S0),
                                     Y=Yj, W=Wj))
    le = float(pt.nmf.log_likelihood(*r_exact.x, Y=Yj, W=Wj))
    ls = float(pt.nmf.log_likelihood(*r_strided.x, Y=Yj, W=Wj))
    assert np.isfinite(ls)
    assert le < 0.05 * l0
    assert ls < 0.05 * l0


def test_nmf_mesh_kwarg_pgm(problem):
    """One-call scale-out: nmf(mesh=...) == single-device solve (pgm
    routes to the explicit-collective whole-solve shard_map)."""
    Y, A0, S0 = problem
    A1, S1 = A0.copy(), S0.copy()
    pt.nmf.nmf(Y, A1, S1, e_rel=0, max_iter=20)

    res = pt.nmf.nmf(Y, A0.copy(), S0.copy(), e_rel=0, max_iter=20,
                     mesh=make_mesh())
    A2, S2 = res.x
    np.testing.assert_allclose(np.asarray(A2), A1, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(S2), S1, rtol=1e-9, atol=1e-12)


def test_nmf_mesh_kwarg_weighted_stride(problem, rng):
    Y, A0, S0 = problem
    W = 0.5 + rng.random(Y.shape)
    res = pt.nmf.nmf(Y, A0.copy(), S0.copy(), W=W, e_rel=0, max_iter=30,
                     mesh=make_mesh(), step_stride=10)
    assert np.isfinite(np.asarray(res.x[1])).all()


def test_nmf_mesh_kwarg_adaprox(problem):
    """Non-pgm algorithms go through auto-SPMD under mesh=...; result
    matches the single-device run and writes back to NumPy inputs."""
    Y, A0, S0 = problem
    A1, S1 = A0.copy(), S0.copy()
    pt.nmf.nmf(Y, A1, S1, algorithm="adaprox", e_rel=0, max_iter=15)

    A2, S2 = A0.copy(), S0.copy()
    pt.nmf.nmf(Y, A2, S2, algorithm="adaprox", e_rel=0, max_iter=15,
               mesh=make_mesh())
    np.testing.assert_allclose(A2, A1, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(S2, S1, rtol=1e-9, atol=1e-12)


def test_full_sharded_solve_weighted_stride_matches_single_device(problem,
                                                                  rng):
    """The sharded segmented strided solve uses the SAME warm-started
    refresh schedule (cold 48 passes, warm 12, 0.9 safety) as the
    single-device WeightedPGMStepper path, and the per-pixel power
    iterations are shard-local — so the two must agree to collective
    summation noise."""
    Y, A0, S0 = problem
    W = 0.5 + rng.random(Y.shape)

    A1, S1 = A0.copy(), S0.copy()
    pt.nmf.nmf(Y, A1, S1, W=W, e_rel=0, max_iter=40, step_stride=10)

    r = nmf_pgm_sharded(Y, A0.copy(), S0.copy(), W=W, mesh=make_mesh(),
                        e_rel=0, max_iter=40, step_stride=10)
    np.testing.assert_allclose(np.asarray(r.x[0]), A1, rtol=1e-8,
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(r.x[1]), S1, rtol=1e-8,
                               atol=1e-10)


def test_full_sharded_solve_multi_level_data_axes(problem, rng):
    """Multi-level layout: the pixel axis sharded over TWO mesh axes
    (e.g. across hosts, then within a host) must match the
    single-device solve; psum/pmax complete over both axes. Weighted +
    strided exercises the warm-start refresh collectives too."""
    Y, A0, S0 = problem
    mesh = make_mesh(shape=(2, 4), axis_names=("dcn", "data"))

    A1, S1 = A0.copy(), S0.copy()
    pt.nmf.nmf(Y, A1, S1, e_rel=0, max_iter=25)
    r = nmf_pgm_sharded(Y, A0.copy(), S0.copy(), mesh=mesh,
                        data_axis=("dcn", "data"), e_rel=0, max_iter=25)
    np.testing.assert_allclose(np.asarray(r.x[0]), A1, rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(r.x[1]), S1, rtol=1e-9,
                               atol=1e-12)

    W = 0.5 + rng.random(Y.shape)
    A2, S2 = A0.copy(), S0.copy()
    pt.nmf.nmf(Y, A2, S2, W=W, e_rel=0, max_iter=30, step_stride=10)
    r2 = nmf_pgm_sharded(Y, A0.copy(), S0.copy(), W=W, mesh=mesh,
                         data_axis=("dcn", "data"), e_rel=0, max_iter=30,
                         step_stride=10)
    np.testing.assert_allclose(np.asarray(r2.x[1]), S2, rtol=1e-8,
                               atol=1e-10)


def test_sharded_solve_step_adapt(rng):
    """step_adapt inside the whole-solve shard_map: the adaptive
    segment lengths are derived from replicated scalars, so the solve
    completes with collectives intact and matches the fixed-stride
    result quality."""
    import jax.numpy as jnp
    from proxmin_tpu.parallel import make_mesh, nmf_pgm_sharded
    from proxmin_tpu.nmf import log_likelihood

    C, K, N = 4, 3, 64
    Y = rng.random((C, K)).astype(np.float32) @ \
        rng.random((K, N)).astype(np.float32)
    W = (0.5 + rng.random((C, N))).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)
    mesh = make_mesh()

    r_fix = nmf_pgm_sharded(Y, A0.copy(), S0.copy(), W=W, mesh=mesh,
                            e_rel=0, max_iter=120, step_stride=10)
    r_ad = nmf_pgm_sharded(Y, A0.copy(), S0.copy(), W=W, mesh=mesh,
                           e_rel=0, max_iter=120, step_stride=10,
                           step_adapt=True)
    assert r_ad.iterations == 120
    l0 = float(log_likelihood(jnp.asarray(A0), jnp.asarray(S0),
                              Y=jnp.asarray(Y), W=jnp.asarray(W)))
    assert r_ad.loss < 0.1 * l0
    assert r_ad.loss < 1.5 * r_fix.loss + 1e-6

    # and through the one-call nmf(mesh=...) route
    import proxmin_tpu as pt
    r = pt.nmf.nmf(Y, A0.copy(), S0.copy(), W=W, mesh=mesh, e_rel=0,
                   max_iter=60, step_adapt=True)
    assert r.iterations == 60


# ---------------------------------------------------------------------------
# multi-chip serving artifacts (export of the sharded whole-solve)

def _f32_problem(rng, C=6, K=3, N=64):
    A_true = rng.random((C, K)).astype(np.float32)
    S_true = rng.random((K, N)).astype(np.float32)
    Y = (A_true @ S_true
         + 0.01 * rng.standard_normal((C, N))).astype(np.float32)
    return Y, rng.random((C, K)).astype(np.float32), \
        rng.random((K, N)).astype(np.float32)


def _put_sharded(mesh, Y, A0, S0, W=None):
    from jax.sharding import NamedSharding

    put = lambda x, spec: jax.device_put(  # noqa: E731
        jnp.asarray(x), NamedSharding(mesh, spec))
    out = (put(A0, P(None, None)), put(S0, P(None, "data")),
           put(Y, P(None, "data")))
    if W is not None:
        out += (put(W, P(None, "data")),)
    return out + (jax.device_put(jnp.int32(0),
                                 NamedSharding(mesh, P())),)


def test_export_sharded_roundtrip_runtime_max_iter(rng):
    """The exported sharded whole-solve artifact reproduces
    nmf_pgm_sharded exactly, and ONE artifact serves different runtime
    iteration budgets (max_iter is a replicated runtime scalar)."""
    from jax import export as jax_export
    from jax.sharding import NamedSharding

    from proxmin_tpu.export import export_nmf_pgm_sharded

    Y, A0, S0 = _f32_problem(rng)
    mesh = make_mesh()
    blob = export_nmf_pgm_sharded(mesh, 6, 3, 64, e_rel=0.0)
    call = jax_export.deserialize(blob).call

    A_d, S_d, Y_d, _ = _put_sharded(mesh, Y, A0, S0)
    mi = lambda n: jax.device_put(  # noqa: E731
        jnp.int32(n), NamedSharding(mesh, P()))
    for n in (7, 20):
        A1, S1, it, cA, cS, loss = call(A_d, S_d, Y_d, mi(n))
        assert int(it) == n
        ref = nmf_pgm_sharded(Y, A0.copy(), S0.copy(), mesh=mesh,
                              e_rel=0, max_iter=n)
        np.testing.assert_allclose(np.asarray(A1), np.asarray(ref.x[0]),
                                   rtol=1e-6)
        np.testing.assert_allclose(np.asarray(S1), np.asarray(ref.x[1]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(loss), ref.loss, rtol=1e-5)


def test_export_sharded_weighted_strided(rng):
    """Weighted + segmented strided refresh bakes into the artifact and
    matches the live sharded solve."""
    from jax import export as jax_export
    from jax.sharding import NamedSharding

    from proxmin_tpu.export import export_nmf_pgm_sharded

    Y, A0, S0 = _f32_problem(rng)
    W = (0.5 + rng.random(Y.shape)).astype(np.float32)
    mesh = make_mesh()
    blob = export_nmf_pgm_sharded(mesh, 6, 3, 64, e_rel=0.0,
                                  weighted=True, step_stride=4)
    call = jax_export.deserialize(blob).call

    A_d, S_d, Y_d, W_d, _ = _put_sharded(mesh, Y, A0, S0, W)
    n = jax.device_put(jnp.int32(13), NamedSharding(mesh, P()))
    outs = call(A_d, S_d, Y_d, W_d, n)
    # strided artifacts append the resume carries after loss
    assert len(outs) == 11
    A1, S1, it, cA, cS, loss = outs[:6]
    assert int(it) == 13
    ref = nmf_pgm_sharded(Y, A0.copy(), S0.copy(), W=W, mesh=mesh,
                          e_rel=0, max_iter=13, step_stride=4)
    np.testing.assert_allclose(np.asarray(S1), np.asarray(ref.x[1]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(loss), ref.loss, rtol=1e-5)


def test_export_sharded_serves_without_library(tmp_path, rng):
    """Pod-serving claim end-to-end: the sharded artifact is loaded in a
    CLEAN subprocess (8 virtual devices, proxmin_tpu never imported),
    driven on a fresh mesh, and matches the in-process sharded solve."""
    import os
    import subprocess
    import sys as _sys

    from proxmin_tpu.export import export_nmf_pgm_sharded, save_exported

    Y, A0, S0 = _f32_problem(rng)
    mesh = make_mesh()
    blob = export_nmf_pgm_sharded(mesh, 6, 3, 64, e_rel=0.0)
    p = save_exported(str(tmp_path / "sharded.bin"), blob)
    np.savez(str(tmp_path / "problem.npz"), Y=Y, A0=A0, S0=S0)

    script = (
        "import sys\n"
        "import numpy as np\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "import jax.numpy as jnp\n"
        "from jax.sharding import Mesh, NamedSharding\n"
        "from jax.sharding import PartitionSpec as P\n"
        "from jax import export as jax_export\n"
        "assert jax.device_count() >= 8, jax.devices()\n"
        "mesh = Mesh(np.array(jax.devices()[:8]), ('data',))\n"
        "call = jax_export.deserialize(\n"
        "    open(sys.argv[1], 'rb').read()).call\n"
        "d = np.load(sys.argv[2])\n"
        "put = lambda x, s: jax.device_put(jnp.asarray(x),\n"
        "                                  NamedSharding(mesh, s))\n"
        "out = call(put(d['A0'], P(None, None)),\n"
        "           put(d['S0'], P(None, 'data')),\n"
        "           put(d['Y'], P(None, 'data')),\n"
        "           put(jnp.int32(15), P()))\n"
        "assert 'proxmin_tpu' not in sys.modules\n"
        "np.savez(sys.argv[3], A1=np.asarray(out[0]),\n"
        "         S1=np.asarray(out[1]), it=np.asarray(out[2]))\n"
        "print('served-sharded')\n"
    )
    out = str(tmp_path / "served.npz")
    env = dict(os.environ)
    flags = env.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        env["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    repo_root = os.path.dirname(os.path.dirname(
        os.path.abspath(pt.__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        p_ for p_ in env.get("PYTHONPATH", "").split(os.pathsep)
        if p_ and os.path.abspath(p_) != repo_root)
    r = subprocess.run(
        [_sys.executable, "-c", script, p,
         str(tmp_path / "problem.npz"), out],
        env=env, cwd=str(tmp_path), timeout=240, capture_output=True)
    assert r.returncode == 0, r.stderr.decode()[-800:]
    assert b"served-sharded" in r.stdout

    served = np.load(out)
    assert int(served["it"]) == 15
    ref = nmf_pgm_sharded(Y, A0.copy(), S0.copy(), mesh=make_mesh(),
                          e_rel=0, max_iter=15)
    np.testing.assert_allclose(served["A1"], np.asarray(ref.x[0]),
                               rtol=1e-6)
    np.testing.assert_allclose(served["S1"], np.asarray(ref.x[1]),
                               rtol=1e-6)


def test_export_sharded_cross_platform(rng):
    """platforms=('cuda','cpu'): the sharded artifact lowers for both
    platforms (no platform-specific custom calls) and serves on CPU."""
    from jax import export as jax_export
    from jax.sharding import NamedSharding

    from proxmin_tpu.export import export_nmf_pgm_sharded

    Y, A0, S0 = _f32_problem(rng, C=4, K=3, N=64)
    mesh = make_mesh()
    blob = export_nmf_pgm_sharded(mesh, 4, 3, 64, e_rel=0.0,
                                  platforms=("cuda", "cpu"))
    exp = jax_export.deserialize(blob)
    assert set(exp.platforms) == {"cuda", "cpu"}
    A_d, S_d, Y_d, _ = _put_sharded(mesh, Y, A0, S0)
    n = jax.device_put(jnp.int32(9), NamedSharding(mesh, P()))
    A1, S1, it, *_ = exp.call(A_d, S_d, Y_d, n)
    assert int(it) == 9
    ref = nmf_pgm_sharded(Y, A0.copy(), S0.copy(), mesh=mesh,
                          e_rel=0, max_iter=9)
    np.testing.assert_allclose(np.asarray(S1), np.asarray(ref.x[1]),
                               rtol=1e-6)


def test_export_sharded_artifact_only_resume(rng):
    """Preemption entirely through artifacts: a fresh weighted strided
    artifact runs 10 iterations, its returned carries feed the
    resume=True artifact for 15 more, and the result matches the live
    uninterrupted 25-iteration sharded solve exactly."""
    from jax import export as jax_export
    from jax.sharding import NamedSharding

    from proxmin_tpu.export import export_nmf_pgm_sharded

    Y, A0, S0 = _f32_problem(rng)
    W = (0.5 + rng.random(Y.shape)).astype(np.float32)
    mesh = make_mesh()
    kw = dict(e_rel=0.0, weighted=True, step_stride=4)
    fresh = jax_export.deserialize(
        export_nmf_pgm_sharded(mesh, 6, 3, 64, **kw)).call
    cont = jax_export.deserialize(
        export_nmf_pgm_sharded(mesh, 6, 3, 64, resume=True, **kw)).call

    A_d, S_d, Y_d, W_d, _ = _put_sharded(mesh, Y, A0, S0, W)
    rep = lambda v: jax.device_put(v, NamedSharding(mesh, P()))  # noqa: E731

    outs = fresh(A_d, S_d, Y_d, W_d, rep(jnp.int32(10)))
    A_m, S_m, it = outs[0], outs[1], outs[2]
    assert int(it) == 10

    # resume carries are exactly the artifact outputs from position 2
    # on: (it, conv_A, conv_S, loss, step_A, step_S, stride, seg_end, v)
    outs2 = cont(A_m, S_m, Y_d, W_d, rep(jnp.int32(15)),
                 *(rep(o) for o in outs[2:-1]), outs[-1])
    assert int(outs2[2]) == 25

    ref = nmf_pgm_sharded(Y, A0.copy(), S0.copy(), W=W, mesh=mesh,
                          e_rel=0, max_iter=25, step_stride=4)
    np.testing.assert_allclose(np.asarray(outs2[1]), np.asarray(ref.x[1]),
                               rtol=0, atol=0)
    np.testing.assert_allclose(np.asarray(outs2[0]), np.asarray(ref.x[0]),
                               rtol=0, atol=0)


def test_export_sharded_2d_mesh(rng):
    """The artifact bakes a 2-D TP×DP topology too (model-sharded A/Y
    rows, data-sharded pixels) and matches the live 2-D sharded solve."""
    from jax import export as jax_export
    from jax.sharding import NamedSharding

    from proxmin_tpu.export import export_nmf_pgm_sharded

    Y, A0, S0 = _f32_problem(rng)
    mesh = make_mesh(shape=(4, 2))
    blob = export_nmf_pgm_sharded(mesh, 6, 3, 64, e_rel=0.0,
                                  model_axis="model")
    call = jax_export.deserialize(blob).call
    put = lambda x, s: jax.device_put(  # noqa: E731
        jnp.asarray(x), NamedSharding(mesh, s))
    out = call(put(A0, P("model", None)), put(S0, P(None, "data")),
               put(Y, P("model", "data")),
               jax.device_put(jnp.int32(12), NamedSharding(mesh, P())))
    ref = nmf_pgm_sharded(Y, A0.copy(), S0.copy(), mesh=mesh,
                          model_axis="model", e_rel=0, max_iter=12)
    np.testing.assert_allclose(np.asarray(out[1]), np.asarray(ref.x[1]),
                               rtol=1e-6)


def test_export_sharded_adaprox_matches_live_driver(rng):
    """The sharded adaprox artifact (auto-SPMD, runtime max_iter, (1,)
    clamped b1 schedule) reproduces the live adaprox nmf() solve."""
    from jax import export as jax_export
    from jax.sharding import NamedSharding

    from proxmin_tpu.export import export_nmf_adaprox_sharded

    Y, A0, S0 = _f32_problem(rng)
    mesh = make_mesh()
    blob = export_nmf_adaprox_sharded(mesh, 6, 3, 64, e_rel=0.0,
                                      dtype=jnp.float64)
    call = jax_export.deserialize(blob).call
    put = lambda x, s: jax.device_put(  # noqa: E731
        jnp.asarray(x, jnp.float64), NamedSharding(mesh, s))
    rep = lambda v: jax.device_put(v, NamedSharding(mesh, P()))  # noqa: E731
    A_d, S_d, Y_d = (put(A0, P(None, None)), put(S0, P(None, "data")),
                     put(Y, P(None, "data")))
    for n_it in (6, 20):
        out = call(A_d, S_d, Y_d, rep(jnp.int32(n_it)))
        assert int(out[8]) == n_it
        live = pt.nmf.nmf(Y.astype(np.float64), A0.astype(np.float64),
                          S0.astype(np.float64), algorithm="adaprox",
                          e_rel=0, max_iter=n_it)
        np.testing.assert_allclose(np.asarray(out[1]),
                                   np.asarray(live.x[1]),
                                   rtol=1e-9, atol=1e-12)


def test_export_sharded_adaprox_warm_continuation(rng):
    """Artifact-only adaprox preemption: fresh 8 iters -> moments +
    clock feed the warm_start artifact for 12 more == live 20."""
    from jax import export as jax_export
    from jax.sharding import NamedSharding

    from proxmin_tpu.export import export_nmf_adaprox_sharded

    Y, A0, S0 = _f32_problem(rng)
    W = (0.5 + rng.random(Y.shape)).astype(np.float32)
    mesh = make_mesh()
    kw = dict(e_rel=0.0, weighted=True, scheme="amsgrad",
              dtype=jnp.float64)
    fresh = jax_export.deserialize(
        export_nmf_adaprox_sharded(mesh, 6, 3, 64, **kw)).call
    cont = jax_export.deserialize(
        export_nmf_adaprox_sharded(mesh, 6, 3, 64, warm_start=True,
                                   **kw)).call
    put = lambda x, s: jax.device_put(  # noqa: E731
        jnp.asarray(x, jnp.float64), NamedSharding(mesh, s))
    rep = lambda v: jax.device_put(v, NamedSharding(mesh, P()))  # noqa: E731
    A_d, S_d = put(A0, P(None, None)), put(S0, P(None, "data"))
    Y_d, W_d = put(Y, P(None, "data")), put(W, P(None, "data"))

    o = fresh(A_d, S_d, Y_d, W_d, rep(jnp.int32(8)))
    # warm carries = outputs 2..7 (moments) then 8..11 (clock +
    # terminal flags), fed straight back in
    o2 = cont(o[0], o[1], Y_d, W_d, rep(jnp.int32(12)),
              o[2], o[3], o[4], o[5], o[6], o[7],
              rep(jnp.asarray(o[8], jnp.int32)),
              rep(o[9]), rep(o[10]), rep(o[11]))
    assert int(o2[8]) == 20

    live = pt.nmf.nmf(Y.astype(np.float64), A0.astype(np.float64),
                      S0.astype(np.float64), W=W.astype(np.float64),
                      algorithm="adaprox", scheme="amsgrad",
                      e_rel=0, max_iter=20)
    np.testing.assert_allclose(np.asarray(o2[1]), np.asarray(live.x[1]),
                               rtol=1e-9, atol=1e-12)


def test_sharded_and_fused_divergence_detection(rng):
    """Failure detection on the fused and sharded engines: a NaN input
    stops the loop early with status='diverged' instead of burning the
    full iteration budget on NaNs."""
    Y, A0, S0 = _f32_problem(rng, C=4, K=3, N=256)
    Y_bad = Y.copy()
    Y_bad[0, 0] = np.nan

    r = nmf_pgm_sharded(Y_bad, A0.copy(), S0.copy(), mesh=make_mesh(),
                        e_rel=0, max_iter=500)
    assert r.status == "diverged"
    assert r.iterations < 500

    r2 = pt.nmf.nmf_pgm_fused(Y_bad, A0.copy(), S0.copy(), e_rel=0,
                              max_iter=500, tile_n=128)
    assert r2.status == "diverged"
    assert r2.iterations < 500

    r3 = pt.nmf.nmf_adaprox_fused(Y_bad, A0.copy(), S0.copy(), e_rel=0,
                                  max_iter=500, tile_n=128)
    assert r3.status == "diverged"
    assert r3.iterations < 500

    # healthy solves keep their status
    r4 = nmf_pgm_sharded(Y, A0.copy(), S0.copy(), mesh=make_mesh(),
                         e_rel=0, max_iter=10)
    assert r4.status == "max_iter" and r4.iterations == 10


# ---------------------------------------------------------------------------
# Explicit-collective sharded adaprox (VERDICT r4 #5)

def test_full_sharded_adaprox_matches_single_device(problem):
    """The explicit shard_map proximal-Adam whole-solve must match the
    single-device adaprox driver: same Jacobi update from one residual,
    same alpha row/column means, same bias-corrected Phi/Psi."""
    from proxmin_tpu.parallel import nmf_adaprox_sharded

    Y, A0, S0 = problem
    A1, S1 = A0.copy(), S0.copy()
    pt.nmf.nmf(Y, A1, S1, algorithm="adaprox", e_rel=0, max_iter=20)

    res = nmf_adaprox_sharded(Y, A0.copy(), S0.copy(), mesh=make_mesh(),
                              e_rel=0, max_iter=20)
    np.testing.assert_allclose(np.asarray(res.x[0]), A1, rtol=1e-8,
                               atol=1e-11)
    np.testing.assert_allclose(np.asarray(res.x[1]), S1, rtol=1e-8,
                               atol=1e-11)
    assert res.iterations == 20
    assert res.state["kind"] == "nmf_adaprox_sharded"


def test_full_sharded_adaprox_weighted_2d(problem, rng):
    """Weighted + 2-D (model x data) mesh: gradients psum over the
    correct axes; result matches the single-device weighted adaprox."""
    from proxmin_tpu.parallel import nmf_adaprox_sharded

    Y, A0, S0 = problem
    W = 0.5 + rng.random(Y.shape)
    A1, S1 = A0.copy(), S0.copy()
    pt.nmf.nmf(Y, A1, S1, W=W, algorithm="adaprox", e_rel=0, max_iter=20)

    mesh = make_mesh(shape=(2, 4), axis_names=("model", "data"))
    res = nmf_adaprox_sharded(Y, A0.copy(), S0.copy(), W=W, mesh=mesh,
                              model_axis="model", e_rel=0, max_iter=20)
    np.testing.assert_allclose(np.asarray(res.x[0]), A1, rtol=1e-7,
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(res.x[1]), S1, rtol=1e-7,
                               atol=1e-10)


def test_sharded_adaprox_resume_bit_exact(problem):
    """Kill-point drill: 12 iterations + state= continuation of 8 must
    land bit-identically on the uninterrupted 20-iteration solve (the
    moments and the global Adam bias-correction clock carry through)."""
    from proxmin_tpu.parallel import nmf_adaprox_sharded

    Y, A0, S0 = problem
    mesh = make_mesh()
    kw = dict(mesh=mesh, e_rel=0, max_iter=20)
    full = nmf_adaprox_sharded(Y, A0.copy(), S0.copy(), **kw)

    half = nmf_adaprox_sharded(Y, A0.copy(), S0.copy(), mesh=mesh,
                               e_rel=0, max_iter=12)
    resumed = nmf_adaprox_sharded(Y, half.x[0], half.x[1], mesh=mesh,
                                  e_rel=0, max_iter=8, state=half.state)
    assert resumed.iterations == 8
    np.testing.assert_array_equal(np.asarray(resumed.x[0]),
                                  np.asarray(full.x[0]))
    np.testing.assert_array_equal(np.asarray(resumed.x[1]),
                                  np.asarray(full.x[1]))


def test_nmf_mesh_adaprox_routes_explicit(problem):
    """nmf(mesh=, algorithm='adaprox') with the default adam scheme and
    separable proxs rides the explicit-collective whole-solve (state
    kind proves the route) and still matches the single-device run."""
    Y, A0, S0 = problem
    A1, S1 = A0.copy(), S0.copy()
    pt.nmf.nmf(Y, A1, S1, algorithm="adaprox", e_rel=0, max_iter=15)

    A2, S2 = A0.copy(), S0.copy()
    res = pt.nmf.nmf(Y, A2, S2, algorithm="adaprox", e_rel=0,
                     max_iter=15, mesh=make_mesh())
    assert res.state["kind"] == "nmf_adaprox_sharded"
    np.testing.assert_allclose(A2, A1, rtol=1e-8, atol=1e-11)
    np.testing.assert_allclose(S2, S1, rtol=1e-8, atol=1e-11)


def test_nmf_mesh_adaprox_nonseparable_falls_back(problem):
    """A non-separable scheme opt-out (separable_prox=False) keeps the
    audited auto-SPMD route — no sharded-adaprox state kind."""
    Y, A0, S0 = problem
    A1, S1 = A0.copy(), S0.copy()
    pt.nmf.nmf(Y, A1, S1, algorithm="adaprox", e_rel=0, max_iter=15,
               separable_prox=False)

    A2, S2 = A0.copy(), S0.copy()
    res = pt.nmf.nmf(Y, A2, S2, algorithm="adaprox", e_rel=0,
                     max_iter=15, separable_prox=False, mesh=make_mesh())
    st = getattr(res, "state", None)
    assert not (hasattr(st, "get")
                and st.get("kind") == "nmf_adaprox_sharded")
    np.testing.assert_allclose(A2, A1, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(S2, S1, rtol=1e-9, atol=1e-12)


def test_sharded_adaprox_resume_wrong_mesh_state_raises(problem):
    """Passing a sharded-adaprox state back through nmf() without
    mesh=, or to a non-eligible call, fails loudly instead of silently
    restarting."""
    from proxmin_tpu.parallel import nmf_adaprox_sharded

    Y, A0, S0 = problem
    half = nmf_adaprox_sharded(Y, A0.copy(), S0.copy(),
                               mesh=make_mesh(), e_rel=0, max_iter=5)
    with pytest.raises(ValueError, match="sharded"):
        pt.nmf.nmf(Y, A0.copy(), S0.copy(), algorithm="adaprox",
                   e_rel=0, max_iter=5, state=half.state)
