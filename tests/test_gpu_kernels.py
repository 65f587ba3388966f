"""Compiled fused kernels on a CUDA GPU (``pytest -m gpu`` there; skipped
elsewhere by the fixture in conftest.py).

The CPU suite checks the kernels' arithmetic in Pallas's interpreter; these
tests check that the Triton-compiled kernels agree with it and with the
XLA engine at a ragged pixel count.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import proxmin_tpu as pt
from proxmin_tpu.ops.nmf_kernels import (
    fused_nmf_adaprox_step,
    fused_nmf_pgm_step,
)

pytestmark = pytest.mark.gpu

# f32 sums over the pixels in another order than the interpreter's
RTOL = 1e-5


def _problem(C=5, K=7, N=10_007, weighted=False, seed=0):
    rng = np.random.default_rng(seed)
    A = jnp.asarray(rng.random((C, K), np.float32))
    S = jnp.asarray(rng.random((K, N), np.float32))
    Y = jnp.asarray(rng.random((C, N), np.float32))
    W = (jnp.asarray((0.5 + rng.random((C, N))).astype(np.float32))
         if weighted else None)
    return A, S, Y, W


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.max(np.abs(a - b)) <= RTOL * max(np.max(np.abs(b)), 1e-30)


@pytest.mark.parametrize("C", [5, 40])
@pytest.mark.parametrize("weighted", [False, True])
def test_compiled_pgm_step_matches_interpreter(C, weighted):
    A, S, Y, W = _problem(C=C, weighted=weighted)
    out_c = fused_nmf_pgm_step(A, S, Y, 0.01, W=W, interpret=False)
    out_i = fused_nmf_pgm_step(A, S, Y, 0.01, W=W, interpret=True)
    for a, b in zip(out_c, out_i):
        _close(a, b)


@pytest.mark.parametrize("weighted", [False, True])
def test_compiled_adaprox_step_matches_interpreter(weighted):
    A, S, Y, W = _problem(weighted=weighted)
    M = jnp.zeros_like(S)
    alpha = jnp.full((S.shape[0],), 1e-3, jnp.float32)
    sc = jnp.asarray([0.9, 10.0, 1000.0], jnp.float32)
    out_c = fused_nmf_adaprox_step(A, S, M, M, Y, alpha, sc, W=W,
                                   interpret=False)
    out_i = fused_nmf_adaprox_step(A, S, M, M, Y, alpha, sc, W=W,
                                   interpret=True)
    for a, b in zip(out_c, out_i):
        _close(a, b)


@pytest.mark.parametrize("algorithm", ["pgm", "adaprox"])
def test_fused_engine_tracks_xla_engine(algorithm):
    """Ten iterations on both engines; the XLA engine's pixel-axis
    contractions run at the platform's default precision."""
    A, S, Y, _ = _problem()
    kw = dict(algorithm=algorithm, e_rel=0, max_iter=10)
    if algorithm == "adaprox":
        kw["separable_prox"] = "auto"   # the fused engine's closed form
    r_pal = pt.nmf.nmf(Y, A, S, engine="pallas", **kw)
    r_xla = pt.nmf.nmf(Y, A, S, engine="xla", **kw)
    for a, b in zip(r_pal.x, r_xla.x):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        # max error relative to the largest entry, as chip_smoke.py (a)
        assert np.max(np.abs(a - b)) <= 1e-3 * np.max(np.abs(b))


@pytest.mark.parametrize("weighted", [False, True])
def test_fused_export_round_trip(weighted):
    """The serialized fused solver (with its Triton calls) runs on the
    card and reproduces the live fused solve."""
    # jax.export serializes through flatbuffers, an optional dependency
    pytest.importorskip("flatbuffers")
    from proxmin_tpu.export import export_nmf_solver, load_solver

    A, S, Y, W = _problem(N=4096, weighted=weighted)
    C, K = A.shape
    N = S.shape[1]
    kw = dict(step_stride=5) if weighted else {}
    blob = export_nmf_solver(C, K, N, e_rel=0.0, weighted=weighted, **kw)
    solve = load_solver(blob)
    args = (A, S, Y) + ((W,) if weighted else ()) + (12,)
    A1, S1 = solve(*args)[:2]
    ref = pt.nmf.nmf_pgm_fused(Y, A, S, W=W, e_rel=0, max_iter=12, **kw)
    np.testing.assert_allclose(np.asarray(A1), np.asarray(ref.x[0]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(S1), np.asarray(ref.x[1]),
                               rtol=1e-6, atol=1e-7)


def test_export_accepts_triton_call():
    """jax.export takes the fused kernel's Triton call when the exporters'
    safety check is lifted, and the exported program runs on the card
    (no serialization, so no flatbuffers needed)."""
    import jax
    from jax import export as jax_export

    from proxmin_tpu.export import _TRITON_CALL

    A, S, Y, _ = _problem()

    def step(A, S, Y):
        return fused_nmf_pgm_step(A, S, Y, 0.01, interpret=False)

    exp = jax_export.export(jax.jit(step), disabled_checks=[_TRITON_CALL])(
        A, S, Y)
    for a, b in zip(exp.call(A, S, Y), step(A, S, Y)):
        _close(a, b)
