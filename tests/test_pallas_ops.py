"""Parity tests for the fused Pallas kernels against the jnp reference
path. Here they run in Pallas's interpreter (the autouse fixture in
conftest.py); the ``gpu``-marked tests compile them for a CUDA GPU."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import proxmin_tpu as pt
import proxmin_tpu.operators as op
from proxmin_tpu import nmf as nmf_mod
from proxmin_tpu.nmf import log_likelihood
from proxmin_tpu.ops import nmf_kernels
from proxmin_tpu.ops.nmf_kernels import (
    fused_nmf_adaprox_step,
    fused_nmf_pgm_step,
    pixel_tile,
)


@pytest.fixture
def fake_cuda(monkeypatch):
    """Routing sees a CUDA GPU; the kernels still run interpreted."""
    monkeypatch.setattr(nmf_mod, "cuda_available", lambda: True)


def _problem(rng, C, K, N, weighted):
    A = rng.random((C, K)).astype(np.float32)
    S = rng.random((K, N)).astype(np.float32)
    Y = rng.random((C, N)).astype(np.float32)
    W = (0.5 + rng.random((C, N))).astype(np.float32) if weighted else None
    return A, S, Y, W


# (C, K, N, tile): one ragged tile, two exact tiles, many tiles with a
# ragged last one, the device-loop channel path (C > 16), and K = 1
_TILINGS = [(5, 7, 100, 128), (5, 7, 256, 128), (5, 7, 1000, 128),
            (20, 3, 300, 64), (3, 1, 70, 16)]


def _check_pgm_step(rng, C, K, N, tile, weighted):
    A, S, Y, W = _problem(rng, C, K, N, weighted)
    sS = 0.05
    gA, S_new, SSt, loss, dS_sq, nS_sq = fused_nmf_pgm_step(
        A, S, Y, sS, W=W, tile_n=tile)

    R = A @ S - Y
    D = (W * R) if weighted else R
    S_new_ref = np.maximum(S - sS * (A.T @ D), 0)

    assert S_new.shape == (K, N)
    np.testing.assert_allclose(np.asarray(gA), D @ S.T, rtol=2e-5)
    np.testing.assert_allclose(np.asarray(S_new), S_new_ref,
                               rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(SSt), S_new_ref @ S_new_ref.T,
                               rtol=2e-5)
    np.testing.assert_allclose(float(loss), np.sum(D * R) / 2, rtol=1e-5)
    np.testing.assert_allclose(float(dS_sq), np.sum((S_new_ref - S) ** 2),
                               rtol=1e-4)
    np.testing.assert_allclose(float(nS_sq), np.sum(S_new_ref ** 2),
                               rtol=1e-5)


@pytest.mark.parametrize("weighted", [False, True])
def test_fused_pgm_step_parity(rng, weighted):
    """One fused kernel step == one hand-computed PGM S-side step."""
    _check_pgm_step(rng, 5, 7, 700, 256, weighted)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("C,K,N,tile", _TILINGS)
def test_fused_pgm_step_tilings(rng, C, K, N, tile, weighted):
    """The per-tile partial sums, added up after the kernel, give the
    whole-problem sums for any number of tiles and a ragged last tile."""
    _check_pgm_step(rng, C, K, N, tile, weighted)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("C,K,N,tile,mdt", [
    (5, 7, 1000, 128, jnp.float32), (20, 3, 300, 64, jnp.float32),
    (5, 7, 300, 128, jnp.bfloat16)])
def test_fused_adaprox_step_parity(rng, C, K, N, tile, mdt, weighted):
    """One fused proximal-Adam step == the hand-computed S-side update."""
    A, S, Y, W = _problem(rng, C, K, N, weighted)
    M = rng.random((K, N)).astype(np.float32)
    V = rng.random((K, N)).astype(np.float32)
    M_in, V_in = jnp.asarray(M, mdt), jnp.asarray(V, mdt)
    alpha = (0.1 * rng.random(K)).astype(np.float32)
    b1, b2, t = 0.9, 0.999, 3
    sc = np.array([b1, 1 / (1 - b1 ** t), 1 / (1 - b2 ** t)], np.float32)
    gA, S1, M1, V1, rowsum, loss, dS_sq, nS_sq = fused_nmf_adaprox_step(
        A, S, M_in, V_in, Y, alpha, sc, W=W, tile_n=tile)

    R = A @ S - Y
    D = (W * R) if weighted else R
    gS = A.T @ D
    M_ref = (1 - b1) * gS + b1 * np.asarray(M_in, np.float32)
    V_ref = (1 - b2) * gS ** 2 + b2 * np.asarray(V_in, np.float32)
    Psi = np.sqrt(V_ref * sc[2]) + 1e-8
    S1_ref = np.maximum(S - alpha[:, None] * M_ref * sc[1] / Psi, 0)
    rtol = 2e-5 if mdt == jnp.float32 else 1e-2

    assert M1.dtype == mdt and V1.dtype == mdt
    np.testing.assert_allclose(np.asarray(gA), D @ S.T, rtol=2e-5)
    np.testing.assert_allclose(np.asarray(S1), S1_ref, rtol=2e-5,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(M1, np.float32), M_ref,
                               rtol=rtol, atol=1e-6)
    np.testing.assert_allclose(np.asarray(V1, np.float32), V_ref,
                               rtol=rtol, atol=1e-6)
    np.testing.assert_allclose(np.asarray(rowsum), S1_ref.sum(axis=1),
                               rtol=2e-5)
    np.testing.assert_allclose(float(loss), np.sum(D * R) / 2, rtol=1e-5)
    np.testing.assert_allclose(float(nS_sq), np.sum(S1_ref ** 2),
                               rtol=1e-5)


@pytest.mark.parametrize("K,N,tile_n,expected", [
    (7, 1_000_000, None, 512),     # flagship: 4096 values per (8, tile)
    (12, 47_500, None, 128),       # wide: shrunk until >= 264 programs
    (7, 1000, None, 128),          # tiny: the 128 floor
    (1, 10 ** 7, None, 2048),      # K = 1: the 2048 ceiling
    (7, 1000, 64, 64),             # explicit override
])
def test_pixel_tile_rule(K, N, tile_n, expected):
    assert pixel_tile(K, N, tile_n) == expected


@pytest.mark.parametrize("tile_n", [100, 8])
def test_pixel_tile_rejects_bad_override(tile_n):
    with pytest.raises(ValueError, match="power of two"):
        pixel_tile(7, 1000, tile_n)


@pytest.mark.parametrize("kernel", ["pgm", "adaprox"])
def test_compiled_kernel_raises_off_cuda(rng, kernel):
    """No silent fallback: a compiled kernel call on the CPU raises, and
    the interpreter runs only when asked for."""
    A, S, Y, _ = _problem(rng, 3, 2, 64, False)
    if kernel == "pgm":
        call = lambda **kw: fused_nmf_pgm_step(A, S, Y, 0.1, **kw)
    else:
        M = np.zeros_like(S)
        sc = np.ones(3, np.float32)
        call = lambda **kw: fused_nmf_adaprox_step(
            A, S, M, M, Y, np.ones(2, np.float32), sc, **kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        call(interpret=False)
    call(interpret=True)      # asked for explicitly
    call()                    # asked for by the suite's fixture


def test_interpret_flag_defaults_off(rng, monkeypatch):
    """Outside the test fixture, INTERPRET is off: a whole fused solve on
    the CPU raises instead of running the interpreter."""
    monkeypatch.setattr(nmf_kernels, "INTERPRET", False)
    A, S, Y, _ = _problem(rng, 3, 2, 64, False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.nmf.nmf(Y, A, S, engine="pallas", max_iter=2)


@pytest.mark.parametrize("C,K,N,wins", [
    (5, 7, 1_000_000, True),       # flagship: kernel measured faster
    (188, 12, 47_500, False),      # wide: kernel measured slower
    (5, 7, 10_000, False),         # not measured: stays on xla
])
def test_fused_kernel_wins_measured_region(C, K, N, wins):
    assert nmf_mod._fused_kernel_wins(C, K, N) is wins


def test_auto_never_picks_kernel_off_cuda(rng, monkeypatch):
    """engine='auto' inside the measured region still runs XLA on the
    CPU — for pgm and adaprox alike."""
    calls = []
    for name in ("nmf_pgm_fused", "nmf_adaprox_fused"):
        monkeypatch.setattr(nmf_mod, name,
                            lambda *a, **k: calls.append(1))
    monkeypatch.setattr(nmf_mod, "_KERNEL_MIN_N", 1)
    A, S, Y, _ = _problem(rng, 5, 7, 256, False)
    assert nmf_mod._fused_kernel_wins(5, 7, 256)
    for alg in ("pgm", "adaprox"):
        r = pt.nmf.nmf(Y, A.copy(), S.copy(), algorithm=alg,
                       engine="auto", e_rel=0, max_iter=3)
        assert r.iterations == 3
    assert calls == []


@pytest.mark.parametrize("kernel", ["pgm", "adaprox"])
@pytest.mark.parametrize("C,K,N", [(5, 7, 1000), (40, 12, 300)])
def test_kernels_lower_to_triton_for_cuda(rng, monkeypatch, kernel, C, K,
                                          N):
    """The compiled kernels (not the interpreter) lower to a Triton call
    for CUDA — this catches primitives the Triton route cannot express
    without a GPU at hand."""
    monkeypatch.setattr(nmf_kernels, "cuda_available", lambda: True)
    A, S, Y, W = _problem(rng, C, K, N, True)
    if kernel == "pgm":
        f = lambda A, S, Y, W: fused_nmf_pgm_step(
            A, S, Y, 0.1, W=W, interpret=False,
            prox_S=lambda x, s: op.prox_unity_plus(x, s, axis=0))
    else:
        f = lambda A, S, Y, W: fused_nmf_adaprox_step(
            A, S, S, S, Y, jnp.ones(K), jnp.ones(3), W=W, interpret=False)
    txt = jax.jit(f).trace(A, S, Y, W).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "xla.gpu.triton" in txt


def test_fused_pgm_driver_matches_xla_path(rng):
    """nmf_pgm_fused must track nmf(algorithm='pgm') iterate-for-iterate
    (both float32, same math, different execution engines)."""
    import proxmin_tpu as pt

    C, K, N = 5, 3, 400
    Y = (rng.random((C, K)) @ rng.random((K, N))).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)

    A1, S1 = A0.copy(), S0.copy()
    pt.nmf.nmf(Y, A1, S1, e_rel=0, max_iter=20)

    res = pt.nmf.nmf_pgm_fused(Y, A0.copy(), S0.copy(), e_rel=0,
                               max_iter=20, tile_n=128)
    A2, S2 = res.x
    np.testing.assert_allclose(np.asarray(A2), A1, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(np.asarray(S2), S1, rtol=1e-3, atol=1e-5)
    assert res.iterations == 20


def test_fused_pgm_driver_custom_prox(rng):
    """Factor-axis-local prox (simplex over K) through the fused kernel."""
    import proxmin_tpu as pt
    from proxmin_tpu import operators

    C, K, N = 4, 3, 300
    Y = (rng.random((C, K)) @ rng.random((K, N))).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)

    def proxS(x, s):
        return operators.prox_unity_plus(x, s, axis=0)

    res = pt.nmf.nmf_pgm_fused(Y, A0, S0, prox_S=proxS, e_rel=0,
                               max_iter=10, tile_n=128)
    _, S2 = res.x
    np.testing.assert_allclose(np.asarray(S2).sum(axis=0), 1.0, rtol=1e-4)


def test_nmf_engine_pallas(rng):
    """nmf(engine='pallas') dispatches to the fused driver."""
    import proxmin_tpu as pt

    C, K, N = 4, 3, 256
    Y = (rng.random((C, K)) @ rng.random((K, N))).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)

    r1 = pt.nmf.nmf(Y, A0.copy(), S0.copy(), e_rel=0, max_iter=15)
    r2 = pt.nmf.nmf(Y, A0.copy(), S0.copy(), e_rel=0, max_iter=15,
                    engine="pallas")
    np.testing.assert_allclose(np.asarray(r2.x[1]), np.asarray(r1.x[1]),
                               rtol=1e-3, atol=1e-5)

    # adaprox now has its own fused engine (see the fused proximal-Adam
    # tests below); bsdmm remains xla-only
    with pytest.raises(ValueError):
        pt.nmf.nmf(Y, A0, S0, engine="pallas", algorithm="bsdmm")
    with pytest.raises(ValueError):
        pt.nmf.nmf(Y, A0, S0, engine="bogus")


def test_nmf_engine_pallas_none_prox(rng):
    """None proxes mean identity in both engines (regression: the pallas
    path used to silently substitute non-negativity / crash)."""
    import proxmin_tpu as pt

    C, K, N = 4, 3, 256
    Y = rng.standard_normal((C, N)).astype(np.float32)  # signed data
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)

    r_x = pt.nmf.nmf(Y, A0.copy(), S0.copy(), prox_A=None, prox_S=None,
                     e_rel=0, max_iter=10)
    r_p = pt.nmf.nmf(Y, A0.copy(), S0.copy(), prox_A=None, prox_S=None,
                     e_rel=0, max_iter=10, engine="pallas")
    # unconstrained factorization of signed data goes negative
    assert np.asarray(r_x.x[1]).min() < 0
    assert np.asarray(r_p.x[1]).min() < 0
    np.testing.assert_allclose(np.asarray(r_p.x[1]), np.asarray(r_x.x[1]),
                               rtol=1e-3, atol=1e-5)


def test_nmf_engine_pallas_inplace_writeback(rng):
    """NumPy inputs are updated in place by the pallas engine too
    (regression: writeback saw jnp rebinds and silently skipped)."""
    import proxmin_tpu as pt

    C, K, N = 4, 3, 128
    Y = (rng.random((C, K)) @ rng.random((K, N))).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)
    A_before = A0.copy()
    pt.nmf.nmf(Y, A0, S0, e_rel=0, max_iter=10, engine="pallas")
    assert not np.allclose(A0, A_before)


def test_fused_pgm_bf16_storage(rng):
    """bf16-stored factors converge to the f32 solution within bf16
    quantization on a well-conditioned problem."""
    import proxmin_tpu as pt

    C, K, N = 16, 8, 512
    Y = (rng.random((C, K)) @ rng.random((K, N))).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)

    r32 = pt.nmf.nmf_pgm_fused(Y, A0.copy(), S0.copy(), e_rel=0,
                               max_iter=50, tile_n=128)
    r16 = pt.nmf.nmf_pgm_fused(Y, A0.copy(), S0.copy(), e_rel=0,
                               max_iter=50, tile_n=128,
                               store_dtype=jnp.bfloat16)
    l32 = 0.5 * np.sum((Y - np.asarray(r32.x[0]) @ np.asarray(r32.x[1])) ** 2)
    l16 = 0.5 * np.sum((Y - np.asarray(r16.x[0]) @ np.asarray(r16.x[1])) ** 2)
    # bf16 run reaches a comparable loss (quantization-limited)
    assert l16 < max(l32 * 3, l32 + 1.0)
    np.testing.assert_allclose(np.asarray(r16.x[1]), np.asarray(r32.x[1]),
                               atol=0.05)


def test_nmf_engine_auto(rng):
    """engine='auto' selects by channel count and falls back cleanly."""
    import proxmin_tpu as pt

    K, N = 3, 256
    A0 = rng.random((4, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)
    Y = (A0 @ S0).astype(np.float32)
    # small C -> xla path (just verify it runs and matches xla)
    r_auto = pt.nmf.nmf(Y, A0.copy(), S0.copy(), e_rel=0, max_iter=5,
                        engine="auto")
    r_xla = pt.nmf.nmf(Y, A0.copy(), S0.copy(), e_rel=0, max_iter=5)
    np.testing.assert_allclose(np.asarray(r_auto.x[1]),
                               np.asarray(r_xla.x[1]), rtol=1e-6)
    # auto with unsupported combo (weighted) must not crash -> xla
    W = (0.5 + rng.random(Y.shape)).astype(np.float32)
    r_w = pt.nmf.nmf(Y, A0.copy(), S0.copy(), W=W, e_rel=0, max_iter=5,
                     engine="auto")
    assert np.isfinite(np.asarray(r_w.x[1])).all()


def test_nmf_auto_with_pallas_kwargs(rng, monkeypatch):
    """Regression: pallas-only kwargs with engine='auto' force the pallas
    engine on a CUDA GPU (instead of crashing pgm with unexpected
    kwargs), raise elsewhere (auto never picks a kernel off CUDA), and
    raise clearly when the call is not pallas-compatible."""
    import proxmin_tpu as pt

    C, K, N = 4, 3, 256
    Y = (rng.random((C, K)) @ rng.random((K, N))).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)

    with pytest.raises(ValueError, match="CUDA"):
        pt.nmf.nmf(Y, A0.copy(), S0.copy(), e_rel=0, max_iter=5,
                   engine="auto", tile_n=128)
    monkeypatch.setattr(nmf_mod, "cuda_available", lambda: True)
    r = pt.nmf.nmf(Y, A0.copy(), S0.copy(), e_rel=0, max_iter=5,
                   engine="auto", tile_n=128)   # off-region but tile_n
    assert r.state["kind"] == "nmf_pgm_fused"
    assert np.isfinite(np.asarray(r.x[1])).all()

    # adaprox + tile_n with a NON-separable prox cannot run the fused
    # kernel, so the pallas-only kwarg must raise, not silently drop
    from functools import partial as _partial

    with pytest.raises(ValueError):
        pt.nmf.nmf(Y, A0, S0, engine="auto", tile_n=128,
                   algorithm="adaprox",
                   prox_S=_partial(pt.operators.prox_soft, thresh=0.1,
                                   type="absolute"))


def test_nmf_auto_routes_reduced_moment_adaprox(rng, monkeypatch,
                                                fake_cuda):
    """engine='auto' routes adaprox to the fused kernel exactly in the
    measured win region (whatever the moment dtype) or on explicit
    tile_n; outside it stays on xla; non-separable proxs fall back to
    xla."""
    from functools import partial

    import proxmin_tpu as pt

    C, K, N = 4, 3, 256
    Y = (rng.random((C, K)) @ rng.random((K, N))).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)

    calls = []
    orig = nmf_mod.nmf_adaprox_fused
    monkeypatch.setattr(
        nmf_mod, "nmf_adaprox_fused",
        lambda *a, **k: (calls.append(1), orig(*a, **k))[1])

    # below the measured region -> xla
    pt.nmf.nmf(Y, A0.copy(), S0.copy(), algorithm="adaprox",
               engine="auto", moment_dtype=jnp.bfloat16,
               e_rel=0, max_iter=5)
    assert calls == []

    # explicit tile_n -> fused even outside the region
    pt.nmf.nmf(Y, A0.copy(), S0.copy(), algorithm="adaprox",
               engine="auto", tile_n=128, e_rel=0, max_iter=5)
    assert calls == [1]

    # inside the region -> fused, with reduced moments or not
    monkeypatch.setattr(nmf_mod, "_KERNEL_MIN_N", 1)
    r = pt.nmf.nmf(Y, A0.copy(), S0.copy(), algorithm="adaprox",
                   engine="auto", moment_dtype=jnp.bfloat16,
                   e_rel=0, max_iter=5)
    assert calls == [1, 1] and np.isfinite(np.asarray(r.x[1])).all()
    pt.nmf.nmf(Y, A0.copy(), S0.copy(), algorithm="adaprox",
               engine="auto", e_rel=0, max_iter=5)
    assert calls == [1, 1, 1]

    # non-separable prox: silently falls back to the xla driver (which
    # honors moment_dtype as the capacity option)
    r4 = pt.nmf.nmf(Y, A0.copy(), S0.copy(), algorithm="adaprox",
                    engine="auto", moment_dtype=jnp.bfloat16,
                    prox_S=partial(pt.operators.prox_soft, thresh=0.1,
                                   type="absolute"),
                    e_rel=0, max_iter=5)
    assert calls == [1, 1, 1] and np.isfinite(np.asarray(r4.x[1])).all()


def test_nmf_scalar_weights(rng):
    """Regression: NumPy/JAX scalar W==1 routes unweighted; scalar W != 1
    is materialized instead of crashing."""
    import proxmin_tpu as pt

    C, K, N = 4, 2, 32
    Y = rng.random((C, K)) @ rng.random((K, N))
    A0, S0 = rng.random((C, K)), rng.random((K, N))

    r1 = pt.nmf.nmf(Y, A0.copy(), S0.copy(), W=np.float64(1.0),
                    e_rel=0, max_iter=10)
    r2 = pt.nmf.nmf(Y, A0.copy(), S0.copy(), e_rel=0, max_iter=10)
    np.testing.assert_allclose(np.asarray(r1.x[1]), np.asarray(r2.x[1]),
                               rtol=1e-12)

    r3 = pt.nmf.nmf(Y, A0.copy(), S0.copy(), W=2.0, e_rel=0, max_iter=10)
    assert np.isfinite(np.asarray(r3.x[1])).all()


def test_nmf_pgm_fused_none_prox_means_identity(rng):
    """Regression: nmf_pgm_fused(prox_S=None) must mean identity like
    nmf(), not the kernel's builtin non-negativity."""
    import proxmin_tpu as pt

    C, K, N = 4, 3, 256
    Y = rng.standard_normal((C, N)).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)
    r = pt.nmf.nmf_pgm_fused(Y, A0, S0, prox_A=None, prox_S=None,
                             e_rel=0, max_iter=10, tile_n=128)
    assert np.asarray(r.x[1]).min() < 0   # unconstrained on signed data


def test_fused_weighted_pgm_matches_xla(rng):
    """Weighted fused runner (kernel consumes W*R in one pass, steps via
    the same implicit power iteration) matches the XLA weighted path
    iterate-for-iterate over a short horizon."""
    C, K, N = 5, 3, 300
    Y = (rng.random((C, K)) @ rng.random((K, N))
         + 0.01 * rng.standard_normal((C, N))).astype(np.float32)
    W = (0.5 + rng.random((C, N))).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)

    r_xla = pt.nmf.nmf(jnp.asarray(Y), jnp.asarray(A0), jnp.asarray(S0),
                       W=jnp.asarray(W), e_rel=0, max_iter=8)
    r_pal = pt.nmf.nmf(jnp.asarray(Y), jnp.asarray(A0), jnp.asarray(S0),
                       W=jnp.asarray(W), e_rel=0, max_iter=8,
                       engine="pallas")
    np.testing.assert_allclose(np.asarray(r_pal.x[0]),
                               np.asarray(r_xla.x[0]), rtol=2e-4,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(r_pal.x[1]),
                               np.asarray(r_xla.x[1]), rtol=2e-4,
                               atol=1e-6)


def test_fused_weighted_pgm_strided_descends(rng):
    C, K, N = 6, 3, 256
    Y = (rng.random((C, K)) @ rng.random((K, N))).astype(np.float32)
    W = (0.5 + rng.random((C, N))).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)
    l0 = float(log_likelihood(jnp.asarray(A0), jnp.asarray(S0),
                              Y=jnp.asarray(Y), W=jnp.asarray(W)))
    res = pt.nmf.nmf(Y, A0, S0, W=W, e_rel=0, max_iter=100,
                     engine="pallas", step_stride=10)
    l1 = float(log_likelihood(*map(jnp.asarray, res.x),
                              Y=jnp.asarray(Y), W=jnp.asarray(W)))
    assert np.isfinite(l1)
    assert l1 < 0.05 * l0


def test_fused_weighted_masked_pixels(rng):
    """W == 0 pixels (and the kernel's zero-weight padding) must not
    produce NaNs in the weighted power iterations or the update."""
    C, K, N = 5, 3, 200
    Y = (rng.random((C, K)) @ rng.random((K, N))).astype(np.float32)
    W = (0.5 + rng.random((C, N))).astype(np.float32)
    W[:, : N // 4] = 0.0      # fully masked pixels
    res = pt.nmf.nmf(rng.permutation(Y, axis=1), rng.random((C, K)),
                     rng.random((K, N)), W=W, e_rel=0, max_iter=20,
                     engine="pallas")
    assert np.isfinite(np.asarray(res.x[0])).all()
    assert np.isfinite(np.asarray(res.x[1])).all()


# ---------------------------------------------------------------------------
# fused proximal-Adam (adaprox) engine (VERDICT r3 item 3)

def test_fused_adaprox_matches_xla_driver(rng):
    """nmf_adaprox_fused == nmf(algorithm='adaprox',
    separable_prox='auto') at fixed iteration count (f32 noise only)."""
    C, K, N = 5, 7, 300
    Y = (rng.random((C, K)) @ rng.random((K, N))
         + 0.01 * rng.standard_normal((C, N))).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)

    ref = pt.nmf.nmf(Y, A0.copy(), S0.copy(), algorithm="adaprox",
                     e_rel=0, max_iter=30, separable_prox="auto")
    fus = pt.nmf.nmf_adaprox_fused(Y, A0.copy(), S0.copy(),
                                   e_rel=0, max_iter=30)
    assert fus.iterations == 30
    for r, f in zip(ref.x, fus.x):
        np.testing.assert_allclose(np.asarray(f), np.asarray(r),
                                   atol=2e-5)


def test_nmf_engine_pallas_adaprox_dispatch(rng):
    """nmf(engine='pallas', algorithm='adaprox') routes to the fused
    engine and matches the XLA driver; padding-unaligned N."""
    C, K, N = 4, 3, 257
    Y = (rng.random((C, K)) @ rng.random((K, N))).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)

    r1 = pt.nmf.nmf(Y, A0.copy(), S0.copy(), algorithm="adaprox",
                    engine="pallas", e_rel=0, max_iter=20)
    r2 = pt.nmf.nmf(Y, A0.copy(), S0.copy(), algorithm="adaprox",
                    e_rel=0, max_iter=20, separable_prox="auto")
    for a, b in zip(r1.x, r2.x):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-5)


def test_fused_adaprox_custom_separable_prox(rng):
    """A non-default separable prox (relative soft threshold) matches
    the driver's closed-form separable path."""
    from functools import partial

    C, K, N = 4, 3, 256
    Y = (rng.random((C, K)) @ rng.random((K, N))).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)
    psoft = partial(pt.operators.prox_soft, thresh=0.01)

    r1 = pt.nmf.nmf(Y, A0.copy(), S0.copy(), algorithm="adaprox",
                    engine="pallas", prox_S=psoft, e_rel=0, max_iter=15)
    r2 = pt.nmf.nmf(Y, A0.copy(), S0.copy(), algorithm="adaprox",
                    prox_S=psoft, e_rel=0, max_iter=15,
                    separable_prox="auto")
    for a, b in zip(r1.x, r2.x):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-5)


def test_fused_adaprox_bf16_moments(rng):
    """bf16 moment storage runs and stays within EMA-rounding distance
    of the f32 solve."""
    C, K, N = 4, 3, 256
    Y = (rng.random((C, K)) @ rng.random((K, N))).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)

    f32 = pt.nmf.nmf_adaprox_fused(Y, A0.copy(), S0.copy(), e_rel=0,
                                   max_iter=20)
    b16 = pt.nmf.nmf_adaprox_fused(Y, A0.copy(), S0.copy(), e_rel=0,
                                   max_iter=20,
                                   moment_dtype=jnp.bfloat16)
    assert b16.x[1].dtype == jnp.float32  # iterates stay full precision
    np.testing.assert_allclose(np.asarray(b16.x[1]),
                               np.asarray(f32.x[1]), atol=0.05)


def test_fused_adaprox_engine_gates(rng):
    """The pallas adaprox engine rejects what it cannot honor, with
    actionable messages."""
    from functools import partial

    C, K, N = 4, 3, 128
    Y = rng.random((C, N)).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)
    W = (0.5 + rng.random((C, N))).astype(np.float32)

    with pytest.raises(ValueError, match="scheme='adam'"):
        pt.nmf.nmf(Y, A0, S0, algorithm="adaprox", engine="pallas",
                   scheme="radam", max_iter=3)
    with pytest.raises(ValueError, match="step_stride"):
        pt.nmf.nmf(Y, A0, S0, algorithm="adaprox", engine="pallas",
                   step_stride=5, max_iter=3)
    with pytest.raises(ValueError, match="separable"):
        pt.nmf.nmf(Y, A0, S0, algorithm="adaprox", engine="pallas",
                   prox_S=partial(pt.operators.prox_soft, thresh=0.01,
                                  type="absolute"),
                   max_iter=3)


def test_fused_adaprox_warm_start_matches_driver(rng):
    """M/V warm restart: each engine restarted from its own returned
    moments continues identically (reference algorithms.py:347-359
    semantics — moments carry over, bias-correction clock restarts)."""
    C, K, N = 4, 3, 256
    Y = (rng.random((C, K)) @ rng.random((K, N))).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)

    rx1 = pt.nmf.nmf(Y, A0.copy(), S0.copy(), algorithm="adaprox",
                     e_rel=0, max_iter=12, separable_prox="auto")
    rf1 = pt.nmf.nmf_adaprox_fused(Y, A0.copy(), S0.copy(), e_rel=0,
                                   max_iter=12)
    rx2 = pt.nmf.nmf(Y, np.array(rx1.x[0]), np.array(rx1.x[1]),
                     algorithm="adaprox", e_rel=0, max_iter=12,
                     separable_prox="auto", M=rx1.M, V=rx1.V)
    rf2 = pt.nmf.nmf_adaprox_fused(Y, np.array(rf1.x[0]),
                                   np.array(rf1.x[1]), e_rel=0,
                                   max_iter=12, M=rf1.M, V=rf1.V)
    for a, b in zip(rx2.x, rf2.x):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   atol=2e-5)
    # engine= dispatch passes M/V through to the same path
    rf2b = pt.nmf.nmf(Y, np.array(rf1.x[0]), np.array(rf1.x[1]),
                      algorithm="adaprox", engine="pallas", e_rel=0,
                      max_iter=12, M=rf1.M, V=rf1.V)
    np.testing.assert_array_equal(np.asarray(rf2b.x[1]),
                                  np.asarray(rf2.x[1]))


def test_fused_adaprox_moments_checkpoint_roundtrip(rng, tmp_path):
    """The fused engine's returned M/V pytree round-trips through
    proxmin_tpu.checkpoint and resumes identically."""
    from proxmin_tpu.checkpoint import load_checkpoint, save_checkpoint

    C, K, N = 3, 2, 128
    Y = (rng.random((C, K)) @ rng.random((K, N))).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)

    r1 = pt.nmf.nmf_adaprox_fused(Y, A0.copy(), S0.copy(), e_rel=0,
                                  max_iter=8)
    state = {"x": tuple(np.asarray(v) for v in r1.x),
             "M": r1.M, "V": r1.V}
    path = save_checkpoint(str(tmp_path / "fused_adaprox_state"),
                           use_orbax=False, **state)
    loaded = load_checkpoint(path, use_orbax=False)

    r2a = pt.nmf.nmf_adaprox_fused(Y, np.array(r1.x[0]),
                                   np.array(r1.x[1]), e_rel=0,
                                   max_iter=8, M=r1.M, V=r1.V)
    r2b = pt.nmf.nmf_adaprox_fused(Y, np.array(loaded["x"][0]),
                                   np.array(loaded["x"][1]), e_rel=0,
                                   max_iter=8, M=loaded["M"],
                                   V=loaded["V"])
    np.testing.assert_array_equal(np.asarray(r2a.x[1]),
                                  np.asarray(r2b.x[1]))


def test_fused_engines_reject_mesh(rng):
    """engine='pallas' + mesh= raises: the fused kernels are single-
    device programs with no SPMD partitioning rule, so a mesh would
    silently gather the pixel-sharded operands (review r4 finding)."""
    from proxmin_tpu.parallel import make_mesh

    C, K, N = 4, 3, 256
    Y = rng.random((C, N)).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)
    mesh = make_mesh(shape=(8,))

    for alg in ("pgm", "adaprox"):
        with pytest.raises(ValueError, match="mesh"):
            pt.nmf.nmf(Y, A0, S0, algorithm=alg, engine="pallas",
                       mesh=mesh, max_iter=3)
    # auto + mesh quietly runs the xla paths (pgm: explicit shard_map)
    r = pt.nmf.nmf(Y, A0.copy(), S0.copy(), engine="auto", mesh=mesh,
                   e_rel=0, max_iter=3)
    assert r.iterations == 3


def test_fused_adaprox_rejects_separable_false(rng):
    """separable_prox=False asks for the sub-iteration prox loop, which
    the fused engine cannot honor — must raise, not silently substitute
    the closed form (review r4 finding)."""
    C, K, N = 4, 3, 128
    Y = rng.random((C, N)).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)
    with pytest.raises(ValueError, match="sub-iteration"):
        pt.nmf.nmf(Y, A0, S0, algorithm="adaprox", engine="pallas",
                   separable_prox=False, max_iter=3)


def test_fused_convergence_test_rejects_nonfinite(rng):
    """The fused engines' fixed-point test is hardened like
    utils.fixed_point_converged: inf <= inf is NOT converged (review
    r4 finding)."""
    from proxmin_tpu.nmf import _fused_fp_conv

    inf = jnp.asarray(np.inf)
    assert not bool(_fused_fp_conv(inf, inf, 0.5))
    assert not bool(_fused_fp_conv(jnp.asarray(np.nan), inf, 0.5))
    assert bool(_fused_fp_conv(jnp.asarray(0.0), jnp.asarray(1.0), 0.5))

    # end to end: a poisoned problem is never "converged" — and since
    # the divergence early-stop it halts as soon as the carried loss
    # goes non-finite instead of burning the full budget on NaNs
    C, K, N = 3, 2, 128
    Y = rng.random((C, N)).astype(np.float32)
    Y[0, 0] = np.inf
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)
    r = pt.nmf.nmf_adaprox_fused(Y, A0, S0, e_rel=10.0, max_iter=4)
    assert r.converged == (False, False)
    assert r.status == "diverged"
    assert r.iterations < 4


def test_fused_runner_cache_hits_on_rebuilt_partials(rng):
    """functools.partial proxs rebuilt per call must hit the runner
    cache (structural callable_key), not retrace (review r4 finding)."""
    from functools import partial

    from proxmin_tpu.nmf import _make_fused_adaprox_runner

    C, K, N = 3, 2, 128
    Y = rng.random((C, N)).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)

    def solve():
        return pt.nmf.nmf(Y, A0.copy(), S0.copy(), algorithm="adaprox",
                          engine="pallas",
                          prox_S=partial(pt.operators.prox_soft,
                                         thresh=0.01),
                          e_rel=0, max_iter=3)

    solve()
    # reach into the memo to confirm the second (fresh-partial) call
    # does not grow it
    cache = _make_fused_adaprox_runner.__closure__
    sizes_before = [len(c.cell_contents) for c in cache
                    if isinstance(c.cell_contents, dict)]
    solve()
    sizes_after = [len(c.cell_contents) for c in cache
                   if isinstance(c.cell_contents, dict)]
    assert sizes_before == sizes_after


def test_fused_adaprox_weighted_matches_driver(rng):
    """Weighted fused adaprox (W consumed in-kernel) matches the
    weighted XLA driver at fixed iterations."""
    C, K, N = 4, 3, 300
    Y = (rng.random((C, K)) @ rng.random((K, N))).astype(np.float32)
    W = (0.5 + rng.random((C, N))).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)

    rx = pt.nmf.nmf(Y, A0.copy(), S0.copy(), W=W, algorithm="adaprox",
                    e_rel=0, max_iter=25, separable_prox="auto")
    rf = pt.nmf.nmf(Y, A0.copy(), S0.copy(), W=W, algorithm="adaprox",
                    engine="pallas", e_rel=0, max_iter=25)
    for a, b in zip(rx.x, rf.x):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   atol=2e-5)


def test_fused_adaprox_broadcastable_W(rng):
    """Lower-rank W (e.g. per-pixel (N,) or per-channel (C,1)) is
    broadcast to (C,N) like the XLA engine's implicit W*(AS-Y), not a
    pad-rank crash (review r4 finding)."""
    C, K, N = 3, 2, 128
    Y = (rng.random((C, K)) @ rng.random((K, N))).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)

    for W in (0.7 * np.ones(N, np.float32),
              (0.5 + rng.random((C, 1))).astype(np.float32)):
        rx = pt.nmf.nmf(Y, A0.copy(), S0.copy(), W=W,
                        algorithm="adaprox", e_rel=0, max_iter=10,
                        separable_prox="auto")
        rf = pt.nmf.nmf(Y, A0.copy(), S0.copy(), W=W,
                        algorithm="adaprox", engine="pallas", e_rel=0,
                        max_iter=10)
        for a, b in zip(rx.x, rf.x):
            np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                       atol=2e-5)


def test_export_nmf_adaprox_rejects_nonseparable_prox():
    """The export gate mirrors the engine gate: a non-separable prox
    must not serialize a silently-wrong artifact (review r4 finding)."""
    from functools import partial

    from proxmin_tpu.export import export_nmf_adaprox_solver

    with pytest.raises(ValueError, match="separable"):
        export_nmf_adaprox_solver(
            3, 2, 128,
            prox_S=partial(pt.operators.prox_soft, thresh=0.1,
                           type="absolute"))


def test_fused_weighted_pgm_bf16_storage(rng):
    """bf16-stored S/Y/W in the WEIGHTED fused kernel: converges to the
    f32 solution within quantization, through both the direct entry and
    nmf(engine='pallas'); the strided Lipschitz refresh works from the
    bf16 stores."""
    import proxmin_tpu as pt

    C, K, N = 16, 8, 512
    Y = (rng.random((C, K)) @ rng.random((K, N))).astype(np.float32)
    W = (0.5 + rng.random((C, N))).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)

    r32 = pt.nmf.nmf_pgm_fused(Y, A0.copy(), S0.copy(), W=W, e_rel=0,
                               max_iter=50, tile_n=128, step_stride=5)
    r16 = pt.nmf.nmf_pgm_fused(Y, A0.copy(), S0.copy(), W=W, e_rel=0,
                               max_iter=50, tile_n=128, step_stride=5,
                               store_dtype=jnp.bfloat16)

    def wloss(r):
        D = Y - np.asarray(r.x[0]) @ np.asarray(r.x[1])
        return 0.5 * np.sum(W * D * D)

    l32, l16 = wloss(r32), wloss(r16)
    assert l16 < max(l32 * 3, l32 + 1.0)
    assert np.asarray(r16.x[1]).dtype == np.float32  # outputs stay f32

    # iterate closeness at a short horizon (before bf16 quantization
    # noise compounds through the nonconvex trajectory)
    s32 = pt.nmf.nmf_pgm_fused(Y, A0.copy(), S0.copy(), W=W, e_rel=0,
                               max_iter=12, tile_n=128, step_stride=5)
    s16 = pt.nmf.nmf_pgm_fused(Y, A0.copy(), S0.copy(), W=W, e_rel=0,
                               max_iter=12, tile_n=128, step_stride=5,
                               store_dtype=jnp.bfloat16)
    np.testing.assert_allclose(np.asarray(s16.x[1]), np.asarray(s32.x[1]),
                               atol=0.05)

    # the one-call route accepts the combination too
    r = pt.nmf.nmf(Y, A0.copy(), S0.copy(), W=W, e_rel=0, max_iter=10,
                   engine="pallas", store_dtype=jnp.bfloat16)
    assert r.iterations == 10


def test_fused_adaprox_bf16_storage(rng, fake_cuda):
    """bf16-stored S/Y (+ bf16 moments) in the fused proximal-Adam
    engine: comparable loss to the f32 store, close iterates at a short
    horizon, f32 outputs, and the nmf() route accepts the combination
    (engine='auto' selects the fused kernel for it)."""
    import proxmin_tpu as pt

    C, K, N = 16, 8, 512
    Y = (rng.random((C, K)) @ rng.random((K, N))).astype(np.float32)
    W = (0.5 + rng.random((C, N))).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)

    r32 = pt.nmf.nmf_adaprox_fused(Y, A0.copy(), S0.copy(), e_rel=0,
                                   max_iter=40, tile_n=128)
    r16 = pt.nmf.nmf_adaprox_fused(Y, A0.copy(), S0.copy(), e_rel=0,
                                   max_iter=40, tile_n=128,
                                   store_dtype=jnp.bfloat16,
                                   moment_dtype=jnp.bfloat16)
    assert np.asarray(r16.x[1]).dtype == np.float32
    assert r16.loss < max(r32.loss * 3, r32.loss + 1.0)

    s32 = pt.nmf.nmf_adaprox_fused(Y, A0.copy(), S0.copy(), e_rel=0,
                                   max_iter=10, tile_n=128)
    s16 = pt.nmf.nmf_adaprox_fused(Y, A0.copy(), S0.copy(), e_rel=0,
                                   max_iter=10, tile_n=128,
                                   store_dtype=jnp.bfloat16)
    # Adam's Phi/Psi ratio amplifies bf16 iterate quantization a bit
    # more than PGM; a handful of elements drift by ~0.1 already at 10
    # iterations (the loss assertion above carries the quality check)
    np.testing.assert_allclose(np.asarray(s16.x[1]), np.asarray(s32.x[1]),
                               atol=0.15)

    # weighted + engine='auto' routes to the fused kernel on store_dtype
    r = pt.nmf.nmf(Y, A0.copy(), S0.copy(), W=W, algorithm="adaprox",
                   e_rel=0, max_iter=8, engine="auto",
                   store_dtype=jnp.bfloat16, tile_n=128)
    assert r.iterations == 8


def test_bf16_inputs_not_promoted_under_store_dtype(rng):
    """Inputs already in the storage dtype must pass the promotion
    boundary untouched (r5 capacity regression: promote_dtype eagerly
    upcast bf16 S/Y to f32 jit arguments — 11.9 GB of arguments on a
    16 GB chip for the 100e6-px solve the mode exists for — and the
    solve OOMed where round 4's had fit)."""
    import proxmin_tpu as pt
    from proxmin_tpu.solvers.common import promote_dtype_host

    # the root contract: keep= short-circuits promotion by identity
    s16 = jnp.ones((4, 8), jnp.bfloat16)
    assert promote_dtype_host(s16, keep=jnp.bfloat16) is s16
    assert promote_dtype_host(s16).dtype == jnp.result_type(float)
    h16 = np.ones((4, 8), jnp.bfloat16)
    assert promote_dtype_host(h16, keep=jnp.bfloat16) is h16

    # behavioral: bf16 inputs under store_dtype=bf16 walk the EXACT
    # trajectory of f32 inputs (the runner's in-jit astype is the same
    # cast the host-side one performs), on both fused engines and the
    # nmf() route
    C, K, N = 16, 8, 512
    Y = (rng.random((C, K)) @ rng.random((K, N))).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)
    Y16 = jnp.asarray(Y).astype(jnp.bfloat16)
    S16 = jnp.asarray(S0).astype(jnp.bfloat16)

    r_f32 = pt.nmf.nmf_pgm_fused(Y, A0.copy(), S0.copy(), e_rel=0,
                                 max_iter=15, tile_n=128,
                                 store_dtype=jnp.bfloat16)
    r_b16 = pt.nmf.nmf_pgm_fused(Y16, A0.copy(), S16, e_rel=0,
                                 max_iter=15, tile_n=128,
                                 store_dtype=jnp.bfloat16)
    np.testing.assert_array_equal(np.asarray(r_f32.x[0]),
                                  np.asarray(r_b16.x[0]))
    np.testing.assert_array_equal(np.asarray(r_f32.x[1]),
                                  np.asarray(r_b16.x[1]))

    a_f32 = pt.nmf.nmf_adaprox_fused(Y, A0.copy(), S0.copy(), e_rel=0,
                                     max_iter=10, tile_n=128,
                                     store_dtype=jnp.bfloat16)
    a_b16 = pt.nmf.nmf_adaprox_fused(Y16, A0.copy(), S16, e_rel=0,
                                     max_iter=10, tile_n=128,
                                     store_dtype=jnp.bfloat16)
    np.testing.assert_array_equal(np.asarray(a_f32.x[1]),
                                  np.asarray(a_b16.x[1]))

    n_f32 = pt.nmf.nmf(Y, A0.copy(), S0.copy(), e_rel=0, max_iter=15,
                       engine="pallas", store_dtype=jnp.bfloat16,
                       tile_n=128)
    n_b16 = pt.nmf.nmf(Y16, A0.copy(), S16, e_rel=0, max_iter=15,
                       engine="pallas", store_dtype=jnp.bfloat16,
                       tile_n=128)
    np.testing.assert_array_equal(np.asarray(n_f32.x[1]),
                                  np.asarray(n_b16.x[1]))


def test_engine_auto_store_dtype_routing(rng, fake_cuda):
    """Review findings (r4 late): engine='auto' routes a reduced
    store_dtype to the fused kernels — including weighted PGM (the only
    engine that can honor the capacity option) — while store_dtype=None
    or float32 is normalized away (f32 store IS the default layout)
    instead of misrouting to the slower f32 fused engine or crashing
    the XLA driver."""
    import proxmin_tpu as pt

    C, K, N = 16, 8, 512
    Y = (rng.random((C, K)) @ rng.random((K, N))).astype(np.float32)
    W = (0.5 + rng.random((C, N))).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)

    # weighted + reduced store -> fused weighted kernel (was a
    # ValueError falsely demanding unweighted W)
    r = pt.nmf.nmf(Y, A0.copy(), S0.copy(), W=W, e_rel=0, max_iter=6,
                   engine="auto", store_dtype=jnp.bfloat16)
    assert r.iterations == 6
    # ... also with a strided refresh (the weighted runner supports it)
    r = pt.nmf.nmf(Y, A0.copy(), S0.copy(), W=W, e_rel=0, max_iter=6,
                   engine="auto", store_dtype=jnp.bfloat16,
                   step_stride=3)
    assert r.iterations == 6

    # None / f32 store_dtype are no-ops on every auto route
    for sdt in (None, jnp.float32):
        r1 = pt.nmf.nmf(Y, A0.copy(), S0.copy(), e_rel=0, max_iter=6,
                        engine="auto", store_dtype=sdt)
        r2 = pt.nmf.nmf(Y, A0.copy(), S0.copy(), e_rel=0, max_iter=6)
        np.testing.assert_allclose(np.asarray(r1.x[1]),
                                   np.asarray(r2.x[1]), rtol=1e-6)
        ra = pt.nmf.nmf(Y, A0.copy(), S0.copy(), algorithm="adaprox",
                        e_rel=0, max_iter=6, engine="auto",
                        store_dtype=sdt)
        rb = pt.nmf.nmf(Y, A0.copy(), S0.copy(), algorithm="adaprox",
                        e_rel=0, max_iter=6)
        np.testing.assert_allclose(np.asarray(ra.x[1]),
                                   np.asarray(rb.x[1]), rtol=1e-6)


def test_fused_prox_safe_predicate():
    """The auto-routing prox guard (r4 late): only library proxs the
    kernel provably applies correctly per pixel tile may auto-route;
    pixel-coupled or unknown proxs must not."""
    from functools import partial

    from proxmin_tpu.nmf import _fused_prox_safe

    # identity / elementwise library operators: safe on either block
    for p in (None, op.prox_id, op.prox_plus, op.prox_soft,
              partial(op.prox_soft, thresh=0.1),
              partial(op.prox_min, thresh=0.2, type="absolute"),
              op.prox_hard_plus, op.prox_max_entropy):
        assert _fused_prox_safe(p, "A") and _fused_prox_safe(p, "S")

    # prox_unity: the factor axis (0) is tile-local for S (padded
    # columns are select-masked after the prox); the pixel axis (1)
    # would normalize per tile -> unsafe for S. A rides whole (zero
    # padding preserves sums) -> either axis.
    for p in (op.prox_unity, op.prox_unity_plus,
              partial(op.prox_unity, axis=0),
              partial(op.prox_unity_plus, axis=0)):
        assert _fused_prox_safe(p, "S")
    for p in (partial(op.prox_unity, axis=1),
              partial(op.prox_unity_plus, axis=1)):
        assert _fused_prox_safe(p, "A")
        assert not _fused_prox_safe(p, "S")

    # POCS combinator: safe iff every member is
    assert _fused_prox_safe(
        op.AlternatingProjections([op.prox_plus,
                                   partial(op.prox_unity, axis=0)]), "S")
    assert not _fused_prox_safe(
        op.AlternatingProjections([op.prox_plus,
                                   partial(op.prox_unity, axis=1)]), "S")

    # unknown callables and positional binds: conservative no
    assert not _fused_prox_safe(lambda X, step: X, "S")
    assert not _fused_prox_safe(partial(op.prox_soft, 0.5), "S")


def test_unweighted_auto_routes_fused_past_cliff(rng, monkeypatch,
                                                fake_cuda):
    """engine='auto' wiring for unweighted pgm consults the measured
    region rule."""
    C, K, N = 4, 3, 256
    Y = (rng.random((C, K)) @ rng.random((K, N))).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)

    calls = []
    orig = nmf_mod.nmf_pgm_fused
    monkeypatch.setattr(
        nmf_mod, "nmf_pgm_fused",
        lambda *a, **k: (calls.append(1), orig(*a, **k))[1])

    kw = dict(e_rel=0, max_iter=5, engine="auto")
    pt.nmf.nmf(Y, A0.copy(), S0.copy(), **kw)      # tiny: xla
    assert calls == []
    monkeypatch.setattr(nmf_mod, "_fused_kernel_wins", lambda *a: True)
    r = pt.nmf.nmf(Y, A0.copy(), S0.copy(), **kw)  # forced region
    assert calls == [1] and np.isfinite(np.asarray(r.x[1])).all()
    r_xla = pt.nmf.nmf(Y, A0.copy(), S0.copy(), e_rel=0, max_iter=5,
                       engine="xla")
    np.testing.assert_allclose(np.asarray(r.x[1]),
                               np.asarray(r_xla.x[1]), rtol=2e-4,
                               atol=2e-5)


def test_weighted_auto_routes_fused_by_measured_region(rng, monkeypatch,
                                                       fake_cuda):
    """engine='auto' wiring for weighted strided/adaptive pgm: routes to
    the fused engine exactly when _fused_kernel_wins says so, stays
    on xla otherwise, and never fuses weighted solves without a
    strided/adaptive policy (the fused runner's warm power iterate is
    the strided policy's semantics)."""
    C, K, N = 4, 3, 256
    Y = (rng.random((C, K)) @ rng.random((K, N))).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)
    W = (0.5 + rng.random(Y.shape)).astype(np.float32)

    calls = []
    orig = nmf_mod.nmf_pgm_fused
    monkeypatch.setattr(
        nmf_mod, "nmf_pgm_fused",
        lambda *a, **k: (calls.append(k.get("step_adapt")),
                         orig(*a, **k))[1])

    kw = dict(W=W, e_rel=0, max_iter=5, engine="auto")
    # tiny problem: below the measured region -> xla, fused not called
    for policy in (dict(step_stride=3), dict(step_adapt=True)):
        r = pt.nmf.nmf(Y, A0.copy(), S0.copy(), **kw, **policy)
        assert np.isfinite(np.asarray(r.x[1])).all()
    assert calls == []

    # force the region decision to True: strided/adaptive now fuse
    monkeypatch.setattr(nmf_mod, "_fused_kernel_wins", lambda *a: True)
    r_str = pt.nmf.nmf(Y, A0.copy(), S0.copy(), **kw, step_stride=3)
    r_ad = pt.nmf.nmf(Y, A0.copy(), S0.copy(), **kw, step_adapt=True)
    assert calls == [False, True]
    assert np.isfinite(np.asarray(r_str.x[1])).all()
    assert np.isfinite(np.asarray(r_ad.x[1])).all()
    # ... and the fused strided result tracks the xla strided result
    r_xla = pt.nmf.nmf(Y, A0.copy(), S0.copy(), W=W, e_rel=0,
                       max_iter=5, engine="xla", step_stride=3)
    np.testing.assert_allclose(np.asarray(r_str.x[1]),
                               np.asarray(r_xla.x[1]), rtol=2e-4,
                               atol=2e-5)

    # no strided/adaptive policy -> xla even inside the "win" region
    pt.nmf.nmf(Y, A0.copy(), S0.copy(), **kw)
    assert calls == [False, True]


def test_fused_unweighted_strided_matches_xla_strided(rng):
    """Unweighted strided fused runner (frozen-step segments, refreshes
    from the kernel-carried Gram) matches the XLA ``StridedStepper``
    path iterate-for-iterate over a short horizon — same refresh
    schedule, same 0.9 safety shrink, steps equal modulo contraction
    order."""
    C, K, N = 5, 3, 300
    Y = (rng.random((C, K)) @ rng.random((K, N))
         + 0.01 * rng.standard_normal((C, N))).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)

    for policy in (dict(step_stride=3), dict(step_adapt=True)):
        r_xla = pt.nmf.nmf(jnp.asarray(Y), jnp.asarray(A0),
                           jnp.asarray(S0), e_rel=0, max_iter=8,
                           engine="xla", **policy)
        r_pal = pt.nmf.nmf(jnp.asarray(Y), jnp.asarray(A0),
                           jnp.asarray(S0), e_rel=0, max_iter=8,
                           engine="pallas", **policy)
        np.testing.assert_allclose(np.asarray(r_pal.x[0]),
                                   np.asarray(r_xla.x[0]), rtol=2e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(r_pal.x[1]),
                                   np.asarray(r_xla.x[1]), rtol=2e-4,
                                   atol=1e-6)


def test_unweighted_auto_routes_strided_by_measured_region(rng,
                                                           monkeypatch,
                                                           fake_cuda):
    """engine='auto' wiring for UNWEIGHTED strided/adaptive pgm: routes
    by the same measured region as the exact engine, stays on xla below
    the region."""
    C, K, N = 4, 3, 256
    Y = (rng.random((C, K)) @ rng.random((K, N))).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)

    calls = []
    orig = nmf_mod.nmf_pgm_fused
    monkeypatch.setattr(
        nmf_mod, "nmf_pgm_fused",
        lambda *a, **k: (calls.append(k.get("step_adapt")),
                         orig(*a, **k))[1])

    kw = dict(e_rel=0, max_iter=5, engine="auto")
    # tiny problem: below the measured region -> xla, fused not called
    for policy in (dict(step_stride=3), dict(step_adapt=True)):
        r = pt.nmf.nmf(Y, A0.copy(), S0.copy(), **kw, **policy)
        assert np.isfinite(np.asarray(r.x[1])).all()
    assert calls == []

    monkeypatch.setattr(nmf_mod, "_fused_kernel_wins", lambda *a: True)
    r_str = pt.nmf.nmf(Y, A0.copy(), S0.copy(), **kw, step_stride=3)
    r_ad = pt.nmf.nmf(Y, A0.copy(), S0.copy(), **kw, step_adapt=True)
    assert calls == [False, True]
    r_xla = pt.nmf.nmf(Y, A0.copy(), S0.copy(), e_rel=0, max_iter=5,
                       engine="xla", step_stride=3)
    np.testing.assert_allclose(np.asarray(r_str.x[1]),
                               np.asarray(r_xla.x[1]), rtol=2e-4,
                               atol=2e-5)
    assert np.isfinite(np.asarray(r_ad.x[1])).all()


def test_auto_prox_guard_blocks_pixel_coupled_prox(rng, monkeypatch,
                                                  fake_cuda):
    """Correctness hole closed (r4 late): a pixel-coupled prox_S (e.g.
    prox_unity(axis=1)) must keep engine='auto' off the fused kernel —
    tile-local application would silently normalize per tile — while a
    factor-axis prox_unity still fuses; explicit pallas-only kwargs
    with an unknown prox raise instead of silently misrouting."""
    from functools import partial

    C, K, N = 64, 3, 256
    monkeypatch.setattr(nmf_mod, "_fused_kernel_wins", lambda *a: True)
    Y = (rng.random((C, K)) @ rng.random((K, N))).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)

    calls = []
    orig = nmf_mod.nmf_pgm_fused
    monkeypatch.setattr(
        nmf_mod, "nmf_pgm_fused",
        lambda *a, **k: (calls.append(1), orig(*a, **k))[1])

    kw = dict(e_rel=0, max_iter=5, engine="auto")
    # default proxs at C >= 64 -> fused
    pt.nmf.nmf(Y, A0.copy(), S0.copy(), **kw)
    assert calls == [1]

    # pixel-coupled prox_S -> xla, and the result is the CORRECT
    # (global) normalization, matching the explicit xla engine
    p_pix = partial(op.prox_unity_plus, axis=1)
    r = pt.nmf.nmf(Y, A0.copy(), S0.copy(), prox_S=p_pix, **kw)
    assert calls == [1]
    r_xla = pt.nmf.nmf(Y, A0.copy(), S0.copy(), prox_S=p_pix,
                       e_rel=0, max_iter=5, engine="xla")
    np.testing.assert_allclose(np.asarray(r.x[1]),
                               np.asarray(r_xla.x[1]), rtol=1e-6)

    # factor-axis prox_unity (tile-local) still fuses, and agrees with
    # the xla engine through the padding masks
    p_fac = partial(op.prox_unity_plus, axis=0)
    r_f = pt.nmf.nmf(Y, A0.copy(), S0.copy(), prox_S=p_fac, **kw)
    assert calls == [1, 1]
    r_fx = pt.nmf.nmf(Y, A0.copy(), S0.copy(), prox_S=p_fac,
                      e_rel=0, max_iter=5, engine="xla")
    np.testing.assert_allclose(np.asarray(r_f.x[1]),
                               np.asarray(r_fx.x[1]), rtol=2e-4,
                               atol=2e-5)

    # unknown prox + pallas-only kwarg: loud error pointing at the
    # engine='pallas' escape hatch, not a silent misroute
    with pytest.raises(ValueError, match="pallas"):
        pt.nmf.nmf(Y, A0.copy(), S0.copy(), tile_n=128,
                   prox_S=lambda X, s: jnp.maximum(X, 0), **kw)


def test_fused_divergence_detected_on_final_iteration(rng):
    """Review finding (r4 late): the carried loss is pre-update, so a
    divergence on the LAST allowed iteration used to escape detection;
    the in-body loss poisoning (post-update norms) closes the gap."""
    import proxmin_tpu as pt

    C, K, N = 3, 2, 128
    Y = rng.random((C, N)).astype(np.float32)
    Y[0, 0] = np.inf
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)
    # max_iter=1: the only iteration produces the NaN
    r = pt.nmf.nmf_pgm_fused(Y, A0.copy(), S0.copy(), e_rel=0,
                             max_iter=1, tile_n=128)
    assert r.status == "diverged"
    r = pt.nmf.nmf_adaprox_fused(Y, A0.copy(), S0.copy(), e_rel=0,
                                 max_iter=1, tile_n=128)
    assert r.status == "diverged"


# ---------------------------------------------------------------------------
# Exhaustive tile-safety oracle for the auto-routing prox guard: every
# library prox x {A, S} x kwargs variant is applied exactly the way the
# fused engine would apply it (S: per column tile on the factor
# row-padded to a power of two, masked after; A: whole) and compared
# against the global prox. The router's verdict must never claim safety the oracle
# refutes, and must match the oracle exactly on the library surface.

def _kernel_style_S(prox, S, step, K, tile):
    """Emulate _pgm_step_kernel's prox_S application: row-pad to a power
    of two, apply per column tile, mask padding, crop."""
    Kp = 1 << (K - 1).bit_length()
    N = S.shape[1]
    S_p = jnp.pad(jnp.asarray(S), ((0, Kp - K), (0, 0)))
    outs = []
    for j in range(0, N, tile):
        blk = S_p[:, j:j + tile]
        out = prox(blk, step)
        rows = jnp.arange(Kp)[:, None] < K
        outs.append(jnp.where(rows, out, 0.0))
    return np.asarray(jnp.concatenate(outs, axis=1))[:K]


def _runner_style_A(prox, A, step, C, K):
    """Emulate the fused runners' prox_A application: whole, unpadded."""
    return np.asarray(prox(jnp.asarray(A), step))


def _tile_safety_matrix():
    """(label, prox, needs_positive_data, expected verdict on A,
    expected verdict on S). Covers EVERY public prox in operators.py
    plus the AlternatingProjections combinator (incl. recursion)."""
    from functools import partial

    ap = op.AlternatingProjections
    elementwise = [
        ("prox_id", op.prox_id, False, True, True),
        ("prox_zero", op.prox_zero, False, True, True),
        ("prox_plus", op.prox_plus, False, True, True),
        ("prox_min_rel", partial(op.prox_min, thresh=0.2), False,
         True, True),
        ("prox_min_abs", partial(op.prox_min, thresh=-0.3,
                                 type="absolute"), False, True, True),
        ("prox_max_rel", partial(op.prox_max, thresh=0.4), False,
         True, True),
        ("prox_max_abs", partial(op.prox_max, thresh=0.8,
                                 type="absolute"), False, True, True),
        ("prox_hard", partial(op.prox_hard, thresh=0.1), False,
         True, True),
        ("prox_hard_abs", partial(op.prox_hard, thresh=0.1,
                                  type="absolute"), False, True, True),
        ("prox_hard_plus", partial(op.prox_hard_plus, thresh=0.1),
         False, True, True),
        ("prox_soft", partial(op.prox_soft, thresh=0.1), False,
         True, True),
        ("prox_soft_abs", partial(op.prox_soft, thresh=0.05,
                                  type="absolute"), False, True, True),
        ("prox_soft_plus", partial(op.prox_soft_plus, thresh=0.1),
         False, True, True),
        ("prox_max_entropy", partial(op.prox_max_entropy, gamma=0.2),
         True, True, True),
    ]
    unity = [
        ("prox_unity_default", op.prox_unity, True, True, True),
        ("prox_unity_ax0", partial(op.prox_unity, axis=0), True,
         True, True),
        ("prox_unity_ax1", partial(op.prox_unity, axis=1), True,
         True, False),
        ("prox_unity_plus_ax0", partial(op.prox_unity_plus, axis=0),
         True, True, True),
        ("prox_unity_plus_ax1", partial(op.prox_unity_plus, axis=1),
         True, True, False),
    ]
    combinators = [
        ("pocs_elementwise", ap([op.prox_plus,
                                 partial(op.prox_soft, thresh=0.1)]),
         False, True, True),
        ("pocs_unity_ax0", ap([op.prox_plus,
                               partial(op.prox_unity, axis=0)]),
         True, True, True),
        ("pocs_unity_ax1", ap([op.prox_plus,
                               partial(op.prox_unity, axis=1)]),
         True, True, False),
        ("pocs_nested", ap([ap([op.prox_plus]),
                            partial(op.prox_unity, axis=1)]),
         True, True, False),
        # intentionally unrouted library callables: conservative False
        # even though some instantiations are tile-invariant
        ("prox_components", partial(op.prox_components,
                                    prox=op.prox_plus), False,
         False, False),
        # positionally-bound partial args: conservative False
        ("positional_partial", __import__("functools").partial(
            op.prox_soft, 0.1), False, False, False),
        # arbitrary user callable: conservative False
        ("user_lambda", lambda x, s: jnp.minimum(x, 2.0), False,
         False, False),
    ]
    return elementwise + unity + combinators


@pytest.mark.parametrize(
    "label,prox,positive,exp_A,exp_S",
    _tile_safety_matrix(),
    ids=[r[0] for r in _tile_safety_matrix()])
def test_fused_prox_safe_matches_tile_oracle(label, prox, positive,
                                             exp_A, exp_S, rng):
    from proxmin_tpu.nmf import _fused_prox_safe

    C, K, N, tile, step = 5, 3, 24, 8, 0.37
    if positive:
        A = (0.05 + rng.random((C, K))).astype(np.float32)
        S = (0.05 + rng.random((K, N))).astype(np.float32)
    else:
        A = rng.standard_normal((C, K)).astype(np.float32)
        S = rng.standard_normal((K, N)).astype(np.float32)

    verdict_A = _fused_prox_safe(prox, "A")
    verdict_S = _fused_prox_safe(prox, "S")
    assert verdict_A == exp_A, f"{label}: A verdict {verdict_A}"
    assert verdict_S == exp_S, f"{label}: S verdict {verdict_S}"

    callable_prox = prox if prox is not None else op.prox_plus
    global_A = np.asarray(callable_prox(jnp.asarray(A), step))
    global_S = np.asarray(callable_prox(jnp.asarray(S), step))
    kernel_A = _runner_style_A(callable_prox, A, step, C, K)
    kernel_S = _kernel_style_S(callable_prox, S, step, K, tile)
    finite = (np.isfinite(kernel_A).all() and np.isfinite(global_A).all()
              and np.isfinite(kernel_S).all()
              and np.isfinite(global_S).all())
    measured_A = finite and np.allclose(kernel_A, global_A,
                                        rtol=1e-6, atol=1e-7)
    measured_S = finite and np.allclose(kernel_S, global_S,
                                        rtol=1e-6, atol=1e-7)

    # the hard invariant: the router may be conservative, but a True
    # verdict MUST be backed by measured tile/padding invariance
    assert not (verdict_A and not measured_A), (
        f"{label}: routed as A-safe but padding changes the result")
    assert not (verdict_S and not measured_S), (
        f"{label}: routed as S-safe but tile-splitting changes the result")

    # and where the router says no on a LIBRARY prox for coupling
    # reasons (unity axis=1 on S), the oracle must agree it's coupled —
    # proving the conservatism is load-bearing, not stale
    if label.endswith("ax1") or label in ("pocs_unity_ax1",
                                          "pocs_nested"):
        assert not measured_S, f"{label}: expected pixel coupling"
