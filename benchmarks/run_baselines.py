"""Reproduce the five BASELINE.json configurations: proxmin_tpu vs the
NumPy reference, comparing wall-clock, iterations-to-tolerance and solution
agreement.

The reference package itself (importable as ``proxmin``; its checkout
path goes in ``PROXMIN_REFERENCE``) is used as the NumPy baseline where its
code path works; configs its bugs break (weighted PGM) fall back to
documented equivalents.

Run:  python benchmarks/run_baselines.py
"""

import sys
import time

import numpy as np

import os  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if os.environ.get("PROXMIN_REFERENCE"):
    sys.path.insert(0, os.environ["PROXMIN_REFERENCE"])

import jax  # noqa: E402

if os.environ.get("PROXMIN_BENCH_CPU"):
    # apples-to-apples with the (CPU-only) reference on these tiny
    # configs, where per-call device dispatch would swamp millisecond
    # solves; the flagship device numbers live in bench.py. Must run
    # before any backend initialization.
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import proxmin_tpu as pt  # noqa: E402

try:
    import proxmin as ref
except ImportError:
    ref = None

CENTER = np.array([1.0, 0.5])
RADIUS = 0.5


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return time.perf_counter() - t0, out


def prox_disk_np(x, step, r=RADIUS):
    n = np.linalg.norm(x)
    return x * (r / n) if n > r else x


def prox_disk(x, step, r=RADIUS):
    n = jnp.sqrt(jnp.sum(x ** 2))
    return jnp.where(n > r, x * (r / n), x)


def config1_fista():
    """pgm/FISTA on the 2-D parabola with circle projection."""
    grad_np = lambda x: x - CENTER
    grad = lambda x: x - jnp.asarray(CENTER)

    x_ref = np.array([-1.0, -1.0])
    t_ref, _ = timed(lambda: ref.pgm(
        x_ref, grad_np, lambda *X, it=None: 0.5, prox=prox_disk_np,
        accelerated=True, e_rel=1e-8, max_iter=1000)) if ref else (None, None)

    t, res = timed(lambda: pt.pgm(
        jnp.asarray([-1.0, -1.0]), grad, 0.5, prox=prox_disk,
        accelerated=True, e_rel=1e-8, max_iter=1000))
    # second call = steady-state cost
    t2, res = timed(lambda: pt.pgm(
        jnp.asarray([-1.0, -1.0]), grad, 0.5, prox=prox_disk,
        accelerated=True, e_rel=1e-8, max_iter=1000))
    d = np.linalg.norm(np.asarray(res.x) - x_ref) if ref else float("nan")
    return "pgm/FISTA parabola+circle", t_ref, t2, res.iterations, d


def config2_admm():
    """linearized ADMM on the parabola with non-smooth prox_g."""
    prox_f = lambda v, s: (v + s * jnp.asarray(CENTER)) / (1 + s)
    prox_f_np = lambda v, s: (v + s * CENTER) / (1 + s)

    x_ref = np.array([-1.0, -1.0])
    t_ref, _ = timed(lambda: ref.admm(
        x_ref, prox_f_np, lambda X, it=None: 0.5, prox_g=prox_disk_np,
        e_rel=1e-8, max_iter=2000)) if ref else (None, None)

    run = lambda: pt.admm(
        jnp.asarray([-1.0, -1.0]), prox_f, 0.5, prox_g=prox_disk,
        e_rel=1e-8, max_iter=2000)
    timed(run)
    t2, res = timed(run)
    d = np.linalg.norm(np.asarray(res.x) - x_ref) if ref else float("nan")
    return "ADMM parabola two-prox", t_ref, t2, res.iterations, d


def _unmix_problem(b=100, n=50, k=3, seed=101):
    rng = np.random.default_rng(seed)
    A_true = rng.dirichlet(np.ones(k), size=b)
    S_true = rng.random((k, n))
    Y = A_true @ S_true + 0.02 * rng.standard_normal((b, n))
    return Y, rng.dirichlet(np.ones(k), size=b), 0.5 + rng.random((k, n))


def config3_nmf_pgm():
    """two-block PGM NMF on synthetic spectral unmixing."""
    Y, A0, S0 = _unmix_problem()

    A_r, S_r = A0.copy(), S0.copy()
    t_ref, _ = timed(lambda: ref.nmf.nmf(
        Y, A_r, S_r, e_rel=1e-4, max_iter=500)) if ref else (None, None)

    # pass a device array so repeat solves hit the driver cache
    Y_dev = jnp.asarray(Y)
    run = lambda: pt.nmf.nmf(Y_dev, A0.copy(), S0.copy(),
                             e_rel=1e-4, max_iter=500)
    timed(run)
    t2, res = timed(run)
    d = (np.linalg.norm(np.asarray(res.x[0]) - A_r)
         + np.linalg.norm(np.asarray(res.x[1]) - S_r)) if ref else float("nan")
    return "PGM NMF unmixing 100x50", t_ref, t2, res.iterations, d


def config4_adaprox():
    """AdaProx NMF (amsgrad) with adaptive per-factor steps."""
    Y, A0, S0 = _unmix_problem()

    A_r, S_r = A0.copy(), S0.copy()
    t_ref, _ = timed(lambda: ref.nmf.nmf(
        Y, A_r, S_r, algorithm=ref.adaprox, scheme="amsgrad",
        e_rel=1e-4, max_iter=300, prox_max_iter=50)) if ref else (None, None)

    Y_dev = jnp.asarray(Y)
    run = lambda: pt.nmf.nmf(Y_dev, A0.copy(), S0.copy(),
                             algorithm="adaprox",
                             scheme="amsgrad", e_rel=1e-4, max_iter=300,
                             prox_max_iter=50)
    timed(run)
    t2, res = timed(run)
    lo = float(pt.nmf.log_likelihood(*map(jnp.asarray, res.x),
                                     Y=jnp.asarray(Y)))
    lo_r = float(ref.nmf.log_likelihood(A_r, S_r, Y=Y)) if ref else float("nan")
    return ("AdaProx amsgrad NMF", t_ref, t2, res.iterations,
            abs(lo - lo_r) / max(lo_r, 1e-9))


def config5_bsdmm():
    """bSDMM multi-constraint CMF."""
    Y, A0, S0 = _unmix_problem(b=40, n=30)

    A_r, S_r = A0.copy(), S0.copy()
    t_ref, _ = timed(lambda: ref.nmf.nmf(
        Y, A_r, S_r, algorithm=ref.bsdmm, e_rel=1e-4,
        max_iter=100)) if ref else (None, None)

    Y_dev = jnp.asarray(Y)
    run = lambda: pt.nmf.nmf(Y_dev, A0.copy(), S0.copy(),
                             algorithm="bsdmm", e_rel=1e-4, max_iter=100)
    timed(run)
    t2, res = timed(run)
    d = (np.linalg.norm(np.asarray(res.x[0]) - A_r)
         + np.linalg.norm(np.asarray(res.x[1]) - S_r)) if ref else float("nan")
    return "bSDMM CMF 40x30", t_ref, t2, res.iterations, d


def main(json_path=None):
    rows = []
    print(f"{'config':28s} {'ref[s]':>8s} {'ours[s]':>8s} "
          f"{'iters':>6s} {'agreement':>10s}")
    for cfg in [config1_fista, config2_admm, config3_nmf_pgm,
                config4_adaprox, config5_bsdmm]:
        # each config internally warms the driver cache and reports the
        # second (steady-state) call time
        name, t_ref, t_warm, iters, d = cfg()
        tr = f"{t_ref:8.3f}" if t_ref is not None else "     n/a"
        print(f"{name:28s} {tr} {t_warm:8.3f} {iters:6d} {d:10.2e}")
        rows.append({
            "config": name,
            "ref_seconds": None if t_ref is None else round(t_ref, 4),
            "ours_warm_seconds": round(t_warm, 4),
            "iterations": iters,
            "agreement": float(d),
            "warm_speedup": None if t_ref is None
            else round(t_ref / t_warm, 2),
        })
    if json_path:
        import json

        with open(json_path, "w") as fh:
            json.dump(rows, fh, indent=1)
        print(f"wrote {json_path}")
    return rows


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
