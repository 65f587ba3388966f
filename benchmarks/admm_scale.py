"""ADMM-family at-scale benchmark: 1e6-pixel TV denoising.

The reference treats its five solvers uniformly
(``proxmin/algorithms.py:426-850``). This benchmark puts
``admm`` and ``sdmm`` on the same footing as the flagship: an H x H
anisotropic TV denoise (the ``examples/image_tv.py`` scenario — the
natural ADMM-family flagship because the constraints are matrix-free
difference operators), measured as marginal ms/iter between two
iteration budgets of one compiled solve, with a naive memory roofline
against the card's peak bandwidth (``bench.PEAK_GBS``).

Naive memory traffic model per iteration (f32 words of size H*W = P):

- ``admm`` (one constraint):  X-update reads X, Z, U and writes X
  (LX is recomputed on the fly: stencil reads of X); ``do_the_mm``
  reads X, Z, U and writes Z, U (+ the Boyd residual reductions ride
  the same passes).  ~8 P words = 32 P bytes.
- ``sdmm`` (M=2 constraints): X-update reads X + (Z_i, U_i) x 2 and
  writes X; per-constraint do_the_mm as above.  ~14 P words = 56 P
  bytes.

These are *naive* bounds in the same sense as bench.py's. Needs a GPU.

Run: ``python benchmarks/admm_scale.py [H]`` (default 1024 = 1e6 px).
"""

import json
import os
import sys
import time
from functools import partial

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))



def main():
    import jax.numpy as jnp

    import bench

    device, peak_gbs = bench.device_info()

    from proxmin_tpu import admm, operators, sdmm
    from proxmin_tpu.linop import FunctionOperator
    from proxmin_tpu.utils import summarize_convergence_warnings

    H = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    W = H
    P = H * W
    lam = 0.4
    rng = np.random.default_rng(11)
    truth = np.zeros((H, W), np.float32)
    truth[H // 8: H // 2, W // 6: W // 2] = 1.0
    truth[5 * H // 8: 7 * H // 8, W // 3: 5 * W // 6] = -0.6
    y = truth + 0.3 * rng.standard_normal((H, W)).astype(np.float32)
    yj = jnp.asarray(y)
    x0 = jnp.zeros((H, W), jnp.float32)

    def dh(x):
        return x[:, 1:] - x[:, :-1]

    def dh_T(v):
        return jnp.concatenate(
            [-v[:, :1], v[:, :-1] - v[:, 1:], v[:, -1:]], axis=1)

    def dv(x):
        return x[1:, :] - x[:-1, :]

    def dv_T(v):
        return jnp.concatenate(
            [-v[:1, :], v[:-1, :] - v[1:, :], v[-1:, :]], axis=0)

    Dh = FunctionOperator(dh, dh_T, (H, W), dtype=jnp.float32,
                          norm_sq=4.0)
    Dv = FunctionOperator(dv, dv_T, (H, W), dtype=jnp.float32,
                          norm_sq=4.0)

    def prox_quad(x, step, *, y):
        return (x + step * y) / (1.0 + step)

    prox_l1 = partial(
        lambda z, step, *, lam: operators.prox_soft(z, step, thresh=lam),
        lam=lam)

    def log(*a):
        print(*a, file=sys.stderr, flush=True)

    def marginal(call, lo=200, hi=1000, reps=5):
        # independent minima of lo/hi over several reps: dispatch jitter
        # can exceed the lo-call runtime, so few-rep paired slopes can
        # sample physically impossible (negative) values; the wide
        # iteration spread makes the true slope dominate the jitter
        def t(n):
            best = 1e9
            for _ in range(reps):
                t0 = time.perf_counter()
                call(n)
                best = min(best, time.perf_counter() - t0)
            return best
        t_lo = t(lo)
        return (t(hi) - t_lo) / (hi - lo), t_lo

    rows = {}
    with summarize_convergence_warnings():
        # --- admm: 1-D TV (horizontal differences only) ----------------
        def call_admm(n):
            res = admm(x0, partial(prox_quad, y=yj), 0.5, prox_g=prox_l1,
                       L=Dh, e_rel=0, e_abs=0, max_iter=n)
            np.asarray(res.x)

        t0 = time.perf_counter()
        call_admm(8)
        compile_admm = time.perf_counter() - t0
        m_admm, _ = marginal(call_admm)
        bytes_admm = 32 * P
        gbs_admm = bytes_admm / m_admm / 1e9
        log(f"admm  {H}x{W}: {m_admm * 1e3:.4f} ms/iter "
            f"(compile {compile_admm:.1f}s) — naive bound "
            f"{bytes_admm / 1e6:.0f} MB/iter -> {gbs_admm:.0f} GB/s "
            f"vs {peak_gbs:.0f} peak")
        rows["admm"] = {"ms_per_iter": round(m_admm * 1e3, 4),
                        "naive_mb_per_iter": round(bytes_admm / 1e6, 1),
                        "achieved_gbs": round(gbs_admm, 0),
                        "compile_s": round(compile_admm, 1)}

        # --- sdmm: anisotropic 2-D TV (M=2 constraints) ----------------
        def call_sdmm(n):
            res = sdmm(x0, partial(prox_quad, y=yj), 0.5,
                       proxs_g=[prox_l1] * 2, Ls=[Dh, Dv],
                       e_rel=0, e_abs=0, max_iter=n)
            np.asarray(res.x)

        t0 = time.perf_counter()
        call_sdmm(8)
        compile_sdmm = time.perf_counter() - t0
        m_sdmm, _ = marginal(call_sdmm)
        bytes_sdmm = 56 * P
        gbs_sdmm = bytes_sdmm / m_sdmm / 1e9
        log(f"sdmm  {H}x{W}: {m_sdmm * 1e3:.4f} ms/iter "
            f"(compile {compile_sdmm:.1f}s) — naive bound "
            f"{bytes_sdmm / 1e6:.0f} MB/iter -> {gbs_sdmm:.0f} GB/s "
            f"vs {peak_gbs:.0f} peak")
        rows["sdmm"] = {"ms_per_iter": round(m_sdmm * 1e3, 4),
                        "naive_mb_per_iter": round(bytes_sdmm / 1e6, 1),
                        "achieved_gbs": round(gbs_sdmm, 0),
                        "compile_s": round(compile_sdmm, 1)}

        # --- quality sanity: the solve actually denoises ---------------
        res = sdmm(x0, partial(prox_quad, y=yj), 0.5,
                   proxs_g=[prox_l1] * 2, Ls=[Dh, Dv],
                   e_rel=1e-4, max_iter=400)
        x = np.asarray(res.x)
        rmse_in = float(np.sqrt(np.mean((y - truth) ** 2)))
        rmse_out = float(np.sqrt(np.mean((x - truth) ** 2)))
        log(f"sdmm quality: RMSE {rmse_in:.4f} -> {rmse_out:.4f} "
            f"({res.iterations} iters)")
        rows["sdmm_quality"] = {"rmse_noisy": round(rmse_in, 4),
                                "rmse_denoised": round(rmse_out, 4),
                                "iterations": int(res.iterations)}

    print(json.dumps({"metric": f"admm_family_tv_{H}x{W}",
                      "pixels": P, "device": device, **rows}))


if __name__ == "__main__":
    main()
