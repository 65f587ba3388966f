"""Engine scaling study: XLA-fused loop vs the Pallas single-pass kernel
across channel counts, plus the weighted strided-step comparison.

Timing uses marginal slopes between two iteration counts of the same
compiled executable (cancels per-call dispatch overhead; see bench.py).

Run on a GPU:  python benchmarks/engine_scaling.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import proxmin_tpu as pt  # noqa: E402
from proxmin_tpu import operators  # noqa: E402
from proxmin_tpu.nmf import (  # noqa: E402
    _make_fused_pgm_runner, pgm_nmf_iteration,
)
from proxmin_tpu.ops.nmf_kernels import pixel_tile  # noqa: E402
from proxmin_tpu.nmf import (  # noqa: E402
)

ITERS_LO, ITERS_HI = 100, 300


def _slope(call, reps=2):
    """Marginal per-iteration time from independently min'd call times
    (same methodology as bench.py: contention outliers rejected without
    pairing artifacts)."""
    call(ITERS_LO)  # compile/warm
    t_los, t_his = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        call(ITERS_LO)
        t_los.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        call(ITERS_HI)
        t_his.append(time.perf_counter() - t0)
    return (min(t_his) - min(t_los)) / (ITERS_HI - ITERS_LO)


def engines_at(C, K, N):
    rng = np.random.default_rng(0)
    Y = jnp.asarray(rng.random((C, N)).astype(np.float32))
    A = jnp.asarray(rng.random((C, K)).astype(np.float32))
    S = jnp.asarray(rng.random((K, N)).astype(np.float32))

    def body(i, c):
        A, S, _ = c
        return pgm_nmf_iteration(A, S, Y)

    @jax.jit
    def run_xla(A, S, n):
        return jax.lax.fori_loop(0, n, body, (A, S, jnp.asarray(False)))

    t_xla = _slope(lambda n: np.asarray(run_xla(A, S, n)[0]))
    runner = _make_fused_pgm_runner(
        operators.prox_plus, None, 0.0, pixel_tile(K, N), C, K, N,
        jnp.float32.dtype
    )
    t_pal = _slope(lambda n: np.asarray(runner(A, S, Y, n)[0]))
    print(f"C={C:4d} K={K:3d} N={N:8d}: xla {t_xla * 1e3:7.3f} ms/iter  "
          f"pallas {t_pal * 1e3:7.3f} ms/iter  "
          f"xla/pallas {t_xla / t_pal:4.2f}x")


def weighted_engines_at(C, K, N, stride=10):
    """Weighted engine comparison at one shape: the XLA driver
    (warm-started strided WeightedPGMStepper) vs the fused weighted
    Pallas kernel, both at the same refresh stride."""
    rng = np.random.default_rng(0)
    Y = jnp.asarray(rng.random((C, N)).astype(np.float32))
    W = jnp.asarray((0.5 + rng.random((C, N))).astype(np.float32))
    A = jnp.asarray(rng.random((C, K)).astype(np.float32))
    S = jnp.asarray(rng.random((K, N)).astype(np.float32))

    times = {}
    rows = (
        ("xla", dict(engine="xla")),
        ("pallas", dict(engine="pallas")),
        ("xla-adapt", dict(engine="xla", step_adapt=True)),
        ("pallas-adapt", dict(engine="pallas", step_adapt=True)),
    )
    for name, kw in rows:
        def call(n, _kw=kw):
            res = pt.nmf.nmf(Y, A, S, W=W, e_rel=0, max_iter=n,
                             step_stride=stride, **_kw)
            return np.asarray(res.x[0])

        times[name] = _slope(call)
    print(f"weighted C={C:4d} K={K:3d} N={N:8d}: "
          f"xla {times['xla'] * 1e3:7.3f} ms/iter  "
          f"pallas {times['pallas'] * 1e3:7.3f} ms/iter  "
          f"xla/pallas {times['xla'] / times['pallas']:4.2f}x  |  "
          f"adapt: xla {times['xla-adapt'] * 1e3:7.3f}  "
          f"pallas {times['pallas-adapt'] * 1e3:7.3f}  "
          f"xla/pallas {times['xla-adapt'] / times['pallas-adapt']:4.2f}x")
    return times


def store_dtype_at(C, K, N, stride=10):
    """bf16-STORAGE speed rows for the weighted-PGM and fused-adaprox
    stores (the W stream halves too; adaprox reaches a 94 MB/iter naive
    floor with bf16 moments+store)."""
    rng = np.random.default_rng(0)
    Y = jnp.asarray(rng.random((C, N)).astype(np.float32))
    W = jnp.asarray((0.5 + rng.random((C, N))).astype(np.float32))
    A = jnp.asarray(rng.random((C, K)).astype(np.float32))
    S = jnp.asarray(rng.random((K, N)).astype(np.float32))

    times = {}
    rows = (
        ("w-pallas-f32", dict(W=W, step_stride=stride, engine="pallas")),
        ("w-pallas-bf16s", dict(W=W, step_stride=stride, engine="pallas",
                                store_dtype=jnp.bfloat16)),
        ("a-pallas-bf16m", dict(algorithm="adaprox", engine="pallas",
                                moment_dtype=jnp.bfloat16)),
        ("a-pallas-bf16m+s", dict(algorithm="adaprox", engine="pallas",
                                  moment_dtype=jnp.bfloat16,
                                  store_dtype=jnp.bfloat16)),
    )
    for name, kw in rows:
        def call(n, _kw=kw):
            res = pt.nmf.nmf(Y, A, S, e_rel=0, max_iter=n, **_kw)
            return np.asarray(res.x[0])

        times[name] = _slope(call)
        print(f"store C={C:4d} K={K:3d} N={N:8d} {name:18s} "
              f"{times[name] * 1e3:7.3f} ms/iter")
    return times


def weighted_strided(C=5, K=7, N=1_000_000):
    rng = np.random.default_rng(101)
    Y = jnp.asarray(
        (rng.random((C, K)) @ rng.random((K, N))).astype(np.float32))
    W = jnp.asarray((0.5 + rng.random((C, N))).astype(np.float32))
    A0 = jnp.asarray(rng.random((C, K)).astype(np.float32))
    S0 = jnp.asarray(rng.random((K, N)).astype(np.float32))

    for tag, kw in [("exact steps", {}), ("step_stride=10",
                                          dict(step_stride=10))]:
        for it in (ITERS_LO, ITERS_HI):   # pre-compile both counts
            pt.nmf.nmf(Y, A0, S0, W=W, e_rel=0, max_iter=it, **kw)
        t0 = time.perf_counter()
        pt.nmf.nmf(Y, A0, S0, W=W, e_rel=0, max_iter=ITERS_LO, **kw)
        t1 = time.perf_counter()
        r = pt.nmf.nmf(Y, A0, S0, W=W, e_rel=0, max_iter=ITERS_HI, **kw)
        t2 = time.perf_counter()
        per = ((t2 - t1) - (t1 - t0)) / (ITERS_HI - ITERS_LO)
        loss = float(pt.nmf.log_likelihood(*r.x, Y=Y, W=W))
        print(f"weighted {tag:15s} {per * 1e3:7.3f} ms/iter  "
              f"loss@{ITERS_HI}={loss:.1f}")


if __name__ == "__main__":
    from proxmin_tpu.utils import summarize_convergence_warnings

    print(f"devices: {jax.devices()}", file=sys.stderr)
    with summarize_convergence_warnings():
        engines_at(5, 7, 1_000_000)
        engines_at(16, 8, 500_000)
        engines_at(64, 16, 250_000)
        engines_at(128, 32, 125_000)
        # the unweighted residency cliff (xla wins <= ~176 MB stream,
        # the kernel from ~200 MB up at ANY channel count)
        engines_at(16, 8, 2_000_000)
        engines_at(5, 7, 4_000_000)
        weighted_engines_at(5, 7, 1_000_000)
        weighted_engines_at(16, 8, 500_000)
        weighted_engines_at(64, 16, 250_000)
        weighted_engines_at(128, 32, 125_000)
        weighted_strided()
        store_dtype_at(5, 7, 1_000_000)
        store_dtype_at(64, 16, 250_000)
